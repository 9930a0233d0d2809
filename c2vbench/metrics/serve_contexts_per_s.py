"""Real contexts of the embed requests answered in the window, over the
window's wall time."""


def read(run):
    c = run.counters
    if "served_contexts" not in c or not c.get("window_s"):
        return None
    return c["served_contexts"] / c["window_s"]
