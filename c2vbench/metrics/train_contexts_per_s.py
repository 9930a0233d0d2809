"""Real (non-PAD) path-contexts of the train steps completed in the window,
over the window's wall time (which ends in one device synchronize)."""


def read(run):
    c = run.counters
    if "contexts" not in c or not c.get("window_s"):
        return None
    return c["contexts"] / c["window_s"]
