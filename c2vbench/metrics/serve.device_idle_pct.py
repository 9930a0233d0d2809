"""Share of the traced serving window in which no operation ran on the
device (the union of every device operation's interval)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or "served_contexts" not in run.counters:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
