"""The train steps' closed-form model operations in the traced window, over
the window's length times the H100's dense TF32 peak (c2vbench/costs.py)."""

from c2vbench.costs import TF32_FLOP_PER_S


def read(run):
    t, c = run.trace, run.counters
    if t is None or not c.get("traced_steps") or t.window_s <= 0:
        return None
    return 100.0 * c["traced_steps"] * c["step_flops"] / (t.window_s * TF32_FLOP_PER_S)
