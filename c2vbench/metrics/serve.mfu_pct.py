"""The engine's device calls in the traced window, at each call's ``[B, W]``:
the model's closed-form forward operations over the window's length times
the H100's dense TF32 peak (c2vbench/costs.py)."""

from c2vbench.costs import TF32_FLOP_PER_S, dims_of, forward_flops


def read(run):
    t = run.trace
    calls = [c for c in run.counters.get("calls", ()) if c[4]]
    if t is None or not calls or t.window_s <= 0:
        return None
    dims = dims_of(run.config)
    flops = sum(forward_flops(b, w, **dims) for b, w, *_ in calls)
    return 100.0 * flops / (t.window_s * TF32_FLOP_PER_S)
