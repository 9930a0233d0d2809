"""The path LSTMs' closed-form forward operations of their real node steps
(``path_steps_real``: the real contexts' nodes, both directions) over the
``path_encoder`` span's device time at the H100's f32 peak (the LSTMs run
with TF32 off). Counting real steps only, a change that skips PAD steps
reads the same work."""

from c2vbench.costs import F32_FLOP_PER_S


def read(run):
    row = (run.counters.get("program") or {}).get("path_encoder")
    if not row or not row["device_count"] or row["device_ms"] <= 0:
        return None
    steps = row["args"].get("path_steps_real")
    if not steps or row["device_count"] != row["count"]:
        return None
    flops = steps * run.counters["path_step_flops"]
    return 100.0 * flops / (F32_FLOP_PER_S * row["device_ms"] / 1e3)
