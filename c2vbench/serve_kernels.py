"""The roofline share of the fused encode-pool kernel in a traced serving
window, split by the width of the engine call that launched it: K3
(materialize) up to the training bag, K4 (online) above it. Both launch
``encode_pool_online_kernel`` and then ``pool_combine_kernel``."""

from __future__ import annotations

import re

from c2vbench.costs import encode_pool_seconds

KERNELS = r"\bencode_pool_online_kernel<|\bpool_combine_kernel\b"
TAG = re.compile(r"^engine\.b(\d+)\.w(\d+)$")


def roofline(run, long_bags: bool):
    t = run.trace
    if t is None:
        return None
    cut = run.counters["longbag_width"]
    seconds = 0.0
    for tag, (sec, _) in t.tagged(KERNELS, "engine.").items():
        m = TAG.match(tag)
        if m and (int(m.group(2)) > cut) == long_bags:
            seconds += sec
    cfg = run.config
    least = sum(encode_pool_seconds(real + all_pad, b, w, terminal_embed=cfg["terminal_embed_size"],
                                    path_embed=cfg["path_embed_size"], encode=cfg["encode_size"])
                for b, w, real, all_pad, traced in run.counters.get("calls", ())
                if traced and (w > cut) == long_bags)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
