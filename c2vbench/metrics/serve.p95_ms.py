"""The clients' submit-to-answer time, 95th percentile of every request
answered in the window (``CodeServer.handle``, host clock)."""

import numpy as np


def read(run):
    lat = run.counters.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))
