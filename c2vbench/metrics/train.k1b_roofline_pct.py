"""K1b (``csrc/pool.cu`` ``pool_bwd_kernel``, the pool's backward): its bytes
at the HBM peak over its traced time, every launch of the traced window."""

from c2vbench.costs import HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.time_of(r"\bpool_bwd_kernel<")
    if not n or seconds <= 0:
        return None
    return 100.0 * n * run.counters["k1b_bytes"] / HBM_BYTES_PER_S / seconds
