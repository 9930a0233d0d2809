"""K4 (``csrc/fused_encode_pool.cu``, online: the streamed kernel and the
combine at the long-bag widths): the least time of its traced calls
(c2vbench/costs.encode_pool_seconds) over their traced time."""

from c2vbench.serve_kernels import roofline


def read(run):
    return roofline(run, long_bags=True)
