"""Set-up: from the process's start to the window's (imports, CUDA's start,
corpus, weights, the kernels' build, warm-up), by the host clock."""


def read(run):
    return run.counters.get("setup_s")
