"""The benchmark of ``code2vec_tpu_torch`` on an NVIDIA H100.

One run is one process::

    python3 -m c2vbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` at that root lists the
cells, the configurations and the metrics; everything that belongs to one
of them lives in a file of its own, found by its name:

- ``configs/<config>.json``: a model configuration, its source and its cuts;
- ``traffic/<traffic>.json``: a traffic mix, naming the driver
  (``drivers/<driver>.py``) that runs it and the limits of its comparison;
- ``metrics/<metric>.py``: one reader a metric, over the run's counters and
  its device trace.

The yardstick is kept here and nowhere else: the corpus and request draws
(``corpus.py``, ``requests.py``), the weights (``weights.py``), the plain
reference and its frozen copies of the program's rules (``reference.py``),
the operation and byte counts and the chip's peaks (``costs.py``), the
reduction of a device trace (``trace.py``) and the comparison that decides
``correct`` (``compare.py``). From the program the benchmark takes the
system under test and its kernel names only.
"""
