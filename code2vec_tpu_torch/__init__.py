"""code2vec_tpu_torch — the PyTorch/CUDA port of ``code2vec_tpu``.

The JAX package beside it is the reference this port is held against
(same weights in, same code vectors out). The port imports ``torch``,
numpy and the standard library only; it never imports ``jax`` or anything
under ``code2vec_tpu`` and keeps its own copy of what it needs.

Layout (each module names its JAX counterpart):

- ``ops`` — the plain PyTorch ops and the hand-written Hopper kernels
  (``csrc/*.cu``, built with ``nvcc`` at first use by ``ops/_build.py``);
- ``models`` — the ``Code2Vec`` ``nn.Module`` and the file-level head
  (``hierarchical``: method vectors pooled into one vector a file);
- ``interop`` — JAX param tree <-> reference ``state_dict``;
- ``formats`` — vocab files, ``code.vec``, the ANN index container and
  the corpus (text and the mmap-backed CSR container), interchangeable
  with the JAX package's; ``tools/corpus_convert.py`` and
  ``tools/corpus_stats.py`` convert and inspect corpora;
- ``ann`` — the IVF-PQ index (k-means and PQ on the card, K5 scoring);
  ``tools/ann_build.py`` builds one from a ``code.vec`` or ``file.vec``;
- ``predict`` / ``serve`` — the serving path (``python -m
  code2vec_tpu_torch.serve``): predict/embed over any bag up to the
  ladder's top rung (K4 above the training bag) and ``neighbors`` over the
  exact or the IVF-PQ backend, from mapped contexts or Java or Python
  source, and ``embed_file`` / file-granularity ``neighbors``;
- ``extractor`` — the repo's C++ Java extractor (``extractor/src``), built
  with ``g++`` at first use: corpora (``python -m
  code2vec_tpu_torch.extractor``, mixed Java + Python datasets too) and
  in-process extraction for ``predict``; ``pyextract`` — the Python
  sources' ``ast`` extractor;
- ``text``, ``data`` (vocab, reader with the native parser and the
  corpus cache, synthetic corpora, epochs and batches of the method and
  variable tasks in RAM, streamed or from an mmap-backed corpus, the feed
  workers), ``metrics``, ``train`` (config, steps, the lazy table
  optimizer, device-resident epochs, the host prefetcher, the SIGTERM
  guard, the epoch loop), ``checkpoint`` (sync and async writers, mid-epoch
  cursors), ``faultinject`` (the fault plan), ``export`` and ``cli`` — the
  training path (``python -m code2vec_tpu_torch``), whose model dir the
  server serves as it stands.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

PAD_INDEX = 0
PAD_NAME = "<PAD/>"
QUESTION_TOKEN_NAME = "@question"
# The terminal vocab injects "@question" at index 1 and shifts all file
# indices > 0 up by one (reference: model/dataset_reader.py:11-12,29-41).
QUESTION_TOKEN_INDEX = 1
