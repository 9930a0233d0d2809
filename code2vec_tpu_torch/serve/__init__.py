"""Online serving on PyTorch/CUDA: counterpart of ``code2vec_tpu/serve``.

- :mod:`engine` — warms every (micro-batch, bag width) shape at start;
- :mod:`batcher` — the continuous micro-batcher (deadline coalescing,
  bounded queue);
- :mod:`protocol` — ``dict -> dict`` request handling and the stdio
  transport; ``python -m code2vec_tpu_torch.serve`` is the CLI.
"""
