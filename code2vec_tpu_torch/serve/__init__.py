"""Online serving on PyTorch/CUDA: counterpart of ``code2vec_tpu/serve``.

- :mod:`engine` — warms every (micro-batch, bag width) shape at start;
- :mod:`batcher` — the continuous micro-batcher (deadline coalescing,
  bounded queue, per-phase metrics and the flight recorder's feed);
- :mod:`retrieval` — the exact and IVF-PQ neighbors backends;
- :mod:`swap` — live checkpoint hot-swap: generations built and warmed on
  a background thread, validated against a golden request set (bitwise
  embeddings, recall-bounded neighbors) and swapped atomically, the
  previous one resident for an instant ``rollback``;
- :mod:`protocol` — ``dict -> dict`` request handling and the stdio and
  HTTP transports with the SIGTERM drain; ``python -m
  code2vec_tpu_torch.serve`` is the CLI;
- :mod:`fleet` — a torch-free router over N replica workers (this CLI on
  stdio), with SLO classes, a result cache and rolling swaps; ``python -m
  code2vec_tpu_torch.serve.fleet`` is its CLI.

Exports resolve lazily (PEP 562): importing a submodule does not import
the rest, so the fleet router, which moves JSON dicts and never tensors,
never imports ``torch``.
"""

_EXPORTS = {
    "CodeServer": "code2vec_tpu_torch.serve.protocol",
    "Generation": "code2vec_tpu_torch.serve.swap",
    "GoldenSet": "code2vec_tpu_torch.serve.swap",
    "MicroBatcher": "code2vec_tpu_torch.serve.batcher",
    "RetrievalIndex": "code2vec_tpu_torch.serve.retrieval",
    "ServeOverloaded": "code2vec_tpu_torch.serve.batcher",
    "ServerClosed": "code2vec_tpu_torch.serve.batcher",
    "ServingEngine": "code2vec_tpu_torch.serve.engine",
    "SwapController": "code2vec_tpu_torch.serve.swap",
    "SwapValidationError": "code2vec_tpu_torch.serve.swap",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
