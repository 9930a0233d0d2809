"""A/B the two per-epoch context-sampling schemes where they differ.

Counterpart of ``tools/ab_sampling.py``, on JAX's spec: 2,500 methods
holding a mean of 60 contexts against a bag of 24, so ~90% of the methods
subsample and the schemes can diverge:

- A (the host pipeline, the reference's): a fresh uniform subsample
  without replacement every epoch (model/dataset_builder.py:134-135);
- B (device epochs): a rotation window over a once-shuffled context order
  (``train/device_epoch.py``).

Both train the same model and recipe on the same corpus, on the card (the
default route, plain), and one JSON line gives their F1 trajectories::

    python -m code2vec_tpu_torch.tools.ab_sampling [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SPEC = dict(n_methods=2500, n_terminals=1200, n_paths=900, n_labels=40, mean_contexts=60.0,
            max_contexts=150, seed=0)
RECIPE = dict(max_epoch=10, batch_size=64, encode_size=64, terminal_embed_size=32,
              path_embed_size=32, max_path_length=24, print_sample_cycle=0,
              early_stop_patience=100)


def run(device) -> dict:
    from code2vec_tpu_torch.data.synth import SynthSpec, corpus_data_from_raw, \
        generate_corpus_data
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import train

    data = corpus_data_from_raw(generate_corpus_data(SynthSpec(**SPEC)))
    host = train(TrainConfig(**RECIPE), data, device=device)
    dev = train(TrainConfig(**RECIPE, device_epoch=True, device_chunk_batches=8), data,
                device=device)
    return {
        "subsample_fraction": float(np.mean(np.diff(data.row_splits)
                                            > RECIPE["max_path_length"])),
        "host_uniform_f1": [round(h["f1"], 4) for h in host.history],
        "device_window_f1": [round(h["f1"], 4) for h in dev.history],
        "host_best_f1": round(host.best_f1, 4),
        "device_best_f1": round(dev.best_f1, 4),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.ab_sampling",
                                 description="host uniform subsample vs device rotation window")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    import torch

    from code2vec_tpu_torch.ops.backend import resolve_device

    device = resolve_device(args.device)
    row = run(device)
    row["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
