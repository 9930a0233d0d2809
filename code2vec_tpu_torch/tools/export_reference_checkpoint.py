"""Export a model of the port to the reference implementation's format.

Counterpart of ``tools/export_reference_checkpoint.py``, with the same
flags (and ``--device``); the inverse of
``tools/import_reference_checkpoint``. It writes the ``code2vec.model``
``state_dict`` that the reference's ``torch.save(model.state_dict(), ...)``
produces (reference main.py:231), so a model trained here can be served or
fine-tuned by the reference's code::

    python -m code2vec_tpu_torch.tools.export_reference_checkpoint \\
        --model_path out/ --output /path/to/refout/code2vec.model [--device cpu]

``--model_path`` is a model dir or one checkpoint file in it. The weights
come from the given checkpoint, else the dir's best checkpoint, else its
last, else its ``code2vec.model``; dims and head from ``model_meta.json``
(written at train time, or by the import tool). Vocab pad rows and head
columns past the true vocab sizes are sliced off (exact: pad ids never
occur in data). Before writing, the port's model (the serving forward's
default route, ``fused``: K3 on the card) and ``interop.reference_forward``
(the reference's forward from the sliced ``state_dict`` alone) run one
random probe batch, and the tool refuses unless their logits agree to
``--atol``. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("export_reference_checkpoint")

PROBE_ROWS = 4


def model_weights(model_path: str) -> tuple[dict, str]:
    """``(state_dict, the file it came from)`` of a model dir or of one
    checkpoint file."""
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.checkpoint import SLOTS, _read, slot_path

    if os.path.isfile(model_path) and model_path.endswith(".pt"):
        candidates = [model_path]
    else:
        candidates = [slot_path(model_path, slot) for slot in SLOTS]
    for path in candidates:
        state = _read(path) if os.path.exists(path) else None
        if state is not None:
            return {k: v.float() for k, v in state["model"].items()}, path
    if os.path.isdir(model_path) and os.path.exists(os.path.join(model_path, interop.MODEL_FILE)):
        path = os.path.join(model_path, interop.MODEL_FILE)
        return interop.load_state_dict(path), path
    raise SystemExit(f"no checkpoint found under {model_path}")


def run_export(args) -> dict:
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops.backend import resolve_device
    from code2vec_tpu_torch.predict import MODEL_META
    from code2vec_tpu_torch.tools.import_reference_checkpoint import probe_diff

    model_dir = args.model_path if os.path.isdir(args.model_path) \
        else os.path.dirname(os.path.abspath(args.model_path))
    meta_file = os.path.join(model_dir, MODEL_META)
    if not os.path.exists(meta_file):
        raise SystemExit(
            f"{meta_file} not found — the model dir must come from a train run (or "
            "tools/import_reference_checkpoint), which writes the model dims there")
    with open(meta_file, encoding="utf-8") as f:
        meta = json.load(f)
    device = resolve_device(args.device)
    config = Code2VecConfig(
        terminal_count=meta["terminal_count"], path_count=meta["path_count"],
        label_count=meta["label_count"], terminal_embed_size=meta["terminal_embed_size"],
        path_embed_size=meta["path_embed_size"], encode_size=meta["encode_size"],
        angular_margin_loss=meta["angular_margin_loss"], angular_margin=meta["angular_margin"],
        inverse_temp=meta["inverse_temp"], vocab_pad_multiple=meta.get("vocab_pad_multiple") or 1,
        use_pallas=True, pallas_impl="fused",
    )
    weights, source = model_weights(args.model_path)
    try:
        interop.check_dims(weights, config)
    except ValueError as e:
        raise SystemExit(f"{source} does not fit {meta_file}: {e}") from e
    with torch.device("meta"):
        model = Code2Vec(config)
    model.load_state_dict(interop.pad_state_dict(weights, config), strict=True, assign=True)
    model.to(device)

    sd = interop.unpad_state_dict(model.state_dict(), config)
    # dims re-derived from the sliced tensors: a model_meta.json that
    # disagrees with the weights fails here with a clear message
    dims = interop.infer_dims(sd)
    for key in ("encode_size", "angular_margin_loss", "label_count"):
        if dims[key] != meta[key]:
            raise SystemExit(f"model_meta.json disagrees with the checkpoint: {key} is "
                             f"{meta[key]} in the meta but {dims[key]} in the tensors")

    # a synthetic probe is enough: both forwards see the same inputs
    rng = np.random.default_rng(0)
    bag = min(32, int(meta.get("max_path_length", 200)))
    batch = {
        "starts": rng.integers(1, meta["terminal_count"], (PROBE_ROWS, bag), dtype=np.int32),
        "paths": rng.integers(1, meta["path_count"], (PROBE_ROWS, bag), dtype=np.int32),
        "ends": rng.integers(1, meta["terminal_count"], (PROBE_ROWS, bag), dtype=np.int32),
        "labels": rng.integers(0, meta["label_count"], (PROBE_ROWS,), dtype=np.int32),
    }
    batch["starts"][:, bag // 2:] = 0  # the padding mask too
    diff = probe_diff(model, sd, dims, batch, meta["angular_margin"], meta["inverse_temp"])
    logger.info("probe max |dlogits| vs the reference forward on %s: %.3g", device, diff)
    if not diff <= args.atol:
        raise SystemExit(
            f"exported forward disagrees with this checkpoint: max |d| = "
            f"{diff:.3g} > atol {args.atol:.3g} — refusing to write")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    path = interop.save_state_dict(sd, args.output)
    return {"exported": os.path.abspath(path), "source": os.path.abspath(source),
            "probe_max_abs_logit_diff": diff, "device": str(device),
            "terminal_count": meta["terminal_count"], "path_count": meta["path_count"],
            "label_count": meta["label_count"],
            "angular_margin_loss": meta["angular_margin_loss"]}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.tools.export_reference_checkpoint",
        description="Convert a model dir of the port into the reference's code2vec.model "
                    "torch state_dict.")
    parser.add_argument("--model_path", required=True,
                        help="trained model dir (checkpoint + model_meta.json), or one "
                        "checkpoint file in it")
    parser.add_argument("--output", required=True,
                        help="output file (conventionally <dir>/code2vec.model)")
    parser.add_argument("--atol", type=float, default=2e-4)
    parser.add_argument("--device", default=None,
                        help="torch device of the probe (default cuda; 'cpu' runs the plain "
                        "versions)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    print(json.dumps(run_export(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
