"""Import a checkpoint of the reference implementation into a port model dir.

Counterpart of ``tools/import_reference_checkpoint.py``, with the same
flags (and ``--device``). The reference saves ``torch.save(model.
state_dict(), <model_path>/code2vec.model)`` on every new best F1
(reference main.py:231); this tool turns that file, with the corpus and
vocab files it was trained on, into a model dir of the port::

    python -m code2vec_tpu_torch.tools.import_reference_checkpoint \\
        --reference_model /path/to/output/code2vec.model \\
        --corpus_path corpus.txt --terminal_idx_path terminal_idxs.txt \\
        --path_idx_path path_idxs.txt --model_path out/ [--device cpu]

``out/`` then works wherever a trained model dir does: ``predict``,
``serve``, ``--export_only``, and ``--resume``, which fine-tunes from the
written checkpoint (``checkpoint_best.pt``) with fresh optimizer moments
(the reference's file has none). The dir holds ``model_meta.json`` and
``label_vocab.txt`` (``predict.save_inference_meta``), the weights as
``code2vec.model`` and the checkpoint.

The label vocabulary is rebuilt from the corpus in the reference's
insertion order (``data/reader.py``), and every dimension of the
``state_dict`` is checked against the corpus and vocab files before
anything is written. Then the port's model (the serving forward's default
route, ``fused``: K3 on the card) and ``interop.reference_forward`` (the
reference's forward from the ``state_dict`` alone) run one probe batch from
the corpus, and the tool refuses to write unless their logits agree to
``--atol`` (default 2e-4: the two reduce in other orders). It runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("import_reference_checkpoint")

PROBE_ROWS = 8


def probe_diff(model, sd: dict, dims: dict, batch: dict, angular_margin: float,
               inverse_temp: float) -> float:
    """``max |ours - theirs|`` of the port's eval forward and the
    reference's (``interop.reference_forward``) logits on ``batch``'s ids,
    both on the model's device."""
    from code2vec_tpu_torch import interop

    dev = next(model.parameters()).device
    ids = [torch.as_tensor(np.asarray(batch[k], np.int32), device=dev)
           for k in ("starts", "paths", "ends", "labels")]
    model.eval()
    with torch.inference_mode():
        ours = model(*ids[:3], labels=ids[3])[0].float()
        theirs = interop.reference_forward({k: v.to(dev) for k, v in sd.items()}, dims,
                                           *ids, angular_margin, inverse_temp)
        return float((ours - theirs).abs().max())


def run_import(args) -> dict:
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.checkpoint import TrainMeta, save_checkpoint
    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_batches, split_items
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops.backend import resolve_device
    from code2vec_tpu_torch.predict import save_inference_meta, save_model_file
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer

    device = resolve_device(args.device)
    try:
        sd = interop.load_state_dict(args.reference_model)
        dims = interop.infer_dims(sd)
    except ValueError as e:  # a state_dict of another layout or shape
        raise SystemExit(str(e)) from e
    logger.info("state_dict dims: %s", dims)
    data = load_corpus(args.corpus_path, args.path_idx_path, args.terminal_idx_path,
                       infer_method=args.infer_method_name,
                       infer_variable=args.infer_variable_name, cache=not args.no_corpus_cache)
    mismatches = [
        (name, have, want)
        for name, have, want in (
            ("terminal vocab", len(data.terminal_vocab), dims["terminal_count"]),
            ("path vocab", len(data.path_vocab), dims["path_count"]),
            ("label vocab", len(data.label_vocab), dims["label_count"]),
        )
        if have != want
    ]
    if mismatches:
        raise SystemExit(
            "corpus/vocab files do not match the checkpoint: "
            + "; ".join(f"{n}: files give {h}, checkpoint has {w}" for n, h, w in mismatches)
            + "\n(pass the exact corpus + idx files the reference trained on,"
            " and the same --infer_method_name/--infer_variable_name flags)"
        )

    config = TrainConfig(
        batch_size=min(PROBE_ROWS, data.n_items), max_path_length=args.max_path_length,
        terminal_embed_size=dims["terminal_embed_size"],
        path_embed_size=dims["path_embed_size"], encode_size=dims["encode_size"],
        dropout_prob=args.dropout_prob, angular_margin_loss=dims["angular_margin_loss"],
        angular_margin=args.angular_margin, inverse_temp=args.inverse_temp,
        infer_method_name=args.infer_method_name,
        infer_variable_name=args.infer_variable_name, vocab_pad_multiple=1,
    )
    model_config = Code2VecConfig(
        terminal_count=dims["terminal_count"], path_count=dims["path_count"],
        label_count=dims["label_count"], terminal_embed_size=dims["terminal_embed_size"],
        path_embed_size=dims["path_embed_size"], encode_size=dims["encode_size"],
        dropout_prob=args.dropout_prob, angular_margin_loss=dims["angular_margin_loss"],
        angular_margin=args.angular_margin, inverse_temp=args.inverse_temp,
        vocab_pad_multiple=1, use_pallas=True, pallas_impl="fused",
    )
    with torch.device("meta"):
        model = Code2Vec(model_config)
    model.load_state_dict(sd, strict=True, assign=True)
    model.to(device)

    rng = np.random.default_rng(0)
    probe_items = np.arange(min(PROBE_ROWS, data.n_items))
    epoch = build_method_epoch(data, probe_items, args.max_path_length, rng)
    batch = next(iter_batches(epoch, len(probe_items), rng=rng, pad_final=False))
    # with --infer_method_name False the method labels are -1 (unused for
    # training); the margin head's one-hot needs a valid class on both sides
    # of the probe, and which class it is does not affect the comparison
    batch = dict(batch, labels=np.maximum(np.asarray(batch["labels"]), 0))
    diff = probe_diff(model, sd, dims, batch, args.angular_margin, args.inverse_temp)
    logger.info("probe max |dlogits| vs the reference forward on %s: %.3g", device, diff)
    if not diff <= args.atol:
        raise SystemExit(
            f"imported forward disagrees with the reference: max |d| = "
            f"{diff:.3g} > atol {args.atol:.3g} — refusing to write"
        )

    os.makedirs(args.model_path, exist_ok=True)
    save_inference_meta(args.model_path, config, model_config, data)
    save_model_file(args.model_path, model)
    # what a fresh run holds at epoch 0: the split drawn, fresh Adam moments,
    # the dropout stream of the run's seed on the device a resume runs on
    np_rng = np.random.default_rng(config.random_seed)
    split_items(data.n_items, np_rng)
    model.seed_dropout(config.random_seed)
    path = save_checkpoint(args.model_path, "best", model, make_optimizer(model, config),
                           TrainMeta(epoch=0, best_f1=None, vocab_pad_multiple=1), np_rng)
    return {"imported": os.path.abspath(path), "probe_max_abs_logit_diff": diff,
            "device": str(device), **dims}


def build_parser() -> argparse.ArgumentParser:
    from code2vec_tpu_torch.cli import _strtobool

    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.tools.import_reference_checkpoint",
        description="Convert a reference code2vec.model (torch state_dict) into a model dir "
                    "of the port.")
    parser.add_argument("--reference_model", required=True,
                        help="path to code2vec.model (or the directory containing it)")
    parser.add_argument("--corpus_path", required=True)
    parser.add_argument("--terminal_idx_path", required=True)
    parser.add_argument("--path_idx_path", required=True)
    parser.add_argument("--model_path", required=True, help="output dir")
    parser.add_argument("--max_path_length", type=int, default=200)
    parser.add_argument("--dropout_prob", type=float, default=0.25)
    # runtime constants of the margin head, not stored in the state_dict
    # (reference main.py:74-75 defaults)
    parser.add_argument("--angular_margin", type=float, default=0.5)
    parser.add_argument("--inverse_temp", type=float, default=30.0)
    parser.add_argument("--infer_method_name", type=_strtobool, default=True)
    parser.add_argument("--infer_variable_name", type=_strtobool, default=False)
    parser.add_argument("--no_corpus_cache", action="store_true")
    parser.add_argument("--atol", type=float, default=2e-4)
    parser.add_argument("--device", default=None,
                        help="torch device of the probe and the checkpoint (default cuda; "
                        "'cpu' runs the plain versions)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    print(json.dumps(run_import(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
