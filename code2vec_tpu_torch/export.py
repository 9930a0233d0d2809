"""Vector export and sample printing (reference: main.py:226-230,362-423).

Counterpart of ``code2vec_tpu/export.py``. ``code.vec`` is rewritten on
every new best F1: a header line, then the train rows followed by the test
rows (each split's method rows, then its variable rows); the optional test-result TSV records each test prediction.
``print_sample`` logs one correctly predicted test example with its
per-context attention, PAD rows skipped. ``export_from_checkpoint`` is the
``--export_only`` pass. ``export_file_vectors`` pools method vectors by
source file (``models/hierarchical.py``) into a ``file.vec`` in
``code.vec``'s format, which the exact backend and ``tools/ann_build``
take as they take ``code.vec``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from code2vec_tpu_torch import PAD_INDEX
from code2vec_tpu_torch.data.pipeline import EpochArrays, iter_batches
from code2vec_tpu_torch.formats.vectors_io import (
    append_code_vectors,
    write_code_vectors_header,
    write_test_results,
)
from code2vec_tpu_torch.ops.autotune import pin_cache
from code2vec_tpu_torch.train.step import eval_step, to_device

logger = logging.getLogger(__name__)


def _eval_whole(model, batch: dict, class_weights, quant_tables=None) -> dict:
    """The eval step's outputs of a whole host batch. On a mesh (every rank
    calls it with the same batch) each rank runs its rows and bag columns
    and the outputs are all-gathered over the data line (the attention
    over the ctx line too)."""
    device = class_weights.device
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return eval_step(model, to_device(batch, device), class_weights, quant_tables)
    from code2vec_tpu_torch.parallel.distributed import _all_gather, global_batch

    out = eval_step(model, to_device(global_batch(mesh, batch), device), class_weights,
                    quant_tables)
    data_group, ctx_group = mesh.group("data"), mesh.group("ctx")
    whole = {k: (v if data_group is None or k == "loss" else _all_gather(v, data_group, 0))
             for k, v in out.items()}
    if ctx_group is not None:
        whole["attention"] = _all_gather(whole["attention"], ctx_group, 1)
    return whole


def _writes(model) -> bool:
    mesh = getattr(model, "mesh", None)
    return mesh is None or mesh.rank == 0


def _forward_all(model, epoch: EpochArrays, batch_size: int, class_weights,
                 quant_tables=None):
    """The eval step over every example: host arrays ``(labels, ids, preds,
    max_logit, code_vectors)``, padding rows removed."""
    labels, ids, outs = [], [], []
    for batch in iter_batches(epoch, batch_size, rng=None, pad_final=True):
        out = _eval_whole(model, batch, class_weights, quant_tables)
        valid = batch["example_mask"].astype(bool)
        labels.append(batch["labels"][valid])
        ids.append(batch["ids"][valid])
        outs.append((out["preds"], out["max_logit"], out["code_vector"], valid))
    preds, logits, vectors = (
        np.concatenate([o[k].cpu().numpy()[o[3]] for o in outs]) for k in range(3))
    return np.concatenate(labels), np.concatenate(ids), preds, logits, vectors


def write_code_vectors(data, model, train_epoch: EpochArrays, test_epoch: EpochArrays,
                       batch_size: int, vectors_path: str, encode_size: int, class_weights,
                       test_result_path: str | None = None, quant_tables=None):
    """Rewrite ``code.vec`` (train rows, then test rows) and optionally the
    test TSV. The header counts the rows written. Returns the test split's
    ``(labels, preds)``. On a mesh every rank runs the forward and rank 0
    writes (JAX ``export.py:80``)."""
    writes = _writes(model)
    if writes:
        write_code_vectors_header(vectors_path, len(train_epoch) + len(test_epoch), encode_size)
    itos = data.label_vocab.itos
    test_labels = test_preds = np.zeros(0, np.int32)
    for split_epoch, is_test in ((train_epoch, False), (test_epoch, True)):
        if len(split_epoch) == 0:
            # an empty test split still leaves the TSV asked for
            if is_test and test_result_path is not None and writes:
                open(test_result_path, "w", encoding="utf-8").close()
            continue
        labels, ids, preds, max_logit, vectors = _forward_all(
            model, split_epoch, batch_size, class_weights, quant_tables)
        if is_test:
            test_labels, test_preds = labels, preds
        if not writes:
            continue
        label_names = [itos[int(label)] for label in labels]
        append_code_vectors(vectors_path, label_names, vectors)
        if is_test and test_result_path is not None:
            with open(test_result_path, "w", encoding="utf-8") as f:
                write_test_results(f, ids.tolist(), label_names,
                                   [itos[int(p)] for p in preds], max_logit.tolist())
    return test_labels, test_preds


def print_sample(data, model, test_epoch: EpochArrays, batch_size: int, class_weights) -> None:
    """Log one correctly predicted test example with each real context's
    attention weight (reference: main.py:362-390)."""
    terminal_itos = data.terminal_vocab.itos
    path_itos = data.path_vocab.itos
    label_itos = data.label_vocab.itos
    for batch in iter_batches(test_epoch, batch_size, rng=None, pad_final=True):
        out = _eval_whole(model, batch, class_weights)
        preds = out["preds"].cpu().numpy()
        attn = out["attention"].cpu().numpy()
        hits = np.nonzero((preds == batch["labels"]) & batch["example_mask"].astype(bool))[0]
        if not len(hits):
            continue
        i = int(hits[0])
        for s, p, e, a in zip(batch["starts"][i], batch["paths"][i], batch["ends"][i], attn[i]):
            if s != PAD_INDEX:
                logger.info("%s %s %s [%s]", terminal_itos[int(s)], path_itos[int(p)],
                            terminal_itos[int(e)], a)
        logger.info("expected label: %s", label_itos[int(batch["labels"][i])])
        logger.info("actual label:   %s", label_itos[int(preds[i])])
        return


def export_file_vectors(method_vectors: np.ndarray, group_ids, vectors_path: str,
                        attn_param: np.ndarray | None = None, group_names=None
                        ) -> tuple[list, np.ndarray]:
    """Attention-pool ``method_vectors [N, H]`` by ``group_ids`` (one file
    or class key a vector) and write one row a group in ``code.vec``'s
    format, labelled ``group_names[key]`` (default ``str(key)``).
    ``attn_param``: the checkpoint's method-level attention vector (None:
    the mean). Returns ``(group keys, [G, H] f32)``."""
    from code2vec_tpu_torch.models.hierarchical import pool_vectors_by_group

    keys, pooled = pool_vectors_by_group(method_vectors, group_ids, attn_param)
    names = [str(group_names[k]) if group_names is not None else str(k) for k in keys]
    write_code_vectors_header(vectors_path, len(names), pooled.shape[-1])
    append_code_vectors(vectors_path, names, pooled)
    logger.info("exported %d file vectors (from %d method vectors) to %s", len(names),
                len(method_vectors), vectors_path)
    return keys, pooled


def export_from_checkpoint(config, data, out_dir: str, vectors_path: str,
                           test_result_path: str | None = None, *, device=None) -> float:
    """Restore the best checkpoint in ``out_dir`` and rewrite ``code.vec``
    (+ the test TSV) without training; returns the restored model's test
    F1. With a quantized ``table_dtype`` the vectors are those a quantized
    deployment would serve."""
    from code2vec_tpu_torch.checkpoint import restore_checkpoint
    from code2vec_tpu_torch.data.pipeline import build_epoch, split_items
    from code2vec_tpu_torch.metrics import evaluate
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.ops.backend import resolve_device
    from code2vec_tpu_torch.train.loop import build_mesh, class_weights_from, model_config_from

    config.validate(training=False)
    # pin the schedule cache before the first forward, as train() does (JAX
    # export.py:225-229): --pallas_impl auto reads the file the run tuned into
    pin_cache(config.autotune_cache)
    dev = resolve_device(device)
    # on a mesh (JAX builds it for the export pass too) every rank runs the
    # forward over its shards and rank 0 writes
    mesh = build_mesh(config)
    if mesh is not None:
        from code2vec_tpu_torch.parallel.distributed import rank_device
        from code2vec_tpu_torch.parallel.shardings import shard_model

        dev = rank_device(dev)
    np_rng = np.random.default_rng(config.random_seed)
    train_idx, test_idx = split_items(data.n_items, np_rng)
    model_config = model_config_from(config, data)
    with torch.device(dev):
        model = Code2Vec(model_config.with_updates(table_dtype="f32"))
    if mesh is not None:
        shard_model(model, mesh)
    meta = restore_checkpoint(out_dir, model, None, np.random.default_rng(0),
                              model_config.vocab_pad_multiple, prefer_best=True, mesh=mesh)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint found under {out_dir}")
    logger.info("restored checkpoint (epoch %d, best_f1=%s)", meta.epoch, meta.best_f1)
    quant_tables = None
    if model_config.table_dtype != "f32":
        model.config = model_config
        quant_tables = model.quantize_tables()
    class_weights = class_weights_from(config, data, dev)
    train_epoch = build_epoch(data, train_idx, config.max_path_length, np_rng,
                              config.shuffle_variable_indexes)
    test_epoch = build_epoch(data, test_idx, config.max_path_length, np_rng,
                             config.shuffle_variable_indexes)
    labels, preds = write_code_vectors(
        data, model, train_epoch, test_epoch, config.batch_size, vectors_path,
        config.encode_size, class_weights, test_result_path, quant_tables)
    f1 = evaluate(config.eval_method, labels, preds, data.label_vocab)[3]
    logger.info("exported %s (test f1=%s)", vectors_path, f1)
    return f1
