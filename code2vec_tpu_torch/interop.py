"""Weights across frameworks: JAX param tree <-> reference ``state_dict``.

Own copy of the mapping of ``code2vec_tpu/interop.py:36-156`` (the port
imports nothing from the JAX package). The reference layout (reference
model/model.py:21-42) is what the port's ``Code2Vec`` holds:

    terminal_embedding.weight [T, dt]  <-> terminal_embedding/embedding
    path_embedding.weight     [P, dp]  <-> path_embedding/embedding
    input_linear.weight   [H, 2dt+dp]  <-> input_dense/kernel (TRANSPOSED:
                                           torch Linear stores [out, in];
                                           concat order start|path|end)
    input_layer_norm.weight/bias  [H]  <-> input_layer_norm/scale, bias
    attention_parameter           [H]  <-> attention
    output_linear.weight/bias (plain)  <-> output_dense/kernel (T), bias
    output_linear (margin Parameter)   <-> output_margin_weight

:func:`state_dict_from_jax_params` keeps the tree's shapes, vocab padding
included, so the round trip tree -> state_dict -> tree is exact.
The file-level head of ``models/hierarchical.py`` carries its one
parameter both ways (:func:`hierarchical_state_dict_from_jax_params`,
:func:`jax_params_from_hierarchical_state_dict`):

    file_attention                [H]  <-> file_attention

``code2vec.model`` files hold the reference's unpadded shapes:
:func:`save_state_dict` slices the pad rows off and :func:`pad_state_dict`
puts zero rows back for a padded config.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PLAIN_KEYS = {
    "terminal_embedding.weight",
    "path_embedding.weight",
    "input_linear.weight",
    "input_layer_norm.weight",
    "input_layer_norm.bias",
    "attention_parameter",
    "output_linear.weight",
    "output_linear.bias",
}
MARGIN_KEYS = (PLAIN_KEYS - {"output_linear.weight", "output_linear.bias"}) | {
    "output_linear"
}
MODEL_FILE = "code2vec.model"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax_params(params: dict, config) -> dict[str, torch.Tensor]:
    """A JAX ``Code2Vec`` param tree (numpy leaves) -> the port's
    ``state_dict`` for ``config`` (shapes kept, padding included)."""
    sd = {
        "terminal_embedding.weight": _t(params["terminal_embedding"]["embedding"]),
        "path_embedding.weight": _t(params["path_embedding"]["embedding"]),
        "input_linear.weight": _t(np.asarray(params["input_dense"]["kernel"]).T),
        "input_layer_norm.weight": _t(params["input_layer_norm"]["scale"]),
        "input_layer_norm.bias": _t(params["input_layer_norm"]["bias"]),
        "attention_parameter": _t(params["attention"]),
    }
    if config.angular_margin_loss:
        sd["output_linear"] = _t(params["output_margin_weight"])
    else:
        sd["output_linear.weight"] = _t(np.asarray(params["output_dense"]["kernel"]).T)
        sd["output_linear.bias"] = _t(params["output_dense"]["bias"])
    return sd


def jax_params_from_state_dict(sd: dict, config) -> dict:
    """Inverse of :func:`state_dict_from_jax_params`: numpy param tree."""

    def a(key):
        return np.ascontiguousarray(sd[key].detach().cpu().numpy().astype(np.float32))

    tree = {
        "terminal_embedding": {"embedding": a("terminal_embedding.weight")},
        "path_embedding": {"embedding": a("path_embedding.weight")},
        "input_dense": {"kernel": np.ascontiguousarray(a("input_linear.weight").T)},
        "input_layer_norm": {
            "scale": a("input_layer_norm.weight"),
            "bias": a("input_layer_norm.bias"),
        },
        "attention": a("attention_parameter"),
    }
    if config.angular_margin_loss:
        tree["output_margin_weight"] = a("output_linear")
    else:
        tree["output_dense"] = {
            "kernel": np.ascontiguousarray(a("output_linear.weight").T),
            "bias": a("output_linear.bias"),
        }
    return tree


def hierarchical_state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``HierarchicalAttentionPool`` param tree -> the port module's
    ``state_dict``."""
    return {"file_attention": _t(params["file_attention"])}


def jax_params_from_hierarchical_state_dict(sd: dict) -> dict:
    """Inverse of :func:`hierarchical_state_dict_from_jax_params`."""
    return {"file_attention": np.ascontiguousarray(
        sd["file_attention"].detach().cpu().numpy().astype(np.float32))}


def check_keys(sd: dict) -> None:
    keys = set(sd)
    if keys not in (PLAIN_KEYS, MARGIN_KEYS):
        raise ValueError(
            f"unrecognized state_dict layout: {sorted(keys)}; expected the "
            "reference Code2Vec model (plain or angular-margin head)"
        )


def check_dims(sd: dict, config) -> None:
    """Raise unless ``sd``'s shapes fit ``config`` (unpadded or padded)."""
    check_keys(sd)
    c = config
    d_in = 2 * c.terminal_embed_size + c.path_embed_size
    head = "output_linear" if c.angular_margin_loss else "output_linear.weight"
    if head not in sd:
        raise ValueError(
            f"config says angular_margin_loss={c.angular_margin_loss} but the "
            f"state_dict has no {head!r}"
        )
    expect = {
        "terminal_embedding.weight": (c.terminal_count, c.terminal_embed_size),
        "path_embedding.weight": (c.path_count, c.path_embed_size),
        "input_linear.weight": (c.encode_size, d_in),
        head: (c.label_count, c.encode_size),
    }
    for key, (rows, cols) in expect.items():
        shape = tuple(sd[key].shape)
        ok_rows = (rows,) if key == "input_linear.weight" else (rows, c.padded(rows))
        if len(shape) != 2 or shape[0] not in ok_rows or shape[1] != cols:
            raise ValueError(f"{key} is {shape}, expected ({rows}, {cols}) for the model meta")


def _resize_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    if t.shape[0] > rows:
        return t[:rows].clone()
    pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype)
    return torch.cat([t, pad])


def _row_counts(config, padded: bool) -> dict[str, int]:
    def n(count):
        return config.padded(count) if padded else count

    return {
        "terminal_embedding.weight": n(config.terminal_count),
        "path_embedding.weight": n(config.path_count),
        "output_linear.weight": n(config.label_count),
        "output_linear.bias": n(config.label_count),
        "output_linear": n(config.label_count),
    }


def pad_state_dict(sd: dict, config) -> dict[str, torch.Tensor]:
    """Reference (unpadded) shapes -> ``config``'s padded shapes: zero rows
    for pad ids that never occur and for head columns that are sliced off."""
    rows = _row_counts(config, padded=True)
    return {k: _resize_rows(v, rows[k]) if k in rows else v for k, v in sd.items()}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """``torch.load`` a reference ``code2vec.model`` (CPU, weights only)."""
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.detach().float() for k, v in sd.items()}
    check_keys(sd)
    return sd


def save_state_dict(sd: dict, path: str, config=None) -> str:
    """Write a reference ``code2vec.model``; with ``config`` the vocab pad
    rows are sliced off first (the reference has no padding)."""
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    check_keys(sd)
    out = {k: v.detach().cpu().float().contiguous() for k, v in sd.items()}
    if config is not None:
        rows = _row_counts(config, padded=False)
        out = {k: _resize_rows(v, rows[k]) if k in rows else v for k, v in out.items()}
    torch.save(out, path)
    return path
