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
included, so the round trip tree -> state_dict -> tree is exact; on a mesh
:func:`rank_state_dict_from_jax_params` carries the tree to one rank's
shards and :func:`jax_params_from_rank_state_dict` back, as exactly.
The file-level head of ``models/hierarchical.py`` carries its one
parameter both ways (:func:`hierarchical_state_dict_from_jax_params`,
:func:`jax_params_from_hierarchical_state_dict`):

    file_attention                [H]  <-> file_attention

``code2vec.model`` files hold the reference's unpadded shapes:
:func:`save_state_dict` slices the pad rows off and :func:`pad_state_dict`
puts zero rows back for a padded config. :func:`infer_dims` reads a
reference ``state_dict``'s dims, and :func:`reference_forward` is the
reference's eval-mode forward written from the ``state_dict`` alone: the
second opinion the checkpoint tools (``tools/import_reference_checkpoint``,
``tools/export_reference_checkpoint``) hold the port's model to before
they write.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

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


def _mesh_entries(config, mesh) -> dict[str, list]:
    """Each key's spec on ``mesh`` over ``config``'s padded global shapes."""
    from code2vec_tpu_torch.parallel.shardings import spec_for_param

    c = config
    labels = (c.padded(c.label_count), c.encode_size)
    shapes = {"terminal_embedding.weight": (c.padded(c.terminal_count), c.terminal_embed_size),
              "path_embedding.weight": (c.padded(c.path_count), c.path_embed_size),
              "output_linear.weight": labels, "output_linear": labels,
              "output_linear.bias": labels[:1]}
    return {k: spec_for_param(k, mesh.shape, shape) for k, shape in shapes.items()}


def rank_state_dict_from_jax_params(params: dict, config, mesh) -> dict[str, torch.Tensor]:
    """A JAX param tree (global, padded to ``config.vocab_pad_multiple``,
    the model axis by default) -> this rank's shards of the port's
    ``state_dict`` on ``mesh`` (``parallel/shardings.py``'s rules)."""
    from code2vec_tpu_torch.parallel.shardings import shard_tensor

    entries = _mesh_entries(config, mesh)
    return {k: shard_tensor(v, entries.get(k), mesh)
            for k, v in state_dict_from_jax_params(params, config).items()}


def jax_params_from_rank_state_dict(sd: dict, config, mesh) -> dict:
    """Inverse of :func:`rank_state_dict_from_jax_params`: the shards
    all-gathered over the model line (every rank calls it), then the numpy
    param tree; exact, the padding rows included."""
    from code2vec_tpu_torch.parallel.shardings import unshard_tensor

    entries = _mesh_entries(config, mesh)
    return jax_params_from_state_dict(
        {k: unshard_tensor(v.detach(), entries.get(k), mesh) for k, v in sd.items()}, config)


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


def unpad_state_dict(sd: dict, config) -> dict[str, torch.Tensor]:
    """Inverse of :func:`pad_state_dict`: the reference's unpadded shapes,
    the vocab pad rows and head columns sliced off (exact: pad ids never
    occur in data)."""
    rows = _row_counts(config, padded=False)
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
        out = unpad_state_dict(out, config)
    torch.save(out, path)
    return path


def infer_dims(sd: dict) -> dict:
    """A reference ``state_dict``'s dims and head (JAX ``interop.infer_dims``,
    ``code2vec_tpu/interop.py:84``); raises ``ValueError`` when the encoder
    does not take ``[start; path; end]``."""
    t_count, t_dim = sd["terminal_embedding.weight"].shape
    p_count, p_dim = sd["path_embedding.weight"].shape
    encode = sd["input_layer_norm.weight"].shape[0]
    margin = "output_linear.weight" not in sd
    head = sd["output_linear"] if margin else sd["output_linear.weight"]
    expect_in = 2 * t_dim + p_dim
    got_out, got_in = sd["input_linear.weight"].shape
    if (got_out, got_in) != (encode, expect_in):
        raise ValueError(
            f"input_linear.weight is {got_out}x{got_in}, expected "
            f"{encode}x{expect_in} (encode x 2*terminal_embed+path_embed)"
        )
    return {
        "terminal_count": int(t_count),
        "path_count": int(p_count),
        "label_count": int(head.shape[0]),
        "terminal_embed_size": int(t_dim),
        "path_embed_size": int(p_dim),
        "encode_size": int(encode),
        "angular_margin_loss": margin,
    }


def reference_forward(sd: dict, dims: dict, starts, paths, ends, labels,
                      angular_margin: float, inverse_temp: float) -> torch.Tensor:
    """The reference's ``Code2Vec.forward`` in eval mode (reference
    model/model.py:44-88; JAX ``interop.reference_forward``,
    ``code2vec_tpu/interop.py:170``): logits ``[B, label_count]`` f32 from
    ``sd``'s tensors alone, on their device, with no module of this package.
    The id arrays (numpy or tensors) are ``[B, L]``, ``labels`` ``[B]``
    (the margin head places its margin there)."""
    t = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    dev = t["attention_parameter"].device

    def ids(x):
        return torch.as_tensor(x, device=dev).long()

    starts_t, paths_t, ends_t = ids(starts), ids(paths), ids(ends)
    ccv = torch.cat((t["terminal_embedding.weight"][starts_t],
                     t["path_embedding.weight"][paths_t],
                     t["terminal_embedding.weight"][ends_t]), dim=2)
    ccv = ccv @ t["input_linear.weight"].T
    ccv = F.layer_norm(ccv, (dims["encode_size"],),
                       t["input_layer_norm.weight"], t["input_layer_norm.bias"])
    ccv = torch.tanh(ccv)
    mask = (starts_t > 0).float()
    ninf = -3.4e38
    attn = F.softmax((ccv * t["attention_parameter"]).sum(-1) * mask + (1 - mask) * ninf,
                     dim=1)
    code_vector = (ccv * attn.unsqueeze(-1)).sum(1)
    if not dims["angular_margin_loss"]:
        return code_vector @ t["output_linear.weight"].T + t["output_linear.bias"]
    cosine = F.normalize(code_vector) @ F.normalize(t["output_linear"]).T
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, min=0.0))
    phi = cosine * math.cos(angular_margin) - sine * math.sin(angular_margin)
    phi = torch.where(cosine > 0, phi, cosine)
    one_hot = torch.zeros_like(cosine)
    one_hot.scatter_(1, ids(labels).view(-1, 1), 1)
    return ((one_hot * phi) + ((1.0 - one_hot) * cosine)) * inverse_temp
