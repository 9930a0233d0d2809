"""Sharding rules: which dimension of which tensor lives on which axis.

Counterpart of ``code2vec_tpu/parallel/shardings.py`` over the port's
``state_dict`` keys (``interop.py``):

- ``terminal_embedding.weight`` / ``path_embedding.weight`` ``[V, E]``:
  row-sharded over ``model`` (JAX ``P("model", None)``);
- ``output_linear.weight`` ``[label, E]`` and ``output_linear.bias``
  ``[label]`` (JAX ``output_dense/kernel [E, label]`` ``P(None, "model")``,
  the layout transposed) and the margin head ``output_linear`` ``[label,
  E]``: sharded over ``model`` along the labels;
- the encoder, LayerNorm and attention vector: replicated (``P()``).

A dim shards only when the axis divides it; otherwise it replicates
(``vocab_pad_multiple``, auto = ``model_axis``, pads the tables so the
shard happens). The Adam moments take their parameter's rule, the lazy
table optimizer's too (its dense part's under ``"dense"``). Retrieval
takes the tables' rule (:func:`retrieval_shardings`,
:func:`ann_shardings`): the exact index's rows and the IVF-PQ cells over
``model``.

Specs are written JAX's way (one entry a dim: None or an axis name,
``[]`` for ``P()``), so :func:`pytree_spec_doc` gives a checkpoint's
``shardings.json`` sidecar in JAX's format, and the restore validates it
(:func:`validate_runtime_spec`, the port's copy of JAX
``analysis/sharding_check.py:267``, rules SC001 and SC002). A checkpoint
holds global tensors, so a restore onto another mesh shape is a re-slice
(:func:`shard_state`) to the layout the restoring model runs with; JAX
instead re-binds the saved specs to the new mesh (:func:`rebind`, its
``rebind_abstract_shardings``, kept for the sidecar's readers): its GSPMD
step runs any layout, the port's sharded forward runs one.
"""

from __future__ import annotations

from typing import Iterable

import torch

from code2vec_tpu_torch.parallel.distributed import _all_gather
from code2vec_tpu_torch.parallel.mesh import AXIS_CTX, AXIS_DATA, AXIS_MODEL, Mesh

TABLE_KEYS = ("terminal_embedding.weight", "path_embedding.weight")
HEAD_KEYS = ("output_linear.weight", "output_linear.bias", "output_linear")


def pad_to_multiple(count: int, multiple: int) -> int:
    """Round a vocab or label count up so the table shards evenly."""
    return -(-count // multiple) * multiple


def spec_for_param(name: str, mesh_shape: dict, shape=None) -> list:
    """The spec of the parameter (or Adam moment) ``name`` (a ``state_dict``
    key) of ``shape`` on a mesh of ``mesh_shape`` (JAX ``_spec_for_param``)."""
    model_axis = AXIS_MODEL if mesh_shape.get(AXIS_MODEL, 1) > 1 else None

    def axis_if_divisible(dim):
        if model_axis is None or shape is None:
            return model_axis
        if dim >= len(shape):
            return None
        return model_axis if shape[dim] % mesh_shape[AXIS_MODEL] == 0 else None

    if name in TABLE_KEYS or name in ("output_linear.weight", "output_linear"):
        return [axis_if_divisible(0), None]
    if name == "output_linear.bias":
        return [axis_if_divisible(0)]
    return []


def param_shardings(mesh: Mesh, model) -> dict[str, list]:
    """Each parameter's spec on ``mesh`` (JAX ``param_shardings``), over the
    global shapes of an unsharded ``model`` or the specs a sharded one runs
    with."""
    return dict(getattr(model, "shard_entries", None) or _entries_of(model, mesh))


def state_shardings(mesh: Mesh, model, optimizer) -> dict[str, list]:
    """The specs of the parameters and their Adam moments (JAX
    ``state_shardings``), keyed as the checkpoint's sidecar keys them."""
    return pytree_spec_doc(mesh, model, optimizer)["specs"]


def batch_shardings(mesh: Mesh) -> dict[str, list]:
    """The batch layout (JAX ``batch_shardings``): rows over ``data``, the
    bag over ``ctx``; labels, ids and the mask over ``data`` only."""
    data = AXIS_DATA if mesh.shape[AXIS_DATA] > 1 else None
    ctx = AXIS_CTX if mesh.shape[AXIS_CTX] > 1 else None
    row, bag = [data], [data, ctx]
    return {"ids": row, "starts": bag, "paths": bag, "ends": bag, "labels": row,
            "example_mask": row}


def retrieval_shardings(mesh: Mesh, n_rows: int | None = None) -> dict[str, list]:
    """The exact retrieval index's layout (JAX ``retrieval_shardings``): the
    unit rows ``[N, E]`` row-sharded over ``model``, as the tables are; the
    queries and each query's result replicated. A row count ``n_rows`` the
    model axis does not divide replicates (JAX's rule;
    ``serve/retrieval.RetrievalIndex`` pads the rows so the shard happens)."""
    model = _model_axis_for(mesh, n_rows)
    return {"rows": [model, None], "query": [], "out": []}


def ann_shardings(mesh: Mesh, n_list: int | None = None) -> dict[str, list]:
    """The IVF-PQ searcher's layout (JAX ``ann_shardings``): the cell-major
    stores (codes ``[n_list, C, M]``, scales, row bias and ids ``[n_list,
    C]``) sharded over ``model`` by cell; centroids, codebooks, the coarse
    ``cell_bias`` and the queries replicated. An ``n_list`` the model axis
    does not divide replicates (``ann/index.AnnSearcher`` pads the cells)."""
    model = _model_axis_for(mesh, n_list)
    return {"codes": [model, None, None], "scales": [model, None], "bias": [model, None],
            "ids": [model, None], "centroids": [], "cell_bias": [], "codebooks": [],
            "query": []}


def _model_axis_for(mesh: Mesh, count: int | None) -> str | None:
    n = mesh.shape[AXIS_MODEL]
    return AXIS_MODEL if n > 1 and (count is None or count % n == 0) else None


def _sharded_dim(entries) -> int | None:
    for dim, entry in enumerate(entries or ()):
        if entry is not None:
            return dim
    return None


def shard_tensor(t: torch.Tensor, entries, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the global ``t`` under ``entries``."""
    dim = _sharded_dim(entries)
    if dim is None:
        return t
    n, me = mesh.shape[AXIS_MODEL], mesh.coords[AXIS_MODEL]
    size = t.shape[dim] // n
    return t.narrow(dim, me * size, size).clone()


def shard_start(local_len: int, entries, mesh: Mesh) -> int | None:
    """The global index at which this rank's slice (``local_len`` long) of
    the dim ``entries`` shard starts, or None when nothing is sharded."""
    if _sharded_dim(entries) is None:
        return None
    return mesh.coords[AXIS_MODEL] * local_len


def unshard_tensor(t: torch.Tensor, entries, mesh: Mesh) -> torch.Tensor:
    """The global tensor of this rank's slice ``t`` (collective over the
    model line)."""
    dim = _sharded_dim(entries)
    group = mesh.group(AXIS_MODEL)
    if dim is None or group is None:
        return t
    return _all_gather(t, group, dim)


def _param_names(model) -> dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def optimizer_param_names(optimizer, model) -> dict[tuple, str]:
    """``{(path..., index): parameter name}`` of an optimizer's
    ``state_dict()["state"]`` entries (a lazy table optimizer's dense part
    under ``"dense"``)."""
    names = _param_names(model)
    out = {}

    def walk(opt, prefix):
        index = 0
        for group in opt.param_groups:
            for p in group["params"]:
                out[(*prefix, index)] = names[id(p)]
                index += 1
        dense = getattr(opt, "dense", None)
        if dense is not None:
            walk(dense, (*prefix, "dense"))

    walk(optimizer, ())
    return out


def _map_optimizer_state(sd: dict, names: dict[tuple, str], fn, prefix=()) -> dict:
    """``sd`` with ``fn(name, tensor)`` applied to every tensor of a
    parameter's shape in its state (new dicts; the optimizer's own state is
    not touched)."""
    out = dict(sd)
    out["state"] = {
        idx: {k: (fn(names[(*prefix, idx)], v) if isinstance(v, torch.Tensor) and v.dim() else v)
              for k, v in st.items()}
        for idx, st in sd["state"].items()
    }
    if "dense" in sd:
        out["dense"] = _map_optimizer_state(sd["dense"], names, fn, (*prefix, "dense"))
    return out


def _entries_of(model, mesh: Mesh) -> dict[str, list]:
    return {n: spec_for_param(n, mesh.shape, tuple(p.shape))
            for n, p in model.named_parameters()}


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's part of a host batch under :func:`batch_shardings`
    (JAX ``shard_batch``): ``distributed.global_batch``."""
    from code2vec_tpu_torch.parallel.distributed import global_batch

    return global_batch(mesh, batch)


def shard_model(model, mesh: Mesh):
    """Slice ``model``'s parameters (global, as built) to this rank's shards
    and attach the mesh; before the optimizer is made. The model's forward
    then gathers rows over ``model`` and runs the column-sharded head."""
    entries = _entries_of(model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            local = shard_tensor(p.data, entries[name], mesh)
            if local is not p.data:
                p.data = local
    model.mesh = mesh
    model.shard_entries = entries
    return model


def unshard_state(mesh: Mesh, model, optimizer) -> tuple[dict, dict | None]:
    """``(model state_dict, optimizer state_dict)`` with every sharded tensor
    gathered to its global shape (collective: every rank calls it)."""
    entries = getattr(model, "shard_entries", None) or _entries_of(model, mesh)
    msd = {k: unshard_tensor(v, entries.get(k), mesh) for k, v in model.state_dict().items()}
    if optimizer is None:
        return msd, None
    names = optimizer_param_names(optimizer, model)
    osd = _map_optimizer_state(optimizer.state_dict(), names,
                               lambda n, v: unshard_tensor(v, entries.get(n), mesh))
    return msd, osd


def shard_state(mesh: Mesh, model, model_sd: dict, optimizer=None,
                optim_sd: dict | None = None) -> tuple[dict, dict | None]:
    """Global state dicts -> this rank's slices in the layout ``model``
    runs with on ``mesh`` (its ``shard_entries``: the rules, with JAX's
    divisibility fallback, over the global shapes). A checkpoint saved on
    another mesh shape restores by this re-slice: its global tensors do not
    depend on the mesh they came from."""
    shapes = {k: tuple(v.shape) for k, v in model_sd.items()}
    entries = getattr(model, "shard_entries", None) or {
        k: spec_for_param(k, mesh.shape, s) for k, s in shapes.items()}
    msd = {k: shard_tensor(v, entries.get(k), mesh) for k, v in model_sd.items()}
    osd = None
    if optim_sd is not None:
        names = optimizer_param_names(optimizer, model)
        osd = _map_optimizer_state(optim_sd, names,
                                   lambda n, v: shard_tensor(v, entries.get(n), mesh))
    return msd, osd


def pytree_spec_doc(mesh: Mesh, model, optimizer=None) -> dict:
    """The checkpoint's sharding doc (JAX ``pytree_spec_doc``):
    ``{"mesh_shape": {axis: size}, "specs": {"model/<key>": entries,
    "optimizer/<path>/<key>": entries}}`` over the global shapes."""
    entries = getattr(model, "shard_entries", None) or _entries_of(model, mesh)
    specs = {f"model/{k}": entries.get(k, []) for k in model.state_dict()}
    if optimizer is not None:
        names = optimizer_param_names(optimizer, model)

        def walk(sd, prefix):
            for idx, st in sd["state"].items():
                for k, v in st.items():
                    if isinstance(v, torch.Tensor) and v.dim():
                        path = "/".join(str(x) for x in (*prefix, idx, k))
                        specs[f"optimizer/{path}"] = entries.get(names[(*prefix, idx)], [])
            if "dense" in sd:
                walk(sd["dense"], (*prefix, "dense"))

        walk(optimizer.state_dict(), ())
    return {"mesh_shape": dict(mesh.shape), "specs": specs}


def rebind(mesh: Mesh, doc: dict, shapes: dict[str, tuple]) -> dict[str, list]:
    """The saved specs of ``shapes``' keys re-expressed on ``mesh`` (JAX
    ``rebind_abstract_shardings``): a dim the resized axis no longer
    divides replicates. A key without a recorded spec replicates."""
    specs = doc.get("specs", {})
    out = {}
    for key, shape in shapes.items():
        entries = specs.get(key)
        if entries is None:
            out[key] = []
            continue
        fitted = []
        for dim, entry in enumerate(entries):
            axes = entry if isinstance(entry, list) else ([] if entry is None else [entry])
            span = 1
            for axis in axes:
                span *= mesh.shape[axis]
            fitted.append(None if axes and (dim >= len(shape) or shape[dim] % span) else entry)
        out[key] = fitted
    return out


def validate_runtime_spec(entries, declared: Iterable[str], context: str = "spec") -> list[str]:
    """SC001/SC002 over one saved spec at restore time (the port's copy of
    JAX ``analysis/sharding_check.validate_runtime_spec``): ``entries`` in
    the sidecar form, ``declared`` the restoring mesh's axis names; returns
    the problems (empty = valid)."""
    declared = set(declared)
    problems: list[str] = []
    flat: list[str] = []
    for entry in entries:
        if entry is None:
            continue
        flat.extend(entry if isinstance(entry, (list, tuple)) else [entry])
    for axis in dict.fromkeys(flat):
        if axis not in declared:
            problems.append(
                f"{context}: axis {axis!r} is not declared by the restore "
                f"mesh (axes: {sorted(declared)}) [SC001]"
            )
        if flat.count(axis) > 1:
            problems.append(
                f"{context}: axis {axis!r} appears {flat.count(axis)} times "
                "in one PartitionSpec — a mesh axis shards at most one "
                "dimension [SC002]"
            )
    return problems
