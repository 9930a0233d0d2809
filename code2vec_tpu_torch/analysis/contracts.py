"""Call-time shape/dtype contracts for the step and kernel entry points.

Counterpart of ``code2vec_tpu/analysis/contracts.py``. JAX checks a
jitted function's inputs once a trace; PyTorch has no trace, so
``@shape_contract`` checks every call. A check reads only a tensor's
``.shape`` and ``.dtype``, never its value, so it never synchronizes the
card: it costs host time alone (a few microseconds a call). A violation
raises :class:`ContractError` before the function body runs, so a
malformed batch fails at the entry that received it, before any kernel
launches, instead of training on a broadcast or a silent cast.

The weakness check is the call-time twin of torchlint's TX001. Torch has
no weak types; the counterpart of JAX's weak value is a Python or numpy
scalar where a tensor is expected (``torch.tensor(1)`` makes int64, a bare
``1.0`` the default float type), rejected unless the spec passes
``allow_weak=True``.

Specs
-----
Each argument spec is one of:

- ``"B,L"`` — a shape pattern: comma-separated dims, each an int literal
  (exact), a symbol (``B``/``L``/... — all uses of one symbol must bind
  the same size within a single call), or ``?`` (any). ``""`` means a
  rank-0 tensor. Symbols bind per call: bucketed runs call at each ladder
  width and each call binds its own ``L``.
- a dtype (``torch.int32``) — dtype-only check.
- ``("B,L", torch.int32)`` — shape + dtype.
- :func:`spec` for the full form: ``spec("B,L", "int", allow_weak=True)``.
  ``dtype`` accepts a ``torch.dtype``, a tuple of them, or a category
  (``"int"`` / ``"float"`` / ``"bool"``).
- a dict — for dict-valued args (a batch) the entries are checked by
  key; for other objects (a model) by attribute, nested dicts descending
  (``{"terminal_embedding": {"weight": ...}}``). Missing keys are
  violations; extra keys are ignored.
- ``None`` — skip this argument.

The messages follow the JAX package's wording (rank, "bound by an earlier
argument", dtype or category), so one pattern matches both packages.
``torch`` is imported on the first check, not with this module.

Example::

    @shape_contract(model={"terminal_embedding": {"weight": spec(None, torch.float32)}},
                    batch={"starts": ("B,L", "int")})
    def train_step(model, optimizer, batch, class_weights): ...
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Mapping

__all__ = ["ContractError", "ArgSpec", "spec", "shape_contract"]


class ContractError(TypeError):
    """A step or kernel input violated its shape/dtype/weakness contract."""


_CATEGORY_NAMES = ("int", "float", "bool")
_WILDCARDS = {"?", "_"}
_torch = None  # bound on the first check
_CATEGORIES: dict[str, frozenset] = {}


def _load_torch():
    global _torch
    if _torch is None:
        import torch

        ints = frozenset(
            getattr(torch, n)
            for n in ("uint8", "int8", "int16", "int32", "int64", "uint16", "uint32", "uint64")
            if hasattr(torch, n)
        )
        floats = frozenset(
            getattr(torch, n)
            for n in ("float16", "bfloat16", "float32", "float64", "float8_e4m3fn",
                      "float8_e5m2")
            if hasattr(torch, n)
        )
        _CATEGORIES.update(int=ints, float=floats, bool=frozenset({torch.bool}))
        _torch = torch
    return _torch


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    dims: tuple | None  # ints / symbol strs / wildcards; None = any shape
    dtypes: tuple | str | None  # torch.dtype tuple, category str, or None
    allow_weak: bool = False


def spec(shape: str | None = None, dtype=None, *, allow_weak: bool = False) -> ArgSpec:
    """Build one argument spec; see the module docstring for the forms."""
    dims = None
    if shape is not None:
        shape = shape.strip()
        if shape == "":
            dims = ()
        else:
            dims = tuple(
                int(tok) if tok.lstrip("-").isdigit() else tok
                for tok in (t.strip() for t in shape.split(","))
            )
    dtypes: tuple | str | None = None
    if dtype is not None:
        if isinstance(dtype, str):
            if dtype not in _CATEGORY_NAMES:
                raise ValueError(
                    f"dtype category must be one of {sorted(_CATEGORY_NAMES)}, got {dtype!r}"
                )
            dtypes = dtype
        elif isinstance(dtype, (tuple, list)):
            dtypes = tuple(_as_dtype(d) for d in dtype)
        else:
            dtypes = (_as_dtype(dtype),)
    return ArgSpec(dims=dims, dtypes=dtypes, allow_weak=allow_weak)


def _as_dtype(d):
    torch = _load_torch()
    if not isinstance(d, torch.dtype):
        raise TypeError(f"cannot interpret {d!r} as a torch dtype")
    return d


def _coerce(s: Any):
    """Shorthand -> ArgSpec (or dict of them, or None)."""
    if s is None or isinstance(s, ArgSpec):
        return s
    if isinstance(s, Mapping):
        return {k: _coerce(v) for k, v in s.items()}
    if isinstance(s, str):
        return spec(shape=s)
    if isinstance(s, (tuple, list)):
        return spec(*s)
    try:
        return spec(dtype=s)
    except TypeError:
        raise TypeError(f"cannot interpret {s!r} as a contract spec") from None


def _aval(fn_name: str, where: str, value) -> tuple[tuple, Any, bool]:
    """(shape, dtype, weak) of a value that is not a tensor: a Python or
    numpy scalar is weak, with the dtype ``torch.tensor`` would give it;
    anything else is not an input a contract accepts."""
    torch = _torch
    if isinstance(value, bool):
        return (), torch.bool, True
    if isinstance(value, int):
        return (), torch.int64, True
    if isinstance(value, float):
        return (), torch.get_default_dtype(), True
    if isinstance(value, complex):
        return (), torch.complex64, True
    np_dtype = getattr(value, "dtype", None)
    if np_dtype is not None and getattr(value, "shape", None) == () \
            and type(value).__module__ == "numpy":
        return (), getattr(torch, np_dtype.name, None), True
    raise ContractError(
        f"{fn_name}: {where} is a {type(value).__module__}.{type(value).__name__}, "
        "contract expects a torch.Tensor"
    )


def _check_value(fn_name: str, where: str, value, s: ArgSpec, env: dict) -> None:
    if isinstance(value, _torch.Tensor):
        shape, dtype, weak = value.shape, value.dtype, False
    else:
        shape, dtype, weak = _aval(fn_name, where, value)
    if s.dims is not None:
        if len(shape) != len(s.dims):
            raise ContractError(
                f"{fn_name}: {where} has rank {len(shape)} (shape {tuple(shape)}), "
                f"contract expects rank {len(s.dims)} ({_dims_str(s.dims)})"
            )
        for i, d in enumerate(s.dims):
            if isinstance(d, int):
                if shape[i] != d:
                    raise ContractError(
                        f"{fn_name}: {where} dim {i} is {shape[i]}, contract pins it to {d}"
                    )
            elif d in _WILDCARDS:
                continue
            else:
                bound = env.setdefault(d, shape[i])
                if bound != shape[i]:
                    raise ContractError(
                        f"{fn_name}: {where} dim {i} ({d}) is {shape[i]} but "
                        f"{d}={bound} was bound by an earlier argument — "
                        "inconsistent shapes within one call"
                    )
    if s.dtypes is not None:
        if isinstance(s.dtypes, str):
            ok = dtype in _CATEGORIES[s.dtypes]
            expect = f"category {s.dtypes!r}"
        else:
            ok = dtype in s.dtypes
            expect = "/".join(_dtype_name(d) for d in s.dtypes)
        if not ok:
            raise ContractError(
                f"{fn_name}: {where} has dtype {_dtype_name(dtype)}, contract expects {expect}"
            )
    if weak and not s.allow_weak:
        raise ContractError(
            f"{fn_name}: {where} is WEAK-typed (a bare Python or numpy scalar where a "
            "tensor is expected). torch.tensor() of it makes int64 or the default float "
            "type, not the pipeline's int32/float32, so the step sees a new input "
            "signature — pass a tensor with an explicit dtype "
            "(e.g. torch.tensor(x, dtype=torch.int32)). [torchlint TX001]"
        )


def _dims_str(dims: tuple) -> str:
    return ",".join(str(d) for d in dims) if dims else "scalar"


def _plan(s, where: str):
    """A spec compiled for the per-call check: ``None``; a dict plan
    ``(where, ((key, sub plan), ...))``; or a leaf plan ``(where, spec,
    rank, pins, binds)`` (rank -1: any; pins ``(dim, size)``; binds ``(dim,
    symbol)``). The ``where`` strings are built once, here."""
    if s is None:
        return None
    if isinstance(s, dict):
        return (where, tuple((k, _plan(v, f"{where}[{k!r}]")) for k, v in s.items()
                             if v is not None))
    dims = s.dims or ()
    pins = tuple((i, d) for i, d in enumerate(dims) if isinstance(d, int))
    binds = tuple((i, d) for i, d in enumerate(dims)
                  if not isinstance(d, int) and d not in _WILDCARDS)
    return (where, s, -1 if s.dims is None else len(dims), pins, binds)


def _fits(leaf, value, env: dict) -> bool:
    """Whether a tensor meets a leaf plan (binding its symbols in ``env``):
    the common case, with no message built."""
    _, s, rank, pins, binds = leaf
    shape = value.shape
    if rank >= 0 and len(shape) != rank:
        return False
    for i, d in pins:
        if shape[i] != d:
            return False
    for i, sym in binds:
        got = shape[i]
        if env.setdefault(sym, got) != got:
            return False
    dtypes = s.dtypes
    return dtypes is None or value.dtype in (
        _CATEGORIES[dtypes] if isinstance(dtypes, str) else dtypes)


def _run(fn_name: str, plan, value, env: dict) -> None:
    if len(plan) == 2:  # a dict plan: by key, or by attribute
        where, items = plan
        is_map = isinstance(value, Mapping)
        for key, sub in items:
            if is_map:
                if key not in value:
                    raise ContractError(f"{fn_name}: {where} is missing required key {key!r}")
                item = value[key]
            else:
                try:
                    item = getattr(value, key)
                except AttributeError:
                    raise ContractError(
                        f"{fn_name}: {where} has no attribute {key!r} required by its contract"
                    ) from None
            _run(fn_name, sub, item, env)
        return
    if isinstance(value, _torch.Tensor) and _fits(plan, value, env):
        return
    # the slow path: the full check, which raises with the message (or
    # passes a weak scalar its spec allows)
    _check_value(fn_name, plan[0], value, plan[1], env)


def shape_contract(*pos_specs, **named_specs):
    """Decorator: validate the wrapped function's inputs on every call.

    Positional specs align with positional parameters; keyword specs
    bind by parameter name (and also cover keyword calls). The wrapper
    keeps the function's name, docstring, signature and ``__wrapped__``
    (``functools.wraps``), counts its checks in ``.contract_checks`` and
    exposes the check alone as ``.check(*args, **kwargs)`` (what the
    wrapper runs before the body: no call of the function)."""
    pos = [_coerce(s) for s in pos_specs]
    named = {k: _coerce(v) for k, v in named_specs.items()}

    def decorate(fn):
        fn_name = getattr(fn, "__name__", "<fn>")
        try:
            params = [
                p.name
                for p in inspect.signature(fn).parameters.values()
                if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD)
            ]
        except (TypeError, ValueError):  # builtins / C callables
            params = []
        by_index: dict[int, Any] = {i: s for i, s in enumerate(pos) if s is not None}
        names_of: dict[int, str] = dict(enumerate(params))
        for name, s in named.items():
            if name in params:
                idx = params.index(name)
                if idx in by_index:
                    raise TypeError(
                        f"shape_contract: parameter {name!r} of {fn_name} "
                        "has both a positional and a named spec"
                    )
                by_index[idx] = s
        by_position = tuple((i, _plan(s, names_of.get(i, f"arg{i}")))
                            for i, s in sorted(by_index.items()))
        by_keyword = {k: _plan(v, k) for k, v in named.items() if v is not None}

        def check(*args, **kwargs):
            if _torch is None:
                _load_torch()
            wrapper.contract_checks += 1
            env: dict = {}
            n = len(args)
            for i, plan in by_position:
                if i < n:
                    _run(fn_name, plan, args[i], env)
            for key, value in kwargs.items():
                plan = by_keyword.get(key)
                if plan is not None:
                    _run(fn_name, plan, value, env)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            check(*args, **kwargs)
            return fn(*args, **kwargs)

        wrapper.contract_checks = 0
        wrapper.check = check
        wrapper.__contract__ = (tuple(pos), dict(named))
        return wrapper

    return decorate
