"""Kernel-schedule autotuning with a persisted cache, on the card.

Counterpart of ``code2vec_tpu/ops/autotune.py``. For each ``(device kind,
batch, bag width, embed dims, table dtype)`` key the tuner times every
route the port can run on that device, keeps the fastest, and persists it
to a JSON cache; ``pallas_impl="auto"`` then looks the schedule up once
per ``(batch, width)`` (``models/code2vec.Code2Vec.resolve_kernel``), so a
run with a warm cache does no timing at all. The cache file is the JAX
package's: the same version, the same ``cache_key()`` strings, the same
``C2V_AUTOTUNE_CACHE`` variable and the same tolerant loading, so a file
either package writes loads in the other.

The variant space on the card (``backend="gpu"``): ``xla`` (the port's
plain route, no kernel), ``pool_only`` (K1 after the plain encode),
``gather_split`` (K2) and ``fused`` with ``materialize`` (K3), ``online``
or ``two_pass`` (K4): six a shape. On the CPU (``backend="cpu"``):
``xla`` and ``gather_split``, JAX's CPU space without its ``block_b``
sweep. The LUT space is K5 alone on the card (``pallas``), the plain
version on the CPU (``xla``). ``block_b``, ``dma_depth`` and ``chunk_l``
keep JAX's defaults (8, 2, 128) in every schedule: the card's kernels
size their own grids.

A cached schedule the port cannot run (another backend, a TPU knob off
its default, an ``xla`` LUT entry for a searcher on the card) is a miss,
logged once: the lookup returns the miss default, never an error and
never a different route in silence.

Accounting: the ``autotune_cache_hit`` / ``autotune_cache_miss`` /
``autotune_timing_run`` / ``autotune_schedule_stored`` counters of
``obs.runtime.global_health()``, as in JAX. The CLI::

    python -m code2vec_tpu_torch.ops.autotune --batch 64 --widths 200 \\
        --terminal-embed 100 --path-embed 100 --encode 100 --cache at.json
    python -m code2vec_tpu_torch.ops.autotune ... --expect-cached   # exit 2 on a miss
    python -m code2vec_tpu_torch.ops.autotune --lut --lut-m 20 ...  # the LUT key
    python -m code2vec_tpu_torch.ops.autotune --dry --backend cpu ...  # no timing

runs on the card unless ``--backend cpu`` (or ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_CACHE_ENV = "C2V_AUTOTUNE_CACHE"
_CACHE_VERSION = 1

IMPLS = ("xla", "pool_only", "gather_split", "fused")
SOFTMAX_MODES = ("materialize", "online", "two_pass")
LUT_IMPLS = ("xla", "pallas")
# the TPU knobs' JAX defaults: the only values the card's kernels take
PORT_KNOBS = {"block_b": 8, "dma_depth": 2, "chunk_l": 128}
LUT_KNOBS = {"chunk_c": 128, "dma_depth": 2}


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """One kernel configuration (a point of the search space); the JAX
    fields and defaults, so its dict is JAX's."""

    impl: str = "pool_only"  # "xla" | "pool_only" | "gather_split" | "fused"
    block_b: int = 8
    dma_depth: int = 2
    chunk_l: int = 128
    softmax: str = "materialize"  # the fused impl: "materialize" | "online" | "two_pass"
    backend: str = "auto"  # "auto" | "gpu" | "cpu" here; JAX also writes "tpu" / "interpret"
    source: str = "default"  # "default" | "dry" | "autotune" | "cache" | "config"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelSchedule":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """What a schedule is keyed by (vocab size is not part of it)."""

    device_kind: str
    batch: int
    width: int
    terminal_embed: int
    path_embed: int
    encode: int
    table_dtype: str  # "f32" | "bf16" | "int8"

    def cache_key(self) -> str:
        return (
            f"{self.device_kind}|b={self.batch}|l={self.width}"
            f"|et={self.terminal_embed}|ep={self.path_embed}"
            f"|h={self.encode}|dt={self.table_dtype}"
        )


@dataclasses.dataclass(frozen=True)
class LutSchedule:
    """One configuration of the LUT-scoring kernel (the second axis)."""

    impl: str = "xla"  # "xla" (the plain version) | "pallas" (K5)
    chunk_c: int = 128
    dma_depth: int = 2
    backend: str = "auto"
    source: str = "default"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LutSchedule":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class LutShapeKey:
    """LUT-kernel key; the ``lut|`` prefix keeps it apart from the forward
    keys in the one cache file."""

    device_kind: str
    m: int
    n_list: int
    capacity: int
    shortlist: int

    def cache_key(self) -> str:
        return (
            f"lut|{self.device_kind}|m={self.m}|nl={self.n_list}"
            f"|cap={self.capacity}|sl={self.shortlist}"
        )


def _device(device=None) -> torch.device:
    from code2vec_tpu_torch.ops.backend import resolve_device

    return resolve_device(device)


def device_kind(device=None) -> str:
    """The key's device kind: the card's name (what JAX's GPU device
    reports, e.g. ``NVIDIA H100 80GB HBM3``), or ``"cpu"`` as JAX's CPU
    device reports it. ``None`` is the card."""
    dev = _device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def backend_label(device=None) -> str:
    """The schedule's ``backend`` field for ``device``: JAX's ``"gpu"`` for
    the card, ``"cpu"`` for the CPU."""
    return "gpu" if _device(device).type == "cuda" else "cpu"


def default_cache_path() -> str:
    env = os.environ.get(DEFAULT_CACHE_ENV, "").strip()
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "code2vec_tpu",
                        "autotune_schedules.json")


def _counters():
    from code2vec_tpu_torch.obs.runtime import global_health

    h = global_health()
    return {
        "hit": h.counter("autotune_cache_hit"),
        "miss": h.counter("autotune_cache_miss"),
        "timing": h.counter("autotune_timing_run"),
        "stored": h.counter("autotune_schedule_stored"),
    }


def counters_snapshot() -> dict[str, int]:
    c = _counters()
    return {
        "autotune_cache_hit": c["hit"].value,
        "autotune_cache_miss": c["miss"].value,
        "autotune_timing_run": c["timing"].value,
        "autotune_schedule_stored": c["stored"].value,
    }


class ScheduleCache:
    """JSON-backed schedule store: a corrupt or version-skewed file loads
    as an empty cache, saves are atomic (a temp file, then ``os.replace``)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.entries: dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if (not isinstance(payload, dict) or payload.get("version") != _CACHE_VERSION
                or not isinstance(payload.get("entries"), dict)):
            return
        self.entries = payload["entries"]

    def save(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": _CACHE_VERSION, "entries": self.entries}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, self.path)

    def _get(self, key, cls):
        entry = self.entries.get(key.cache_key())
        if not isinstance(entry, dict) or not isinstance(entry.get("schedule"), dict):
            return None
        try:
            sched = cls.from_dict(entry["schedule"])
        except TypeError:
            return None
        return dataclasses.replace(sched, source="cache")

    def get(self, key: ShapeKey) -> KernelSchedule | None:
        return self._get(key, KernelSchedule)

    def get_lut(self, key: LutShapeKey) -> LutSchedule | None:
        return self._get(key, LutSchedule)

    def put(self, key, schedule, timings_ms: dict | None = None,
            interpret: bool | None = None) -> None:
        self.entries[key.cache_key()] = {
            "schedule": schedule.to_dict(),
            "timings_ms": timings_ms,
            "interpret": interpret,
            "created": time.time(),
        }
        _counters()["stored"].inc()


_cache_singleton: ScheduleCache | None = None


def get_cache(path: str | None = None) -> ScheduleCache:
    """The process-wide cache. A ``path`` pins (and loads) it; ``None``
    returns whatever is pinned, so a run that named ``--autotune_cache``
    keeps that file for every later lookup in the process."""
    global _cache_singleton
    if path is None:
        if _cache_singleton is None:
            _cache_singleton = ScheduleCache(default_cache_path())
        return _cache_singleton
    if _cache_singleton is None or _cache_singleton.path != path:
        _cache_singleton = ScheduleCache(path)
    return _cache_singleton


def pin_cache(path: str | None) -> None:
    """Pin the process-wide cache to an entry point's ``--autotune_cache``
    (nothing when it names none), before its first forward, so every
    ``pallas_impl="auto"`` lookup of the run reads that file."""
    if path:
        get_cache(path)


def reset_cache() -> None:
    """Drop the pinned cache (tests; a new environment variable)."""
    global _cache_singleton
    _cache_singleton = None


# ---- what the port can run -----------------------------------------------

_LOGGED: set[tuple[str, str]] = set()


def unrunnable(schedule, device=None) -> str | None:
    """Why the port cannot run ``schedule`` (a :class:`KernelSchedule` or
    :class:`LutSchedule`) on ``device``, or None when it can."""
    label = backend_label(device)
    if schedule.backend not in ("auto", label):
        return f"backend {schedule.backend!r}, not {label!r}"
    if isinstance(schedule, LutSchedule):
        want = "pallas" if label == "gpu" else "xla"
        if schedule.impl != want:
            return (f"LUT impl {schedule.impl!r}: the port scores cells with "
                    f"{'K5' if label == 'gpu' else 'its plain version'} on the {label}")
        knobs = LUT_KNOBS
    else:
        if schedule.impl not in IMPLS:
            return f"impl {schedule.impl!r}"
        if schedule.softmax not in SOFTMAX_MODES:
            return f"softmax {schedule.softmax!r}"
        knobs = PORT_KNOBS
    off = {k: getattr(schedule, k) for k, v in knobs.items() if getattr(schedule, k) != v}
    if off:
        return f"TPU knobs off their defaults {off} (the card's kernels size their own grids)"
    return None


def _runnable(found, key, device):
    """``found`` when the port can run it on ``device``, else None (the
    first time for a key and reason, with a warning)."""
    if found is None:
        return None
    why = unrunnable(found, device)
    if why is None:
        return found
    tag = (key.cache_key(), why)
    if tag not in _LOGGED:
        _LOGGED.add(tag)
        logger.warning("autotune: the cached schedule of %s cannot run here (%s): a miss",
                       key.cache_key(), why)
    return None


def default_schedule(device=None) -> KernelSchedule:
    """The miss fallback of :func:`consult_schedules` (and of a lookup
    without ``default``): ``gather_split``, as JAX's compiled CPU and GPU
    strategies have it."""
    return KernelSchedule(impl="gather_split", backend=backend_label(device), source="default")


def lookup_schedule(batch: int, width: int, terminal_embed: int, path_embed: int,
                    encode: int, table_dtype: str = "f32", *,
                    default: KernelSchedule | None = None,
                    cache: ScheduleCache | None = None, device=None) -> KernelSchedule:
    """The ``pallas_impl="auto"`` lookup: a hit returns the persisted
    winner, a miss (or an entry the port cannot run) ``default`` without
    timing anything."""
    key = ShapeKey(device_kind=device_kind(device), batch=int(batch), width=int(width),
                   terminal_embed=int(terminal_embed), path_embed=int(path_embed),
                   encode=int(encode), table_dtype=table_dtype)
    cache = cache or get_cache()
    c = _counters()
    found = _runnable(cache.get(key), key, device)
    if found is not None:
        c["hit"].inc()
        return found
    c["miss"].inc()
    return default or default_schedule(device)


def consult_schedules(keys: list[ShapeKey], cache: ScheduleCache | None = None,
                      device=None) -> list[dict]:
    """The serving start's consultation: one ``{"key", "schedule",
    "cached"}`` record a key, no timing; hits and misses on the counters."""
    cache = cache or get_cache()
    c = _counters()
    out = []
    for key in keys:
        found = _runnable(cache.get(key), key, device)
        if found is not None:
            c["hit"].inc()
        else:
            c["miss"].inc()
        schedule = found or default_schedule(device)
        out.append({"key": key.cache_key(), "schedule": schedule.to_dict(),
                    "cached": found is not None})
    return out


# ---- the LUT axis ----------------------------------------------------------


def default_lut_schedule(device=None) -> LutSchedule:
    """K5 on the card, the plain version on the CPU."""
    label = backend_label(device)
    return LutSchedule(impl="pallas" if label == "gpu" else "xla", backend=label,
                       source="default")


def lookup_lut_schedule(m: int, n_list: int, capacity: int, shortlist: int, *,
                        default: LutSchedule | None = None,
                        cache: ScheduleCache | None = None, device=None) -> LutSchedule:
    """The searcher's lookup: the :func:`lookup_schedule` contract."""
    key = LutShapeKey(device_kind=device_kind(device), m=int(m), n_list=int(n_list),
                      capacity=int(capacity), shortlist=int(shortlist))
    cache = cache or get_cache()
    c = _counters()
    found = _runnable(cache.get_lut(key), key, device)
    if found is not None:
        c["hit"].inc()
        return found
    c["miss"].inc()
    return default or default_lut_schedule(device)


def enumerate_lut_variants(capacity: int, device=None) -> list[LutSchedule]:
    """The LUT search space: K5 on the card, the plain version on the CPU."""
    label = backend_label(device)
    return [LutSchedule(impl="pallas" if label == "gpu" else "xla", backend=label)]


def _synth_lut_inputs(key: LutShapeKey, n_probe: int, q: int, seed: int = 0, device=None):
    """JAX ``_synth_lut_inputs``'s draws, as tensors on ``device``."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(q, key.m, 256)).astype(np.float32)
    probed = rng.integers(0, key.n_list, (q, n_probe)).astype(np.int32)
    codes = rng.integers(0, 256, (key.n_list, key.capacity, key.m)).astype(np.uint8)
    scales = rng.random((key.n_list, key.capacity)).astype(np.float32)
    bias = np.zeros((key.n_list, key.capacity), np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (lut, probed, codes, scales, bias))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn, device: torch.device, iters: int, repeats: int) -> float:
    """JAX's timing contract: one untimed warm call, then the best of
    ``repeats`` wall times of ``iters`` calls (seconds per call), fenced
    with ``torch.cuda.synchronize`` on the card."""
    fn()
    _sync(device)
    best = float("inf")
    n = max(iters, 1)
    for _ in range(max(repeats, 1)):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def time_lut_variant(schedule: LutSchedule, inputs, iters: int = 3, repeats: int = 2) -> float:
    """Best-of wall time (seconds a call) of one LUT variant."""
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells

    device = inputs[0].device
    why = unrunnable(schedule, device)
    if why is not None:
        raise ValueError(f"LUT variant {_lut_variant_label(schedule)} cannot run here: {why}")

    def fn():
        return lut_score_cells(*inputs)

    with torch.inference_mode():
        return _best_of(fn, device, iters, repeats)


def _lut_variant_label(s: LutSchedule) -> str:
    label = "xla" if s.impl == "xla" else f"pallas/c{s.chunk_c}/d{s.dma_depth}"
    if s.backend != "auto":
        label += f"@{s.backend}"
    return label


def _skip(what: str, label: str, key, exc: Exception) -> None:
    """JAX's search semantics for a variant that raises: NaN in the
    timings and one stderr line naming the exception."""
    print(f"autotune: {what} {label} failed on {key.cache_key()}: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)


def autotune_lut(keys: list[LutShapeKey], *, cache: ScheduleCache | None = None,
                 dry: bool = False, iters: int = 3, repeats: int = 2, n_probe: int = 8,
                 q_batch: int = 8, force: bool = False,
                 device=None) -> dict[str, LutSchedule]:
    """Search (or dry-stamp) a LUT schedule per missing key and persist."""
    dev = _device(device)
    cache = cache or get_cache()
    c = _counters()
    out: dict[str, LutSchedule] = {}
    dirty = False
    for key in keys:
        cached = None if force else _runnable(cache.get_lut(key), key, dev)
        if cached is not None:
            c["hit"].inc()
            out[key.cache_key()] = cached
            continue
        c["miss"].inc()
        if dry:
            sched = dataclasses.replace(default_lut_schedule(dev), source="dry")
            cache.put(key, sched, timings_ms=None, interpret=False)
            out[key.cache_key()] = sched
            dirty = True
            continue
        inputs = _synth_lut_inputs(key, min(n_probe, key.n_list), q_batch, device=dev)
        timings: dict[str, float] = {}
        best_sched, best_t = None, float("inf")
        for variant in enumerate_lut_variants(key.capacity, dev):
            c["timing"].inc()
            label = _lut_variant_label(variant)
            try:
                t = time_lut_variant(variant, inputs, iters=iters, repeats=repeats)
            except Exception as exc:  # noqa: BLE001 - JAX's contract: skipped, NaN, named
                timings[label] = float("nan")
                _skip("lut variant", label, key, exc)
                continue
            timings[label] = round(t * 1e3, 4)
            if t < best_t:
                best_sched, best_t = variant, t
        if best_sched is None:
            raise RuntimeError(f"every LUT variant failed for {key.cache_key()}")
        sched = dataclasses.replace(best_sched, source="autotune")
        cache.put(key, sched, timings_ms=timings, interpret=False)
        out[key.cache_key()] = sched
        dirty = True
    if dirty:
        cache.save()
    return out


# ---- the forward axis ------------------------------------------------------


def enumerate_variants(batch: int, width: int, table_dtype: str,
                       device=None) -> list[KernelSchedule]:
    """The search space of one shape: on the card the plain route and
    every kernel route (K1; K2; K3 and both K4 modes), on the CPU the
    plain route and ``gather_split`` (JAX's CPU space, one ``block_b``)."""
    label = backend_label(device)
    if label == "cpu":
        return [KernelSchedule(impl="xla", backend="cpu"),
                KernelSchedule(impl="gather_split", backend="cpu")]
    variants = [KernelSchedule(impl=impl, backend="gpu")
                for impl in ("xla", "pool_only", "gather_split")]
    variants += [KernelSchedule(impl="fused", softmax=mode, backend="gpu")
                 for mode in SOFTMAX_MODES]
    return variants


class SynthInputs:
    """One key's timing inputs: a ``Code2Vec`` at the key's widths (one
    label) whose weights are JAX ``_synth_inputs``' draws, its quantized
    tables, and the ids (PAD where JAX's random mask is 0, so the model's
    mask is that mask) on ``device``."""

    def __init__(self, model, ids, quant_tables) -> None:
        self.model = model
        self.ids = ids
        self.quant_tables = quant_tables

    @property
    def device(self) -> torch.device:
        return self.ids[0].device

    def forward(self, schedule: KernelSchedule):
        """``(logits, code_vector, attention)`` on ``schedule``'s route."""
        from code2vec_tpu_torch.models.code2vec import route_config

        model = self.model
        base = model.config
        model.config = route_config(base, schedule)
        try:
            with torch.inference_mode():
                return model(*self.ids, quant_tables=self.quant_tables)
        finally:
            model.config = base


def _synth_tables(vocab: int, key: ShapeKey, seed: int, memo: dict | None):
    """The tables JAX ``_synth_inputs`` draws first, and the generator's
    state after them (one draw of a top11-sized pair takes seconds, so a
    tuning run draws it once for all its keys)."""
    tag = (vocab, key.terminal_embed, key.path_embed, seed)
    if memo is not None and tag in memo:
        tt, pt, state = memo[tag]
        rng = np.random.default_rng()
        rng.bit_generator.state = state
        return tt, pt, rng
    rng = np.random.default_rng(seed)
    tt = rng.normal(size=(vocab, key.terminal_embed)).astype(np.float32)
    pt = rng.normal(size=(vocab, key.path_embed)).astype(np.float32)
    if memo is not None:
        memo[tag] = (tt, pt, rng.bit_generator.state)
    return tt, pt, rng


def _synth_inputs(key: ShapeKey, vocab: int, seed: int = 0, device=None,
                  memo: dict | None = None) -> SynthInputs:
    """JAX ``_synth_inputs``'s draws in its order (tables, ids, mask, W,
    attention vector; LayerNorm ones and zeros), put into a model."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    dev = _device(device)
    tt, pt, rng = _synth_tables(vocab, key, seed, memo)
    b, l, h = key.batch, key.width, key.encode
    starts = rng.integers(1, vocab, (b, l)).astype(np.int32)
    paths = rng.integers(1, vocab, (b, l)).astype(np.int32)
    ends = rng.integers(1, vocab, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) > 0.4
    dense = (rng.normal(size=(2 * key.terminal_embed + key.path_embed, h)).astype(np.float32)
             * 0.05)
    attn = rng.normal(size=h).astype(np.float32)
    for ids in (starts, paths, ends):
        ids[~mask] = 0
    cfg = Code2VecConfig(terminal_count=vocab, path_count=vocab, label_count=1,
                         terminal_embed_size=key.terminal_embed,
                         path_embed_size=key.path_embed, encode_size=h, dropout_prob=0.0,
                         table_dtype=key.table_dtype)
    with torch.device("meta"):
        model = Code2Vec(cfg)
    state = {
        "terminal_embedding.weight": torch.from_numpy(tt),
        "path_embedding.weight": torch.from_numpy(pt),
        "input_linear.weight": torch.from_numpy(np.ascontiguousarray(dense.T)),
        "input_layer_norm.weight": torch.ones(h),
        "input_layer_norm.bias": torch.zeros(h),
        "attention_parameter": torch.from_numpy(attn),
        "output_linear.weight": torch.zeros(1, h),
        "output_linear.bias": torch.zeros(1),
    }
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True, assign=True)
    model.eval().requires_grad_(False)
    ids = tuple(torch.from_numpy(x).to(dev) for x in (starts, paths, ends))
    return SynthInputs(model, ids, model.quantize_tables())


def time_variant(schedule: KernelSchedule, inputs: SynthInputs, iters: int = 3,
                 repeats: int = 2) -> float:
    """Best-of wall time (seconds a forward) of one variant: the model's
    own forward on the variant's route (what ``pallas_impl="auto"`` then
    runs), one untimed warm call first."""
    why = unrunnable(schedule, inputs.device)
    if why is not None:
        raise ValueError(f"variant {_variant_label(schedule)} cannot run here: {why}")
    return _best_of(lambda: inputs.forward(schedule), inputs.device, iters, repeats)


def autotune(keys: list[ShapeKey], *, cache: ScheduleCache | None = None, dry: bool = False,
             iters: int = 3, repeats: int = 2, vocab: int | None = None, force: bool = False,
             device=None, inputs_memo: dict | None = None) -> dict[str, KernelSchedule]:
    """Search (or dry-stamp) a schedule for every key not already cached,
    persist the cache once, and return the key -> schedule mapping.
    Timed entries keep every variant's ms; a variant that raises is
    skipped (NaN, one stderr line), as in JAX."""
    dev = _device(device)
    cache = cache or get_cache()
    c = _counters()
    vocab = vocab or int(os.environ.get("C2V_AUTOTUNE_VOCAB", 20_000))
    memo = {} if inputs_memo is None else inputs_memo
    out: dict[str, KernelSchedule] = {}
    dirty = False
    for key in keys:
        cached = None if force else _runnable(cache.get(key), key, dev)
        if cached is not None:
            c["hit"].inc()
            out[key.cache_key()] = cached
            continue
        c["miss"].inc()
        if dry:
            sched = dataclasses.replace(default_schedule(dev), source="dry")
            cache.put(key, sched, timings_ms=None, interpret=False)
            out[key.cache_key()] = sched
            dirty = True
            continue
        inputs = _synth_inputs(key, vocab, device=dev, memo=memo)
        timings: dict[str, float] = {}
        best_sched, best_t = None, float("inf")
        for variant in enumerate_variants(key.batch, key.width, key.table_dtype, dev):
            c["timing"].inc()
            label = _variant_label(variant)
            try:
                t = time_variant(variant, inputs, iters=iters, repeats=repeats)
            except Exception as exc:  # noqa: BLE001 - JAX's contract: skipped, NaN, named
                timings[label] = float("nan")
                _skip("variant", label, key, exc)
                continue
            timings[label] = round(t * 1e3, 4)
            if t < best_t:
                best_sched, best_t = variant, t
        del inputs
        if best_sched is None:
            raise RuntimeError(f"every kernel variant failed for {key.cache_key()}")
        sched = dataclasses.replace(best_sched, source="autotune")
        cache.put(key, sched, timings_ms=timings, interpret=False)
        out[key.cache_key()] = sched
        dirty = True
    if dirty:
        cache.save()
    return out


def _variant_label(s: KernelSchedule) -> str:
    if s.impl in ("xla", "pool_only", "gather_split"):
        label = s.impl if s.impl == "xla" else f"{s.impl}/b{s.block_b}"
    else:
        label = f"fused/b{s.block_b}/d{s.dma_depth}/c{s.chunk_l}"
        if s.softmax != "materialize":
            label += f"/{s.softmax}"
    if s.backend != "auto":
        label += f"@{s.backend}"
    return label


def keys_for(batch: int, widths: list[int], terminal_embed: int, path_embed: int, encode: int,
             table_dtypes: list[str], kind: str | None = None, device=None) -> list[ShapeKey]:
    kind = kind or device_kind(device)
    return [
        ShapeKey(device_kind=kind, batch=batch, width=w, terminal_embed=terminal_embed,
                 path_embed=path_embed, encode=encode, table_dtype=dt)
        for w in widths
        for dt in table_dtypes
    ]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.ops.autotune",
        description="kernel-schedule autotuner (see the module docstring)")
    parser.add_argument("--autotune", action="store_true",
                        help="accepted for JAX's command lines; this module is the autotuner")
    parser.add_argument("--dry", action="store_true",
                        help="write default schedules without timing (serialization smoke)")
    parser.add_argument("--cache", type=str, default=None,
                        help=f"cache path (default ${DEFAULT_CACHE_ENV} or "
                             "~/.cache/code2vec_tpu/autotune_schedules.json)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--widths", type=str, default="16,32",
                        help="comma list of bag widths (the bucket ladder)")
    parser.add_argument("--terminal-embed", type=int, default=8)
    parser.add_argument("--path-embed", type=int, default=8)
    parser.add_argument("--encode", type=int, default=16)
    parser.add_argument("--table-dtypes", type=str, default="f32",
                        help="comma list from {f32,bf16,int8}")
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--vocab", type=int, default=None,
                        help="rows of the synthetic tables (default $C2V_AUTOTUNE_VOCAB or "
                             "20000)")
    parser.add_argument("--force", action="store_true", help="re-tune even cached shapes")
    parser.add_argument("--backend", type=str, default=None, choices=("auto", "gpu", "cpu"),
                        help="JAX's flag: gpu (or auto, the default) tunes on the card, cpu "
                             "on the CPU")
    parser.add_argument("--expect-cached", action="store_true",
                        help="exit 2 if any shape missed the cache (a second identical run "
                             "must do no search)")
    parser.add_argument("--lut", action="store_true",
                        help="tune the LUT-scoring kernel (K5) instead of the forward; keys "
                             "from the --lut-* knobs")
    parser.add_argument("--lut-m", type=int, default=8)
    parser.add_argument("--lut-n-list", type=int, default=64)
    parser.add_argument("--lut-capacity", type=int, default=256)
    parser.add_argument("--lut-shortlist", type=int, default=128)
    args = parser.parse_args(argv)

    device = _device("cpu" if args.backend == "cpu" else None)

    cache = ScheduleCache(args.cache or default_cache_path())
    before = counters_snapshot()
    if args.lut:
        lut_keys = [LutShapeKey(device_kind=device_kind(device), m=args.lut_m,
                                n_list=args.lut_n_list, capacity=args.lut_capacity,
                                shortlist=args.lut_shortlist)]
        schedules = autotune_lut(lut_keys, cache=cache, dry=args.dry, iters=args.iters,
                                 force=args.force, device=device)
    else:
        keys = keys_for(args.batch, [int(w) for w in args.widths.split(",") if w.strip()],
                        args.terminal_embed, args.path_embed, args.encode,
                        [d.strip() for d in args.table_dtypes.split(",") if d.strip()],
                        device=device)
        schedules = autotune(keys, cache=cache, dry=args.dry, iters=args.iters,
                             vocab=args.vocab, force=args.force, device=device)
    after = counters_snapshot()
    delta = {k: after[k] - before[k] for k in after}
    print(json.dumps({
        "device_kind": device_kind(device),
        "backend": backend_label(device),
        "cache": cache.path,
        "dry": args.dry,
        "schedules": {k: s.to_dict() for k, s in schedules.items()},
        "counters": delta,
    }), flush=True)
    if args.expect_cached and delta["autotune_cache_miss"] > 0:
        print(f"autotune: --expect-cached but {delta['autotune_cache_miss']} shape(s) missed "
              "the cache", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
