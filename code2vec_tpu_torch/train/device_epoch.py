"""Device-resident epochs: the corpus staged on the card once, each epoch's
batches sampled there, chunks of steps enqueued back to back.

Counterpart of ``code2vec_tpu/train/device_epoch.py`` for one device and
both tasks: ``StagedCorpus`` and the staging of method and variable rows
(``:57-282``), the sampler ``_sample_batch`` with its variable remap
(``:565-616``), the double
buffer of ``_scan_train_chunk`` / ``_scan_eval_chunk`` (``:619-680``),
``EpochRunner`` (``:683-908``) and the bucketed staging and runner
(``:912-1001``, ``:1051-1139``).

The host pipeline (``data/pipeline.py``) rebuilds ``[N, L]`` epoch arrays
in numpy every epoch and copies one ``[B, L]`` batch per step. Here:

- ``stage_method_corpus`` builds the split's CSR contexts once on the host
  (interleaved ``[total, 3]``, each method's contexts shuffled once, the
  ``@method_0 -> @question`` substitution applied) and copies each array to
  the card once;
- each step draws a random rotation window of ``bag`` contexts per method
  (``ctx[(shift + j) % n]``) on the card. A method with ``n <= bag``
  contexts (the common case) takes all of them, as the host pipeline does,
  and attention pooling does not depend on their order. A longer method
  keeps each context with probability ``bag / n`` without duplicates, but
  neighbours in the staged order are drawn together; the host pipeline
  stays the exact-parity path;
- a chunk of ``chunk_batches`` steps costs the host one pinned copy of its
  ``[nb * B]`` row order; the losses stay on the card and are read once
  per epoch.

Each step is the port's own ``train_step`` / ``eval_step``, so every
kernel route, compute dtype and table update works unchanged: the sampled
batch has the keys and dtypes of ``train/step.to_device``. The numpy
generator draws the staging shuffles and each epoch's method order in the
JAX module's order; the shifts (and, for the variable task's
``shuffle_variable_ids``, each batch's ``[B, V]`` uniform draw) come from an
explicit ``torch.Generator`` on the corpus's device (its stream differs
from JAX's keys, as dropout's does). The remap permutes the ``@var_*`` ids
once per variable row of a batch, where the host path permutes them once
per method; the marginal distribution is the same (JAX ``:577-579``).

Sharded staging (``shard_staged_corpus``) partitions a split over the
mesh's data axis: :func:`shard_staged` from a whole-corpus host staging,
:func:`shard_staged_multiprocess` from each feed group's own corpus shard.
Not ported: CUDA-graph capture of a chunk (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_INDEX
from code2vec_tpu_torch.data.pipeline import assign_buckets, flat_context_indices
from code2vec_tpu_torch.obs.trace import NULL_TRACER, get_tracer
from code2vec_tpu_torch.train.step import StepTally, eval_step, train_step

# the shifts are uniform in [0, 2^30), as JAX's randint draws them
SHIFT_HIGH = 1 << 30
# the sampler's stream, apart from dropout's and the numpy generator's
SAMPLER_STREAM = 0x5A3D


@dataclass
class StagedCorpus:
    """A split staged as CSR: method ``i`` owns ``contexts[row_splits[i]:
    row_splits[i + 1]]``. On the card the arrays are int32 tensors; a host
    staging (``device="host"``) keeps numpy arrays with int64 splits.
    ``counts`` is the host's copy of each row's context count, which the
    pad and speed accounting read without a device sync. A row is a method
    (method task) or one ``@var_*`` alias of a method (variable task);
    ``remap_ids`` (the sorted ``@var_*`` ids) and ``remap_flags`` (1 on a
    variable row) are set when the corpus holds variable rows."""

    contexts: torch.Tensor | np.ndarray  # int32 [total, 3]: (start, path, end), @question applied
    row_splits: torch.Tensor | np.ndarray  # int32 [n_items + 1] (int64 on the host)
    labels: torch.Tensor | np.ndarray  # int32 [n_items]
    n_items: int
    counts: np.ndarray  # int64 [n_items]
    remap_ids: torch.Tensor | np.ndarray | None = None  # int32 [V]
    remap_flags: torch.Tensor | np.ndarray | None = None  # int32 [n_items]

    @property
    def n_contexts(self) -> int:
        return int(self.contexts.shape[0])

    @property
    def nbytes(self) -> int:
        extra = sum(int(x.nbytes) for x in (self.remap_ids, self.remap_flags) if x is not None)
        return int(self.contexts.nbytes + self.row_splits.nbytes + self.labels.nbytes) + extra


def _check_device_total(total: int) -> None:
    """The sampler indexes with int32 ``row_splits``: per shard under
    ``shard_staged_corpus``."""
    if total >= 2**31:
        raise ValueError(
            f"staged corpus (or shard) has {total} contexts; device row_splits are int32: "
            "shard the staging over more ranks (--shard_staged_corpus with a larger "
            "--data_axis) or stage a subset"
        )


def _per_row_shuffle(total: int, row_splits: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """A permutation of ``[0, total)`` that shuffles within each CSR row
    only: a sort by (row id, f32 uniform), the JAX module's draw exactly."""
    row_ids = np.repeat(np.arange(len(row_splits) - 1, dtype=np.int32), np.diff(row_splits))
    return np.lexsort((rng.random(total, dtype=np.float32), row_ids))


def stage_method_corpus(data, item_idx: np.ndarray, rng: np.random.Generator,
                        device: str | torch.device = "host") -> StagedCorpus:
    """Stage the selected items' contexts: built on the host (each row
    shuffled once, ``@method_0`` replaced by ``@question``, as the host
    pipeline does per epoch), then one copy per array to ``device``
    (``"host"`` keeps the numpy arrays)."""
    counts = np.diff(data.row_splits)[item_idx].astype(np.int64)
    new_splits = np.zeros(len(item_idx) + 1, np.int64)
    np.cumsum(counts, out=new_splits[1:])
    total = int(new_splits[-1])
    if device != "host":
        _check_device_total(total)
    # the shuffle permutes the flat indices before the gather: one [total, 3]
    # pass instead of gather-then-permute
    flat, _, _ = flat_context_indices(data.row_splits, item_idx)
    flat = flat[_per_row_shuffle(total, new_splits, rng)]
    contexts = np.empty((total, 3), np.int32)
    contexts[:, 0] = data.starts[flat]
    contexts[:, 1] = data.paths[flat]
    contexts[:, 2] = data.ends[flat]
    method_idx = data.method_token_index
    if method_idx is not None:
        terms = contexts[:, (0, 2)]
        np.putmask(terms, terms == method_idx, QUESTION_TOKEN_INDEX)
        contexts[:, (0, 2)] = terms
    staged = StagedCorpus(contexts=contexts, row_splits=new_splits,
                          labels=data.labels[item_idx].astype(np.int32),
                          n_items=len(item_idx), counts=counts)
    return staged if device == "host" else place_staged(staged, device)


def stage_variable_corpus(data, item_idx: np.ndarray, rng: np.random.Generator,
                          device: str | torch.device = "host") -> StagedCorpus:
    """Stage the variable task: one row per ``@var_*`` alias of each item,
    the contexts touching that alias with the alias renamed to
    ``@question``, each row shuffled once (one ``rng.permutation`` a row,
    an alias no context touches included: its row is empty). The remap of
    the other variables redraws every epoch, so it is left to the sampler:
    the staging carries ``remap_ids`` and ``remap_flags``."""
    from code2vec_tpu_torch.data.pipeline import variable_items

    label_stoi = data.label_vocab.stoi
    parts: list[np.ndarray] = []
    counts: list[int] = []
    labels: list[int] = []
    for i, alias_names, alias_idx, s, p, e in variable_items(data, item_idx):
        alias_map = data.aliases[i]
        for alias_name, var_idx in zip(alias_names, alias_idx):
            mine = (s == var_idx) | (e == var_idx)
            row = np.stack([np.where(s[mine] == var_idx, QUESTION_TOKEN_INDEX, s[mine]),
                            p[mine],
                            np.where(e[mine] == var_idx, QUESTION_TOKEN_INDEX, e[mine])],
                           axis=1).astype(np.int32)
            parts.append(row[rng.permutation(len(row))])
            counts.append(len(row))
            labels.append(label_stoi[alias_map[alias_name]])
    contexts = np.concatenate(parts) if parts else np.zeros((0, 3), np.int32)
    row_splits = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=row_splits[1:])
    staged = StagedCorpus(contexts=contexts, row_splits=row_splits,
                          labels=np.asarray(labels, np.int32), n_items=len(labels),
                          counts=np.asarray(counts, np.int64),
                          remap_ids=data.variable_indexes.astype(np.int32),
                          remap_flags=np.ones(len(labels), np.int32))
    return staged if device == "host" else place_staged(staged, device)


def concat_staged(a: StagedCorpus, b: StagedCorpus) -> StagedCorpus:
    """Method rows then variable rows in one host staging (``build_epoch``'s
    order); place it afterwards with :func:`place_staged`."""
    a_rs, b_rs = np.asarray(a.row_splits, np.int64), np.asarray(b.row_splits, np.int64)

    def flags(x: StagedCorpus) -> np.ndarray:
        return (np.asarray(x.remap_flags) if x.remap_flags is not None
                else np.zeros(x.n_items, np.int32))

    return StagedCorpus(
        contexts=np.concatenate([np.asarray(a.contexts), np.asarray(b.contexts)]),
        row_splits=np.concatenate([a_rs, b_rs[1:] + int(a_rs[-1])]),
        labels=np.concatenate([np.asarray(a.labels), np.asarray(b.labels)]),
        n_items=a.n_items + b.n_items, counts=np.concatenate([a.counts, b.counts]),
        remap_ids=a.remap_ids if a.remap_ids is not None else b.remap_ids,
        remap_flags=np.concatenate([flags(a), flags(b)]))


def place_staged(staged: StagedCorpus, device: str | torch.device) -> StagedCorpus:
    """A host staging on ``device``: one copy per array, int32 splits."""
    rs = np.asarray(staged.row_splits)
    _check_device_total(int(rs[-1]) if len(rs) else 0)
    dev = torch.device(device)

    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return StagedCorpus(contexts=put(staged.contexts), row_splits=put(rs.astype(np.int32)),
                        labels=put(staged.labels), n_items=staged.n_items, counts=staged.counts,
                        remap_ids=put(staged.remap_ids), remap_flags=put(staged.remap_flags))


@dataclass
class BucketedStagedCorpus:
    """A staged split partitioned by context count over a ladder of bag
    widths: one :class:`StagedCorpus` per non-empty bucket (the top one
    always), each sampled at its own width by :class:`BucketedEpochRunner`.
    Rows keep every context; the width bounds the sampled window."""

    buckets: list[tuple[int, StagedCorpus]]  # (bag width, staged rows)

    @property
    def n_items(self) -> int:
        return sum(s.n_items for _, s in self.buckets)

    @property
    def n_contexts(self) -> int:
        return sum(s.n_contexts for _, s in self.buckets)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for _, s in self.buckets)

    @property
    def contexts(self):
        """The first bucket's contexts (where the staging lives)."""
        return self.buckets[0][1].contexts

    @property
    def counts(self) -> np.ndarray:
        """Context counts in bucket order."""
        return np.concatenate([s.counts for _, s in self.buckets]) if self.buckets \
            else np.zeros(0, np.int64)

    def host_labels(self) -> np.ndarray:
        """Labels in bucket order, the ``expected`` array of
        :meth:`BucketedEpochRunner.run_eval_epoch`'s predictions (read from
        the card: call it once, at staging)."""
        return (np.concatenate([np.asarray(torch.as_tensor(s.labels).cpu()) for _, s in
                                self.buckets]) if self.buckets else np.zeros(0, np.int32))


def _bucket_host_partition(staged: StagedCorpus,
                           ladder: tuple[int, ...]) -> list[tuple[int, StagedCorpus]]:
    """A host staging's rows by context count into ladder buckets. Rows
    longer than the top width land in the top bucket (the sampler
    subsamples them); empty buckets are dropped but for the top one."""
    rs = np.asarray(staged.row_splits).astype(np.int64)
    ctx, labels = np.asarray(staged.contexts), np.asarray(staged.labels)
    flags = None if staged.remap_flags is None else np.asarray(staged.remap_flags)
    counts = np.diff(rs)
    bucket_of = assign_buckets(counts, ladder)
    out = []
    for b, width in enumerate(ladder):
        members = np.flatnonzero(bucket_of == b)
        if not len(members) and width != ladder[-1]:
            continue
        flat, _, _ = flat_context_indices(rs, members)
        sub_splits = np.zeros(len(members) + 1, np.int64)
        np.cumsum(counts[members], out=sub_splits[1:])
        out.append((width, StagedCorpus(
            contexts=ctx[flat], row_splits=sub_splits, labels=labels[members],
            n_items=len(members), counts=counts[members], remap_ids=staged.remap_ids,
            remap_flags=None if flags is None else flags[members])))
    return out


def bucket_staged(staged: StagedCorpus, ladder: tuple[int, ...],
                  device: str | torch.device) -> BucketedStagedCorpus:
    """Partition a host staging over ``ladder`` and place each bucket on
    ``device``."""
    return BucketedStagedCorpus(buckets=[(width, place_staged(sub, device))
                                         for width, sub in _bucket_host_partition(staged, ladder)])


def sampler_generator(seed: int, device: str | torch.device) -> torch.Generator:
    """The shifts' generator on ``device``, seeded from the run's seed on a
    stream of its own (not dropout's, not the numpy generator's)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, SAMPLER_STREAM]).generate_state(1)[0]))
    return g


def sample_batch_from_shift(contexts: torch.Tensor, row_splits: torch.Tensor,
                            labels: torch.Tensor, rows: torch.Tensor, row_valid: torch.Tensor,
                            bag: int, shift: torch.Tensor, remap_ids: torch.Tensor | None = None,
                            remap_flags: torch.Tensor | None = None,
                            remap_u: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One ``[B, bag]`` batch of rows ``rows`` (int [B], may repeat for a
    masked tail; ``row_valid`` f32 [B] is the example mask): row ``i``
    takes contexts ``(shift[i] + j) % n_i`` for ``j < min(n_i, bag)`` and
    PAD after. With ``remap_u`` (f32 ``[B, V]``, a uniform draw) each row
    flagged in ``remap_flags`` maps every ``@var_*`` id of ``remap_ids``
    (sorted ``[V]``) to ``remap_ids[argsort(remap_u[i])]`` at its rank, the
    per-epoch shuffle of the variable ids. The value of JAX
    ``_sample_batch`` for the ``shift`` and ``remap_u`` its key draws;
    int32 ids and labels, f32 mask, as ``train/step.to_device`` gives the
    step."""
    rows = rows.long()
    off = row_splits[rows]
    n = row_splits[rows + 1] - off
    n_safe = n.clamp(min=1)[:, None]
    j = torch.arange(bag, dtype=torch.int32, device=contexts.device)[None, :]
    idx = (j + shift % n_safe) % n_safe
    valid = j < n.clamp(max=bag)[:, None]
    trip = contexts[torch.where(valid, off[:, None] + idx, 0)]  # [B, bag, 3]
    starts = torch.where(valid, trip[..., 0], PAD_INDEX)
    ends = torch.where(valid, trip[..., 2], PAD_INDEX)
    if remap_u is not None:
        n_var = remap_ids.shape[0]
        mapped = remap_ids[torch.argsort(remap_u, dim=1, stable=True)]  # [B, V]
        apply_row = (remap_flags[rows] > 0)[:, None]

        def remap(t: torch.Tensor) -> torch.Tensor:
            # searchsorted gives V past the largest id: clamp as JAX clips
            pos = torch.searchsorted(remap_ids, t).clamp_(max=n_var - 1)
            is_var = remap_ids[pos] == t
            return torch.where(is_var & apply_row, torch.take_along_dim(mapped, pos, dim=1), t)

        starts, ends = remap(starts), remap(ends)
    return {
        "starts": starts,
        "paths": torch.where(valid, trip[..., 1], PAD_INDEX),
        "ends": ends,
        "labels": labels[rows],
        "example_mask": row_valid,
    }


def remaps(corpus: StagedCorpus, shuffle_variable_ids: bool) -> bool:
    """Whether the sampler remaps ``corpus``'s variable rows (JAX
    ``_remap_args``): asked for, and the corpus carries ``@var_*`` ids."""
    return (shuffle_variable_ids and corpus.remap_ids is not None
            and int(corpus.remap_ids.shape[0]) > 0)


def sample_batch(corpus: StagedCorpus, rows: torch.Tensor, row_valid: torch.Tensor, bag: int,
                 generator: torch.Generator, shuffle_variable_ids: bool = False,
                 draw: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """:func:`sample_batch_from_shift` with the shifts, then (when the
    corpus :func:`remaps`) the ``[B, V]`` uniform draw, from ``generator``
    on the corpus's device. ``draw=(n, offset)``: draw ``n`` rows' values
    and take the ``B`` from ``offset`` (a shard's slice of the global
    batch's draw, so every rank's generator stays in one state)."""
    dev = corpus.contexts.device
    b = rows.shape[0]
    n, lo = draw if draw is not None else (b, 0)
    shift = torch.randint(0, SHIFT_HIGH, (n, 1), generator=generator, device=dev)[lo:lo + b]
    if not remaps(corpus, shuffle_variable_ids):
        return sample_batch_from_shift(corpus.contexts, corpus.row_splits, corpus.labels, rows,
                                       row_valid, bag, shift)
    u = torch.rand((n, corpus.remap_ids.shape[0]), generator=generator, device=dev)[lo:lo + b]
    return sample_batch_from_shift(corpus.contexts, corpus.row_splits, corpus.labels, rows,
                                   row_valid, bag, shift, corpus.remap_ids, corpus.remap_flags, u)


class _SideSampler:
    """``sample_prefetch`` on the card: the batches are sampled on a second
    stream, ordered after the chunk's inputs (made on the current stream)
    and waited for by the current stream before their step, so the gathers
    can overlap the step before them. Tensors crossing streams are recorded
    on the stream that uses them, so the allocator does not hand their
    memory out early."""

    def __init__(self, device: torch.device, *inputs: torch.Tensor):
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)
        self.side.wait_stream(self.main)
        for t in inputs:
            t.record_stream(self.side)

    def sample(self, fn, i: int):
        with torch.cuda.stream(self.side):
            batch = fn(i)
            done = torch.cuda.Event()
            done.record(self.side)
        return batch, done

    def ready(self, pending) -> dict[str, torch.Tensor]:
        batch, done = pending
        self.main.wait_event(done)
        for t in batch.values():
            t.record_stream(self.main)
        return batch


class EpochRunner:
    """Train and eval epochs over a :class:`StagedCorpus` at one bag width,
    ``chunk_batches`` sampled steps a chunk, enqueued with no host sync.

    ``sample_prefetch`` double-buffers as JAX ``_scan_train_chunk`` does:
    batch i + 1 is sampled before batch i is stepped (on a second stream
    on the card). The generator draws in the same order and no tail batch
    is drawn, so the batches are bit for bit those of the unprefetched
    runner."""

    def __init__(self, class_weights: torch.Tensor, batch_size: int, bag: int,
                 chunk_batches: int = 16, sample_prefetch: bool = False,
                 shuffle_variable_ids: bool = False, mesh=None):
        self.class_weights = class_weights
        self.batch_size = int(batch_size)
        self.bag = int(bag)
        self.chunk_batches = int(chunk_batches)
        self.sample_prefetch = bool(sample_prefetch)
        self.shuffle_variable_ids = bool(shuffle_variable_ids)
        # a replicated staging on a mesh: each rank keeps its part of the
        # global batch sampled alike everywhere
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._draw = None  # (rows drawn, offset): a sharded runner's slice

    def _place(self, batch: dict) -> dict:
        if self.mesh is None or self._draw is not None:
            return batch
        from code2vec_tpu_torch.parallel.distributed import global_batch

        return global_batch(self.mesh, batch)

    def _gather_preds(self, preds: torch.Tensor) -> torch.Tensor:
        """A replicated staging's predictions of the whole global batch."""
        if self.mesh is None or self._draw is not None:
            return preds
        from code2vec_tpu_torch.parallel.distributed import _all_gather

        group = self.mesh.group("data")
        return preds if group is None else _all_gather(preds, group, 0)

    def _chunk_plan(self, n_rows: int) -> list[tuple[int, int, int]]:
        """``[(row_lo, n_batches, n_valid_rows)]`` over ``ceil(n / B)``
        batches."""
        n_batches_total = -(-n_rows // self.batch_size)
        plan, lo = [], 0
        while lo < n_batches_total:
            nb = min(self.chunk_batches, n_batches_total - lo)
            row_lo = lo * self.batch_size
            plan.append((row_lo, nb, min(n_rows - row_lo, nb * self.batch_size)))
            lo += nb
        return plan

    def _padded_rows(self, order: np.ndarray, row_lo: int, nb: int) -> np.ndarray:
        rows = order[row_lo:row_lo + nb * self.batch_size]
        if len(rows) < nb * self.batch_size:
            # the masked tail repeats order[0], as iter_batches pads
            fill = np.full(nb * self.batch_size - len(rows), order[0] if len(order) else 0,
                           rows.dtype)
            rows = np.concatenate([rows, fill])
        return rows.astype(np.int32)

    def _batches(self, corpus: StagedCorpus, order: np.ndarray, row_lo: int, nb: int,
                 n_valid: int, generator: torch.Generator, tracer=NULL_TRACER):
        """The chunk's ``nb`` sampled batches, in order: one pinned,
        asynchronous copy of its row order to the card, the example mask
        made there. Each batch's sampling is a ``sample`` span of
        ``tracer``, timed on the stream it runs on."""
        dev = corpus.contexts.device
        rows = torch.from_numpy(self._padded_rows(order, row_lo, nb))
        if dev.type == "cuda":
            rows = rows.pin_memory().to(dev, non_blocking=True)
        valid = (torch.arange(nb * self.batch_size, device=dev) < n_valid).float()
        b = self.batch_size

        def sample(i):
            with tracer.span("sample", "train", dev):
                return self._place(sample_batch(corpus, rows[i * b:(i + 1) * b],
                                                valid[i * b:(i + 1) * b], self.bag, generator,
                                                self.shuffle_variable_ids, self._draw))

        if not self.sample_prefetch:
            for i in range(nb):
                yield sample(i)
            return
        # batch i + 1 is sampled before batch i is handed out (and stepped)
        side = _SideSampler(dev, rows, valid) if dev.type == "cuda" else None
        prefetch = side.sample if side else (lambda fn, i: fn(i))
        pending = prefetch(sample, 0)
        for i in range(nb):
            batch = side.ready(pending) if side else pending
            if i + 1 < nb:
                pending = prefetch(sample, i + 1)
            yield batch

    def _real_contexts(self, corpus: StagedCorpus, order: np.ndarray, row_lo: int,
                       nb: int, n_valid: int) -> list[int]:
        """Each of the chunk's batches' real (sampled, unmasked) contexts,
        from the host's copy of the counts."""
        taken = np.minimum(corpus.counts[order[row_lo:row_lo + n_valid]], self.bag)
        b = self.batch_size
        return [int(taken[i * b:(i + 1) * b].sum()) for i in range(nb)]

    def train_chunk(self, model, optimizer, corpus: StagedCorpus, order: np.ndarray,
                    row_lo: int, nb: int, n_valid: int, generator: torch.Generator,
                    tally: StepTally) -> None:
        """Enqueue one chunk of train steps; each step's loss goes to
        ``tally``. Under a tracer the chunk is a ``train_chunk`` span (args
        ``steps``, ``rows``, ``real_contexts``, ``slots`` and
        ``late_steps``, the steps in which an edged span found the card
        drained), holding each step's ``sample`` and ``train_step``; the
        device edges of the chunks before it are read first (no wait)."""
        tracer = get_tracer()
        tracer.poll()
        with tracer.span("train_chunk", "train", steps=nb, rows=n_valid,
                         slots=nb * self.batch_size * self.bag) as span:
            real = self._real_contexts(corpus, order, row_lo, nb, n_valid)
            late = 0
            for i, batch in enumerate(self._batches(corpus, order, row_lo, nb, n_valid,
                                                    generator, tracer)):
                drained = tracer.drained_edges
                tally.add(train_step(model, optimizer, batch, self.class_weights), real[i])
                late += tracer.drained_edges > drained
            if tracer.enabled:
                span.args.update(real_contexts=sum(real), late_steps=late)

    def train_epoch(self, model, optimizer, corpus: StagedCorpus, rng: np.random.Generator,
                    generator: torch.Generator, tally: StepTally) -> None:
        """Enqueue one epoch of train steps in the order ``rng`` draws."""
        order = rng.permutation(corpus.n_items)
        for row_lo, nb, n_valid in self._chunk_plan(corpus.n_items):
            self.train_chunk(model, optimizer, corpus, order, row_lo, nb, n_valid, generator,
                             tally)

    def run_train_epoch(self, model, optimizer, corpus: StagedCorpus, rng: np.random.Generator,
                        generator: torch.Generator) -> tuple[float, dict]:
        """One training epoch: ``(summed loss, speed)`` as the host path's
        ``_train_pass`` gives them, the losses read once."""
        tally = StepTally(corpus.contexts.device)
        self.train_epoch(model, optimizer, corpus, rng, generator, tally)
        return tally.result()

    def eval_epoch(self, model, corpus: StagedCorpus, generator: torch.Generator,
                   outs: list) -> None:
        """Enqueue one eval pass in corpus order; each batch's ``(loss,
        preds, max_logit)`` of its unmasked rows goes to ``outs``."""
        order = np.arange(corpus.n_items)
        for row_lo, nb, n_valid in self._chunk_plan(corpus.n_items):
            batches = self._batches(corpus, order, row_lo, nb, n_valid, generator)
            for i, batch in enumerate(batches):
                out = eval_step(model, batch, self.class_weights)
                k = min(self.batch_size, n_valid - i * self.batch_size)
                outs.append((out["loss"], self._gather_preds(out["preds"])[:k],
                             self._gather_preds(out["max_logit"])[:k]))

    def run_eval_epoch(self, model, corpus: StagedCorpus,
                       generator: torch.Generator) -> tuple[float, np.ndarray, np.ndarray]:
        """One eval pass in corpus order: ``(sum of the batch mean losses,
        preds [n_items], max_logits [n_items])``."""
        outs = []
        self.eval_epoch(model, corpus, generator, outs)
        return eval_results(outs)


def eval_results(outs: list) -> tuple[float, np.ndarray, np.ndarray]:
    """The eval outputs read back: the loss as the host path sums it."""
    if not outs:
        return 0.0, np.zeros(0, np.int64), np.zeros(0, np.float32)
    losses, preds, max_logits = zip(*outs)
    return (float(torch.stack(losses).double().sum()), torch.cat(preds).cpu().numpy(),
            torch.cat(max_logits).float().cpu().numpy())


class BucketedEpochRunner:
    """:class:`EpochRunner` over a :class:`BucketedStagedCorpus`: one
    sub-epoch per bucket at its own ``[B, L_b]`` shape. Training takes the
    buckets in the order ``rng.permutation(len(buckets))`` draws, each
    bucket then drawing its own method order; eval takes them in ladder
    order, the order of :meth:`BucketedStagedCorpus.host_labels`."""

    runner = EpochRunner  # the runner of one bucket

    def __init__(self, class_weights: torch.Tensor, batch_size: int, ladder: tuple[int, ...],
                 chunk_batches: int = 16, sample_prefetch: bool = False,
                 shuffle_variable_ids: bool = False, mesh=None):
        self.ladder = tuple(ladder)
        self.mesh = mesh
        self._runners = {width: self.runner(class_weights, batch_size, width, chunk_batches,
                                            sample_prefetch, shuffle_variable_ids, mesh)
                         for width in self.ladder}

    def run_train_epoch(self, model, optimizer, corpus: BucketedStagedCorpus,
                        rng: np.random.Generator,
                        generator: torch.Generator) -> tuple[float, dict]:
        tally = StepTally(corpus.contexts.device)
        for i in rng.permutation(len(corpus.buckets)):
            width, staged = corpus.buckets[int(i)]
            self._runners[width].train_epoch(model, optimizer, staged, rng, generator, tally)
        return tally.result()

    def run_eval_epoch(self, model, corpus: BucketedStagedCorpus,
                       generator: torch.Generator) -> tuple[float, np.ndarray, np.ndarray]:
        outs = []
        for width, staged in corpus.buckets:
            self._runners[width].eval_epoch(model, staged, generator, outs)
        return eval_results(outs)


# ---------------------------------------------------------------------------
# sharded staging (shard_staged_corpus): each rank holds its data share
# ---------------------------------------------------------------------------


@dataclass
class ShardedStagedCorpus:
    """A split partitioned over the mesh's data axis (JAX ``:286``): this
    rank holds ``local``, its coordinate's snake-dealt share
    (:func:`partition_items_balanced`), on its card; every rank knows every
    share's item count (``shard_counts``), which sets the epoch's length."""

    local: StagedCorpus
    shard_counts: np.ndarray  # int64 [data] items a share
    n_items: int  # every share's items
    total_contexts: int  # every share's contexts
    host_labels: np.ndarray  # this share's labels, on the host

    @property
    def n_contexts(self) -> int:
        return self.total_contexts

    @property
    def nbytes(self) -> int:
        """The bytes this rank stages."""
        return self.local.nbytes

    def flat_labels(self, mesh) -> np.ndarray:
        """Every share's labels in share order: the ``expected`` array of
        :meth:`ShardedEpochRunner.run_eval_epoch`'s predictions."""
        from code2vec_tpu_torch.parallel.distributed import allgather_to_host

        return allgather_to_host(self.host_labels, mesh)


def partition_items_balanced(counts: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Deal item positions to shards in a snake over descending context
    counts (JAX ``:323``): item counts equal within one, context loads
    close."""
    n = len(counts)
    order = np.argsort(-np.asarray(counts), kind="stable")
    pos_in_round = np.arange(n) % (2 * n_shards)
    shard = np.where(pos_in_round < n_shards, pos_in_round, 2 * n_shards - 1 - pos_in_round)
    return [np.sort(order[shard == s]).astype(np.int64) for s in range(n_shards)]


def _host_rows(staged: StagedCorpus, members: np.ndarray) -> StagedCorpus:
    """Rows ``members`` of a host staging, as a host staging of their own."""
    rs = np.asarray(staged.row_splits).astype(np.int64)
    counts = np.diff(rs)[members]
    flat, _, _ = flat_context_indices(rs, members)
    splits = np.zeros(len(members) + 1, np.int64)
    np.cumsum(counts, out=splits[1:])
    flags = None if staged.remap_flags is None else np.asarray(staged.remap_flags)[members]
    return StagedCorpus(contexts=np.asarray(staged.contexts)[flat], row_splits=splits,
                        labels=np.asarray(staged.labels)[members], n_items=len(members),
                        counts=counts.astype(np.int64), remap_ids=staged.remap_ids,
                        remap_flags=flags)


def shard_staged(staged: StagedCorpus, mesh, device: str | torch.device) -> ShardedStagedCorpus:
    """A host staging partitioned over the mesh's data axis (JAX
    ``shard_staged``, ``:386``): this rank places only its share on
    ``device`` (the 2^31 check is per share)."""
    n_shards, me = mesh.shape["data"], mesh.coords["data"]
    counts = np.diff(np.asarray(staged.row_splits).astype(np.int64))
    groups = partition_items_balanced(counts, n_shards)
    mine = _host_rows(staged, groups[me])
    return ShardedStagedCorpus(local=place_staged(_or_empty(mine, staged), device),
                               shard_counts=np.asarray([len(g) for g in groups], np.int64),
                               n_items=staged.n_items, total_contexts=int(counts.sum()),
                               host_labels=np.asarray(mine.labels))


def _or_empty(mine: StagedCorpus, like: StagedCorpus) -> StagedCorpus:
    """``mine``, or for a share with no rows (a bucket smaller than the data
    axis) the stand-in that still steps masked batches: one empty row over
    one PAD context to sample."""
    if mine.n_items:
        return mine
    return StagedCorpus(contexts=np.zeros((1, 3), np.int32), row_splits=np.zeros(2, np.int64),
                        labels=np.zeros(1, np.int32), n_items=1, counts=np.zeros(1, np.int64),
                        remap_ids=like.remap_ids,
                        remap_flags=None if like.remap_flags is None else np.zeros(1, np.int32))


def stage_method_corpus_sharded(data, item_idx: np.ndarray, rng: np.random.Generator, mesh,
                                device: str | torch.device) -> ShardedStagedCorpus:
    """Method-task host staging, then :func:`shard_staged` (JAX ``:436``)."""
    return shard_staged(stage_method_corpus(data, item_idx, rng), mesh, device)


def _check_shard_ctx_cap(ctx_cap: int, n_shards: int) -> None:
    """A share's ``row_splits`` are int32 (JAX ``:343``): the corpus may pass
    2^31 contexts, one share may not."""
    if ctx_cap >= 2**31:
        raise ValueError(f"largest shard holds {ctx_cap} contexts (int32 row_splits); "
                         f"increase data_axis beyond {n_shards}")


def settle_group_counts(gathered: np.ndarray, n_shards: int) -> tuple[np.ndarray, int]:
    """``(shard_counts, total_contexts)`` from :func:`shard_staged_multiprocess`'s
    gathered ``[world, 3 + 2 * n_shards]`` matrix (a rank's row: its items
    cap, its contexts cap, its feed group, then each coordinate's items and
    contexts, zero outside its group). Every rank reads the same matrix, so
    a check that fails here fails on every rank and none is left waiting at
    the next collective. The largest share's contexts must fit int32, and
    the replicas of a feed group must agree exactly on their counts: a
    mismatch means divergent staging (an rng seeded by rank, not by group),
    which would assemble wrong shares silently (JAX ``:518-541``)."""
    gathered = np.asarray(gathered, np.int64)
    _check_shard_ctx_cap(max(int(gathered[:, 1].max()), 1), n_shards)
    proc_groups = gathered[:, 2]
    all_counts = gathered[:, 3:3 + n_shards]
    all_ctx = gathered[:, 3 + n_shards:]
    for g in np.unique(proc_groups):
        members = np.flatnonzero(proc_groups == g)
        for name, arr in (("item", all_counts), ("context", all_ctx)):
            if not (arr[members] == arr[members[0]][None, :]).all():
                raise ValueError(
                    f"feed-group {int(g)} replicas disagree on per-shard "
                    f"{name} counts ({arr[members].tolist()}); group "
                    "members must stage the SAME shard with the SAME seed "
                    "(seed the staging rng by feed group, not by process)")
    return all_counts.max(axis=0), int(all_ctx.max(axis=0).sum())


def shard_staged_multiprocess(staged_local: StagedCorpus, mesh,
                              device: str | torch.device) -> ShardedStagedCorpus:
    """Sharded staging where each feed group stages only its own corpus
    shard (JAX ``:448``): ``staged_local`` is the host staging of this
    rank's group shard (``load_corpus(shard=feed_groups(mesh))``, the rng
    seeded by group, so the replicas of a group stage alike). The shard is
    dealt over the group's own data coordinates and this rank places its
    coordinate's share on ``device``; one all-gather of a small int64
    vector tells every rank every share's item and context counts. No rank
    holds the whole corpus. Method task only; a world of one rank is
    :func:`shard_staged`."""
    from code2vec_tpu_torch.parallel.distributed import feed_groups, process_allgather

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return shard_staged(staged_local, mesh, device)
    if staged_local.remap_ids is not None and len(np.asarray(staged_local.remap_ids)):
        raise ValueError("multi-process sharded staging supports the method task only; "
                         "stage the variable task replicated or use the host pipeline")
    group, n_groups = feed_groups(mesh)
    n_shards = mesh.shape["data"]
    if n_shards % n_groups:
        raise ValueError(f"data axis {n_shards} not divisible by {n_groups} feed groups")
    # group g owns the data coordinates [g * local_d, (g + 1) * local_d)
    local_d = n_shards // n_groups
    counts = np.diff(np.asarray(staged_local.row_splits).astype(np.int64))
    groups_local = partition_items_balanced(counts, local_d)
    mine = slice(group * local_d, (group + 1) * local_d)
    items, ctx = np.zeros(n_shards, np.int64), np.zeros(n_shards, np.int64)
    items[mine] = [len(g) for g in groups_local]
    ctx[mine] = [int(counts[g].sum()) for g in groups_local]
    gathered = process_allgather(np.concatenate([
        [max(items.max(), 1), max(ctx.max(), 1), group], items, ctx]))
    shard_counts, total_contexts = settle_group_counts(gathered, n_shards)
    members = groups_local[mesh.coords["data"] - group * local_d]
    # a group of one coordinate (one rank a coordinate, as the port's mesh
    # lays ranks) keeps every row in order: no second host copy of the shard
    share = (staged_local if len(members) == staged_local.n_items
             else _host_rows(staged_local, members))
    return ShardedStagedCorpus(local=place_staged(_or_empty(share, staged_local), device),
                               shard_counts=shard_counts, n_items=int(shard_counts.sum()),
                               total_contexts=total_contexts,
                               host_labels=np.asarray(share.labels))


@dataclass
class BucketedShardedStagedCorpus:
    """Each ladder bucket sharded over the data axis (JAX ``:1005``)."""

    buckets: list[tuple[int, ShardedStagedCorpus]]

    @property
    def n_items(self) -> int:
        return sum(s.n_items for _, s in self.buckets)

    @property
    def n_contexts(self) -> int:
        return sum(s.n_contexts for _, s in self.buckets)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for _, s in self.buckets)

    @property
    def contexts(self):
        """The first bucket's share of contexts on this rank."""
        return self.buckets[0][1].local.contexts

    def flat_labels(self, mesh) -> np.ndarray:
        return (np.concatenate([s.flat_labels(mesh) for _, s in self.buckets]) if self.buckets
                else np.zeros(0, np.int32))


def bucket_shard_staged(staged: StagedCorpus, ladder: tuple[int, ...], mesh,
                        device: str | torch.device) -> BucketedShardedStagedCorpus:
    """Ladder-partition a host staging, then shard each bucket (JAX
    ``:1038``)."""
    return BucketedShardedStagedCorpus(buckets=[
        (width, shard_staged(sub, mesh, device))
        for width, sub in _bucket_host_partition(staged, ladder)])


class ShardedEpochRunner(EpochRunner):
    """Epochs over a :class:`ShardedStagedCorpus` (JAX ``:1142``): each step
    samples ``B / data`` rows from this rank's share (stratified by share,
    as DDP and the host-sharded feed sample); the epoch runs
    ``ceil(largest share / (B / data))`` steps on every rank, a shorter
    share's tail masked. Data and model axes; ``ctx`` must be 1."""

    def __init__(self, class_weights: torch.Tensor, batch_size: int, bag: int,
                 chunk_batches: int = 16, sample_prefetch: bool = False,
                 shuffle_variable_ids: bool = False, mesh=None):
        if mesh is None:
            raise ValueError("ShardedEpochRunner needs a mesh")
        if mesh.shape["ctx"] > 1:
            raise ValueError("sharded corpus staging composes with data/model axes; a "
                             "ctx-sharded bag needs replicated staging or the host pipeline")
        n_shards = mesh.shape["data"]
        if batch_size % n_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by data axis {n_shards}")
        super().__init__(class_weights, batch_size // n_shards, bag, chunk_batches,
                         sample_prefetch, shuffle_variable_ids)
        self.mesh = mesh
        self.n_shards, self.shard = n_shards, mesh.coords["data"]
        self._draw = (batch_size, self.shard * self.batch_size)

    def _plan(self, counts: np.ndarray) -> list[tuple[int, int, int]]:
        """``[(row_lo, n_batches, n_valid_rows)]`` of this share over the
        largest share's batches."""
        per, mine = self.batch_size, int(counts[self.shard])
        nb_total = max(-(-int(counts.max()) // per), 1)
        plan, lo = [], 0
        while lo < nb_total:
            nb = min(self.chunk_batches, nb_total - lo)
            row_lo = lo * per
            plan.append((row_lo, nb, max(min(mine - row_lo, nb * per), 0)))
            lo += nb
        return plan

    def train_epoch(self, model, optimizer, corpus: ShardedStagedCorpus, rng, generator,
                    tally: StepTally) -> None:
        # every rank draws every share's order: the host generator stays one
        orders = [rng.permutation(int(c)) for c in corpus.shard_counts]
        order = orders[self.shard]
        for row_lo, nb, n_valid in self._plan(corpus.shard_counts):
            self.train_chunk(model, optimizer, corpus.local, order, row_lo, nb, n_valid,
                             generator, tally)

    def run_train_epoch(self, model, optimizer, corpus: ShardedStagedCorpus, rng, generator):
        tally = StepTally(corpus.local.contexts.device)
        self.train_epoch(model, optimizer, corpus, rng, generator, tally)
        return tally.result()

    def eval_epoch(self, model, corpus: ShardedStagedCorpus, generator, acc: list) -> None:
        """Enqueue one eval pass, each share in its own order; ``acc`` gets
        ``(loss, global valid rows, this share's preds, max logits)`` a
        batch."""
        counts, per = corpus.shard_counts, self.batch_size
        order = np.arange(int(counts[self.shard]))
        for row_lo, nb, n_valid in self._plan(counts):
            batches = self._batches(corpus.local, order, row_lo, nb, n_valid, generator)
            for i, batch in enumerate(batches):
                out = eval_step(model, batch, self.class_weights)
                lo = row_lo + i * per
                rows = int(np.clip(counts - lo, 0, per).sum())
                k = max(min(per, n_valid - i * per), 0)
                acc.append((out["loss"], rows, out["preds"][:k], out["max_logit"][:k]))

    def run_eval_epoch(self, model, corpus: ShardedStagedCorpus, generator):
        """``(loss, preds, max_logits)``, the predictions in share order
        (:meth:`ShardedStagedCorpus.flat_labels`), the loss JAX's: the
        batch means weighted by their valid rows, times ``ceil(N / B)``."""
        acc: list = []
        self.eval_epoch(model, corpus, generator, acc)
        return sharded_eval_results(acc, int(corpus.shard_counts.sum()),
                                    self.batch_size * self.n_shards, self.mesh)


def sharded_eval_results(acc: list, n_total: int, global_batch: int, mesh):
    from code2vec_tpu_torch.parallel.distributed import allgather_to_host

    if not acc:
        return 0.0, np.zeros(0, np.int64), np.zeros(0, np.float32)
    losses = torch.stack([a[0] for a in acc]).double().cpu().numpy()
    rows = np.asarray([a[1] for a in acc], np.float64)
    mean = float(losses @ rows) / max(float(rows.sum()), 1.0)
    preds = allgather_to_host(torch.cat([a[2] for a in acc]), mesh)
    max_logits = allgather_to_host(torch.cat([a[3] for a in acc]).float(), mesh)
    return mean * max(-(-n_total // global_batch), 1), preds, max_logits


class BucketedShardedEpochRunner(BucketedEpochRunner):
    """:class:`ShardedEpochRunner` a ladder bucket (JAX ``:1441``): training
    takes the buckets in ``rng.permutation(len(buckets))`` order, eval in
    ladder order, the order of :meth:`BucketedShardedStagedCorpus.flat_labels`."""

    runner = ShardedEpochRunner

    def run_eval_epoch(self, model, corpus: BucketedShardedStagedCorpus, generator):
        loss, preds, logits = 0.0, [], []
        for width, staged in corpus.buckets:
            runner = self._runners[width]
            acc: list = []
            runner.eval_epoch(model, staged, generator, acc)
            b_loss, b_preds, b_logits = sharded_eval_results(
                acc, int(staged.shard_counts.sum()), runner.batch_size * runner.n_shards,
                self.mesh)
            loss += b_loss
            preds.append(b_preds)
            logits.append(b_logits)
        return (loss, np.concatenate(preds) if preds else np.zeros(0, np.int64),
                np.concatenate(logits) if logits else np.zeros(0, np.float32))
