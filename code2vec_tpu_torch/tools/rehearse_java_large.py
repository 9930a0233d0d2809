"""java-large end-to-end rehearsal on the card, synthetic (BASELINE config 3).

Counterpart of ``tools/rehearse_java_large.py``, with its flags (and
``--device``; ``--vocab_rows`` and ``--n_labels`` cut the model) and its
five phases, each in a subprocess of its own (so each phase's peak RSS,
``VmHWM``, is its own; the parent imports no torch):

  gen        chunked corpus synthesis at ``--n_methods`` x ~120 contexts a
             method into ``.npy`` files (byte-identical to JAX's
             ``phase_gen`` at the same ``--n_methods``)
  guard      the device staging's int32 guard
             (``train/device_epoch._check_device_total``) against the real
             total, and a forced-overflow probe that must fire before any
             allocation
  hostshard  the per-host CSR bytes of ``--host_shard_corpus``'s
             round-robin share, at array level
  stream     ``iter_streaming_batches`` (``--stream_chunk_items``) driving
             real train steps on the card, the corpus memory-mapped from
             disk, on a model with 1.3M-row path and terminal vocabs and 50k
             labels
  shard      ``shard_staged_multiprocess`` + ``ShardedEpochRunner`` over
             a ``data=--data_axis`` ``torch.distributed`` group (gloo), one
             process a rank, real train steps: each rank stages only its
             round-robin share of the memory-mapped corpus (its feed
             group's shard, as ``hostshard`` reckons it), so together the
             ranks stage the corpus once; each rank's staged bytes against
             the ``/D`` budget. Ranks share the visible cards in turn (on
             one card: every rank on it, as a gloo mesh runs)

The train phases run the ``pool_only`` route (K1 forward, K1b backward)
at batch ``--batch``, bag ``--bag``, dropout 0.25, with ``--table_update``
dense or lazy tables. Results stream as JSON lines, each written whole in
one call (the shard phase's ranks share one stdout); every phase but
``gen`` and ``hostshard`` names its device. The shard phase's ranks meet
at a file store under ``--work_dir``, so there is no port to pick. The
corpus text layer is not rehearsed: the phases drive the array-level paths
below it::

    python -m code2vec_tpu_torch.tools.rehearse_java_large             # 16M methods
    python -m code2vec_tpu_torch.tools.rehearse_java_large --n_methods 2000000 --steps 2 \\
        --data_axis 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "java_large_rehearsal")

N_TERMINALS = 1_300_000  # and as many paths
N_LABELS = 50_000
MEAN_CONTEXTS = 120.0
MAX_CONTEXTS = 1000
GEN_CHUNK = 64_000_000


def _rss() -> dict:
    """Current and peak RSS, and the anonymous part of the current (not
    the mapped corpus's file pages), in MB from /proc/self/status."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS", "VmHWM", "RssAnon")):
                k, v = line.split(":")
                out[k] = round(int(v.split()[0]) / 1024.0)
    return out


def _emit(**kw) -> None:
    # one write a line: under PYTHONUNBUFFERED ``print`` writes the text and
    # its newline apart, and the lines of two ranks would interleave
    sys.stdout.write(json.dumps(kw) + "\n")
    sys.stdout.flush()


def phase_gen(work_dir: str, n_methods: int, vocab_rows: int = N_TERMINALS,
              n_labels: int = N_LABELS) -> None:
    """JAX's synthesis, draw for draw: at the default vocab and label
    counts, the same files as JAX's ``phase_gen`` at the same size."""
    import numpy as np

    os.makedirs(work_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    t0 = time.time()
    counts = np.clip(
        rng.lognormal(np.log(MEAN_CONTEXTS), 0.6, n_methods).astype(np.int64),
        3, MAX_CONTEXTS,
    )
    row_splits = np.zeros(n_methods + 1, np.int64)
    np.cumsum(counts, out=row_splits[1:])
    total = int(row_splits[-1])
    _emit(phase="gen", n_methods=n_methods, total_contexts=total, int32_margin=2**31 - total)

    labels = rng.integers(0, n_labels, n_methods).astype(np.int32)
    np.save(os.path.join(work_dir, "row_splits.npy"), row_splits)
    np.save(os.path.join(work_dir, "labels.npy"), labels)
    # chunked straight into on-disk memmaps: the peak is the chunk's
    # temporaries, not the whole corpus
    mms = {
        name: np.lib.format.open_memmap(os.path.join(work_dir, f"{name}.npy"), mode="w+",
                                        dtype=np.int32, shape=(total,))
        for name in ("starts", "paths", "ends")
    }
    lo = 0
    while lo < total:
        hi = min(lo + GEN_CHUNK, total)
        n = hi - lo
        mms["starts"][lo:hi] = rng.integers(1, vocab_rows + 1, n, dtype=np.int32)
        mms["paths"][lo:hi] = rng.integers(1, vocab_rows + 1, n, dtype=np.int32)
        mms["ends"][lo:hi] = rng.integers(1, vocab_rows + 1, n, dtype=np.int32)
        lo = hi
    for m in mms.values():
        m.flush()
    del mms
    _emit(phase="gen", done=True, seconds=round(time.time() - t0, 1),
          csr_gb=round(total * 3 * 4 / 2**30, 2), **_rss())


def load_corpus_data(work_dir: str, n_labels: int):
    """A ``CorpusData`` over the generated arrays, memory-mapped (RSS grows
    only with the pages a path touches). Vocabs hold the special tokens and
    the labels only: the phases train, they do not decode."""
    import numpy as np

    from code2vec_tpu_torch.data.reader import CorpusData
    from code2vec_tpu_torch.data.vocab import Vocab

    arrays = {name: np.load(os.path.join(work_dir, f"{name}.npy"), mmap_mode="r")
              for name in ("starts", "paths", "ends")}
    row_splits = np.load(os.path.join(work_dir, "row_splits.npy"))
    labels = np.load(os.path.join(work_dir, "labels.npy"))
    n = len(row_splits) - 1
    label_vocab = Vocab()
    for i in range(n_labels):
        label_vocab.add_label(f"label{i}")
    terminal_vocab = Vocab()
    terminal_vocab.add("<PAD/>", 0)
    terminal_vocab.add("@question", 1)
    path_vocab = Vocab()
    path_vocab.add("<PAD/>", 0)
    return CorpusData(
        **arrays, row_splits=row_splits, ids=np.arange(n, dtype=np.int64), labels=labels,
        normalized_labels=[], sources=[None] * n, aliases=[{}] * n,
        terminal_vocab=terminal_vocab, path_vocab=path_vocab, label_vocab=label_vocab,
        mmap_backed=True,
    )


def model_bits(device, batch: int, bag: int, table_update: str, vocab_rows: int,
               n_labels: int):
    """The java-large model on ``device`` (``pool_only``), its optimizer
    and class weights."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer

    config = Code2VecConfig(
        terminal_count=vocab_rows + 2, path_count=vocab_rows + 1, label_count=n_labels,
        terminal_embed_size=100, path_embed_size=100, encode_size=100, dropout_prob=0.25,
        use_pallas=True, pallas_impl="pool_only")
    with torch.device(device):  # built and initialized where it trains
        model = Code2Vec(config)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    model.seed_dropout(0)
    optimizer = make_optimizer(model, TrainConfig(batch_size=batch, max_path_length=bag,
                                                  table_update=table_update))
    return model, optimizer, torch.ones(n_labels, device=device)


def _sync(device) -> None:
    """Wait for the card: each step is timed on its own, as JAX's rehearsal
    blocks on every step's loss."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_stats(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"device": device.type}
    return {"device": torch.cuda.get_device_name(device),
            "peak_device_mb": round(torch.cuda.max_memory_allocated(device) / 2**20)}


def phase_guard(work_dir: str, device_arg: str | None) -> None:
    import numpy as np

    from code2vec_tpu_torch.train.device_epoch import _check_device_total, stage_method_corpus

    row_splits = np.load(os.path.join(work_dir, "row_splits.npy"))
    total = int(row_splits[-1])
    try:
        _check_device_total(total)
        fits = True
    except ValueError:
        fits = False
    _emit(phase="guard", total_contexts=total, fits_int32=fits, margin=2**31 - total)

    # forced overflow: a stub whose selected rows exceed 2^31 contexts must
    # trip the guard before any allocation
    class _Stub:
        pass

    stub = _Stub()
    stub.row_splits = np.array([0, 2**31 + 10], np.int64)
    try:
        stage_method_corpus(stub, np.array([0]), np.random.default_rng(0),
                            device=device_arg or "cuda")
    except ValueError as e:
        _emit(phase="guard", overflow_guard="fired", message=str(e)[:120])
    else:
        _emit(phase="guard", overflow_guard="DID NOT FIRE (BUG)")
        sys.exit(1)


def phase_hostshard(work_dir: str, n_hosts: int) -> None:
    import numpy as np

    counts = np.diff(np.load(os.path.join(work_dir, "row_splits.npy")))
    # the reader keeps rows with id % n_hosts == host (data/reader.py's
    # round robin); the CSR bytes of a host's share dominate its budget
    shares = [int(counts[host::n_hosts].sum()) * 3 * 4 for host in range(n_hosts)]
    _emit(phase="hostshard", n_hosts=n_hosts,
          per_host_csr_gb=[round(s / 2**30, 2) for s in shares],
          max_over_min=round(max(shares) / min(shares), 4))


def phase_stream(work_dir: str, batch: int, bag: int, steps: int, chunk_items: int,
                 table_update: str, device_arg: str | None, vocab_rows: int,
                 n_labels: int) -> None:
    import numpy as np

    from code2vec_tpu_torch.data.pipeline import build_epoch, iter_streaming_batches
    from code2vec_tpu_torch.ops.backend import launch_counts, resolve_device
    from code2vec_tpu_torch.train.step import to_device, train_step

    device = resolve_device(device_arg)
    data = load_corpus_data(work_dir, n_labels)
    _emit(phase="stream", loaded=True, **_rss())
    model, optimizer, cw = model_bits(device, batch, bag, table_update, vocab_rows, n_labels)
    rng = np.random.default_rng(0)
    it = iter_streaming_batches(lambda idx: build_epoch(data, idx, bag, rng),
                                np.arange(data.n_items), batch, rng, chunk_items=chunk_items)
    t_start = time.time()
    first_batch_s, times, loss = None, [], None
    for b in it:
        if first_batch_s is None:
            first_batch_s = time.time() - t_start  # the first chunk's build
        t0 = time.time()
        loss = train_step(model, optimizer, to_device(b, device), cw)
        _sync(device)
        times.append(time.time() - t0)
        if len(times) >= steps:
            break
    _emit(phase="stream", steps=len(times),
          first_step_s=round(times[0], 2) if times else None,
          later_step_s=round(float(np.mean(times[1:])), 3) if len(times) > 1 else None,
          chunk_items=chunk_items,
          time_to_first_batch_s=round(first_batch_s, 1) if first_batch_s else None,
          final_loss=None if loss is None else float(loss), launches=launch_counts(),
          **_device_stats(device), **_rss())


def phase_shard(work_dir: str, batch: int, bag: int, steps: int, data_axis: int,
                table_update: str, device_arg: str | None, vocab_rows: int, n_labels: int,
                rank: int, init: str) -> None:
    """One rank of the ``data=data_axis`` group: its feed group's
    round-robin share of the memory-mapped corpus, staged with the group's
    seed; ``shard_staged_multiprocess`` places it and tells every rank
    every share's counts."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from code2vec_tpu_torch.ops.backend import launch_counts
    from code2vec_tpu_torch.parallel.distributed import feed_groups
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    from code2vec_tpu_torch.parallel.shardings import shard_model
    from code2vec_tpu_torch.train.device_epoch import (
        ShardedEpochRunner,
        sampler_generator,
        shard_staged_multiprocess,
        stage_method_corpus,
    )
    from code2vec_tpu_torch.train.step import StepTally

    if device_arg is None or device_arg.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass --device cpu")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_arg)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=data_axis,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(data=data_axis, model=1, ctx=1)
        group, n_groups = feed_groups(mesh)
        data = load_corpus_data(work_dir, n_labels)
        if rank == 0:
            _emit(phase="shard", loaded=True, **_rss())
        model, optimizer, cw = model_bits(device, batch, bag, table_update, vocab_rows,
                                          n_labels)
        shard_model(model, mesh)
        # the reader's round robin (data/reader.py): this group's rows
        mine = np.arange(group, data.n_items, n_groups)
        t0 = time.time()
        staged = shard_staged_multiprocess(
            stage_method_corpus(data, mine, np.random.default_rng(1000 + group)), mesh, device)
        del data
        local = int(staged.nbytes)
        _emit(phase="shard", rank=rank, staged=True, seconds=round(time.time() - t0, 1),
              data_axis=data_axis, local_items=len(mine),
              per_device_staged_mb=round(local / 2**20),
              total_staged_mb=round(local * data_axis / 2**20), **_rss())
        rng = np.random.default_rng(0)
        runner = ShardedEpochRunner(cw, batch, bag, chunk_batches=1, mesh=mesh)
        gen = sampler_generator(0, device)
        tally = StepTally(device)
        per = runner.batch_size
        times = []
        for _ in range(steps):
            order = rng.integers(0, max(int(staged.shard_counts[runner.shard]), 1), per)
            t0 = time.time()
            runner.train_chunk(model, optimizer, staged.local, order, 0, 1, per, gen, tally)
            _sync(device)
            times.append(time.time() - t0)
        _emit(phase="shard", rank=rank, steps=steps, first_step_s=round(times[0], 2),
              later_step_s=round(float(np.mean(times[1:])), 3) if len(times) > 1 else None,
              final_loss=float(tally.losses[-1]), launches=launch_counts(),
              **_device_stats(device), **_rss())
    finally:
        dist.destroy_process_group()


def run_phases(args) -> int:
    """Every phase in its own subprocess, in order; the first that fails
    stops the run with its exit code."""
    base = [sys.executable, "-m", "code2vec_tpu_torch.tools.rehearse_java_large",
            "--work_dir", args.work_dir]
    if args.device:
        base += ["--device", args.device]
    base += ["--vocab_rows", str(args.vocab_rows), "--n_labels", str(args.n_labels)]
    # the train phases take the recipe's shape: a small run must not
    # silently train the defaults
    shape = ["--batch", str(args.batch), "--bag", str(args.bag),
             "--table_update", args.table_update, "--steps", str(args.steps)]
    phases = [
        ["--phase", "gen", "--n_methods", str(args.n_methods)],
        ["--phase", "guard"],
        ["--phase", "hostshard", "--n_hosts", str(args.n_hosts)],
        ["--phase", "stream", "--chunk_items", str(args.chunk_items)] + shape,
        ["--phase", "shard", "--data_axis", str(args.data_axis)] + shape,
    ]
    t0 = time.time()
    for extra in phases:
        _emit(running=extra[1])
        t_phase = time.time()
        if extra[1] == "shard":
            store = os.path.abspath(os.path.join(args.work_dir, "shard.rendezvous"))
            if os.path.exists(store):  # a --keep run's, which a new group must not read
                os.remove(store)
            init = "file://" + store
            procs = [subprocess.Popen(base + extra + ["--rank", str(r), "--init", init])
                     for r in range(args.data_axis)]
            rcs = [p.wait() for p in procs]
            rc = next((c for c in rcs if c), 0)
        else:
            rc = subprocess.call(base + extra)
        _emit(phase=extra[1], rc=rc, seconds=round(time.time() - t_phase, 1))
        if rc != 0:
            _emit(phase=extra[1], rc=rc, error="phase failed")
            return rc
    if not args.keep:
        import shutil

        shutil.rmtree(args.work_dir, ignore_errors=True)
    _emit(done=True, total_minutes=round((time.time() - t0) / 60.0, 1))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.rehearse_java_large",
                                 description="java-large rehearsal (module docstring)")
    ap.add_argument("--phase", choices=["gen", "guard", "stream", "shard", "hostshard"])
    ap.add_argument("--work_dir", default=DEFAULT_DIR)
    ap.add_argument("--n_methods", type=int, default=16_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--bag", type=int, default=200)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--chunk_items", type=int, default=65_536)
    ap.add_argument("--data_axis", type=int, default=4)
    ap.add_argument("--n_hosts", type=int, default=8)
    ap.add_argument("--table_update", choices=("dense", "lazy"), default="dense",
                    help="the tables' optimizer in the train phases: 'lazy' steps only the "
                    "touched rows (train/table_opt.py), the mode made for this vocab scale")
    ap.add_argument("--keep", action="store_true", help="keep the generated corpus files")
    ap.add_argument("--device", default=None,
                    help="torch device of the train phases (default cuda; 'cpu' runs the "
                    "plain versions)")
    ap.add_argument("--vocab_rows", type=int, default=N_TERMINALS,
                    help="rows of the terminal and of the path vocab (java-large: 1.3M); a "
                    "smaller value rehearses a cut model")
    ap.add_argument("--n_labels", type=int, default=N_LABELS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.phase == "gen":
        phase_gen(args.work_dir, args.n_methods, args.vocab_rows, args.n_labels)
    elif args.phase == "guard":
        phase_guard(args.work_dir, args.device)
    elif args.phase == "hostshard":
        phase_hostshard(args.work_dir, args.n_hosts)
    elif args.phase == "stream":
        phase_stream(args.work_dir, args.batch, args.bag, args.steps, args.chunk_items,
                     args.table_update, args.device, args.vocab_rows, args.n_labels)
    elif args.phase == "shard":
        phase_shard(args.work_dir, args.batch, args.bag, args.steps, args.data_axis,
                    args.table_update, args.device, args.vocab_rows, args.n_labels,
                    args.rank, args.init)
    else:
        return run_phases(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
