"""Device-epoch training of code2seq (``models/code2seq.py``): the corpus
staged on the card, each step's batch sampled there and expanded to
subtokens, nodes and target subtokens by the model, chunks of steps
enqueued with no host sync (``train/device_epoch.EpochRunner.
train_chunk``), SGD with Nesterov momentum.

As ``train_device.py``: set-up builds one training object (the model from
``code2seq_inputs.py``'s weights and tables, its optimizer, the runner, the
staged corpus and the sampler's generator) and drives it through its first
``compare_steps`` steps, one ``train_chunk`` call each; it reads the
momentum buffer after the first step (the first gradient) and each
parameter's change after the last. One whole chunk warms the window's
call; the window hands the same object chunk after chunk until ``seconds``
have passed and ends in one ``torch.cuda.synchronize()``. After it, with the
program's state freed, the plain reference (``reference_code2seq.py``)
follows the first steps from the same weights, tables, rows and seed, and
the two are compared (``compare.train_gaps``).

With ``trace`` the program's tracer (``obs/trace.Tracer``) is installed for
the window and its ``summary`` over the window goes to
``run.counters["program"]`` (the ``path_encoder`` and ``decoder`` spans the
per-layer metrics read); the last ``trace_seconds`` run under the profiler,
each chunk's call marked ``train_chunk`` and the idle gaps named by the
program's spans.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from c2vbench import compare, costs_code2seq
from c2vbench.code2seq_inputs import draw_tables, make_weights, table_rows
from c2vbench.corpus import draw_corpus
from c2vbench.drivers.train_device import RowFeed
from c2vbench.harness import Run, peak_bytes, sync
from c2vbench.reference_code2seq import follow_train
from c2vbench.seeds import numpy_rng, sub_seed, torch_generator
from c2vbench.trace import Profiler


def build(cell, seed: int, device):
    """The training object of the cell, its corpus and its tables."""
    import torch

    from code2vec_tpu_torch.models.code2seq import Code2Seq, Code2SeqConfig
    from code2vec_tpu_torch.train.device_epoch import EpochRunner, StagedCorpus
    from code2vec_tpu_torch.train.step import make_optimizer

    cfg, tr = cell.config, cell.traffic
    corpus = draw_corpus(cfg, seed, device)
    tables = draw_tables(cfg, seed, device)
    staged = StagedCorpus(contexts=corpus.contexts, row_splits=corpus.row_splits,
                          labels=corpus.labels, n_items=corpus.n_items, counts=corpus.counts)
    sub_rows, node_rows, tgt_rows = table_rows(cfg)
    mcfg = Code2SeqConfig(
        subtoken_count=sub_rows, node_count=node_rows, target_count=tgt_rows,
        embed_size=cfg["embed_size"], rnn_size=cfg["rnn_size"],
        decoder_size=cfg["decoder_size"], max_name_parts=cfg["max_name_parts"],
        max_path_nodes=cfg["max_path_nodes"], max_target_parts=cfg["max_target_parts"],
        embed_dropout_prob=cfg["embed_dropout_prob"], rnn_dropout_prob=cfg["rnn_dropout_prob"])
    with torch.device(device):
        model = Code2Seq(mcfg, tables)
    model.load_state_dict(make_weights(cfg, seed, device))
    model.seed_dropout(sub_seed(seed, "dropout"))
    optimizer = make_optimizer(model, SimpleNamespace(lr=cfg["lr"],
                                                      weight_decay=cfg["weight_decay"]))
    if optimizer.defaults["momentum"] != cfg["momentum"]:
        raise ValueError(f"the program's Nesterov momentum {optimizer.defaults['momentum']} "
                         f"is not the configuration's {cfg['momentum']}")
    # code2seq's loss weighs no class
    class_weights = torch.ones(1, dtype=torch.float32, device=device)
    runner = EpochRunner(class_weights, cfg["batch_size"], cfg["max_path_length"],
                         chunk_batches=tr["chunk_batches"], sample_prefetch=tr["sample_prefetch"])
    return SimpleNamespace(model=model, optimizer=optimizer, runner=runner, staged=staged,
                           generator=torch_generator(seed, "sampler", device)), corpus, tables


def first_steps(obj, feed: RowFeed, n_steps: int, batch: int, device):
    """The set-up's first steps through ``train_chunk``: ``(rows, losses,
    grad, delta)``, the readings still on the device; the first gradient is
    the momentum buffer after one step."""
    import torch

    from code2vec_tpu_torch.train.step import StepTally

    named = dict(obj.model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    tally = StepTally(device)
    rows, grad = [], {}
    for i in range(n_steps):
        order, lo, nb = feed.take(1)
        rows.append(order[lo:lo + batch].copy())
        obj.runner.train_chunk(obj.model, obj.optimizer, obj.staged, order, lo, nb, batch,
                               obj.generator, tally)
        if i == 0:
            grad = {k: obj.optimizer.state[p]["momentum_buffer"].norm()
                    for k, p in named.items()}
    delta = {k: (p.detach() - before[k]).norm() for k, p in named.items()}
    del before
    return rows, torch.stack(tally.losses), grad, delta


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    import torch

    from c2vbench.program_spans import _marked
    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer
    from code2vec_tpu_torch.train.step import StepTally

    cfg, tr = cell.config, cell.traffic
    batch, bag, chunk = cfg["batch_size"], cfg["max_path_length"], tr["chunk_batches"]
    obj, corpus, tables = build(cell, seed, device)
    feed = RowFeed(corpus.n_items, batch, numpy_rng(seed, "rows"))
    rows, losses, grad, delta = first_steps(obj, feed, tr["compare_steps"], batch, device)
    warm = StepTally(device)
    order, lo, nb = feed.take(chunk)
    obj.runner.train_chunk(obj.model, obj.optimizer, obj.staged, order, lo, nb, nb * batch,
                           obj.generator, warm)
    sync(device)

    tally = StepTally(device)
    steps = contexts = enqueue_steps = traced_steps = 0
    enqueue_s = 0.0
    prof = None
    tracer = Tracer() if trace else None
    profiler = _marked(tracer, []) if trace else Profiler
    previous = set_tracer(tracer)
    try:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if trace and prof is None and now - t0 >= seconds - tr["trace_seconds"]:
                prof = profiler()
                prof.start()
            order, lo, nb = feed.take(chunk)
            ta, ta_ns = time.perf_counter(), time.time_ns()
            obj.runner.train_chunk(obj.model, obj.optimizer, obj.staged, order, lo, nb,
                                   nb * batch, obj.generator, tally)
            if prof is None:
                enqueue_s += time.perf_counter() - ta
                enqueue_steps += nb
            else:
                prof.mark("train_chunk", ta_ns, time.time_ns())
                traced_steps += nb
            contexts += int(np.minimum(corpus.counts[order[lo:lo + nb * batch]], bag).sum())
            steps += nb
        sync(device)
        t1 = time.perf_counter()
    finally:
        set_tracer(previous)
    window_s = t1 - t0
    summary = prof.stop() if prof is not None else None
    memory_peak = peak_bytes(device)
    program = tracer.summary(round(t0 * 1e9), round(t1 * 1e9)) if trace else None

    window_losses = torch.stack(tally.losses)
    failed = int((~torch.isfinite(window_losses)).sum())
    prog = {"losses": losses.cpu().tolist(),
            "grad": {k: float(v) for k, v in grad.items()},
            "delta": {k: float(v) for k, v in delta.items()}}
    del obj, tally, warm, window_losses, losses, grad, delta, tracer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow_train(cfg, tr, make_weights(cfg, seed, device), tables, corpus, rows, seed)
    checks = compare.judge(compare.train_gaps(prog, ref), tr["limits"])

    counters = {
        "setup_s": setup_s, "window_s": window_s, "steps": steps, "contexts": contexts,
        "enqueue_s": enqueue_s, "enqueue_steps": enqueue_steps, "traced_steps": traced_steps,
        "step_flops": costs_code2seq.train_step_flops(batch, bag, **costs_code2seq.dims_of(cfg)),
        "path_step_flops": costs_code2seq.lstm_step_flops(cfg["embed_size"],
                                                          cfg["rnn_size"] // 2),
    }
    if program is not None:
        counters["program"] = program
    return Run(correct=compare.passed(checks) and failed == 0, attempted=steps, failed=failed,
               checks=checks, counters=counters, trace=summary, memory_peak_bytes=memory_peak,
               config=cfg)
