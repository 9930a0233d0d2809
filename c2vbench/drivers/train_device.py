"""Device-epoch training: the corpus staged on the card, each step's batch
sampled there, chunks of steps enqueued with no host sync
(``train/device_epoch.EpochRunner.train_chunk``).

Set-up builds one training object (the model, its optimizer, the runner,
the staged corpus and the sampler's generator) and drives it through its
first ``compare_steps`` steps, one call of ``train_chunk`` each, on rows
that all differ; it reads the optimizer's first moment after the first
step and each parameter's change after the last. One whole chunk then
warms the window's call. The window hands the same object chunk after
chunk of the seed's epoch orders until ``seconds`` have passed, and ends
in one ``torch.cuda.synchronize()``. After it, with the program's state
freed, the plain reference follows the first steps from the same weights,
rows and seed, and the two are compared (``compare.train_gaps``).

With ``trace`` the last ``trace_seconds`` of the window run under the
profiler, each chunk's call marked ``train_chunk``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from c2vbench import compare, costs
from c2vbench.corpus import draw_corpus
from c2vbench.harness import Run, peak_bytes, sync
from c2vbench.reference import follow_train
from c2vbench.seeds import numpy_rng, sub_seed, torch_generator
from c2vbench.trace import Profiler
from c2vbench.weights import make_weights


class RowFeed:
    """Chunks of whole batches over epochs of the seed's method orders (a
    short chunk ends an epoch; the last partial batch is left out)."""

    def __init__(self, n_items: int, batch: int, rng: np.random.Generator):
        self.n, self.b, self.rng = n_items, batch, rng
        self.order, self.lo, self.left = None, 0, 0

    def take(self, nb: int) -> tuple[np.ndarray, int, int]:
        if not self.left:
            self.order, self.lo, self.left = self.rng.permutation(self.n), 0, self.n // self.b
        nb = min(nb, self.left)
        lo = self.lo
        self.lo += nb * self.b
        self.left -= nb
        return self.order, lo, nb


def first_moment_norm(optimizer, param):
    """The norm of ``param``'s first moment in the optimizer's state (a lazy
    optimizer keeps the non-table parameters' in its dense Adam); 0 when
    the state holds none, as after a step that left it unchanged."""
    import torch

    for opt in (optimizer, getattr(optimizer, "dense", None)):
        state = getattr(opt, "state", {}).get(param, {})
        if "exp_avg" in state:
            return state["exp_avg"].float().norm()
    return torch.zeros((), device=param.device)


def build(cell, seed: int, device):
    """The training object of the cell and its corpus."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.train.device_epoch import EpochRunner, StagedCorpus
    from code2vec_tpu_torch.train.step import make_optimizer

    cfg, tr = cell.config, cell.traffic
    corpus = draw_corpus(cfg, seed, device)
    staged = StagedCorpus(contexts=corpus.contexts, row_splits=corpus.row_splits,
                          labels=corpus.labels, n_items=corpus.n_items, counts=corpus.counts)
    mcfg = Code2VecConfig(
        terminal_count=cfg["terminal_count"], path_count=cfg["path_count"],
        label_count=cfg["label_count"], terminal_embed_size=cfg["terminal_embed_size"],
        path_embed_size=cfg["path_embed_size"], encode_size=cfg["encode_size"],
        dropout_prob=cfg["dropout_prob"], use_pallas=tr["use_pallas"],
        pallas_impl=tr["pallas_impl"])
    with torch.device(device):
        model = Code2Vec(mcfg)
    model.load_state_dict(make_weights(cfg, seed, device))
    model.seed_dropout(sub_seed(seed, "dropout"))
    optimizer = make_optimizer(model, SimpleNamespace(
        lr=cfg["lr"], beta_min=cfg["beta_min"], beta_max=cfg["beta_max"],
        weight_decay=cfg["weight_decay"], adam_mu_dtype="float32",
        table_update=tr["table_update"]))
    class_weights = torch.ones(cfg["label_count"], dtype=torch.float32, device=device)
    runner = EpochRunner(class_weights, cfg["batch_size"], cfg["max_path_length"],
                         chunk_batches=tr["chunk_batches"], sample_prefetch=tr["sample_prefetch"])
    return SimpleNamespace(model=model, optimizer=optimizer, runner=runner, staged=staged,
                           generator=torch_generator(seed, "sampler", device)), corpus


def first_steps(obj, feed: RowFeed, n_steps: int, b1: float, batch: int, device):
    """The set-up's first steps through ``train_chunk``: ``(rows, losses,
    grad, delta)``, the readings still on the device."""
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
            grad = {k: first_moment_norm(obj.optimizer, p) / (1.0 - b1)
                    for k, p in named.items()}
    delta = {k: (p.detach() - before[k]).norm() for k, p in named.items()}
    del before
    return rows, torch.stack(tally.losses), grad, delta


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    import torch

    from code2vec_tpu_torch.train.step import StepTally

    cfg, tr = cell.config, cell.traffic
    batch, bag, chunk = cfg["batch_size"], cfg["max_path_length"], tr["chunk_batches"]
    obj, corpus = build(cell, seed, device)
    feed = RowFeed(corpus.n_items, batch, numpy_rng(seed, "rows"))
    rows, losses, grad, delta = first_steps(obj, feed, tr["compare_steps"], cfg["beta_min"],
                                            batch, device)
    warm = StepTally(device)
    order, lo, nb = feed.take(chunk)
    obj.runner.train_chunk(obj.model, obj.optimizer, obj.staged, order, lo, nb, nb * batch,
                           obj.generator, warm)
    sync(device)

    tally = StepTally(device)
    steps = contexts = enqueue_steps = traced_steps = 0
    enqueue_s = 0.0
    prof = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if trace and prof is None and now - t0 >= seconds - tr["trace_seconds"]:
            prof = Profiler()
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
    window_s = time.perf_counter() - t0
    summary = prof.stop() if prof is not None else None
    memory_peak = peak_bytes(device)

    window_losses = torch.stack(tally.losses)
    failed = int((~torch.isfinite(window_losses)).sum())
    prog = {"losses": losses.cpu().tolist(),
            "grad": {k: float(v) for k, v in grad.items()},
            "delta": {k: float(v) for k, v in delta.items()}}
    del obj, tally, warm, window_losses, losses, grad, delta
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow_train(cfg, tr, make_weights(cfg, seed, device), corpus, rows, seed)
    checks = compare.judge(compare.train_gaps(prog, ref), tr["limits"])

    h = cfg["encode_size"]
    counters = {
        "setup_s": setup_s, "window_s": window_s, "steps": steps, "contexts": contexts,
        "enqueue_s": enqueue_s, "enqueue_steps": enqueue_steps, "traced_steps": traced_steps,
        "step_flops": costs.train_step_flops(batch, bag, **costs.dims_of(cfg)),
        "k1_bytes": costs.pool_bytes(batch, bag, h),
        "k1b_bytes": costs.pool_bwd_bytes(batch, bag, h),
    }
    return Run(correct=compare.passed(checks) and failed == 0, attempted=steps, failed=failed,
               checks=checks, counters=counters, trace=summary, memory_peak_bytes=memory_peak,
               config=cfg)
