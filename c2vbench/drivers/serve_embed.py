"""Bulk embedding through the server, in process: a closed loop of clients,
each sending its next ``embed`` request (the protocol's contexts form)
when the last is answered.

Set-up writes a model dir of the configuration's widths from the seed's
weights (vocab files with placeholder names), builds the server as its
command line does (``serve.__main__.build_server``: the model loaded, every
(batch, width) of the ladder warmed, the extractor loaded), starts the
clients and lets them run ``warmup_seconds``. The window is the next
``seconds``: a request answered inside it counts, with its real contexts
and its submit-to-answer time. The clients then finish the request each has
in flight and stop, and the server closes.

Each device call of the engine (``ServingEngine.run``) is wrapped so that
the benchmark counts its ``[B, W]`` shape, its real contexts and its all-PAD
rows, and, in a traced run, marks it ``engine.b<B>.w<W>`` on the host's
clock: the kernels that run inside it are K3 (materialize) at widths up to
the training bag and K4 (online) above it, one kernel on the card for both.

``correct``: a sample of the answered requests drawn from the seed, the
pool's longest bags among them, is compared with the plain reference's
code vectors of the same bags (``compare.cv_gap``).
"""

from __future__ import annotations

import json
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from c2vbench import compare
from c2vbench.harness import Run, peak_bytes, sync
from c2vbench.reference import code_vectors
from c2vbench.requests import draw_bags, embed_request
from c2vbench.seeds import numpy_rng
from c2vbench.trace import Profiler
from c2vbench.weights import make_weights


def write_model_dir(path: Path, config: dict, traffic: dict, weights: dict) -> None:
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.formats.vocab_io import write_vocab

    sizes = {k: config[k] for k in ("terminal_count", "path_count", "label_count",
                                     "terminal_embed_size", "path_embed_size", "encode_size")}
    interop.save_state_dict(weights, str(path))
    meta = dict(sizes, angular_margin_loss=False, angular_margin=0.5, inverse_temp=30.0,
                vocab_pad_multiple=1, max_path_length=config["max_path_length"],
                infer_method_name=True, infer_variable_name=False, table_dtype="f32",
                bucket_ladder=list(traffic["ladder"]))
    (path / "model_meta.json").write_text(json.dumps(meta))
    write_vocab(path / "label_vocab.txt", ((i, f"label{i}") for i in range(sizes["label_count"])))
    # "@question" takes terminal index 1, so the file holds count - 1 names
    write_vocab(path / "terminal_idxs.txt", ((i, f"t{i}" if i else "<PAD/>")
                                             for i in range(sizes["terminal_count"] - 1)))
    write_vocab(path / "path_idxs.txt", ((i, f"p{i}" if i else "<PAD/>")
                                         for i in range(sizes["path_count"])))


def server_args(model_dir: Path, traffic: dict, device):
    from code2vec_tpu_torch.serve.__main__ import build_parser

    return build_parser().parse_args([
        "--model_path", str(model_dir),
        "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
        "--path_idx_path", str(model_dir / "path_idxs.txt"),
        "--pallas_impl", traffic["pallas_impl"],
        "--batch_sizes", ",".join(map(str, traffic["batch_sizes"])),
        "--longbag_widths", ",".join(map(str, traffic["longbag_widths"])),
        "--deadline_ms", str(traffic["deadline_ms"]),
        "--autotune_cache", str(model_dir / "autotune_schedules.json"),
        "--device", str(device),
    ])


class EngineCalls:
    """``ServingEngine.run`` wrapped: each call's shape and contexts, and a
    mark of it in ``profiler`` while one is set."""

    def __init__(self, engine):
        self.run = engine.run
        self.calls: list = []  # (batch, width, real contexts, all-PAD rows, traced)
        self.profiler = None
        self.counting = False
        engine.run = self

    def __call__(self, starts, paths, ends):
        b, w = starts.shape
        prof = self.profiler
        t0 = time.time_ns()
        out = self.run(starts, paths, ends)
        traced = prof is not None
        if traced:
            prof.mark(f"engine.b{b}.w{w}", t0, time.time_ns())
        if self.counting:
            real = starts > 0
            self.calls.append((b, w, int(real.sum()), int((~real.any(axis=1)).sum()), traced))
        return out


class Clients:
    """``n`` closed-loop clients over the request pool: client ``i`` sends
    pool entries ``i, i + n, i + 2n, ...``. Each answer is kept as
    ``(pool index, submitted, answered, ok, n_contexts, coalesced, vector)``."""

    def __init__(self, server, requests: list, n: int):
        self.server, self.requests, self.n = server, requests, n
        self.stop = threading.Event()
        self.answers = [[] for _ in range(n)]
        self.threads = [threading.Thread(target=self._loop, args=(i,), daemon=True)
                        for i in range(n)]

    def _loop(self, i: int) -> None:
        k, pool, out = i, len(self.requests), self.answers[i]
        while not self.stop.is_set():
            j = k % pool
            k += self.n
            t = time.perf_counter()
            resp = self.server.handle(self.requests[j])
            done = time.perf_counter()
            ok = bool(resp.get("ok"))
            entry = resp["methods"][0] if ok else {}
            vector = entry.get("code_vector")
            out.append((j, t, done, ok and vector is not None, entry.get("n_contexts", 0),
                        entry.get("timing", {}).get("coalesced", 0),
                        None if vector is None else np.asarray(vector, np.float32)))

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self, timeout: float) -> None:
        self.stop.set()
        deadline = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(deadline - time.perf_counter(), 0.0))
        alive = sum(t.is_alive() for t in self.threads)
        if alive:
            raise RuntimeError(f"{alive} clients still waiting {timeout} s after the window")


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    import torch

    from code2vec_tpu_torch.serve.__main__ import build_server

    cfg, tr = cell.config, cell.traffic
    bags = draw_bags(cfg, tr, seed)
    requests = [embed_request(b) for b in bags]
    tmp = Path(tempfile.mkdtemp(prefix="c2vbench-model-"))
    try:
        write_model_dir(tmp, cfg, tr, make_weights(cfg, seed, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        server = build_server(server_args(tmp, tr, device))
        try:
            calls = EngineCalls(server.engine)
            clients = Clients(server, requests, tr["clients"])
            clients.start()
            time.sleep(tr["warmup_seconds"])
            calls.counting = True
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            t1 = t0 + seconds
            prof = None
            if trace:
                time.sleep(max(seconds - tr["trace_seconds"], 0.0))
                prof = Profiler(idle_label="between engine calls")
                prof.start()
                calls.profiler = prof
            time.sleep(max(t1 - time.perf_counter(), 0.0))
            t1 = time.perf_counter()
            calls.profiler = None
            summary = prof.stop() if prof is not None else None
            calls.counting = False
            clients.join(tr["join_seconds"])
            sync(device)
            memory_peak = peak_bytes(device)
        finally:
            server.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    answered = [a for per in clients.answers for a in per if t0 <= a[2] <= t1]
    ok = [a for a in answered if a[3]]
    failed = len(answered) - len(ok)
    latencies_ms = [1e3 * (a[2] - a[1]) for a in ok]
    served = sum(a[4] for a in ok)
    del server, clients
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the sample compared: drawn from the seed, with every answer to the
    # pool's longest bag in it
    rng = numpy_rng(seed, "check")
    n_check = min(tr["check_requests"], len(ok))
    picked = set(rng.choice(len(ok), n_check, replace=False).tolist()) if n_check else set()
    longest = max(range(len(bags)), key=lambda j: len(bags[j]))
    picked |= {i for i, a in enumerate(ok) if a[0] == longest}
    sample = [ok[i] for i in sorted(picked)]
    distinct = sorted({a[0] for a in sample})
    want = dict(zip(distinct, code_vectors(make_weights(cfg, seed, device),
                                           [bags[j] for j in distinct], device)))
    gap = compare.cv_gap([a[6] for a in sample], [want[a[0]] for a in sample]) \
        if sample else float("inf")
    checks = compare.judge({"cv_gap": gap}, tr["limits"])

    counters = {
        "setup_s": setup_s, "window_s": t1 - t0, "served_contexts": served,
        "answered": len(ok), "latencies_ms": latencies_ms,
        "coalesced": [a[5] for a in ok], "calls": calls.calls,
        "compared": len(sample), "longbag_width": cfg["max_path_length"],
    }
    return Run(correct=compare.passed(checks) and failed == 0 and bool(ok),
               attempted=len(answered), failed=failed, checks=checks, counters=counters,
               trace=summary, memory_peak_bytes=memory_peak, config=cfg)
