"""The port's HTTP transport and SIGTERM drain, held to the JAX package's.

- The error-kind -> HTTP status table is JAX's, and every error kind the
  port's server answers with is in it.
- Over a real socket (``make_http_server`` on port 0, ``--device cpu``):
  the data and control ops answer 200; a bad body 400, a full queue 429, a
  failed reload 500; ``GET /healthz`` and ``GET /metrics``.
- After the same request stream, the port's ``/metrics`` carries JAX's
  metric names, apart from the listed ones that only one side has.
- ``python -m code2vec_tpu_torch.serve --transport stdio --device cpu`` as
  a subprocess answers every pipelined request accepted before a SIGTERM
  and exits 0.
"""

from __future__ import annotations

import json
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from code2vec_tpu.serve.protocol import CodeServer as JaxCodeServer
from code2vec_tpu_torch.obs import runtime as port_runtime
from code2vec_tpu_torch.serve.protocol import CodeServer, make_http_server
from test_torch_serve import bag, make_model_dir
from test_torch_swap import jax_params, jax_server, port_server, write_other_weights

REPO = Path(__file__).resolve().parent.parent

# metric names only one side exports after the same stream: the autotuner's
# counters, which both packages keep on their process-wide registry (JAX
# ops/autotune.py _counters); the port's server here serves that registry, as
# JAX's build_server does, but this test's JAX server runs on a private one
PORT_ONLY: set[str] = {f"c2v_autotune_{name}_total" for name in
                       ("cache_hit", "cache_miss", "timing_run", "schedule_stored")}
JAX_ONLY: set[str] = set()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("http")
    (root / "a").mkdir()
    a, _, params_a = make_model_dir(root / "a")
    out = {"A": a, "params": {"A": params_a}}
    for name, seed, nan in (("B", 11, False), ("NaN", 11, True)):
        out[name] = root / name.lower()
        out["params"][name] = write_other_weights(a, out[name], seed, nan)
    return out


def test_status_table_is_jax_table():
    assert CodeServer.HTTP_STATUS == JaxCodeServer.HTTP_STATUS


@pytest.mark.parametrize("exc,kind", [
    (ValueError("x"), "bad_request"), (KeyError("x"), "bad_request"),
    (TypeError("x"), "bad_request"), (RuntimeError("x"), "internal"),
])
def test_error_kinds_are_jax_kinds(exc, kind):
    got = CodeServer._error_payload(exc)["error_kind"]
    assert got == JaxCodeServer._error_payload(exc)["error_kind"] == kind
    assert got in CodeServer.HTTP_STATUS


def test_overloaded_and_closed_kinds_are_in_the_table():
    from code2vec_tpu_torch.serve.batcher import ServeOverloaded, ServerClosed

    for exc, kind in ((ServeOverloaded("x"), "overloaded"), (ServerClosed("x"), "closed")):
        assert CodeServer._error_payload(exc)["error_kind"] == kind
        assert kind in CodeServer.HTTP_STATUS


class Http:
    def __init__(self, server):
        self.httpd = make_http_server(server, "127.0.0.1", 0)
        self.base = "http://127.0.0.1:%d" % self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05}, daemon=True)
        self.thread.start()

    def call(self, path, body=None, raw=None):
        data = raw if raw is not None else (json.dumps(body).encode() if body is not None
                                            else None)
        req = urllib.request.Request(self.base + path, data=data,
                                     method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@pytest.fixture
def fresh_registry(monkeypatch):
    """The port's process-wide registry, fresh for one test."""
    monkeypatch.setattr(port_runtime, "_global_health", port_runtime.RuntimeHealth())


def test_http_statuses(dirs, fresh_registry):
    server, _, targets = port_server(dirs)
    http = Http(server)
    try:
        contexts = bag(9, 1).tolist()
        for body in ({"op": "predict", "contexts": contexts}, {"op": "embed", "contexts": contexts},
                     {"op": "health"}, {"op": "swap_status"}, {"op": "flights"}):
            code, payload = http.call("/", body)
            assert code == 200 and json.loads(payload)["ok"], payload
        code, payload = http.call("/v1/embed", {"contexts": contexts})
        assert code == 200 and json.loads(payload)["methods"]
        assert http.call("/", raw=b"{not json")[0] == 400
        assert http.call("/", {"op": "predict"})[0] == 400
        assert http.call("/", {"op": "rollback"})[0] == 400
        assert http.call("/", {"op": "nope"})[0] == 400
        code, payload = http.call("/", {"op": "reload", "model_path": targets["NaN"],
                                        "wait": True})
        assert code == 500 and json.loads(payload)["error_kind"] == "swap_failed"
        code, payload = http.call("/", {"op": "reload", "model_path": targets["B"],
                                        "wait": True})
        assert code == 200 and json.loads(payload)["swap"]["last_swap"]["outcome"] == "committed"
        code, payload = http.call("/healthz")
        assert code == 200 and json.loads(payload)["version"].startswith(targets["B"])
        code, text = http.call("/metrics")
        assert code == 200 and b"c2v_serve_op_reload_requests_total 2" in text
        assert http.call("/nowhere")[0] == 404
    finally:
        http.close()
        server.close()


def test_http_overloaded_is_429_and_accepted_requests_answer(dirs, fresh_registry):
    """The engine held: one group waits in the batcher, the queue (2)
    fills, the rest are shed with 429; once let go every accepted request
    answers 200."""
    a = dirs["A"]
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    server = build_server(build_parser().parse_args([
        "--model_path", str(a), "--terminal_idx_path", str(a / "terminal_idxs.txt"),
        "--path_idx_path", str(a / "path_idxs.txt"), "--device", "cpu",
        "--batch_sizes", "1", "--max_pending", "2"]))
    http = Http(server)
    lock = server.engine._lock
    lock.acquire()
    held = True
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(http.call, "/", {"op": "embed", "contexts": bag(3, i).tolist()})
                    for i in range(8)]
            deadline = time.time() + 30
            while sum(f.done() for f in futs) < 5 and time.time() < deadline:
                time.sleep(0.05)
            lock.release()
            held = False
            codes = sorted(f.result()[0] for f in futs)
    finally:
        if held:
            lock.release()
        http.close()
        server.close()
    assert codes.count(429) >= 5 and set(codes) == {200, 429}, codes


def metric_names(text: bytes) -> set[str]:
    names = set()
    for line in text.decode().splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
    return names


def stream(server):
    """The same request stream for both servers (contexts forms only: the
    JAX server here has no extractor)."""
    for i, n in enumerate((1, 5, 9, 16, 3, 12)):
        server.handle({"op": "embed", "contexts": bag(n, 40 + i).tolist()})
    server.handle({"op": "predict", "contexts": [[1, 1, 1], [99, 1, 1]]})  # bad_request
    for op in ("health", "swap_status", "flights", "nope"):
        server.handle({"op": op})


def test_metrics_names_equal_jax(dirs, fresh_registry):
    texts = {}
    for name, make in (("jax", jax_server), ("port", port_server)):
        server, _, targets = make(dirs)
        try:
            stream(server)
            server.handle({"op": "reload", "model_path": targets["B"], "wait": True})
            server.handle({"op": "rollback"})
            texts[name] = server.metrics_text().encode()
        finally:
            server.close()
    port, jax_ = metric_names(texts["port"]), metric_names(texts["jax"])
    assert port - jax_ == PORT_ONLY, sorted(port - jax_)
    assert jax_ - port == JAX_ONLY, sorted(jax_ - port)
    build = re.search(rb"c2v_build_info\{([^}]*)\}", texts["port"]).group(1).decode()
    assert "torch_version=" in build and "jax_version" not in build


def test_sigterm_drains_every_accepted_request(dirs):
    a = dirs["A"]
    cmd = [sys.executable, "-m", "code2vec_tpu_torch.serve", "--transport", "stdio",
           "--model_path", str(a), "--terminal_idx_path", str(a / "terminal_idxs.txt"),
           "--path_idx_path", str(a / "path_idxs.txt"), "--device", "cpu",
           "--batch_sizes", "1,8"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        proc.stdin.write(json.dumps({"id": "ready", "op": "health"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["id"] == "ready"
        n = 48
        for i in range(n):
            proc.stdin.write(json.dumps({"id": i, "op": "embed",
                                         "contexts": bag(1 + i % 16, i).tolist()}) + "\n")
        proc.stdin.flush()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    answers = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert proc.returncode == 0, err[-2000:]
    assert [a["id"] for a in answers] == list(range(n))
    assert all(a["ok"] for a in answers)


def test_jax_params_helper_is_seeded():
    assert (jax_params(3)["attention"] == jax_params(3)["attention"]).all()
