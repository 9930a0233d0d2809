"""Transport-thin request handling: dict in, dict out.

Counterpart of ``code2vec_tpu/serve/protocol.py``, for the ops this slice
serves::

    {"op": "predict", "contexts": [[start, path, end], ...], "top_k": 5,
     "method_name": "*", "include_vector": false}
    {"op": "predict", "source": "class A { int f(int x) { ... } }", "language": "java"}
    {"op": "predict", "source": "def f(x):\\n    return x + 1\\n", "language": "python"}
    {"op": "embed",   "contexts": [[start, path, end], ...]}   (or "source")
    {"op": "embed_file", "source": "...", "language": "python"}   (or "contexts")
    {"op": "neighbors", "vector": [...], "top_k": 5}
    {"op": "neighbors", "contexts": [[start, path, end], ...], "top_k": 5}   (or "source")
    {"op": "neighbors", "source": "...", "granularity": "file", "top_k": 5}
    {"op": "health"}
    {"op": "shutdown"}

Responses echo an optional ``"id"`` and carry ``"error"`` +
``"error_kind"`` instead of results on failure. A ``source`` request (Java
or Python) is extracted and mapped into the training vocab on the request
thread, so the batcher only sees id arrays: one entry per matching method,
a method whose every context is OOV getting an entry with an ``error`` and
no device work, and the payload's ``extract_ms`` (extraction and mapping,
host work) apart from each entry's device timing. ``embed_file`` embeds
every method of the source through the batcher and pools the method
vectors on the host with the checkpoint's attention vector
(``models/hierarchical.pool_vectors``) into one ``file_vector``; a source
where no method embeds is a ``bad_request``. ``reload``, ``rollback``,
``swap_status`` and ``flights`` get a ``not_implemented`` error.
``neighbors`` answers from the server's retrieval backend
(``serve/retrieval.py``: exact or IVF-PQ): the ``vector`` form directly,
the ``contexts`` and ``source`` forms after embedding through the batcher;
at ``granularity="file"`` they are pooled as ``embed_file`` pools them and
searched against an index of file vectors (``export.export_file_vectors``).
Context triples are bounds-checked against the vocab tables BEFORE they
reach a kernel: an out-of-range id is the client's mistake, never a device
gather.

:func:`serve_stdio` is the JSONL transport: responses in request order,
and because requests are submitted as they are read while responses are
resolved in order, a pipelined client gets real micro-batch coalescing.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Callable

import numpy as np

from code2vec_tpu_torch.predict import softmax_top_k, subsample
from code2vec_tpu_torch.serve.batcher import ServeOverloaded, ServerClosed

logger = logging.getLogger(__name__)

NOT_PORTED_OPS = ("reload", "rollback", "swap_status", "flights")


def validate_context_rows(rows, n_terminals: int, n_paths: int) -> list[tuple[int, int, int]]:
    """A pre-mapped ``"contexts"`` field: a non-empty list of integer
    ``[start, path, end]`` triples within the vocab tables."""
    if not isinstance(rows, (list, tuple)) or not rows:
        raise ValueError("'contexts' must be a non-empty list of [start, path, end] id triples")
    mapped = []
    for row in rows:
        if not isinstance(row, (list, tuple)) or len(row) != 3:
            raise ValueError(f"each context must be a [start, path, end] triple, got {row!r}")
        try:
            s, p, e = (int(v) for v in row)
        except (TypeError, ValueError):
            raise ValueError(f"context triple {row!r} is not integer-valued") from None
        if not (0 <= s < n_terminals and 0 <= p < n_paths and 0 <= e < n_terminals):
            raise ValueError(
                f"context triple {row!r} is outside the vocab tables "
                f"({n_terminals} terminals, {n_paths} paths)"
            )
        mapped.append((s, p, e))
    return mapped


class CodeServer:
    """The serving facade over one predictor, engine and micro-batcher."""

    def __init__(self, predictor, engine, batcher, *, retrieval=None,
                 version: str = "v0", extractor_ms: float | None = None) -> None:
        self.predictor = predictor
        self.engine = engine
        self.batcher = batcher
        self.retrieval = retrieval  # the neighbors backend, or None
        self.version = version
        self.extractor_ms = extractor_ms  # the warmup's build and load of the extractor
        self._file_attention = None  # the file pool's direction, [H] f32 on the host
        self._shutdown = threading.Event()

    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown.is_set()

    def close(self) -> None:
        """Drain in-flight requests and stop the batcher."""
        self.batcher.close()

    def handle(self, request: dict) -> dict:
        """Submit and wait; resolve-time failures become error payloads."""
        resolver = self.handle_async(request)
        try:
            return resolver()
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            return self._error_payload(exc)

    def handle_async(self, request: dict) -> Callable[[], dict]:
        """Submit any device work NOW; return a resolver that blocks for
        the results and builds the response."""
        req_id = request.get("id")
        op = request.get("op")
        try:
            if op == "health":
                resolver = self._health_payload
            elif op == "shutdown":
                self._shutdown.set()
                resolver = lambda: {"ok": True, "shutting_down": True}  # noqa: E731
            elif op in ("predict", "embed"):
                resolver = self._submit_methods(request, op)
            elif op == "embed_file":
                resolver = self._submit_file(request)
            elif op == "neighbors":
                resolver = self._submit_neighbors(request)
            elif op in NOT_PORTED_OPS:
                raise NotImplementedError(f"op {op!r} is not ported yet")
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            payload = self._error_payload(exc)
            resolver = lambda: payload  # noqa: E731

        def finish() -> dict:
            payload = resolver()
            return {"id": req_id, **payload} if req_id is not None else payload

        return finish

    @staticmethod
    def _error_payload(exc: BaseException) -> dict:
        if isinstance(exc, ServeOverloaded):
            kind = "overloaded"
        elif isinstance(exc, ServerClosed):
            kind = "closed"
        elif isinstance(exc, NotImplementedError):
            kind = "not_implemented"
        elif isinstance(exc, (ValueError, KeyError, TypeError)):
            kind = "bad_request"
        else:
            kind = "internal"
            logger.exception("request failed")
        return {"error": f"{type(exc).__name__}: {exc}", "error_kind": kind}

    def _health_payload(self) -> dict:
        from code2vec_tpu_torch.ops.backend import launch_counts

        engine, config = self.engine, self.predictor.config
        return {
            "ok": True,
            "version": self.version,
            "device": str(engine.device),
            "ladder": list(engine.ladder),
            "base_width": engine.base_width,
            "max_width": engine.max_width,
            "batch_sizes": list(engine.batch_sizes),
            "executables": engine.executables(),
            "post_warmup_compiles": engine.post_warmup_compiles,
            "extractor_ms": self.extractor_ms,
            "table_dtype": engine.table_dtype,
            "kernel_route": config.pallas_impl if config.use_pallas else "plain",
            "kernel_launches": launch_counts(),
            "retrieval": self.retrieval.describe() if self.retrieval is not None else None,
        }

    def _submit_methods(self, request: dict, op: str) -> Callable[[], dict]:
        predictor, engine = self.predictor, self.engine
        source = request.get("source")
        contexts_field = request.get("contexts")
        if contexts_field is None and (not isinstance(source, str) or not source.strip()):
            raise ValueError(f"{op!r} needs a non-empty 'source' string or a 'contexts' list "
                             "of [start, path, end] id triples")
        if op == "predict" and not predictor.meta.get("infer_method_name", True):
            raise ValueError(
                "this checkpoint was trained for the variable-name task only; "
                "'predict' is unavailable (embed and neighbors still work)"
            )
        method_name = request.get("method_name", "*")
        top_k = int(request.get("top_k", 5))
        include_vector = bool(request.get("include_vector", op == "embed"))
        # (label, n_oov, future or None, n_contexts): over-long bags take the
        # offline Predictor's seeded subsample
        submitted = []
        extract_ms = None
        if contexts_field is not None:
            mapped = validate_context_rows(
                contexts_field, int(predictor.meta["terminal_count"]),
                int(predictor.meta["path_count"]),
            )
            mapped = subsample(mapped, engine.max_width)
            label = (method_name if isinstance(method_name, str) and method_name != "*"
                     else "<contexts>")
            submitted.append((label, 0, self.batcher.submit(
                np.asarray(mapped, np.int32).reshape(-1, 3)), len(mapped)))
        else:
            language = request.get("language", "java")
            t0 = time.perf_counter()
            methods = []
            for label, contexts, _ in predictor._extract(source, method_name, language):
                mapped, n_oov = predictor._map_contexts(contexts)
                methods.append((label, subsample(mapped, engine.max_width), n_oov))
            extract_ms = (time.perf_counter() - t0) * 1e3
            for label, mapped, n_oov in methods:
                future = (self.batcher.submit(np.asarray(mapped, np.int32).reshape(-1, 3))
                          if mapped else None)
                submitted.append((label, n_oov, future, len(mapped)))
        label_vocab = predictor.label_vocab

        def resolve() -> dict:
            entries = []
            for label, n_oov, future, n_contexts in submitted:
                entry: dict = {"method_name": label, "n_contexts": n_contexts, "n_oov": n_oov}
                entries.append(entry)
                if future is None:
                    entry["error"] = "every context is OOV against the training vocab"
                    continue
                result = future.result()
                if op == "predict":
                    entry["predictions"] = [
                        {"name": label_vocab.itos[i], "prob": prob}
                        for i, prob in softmax_top_k(result.logits, len(label_vocab), top_k)
                    ]
                if include_vector:
                    entry["code_vector"] = [float(v) for v in result.code_vector]
                entry["timing"] = {
                    "queue_wait_ms": result.queue_wait_ms,
                    "device_ms": result.device_ms,
                    "coalesced": result.coalesced,
                    "batch": result.batch,
                    "width": result.width,
                }
            payload = {"ok": True, "methods": entries}
            if extract_ms is not None:
                payload["extract_ms"] = extract_ms
            return payload

        return resolve

    def _submit_file(self, request: dict) -> Callable[[], dict]:
        """``embed_file``: every method of the request embedded through the
        batcher (as ``embed``), then the method vectors pooled on the host
        with the checkpoint's attention vector into one file vector."""
        embed_resolver = self._submit_methods({**request, "include_vector": True}, "embed")
        if self._file_attention is None:  # read off the card once, not a sync a request
            self._file_attention = self.predictor.attention_vector()
        attn = self._file_attention

        def resolve() -> dict:
            from code2vec_tpu_torch.models.hierarchical import pool_vectors

            embedded = embed_resolver()
            names, vectors = [], []
            for entry in embedded["methods"]:
                if entry.get("code_vector") is not None:
                    names.append(entry["method_name"])
                    vectors.append(entry["code_vector"])
            if not vectors:
                return {"error": "no method in the source produced an embedding (nothing "
                                 "extracted, or every context is OOV against the training vocab)",
                        "error_kind": "bad_request"}
            file_vector = pool_vectors(np.asarray(vectors, np.float32), attn)
            payload = {"ok": True, "file_vector": [float(v) for v in file_vector],
                       "n_methods": len(vectors), "method_names": names}
            if "extract_ms" in embedded:
                payload["extract_ms"] = embedded["extract_ms"]
            return payload

        return resolve

    def _submit_neighbors(self, request: dict) -> Callable[[], dict]:
        retrieval = self.retrieval
        if retrieval is None:
            raise ValueError(
                "no retrieval index loaded: start the server with --code_vec_path "
                "(exact) or --retrieval_backend ann --ann_index_path"
            )
        top_k = int(request.get("top_k", 5))
        granularity = request.get("granularity", "method")
        if granularity not in ("method", "file"):
            raise ValueError(f"granularity must be 'method' or 'file', got {granularity!r}")

        def ranked(vec: np.ndarray) -> list[dict]:
            return [{"name": n, "similarity": s} for n, s in retrieval.top_k(vec, top_k)]

        vector = request.get("vector")
        if vector is not None:
            vec = np.asarray(vector, np.float32)
            if vec.shape != (retrieval.dim,):
                raise ValueError(f"'vector' must have dim {retrieval.dim}, got {vec.shape}")
            payload = {"ok": True, "neighbors": ranked(vec)}
            return lambda: payload
        # the client's include_vector decides whether the vector stays in
        want_vector = bool(request.get("include_vector", False))
        if granularity == "file":
            # pool the method vectors into one file vector, then retrieve
            file_resolver = self._submit_file(request)

            def resolve_file() -> dict:
                pooled = file_resolver()
                if "error" in pooled:
                    return pooled
                out = {"ok": True, "n_methods": pooled["n_methods"],
                       "neighbors": ranked(np.asarray(pooled["file_vector"], np.float32))}
                if want_vector:
                    out["file_vector"] = pooled["file_vector"]
                if "extract_ms" in pooled:
                    out["extract_ms"] = pooled["extract_ms"]
                return out

            return resolve_file
        # contexts and source forms: embed through the batcher, then retrieve
        embed_resolver = self._submit_methods({**request, "include_vector": True}, "embed")

        def resolve() -> dict:
            embedded = embed_resolver()
            for entry in embedded["methods"]:
                cv = entry.get("code_vector")
                if cv is not None:
                    entry["neighbors"] = ranked(np.asarray(cv, np.float32))
                if not want_vector:
                    entry.pop("code_vector", None)
            return embedded

        return resolve


def serve_stdio(server: CodeServer, in_stream, out_stream, stop_event=None) -> None:
    """JSONL over a line-iterable / writable stream pair. Responses keep
    request order; with ``stop_event`` set the loop stops waiting for new
    requests but still answers every one already accepted."""
    pending: queue.Queue = queue.Queue()
    eof = object()

    def reader() -> None:
        try:
            for line in in_stream:
                line = line.strip()
                if not line:
                    continue
                try:
                    request = json.loads(line)
                    if not isinstance(request, dict):
                        raise ValueError("request must be a JSON object")
                except ValueError as exc:
                    payload = {"error": f"bad request line: {exc}", "error_kind": "bad_request"}
                    pending.put(lambda payload=payload: payload)
                    continue
                pending.put(server.handle_async(request))
                if server.shutdown_requested:
                    break
        finally:
            pending.put(eof)

    thread = threading.Thread(target=reader, name="c2v-torch-stdin", daemon=True)
    thread.start()
    try:
        while True:
            try:
                resolver = pending.get(timeout=0.1)
            except queue.Empty:
                if stop_event is not None and stop_event.is_set() and pending.empty():
                    break
                continue
            if resolver is eof:
                break
            try:
                response = resolver()
            except Exception as exc:  # noqa: BLE001 - keep serving
                response = CodeServer._error_payload(exc)
            out_stream.write(json.dumps(response) + "\n")
            out_stream.flush()
    finally:
        server.close()
        thread.join(timeout=5.0)
