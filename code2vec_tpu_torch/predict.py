"""Inference from a trained model dir: load once, predict per bag of contexts.

Counterpart of ``code2vec_tpu/predict.py``. A model dir holds
``model_meta.json`` (dims, flags, the bag-width ladder), ``label_vocab.txt``
and the weights as a reference-layout ``code2vec.model`` (a dir that holds
only a checkpoint gets one from ``python -m
code2vec_tpu_torch.tools.export_reference_checkpoint``, and a reference
run's ``code2vec.model`` becomes a model dir through
``code2vec_tpu_torch.tools.import_reference_checkpoint``). The
:class:`Predictor` reads them, quantizes the tables once at load
(``table_dtype``), and pads every forward to the nearest ladder width.
A ladder with rungs above the training bag (recorded by a run that fed
unbounded bags, or given as ``longbag_widths``) serves long bags: the
Predictor's bag rises to the top rung and the model streams the softmax
(K4) at every width above the training bag.

A training run writes such a dir itself: :func:`save_inference_meta` at
its start, :func:`save_model_file` on every new best F1.

From Java or Python source (JAX ``predict.py:306-693``):
``predict_source`` names each method, ``predict_variables`` each
``@var_*`` variable of each method (``target_variable``), through the
port's extractors (``extractor.py`` for Java, ``pyextract.py`` for Python)
with the corpus's ``params.txt`` caps, the names mapped into the training
vocab (a context with an unseen name is dropped and counted as OOV) and
the trainer's framing (the method's or the variable's alias becomes
``@question``). ``embed_file`` gives one vector for a whole source file:
its methods' code vectors pooled with the checkpoint's attention vector
(``models/hierarchical.py``). Extraction and the file pool are host work;
only the forward runs on the device::

    python -m code2vec_tpu_torch.predict File.java|file.py --model_path out \
        --terminal_idx_path ds/terminal_idxs.txt --path_idx_path ds/path_idxs.txt \
        [--task auto|method|variable] [--top_k 5] [--show_attention N] \
        [--neighbors N [--code_vec_path out/code.vec]] [--no_cuda]
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_INDEX, QUESTION_TOKEN_NAME
from code2vec_tpu_torch.ops.autotune import pin_cache

logger = logging.getLogger(__name__)

MODEL_META = "model_meta.json"
LABEL_VOCAB = "label_vocab.txt"


def save_inference_meta(out_dir: str, config, model_config, data, bucket_ladder=None) -> None:
    """``model_meta.json`` and ``label_vocab.txt`` of a training run, the
    JAX ``save_inference_meta``'s keys (``code2vec_tpu/predict.py:38-82``):
    model dims and flags, the bag and the run's bag-width ladder, so a
    server needs no corpus to pick its shapes."""
    from code2vec_tpu_torch.formats.vocab_io import write_vocab

    meta = {
        "adam_mu_dtype": config.adam_mu_dtype,
        "table_update": config.table_update,
        "terminal_count": model_config.terminal_count,
        "path_count": model_config.path_count,
        "label_count": model_config.label_count,
        "terminal_embed_size": model_config.terminal_embed_size,
        "path_embed_size": model_config.path_embed_size,
        "encode_size": model_config.encode_size,
        "angular_margin_loss": model_config.angular_margin_loss,
        "angular_margin": model_config.angular_margin,
        "inverse_temp": model_config.inverse_temp,
        "vocab_pad_multiple": model_config.vocab_pad_multiple,
        "max_path_length": config.max_path_length,
        "infer_method_name": config.infer_method_name,
        "infer_variable_name": config.infer_variable_name,
        "table_dtype": config.table_dtype,
        "bucket_ladder": [int(w) for w in bucket_ladder] if bucket_ladder else None,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, MODEL_META), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    write_vocab(os.path.join(out_dir, LABEL_VOCAB), sorted(data.label_vocab.itos.items()))


def save_model_file(out_dir: str, model) -> str:
    """The weights as a reference-layout ``code2vec.model`` (vocab pad
    rows sliced off), the file the :class:`Predictor` loads."""
    from code2vec_tpu_torch import interop

    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return interop.save_state_dict(model.state_dict(), out_dir, model.config)
    from code2vec_tpu_torch.parallel.shardings import unshard_state

    # a mesh's shards gathered (every rank calls this), rank 0 writes
    sd = unshard_state(mesh, model, None)[0]
    if mesh.rank == 0:
        return interop.save_state_dict(sd, out_dir, model.config)
    return os.path.join(out_dir, interop.MODEL_FILE)


def softmax_top_k(logits: np.ndarray, n_labels: int, top_k: int) -> list[tuple[int, float]]:
    """Top-k ``(label index, probability)`` from one logits row: a float64
    softmax over the REAL label rows (the head may be vocab-padded)."""
    logits = np.asarray(logits, np.float64)[:n_labels]
    z = np.exp(logits - logits.max())
    probs = z / z.sum()
    order = np.argsort(-probs)[:top_k]
    return [(int(i), float(probs[i])) for i in order]


@dataclass
class Prediction:
    name: str
    prob: float


@dataclass
class MethodPrediction:
    predictions: list[Prediction]  # top-k, most probable first
    n_contexts: int  # contexts fed to the model (after the OOV drop and any subsample)
    # (start, path, end, weight), heaviest first: ids, or names for a source prediction
    attention: list[tuple]
    code_vector: np.ndarray  # [encode_size]
    method_name: str = "<contexts>"  # the name found in the source
    n_oov: int = 0  # contexts dropped: a name unseen in training
    target_variable: str | None = None  # set on a variable-name prediction


def nearest_from_rows(labels: list[str], rows: np.ndarray, vector: np.ndarray, top_k: int = 5,
                      row_norms: np.ndarray | None = None) -> list[tuple[str, float]]:
    """The cosine-nearest rows of a ``code.vec`` matrix to ``vector``; pass
    ``row_norms`` when querying many vectors."""
    if row_norms is None:
        row_norms = np.linalg.norm(rows, axis=1)
    norms = row_norms * max(np.linalg.norm(vector), 1e-12)
    sims = rows @ vector / np.maximum(norms, 1e-12)
    order = np.argsort(-sims)[:top_k]
    return [(labels[int(i)], float(sims[i])) for i in order]


def nearest_neighbors(code_vec_path: str, vector: np.ndarray,
                      top_k: int = 5) -> list[tuple[str, float]]:
    """The cosine-nearest rows of an exported ``code.vec`` to ``vector``;
    for many queries read the file once and call :func:`nearest_from_rows`."""
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

    labels, rows = read_code_vectors(code_vec_path)
    return nearest_from_rows(labels, rows, vector, top_k)


def subsample(contexts: list, bag: int, rng: np.random.Generator | None = None) -> list:
    """Over-long bags: a seeded random subsample of ``bag`` contexts, kept
    in order (the trainer's truncation rule, dataset_builder.py:134-135)."""
    if len(contexts) <= bag:
        return contexts
    r = rng if rng is not None else np.random.default_rng(0)
    keep = r.choice(len(contexts), bag, replace=False)
    return [contexts[i] for i in sorted(keep)]


class Predictor:
    """Loads a model dir once; predicts per bag of (start, path, end) ids.

    ``device``: ``None`` runs on ``cuda`` and raises when no GPU is
    visible; ``"cpu"`` runs the plain versions. ``pallas_impl`` picks the
    forward's kernel route (serving default: the fully fused K3); ``"auto"``
    takes each ``(batch, width)``'s route from the schedule cache, pinned
    to ``autotune_cache`` when one is given (``ops/autotune.py``).
    ``table_dtype`` overrides the meta's table storage. ``longbag_widths``
    adds rungs above the ladder's top (each must exceed it).
    """

    def __init__(
        self,
        model_path: str,
        terminal_idx_path: str,
        path_idx_path: str,
        table_dtype: str | None = None,
        *,
        device: str | torch.device | None = None,
        pallas_impl: str = "fused",
        pallas_softmax: str = "auto",
        longbag_widths: tuple[int, ...] = (),
        autotune_cache: str | None = None,
    ) -> None:
        from code2vec_tpu_torch import interop
        from code2vec_tpu_torch.data.pipeline import derive_bucket_ladder
        from code2vec_tpu_torch.formats.vocab_io import read_vocab
        from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
        from code2vec_tpu_torch.ops.backend import resolve_device

        self.device = resolve_device(device)
        pin_cache(autotune_cache)
        meta_path = os.path.join(model_path, MODEL_META)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"{meta_path} not found: not a trained model dir")
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        self.meta = meta
        self.terminal_vocab = read_vocab(terminal_idx_path, extra_tokens=[QUESTION_TOKEN_NAME])
        self.path_vocab = read_vocab(path_idx_path)
        self.label_vocab = read_vocab(os.path.join(model_path, LABEL_VOCAB))

        self.bag = int(meta["max_path_length"])
        # the TRAINING bag, before any long-bag raise below: the serving
        # engine keys its base/long-bag split off this
        self.base_bag = self.bag
        recorded = meta.get("bucket_ladder")
        # a recorded ladder is the checkpoint's word; the geometric one is
        # a guess for this Predictor's own padding
        self.ladder_recorded = bool(recorded)
        self.ladder: tuple[int, ...] = (
            tuple(int(w) for w in recorded) if recorded
            else derive_bucket_ladder(np.zeros(0, np.int64), self.bag)
        )
        extra = tuple(sorted({int(w) for w in longbag_widths}))
        if extra:
            if extra[0] <= self.ladder[-1]:
                raise ValueError(
                    f"long-bag widths must all exceed the ladder top {self.ladder[-1]}, "
                    f"got {list(extra)}"
                )
            self.ladder = self.ladder + extra
        if self.ladder[-1] < self.bag:
            raise ValueError(
                f"the ladder {list(self.ladder)} must end at the training bag {self.bag}"
            )
        if self.ladder[-1] > self.bag:
            # long-bag rungs: bags up to the top rung are padded to a rung
            # instead of subsampled, and widths above the training bag
            # stream their softmax (K4)
            self.bag = int(self.ladder[-1])
        # the corpus's extraction caps (params.txt beside the vocab files):
        # new sources must be extracted as the corpus was
        self.extract_params = self._load_extract_params(
            os.path.join(os.path.dirname(os.path.abspath(path_idx_path)), "params.txt"))
        self.table_dtype = table_dtype or meta.get("table_dtype", "f32")
        self.config = Code2VecConfig(
            terminal_count=meta["terminal_count"],
            path_count=meta["path_count"],
            label_count=meta["label_count"],
            terminal_embed_size=meta["terminal_embed_size"],
            path_embed_size=meta["path_embed_size"],
            encode_size=meta["encode_size"],
            dropout_prob=0.0,
            angular_margin_loss=meta["angular_margin_loss"],
            angular_margin=meta["angular_margin"],
            inverse_temp=meta["inverse_temp"],
            vocab_pad_multiple=meta.get("vocab_pad_multiple", 1) or 1,
            table_dtype=self.table_dtype,
            use_pallas=True,
            pallas_impl=pallas_impl,
            pallas_softmax=pallas_softmax,
            longbag_width=self.base_bag if self.bag > self.base_bag else 0,
        )
        sd = interop.load_state_dict(model_path)
        interop.check_dims(sd, self.config)
        with torch.device("meta"):
            model = Code2Vec(self.config)
        model.load_state_dict(interop.pad_state_dict(sd, self.config), strict=True, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        # quantize the f32 master tables ONCE; every forward then gathers
        # through the int8/bf16 storage
        self.quant_tables = self.model.quantize_tables()
        if self.quant_tables is not None:
            logger.info("serving with %s-quantized tables", self.table_dtype)

    def forward(self, starts, paths, ends):
        """``(logits, code_vector, attention)`` for id arrays ``[B, L]``
        (numpy or tensors) on the predictor's device."""
        ids = [torch.as_tensor(np.asarray(x, np.int32)).to(self.device)
               for x in (starts, paths, ends)]
        with torch.inference_mode():
            return self.model(*ids, labels=None, quant_tables=self.quant_tables)

    def predict_contexts(
        self, contexts, top_k: int = 5, rng: np.random.Generator | None = None
    ) -> MethodPrediction:
        """Predict one method from its mapped ``(start, path, end)`` ids."""
        from code2vec_tpu_torch.data.pipeline import nearest_bucket_width

        contexts = subsample(list(contexts), self.bag, rng)
        arr = np.asarray(contexts, np.int32).reshape(-1, 3)
        n = arr.shape[0]
        width = nearest_bucket_width(max(n, 1), self.ladder)
        ids = np.full((3, 1, width), PAD_INDEX, np.int32)
        ids[:, 0, :n] = arr.T
        logits, code_vector, attn = self.forward(*ids)
        logits = logits[0].float().cpu().numpy()
        attn = attn[0].float().cpu().numpy()
        preds = [
            Prediction(self.label_vocab.itos[i], prob)
            for i, prob in softmax_top_k(logits, len(self.label_vocab), top_k)
        ]
        attention = sorted(
            ((int(s), int(p), int(e), float(a)) for (s, p, e), a in zip(arr, attn[:n])),
            key=lambda row: -row[3],
        )
        return MethodPrediction(
            predictions=preds, n_contexts=n, attention=attention,
            code_vector=code_vector[0].float().cpu().numpy(),
        )

    @staticmethod
    def _load_extract_params(params_path: str) -> dict:
        """The extractor's keyword arguments from a corpus's ``params.txt``
        (the reference's typo'd ``nomalize_`` keys, or the right spelling);
        the reference defaults, with a warning, when there is none."""
        defaults = dict(max_length=8, max_width=3, normalize_string=True, normalize_char=True,
                        normalize_int=False, normalize_double=True)
        if not os.path.exists(params_path):
            logger.warning("%s not found: extracting with the default caps; if the corpus "
                           "used other extraction params, predictions degrade", params_path)
            return defaults
        from code2vec_tpu_torch.formats.params_io import read_params

        p = read_params(params_path)

        def flag(key: str, default: bool) -> bool:
            raw = p.get("nomalize_" + key, p.get("normalize_" + key))
            return default if raw is None else raw.strip() == "true"

        return dict(max_length=int(p.get("max_length", 8)), max_width=int(p.get("max_width", 3)),
                    normalize_string=flag("string_literal", True),
                    normalize_char=flag("char_literal", True),
                    normalize_int=flag("int_literal", False),
                    normalize_double=flag("double_literal", True))

    def _map_contexts(self, contexts: list[tuple[str, str, str]],
                      question_token: str = "@method_0") -> tuple[list[tuple[int, int, int]], int]:
        """(start, path, end) names -> training vocab ids, and the count of
        contexts dropped for a name unseen in training. ``question_token``
        maps to ``@question`` (the method's own alias for the method task,
        the target variable's for the variable task); terminals are
        lowercased as the vocab writers lowercase them."""
        t_stoi, p_stoi = self.terminal_vocab.stoi, self.path_vocab.stoi

        def term_id(name: str) -> int | None:
            return QUESTION_TOKEN_INDEX if name == question_token else t_stoi.get(name.lower())

        mapped, oov = [], 0
        for s, p, e in contexts:
            ts, tp, te = term_id(s), p_stoi.get(p), term_id(e)
            if ts is None or tp is None or te is None:
                oov += 1
                continue
            mapped.append((ts, tp, te))
        return mapped, oov

    def _extract(self, source: str, method_name: str, language: str
                 ) -> list[tuple[str, list[tuple[str, str, str]], list[tuple[str, str]]]]:
        """Per matching method of ``source``: (its name, its contexts as
        name triples, its (original, alias) pairs). The Java extractor
        gives run-local ids and vocabs, the Python one name triples."""
        if language == "java":
            from code2vec_tpu_torch.extractor import extract_source

            result = extract_source(source, method_name, **self.extract_params)
            t, p = result.terminal_vocab, result.path_vocab
            return [(m.label, [(t[s], p[pa], t[e]) for s, pa, e in m.path_contexts],
                     list(m.aliases)) for m in result.methods]
        if language != "python":
            raise ValueError(f"unknown language: {language!r}")
        from code2vec_tpu_torch.pyextract import PyExtractConfig, extract_python_source

        ep = self.extract_params
        config = PyExtractConfig(
            normalize_string_literal=ep["normalize_string"],
            normalize_char_literal=ep["normalize_char"],
            normalize_int_literal=ep["normalize_int"],
            normalize_double_literal=ep["normalize_double"],
            max_length=ep["max_length"], max_width=ep["max_width"])
        return [(m.label, list(m.contexts), list(m.variables))
                for m in extract_python_source(source, method_name, config)]

    def attention_vector(self) -> np.ndarray:
        """The method-level attention vector ``[H]`` f32: the salience
        direction the file pool reuses one level up."""
        return self.model.attention_parameter.detach().float().cpu().numpy()

    def _predict_named(self, label: str, mapped, n_oov: int, top_k: int,
                       rng: np.random.Generator | None) -> MethodPrediction:
        """:meth:`predict_contexts` with the attention as names."""
        m = self.predict_contexts(mapped, top_k, rng)
        t_itos, p_itos = self.terminal_vocab.itos, self.path_vocab.itos
        m.attention = [(t_itos[s], p_itos[p], t_itos[e], a) for s, p, e, a in m.attention]
        m.method_name, m.n_oov = label, n_oov
        return m

    def predict_source(self, source: str, method_name: str = "*", language: str = "java",
                       top_k: int = 5, rng: np.random.Generator | None = None
                       ) -> list[MethodPrediction]:
        """Method-name predictions for every matching method of ``source``."""
        if not self.meta.get("infer_method_name", True):
            raise ValueError("this checkpoint was trained for the variable-name task only; "
                             "use predict_variables (CLI: --task variable)")
        out = []
        for label, contexts, _ in self._extract(source, method_name, language):
            mapped, oov = self._map_contexts(contexts)
            if not mapped:
                logger.warning("%s: every context is OOV against the training vocab; the "
                               "prediction is the label prior", label)
            out.append(self._predict_named(label, mapped, oov, top_k, rng))
        return out

    def predict_variables(self, source: str, method_name: str = "*", language: str = "java",
                          top_k: int = 5, rng: np.random.Generator | None = None
                          ) -> list[MethodPrediction]:
        """Variable-name predictions: one per ``@var_*`` alias of each
        matching method, in the extractor's order, framed as the trainer
        frames them (the contexts touching the variable, its alias as
        ``@question``; model/dataset_builder.py:152-204)."""
        if not self.meta.get("infer_variable_name", False):
            raise ValueError("this checkpoint was not trained for the variable-name task; "
                             "use predict_source (CLI: --task method)")
        out = []
        for label, contexts, aliases in self._extract(source, method_name, language):
            for original, alias in aliases:
                if not alias.startswith("@var_"):
                    continue  # @method_ / @label_ aliases are not variables
                mine = [(s, p, e) for s, p, e in contexts if s == alias or e == alias]
                mapped, oov = self._map_contexts(mine, question_token=alias)
                if not mapped:
                    logger.warning("%s.%s: every context is OOV against the training vocab; "
                                   "the prediction is the label prior", label, original)
                m = self._predict_named(f"{label}.{original}", mapped, oov, top_k, rng)
                m.target_variable = original
                out.append(m)
        return out

    def embed_file(self, source: str, language: str = "java", method_name: str = "*",
                   rng: np.random.Generator | None = None) -> tuple[np.ndarray, list[str]]:
        """One vector for a whole source file: each matching method whose
        mapped contexts are not empty is embedded, and the method vectors
        are pooled with the checkpoint's attention vector
        (``models/hierarchical.pool_vectors``). Returns ``(file vector [H]
        f32, method names)``; raises ``ValueError`` when no method embeds
        (nothing extracted, or every context OOV)."""
        from code2vec_tpu_torch.models.hierarchical import pool_vectors

        names, vectors = [], []
        for label, contexts, _ in self._extract(source, method_name, language):
            mapped, _ = self._map_contexts(contexts)
            if not mapped:
                continue
            names.append(label)
            vectors.append(self.predict_contexts(mapped, 1, rng).code_vector)
        if not vectors:
            raise ValueError("no method in the source produced an embedding (nothing extracted, "
                             "or every context is OOV against the training vocab)")
        return pool_vectors(np.stack(vectors), self.attention_vector()), names


def main(argv: list[str] | None = None) -> int:
    """``python -m code2vec_tpu_torch.predict File.java --model_path ...``:
    the top-k names of each method (or each variable) of a Java or Python
    (``.py``) file, on the card unless ``--no_cuda``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.predict",
        description="Predict method or variable names for a Java or Python file from a "
                    "trained model dir")
    parser.add_argument("source_file", help=".java or .py file")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--terminal_idx_path", required=True)
    parser.add_argument("--path_idx_path", required=True)
    parser.add_argument("--method_name", default="*", help="* = all methods")
    parser.add_argument("--no_cuda", action="store_true", default=False,
                        help="run the plain versions on the CPU (the default is the card)")
    parser.add_argument("--accelerator", action="store_true", default=False,
                        help="JAX's flag for a forward off the CPU, accepted so its command "
                             "lines run; the port runs on the card without it too, and "
                             "--no_cuda still wins")
    parser.add_argument("--task", default="auto", choices=("auto", "method", "variable"),
                        help="what to predict; auto follows the model's training task (method "
                             "wins for a dual-task model)")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--table_dtype", default=None, choices=("f32", "bf16", "int8"),
                        help="embedding storage of the forward (default: the model meta's)")
    parser.add_argument("--show_attention", type=int, default=0, metavar="N",
                        help="also print the N highest-attention path-contexts per method")
    parser.add_argument("--neighbors", type=int, default=0, metavar="N",
                        help="also print the N cosine-nearest methods of --code_vec_path")
    parser.add_argument("--code_vec_path", default=None,
                        help="exported code.vec for --neighbors (default: "
                             "<model_path>/code.vec when present)")
    args = parser.parse_args(argv)

    neighbor_index = None
    if args.neighbors:
        from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

        code_vec_path = args.code_vec_path
        if code_vec_path is None:
            code_vec_path = os.path.join(args.model_path, "code.vec")
            if not os.path.exists(code_vec_path):
                parser.error(f"--neighbors needs --code_vec_path (no {code_vec_path} found)")
        nn_labels, nn_rows = read_code_vectors(code_vec_path)
        meta_file = os.path.join(args.model_path, MODEL_META)
        if os.path.exists(meta_file):
            with open(meta_file, encoding="utf-8") as f:
                encode_size = json.load(f).get("encode_size")
            if encode_size and nn_rows.ndim == 2 and nn_rows.shape[1] != encode_size:
                parser.error(f"{code_vec_path} holds {nn_rows.shape[1]}-dim vectors but the "
                             f"model's encode_size is {encode_size}: it was exported from a "
                             "different model")
        neighbor_index = (nn_labels, nn_rows, np.linalg.norm(nn_rows, axis=1))

    predictor = Predictor(args.model_path, args.terminal_idx_path, args.path_idx_path,
                          table_dtype=args.table_dtype, device="cpu" if args.no_cuda else None)
    with open(args.source_file, encoding="utf-8") as f:
        source = f.read()
    language = "python" if args.source_file.endswith(".py") else "java"
    task = args.task
    if task == "auto":
        task = "method" if predictor.meta.get("infer_method_name", True) else "variable"
    predict = predictor.predict_source if task == "method" else predictor.predict_variables
    results = predict(source, args.method_name, language=language, top_k=args.top_k)
    if not results:
        print("no matching methods found")
        return 0
    for m in results:
        print(f"{m.method_name}  ({m.n_contexts} contexts"
              + (f", {m.n_oov} OOV dropped" if m.n_oov else "") + ")")
        for p in m.predictions:
            print(f"  {p.prob:6.3f}  {p.name}")
        for s, pth, e, a in m.attention[:args.show_attention]:
            print(f"    [{a:.3f}] {s} {pth} {e}")
        if neighbor_index is not None:
            nn_labels, nn_rows, nn_norms = neighbor_index
            for name, sim in nearest_from_rows(nn_labels, nn_rows, m.code_vector,
                                               args.neighbors, row_norms=nn_norms):
                print(f"    ~{sim:.3f}  {name}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
