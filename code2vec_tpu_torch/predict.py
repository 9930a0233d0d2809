"""Inference from a trained model dir: load once, predict per bag of contexts.

Counterpart of ``code2vec_tpu/predict.py``. A model dir holds
``model_meta.json`` (dims, flags, the bag-width ladder), ``label_vocab.txt``
and the weights as a reference-layout ``code2vec.model`` (a JAX-trained dir
gets one from ``tools/export_reference_checkpoint.py``). The
:class:`Predictor` reads them, quantizes the tables once at load
(``table_dtype``), and pads every forward to the nearest ladder width.
A ladder with rungs above the training bag (recorded by a run that fed
unbounded bags, or given as ``longbag_widths``) serves long bags: the
Predictor's bag rises to the top rung and the model streams the softmax
(K4) at every width above the training bag.

Source extraction (``predict_source``: the Java and Python extractors) is
not ported yet; the pre-mapped ``contexts`` form is the input here.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_NAME

logger = logging.getLogger(__name__)

MODEL_META = "model_meta.json"
LABEL_VOCAB = "label_vocab.txt"


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
    n_contexts: int
    attention: list[tuple[int, int, int, float]]  # (start, path, end, weight), heaviest first
    code_vector: np.ndarray  # [encode_size]


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
    forward's kernel route (serving default: the fully fused K3).
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
    ) -> None:
        from code2vec_tpu_torch import interop
        from code2vec_tpu_torch.data.pipeline import derive_bucket_ladder
        from code2vec_tpu_torch.formats.vocab_io import read_vocab
        from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
        from code2vec_tpu_torch.ops.backend import resolve_device

        self.device = resolve_device(device)
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

    def predict_source(self, *args, **kwargs):
        raise NotImplementedError(
            "source extraction (Java/Python extractors) is not ported yet; "
            "send pre-mapped 'contexts' instead"
        )
