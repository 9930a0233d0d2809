"""Evaluation metrics: the reference's three matchers (main.py:291-359).

Own copy of ``code2vec_tpu/metrics.py``. All three take label ids plus the
label vocab's subtoken table and run on the host in numpy. ``exact_match``
is computed here in numpy (the JAX module calls scikit-learn): accuracy
and support-weighted precision / recall / F1 over the labels that occur
in either array, a zero where a denominator is zero (``zero_division=0``).
:func:`sequence_subtoken_match` is code2seq's: subtoken precision, recall
and F1 of greedy-decoded names (no JAX counterpart).
"""

from __future__ import annotations

import numpy as np

from code2vec_tpu_torch.data.vocab import Vocab


def exact_match(expected: np.ndarray, actual: np.ndarray) -> tuple[float, float, float, float]:
    """Accuracy + weighted P/R/F1 on raw label ids (reference main.py:300-305)."""
    expected = np.asarray(expected).ravel()
    actual = np.asarray(actual).ravel()
    labels, inv = np.unique(np.concatenate([expected, actual]), return_inverse=True)
    n = len(expected)
    t, p = inv[:n], inv[n:]
    k = len(labels)
    tp = np.bincount(t[t == p], minlength=k).astype(np.float64)
    true_sum = np.bincount(t, minlength=k).astype(np.float64)
    pred_sum = np.bincount(p, minlength=k).astype(np.float64)

    def divide(num, den):
        out = np.zeros_like(num)
        np.divide(num, den, out=out, where=den != 0)
        return out

    precision = divide(tp, pred_sum)
    recall = divide(tp, true_sum)
    f1 = divide(2.0 * precision * recall, precision + recall)
    total = true_sum.sum()

    def weighted(v):
        return float((v * true_sum).sum() / total) if total else 0.0

    accuracy = float(np.mean(expected == actual)) if n else 0.0
    return accuracy, weighted(precision), weighted(recall), weighted(f1)


def subtoken_match(expected: np.ndarray, actual: np.ndarray,
                   label_vocab: Vocab) -> tuple[float, float, float, float]:
    """Corpus-pooled subtoken overlap, the reference default
    (main.py:339-359). A predicted subtoken matches if it appears in the
    expected name's subtokens (membership, as the reference's ``in``)."""
    match = expected_count = actual_count = 0.0
    itosubtokens = label_vocab.itosubtokens
    for exp, act in zip(np.asarray(expected).tolist(), np.asarray(actual).tolist()):
        exp_subtokens = itosubtokens[int(exp)]
        act_subtokens = itosubtokens[int(act)]
        for subtoken in exp_subtokens:
            if subtoken in act_subtokens:
                match += 1
        expected_count += len(exp_subtokens)
        actual_count += len(act_subtokens)
    denom = expected_count + actual_count - match
    accuracy = match / denom if denom else 0.0
    precision = match / actual_count if actual_count else 0.0
    recall = match / expected_count if expected_count else 0.0
    f1 = 2.0 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return accuracy, precision, recall, f1


def averaged_subtoken_match(expected: np.ndarray, actual: np.ndarray,
                            label_vocab: Vocab) -> tuple[float, float, float, float]:
    """Per-example subtoken metrics, then their mean (main.py:308-336)."""
    accs, precs, recs, f1s = [], [], [], []
    itosubtokens = label_vocab.itosubtokens
    for exp, act in zip(np.asarray(expected).tolist(), np.asarray(actual).tolist()):
        exp_subtokens = itosubtokens[int(exp)]
        act_subtokens = itosubtokens[int(act)]
        match = sum(1 for s in exp_subtokens if s in act_subtokens)
        acc = match / float(len(exp_subtokens) + len(act_subtokens) - match)
        rec = match / float(len(exp_subtokens))
        prec = match / float(len(act_subtokens))
        accs.append(acc)
        precs.append(prec)
        recs.append(rec)
        f1s.append(2.0 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
    return (float(np.average(accs)), float(np.average(precs)), float(np.average(recs)),
            float(np.average(f1s)))


def sequence_subtoken_match(expected: list, predicted: np.ndarray, target_names: list,
                            specials: int = 3) -> tuple[float, float, float, float]:
    """code2seq's subtoken metrics over greedy-decoded names (its
    ``update_per_subtoken_statistics``): ``expected`` each row's true
    subtokens (strings), ``predicted`` ``[N, T]`` target ids, read up to the
    first end of name (id 0), the reserved ids (below ``specials``: end,
    UNK, SOS) dropped. A name predicted whole counts all its subtokens true;
    otherwise a predicted subtoken is true if the name holds it (else
    false), a true one missed if the prediction lacks it. Returns
    ``(accuracy, precision, recall, f1)``, accuracy the share of names
    predicted whole."""
    tp = fp = fn = whole = 0
    for want, row in zip(expected, np.asarray(predicted).tolist()):
        got = []
        for t in row:
            if t == 0:
                break
            if t >= specials:
                got.append(target_names[t])
        want = list(want)
        if "".join(want) == "".join(got):
            tp += len(want)
            whole += 1
            continue
        tp += sum(1 for s in got if s in want)
        fp += sum(1 for s in got if s not in want)
        fn += sum(1 for s in want if s not in got)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2.0 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return (whole / len(expected) if len(expected) else 0.0), precision, recall, f1


def evaluate(eval_method: str, expected: np.ndarray, actual: np.ndarray,
             label_vocab: Vocab) -> tuple[float, float, float, float]:
    """``(accuracy, precision, recall, f1)`` by ``eval_method``
    (main.py:291-296); all zeros for an empty split."""
    if len(expected) == 0:
        return 0.0, 0.0, 0.0, 0.0
    if eval_method == "exact":
        return exact_match(expected, actual)
    if eval_method == "subtoken":
        return subtoken_match(expected, actual, label_vocab)
    if eval_method == "ave_subtoken":
        return averaged_subtoken_match(expected, actual, label_vocab)
    raise ValueError(f"unknown eval_method: {eval_method!r}")
