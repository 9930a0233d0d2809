"""A training corpus drawn from the seed on the device, ids only.

A vectorised copy of ``code2vec_tpu_torch/data/synth.py``'s draw, in the
model's id space and with no vocabulary strings: each label owns a
signature pool of ``signature_size`` path-contexts, a method's contexts
come from its label's pool with probability ``signal`` and are uniform
over the vocabularies otherwise, and a ``question_share`` of the starts is
``@question`` (id 1, the staged form of ``@method_0``). Ids: PAD is 0,
terminals ``[2, terminal_count)``, paths ``[1, path_count)``.

The lengths are one fixed multiset for every seed, drawn from the
configuration's ``length_seed`` (lognormal around ``median_contexts`` with
``length_sigma``, clipped to ``[min_contexts, max_contexts]``), dealt to the
methods in the seed's order: every seed trains on the same amount of work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from c2vbench.seeds import numpy_rng, torch_generator

PAD, QUESTION = 0, 1
# methods drawn a block, so the transient int64 tensors stay small
BLOCK_METHODS = 1 << 17


@dataclass
class Corpus:
    contexts: object  # int32 [total, 3] (start, path, end) on the device
    row_splits: object  # int32 [n + 1] on the device
    labels: object  # int32 [n] on the device
    counts: np.ndarray  # int64 [n] on the host

    @property
    def n_items(self) -> int:
        return len(self.counts)


def lengths(spec: dict, n_methods: int, seed: int) -> np.ndarray:
    """Each method's context count: the fixed multiset, in the seed's order."""
    fixed = np.random.default_rng(spec["length_seed"])
    counts = np.clip(fixed.lognormal(np.log(spec["median_contexts"]), spec["length_sigma"],
                                     n_methods).astype(np.int64),
                     spec["min_contexts"], spec["max_contexts"])
    return counts[numpy_rng(seed, "order").permutation(n_methods)]


def draw_corpus(config: dict, seed: int, device) -> Corpus:
    import torch

    spec = config["corpus"]
    n = spec["n_methods"]
    counts = lengths(spec, n, seed)
    total = int(counts.sum())
    if total >= 2**31:
        raise ValueError(f"{total} contexts: the staged row splits are int32")
    g = torch_generator(seed, "corpus", device)
    i32 = torch.int32
    tc, pc, nl = config["terminal_count"], config["path_count"], config["label_count"]
    sig = spec["signature_size"]
    labels = torch.randint(0, nl, (n,), generator=g, device=device, dtype=i32)
    pools = (torch.randint(2, tc, (nl, sig), generator=g, device=device, dtype=i32),
             torch.randint(1, pc, (nl, sig), generator=g, device=device, dtype=i32),
             torch.randint(2, tc, (nl, sig), generator=g, device=device, dtype=i32))
    highs = ((2, tc), (1, pc), (2, tc))
    contexts = torch.empty((total, 3), dtype=i32, device=device)
    splits = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=splits[1:])
    counts_dev = torch.from_numpy(counts).to(device)
    for lo in range(0, n, BLOCK_METHODS):
        hi = min(n, lo + BLOCK_METHODS)
        c0, c1 = int(splits[lo]), int(splits[hi])
        m = c1 - c0
        seg_label = torch.repeat_interleave(labels[lo:hi].long(), counts_dev[lo:hi])
        from_sig = torch.rand(m, generator=g, device=device) < spec["signal"]
        slot = torch.randint(0, sig, (m,), generator=g, device=device)
        for col, (pool, (low, high)) in enumerate(zip(pools, highs)):
            uniform = torch.randint(low, high, (m,), generator=g, device=device, dtype=i32)
            contexts[c0:c1, col] = torch.where(from_sig, pool[seg_label, slot], uniform)
        question = torch.rand(m, generator=g, device=device) < spec["question_share"]
        contexts[c0:c1, 0].masked_fill_(question, QUESTION)
    row_splits = torch.from_numpy(splits.astype(np.int32)).to(device)
    return Corpus(contexts=contexts, row_splits=row_splits, labels=labels, counts=counts)
