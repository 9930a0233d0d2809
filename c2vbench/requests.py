"""Embedding requests drawn from the seed, in the protocol's contexts form.

A pool of ``pool_size`` requests: ``long_share`` of them log-uniform over
``[long_min, long_max]`` contexts, the rest log-uniform over ``[short_min,
short_max]``. The lengths are one fixed multiset for every seed (drawn from
the traffic's ``length_seed``), in the seed's order; the ids come from the
seed: starts and ends over the terminals ``[2, terminal_count)``, paths over
``[1, path_count)``.
"""

from __future__ import annotations

import numpy as np

from c2vbench.seeds import numpy_rng


def log_uniform(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    return np.clip(np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n)).astype(np.int64), lo, hi)


def lengths(traffic: dict, seed: int) -> np.ndarray:
    n = traffic["pool_size"]
    n_long = int(round(traffic["long_share"] * n))
    fixed = np.random.default_rng(traffic["length_seed"])
    out = np.concatenate([
        log_uniform(fixed, traffic["short_min"], traffic["short_max"], n - n_long),
        log_uniform(fixed, traffic["long_min"], traffic["long_max"], n_long)])
    return out[numpy_rng(seed, "order").permutation(n)]


def draw_bags(config: dict, traffic: dict, seed: int) -> list:
    """The pool's id bags, int32 ``[n, 3]`` arrays of (start, path, end)."""
    rng = numpy_rng(seed, "requests")
    tc, pc = config["terminal_count"], config["path_count"]
    bags = []
    for n in lengths(traffic, seed):
        bags.append(np.stack([rng.integers(2, tc, n), rng.integers(1, pc, n),
                              rng.integers(2, tc, n)], axis=1).astype(np.int32))
    return bags


def embed_request(bag: np.ndarray) -> dict:
    """The protocol's ``embed`` request of one bag (``contexts`` as JSON
    lists, as a client sends them)."""
    return {"op": "embed", "contexts": bag.tolist()}
