"""Every random stream of a run, derived from its ``--seed``."""

from __future__ import annotations

import numpy as np

# one stream a use, so that a draw added to one cannot shift another
STREAMS = {
    "order": 1,  # the corpus's methods, or the requests, in the run's order
    "corpus": 2,  # context ids and labels
    "weights": 3,  # the model's initial weights
    "sampler": 4,  # the device sampler's rotation shifts
    "dropout": 5,  # the dropout keep masks
    "rows": 6,  # each epoch's method order
    "requests": 7,  # request ids
    "check": 8,  # the requests sampled for the comparison
}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of the run seeded ``seed`` (any whole
    number; a large or negative one is folded into 64 bits first)."""
    state = np.random.SeedSequence([int(seed) % 2**64, STREAMS[stream]]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def torch_generator(seed: int, stream: str, device):
    """A ``torch.Generator`` on ``device`` for ``stream``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g
