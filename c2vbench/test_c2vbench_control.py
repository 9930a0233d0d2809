"""The controls on the card: the plain reference put in the program's place
and computed in TF32, the precision just below the configurations' f32
with TF32 off, has to come out as not correct, while the program's own
first steps stay inside the same limits. At the cells' widths with a
corpus and a label count a test run can hold; the cells' own sizes are
read by ``python3 -m c2vbench.control``. Skipped without a card::

    python3 -m pytest -m cuda c2vbench/test_c2vbench_control.py -q
"""

from __future__ import annotations

import pytest
import torch

from c2vbench import compare, control, harness
from c2vbench.reference import code_vectors
from c2vbench.requests import draw_bags
from c2vbench.weights import make_weights


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 products run only on the card")
    return torch.device("cuda", 0)


def held_size(config: str) -> dict:
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    cfg["label_count"] = min(cfg["label_count"], 20000)
    cfg["corpus"]["n_methods"] = 20000
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("config,traffic", [("top11", "train_device"),
                                            ("java14m", "train_lazy")])
def test_train_control_fails(config, traffic):
    device = card()
    tr = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    cell = harness.Cell("held", 1, held_size(config), tr, [], [])
    for seed in (101, 102, 103):
        got = control.readings(cell, seed, device)
        assert compare.passed(compare.judge(got["program"], tr["limits"])), got["program"]
        for side in ("control_tf32", "fault_half", "fault_frozen"):
            assert not compare.passed(compare.judge(got[side], tr["limits"])), (side, got[side])


@pytest.mark.cuda
def test_serve_control_fails():
    device = card()
    cfg = harness.load_json(harness.HERE / "configs" / "top11.json")
    tr = harness.load_json(harness.HERE / "traffic" / "serve_embed.json")
    tr["pool_size"] = 256
    for seed in (101, 102, 103):
        bags = draw_bags(cfg, tr, seed)
        w = make_weights(cfg, seed, device)
        ref = code_vectors(w, bags, device)
        low = code_vectors(w, bags, device, tf32=True)
        gap = compare.cv_gap([x.numpy() for x in low], ref)
        assert gap > tr["limits"]["cv_gap"], gap
