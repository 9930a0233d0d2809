"""The readings a cell's limits are set from, at the cell's own
size, on the card (not run by the benchmark's own runs)::

    python3 -m c2vbench.control --workload <cell> --seeds 1,2,3 --out readings.json

For each seed it builds the cell's training object as a run does, drives
its first steps through ``train_chunk`` and compares them with the plain
reference (the program's reading, the lower end of each limit). Then it
puts the reference in the program's place, computed in TF32 with TF32 off
as the configuration states it (the control), and with two planted faults:
a step that leaves the state unchanged (``frozen``) and half of each batch
left out with the mean over the rest (``half``). Each reading is the
``compare.train_gaps`` of that side against the f32 reference. For a
serving cell it reads the control alone: the reference's code vectors of
the seed's request pool in TF32 against the same in f32; the program's
readings there are its runs' own ``cv_gap``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from c2vbench import compare, harness
from c2vbench.drivers import train_device
from c2vbench.reference import follow_train
from c2vbench.seeds import numpy_rng
from c2vbench.weights import make_weights


def readings(cell, seed: int, device, raw: dict | None = None) -> dict:
    import torch

    cfg, tr = cell.config, cell.traffic
    obj, corpus = train_device.build(cell, seed, device)
    feed = train_device.RowFeed(corpus.n_items, cfg["batch_size"], numpy_rng(seed, "rows"))
    rows, losses, grad, delta = train_device.first_steps(obj, feed, tr["compare_steps"],
                                                         cfg["beta_min"], cfg["batch_size"],
                                                         device)
    prog = {"losses": losses.cpu().tolist(), "grad": {k: float(v) for k, v in grad.items()},
            "delta": {k: float(v) for k, v in delta.items()}}
    del obj, losses, grad, delta
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg, seed, device)
    ref = follow_train(cfg, tr, weights, corpus, rows, seed)
    sides = {
        "program": prog,
        "control_tf32": follow_train(cfg, tr, weights, corpus, rows, seed, tf32=True),
        "fault_half": follow_train(cfg, tr, weights, corpus, rows, seed, fault="half"),
        "fault_frozen": follow_train(cfg, tr, weights, corpus, rows, seed, fault="frozen"),
    }
    if raw is not None:
        raw.update(reference=ref, **sides)
    return {name: compare.train_gaps(side, ref) for name, side in sides.items()}


def serve_readings(cell, seed: int, device) -> dict:
    """A serving cell's control: the reference's code vectors of the seed's
    request pool computed in TF32, against the same in f32 (the program's
    readings are its runs' own ``cv_gap``)."""
    from c2vbench.reference import code_vectors
    from c2vbench.requests import draw_bags

    bags = draw_bags(cell.config, cell.traffic, seed)
    w = make_weights(cell.config, seed, device)
    ref = code_vectors(w, bags, device)
    low = code_vectors(w, bags, device, tf32=True)
    return {"control_tf32": {"cv_gap": compare.cv_gap([x.numpy() for x in low], ref)}}


def summarize(per_seed: dict) -> dict:
    """Each number's lower reading (the program's largest) and each side's
    smallest reading."""
    first = next(iter(per_seed.values()))
    names = next(iter(first.values())).keys()
    sides = first.keys()
    return {side: {n: (max if side == "program" else min)(s[side][n] for s in per_seed.values())
                   for n in names} for side in sides}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m c2vbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma list of seeds")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    per_seed, raw = {}, {}
    serving = cell.traffic["driver"] == "serve_embed"
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        raw[s] = {}
        per_seed[s] = (serve_readings(cell, int(s), device) if serving
                       else readings(cell, int(s), device, raw[s]))
        print(json.dumps({"seed": s, "seconds": time.perf_counter() - t0, **per_seed[s]}),
              flush=True)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "per_seed": per_seed, "summary": summarize(per_seed), "raw": raw}
    print(json.dumps(out["summary"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
