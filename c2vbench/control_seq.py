"""The readings a code2seq cell's limits are set from, at the cell's own
size, on the card (not run by the benchmark's own runs)::

    python3 -m c2vbench.control_seq --workload c2s_java_large.train_seq --seeds 1,2,3 --out r.json

``control.py``'s readings for the ``train_seq`` driver: for each seed it
builds the cell's training object as a run does, drives its first steps
through ``train_chunk`` and compares them with the plain reference
(``program``, the lower end of each limit); then it puts the reference in
the program's place, computed in TF32 with TF32 off as the configuration
states it (``control_tf32``), and with the two planted faults
(``fault_frozen``, ``fault_half``). Each reading is ``compare.train_gaps``
against the f32 reference. The last line is ``control.summarize``'s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from c2vbench import compare, harness
from c2vbench.code2seq_inputs import make_weights
from c2vbench.control import summarize
from c2vbench.drivers import train_seq
from c2vbench.reference_code2seq import follow_train
from c2vbench.seeds import numpy_rng


def readings(cell, seed: int, device) -> dict:
    import torch

    cfg, tr = cell.config, cell.traffic
    b = cfg["batch_size"]
    obj, corpus, tables = train_seq.build(cell, seed, device)
    feed = train_seq.RowFeed(corpus.n_items, b, numpy_rng(seed, "rows"))
    rows, losses, grad, delta = train_seq.first_steps(obj, feed, tr["compare_steps"], b, device)
    prog = {"losses": losses.cpu().tolist(), "grad": {k: float(v) for k, v in grad.items()},
            "delta": {k: float(v) for k, v in delta.items()}}
    del obj, losses, grad, delta
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg, seed, device)

    def follow(**kw):
        return follow_train(cfg, tr, weights, tables, corpus, rows, seed, **kw)

    ref = follow()
    sides = {"program": prog, "control_tf32": follow(tf32=True),
             "fault_half": follow(fault="half"), "fault_frozen": follow(fault="frozen")}
    return {name: compare.train_gaps(side, ref) for name, side in sides.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m c2vbench.control_seq")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma list of seeds")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from c2vbench.run import cache_dirs

    cache_dirs()
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    per_seed = {}
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        per_seed[s] = readings(cell, int(s), device)
        print(json.dumps({"seed": s, "seconds": time.perf_counter() - t0, **per_seed[s]}),
              flush=True)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "per_seed": per_seed, "summary": summarize(per_seed)}
    print(json.dumps(out["summary"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
