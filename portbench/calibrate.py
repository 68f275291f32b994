"""Readings behind a cell's limits, in one process: the program's numbers
on many seeds (short windows at the cell's own load and size), and on a
few of them the control's (the reference in bfloat16 put in the
program's place) and the planted faults'.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
      --control-seeds 1,2,3 [--seconds 2] [--out readings.json]

The fault "half of the batch left out, the mean taken over the rest" is
the float32 reference stepping on the first half of each checked batch;
"a step that returns its state unchanged" reads 1 on ``change_gap`` by
its definition and needs no run. Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
from portbench import run as prun  # noqa: E402  (sets the cache dirs)


def train_readings(rec, cell_ctx):
    """The control's and the half-batch fault's numbers of a train run."""
    import torch
    from portbench import common
    from portbench.traffic import train
    cfg = cell_ctx["cfg"]
    ref = common.reference_module(cfg)
    geo, data = cell_ctx["geo"], cell_ctx["data"]
    field = ref.Field(cfg, geo, data["near"], data["far"],
                      1.0 if data["white_bkgd"] else 0.0)
    dev = rec["batches"][0][0].device
    ctl = train.follow(ref, field, rec["host0"], rec["batches"], dev,
                       rec["tv"], torch.bfloat16)
    ctl.pop("params")
    half = [tuple(x[: x.shape[0] // 2] for x in b) for b in rec["batches"]]
    flt = train.follow(ref, field, rec["host0"], half, dev, rec["tv"],
                       torch.float32)
    flt.pop("params")
    return {"control": train.compare(ref, rec["readings"], ctl),
            "fault_half_batch": train.compare(ref, rec["readings"], flt)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import inputs
    bench = prun.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    cfg = prun.read_json(os.path.join(HERE, "configs",
                                      f"{cell['config']}.json"))
    data = inputs.fixture(cfg)
    cell_ctx = {"cfg": cfg, "data": data, "geo": inputs.geometry(cfg, data)}
    rows = []
    for seed in seeds:
        t0 = time.time()
        out, rec = prun.run_cell(bench, cell, seed, args.seconds, 0, dev)
        row = {"seed": seed, "program": rec["numbers"],
               "correct": out["correct"], "units": rec["units"],
               "setup_s": rec["setup_s"],
               "memory_peak_bytes": rec["memory_peak_bytes"]}
        if seed in controls:
            row.update(train_readings(rec, cell_ctx))
        row["seconds"] = time.time() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del rec
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
