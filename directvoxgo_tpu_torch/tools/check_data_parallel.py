"""Train the lego fixture data-parallel over every visible card, and check
the ranks and rank 0's render.

Runs ``python -m directvoxgo_tpu_torch.run --data_parallel --render_test``
(one rank spawned per card, the NCCL all-reduce captured in the steps'
CUDA graphs) on the lego fixture at full width, then the same command on
one card, and checks that

  - the driver spawned one rank per card and sharded both stages' batches
    over them;
  - the replicas agree bit for bit after each stage (the loop's
    ``data_parallel: replicas after <stage>`` line);
  - rank 0 rendered every test view (PNGs written, a finite test PSNR) and
    the other ranks rendered nothing;
  - the data-parallel test PSNR is within ``PSNR_TOL`` dB of the one-card
    run's (the two runs sum their gradients in another order, so their
    trajectories part in the last bits and do not stay bit for bit).

The runs' output, configs, checkpoints and renders go to
``logs/check_data_parallel/`` (``dp.log``, ``one.log``); the last line of
standard output is a JSON summary. Exits 1 when a check fails. Needs two
cards or more. Usage::

  python -m directvoxgo_tpu_torch.tools.check_data_parallel
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASE = os.path.join(REPO, "configs", "synthetic", "fixture_lego_sparse.py")
# The schedule of chip_smoke.py's training phase: the base config's widths
# and N_rand 8192 (2048 rays a rank on four cards), fewer iterations.
N_COARSE, N_FINE, PG_SCALE = 3000, 600, [100, 200, 300, 400]
PSNR_TOL = 1.0
RUN_TIMEOUT_S = 900
OUT = os.path.join(REPO, "logs", "check_data_parallel")


def write_config(out, name):
    path = os.path.join(out, f"{name}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = {os.path.relpath(BASE, out)!r}\n"
                f"expname = {name!r}\n"
                f"basedir = {out!r}\n"
                f"coarse_train = {{'N_iters': {N_COARSE}}}\n"
                f"fine_train = {{'N_iters': {N_FINE}, "
                f"'pg_scale': {PG_SCALE}}}\n")
    return path


def run(out, name, extra):
    """One driver run; returns (its output, seconds)."""
    cmd = [sys.executable, "-m", "directvoxgo_tpu_torch.run", "--config",
           write_config(out, name), "--render_test", "--i_print", "500",
           *extra]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=RUN_TIMEOUT_S)
    dt = time.time() - t0
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(proc.stdout)
    if proc.returncode:
        raise RuntimeError(f"{name}: exit {proc.returncode}; see "
                           f"{out}/{name}.log:\n{proc.stdout[-3000:]}")
    return proc.stdout, dt


def summary(text, out, name):
    psnr = re.findall(r"Testing psnr ([-\d.naif]+)", text)
    spreads = dict(re.findall(
        r"data_parallel: replicas after (\w+): largest difference from "
        r"rank 0 ([-\d.e+naif]+)", text))
    return {
        "ranks": [int(n) for n in re.findall(
            r"data_parallel: one rank per card, (\d+) ranks", text)],
        "sharded_stages": re.findall(
            r"data_parallel: sharding ray batches over (\d+) devices", text),
        "replica_spread": {k: float(v) for k, v in spreads.items()},
        "test_psnr": float(psnr[-1]) if psnr else None,
        "pngs": len(glob.glob(os.path.join(
            out, name, "render_test_fine_last", "*.png"))),
        "train_s": [float(s) for s in re.findall(
            r"train: (?:coarse geometry searching|fine detail "
            r"reconstruction) in ([\d.]+) s", text)],
    }


def main():
    import torch
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"check_data_parallel: needs two cards or more, found "
              f"{n_cards}", file=sys.stderr)
        return 1
    out = OUT
    os.makedirs(out, exist_ok=True)
    dp_text, dp_s = run(out, "dp", ["--data_parallel"])
    one_text, one_s = run(out, "one", [])
    dp, one = summary(dp_text, out, "dp"), summary(one_text, out, "one")
    dp["command_s"], one["command_s"] = dp_s, one_s
    checks = {
        "one rank per card": dp["ranks"] == [n_cards],
        "both stages sharded": dp["sharded_stages"] == [str(n_cards)] * 2,
        "replicas bit for bit": (sorted(dp["replica_spread"])
                                 == ["coarse", "fine"]
                                 and all(v == 0.0 for v in
                                         dp["replica_spread"].values())),
        "rank 0 rendered": (dp["test_psnr"] is not None and dp["pngs"] > 0
                            and dp["pngs"] == one["pngs"]
                            and dp_text.count("Testing psnr") == 1),
        "psnr as one card": (dp["test_psnr"] is not None
                             and one["test_psnr"] is not None
                             and abs(dp["test_psnr"] - one["test_psnr"])
                             <= PSNR_TOL),
    }
    ok = all(checks.values())
    for k, v in checks.items():
        print(f"check_data_parallel: {k}: {'ok' if v else 'FAILED'}",
              file=sys.stderr)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(json.dumps({"ok": ok, "cards": n_cards,
                      "card": smi.stdout.strip().splitlines(),
                      "data_parallel": dp, "one_card": one,
                      "checks": checks}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
