"""Run ``python -m directvoxgo_tpu_torch.run`` to completion across wedged
device pulls.

With ``DVGO_FETCH_WATCHDOG`` set, the engine's watchdog ends a process
whose pull from the device never returns with exit 17
(:mod:`..engine.fetchguard`). This wrapper then

  1. waits until the card answers again (probe: a subprocess allocates on
     the card and pulls one scalar under the watchdog),
  2. relaunches the same command, which resumes from the newest numbered
     checkpoint of the stage (``--i_weights``), checked against the
     current config (:func:`..engine.checkpoint.check_numbered_resume`).

Pass ``--i_weights <k>`` in the run's arguments so that mid-stage
checkpoints exist to resume from; each attempt then makes progress.

Usage::

  python -m directvoxgo_tpu_torch.tools.resilient_run [--max-restarts N]
      [--watchdog SECS] -- --config configs/nerf/lego.py --i_weights 2000
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXIT_WEDGED = 17
PROBE_EVERY_S = 45.0  # seconds between probes of the card

PROBE_SRC = r"""
import torch
from directvoxgo_tpu_torch.engine.fetchguard import guarded
big = torch.zeros((512, 1024, 1024), device="cuda")  # 2 GiB
with guarded("probe scalar pull"):
    v = float(big[:4].sum())
print("probe ok", v)
"""


def probe_device(watchdog, timeout=300, src=PROBE_SRC):
    """Exit code of the probe (0: the card answers; 17: its pull wedged)."""
    env = dict(os.environ, DVGO_FETCH_WATCHDOG=str(watchdog))
    try:
        r = subprocess.run([sys.executable, "-c", src], env=env, cwd=REPO,
                           timeout=timeout, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        return r.returncode
    except subprocess.TimeoutExpired:
        return EXIT_WEDGED


def main(argv=None, command=None):
    """``command``: the argv prefix of the run (tests substitute one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--watchdog", type=float, default=240.0,
                    help="watchdog seconds of the run (checkpoint and eval "
                         "pulls get 4x this)")
    ap.add_argument("--probe-wait", type=float, default=900.0,
                    help="most seconds to wait for the card between "
                         "attempts")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by the run's arguments")
    args = ap.parse_args(argv)
    run_args = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if not run_args:
        ap.error("no run arguments given (use -- <args>)")
    if command is None:
        command = [sys.executable, "-m", "directvoxgo_tpu_torch.run"]
    env = dict(os.environ, DVGO_FETCH_WATCHDOG=str(args.watchdog))

    for attempt in range(args.max_restarts + 1):
        t0 = time.time()
        print(f"resilient_run: attempt {attempt + 1} (watchdog "
              f"{args.watchdog:.0f} s): " + " ".join(run_args), flush=True)
        rc = subprocess.call(command + run_args, env=env, cwd=REPO)
        dt = time.time() - t0
        if rc == 0:
            print(f"resilient_run: completed in {dt:.0f} s on attempt "
                  f"{attempt + 1}", flush=True)
            return 0
        if rc != EXIT_WEDGED:
            print(f"resilient_run: the run failed rc={rc} after {dt:.0f} s "
                  "(not a wedged pull; not retrying)", flush=True)
            return rc
        print(f"resilient_run: a pull wedged after {dt:.0f} s; waiting for "
              "the card", flush=True)
        t_wait = time.time()
        while time.time() - t_wait < args.probe_wait:
            time.sleep(PROBE_EVERY_S)
            prc = probe_device(min(args.watchdog, 120.0))
            state = {0: "healthy", EXIT_WEDGED: "still wedged"}.get(
                prc, f"allocation failed rc={prc}")
            print(f"resilient_run: probe after {time.time() - t_wait:.0f} "
                  f"s: {state}", flush=True)
            if prc == 0:
                break
        else:
            print("resilient_run: the card did not recover within "
                  f"{args.probe_wait:.0f} s; giving up", flush=True)
            return EXIT_WEDGED
    print(f"resilient_run: exhausted {args.max_restarts} restarts",
          flush=True)
    return EXIT_WEDGED


if __name__ == "__main__":
    sys.exit(main())
