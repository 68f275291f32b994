"""Trace eager unfused train steps of one window key at full lego width:
the device's busy time per step, the host wall time and the operators
with the most device time.

  python -m directvoxgo_tpu_torch.tools.trace_step [--axis 2] [--window 96]

The model is the lego fine model at 160^3 (``fixture_lego_sparse``'s fine
settings) with the fixture teacher's density and seeded random colour
features and MLP; the rays are those of the first 8 train views whose
dominant axis is ``--axis``; the step key is the composed box (full p,
``--window``, ``--window``) at the centre of the grid, in region mode
(``skip_zero_grad`` grids, box-sized Adam). ``--steps`` steps run once
to warm up, then again under ``torch.profiler``. Steps run eagerly, through
``make_train_step`` and host offsets only, so that the same file runs
against an older tree of the package (copy it into that tree's
``tools/``) and two trees compare on one card. Needs a CUDA device; the
last line on stdout is one JSON object.

:func:`profile_steps` is the trace both this tool and ``chip_smoke.py``
take of train steps and renders.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "synthetic", "fixture_lego_sparse.py")


# Host-side calls that put work on the card, as the profiler's runtime
# events name them.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


def profile_steps(fn, n_steps, share_of=(), warm=None):
    """``fn()`` (which takes ``n_steps`` steps) once under
    ``torch.profiler``, after one untraced call of ``warm`` (default
    ``fn``). Per step: the host wall
    time (with the profiler's own cost in it), the device's busy time (the
    sum of its kernels and copies) and idle share, the kernels run, the
    host's launch calls (graph and kernel launches, copies and fills), the
    ten kernels and the ten operators with the most device time (ms) and,
    for each name in ``share_of``, the share of the busy time in kernels
    whose name holds it. None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    (warm or fn)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    kernels, operators, host = [], [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.key in LAUNCH_APIS:
            host += ev.count
        if dev_us <= 0:
            continue
        row = {"name": ev.key[:48], "ms": dev_us / 1e3 / n_steps,
               "calls": ev.count / n_steps, "key": ev.key}
        (kernels if ev.device_type == DeviceType.CUDA else operators).append(
            row)
    if not kernels:
        return None
    busy = sum(r["ms"] for r in kernels)
    shares = {name: sum(r["ms"] for r in kernels if name in r["key"]) / busy
              for name in share_of}
    for r in kernels + operators:
        del r["key"]
        r["ms"] = round(r["ms"], 4)
    top = lambda rows: sorted(rows, key=lambda r: -r["ms"])[:10]  # noqa: E731
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "kernel_launches": sum(r["calls"] for r in kernels),
            "host_launches": host / n_steps if host else None,
            "top_kernels": top(kernels), "top_operators": top(operators),
            **({"busy_share_of": shares} if share_of else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--axis", type=int, default=2)
    ap.add_argument("--window", type=int, default=96)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_step: needs a CUDA device", file=sys.stderr)
        return 2
    from .. import rays as ray_lib
    from ..config import Config
    from ..data import load_everything
    from ..data.synthetic import teacher_grids
    from ..engine import train as train_lib
    from ..models.dvgo import DirectVoxGO
    from ..ops import grid as grid_ops
    from ..ops import sweep as sweep_ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(CONFIG)
    kw = dict(cfg.fine_model_and_render)
    gen = torch.Generator(device="cpu").manual_seed(0)
    model = DirectVoxGO(xyz_min=[-1.0] * 3, xyz_max=[1.0] * 3, device=dev,
                        **kw)
    dens, _ = teacher_grids(128, "lego")
    dens = torch.nn.functional.interpolate(
        torch.as_tensor(dens)[None, None], size=model.world_size,
        mode="trilinear", align_corners=True)[0, 0]
    with torch.no_grad():
        model.density.copy_(dens.to(dev))
        model.k0.copy_(torch.randn(model.k0.shape, generator=gen).to(dev))
        model.mask.copy_(model.activate_density(
            grid_ops.max_pool3d_same(model.density)) >= 1e-3)

    data = load_everything(None, cfg)
    ro, rd, vd = [], [], []
    for v in data["i_train"][:8]:
        h, w = (int(x) for x in data["HW"][v])
        for out, x in zip((ro, rd, vd), ray_lib.get_rays_of_a_view(
                h, w, data["Ks"][v], data["poses"][v], False, False, False,
                False)):
            out.append(x.reshape(-1, 3))
    ro, rd, vd = (np.concatenate(x).astype(np.float32) for x in (ro, rd, vd))
    rgb = np.random.default_rng(0).uniform(0, 1, ro.shape).astype(np.float32)
    pool = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("rgb", rgb), ("rays_o", ro), ("rays_d", rd), ("viewdirs", vd))}
    ax = args.axis
    group = np.flatnonzero(sweep_ops.dominant_axis(
        rd, model.xyz_min, model.xyz_max, model.world_size) == ax)
    gp, gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[ax])
    key = (gp, args.window, args.window)
    off = np.asarray([0, (gu - args.window) // 2, (gv - args.window) // 2],
                     np.int32)
    opt = train_lib.create_optimizer_or_freeze_model(model, cfg.fine_train)
    rk = {"near": data["near"], "far": data["far"], "bg": 1.0,
          "stepsize": cfg.fine_model_and_render.stepsize}
    step = train_lib.make_train_step(model, opt, cfg.fine_train, rk, False,
                                     False, axis=ax, clip_sizes=key)
    rng = np.random.default_rng(1)
    n_rand = int(cfg.fine_train.N_rand)
    sels = [torch.as_tensor(rng.choice(group, n_rand, replace=False),
                            device=dev) for _ in range(args.steps)]

    def steps():
        for sel in sels:
            step(pool, sel, off)

    trace = profile_steps(steps, args.steps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "world_size": [int(x) for x in model.world_size], "axis": ax,
        "key": list(key), "steps": args.steps, **(trace or {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
