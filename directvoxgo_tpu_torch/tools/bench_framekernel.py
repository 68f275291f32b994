"""Numerics and timing harness of the fused frame kernel K-B in the three
forms of the JAX package's frame kernels: v1 (``render_frame_pallas``), v3
(``render_frame_pallas3``) and v4 (``render_frame_pallas4``).

  python -m directvoxgo_tpu_torch.tools.bench_framekernel check [--device cpu]
  python -m directvoxgo_tpu_torch.tools.bench_framekernel perf [--device cpu]

``check`` renders three small cases (direct MLP, ``logit_plus_k0``, no MLP)
in every form and logs v1 against v3 (2e-2 relative) and v3 against v4
(1e-4 of max(1, |x|); the bf16 ``shared1`` of v3 puts up to ~1e-3 on rgb,
which is logged, not failed). On a GPU it also holds each form's kernel
against its plain version and fails on that alone. ``perf`` times six
variants at the full bench shape (1024^2 intermediate image, 192 stations,
160x160 slabs, F 12, W 128, occupancy 0.05): best and median of CUDA-event
times, or of host-clock times of the plain versions with ``--device cpu``.
The log goes to stderr; nothing is printed on stdout.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..engine.render_sweep import _tile_activity
from ..ops import render_frame as kb

BF16 = torch.bfloat16
EMB_DIM = 27
CHECK_SHAPE = (128, 256, 32, 48, 40)           # Hi, Wi, S, Gu, Gv
CHECK_MODES = (("direct", True), ("logit_plus_k0", True), ("direct", False))
PERF_SHAPE = dict(hi=1024, wi=1024, s_total=192, gu=160, gv=160,
                  occupancy=0.05)
VARIANTS = ("v3", "v3+gate", "v4", "v4+gate", "v3+gate geo-only", "v1")
# Kernel against its plain version on the card: the same rounding points;
# an f32 sum of the MLP taken in another order can flip one bf16 rounding
# of a hidden unit, which moves rgb by a few 1e-4 at most.
KERNEL_TOL = dict(rgb=1e-3, tcum=1e-4, depth_rel=1e-3)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).float().numpy()


def make_case(hi, wi, s_total, gu, gv, f_k0=12, width=128, has_mlp=True,
              rgb_mode="direct", occupancy=0.05, seed=0):
    """Synthetic slabs with a blob occupancy pattern, in the JAX kernels'
    layouts, as CPU tensors: the same arrays, drawn in the same order from
    the same seed, as ``make_case`` of the JAX package's harness
    ``tools/bench_framekernel.py``."""
    rng = np.random.default_rng(seed)
    zz, uu, vv = np.meshgrid(np.linspace(-1, 1, s_total),
                             np.linspace(-1, 1, gu),
                             np.linspace(-1, 1, gv), indexing="ij")
    r2 = zz ** 2 + uu ** 2 + vv ** 2
    radius = (occupancy * 6 / np.pi) ** (1 / 3)
    mask = (r2 < radius ** 2).astype(np.float32)
    density = np.where(mask > 0, rng.normal(2.0, 1.0, mask.shape), -6.0)
    k0 = rng.normal(0, 0.3, (s_total, f_k0, gu, gv)).astype(np.float32)
    d_geo_cm = np.concatenate([density, mask], axis=2)   # [S, Gu, 2Gv]
    dnorm = np.full((hi, wi), 1.3, np.float32) \
        + rng.normal(0, 0.01, (hi, wi)).astype(np.float32)
    dclip = dnorm * (0.8 + rng.uniform(0, 0.2, (hi, wi)).astype(np.float32))
    ur = np.linspace(-0.3 * gu, 1.3 * gu, hi).astype(np.float32)
    vr = np.linspace(-0.3 * gv, 1.3 * gv, wi).astype(np.float32)
    vd_emb = rng.normal(0, 0.5, (hi, wi, EMB_DIM)).astype(np.float32)
    w1b = rng.normal(0, 0.1, (EMB_DIM, width)).astype(np.float32)
    b1 = rng.normal(0, 0.05, (width,)).astype(np.float32)
    shared1 = (_bf16_round(vd_emb) @ w1b + b1).astype(np.float32)
    mlp = {
        "w1a": rng.normal(0, 0.3, (f_k0 - (3 if rgb_mode == "logit_plus_k0"
                                           else 0), width)).astype(np.float32),
        "w2": rng.normal(0, 0.1, (width, width)).astype(np.float32),
        "b2": rng.normal(0, 0.1, (width,)).astype(np.float32),
        "w3": rng.normal(0, 0.3, (width, 3)).astype(np.float32),
        "b3": rng.normal(0, 0.1, (3,)).astype(np.float32),
        "w1b": w1b, "b1": b1,
    }
    op = -40.0
    p_ref = float(s_total - 1) / 2.0  # stations at p = idx/2 (k=2)
    sc = np.array([op, -20.0, -25.0, 1.0 / (p_ref - op), 0.0, 0.5,
                   -4.6, 0.004, 1e-4, 0.1, 1e9, 1.0], np.float32)
    t = torch.from_numpy
    return dict(d_geo=t(d_geo_cm).to(BF16), d_k0=t(k0).to(BF16),
                d_k0t=t(k0.reshape(s_total, f_k0 * gu, gv)).to(BF16),
                shared1=t(shared1).to(BF16), dnorm=t(dnorm), dclip=t(dclip),
                ur=t(ur), vr=t(vr), mlp={k: t(v) for k, v in mlp.items()},
                vd_emb_cl=t(np.ascontiguousarray(
                    vd_emb.transpose(2, 0, 1))).to(BF16),
                sc=t(sc), guv=(gu, gv), has_mlp=has_mlp, rgb_mode=rgb_mode)


def to_device(case, dev):
    """The case's tensors on ``dev`` (the pose scalars stay on the host)."""
    out = {}
    for k, v in case.items():
        if k == "mlp":
            v = {n: w.to(dev) for n, w in v.items()}
        elif torch.is_tensor(v) and k != "sc":
            v = v.to(dev)
        out[k] = v
    return out


def _activity(case):
    return _tile_activity(kb.geo_from_channel_major(case["d_geo"]),
                          case["ur"], case["vr"], case["sc"], *case["guv"])


def _v1_inputs(case):
    """v1's positional and keyword arguments."""
    return ((case["d_geo"], case["d_k0"], case["shared1"], case["dnorm"],
             case["dclip"], case["ur"], case["vr"], case["mlp"], case["sc"]),
            dict(guv=case["guv"], has_mlp=case["has_mlp"],
                 rgb_mode=case["rgb_mode"]))


def _v3_inputs(case, gated=False, geo_only=False):
    """v3's positional and keyword arguments; ``geo_only``: the geometry
    warp and compositing alone (no colour grid, no MLP), which isolates the
    colour path's share of the time."""
    act = _activity(case) if gated else None
    if geo_only:
        return ((case["d_geo"], None, None, case["dnorm"], case["dclip"],
                 case["ur"], case["vr"], None, case["sc"], act),
                dict(guv=case["guv"], has_mlp=False, rgb_mode="direct"))
    return ((case["d_geo"], case["d_k0t"], case["shared1"], case["dnorm"],
             case["dclip"], case["ur"], case["vr"], case["mlp"], case["sc"],
             act),
            dict(guv=case["guv"], has_mlp=case["has_mlp"],
                 rgb_mode=case["rgb_mode"]))


def v1_args(case):
    a, kw = _v1_inputs(case)
    return kb.v1_frame_args(*a, **kw)


def v3_args(case):
    a, kw = _v3_inputs(case)
    return kb.v3_frame_args(*a, **kw)


def v4_args(case, gated=False):
    """v4's inputs in K-B's layouts: the view embedding, channel-leading
    ``[E, Hi, Wi]`` in the JAX kernel, transposed to ``[Hi, Wi, E]``."""
    gu, gv = case["guv"]
    s_total = case["d_geo"].shape[0]
    f_k0 = case["d_k0t"].shape[1] // gu
    layers = vd_emb = None
    if case["has_mlp"]:
        m = case["mlp"]
        layers = [(torch.cat([m["w1a"], m["w1b"]]), m["b1"]),
                  (m["w2"], m["b2"]), (m["w3"], m["b3"])]
        vd_emb = case["vd_emb_cl"].permute(1, 2, 0).contiguous()
    hi, wi = case["dnorm"].shape
    act = _activity(case) if gated else kb.all_active(
        hi, wi, s_total, case["dnorm"].device)
    return dict(
        d_geo=kb.geo_from_channel_major(case["d_geo"]).contiguous(),
        d_k0=case["d_k0t"].reshape(s_total, f_k0, gu, gv).permute(
            0, 2, 3, 1).contiguous(),
        vd_emb=vd_emb, dnorm=case["dnorm"], dclip=case["dclip"],
        ur=case["ur"], vr=case["vr"], layers=layers, scalars=case["sc"],
        activity=act, has_mlp=case["has_mlp"], rgb_mode=case["rgb_mode"])


def _hwc(out):
    rgb, depth, tcum = out
    return rgb.permute(1, 2, 0), depth, tcum


def run_v1(case):
    a, kw = _v1_inputs(case)
    return kb.render_frame_v1(*a, **kw)


def run_v3(case, gated=False, geo_only=False):
    a, kw = _v3_inputs(case, gated, geo_only)
    return _hwc(kb.render_frame_v3(*a, **kw))


def run_v4(case, gated=False):
    return _hwc(kb.render_frame(**v4_args(case, gated)))


def hold_kernel(args):
    """K-B on ``args`` against its plain version: (errors, stats); the
    errors are max |rgb|, max |T| and max relative depth differences."""
    rgb, depth, tcum = kb.render_frame(**args)
    torch.cuda.synchronize()
    stats = {}
    r_p, d_p, t_p = kb.render_frame_plain(**args, stats=stats)
    errs = dict(rgb=float((rgb - r_p).abs().max()),
                tcum=float((tcum - t_p).abs().max()),
                depth_rel=float(((depth - d_p).abs()
                                 / torch.clamp(d_p.abs(), min=1.0)).max()))
    return errs, stats


def within_tol(errs):
    """Whether :func:`hold_kernel`'s errors are inside ``KERNEL_TOL``."""
    return all(errs[k] <= KERNEL_TOL[k] for k in KERNEL_TOL)


def check(dev):
    """The harness's comparisons; on a GPU also every form's kernel against
    its plain version (raises if one disagrees). Returns
    {(rgb_mode, has_mlp): {form: errors}} of those kernel checks."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    held, failed = {}, []
    for rgb_mode, has_mlp in CHECK_MODES:
        hi, wi, s_total, gu, gv = CHECK_SHAPE
        case = make_case(*CHECK_SHAPE, has_mlp=has_mlp, rgb_mode=rgb_mode,
                         occupancy=0.15)
        if not has_mlp:
            case["d_k0"] = case["d_k0"][:, :3].contiguous()
            case["d_k0t"] = case["d_k0"].reshape(s_total, 3 * gu, gv)
        case = to_device(case, dev)
        a = [x.float().cpu().numpy() for x in run_v1(case)]
        b = [x.float().cpu().numpy() for x in run_v3(case)]
        c = [x.float().cpu().numpy() for x in run_v4(case)]
        for name, x, y in zip(("rgb", "depth", "tcum"), a, b):
            err = np.max(np.abs(x - y))
            rel = err / (np.max(np.abs(x)) + 1e-9)
            status = "OK" if rel < 2e-2 else "MISMATCH"
            log(f"{rgb_mode} mlp={has_mlp} v1-v3 {name}: maxabs={err:.5f} "
                f"rel={rel:.5f} {status}")
        for name, x, y in zip(("rgb", "depth", "tcum"), b, c):
            err = np.max(np.abs(x - y))
            tol = 1e-4 * max(1.0, float(np.abs(x).max()))
            status = "OK" if err < tol else "MISMATCH"
            log(f"{rgb_mode} mlp={has_mlp} v3-v4 {name}: maxabs={err:.6f} "
                f"tol={tol:.6f} {status}")
        if dev.type != "cuda":
            continue
        held[(rgb_mode, has_mlp)] = {}
        for form, args in (("v1", v1_args(case)), ("v3", v3_args(case)),
                           ("v4", v4_args(case))):
            errs, stats = hold_kernel(args)
            held[(rgb_mode, has_mlp)][form] = errs
            ok = within_tol(errs)
            log(f"{rgb_mode} mlp={has_mlp} {form} kernel-plain: "
                + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                + f" visible samples={stats['visible_samples']} "
                + ("OK" if ok else f"MISMATCH (bounds {KERNEL_TOL})"))
            if not ok:
                failed.append((rgb_mode, has_mlp, form, errs))
    if failed:
        raise AssertionError(f"frame kernel differs from its plain version: "
                             f"{failed}")
    return held


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_call(fn, dev, n_runs, warmup=0):
    """(best, median) ms of ``fn`` over ``n_runs`` calls after ``warmup``
    untimed ones: CUDA events on a GPU, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[0], times[len(times) // 2]


def perf(dev, shape=None, n_runs=6):
    """Times the six variants of the JAX harness's ``perf`` (each call with
    its layout adapters and, gated, its activity table). Returns
    {variant: {"best_ms", "median_ms", "first_s"}}."""
    shape = dict(PERF_SHAPE if shape is None else shape)
    case = to_device(make_case(**shape), dev)
    clock = "CUDA events" if dev.type == "cuda" else \
        "host clock, plain versions on the CPU"
    log(f"perf: {shape} on {dev} ({clock})")
    fns = {"v3": lambda: run_v3(case),
           "v3+gate": lambda: run_v3(case, gated=True),
           "v4": lambda: run_v4(case),
           "v4+gate": lambda: run_v4(case, gated=True),
           "v3+gate geo-only": lambda: run_v3(case, gated=True,
                                              geo_only=True),
           "v1": lambda: run_v1(case)}
    out = {}
    for name in VARIANTS:
        t0 = time.perf_counter()
        fns[name]()
        _sync(dev)
        first = time.perf_counter() - t0
        best, med = time_call(fns[name], dev, n_runs)
        out[name] = dict(best_ms=best, median_ms=med, first_s=first)
        log(f"{name}: first call {first:.2f} s, best {best:.3f} ms, median "
            f"{med:.3f} ms per frame kernel ({n_runs} runs)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m directvoxgo_tpu_torch.tools.bench_framekernel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("check", "perf"))
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    {"check": check, "perf": perf}[args.mode](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
