#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (directvoxgo_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which fails the run:
  0. build every CUDA kernel of the render path from csrc/ (one nvcc per
     source, all at once);
  1. hold each kernel against its plain PyTorch version on the card, at a
     small shape here and at the main path's full shape after phase 3;
  2. build a full-width lego fine checkpoint (160^3 grid, k0 12, MLP
     39->128->128->3) from the fixture teacher density and seeded random
     colour weights, and save it in the checkpoint format;
  3. render the 4 test views of configs/synthetic/fixture_lego_sparse.py at
     400^2 through ``python -m directvoxgo_tpu_torch.run`` (in process, so
     the launch counts are visible) and check that the frame kernel ran
     once per view the sweep plan accepts and the sweep kernel ran for the
     views it rejects, that the frames are finite and not trivially empty,
     and that a frame rendered per ray agrees with the same frame rendered
     whole;
  4. time the kernels, their plain versions, whole 800^2 frames and one
     view the plan rejects, rendered per ray.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without a result
line when there is no CUDA device or the port's package is not beside this
file.
"""

import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic", "fixture_lego_sparse.py")
CKPT_DIR = os.path.join(REPO, "logs", "chip_smoke")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# and f32 non-tensor FLOP/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_time(fn, n_iter, warmup=2):
    """Median ms per call over ``n_iter`` calls (CUDA events, warm)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_iter):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(sorted(times)[len(times) // 2])


def host_time(fn, n_iter, warmup=1):
    """Median ms per call of a function that ends in a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(sorted(times)[len(times) // 2])


def psnr(a, b):
    import torch
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return float("inf") if mse == 0 else -10.0 * float(
        torch.log10(torch.tensor(mse)))


class Capture:
    """Wraps a kernel wrapper in its module namespace and keeps the inputs
    of every call (``calls``); the wrapped call still launches (and counts)
    exactly as before."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.orig(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.orig)


# ----------------------------------------------------------------- phase 1

def small_sweep_case(torch, dev):
    g = torch.Generator(device="cpu").manual_seed(SEED)
    s_total, gu, gv, c, n, k = 33, 24, 20, 14, 4096, 2
    slabs = torch.randn((s_total, gu, gv, c), generator=g).to(torch.bfloat16)
    rays = torch.stack([
        torch.rand(n, generator=g) * (s_total / k + 4) - 2,
        torch.rand(n, generator=g) * (gu + 2) - 1,
        torch.rand(n, generator=g) * (gv + 2) - 1,
        (torch.rand(n, generator=g) * 0.7 + 0.3)
        * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0),
        torch.rand(n, generator=g) - 0.5,
        torch.rand(n, generator=g) - 0.5])
    return slabs.to(dev).contiguous(), rays.to(dev).contiguous(), k


def small_frame_case(torch, dev, width=128, f_k0=12, rgb_mode="direct"):
    """Random frame-kernel inputs: 2x2 intermediate tiles, 32 stations."""
    from directvoxgo_tpu_torch.ops.render_frame import S_BLK, TILE
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    s_total, gu, gv, hi, wi, emb = 32, 24, 24, 2 * TILE, 2 * TILE, 27
    dens = torch.randn((s_total, gu, gv), generator=g) * 4.0
    mask = (torch.rand((s_total, gu, gv), generator=g) < 0.85).float()
    d_geo = torch.stack([dens, mask], -1).to(torch.bfloat16)
    d_k0 = torch.randn((s_total, gu, gv, f_k0), generator=g).to(
        torch.bfloat16)
    ur = torch.linspace(-4.0, gu + 3.0, hi)
    vr = torch.linspace(-4.0, gv + 3.0, wi)
    dnorm = 30.0 + torch.rand((hi, wi), generator=g)
    dclip = dnorm * (0.9 + 0.1 * torch.rand((hi, wi), generator=g))
    vd_emb = (torch.rand((hi, wi, emb), generator=g) * 2 - 1).to(
        torch.bfloat16)
    f_mlp = f_k0 - (3 if rgb_mode == "logit_plus_k0" else 0)
    dims = [f_mlp + emb, width, width, 3]
    layers = [((torch.rand((dims[i], dims[i + 1]), generator=g) * 2 - 1)
               / dims[i] ** 0.5, torch.rand(dims[i + 1], generator=g) * 0.2
               - 0.1) for i in range(3)]
    activity = (torch.rand((hi // TILE, wi // TILE, s_total // S_BLK),
                           generator=g) < 0.8).to(torch.int32)
    op, p_ref = -20.0, (s_total - 1) / 2.0
    scalars = [op, gu / 2.0, gv / 2.0, 1.0 / (p_ref - op), 0.0, 0.5,
               -4.6, 0.02, 1e-4, 20.0, 60.0, 1.0]
    scalars = [float(torch.tensor(x, dtype=torch.float32)) for x in scalars]
    to = lambda x: x.to(dev).contiguous()  # noqa: E731
    return dict(d_geo=to(d_geo), d_k0=to(d_k0), vd_emb=to(vd_emb),
                dnorm=to(dnorm), dclip=to(dclip), ur=to(ur), vr=to(vr),
                layers=[(to(w), to(b)) for w, b in layers], scalars=scalars,
                activity=to(activity), has_mlp=True, rgb_mode=rgb_mode)


def check_sweep(ka, slabs, rays, k, what, nonempty=False):
    import torch
    out = ka.sweep_fwd(slabs, rays, k)
    torch.cuda.synchronize()
    ref = ka.sweep_fwd_plain(slabs, rays, k)
    err = float((out - ref).abs().max())
    share = float((ref != 0).float().mean())
    log(f"[phase 1] K-A sweep_fwd {what}: S={slabs.shape[0]} "
        f"slab={tuple(slabs.shape[1:])} N={rays.shape[1]} "
        f"max|kernel-plain|={err:.3e} nonzero share={share:.4f}")
    if not err <= 1e-2:
        raise AssertionError(f"K-A {what}: max abs err {err} > 1e-2")
    if nonempty and share == 0.0:
        raise AssertionError(f"K-A {what}: every sample is zero")
    return err


def check_frame(kb, case, what, empty_check=False):
    import torch
    args = dict(case)
    rgb, depth, tcum = kb.render_frame(**args)
    torch.cuda.synchronize()
    stats = {}
    r_p, d_p, t_p = kb.render_frame_plain(**args, stats=stats)
    p = psnr(rgb, r_p)
    d_err = float(((depth - d_p).abs()
                   / torch.clamp(d_p.abs(), min=1.0)).max())
    t_err = float((tcum - t_p).abs().max())
    share = float((t_p < 0.5).float().mean())
    log(f"[phase 1] K-B render_frame {what}: S={case['d_geo'].shape[0]} "
        f"slab={tuple(case['d_geo'].shape[1:3])} "
        f"inter={tuple(case['dnorm'].shape)} rgb PSNR={p:.2f} dB "
        f"depth rel err={d_err:.3e} T err={t_err:.3e} "
        f"visible samples={stats['visible_samples']} T<0.5 share={share:.4f}")
    if not (p >= 55.0 and d_err <= 1e-2 and t_err <= 1e-3):
        raise AssertionError(f"K-B {what}: PSNR {p}, depth {d_err}, T {t_err}")
    if empty_check and not 0.01 <= share <= 0.95:
        raise AssertionError(f"K-B {what}: T<0.5 share {share} outside "
                             "[0.01, 0.95] (trivially empty or full frame)")
    err = max(float((rgb - r_p).abs().max()), t_err)
    return err, stats["visible_samples"]


# ----------------------------------------------------------------- phase 2

def build_checkpoint(torch, dev, num_voxels=None):
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data.synthetic import teacher_grids
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    from directvoxgo_tpu_torch.ops import grid as grid_ops
    cfg = Config.fromfile(CONFIG)
    kw = dict(cfg.fine_model_and_render)
    num_voxels = num_voxels or kw.pop("num_voxels")
    kw.pop("num_voxels", None)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    model = DirectVoxGO(xyz_min=[-1.0] * 3, xyz_max=[1.0] * 3,
                        num_voxels=num_voxels, device=dev, generator=gen,
                        **kw)
    dens, _ = teacher_grids(128, "lego")
    dens = torch.nn.functional.interpolate(
        torch.as_tensor(dens)[None, None], size=model.world_size,
        mode="trilinear", align_corners=True)[0, 0]
    with torch.no_grad():
        model.density.copy_(dens.to(dev))
        model.k0.copy_(torch.randn(model.k0.shape, generator=gen).to(dev))
        alpha = model.activate_density(grid_ops.max_pool3d_same(
            model.density))
        model.mask.copy_(alpha >= 1e-3)
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "fine_lego_random.tar")
    ckpt_lib.save_model_checkpoint(path, model, 0, compact=True)
    log(f"[phase 2] checkpoint {path}: world_size {model.world_size}, "
        f"k0 {model.k0_dim}, MLP {[l.in_features for l in model.rgbnet.layers]}"
        f"->3, occupied {float(model.mask.float().mean()):.4f}")
    return path


# ----------------------------------------------------------------- main

def run(dev):
    import numpy as np
    import torch
    from directvoxgo_tpu_torch.ops import _build
    from directvoxgo_tpu_torch.ops import render_frame as kb
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    from directvoxgo_tpu_torch.ops import sweep_fwd as ka
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    logs = _build.build_all()
    for name, text in logs.items():
        log(f"[phase 0] nvcc {name}.cu:\n{text.strip()}")
    log(f"[phase 0] built {list(logs)} in {time.time() - t0:.1f} s")

    errs = {}
    slabs, rays, k = small_sweep_case(torch, dev)
    errs["sweep_fwd"] = check_sweep(ka, slabs, rays, k, "small")
    for rgb_mode, f_k0, width in (("direct", 12, 128),
                                  ("logit_plus_k0", 12, 64)):
        case = small_frame_case(torch, dev, width, f_k0, rgb_mode)
        errs["render_frame"] = max(errs.get("render_frame", 0.0), check_frame(
            kb, case, f"small {rgb_mode} width {width}")[0])

    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import render as render_lib
    from directvoxgo_tpu_torch.engine import render_sweep
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO

    ckpt = build_checkpoint(torch, dev)

    # Phase 3: the main path, through the entry point.
    cfg = Config.fromfile(CONFIG)
    data = load_everything(None, cfg)
    model = ckpt_lib.load_model(DirectVoxGO, ckpt, device=dev)
    i_test = data["i_test"]
    accepted = [int(i) for i in i_test if render_sweep.plan_camera_sweep(
        model, 400, 400, data["Ks"][i], data["poses"][i], data["near"],
        data["far"]) is not None]
    rejected = [int(i) for i in i_test if int(i) not in accepted]
    log(f"[phase 3] test views {list(map(int, i_test))}: plan accepts "
        f"{accepted}, rejects {rejected}")
    cap_b = Capture(render_sweep, "render_frame")
    cap_a = Capture(sweep_ops, "sweep_fwd")
    ka.launches = kb.launches = 0
    t0 = time.time()
    try:
        run_lib.main(["--config", CONFIG, "--render_only", "--render_test",
                      "--ft_path", ckpt, "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        cap_a.restore()
        cap_b.restore()
    launches = {"sweep_fwd": ka.launches, "render_frame": kb.launches}
    log(f"[phase 3] run.main rendered {len(i_test)} views in "
        f"{time.time() - t0:.1f} s; launches {launches}")
    if launches["render_frame"] != len(accepted):
        raise AssertionError(f"K-B ran {launches['render_frame']} times for "
                             f"{len(accepted)} accepted views")
    if not rejected or launches["sweep_fwd"] < 1:
        raise AssertionError("K-A did not run for a rejected view "
                             f"(rejected {rejected}, {launches['sweep_fwd']} "
                             "launches)")
    savedir = os.path.join(cfg.basedir, cfg.expname,
                           "render_test_fine_lego_random")
    pngs = sorted(f for f in os.listdir(savedir) if f[0].isdigit())
    if len(pngs) != len(i_test):
        raise AssertionError(f"expected {len(i_test)} frames, got {pngs}")

    # Phase 1 at the main path's shapes, on the captured inputs.
    # The middle chunk of the rejected view: rays through the object.
    s_args = cap_a.calls[len(cap_a.calls) // 2][0]
    errs["sweep_fwd"] = max(errs["sweep_fwd"], check_sweep(
        ka, *s_args, "main path", nonempty=True))
    f_case = dict(zip(("d_geo", "d_k0", "vd_emb", "dnorm", "dclip", "ur",
                       "vr", "layers", "scalars", "activity"),
                      cap_b.calls[0][0]), **cap_b.calls[0][1])
    err_b, _ = check_frame(kb, f_case, "main path 400^2", empty_check=True)
    errs["render_frame"] = max(errs["render_frame"], err_b)

    # End-to-end agreement: one accepted view rendered per ray (K-A) and as
    # a whole frame (K-B) - different quadrature, same radiance field.
    rk = {"near": data["near"], "far": data["far"], "bg": 1.0,
          "stepsize": cfg.fine_model_and_render.stepsize, "inverse_y": False}
    v = accepted[0]
    K, c2w = data["Ks"][v], data["poses"][v]
    rgb_f, _ = render_sweep.render_frame_sweep(model, 400, 400, K, c2w, rk)
    from directvoxgo_tpu_torch import rays as ray_lib
    ro, rd, vd = ray_lib.get_rays_of_a_view(400, 400, K, c2w, False, False,
                                            False, False)
    rgb_r, _ = render_lib.render_rays_chunked(
        render_lib.make_render_fn(model, rk), model, ro.reshape(-1, 3),
        rd.reshape(-1, 3), vd.reshape(-1, 3), 8192)
    if not (rgb_f.shape == (400, 400, 3) and np.isfinite(rgb_f).all()
            and np.isfinite(rgb_r).all()):
        raise AssertionError(f"view {v}: frame of shape {rgb_f.shape} or "
                             "per-ray pixels not finite")
    p_fr = psnr(torch.as_tensor(rgb_f.reshape(-1, 3)),
                torch.as_tensor(rgb_r))
    log(f"[phase 3] view {v}: whole-frame vs per-ray PSNR {p_fr:.2f} dB")
    if not p_fr > 30.0:
        raise AssertionError(f"frame vs per-ray PSNR {p_fr} <= 30 dB")

    # Phase 4: timing at 800^2.
    K2 = K.copy()
    K2[:2, :3] *= 2.0
    cap_b = Capture(render_sweep, "render_frame")
    try:
        render_sweep.render_frame_sweep(model, 800, 800, K2, c2w, rk)
    finally:
        cap_b.restore()
    f800 = dict(zip(("d_geo", "d_k0", "vd_emb", "dnorm", "dclip", "ur",
                     "vr", "layers", "scalars", "activity"),
                    cap_b.calls[0][0]), **cap_b.calls[0][1])
    stats = {}
    kb.render_frame_plain(**f800, stats=stats)
    ms_b = cuda_time(lambda: kb.render_frame(**f800), 10)
    plain_b = cuda_time(lambda: kb.render_frame_plain(**f800), 3, warmup=1)
    frame_ms = host_time(lambda: render_sweep.render_frame_sweep(
        model, 800, 800, K2, c2w, rk), 5)
    ms_a = cuda_time(lambda: ka.sweep_fwd(*s_args), 20)
    plain_a = cuda_time(lambda: ka.sweep_fwd_plain(*s_args), 3, warmup=1)
    lib_a = cuda_time(grid_sample_call(torch, *s_args), 20)
    # A view the sweep plan rejects, rendered per ray through
    # render_viewpoints as run.py calls it (20 chunks of 8192 rays at 400^2).
    r = rejected[0]
    rk_view = dict(rk, render_depth=True)
    rays_view_ms = host_time(lambda: render_lib.render_viewpoints(
        model, data["poses"][[r]], np.array([[400, 400]]), data["Ks"][[r]],
        False, rk_view, verbose=False), 3)

    # Bounds from this run's inputs: what the function must read and write
    # once, and the operations this run's data needs (see PERF.md).
    slabs, rays, k = s_args
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    vox_a = sweep_voxels(torch, slabs, rays, k)
    bytes_a = vox_a * c * slabs.element_size() + rays.numel() * 4 \
        + s_total * c * n * 4
    ops_a = s_total * n * (4 * c * 2 + 16)
    bound_a = max(bytes_a / HBM_BPS, ops_a / F32_FLOPS) * 1e3
    by_a = "bytes" if bytes_a / HBM_BPS >= ops_a / F32_FLOPS else "operations"
    hi, wi = f800["dnorm"].shape
    width = f800["layers"][1][0].shape[0]
    emb = f800["vd_emb"].shape[-1]
    f_mlp = f800["layers"][0][0].shape[0] - emb
    f_k0 = f800["d_k0"].shape[-1]
    bytes_b = (stats["geo_voxels"] * 2 * 2                 # density, mask
               + stats["k0_voxels"] * f_k0 * 2
               + stats["visible_pixels"] * emb * 2         # vd_emb
               + stats["live_pixels"] * 2 * 4              # dnorm, dclip
               + (hi + wi) * 4 + f800["activity"].numel() * 4
               + sum(w.numel() * 2 + b.numel() * 4 for w, b in f800["layers"])
               + hi * wi * 5 * 4)                          # rgb, depth, T
    mlp_flops = 2 * (stats["visible_samples"] * (f_mlp * width
                                                 + width * width + 3 * width)
                     + stats["visible_pixels"] * emb * width)
    geo_flops = stats["live_samples"] * 40
    t_ops_b = mlp_flops / BF16_FLOPS + geo_flops / F32_FLOPS
    bound_b = max(bytes_b / HBM_BPS, t_ops_b) * 1e3
    by_b = "bytes" if bytes_b / HBM_BPS >= t_ops_b else "operations"
    log(f"[phase 4] 800^2 frame: inter {hi}x{wi}, S={f800['d_geo'].shape[0]},"
        f" {stats}; K-B {ms_b:.4f} ms, plain {plain_b:.1f} ms, whole frame "
        f"{frame_ms:.2f} ms; K-B bound {bound_b:.5f} ms ({by_b}: "
        f"{bytes_b} bytes, {mlp_flops} MLP + {geo_flops} f32 operations)")
    log(f"[phase 4] K-A {ms_a:.4f} ms (plain {plain_a:.1f}, grid_sample "
        f"{lib_a:.4f}), bound {bound_a:.5f} ms ({by_a}: {bytes_a} bytes, "
        f"{vox_a} slab voxels read); rejected view {r} per ray at 400^2: "
        f"{rays_view_ms:.2f} ms")
    kernels = [
        {"name": "sweep_fwd", "route": "cuda",
         "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
         "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
         "launches": launches["sweep_fwd"], "max_abs_err": errs["sweep_fwd"],
         "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a,
         "bound_by": by_a, "library_ms": lib_a,
         "rejected_view_ms": rays_view_ms,
         "shape": f"S={s_total} slab={gu}x{gv}x{c} N={n}"},
        {"name": "render_frame", "route": "cuda",
         "source": "directvoxgo_tpu_torch/csrc/render_frame.cu",
         "replaces": "directvoxgo_tpu/ops/pallas_render4.py:74 and "
                     "directvoxgo_tpu/ops/pallas_render3.py:51",
         "launches": launches["render_frame"],
         "max_abs_err": errs["render_frame"], "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
         "library_ms": None, "frame_ms": frame_ms,
         "shape": f"800^2 frame, intermediate {hi}x{wi}, "
                  f"S={f800['d_geo'].shape[0]}, "
                  f"{stats['visible_samples']} visible samples"},
    ]
    return kernels


def sweep_voxels(torch, slabs, rays, k):
    """Distinct slab voxels that K-A's taps read with a nonzero weight."""
    s_total, gu, gv, _ = slabs.shape
    op, ou, ov, dp, du, dv = rays
    total = 0
    for s in range(s_total):
        t = (s / k - op) / dp
        u, v = ou + t * du, ov + t * dv
        hit = torch.zeros((gu, gv), dtype=torch.bool, device=rays.device)
        for iu in (torch.floor(u), torch.floor(u) + 1):
            for iv in (torch.floor(v), torch.floor(v) + 1):
                ok = ((iu >= 0) & (iu < gu) & (iv >= 0) & (iv < gv)
                      & ((u - iu).abs() < 1) & ((v - iv).abs() < 1))
                hit[iu[ok].long(), iv[ok].long()] = True
        total += int(hit.sum())
    return total


def grid_sample_call(torch, slabs, rays, k):
    """One ``grid_sample`` call computing K-A's function (bilinear, zero
    padding, align_corners) on the same slabs; the sample coordinates are
    prepared outside the timed call."""
    s_total, gu, gv, c = slabs.shape
    op, ou, ov, dp, du, dv = rays
    p = torch.arange(s_total, dtype=torch.float32, device=rays.device) / k
    t = (p[:, None] - op[None]) / dp[None]
    u = ou[None] + t * du[None]
    v = ov[None] + t * dv[None]
    grid = torch.stack([v / (gv - 1) * 2 - 1, u / (gu - 1) * 2 - 1],
                       -1)[:, None]                        # [S, 1, N, 2]
    inp = slabs.permute(0, 3, 1, 2).float().contiguous()   # [S, C, Gu, Gv]
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True)


def main():
    if len(sys.argv) > 1:
        log(f"chip_smoke: takes no arguments, got {sys.argv[1:]}")
        return 2
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    if not os.path.isdir(os.path.join(REPO, "directvoxgo_tpu_torch")):
        log("chip_smoke: the directvoxgo_tpu_torch package is not beside "
            "this script")
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    try:
        kernels = run(torch.device("cuda", 0))
    except Exception:  # report the failed phase, print no result
        traceback.print_exc()
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
