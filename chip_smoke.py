#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (directvoxgo_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which fails the run:
  0. build every CUDA kernel from csrc/ (one nvcc per source, all at once),
     and the first versions of K-A, K-C, K-F, K-B, K-D and K-E
     (csrc/sweep_{fwd,bwd}_v1.cu, csrc/tv_add_grad_first.cu,
     csrc/render_frame_first.cu, csrc/train_fused_{fwd,bwd}_first.cu), the
     yardstick of their redesign; keep each kernel instance's registers and
     spills from ``-Xptxas -v``;
  1. hold each kernel against its plain PyTorch version on the card, at a
     small shape here (the sweep's forward at every count of stations a
     thread and its backward in its global and shared forms, on both
     cotangent layouts, full, segment and per-tile windowed, for every
     channel instance; the fused train step in both colour modes, both
     march directions, full and windowed, T and the gates bit for bit
     against its first version; the TV stencil on whole grids and
     boxes, on its rows and strided paths, bit for bit; the frame kernel in
     every form, MLP width and colour mode, T and depth bit for bit against
     its first version; in the f32 parity mode, a composed-box window
     train step against the clip-box step, an MPI window step with sparse
     TV against the unclipped one, a blocked step against the plain one,
     and an NDC frame as pixel tiles and as windowed chunks against the
     chunked render; every unfused step key kind - an 8-step chunk over a
     clip box, a composed-box window, a blocked step, an MPI window under
     dense and under sparse TV - replayed as a CUDA graph against the same
     steps run eagerly from one state) and at the main paths' full shapes
     after phases 3,
     4, 5, 6 and 7, there on the last call of every form each kernel took
     (K-A's instance and windowing, K-C's shared or global form);
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
     view the plan rejects, rendered per ray; the frame kernel also beside
     its first version, on the geometry alone (no colour grid, no MLP), and
     with the fill of its sample queue;
  5. train coarse then fine at full lego width through
     ``python -m directvoxgo_tpu_torch.run`` (in process) on a config that
     shortens only the iteration counts of
     configs/synthetic/fixture_lego_sparse.py (its steps replayed as CUDA
     graphs, the launch counts counting replays), and check the launch
     counts against the steps and counted views, the share of replayed
     steps, each form on its own channel
     instance of K-A and K-C (launch counts by form), that the fine stage
     drew window classes once its grid passed 1.1 M voxels, finite
     parameters, a rising train PSNR, exact zeros of the density cotangent
     outside the clip box, the checkpoints, and ``--render_test`` of the
     trained model; print the draws by step key at the top grid with their
     median times and the seconds of each bucket build; hold graphed steps
     against eager ones from one state at full width (an 8-step coarse
     chunk, a fine window step at 160^3, a blocked step built from the fine
     pool), with each key's capture seconds, step wall ms, busy ms, idle
     share and host launches graphed and eager; trace three more
     fine steps, and the last window step beside its batch over the clip
     box, and time ``voxel_count_views``; then a few train steps with
     ray-tile v-windows (a side path: no engine draw takes them); then the
     sweep's forward and backward, each against its plain version and
     timed beside its first version and one library call, on the inputs of
     the last call of every form the training run launched (a coarse
     step's, a fine step's, a fine window step's, a counted view's of the
     per-voxel lr);
  6. with ``DVGO_FUSED_TRAIN=1``, train the fine stage again from phase 5's
     coarse checkpoint, same schedule and width, through the fused step
     (kernels K-D and K-E, drawn as same-class ray tiles; the remainder
     re-bucketed into 2D and per-block windows once windows engage), and
     check that both kernels ran once per fused step, K-A and K-C once per
     unfused step (once per block of a blocked one), that at least half
     of the steps where the JAX rule lets steps fuse (grids past 1.1 M
     voxels) were fused and none elsewhere, that re-bucketed remainder
     classes were
     drawn, and that the trained model's test PSNR beats a white frame's
     by 3 dB; print the tile classes, the remainder's share of rays,
     the fused step's time beside phase 5's unfused one and the gated
     samples per step; then both kernels against their plain versions (T
     and the gates against their first versions), and timed beside their
     first versions and their diagnostic forms (without the MLP, without
     K-E's scatters, without K-E's reverse walk), on the inputs of the last
     fused step;
  7. train DirectMPIGO on the forward-facing fern-width fixture
     (configs/synthetic/fixture_ndc_fern.py with only its iteration counts
     cut) through ``python -m directvoxgo_tpu_torch.run`` (in process), up
     to the 352x371x128 grid with dense then sparse TV on every step, and
     check one K-A and one K-C launch per step and two K-F launches (the TV
     stencil: density and k0) per TV step, replays counted, the share of
     replayed steps, graphed window steps against eager ones at the top
     grid under dense and under sparse TV, that the steps past 1.1 M
     voxels drew 2D window classes, finite parameters, a rising train
     PSNR, the checkpoint, and ``--render_test`` of the three 756x1008 test
     views (as windowed pixel tiles) against an all-black frame; print the
     draws by step key, the median step at the top grid, the stage time,
     the seconds of each bucket build, a trace of top-grid window steps
     beside their batches over the clip box, and one view's time as tiles,
     as windowed chunks and as plain chunks; then K-F in every form and
     path the run launched, K-A on a step of each path form and on a
     render tile, and K-C on a step of each path form, each against its
     plain version and timed;
  8. run the frame-kernel harness (``python -m
     directvoxgo_tpu_torch.tools.bench_framekernel``, in process): check
     (three colour modes at 128x256, S=32, 48x40 slabs; v1 against v3, v3
     against v4, and every form's kernel against its plain version) and
     perf (v3, v3+gate, v4, v4+gate, v3+gate geo-only, v1 at 1024^2,
     S=192, 160x160 slabs, F 12, W 128, occupancy 0.05), then the op probe
     (``directvoxgo_tpu_torch.tools.probe_ops``: eleven op classes and the
     null body through K-G, each digest against its plain version, per-op
     cost against its bound and one library call), and check that K-B ran
     in its v1, v3 and v4 forms and K-G for every class; then the v1, v3
     and v4 forms against their plain and first versions at the bench
     shape, timed with their layout adapters apart;
  9. the gather path (``query_mode='gather'``, the reference-faithful
     point sampling in plain f32 PyTorch): (a) train lego coarse then fine
     through ``python -m directvoxgo_tpu_torch.run`` (in process) on a
     config that sets ``query_mode`` and cuts only the iteration counts of
     configs/synthetic/fixture_lego_sparse.py (3000 coarse steps with the
     exact view count, 300 fine through four rescales to 160^3), then
     ``--render_test``; check that no K-A to K-E launch happened, that the
     gather key was replayed as a CUDA graph, a rising train PSNR, finite
     parameters, that the 4 test views went per ray and beat a white
     frame; print the exact count's seconds and its freeze mask against
     the sweep form's on the same rays (agreement at least 0.97, IoU), the
     median gather step at 160^3 with its trace, one 800^2 view per ray and
     the peak memory; (d) a few grid-LIIF steps (``feat_unfold``) at 160^3
     on the trained grid, their time and peak memory; (b) train
     DirectMPIGO on fern (configs/synthetic/fixture_ndc_fern.py with
     ``query_mode`` set and its iteration counts cut) to 352x371x128 with
     dense then sparse TV on every step, check two K-F launches a step and
     no other kernel's, replays counted, the rising PSNR and the test views
     per ray against an all-black frame; K-F's whole-grid forms of those
     steps against their plain versions, timed; (c) one gather step per
     colour mode (coarse, fine direct and not, ``posbase_pe``,
     ``rgbnet_full_implicit``, grid-LIIF with and without ``feat_unfold``)
     on the card and on the CPU from one state (loss 1e-5 relative,
     parameters 1e-5 of their scale), and graphed gather steps against
     eager ones;
 10. the conditioned and multi-scene drivers, in process, on configs under
     logs/chip_smoke/ that take each task's config (configs/tri_default.py,
     sr_default.py, multiscene_default.py, tri_multiscene_default.py: their
     widths) with fixture_lego_sparse.py's data and cut only iteration
     counts and pg_scale: (a) ``run_tri``: 2000 DirectVoxGO coarse steps
     through the sweep (K-A and K-C once per step and per counted view),
     300 TriDVGO fine steps through four rescales to 160^3 with ``down``
     drawn in [2, 16), ``--render_test``; the median fine step at the top
     grid with its trace, EDSR's encode of 3 views at down 1, 2, 4 and 15,
     the area resize, peak memory, ms per test view; (b) ``run_sr`` on LR
     views made by the area resize at down 4 (coarse on them through K-A
     and K-C, SRDVGO fine, eval); (c) ``run_multiscene``'s implicit model
     (NeRF MLP 8 x 256, mip-NeRF density) for 60 fine steps on (a)'s
     coarse occupancy, one test view (its PSNRs reported, not held to a
     rise or to the white frame: at the config's lr it does not train);
     (d) ``run_tri_multiscene_v2`` on two
     scenes (the fixture, and its views with the RGB channels permuted):
     the joint DirectVoxGOMultiScene coarse stage (gather, no kernel),
     TriDVGOMultiScene with consistency and cosine losses, eval per scene,
     then 20 steps of the v1 driver (lazy pools, prefetch thread) resumed
     from it; each fine stage launches no K-A to K-E and keeps finite
     parameters, and but for (c)'s its train PSNR rises and its test
     views beat a white frame; (e) one train step of each conditioned
     model and mode on the card (TF32 off) and on the CPU from one state
     (loss 1e-5 relative, parameters 1e-5 of their scale), and the
     difference at full width with the TF32 convolutions the drivers
     train with;
 11. the remaining loaders, the frame outputs and the driver's flags, with
     ``imageio``, ``cv2`` and ``PIL`` blocked for (a)-(d): (a) write the
     lego fixture's views (400^2, 40/2/4) under logs/chip_smoke/scenes/ as
     an NSVF, BlendedMVS, Tanks&Temples, DeepVoxels (views resampled to its
     512^2 target: loaded, not trained) and CO3D scene (masks, NDC
     intrinsics, every other view cropped with its principal point moved);
     (b) load each through ``load_everything`` and the config of configs/
     its layout's (paths replaced): the 8-bit views exactly, poses and K to
     1e-6, each view's rays against the fixture's at the same pixels to
     1e-5; (c) train configs/nsvf/Bike.py (no coarse stage),
     tankstemple/Barn.py and co3d/donut_369_40208_78816.py at full width
     through ``python -m directvoxgo_tpu_torch.run`` (in process; only the
     datadir, the iteration counts and ``pg_scale`` cut): K-A and K-C once
     per step and counted view, the draws past 1.1 M voxels, a rising
     train PSNR, ``--render_test`` above the background frame with K-B
     once per view the frame plan accepts, and a whole frame against the
     same view per ray (the CO3D cameras on the Tanks&Temples model); (d)
     ``run_tri_multiscene_v2`` on two NSVF scenes through the multi-scene
     NSVF dataset; (e) the 800^2 lego frame as ``device_compact`` (bit for
     bit) and ``device_yuv420`` (against its conversion in float64) with
     ms and bytes per frame, the export flags on phase 5's checkpoints,
     ``--profile_dir`` (its trace names K-A and K-C) and the ground truth
     of an uncached fixture key rendered on the card (a small key against
     the CPU at 1e-5);
 12. data parallelism, the scan frame core and the watchdog: (a) an NCCL
     group of one rank on the card (its all-reduce, captured in a CUDA
     graph, returns its input bit for bit), phase 5's 8-step coarse chunk
     and top-grid fine window steps through the data-parallel step,
     replayed as CUDA graphs with the all-reduce captured, against the
     same graphed steps without a group from one state (the first step bit
     for bit, every step within the graph checks' bounds, a second plain
     run as the noise floor of K-C's run-to-run sums), ms per step of
     each; (b) two spawned gloo ranks sharing the card with CUDA tensors:
     4 window steps, 4 gather steps and one fused step
     (``DVGO_FUSED_TRAIN=force``) of phase 5's top-grid fine model, both
     ranks bit for bit equal and against one rank at
     tests/test_parallel.py's bars (loss 1e-5, parameters rtol 1e-2 /
     atol 5e-4), or gloo's refusal of CUDA tensors reported; (c) the
     800^2 lego frame through ``render_frame_sweep(backend="scan")``
     against K-B's (>= 55 dB rgb, depth within 1e-2), both timed; (d)
     children with ``DVGO_FETCH_WATCHDOG=2`` whose pull waits behind a
     spinning kernel, or who sleep inside the guard, exit 17, and one
     whose guard ends in time does not. Alone: ``python3 -c "import
     chip_smoke; chip_smoke.phase12_alone()"`` (with phase 5, ~5 min).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line (one
entry per kernel and form, each with the launches of the path it belongs
to; ``[conditioned coarse]`` entries for K-A and K-C on phase 10's coarse
stages; ``[loaders]`` entries for K-A, K-C and K-B on phase 11's runs;
``[data parallel]`` entries for K-A and K-C on phase 12's NCCL steps;
those of K-A, K-C, K-F, K-B, K-D and K-E also with their first
version's device time on the same inputs, ``prev_ms``, and the instance's
registers and spills) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a result line
when there is no CUDA device or the port's package is not beside this
file.
"""

import collections
import json
import math
import os
import re
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


# Clock cycles of the spin that keeps the stream busy ahead of a timed call
# (about 1 ms): the host's dispatch of the call overlaps it.
BUSY_CYCLES = 2_000_000


def cuda_time(fn, n_iter, warmup=2, device_only=False):
    """Median ms per call over ``n_iter`` calls (CUDA events, warm). With
    ``device_only`` the stream spins (``torch.cuda._sleep``) before the
    first event of each call, so the events time the call's device work
    and not the host's dispatch of it (Python, allocation, ctypes), as
    long as the dispatch takes less than the spin."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_iter):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(BUSY_CYCLES)
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
    """Wraps a function in its module namespace and keeps the inputs of
    every call (``calls``; only the last ``keep`` when given) and, with
    ``results``, what it returned; the wrapped call still launches (and
    counts) exactly as before. With ``form`` (a function of the call's
    arguments naming its form) it keeps instead the last call of every
    form (``forms``) and how many calls each form had (``counts``)."""

    def __init__(self, module, name, keep=None, results=False, form=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = collections.deque(maxlen=keep)
        self.results = [] if results else None
        self.form, self.forms = form, {}
        self.counts = collections.Counter()
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        import torch
        # A call made while a train step is captured as a CUDA graph counts
        # (per replay, with PerReplay) but keeps no inputs: they lie in the
        # graphs' shared pool, where other graphs' replays overwrite them.
        # Every step key's first call, which keeps them, is eager.
        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        if self.form is None:
            if not capturing:
                self.calls.append((args, kw))
        else:
            form = self.form(*args, **kw)
            if not capturing or form not in self.forms:
                self.forms[form] = (args, kw)
            self.counts[form] += 1
        out = self.orig(*args, **kw)
        if self.results is not None:
            self.results.append(out)
        return out

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


FRAME_RGB_TOL = 1e-3   # bench_framekernel.KERNEL_TOL["rgb"]


def frame_form(torch, case, form, has_mlp=True):
    """``render_frame``'s keyword arguments for ``form`` ("v4", "v3" or
    "v1") of a small case made for v4 (view embedding, layer 1 with its
    view half and bias): v3 and v1 take ``shared1 = bf16(emb . bf16(w1b) +
    b1)`` and layer 1's feature half, v1 contracts k0 u first. Without an
    MLP only the k0 order differs between the forms."""
    f = dict(case)
    if not has_mlp:
        f.update(vd_emb=None, layers=None, has_mlp=False)
    elif form != "v4":
        (w1, b1), l2, l3 = f["layers"]
        emb = f["vd_emb"]
        f_mlp = w1.shape[0] - emb.shape[-1]
        w1b = w1[f_mlp:].to(torch.bfloat16).float()
        f["shared1"] = (emb.float() @ w1b + b1).to(torch.bfloat16)
        f.update(vd_emb=None, layers=[(w1[:f_mlp], None), l2, l3])
    f["k0_order"] = "u_first" if form == "v1" else "v_first"
    return f


def hold_frame(torch, kb, f, what):
    """K-B on the frame ``f`` against its plain version (rgb within
    ``FRAME_RGB_TOL`` and at least 55 dB) and its first version (T and
    depth bit for bit, since the march and its rounding are the same);
    returns the largest |rgb| difference from the plain version."""
    rgb, depth, tcum = kb.render_frame(**f)
    r_f, d_f, t_f = prev_frame_call(torch, f)()
    torch.cuda.synchronize()
    r_p, d_p, t_p = kb.render_frame_plain(**f)
    err = float((rgb - r_p).abs().max())
    p = psnr(rgb, r_p)
    same = bool(torch.equal(tcum, t_f)) and bool(torch.equal(depth, d_f))
    log(f"[phase 1] K-B {what}: rgb max|kernel-plain|={err:.3e} "
        f"PSNR={p:.2f} dB, T err {float((tcum - t_p).abs().max()):.3e}, "
        f"T and depth equal to the first version: {same}, rgb "
        f"max|kernel-first|={float((rgb - r_f).abs().max()):.3e}")
    if not (err <= FRAME_RGB_TOL and p >= 55.0 and same):
        raise AssertionError(f"K-B {what}: rgb err {err}, PSNR {p}, T and "
                             f"depth equal to the first version {same}")
    return err


def small_frame_checks(torch, dev, kb):
    """K-B in every form (v4, v3, v1) x MLP width (32, 64, 128) x colour
    mode (direct, logit_plus_k0), and without an MLP (both k0 orders, and
    without a colour grid), each held by :func:`hold_frame`."""
    worst, n = 0.0, 0
    for rgb_mode in ("direct", "logit_plus_k0"):
        for width in (32, 64, 128):
            case = small_frame_case(torch, dev, width, 12, rgb_mode)
            for form in ("v4", "v3", "v1"):
                worst = max(worst, hold_frame(
                    torch, kb, frame_form(torch, case, form),
                    f"small {form} {rgb_mode} width {width}"))
                n += 1
        for form in ("v3", "v1"):
            worst = max(worst, hold_frame(
                torch, kb, frame_form(torch, case, form, has_mlp=False),
                f"small {form} {rgb_mode} no MLP"))
            n += 1
    geo = dict(frame_form(torch, case, "v4", has_mlp=False), d_k0=None,
               rgb_mode="direct")
    worst = max(worst, hold_frame(torch, kb, geo, "small, no colour grid"))
    log(f"[phase 1] K-B: {n + 1} small cases, largest rgb error {worst:.3e}")
    return worst


def frame_numbers(torch, kb, f, n_iter, geo=False):
    """K-B on the frame ``f``: device ms beside its first version's (same
    inputs, same call), the instance's registers and spills (and the first
    version's), its form and the mean fill of its sample queue per flush;
    with ``geo`` also both versions on the geometry alone (no colour grid,
    no MLP: what is left of the frame without the colour path)."""
    prev_call = prev_frame_call(torch, f)
    prev = cuda_time(prev_call, n_iter, device_only=True)
    ms = cuda_time(lambda: kb.render_frame(**f), n_iter, device_only=True)
    prev_again = cuda_time(prev_call, n_iter, device_only=True)
    torch.cuda.synchronize()
    kb.queue_stats(enable=True)
    kb.render_frame(**f)
    torch.cuda.synchronize()
    queue = kb.queue_stats(enable=False)
    width = f["layers"][1][0].shape[0] if f["has_mlp"] else 32
    shared1 = f["has_mlp"] and f.get("shared1") is not None
    u_first = f.get("k0_order", "v_first") == "u_first"
    if not f["has_mlp"]:
        shared1 = u_first
    nums = {"ms": ms, "prev_ms": min(prev, prev_again),
            "prev_ms_runs": [prev, prev_again],
            "form": kb._form(f.get("shared1"), f.get("k0_order", "v_first")),
            **kernel_usage("render_frame", "render_frame_kernel", width,
                           shared1, u_first),
            "prev_usage": kernel_usage("render_frame_first",
                                       "render_frame_kernel", width,
                                       shared1, u_first),
            "queue": queue}
    if geo:
        g = dict(f, d_k0=None, vd_emb=None, layers=None, shared1=None,
                 has_mlp=False, rgb_mode="direct")
        g_prev = prev_frame_call(torch, g)
        nums["prev_geo_ms"] = cuda_time(g_prev, n_iter, device_only=True)
        nums["geo_ms"] = cuda_time(lambda: kb.render_frame(**g), n_iter,
                                   device_only=True)
    return nums


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


# ------------------------------------------- phase 1: the sweep's backward

TRAIN_CONFIG = os.path.join(CKPT_DIR, "train_lego.py")
# Iteration counts of the training phase (the base config's are 5000 and
# 20000 with pg_scale [1000, 2000, 3000, 4000]); everything else is the
# lego schedule: N_rand 8192, per-voxel lr, in_maskcache sampling. The
# coarse stage keeps 3000 steps: from alpha_init 1e-6 at lr 0.1 its PSNR
# only leaves the white frame's after some 1500 steps, and a shorter stage
# hands the fine stage an empty occupancy mask.
N_COARSE, N_FINE, PG_SCALE = 3000, 600, [100, 200, 300, 400]
CLIP_QUANTUM = 16       # voxels the clip box sizes round up to
MIN_TOP_STEPS = 100     # fine steps at the final resolution, at least
TRAIN_BASE = '../../configs/synthetic/fixture_lego_sparse.py'


def small_bwd_case(torch, dev, c, k):
    """Rays over a 10 x 12 x 40 grid (two 512-ray tiles), a cotangent of
    which 70% is exactly zero, and windows for the three forms."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    gp, gu, gv, n = 10, 12, 40, 1024
    s_total = k * (gp - 1) + 1
    rays = torch.stack([
        torch.rand(n, generator=g) * (gp + 4) - 2,
        torch.rand(n, generator=g) * (gu + 2) - 1,
        torch.rand(n, generator=g) * (gv + 2) - 1,
        (torch.rand(n, generator=g) * 0.7 + 0.3)
        * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0),
        torch.rand(n, generator=g) - 0.5,
        torch.rand(n, generator=g) - 0.5])
    rays[3, :7] = 1e-10        # rays parallel to the stations: huge t
    cot = torch.randn((s_total, c, n), generator=g) * (
        torch.rand((s_total, 1, n), generator=g) < 0.3)
    forms = {"full": (None, 0),
             "tile": (torch.tensor([0, 16], dtype=torch.int32), 16),
             "segment": (torch.tensor([0, 16, 8], dtype=torch.int32), 24)}
    forms = {f: (None if vb is None else vb.to(dev), wv)
             for f, (vb, wv) in forms.items()}
    return (rays.to(dev).contiguous(), cot.to(dev).contiguous(),
            (gp, gu, gv, c), forms)


def check_bwd(kc, g, rays, k, shape, dtype, v_base, wv, what):
    """K-C against its plain version: the f32 accumulator within ``tol`` =
    1e-5 of the plain sum's largest entry (f32 atomics sum in another
    order); the output in the grid dtype within one bf16 ulp of the value on
    top of that (a sum that nearly cancels keeps the absolute error of its
    summands; f32 grids: ``tol`` again); zeros exactly where the plain
    version has zeros. A voxel sums up to N*(2k-1) terms one after another
    in f32, and the rounding of such a sum grows with the square root of
    their number (the plain version's matrix product sums in blocks): 1e-5
    covers batches of up to 8192 rays, and a counted view's 160,000 rays
    get 2e-5 * sqrt(N / 8192)."""
    import torch
    n = g.shape[2]
    tol = 1e-5 if n <= 8192 else 2e-5 * (n / 8192) ** 0.5
    acc = kc.sweep_bwd(g, rays, k, shape, dtype, v_base, wv,
                       out_dtype=torch.float32)
    out = kc.sweep_bwd(g, rays, k, shape, dtype, v_base, wv)
    torch.cuda.synchronize()
    ref = kc.sweep_bwd_plain(g, rays, k, shape, dtype, v_base, wv)
    scale = float(ref.abs().max())
    err = float((acc - ref).abs().max())
    zeros_differ = int(((acc == 0) != (ref == 0)).sum())
    ref_out = ref.to(dtype).float()
    if dtype == torch.bfloat16:
        ulp_ok = bool(((out.float() - ref_out).abs()
                       <= 2.0 ** -7 * ref_out.abs() + tol * scale).all())
    else:
        ulp_ok = float((out - ref_out).abs().max()) <= tol * scale
    log(f"[phase 1] K-C sweep_bwd {what}: g={tuple(g.shape)} grid="
        f"{tuple(shape)} {str(dtype).split('.')[-1]} wv={wv} max|kernel-"
        f"plain|={err:.3e} of {scale:.3e} (allowed {tol:.2e} of it), zero "
        f"pattern differs at "
        f"{zeros_differ}, output within one ulp: {ulp_ok}, nonzero voxels "
        f"{float((ref != 0).float().mean()):.4f}")
    if not (scale > 0 and err <= tol * scale and zeros_differ == 0
            and ulp_ok and bool(torch.isfinite(acc).all())):
        raise AssertionError(f"K-C {what}: err {err} of {scale}, zero "
                             f"pattern differs at {zeros_differ}, ulp "
                             f"{ulp_ok}")
    return err


def check_sweep_rel(ka, slabs, rays, k, v_base, wv, what, zero_slab=False):
    """K-A, full (``wv`` 0) or windowed, against its plain version, channel
    by channel: within 1e-5 of the channel's largest plain value (a trained
    grid's channels differ by orders of magnitude), and exactly zero
    wherever the plain version is (off the slab, outside the window).
    ``zero_slab``: the slabs are all zero (a counted view's), so the output
    must be too."""
    import torch
    out = ka.sweep_fwd(slabs, rays, k, v_base, wv)
    torch.cuda.synchronize()
    ref = ka.sweep_fwd_plain(slabs, rays, k, v_base, wv)
    scale = ref.abs().amax((0, 2))                              # [C]
    err_c = (out - ref).abs().amax((0, 2))
    err = float(err_c.max())
    rel = float((err_c / scale.clamp(min=1e-30)).max())
    stray = int(((ref == 0) & (out != 0)).sum())
    log(f"[phase 1] K-A sweep_fwd {what}: S={slabs.shape[0]} "
        f"slab={tuple(slabs.shape[1:])} {str(slabs.dtype).split('.')[-1]} "
        f"N={rays.shape[1]} wv={wv} max|kernel-plain|={err:.3e}, largest "
        f"share of a channel's max {rel:.3e}, nonzero where plain is zero: "
        f"{stray}, nonzero share={float((ref != 0).float().mean()):.4f}")
    if not (bool((err_c <= 1e-5 * scale).all()) and stray == 0
            and (float(scale.max()) > 0) != zero_slab
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"K-A {what}: max abs err {err}, {rel} of a "
                             f"channel's largest value, {stray} stray "
                             "nonzeros")
    return err


class ForcedForm:
    """Within the block, K-C takes its shared form (``shared``) or its
    global one, whatever its rule would pick (small planes fit either)."""

    def __init__(self, kc, shared):
        self.kc, self.shared = kc, shared

    def __enter__(self):
        self.orig = self.kc.shared_form
        self.kc.shared_form = lambda *a: self.shared

    def __exit__(self, *exc):
        self.kc.shared_form = self.orig


class StationsPerThread:
    """Within the block, K-A takes ``spt`` stations a thread, whatever its
    rule would pick."""

    def __init__(self, ka, spt):
        self.ka, self.spt = ka, spt

    def __enter__(self):
        self.orig = self.ka.stations_per_thread
        self.ka.stations_per_thread = lambda *a: self.spt

    def __exit__(self, *exc):
        self.ka.stations_per_thread = self.orig


# Channel counts and dtypes of the small checks: every channel instance of
# K-A and K-C (14, 5, 11, 1) and the generic one (3).
SMALL_CHANNELS = ((14, "bfloat16"), (1, "float32"), (5, "bfloat16"),
                  (11, "bfloat16"), (3, "bfloat16"), (14, "float32"))


def small_train_kernel_checks(torch, dev, ka, kc, sweep_ops):
    """K-C in its global and its shared form, on a [S, C, N] cotangent and
    on autograd's [C, N, S] layout, full, segment and per-tile windowed;
    K-A full and windowed on contiguous and channel-padded station slabs;
    each for every channel instance, k = 1 and 2, against its plain
    version."""
    errs = {"sweep_bwd": 0.0, "sweep_fwd_windowed": 0.0}
    n_bwd = n_fwd = 0
    for c, dtype in SMALL_CHANNELS:
        dtype = getattr(torch, dtype)
        for k in (1, 2):
            rays, cot, shape, forms = small_bwd_case(torch, dev, c, k)
            cot_cns = cot.permute(1, 2, 0).contiguous().permute(2, 0, 1)
            for form, (vb, wv) in forms.items():
                for layout, g in (("", cot), (", [C, N, S] layout", cot_cns)):
                    for shared in (False, True):
                        with ForcedForm(kc, shared):
                            errs["sweep_bwd"] = max(errs["sweep_bwd"],
                                                    check_bwd(
                                kc, g, rays, k, shape, dtype, vb, wv,
                                f"small {form} C={c} k={k}{layout}, "
                                f"{'shared' if shared else 'global'} form"))
                        n_bwd += 1
            gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
            slabs = sweep_ops._station_slabs(torch.randn(
                shape, generator=gen).to(dtype).to(dev), k).contiguous()
            for form in ("full", "tile"):
                for spt in ka.STATIONS_PER_THREAD_CHOICES:
                    with StationsPerThread(ka, spt):
                        err = check_sweep_rel(
                            ka, slabs, rays, k, *forms[form],
                            f"{form} small C={c} k={k}, {spt} stations a "
                            "thread")
                    n_fwd += 1
                    if form == "tile":
                        errs["sweep_fwd_windowed"] = max(
                            errs["sweep_fwd_windowed"], err)
    log(f"[phase 1] K-C: {n_bwd} small cases, K-A: {n_fwd}; forms launched "
        f"K-A {dict(ka.launches_by_form)}, K-C {dict(kc.launches_by_form)}")
    return errs


# ------------------------------------------ phase 1: the fused train step

# Kernel against plain version, as shares of each tensor's largest entry.
# Values that do not pass through the colour MLP (alphainv_last, the density
# cotangent's dependence on T) agree to f32 rounding of sums taken in another
# order. The MLP's hidden activations are rounded to bf16 in both versions:
# where the two f32 sums (tensor-core tiles here, an f32 matrix product
# there) land on either side of a rounding boundary, one activation moves by
# 2^-8 of itself, which a single sample's colour and cotangents show. Such
# flips are rare, so the mean error stays at f32 level while the largest
# error may reach the first bound.
FUSED_TOL_MAX = 5e-3     # largest error of an MLP-path tensor
FUSED_TOL_MEAN = 5e-5    # mean error of any tensor
FUSED_TOL_EXACT = 2e-5   # largest error off the MLP path (alphainv_last)


def small_fused_case(torch, dev, direct, desc, width, windowed,
                     dead_tile=False):
    """Seeded inputs of the fused kernels on a 12 x 24 x 20 box at k = 2:
    three 512-ray tiles, each aimed at its own spot of the plane (the last
    one missing the box altogether with ``dead_tile``)."""
    from directvoxgo_tpu_torch.ops import train_fused as tf
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    gp, gu, gv, k, nt, n_tiles = 12, 24, 20, 2, 512, 3
    n = nt * n_tiles
    k0_dim = 12
    fdim = k0_dim if direct else k0_dim - 3

    def rand(*shape):
        return torch.rand(shape, generator=g)

    dens = torch.randn((gp, gu, gv), generator=g) * 3.0
    k0 = torch.randn((gp, gu, gv, k0_dim), generator=g)
    mask = (rand(gp, gu, gv) < 0.8).float()
    rays = torch.zeros((16, n))
    sg = -1.0 if desc else 1.0
    for j in range(n_tiles):
        sl = slice(j * nt, (j + 1) * nt)
        cu, cv = 5.0 + 6.0 * j, 4.0 + 5.0 * j
        dp = sg * (rand(nt) * 0.8 + 0.6)
        op = (gp + 2.0 + rand(nt) * 2) if desc else (-3.0 - rand(nt) * 2)
        du = torch.randn(nt, generator=g) * 0.12 * dp.abs()
        dv = torch.randn(nt, generator=g) * 0.12 * dp.abs()
        tm = ((gp - 1) / 2 - op) / dp
        t_a, t_b = (0.8 - op) / dp, (gp - 1.6 - op) / dp
        tlo, thi = torch.minimum(t_a, t_b), torch.maximum(t_a, t_b)
        miss = rand(nt) < (1.0 if dead_tile and j == n_tiles - 1 else 0.05)
        rays[0, sl], rays[3, sl], rays[4, sl], rays[5, sl] = op, dp, du, dv
        rays[1, sl] = cu + torch.randn(nt, generator=g) * 1.5 - tm * du
        rays[2, sl] = cv + torch.randn(nt, generator=g) * 1.5 - tm * dv
        rays[6, sl], rays[7, sl] = tlo, torch.where(miss, tlo - 0.1, thi)
        rays[8, sl] = rand(nt) * 0.7 + 0.3
        rays[9:12, sl] = rand(3, nt)
    dims = [fdim, width, width, 3]
    ws = [(rand(dims[i], dims[i + 1]) * 2 - 1) / dims[i] ** 0.5
          for i in range(3)]
    cfg = tf.FusedCfg(k=k, f=fdim, width=width, act_shift=-4.0, thres=1e-4,
                      bg=1.0, direct=direct, wu=16 if windowed else 0,
                      wv=16 if windowed else 0)
    slabs = tf.build_slabs(dens.to(dev), k0.to(dev), mask.to(dev), k)
    rays = rays.to(dev).contiguous()
    uvb = None
    gu_p, gv_p, wu_e, wv_e, win = tf._window_plan(cfg, gu, gv)
    if win:
        s_pad, p0, pstep = tf.march_scalars(slabs.shape[0], k, cfg.s_blk,
                                            desc)
        uvb, _ = tf.blocktile_uv_bases(rays, p0, pstep, s_pad // cfg.s_blk,
                                       cfg.s_blk, gu_p, gv_p, wu_e, wv_e,
                                       cfg.nt)
    bf = torch.bfloat16
    cot = torch.cat([torch.randn((3, n), generator=g),
                     torch.randn((1, n), generator=g),
                     rand(1, n) * 0.1, torch.zeros((3, n))])
    return dict(
        slabs=slabs, rays16=rays,
        sh1_t=(torch.randn((width, n), generator=g) * 0.5).to(dev),
        w1a=ws[0].to(bf).to(dev), w2=ws[1].to(bf).to(dev),
        b2=(rand(width) * 0.2 - 0.1).to(dev), w3=ws[2].to(bf).to(dev),
        b3=(rand(3) * 0.2 - 0.1).to(dev), desc=desc, uvb=uvb, cfg=cfg, gp=gp,
        cot=cot.to(dev).contiguous())


def _share(torch, got, ref):
    """(largest, mean) |got - ref| as shares of ref's largest entry."""
    scale = float(ref.abs().max())
    diff = (got - ref).abs()
    if scale == 0.0:
        return float(diff.max()), float(diff.mean()), scale
    return float(diff.max()) / scale, float(diff.mean()) / scale, scale


def check_fused(tf, case, what):
    """K-D and K-E against their plain versions on ``case``. Returns the
    largest absolute error of K-D's pack and of K-E's outputs."""
    import torch
    names = ("slabs", "rays16", "sh1_t", "w1a", "w2", "b2", "w3", "b3",
             "desc", "uvb")
    args = [case[k] for k in names]
    cfg, gp = case["cfg"], case["gp"]
    pack = tf.train_fwd(*args, cfg=cfg)
    torch.cuda.synchronize()
    ref = tf.train_fwd_plain(*args, cfg=cfg)
    rows = {"rgb": slice(0, 3), "alphainv_last": slice(3, 4),
            "rgbper_sum": slice(4, 5)}
    msgs, ok = [], bool(torch.isfinite(pack).all())
    for name, sl in rows.items():
        mx, mean, scale = _share(torch, pack[sl], ref[sl])
        tol = FUSED_TOL_EXACT if name == "alphainv_last" else FUSED_TOL_MAX
        ok = ok and mx <= tol and mean <= FUSED_TOL_MEAN and scale > 0
        msgs.append(f"{name} {mx:.2e}/{mean:.2e}")
    ok = ok and not bool(pack[5:].any())
    err_fwd = float((pack - ref).abs().max())
    # T and the gates against the first version, bit for bit: T from pack
    # row 3, the gates from their fingerprint (MODE_GATES: pack rows 5-7,
    # also against the plain version's march).
    first = prev_fused_call(torch, args, cfg, mode=tf.MODE_GATES)()
    gates = tf.train_fwd(*args, cfg=cfg, mode=tf.MODE_GATES)
    torch.cuda.synchronize()
    want_gates = gate_fingerprint(torch, tf, args, cfg)
    same_t = bool(torch.equal(pack[3], first[3]))
    same_gates = bool(torch.equal(gates[5:], first[5:])) and bool(
        torch.equal(gates[5:], want_gates))
    ok = ok and same_t and same_gates and bool(torch.equal(gates[3], pack[3]))
    msgs.append(f"T bit-identical to the first version {same_t}, gates "
                f"({int(want_gates[0].sum())} samples) identical to the "
                f"first and the plain version {same_gates}")
    log(f"[phase 1] K-D train_fwd {what}: slabs {tuple(case['slabs'].shape)}"
        f" N={pack.shape[1]} W={cfg.width} max/mean |kernel-plain| as a "
        f"share of the largest entry: {', '.join(msgs)}")
    if not ok:
        raise AssertionError(f"K-D {what}: {msgs}")

    # K-E takes alphainv_last from the forward it follows.
    cot = case["cot"].clone()
    cot[5] = pack[3]
    b_args = args[:2] + [cot] + args[2:]
    outs = tf.train_bwd(*b_args, cfg=cfg, gp=gp)
    torch.cuda.synchronize()
    refs = tf.train_bwd_plain(*b_args, cfg=cfg, gp=gp)
    onames = ("d_density", "d_k0", "d_sh1", "d_w1a", "d_w2", "d_b2", "d_w3",
              "d_b3")
    msgs, ok, err_bwd = [], True, 0.0
    for name, got, want in zip(onames, outs, refs):
        mx, mean, scale = _share(torch, got, want)
        ok = ok and bool(torch.isfinite(got).all()) and scale > 0 \
            and mx <= FUSED_TOL_MAX and mean <= FUSED_TOL_MEAN
        err_bwd = max(err_bwd, float((got - want).abs().max()))
        msg = f"{name} {mx:.2e}/{mean:.2e}"
        if name in ("d_density", "d_k0"):
            differ = int(((got == 0) != (want == 0)).sum())
            ok = ok and differ == 0
            msg += f" (zero pattern differs at {differ} of " \
                   f"{int((want != 0).sum())} nonzeros)"
        msgs.append(msg)
    log(f"[phase 1] K-E train_bwd {what}: {', '.join(msgs)}")
    if not ok:
        raise AssertionError(f"K-E {what}: {msgs}")
    return err_fwd, err_bwd


def small_fused_checks(torch, dev, tf):
    """Both rgb modes, both march directions, full and windowed, and a
    batch whose last tile misses the box (every cell of it inactive)."""
    errs = {"train_fwd": 0.0, "train_bwd": 0.0}
    for direct, width in ((True, 128), (False, 64), (True, 32)):
        for desc in (False, True):
            for windowed in (False, True):
                dead = windowed and desc
                case = small_fused_case(torch, dev, direct, desc, width,
                                        windowed, dead_tile=dead)
                e_f, e_b = check_fused(
                    tf, case, f"small {'direct' if direct else 'logit+k0'} "
                    f"W={width} {'desc' if desc else 'asc'} "
                    f"{'windowed' if windowed else 'full'}"
                    f"{' dead tile' if dead else ''}")
                errs["train_fwd"] = max(errs["train_fwd"], e_f)
                errs["train_bwd"] = max(errs["train_bwd"], e_b)
    return errs


# ------------------------------------------------ phase 1: the TV stencil

def small_tv_checks(torch, dev, tv):
    """K-F against its plain version and its first version: [X, Y, Z] and
    [X, Y, Z, C] grids, dense and sparse, ``bug_compat`` on and off with
    anisotropic weights, the whole grid and boxes touching 0, 1 and 3 faces
    of it, gradients contiguous and z-major (the sweep's permuted gradient;
    both take the rows path where the run is aligned) and strided (a
    channel slice, as autograd hands them over; a box of the grid's
    gradient: the strided path), at two sizes (the larger spans
    several tiles, rows and x slices of the rows path, with ragged ends).
    Each output bit-identical to the plain version's and to the first
    version's (zeros at the same places, gated elements exactly the
    gradient); both paths must have run."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    n_cases = 0
    small = (None, ((2, 2, 2), (4, 3, 4)), ((0, 2, 2), (4, 3, 4)),
             ((5, 0, 4), (4, 3, 4)), ((2, 2, 4), (4, 3, 4)),
             ((2, 1, 0), (4, 3, 8)))
    large = (None, ((3, 2, 8), (30, 15, 36)), ((0, 5, 3), (37, 14, 45)),
             ((3, 2, 0), (30, 15, 48)))
    dev_paths = collections.Counter()
    for k in tv.launches_by_path:
        tv.launches_by_path[k] = 0
    for shape, boxes in (((9, 7, 8), small), ((9, 7, 8, 3), small),
                         ((37, 19, 48), large), ((37, 19, 48, 9), large)):
        p = (torch.randn(shape, generator=gen) * 0.8).to(dev)
        wide = (*shape[:3], 2 * (shape[3] if len(shape) > 3 else 1))
        g_wide = (torch.randn(wide, generator=gen)
                  * (torch.rand(wide, generator=gen) < 0.4)).to(dev)
        g_strided = (g_wide[..., 1::2] if len(shape) > 3
                     else g_wide[..., 1])
        # z-major: the layout of the sweep's gradient of an MPI grid
        z_major = g_strided.movedim(2, 0).contiguous().movedim(0, 2)
        for bug, g in ((True, g_strided.contiguous()), (False, g_strided),
                       (True, z_major)):
            for dense in (True, False):
                for box in boxes:
                    if box is None:
                        name, g_in = "total_variation_add_grad", g
                        args = (p, g, 0.9, 0.5, 0.2, dense, bug)
                    else:
                        offs, sizes = box
                        g_in = g[tuple(slice(o, o + z) for o, z in
                                       zip(offs, sizes))]
                        if g is not g_strided and g is not z_major:
                            g_in = g_in.contiguous()
                        name = "tv_add_grad_box"
                        args = (p, g_in, offs, 0.9, 0.5, 0.2, dense, bug)
                    out = getattr(tv, name)(*args)
                    first = prev_tv_call(torch, name, args, {})()
                    torch.cuda.synchronize()
                    ref = getattr(tv, name + "_plain")(*args)
                    scale = float((ref - g_in).abs().max())
                    err = float((out - ref).abs().max())
                    off = g_in == 0
                    ok = (scale > 0 and bool(torch.equal(out, ref))
                          and bool(torch.equal(out, first))
                          and bool(((out == 0) == (ref == 0)).all())
                          and (dense or bool(torch.equal(
                              out[off], g_in[off] + 0.0))))
                    if not ok:
                        path = tv.path_of(p, g_in, box[0] if box
                                          else (0, 0, 0))
                        raise AssertionError(
                            f"K-F {shape} bug_compat={bug} dense={dense} "
                            f"box={box} ({path} path): err {err} of "
                            f"{scale}")
                    if box is not None:
                        # the offsets as device data, as a train step
                        # captured as a CUDA graph passes them
                        offs_t = torch.tensor(offs, dtype=torch.int32,
                                              device=dev)
                        args_t = (p, g_in, offs_t) + args[3:]
                        out_t = tv.tv_add_grad_box(*args_t)
                        dev_paths[tv.path_of(p, g_in, offs_t)] += 1
                        if not torch.equal(out_t, out):
                            raise AssertionError(
                                f"K-F {shape} box={box} dense={dense}: "
                                "device offsets differ from host offsets")
                    n_cases += 1
    paths = dict(tv.launches_by_path)
    log(f"[phase 1] K-F tv_add_grad: {n_cases} small cases, each "
        f"bit-identical to its plain and its first version, boxes also "
        f"with device offsets (their paths {dict(dev_paths)}); launches by "
        f"path {paths}")
    if min(paths.values()) < 1 or min(dev_paths.values()) < 1 \
            or len(dev_paths) < 2:
        raise AssertionError(f"K-F small cases missed a path: {paths}, "
                             f"device offsets {dict(dev_paths)}")
    return 0.0


# ------------------------------------------------ phase 1: window draws

# Windowed against unwindowed, at the tolerances of the CPU tests
# (tests/test_torch_windowed_step.py, tests/test_torch_render_windowed.py):
# loss relative and parameters absolute for a composed-box window; loss
# absolute and parameters relative to their scale for the blocked step;
# rgb and depth absolute for the NDC tiles.
WINDOW_TOL = (1e-6, 5e-4)
BLOCKED_TOL = (3e-5, 5e-5)
TILES_TOL = 2e-3


def _f32_model(torch, cls, kw, density, seed, dev):
    """A model of ``cls`` with the density ``density(model)`` (numpy) and
    seeded random colour features and MLP, its occupancy renewed, sweeping
    and running its MLP in f32 (the parity mode)."""
    import numpy as np
    model = cls(**kw, device=dev,
                generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.density.copy_(torch.as_tensor(density(model)))
        model.k0.copy_(torch.as_tensor(rng.normal(
            0, 0.5, tuple(model.k0.shape)).astype(np.float32)))
    model.update_occupancy_cache()
    model.sweep_dtype, model.mlp_dtype = torch.float32, None
    return model


def _blob(centre, radius):
    import numpy as np

    def density(model):
        pts = model.grid_points().cpu().numpy()
        r2 = (((pts - np.asarray(centre)) / radius) ** 2).sum(-1)
        return (16 * np.exp(-2 * r2) - 8).astype(np.float32)
    return density


def _one_step(torch, make, cfg, rk, tv, axis, key, off, pool, sel):
    """One train step of a fresh ``make()`` model: (loss, parameters)."""
    from directvoxgo_tpu_torch.engine import train as train_lib
    model = make()
    opt = train_lib.create_optimizer_or_freeze_model(model, cfg)
    step = train_lib.make_train_step(model, opt, cfg, rk, *tv, axis=axis,
                                     clip_sizes=key)
    loss, _ = step(pool, sel, off)
    return float(loss), [p.detach() for p in model.parameters()]


def _step_pair(torch, what, make, cfg, rk, tv, axis, keys, pool, sel,
               blocked=False):
    """The step of ``keys[0]`` (a window) against that of ``keys[1]`` on
    the same batch from the same parameters."""
    (la, pa), (lb, pb) = (_one_step(torch, make, cfg, rk, tv, axis, key,
                                    off, pool, sel) for key, off in keys)
    d_loss = abs(la - lb)
    d_par = [float((a - b).abs().max()) for a, b in zip(pa, pb)]
    scale = [max(1.0, float(b.abs().max())) for b in pb]
    if blocked:
        ok = d_loss <= BLOCKED_TOL[0] and all(
            d <= BLOCKED_TOL[1] * sc for d, sc in zip(d_par, scale))
    else:
        ok = d_loss <= WINDOW_TOL[0] * max(1.0, abs(lb)) and all(
            d <= WINDOW_TOL[1] for d in d_par)
    log(f"[phase 1] window step {what}: key {keys[0][0]} at "
        f"{keys[0][1].tolist()} against {keys[1][0]}: loss {la:.8f} vs "
        f"{lb:.8f}, largest parameter difference {max(d_par):.3e}")
    if not ok:
        raise AssertionError(f"window step {what}: loss {la} vs {lb}, "
                             f"parameters differ by {d_par}")
    return max(d_par)


def small_window_checks(torch, dev):
    """On the card, in the f32 parity mode: a perspective batch drawn as a
    composed box over the clip box against the clip-box step, an MPI tile
    with sparse TV (K-F's box form on the window) against the unclipped
    step, a blocked step against the plain step, and an NDC frame as
    pixel tiles against the chunked render."""
    import numpy as np
    from directvoxgo_tpu_torch.config import ConfigDict
    from directvoxgo_tpu_torch.engine import render as render_lib
    from directvoxgo_tpu_torch.engine.draws import Draws
    from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops

    def cfg(n_rand, w_tv=0.0):
        return ConfigDict(N_rand=n_rand, weight_main=1.0,
                          weight_entropy_last=0.001, weight_rgbper=0.01,
                          weight_tv_density=w_tv, weight_tv_k0=w_tv,
                          lrate_decay=20, lrate_density=1e-1, lrate_k0=1e-1,
                          lrate_rgbnet=1e-3,
                          skip_zero_grad_fields=["density", "k0"])

    def pool_of(o, d, rng):
        vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
        rgb = rng.uniform(0, 1, o.shape).astype(np.float32)
        return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                                   device=dev)
                for k, v in (("rays_o", o), ("rays_d", d), ("viewdirs", vd),
                             ("rgb", rgb))}

    dvgo_kw = dict(xyz_min=[-1] * 3, xyz_max=[1] * 3, alpha_init=1e-2,
                   fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_direct=True,
                   rgbnet_width=16, k_density=None, k_color=0)
    errs = {}
    # a perspective fan along x, one Morton segment as a composed box
    rng = np.random.default_rng(20)
    n = 6 * 512
    ang = rng.uniform(-0.04, 0.04, (n, 2))
    o = np.roll(np.tile([[0.15, -0.1, 3.0]], (n, 1)), -2, 1)
    d = np.roll(np.stack([np.tan(ang[:, 0]) + rng.uniform(-0.1, 0.1, n),
                          np.tan(ang[:, 1]), -np.ones(n)], -1), -2, 1)
    o, d = o.astype(np.float32), d.astype(np.float32)

    def make():
        return _f32_model(torch, DirectVoxGO, dict(
            dvgo_kw, num_voxels=40 ** 3, num_voxels_base=40 ** 3),
            _blob([0.1, -0.05, 0.05], 0.75), 19, dev)

    model = make()
    sizes, offs = model.sweep_clip_for_axis(0, quantum=8)
    box6 = tuple(float(x) for a, b in zip(offs, sizes) for x in (a, a + b - 1))
    bk = sweep_ops.build_ray_segments_2d(
        o, d, model.xyz_min, model.xyz_max, model.world_size, 0, n_rand=512,
        widths=(16, 24, 32), clip_box=box6)
    key = next(k for k in bk if k != (0, 0)
               and Draws._eff(k, *sizes[1:]) != tuple(sizes[1:]))
    eu, ev = Draws._eff(key, *sizes[1:])
    idx, ulo, vlo = bk[key]
    off = Draws._clamped(offs, sizes[1:], (eu, ev), ulo[0], vlo[0])
    rk = dict(near=0.5, far=6.0, bg=1.0, stepsize=0.5)
    errs["perspective window"] = _step_pair(
        torch, "perspective", make, cfg(512), rk, (False, False), 0,
        (((sizes[0], eu, ev), off), (sizes, np.asarray(offs))),
        pool_of(o, d, rng), torch.as_tensor(idx[0], device=dev))

    # an MPI image tile with sparse TV
    rng = np.random.default_rng(3)
    mpi_kw = dict(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                  num_voxels=48 * 48 * 32, mpi_depth=32,
                  fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=16)

    def make():
        return _f32_model(torch, DirectMPIGO, mpi_kw, lambda m: np.random
                          .default_rng(4).normal(0, 1, tuple(m.world_size))
                          .astype(np.float32), 5, dev)

    model = make()
    n = 256
    o = np.stack([rng.uniform(0.1, 0.4, n), rng.uniform(-0.4, -0.1, n),
                  np.zeros(n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
                  np.ones(n)], -1).astype(np.float32)
    bk = sweep_ops.build_ray_segments_2d(
        o, d, model.xyz_min, model.xyz_max, model.world_size, 2, n_rand=n,
        widths=(16, 24, 32))
    gp, gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[2])
    key = next(k for k in bk if k != (0, 0))
    eu, ev = Draws._eff(key, gu, gv)
    idx, ulo, vlo = bk[key]
    off = Draws._clamped(np.zeros(3, np.int32), (gu, gv), (eu, ev), ulo[0],
                         vlo[0])
    errs["mpi window, sparse TV"] = _step_pair(
        torch, "MPI, sparse TV", make, cfg(n, 1e-2),
        dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0), (True, False), 2,
        (((gp, eu, ev), off), (None, np.zeros(3, np.int32))),
        pool_of(o, d, rng), torch.as_tensor(idx[0], device=dev))

    # a blocked step
    rng = np.random.default_rng(32)
    n = 4 * 512
    ang = rng.uniform(-0.12, 0.12, (n, 2))
    o = np.tile([[0.1, 0.1, 3.0]], (n, 1)).astype(np.float32)
    d = np.stack([np.tan(ang[:, 0]) + 0.05, np.tan(ang[:, 1]), -np.ones(n)],
                 -1).astype(np.float32)

    def make():
        return _f32_model(torch, DirectVoxGO, dict(
            dvgo_kw, num_voxels=48 ** 3, num_voxels_base=48 ** 3),
            _blob([0.05, -0.1, 0.0], 0.6), 31, dev)

    model = make()
    bk = sweep_ops.build_ray_segments_blocked(
        o, d, model.xyz_min, model.xyz_max, model.world_size, 2, n_rand=512,
        n_blocks=4, widths=(16, 24, 32, 40))
    key = next(k for k in bk if k != (0, 0))
    idx, uo, vo = bk[key]
    gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[2][1:])
    errs["blocked"] = _step_pair(
        torch, "blocked", make, cfg(512), rk, (False, False), 2,
        ((("blk", uo.shape[1], *Draws._eff(key, gu, gv)),
          np.stack([uo[0], vo[0]], 1).astype(np.int32)),
         (None, np.zeros(3, np.int32))),
        pool_of(o, d, rng), torch.as_tensor(idx[0], device=dev),
        blocked=True)

    # an NDC frame as pixel tiles against the chunked render
    model = _f32_model(torch, DirectMPIGO, dict(
        mpi_kw, num_voxels=96 * 96 * 48, mpi_depth=48, rgbnet_width=32,
        viewbase_pe=4, k_color=8), lambda m: np.random.default_rng(11)
        .normal(0, 1.5, tuple(m.world_size)).astype(np.float32), 12, dev)
    h = w = 48
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)[:3]
    rk = dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0)
    fn = render_lib.make_render_fn(model, rk)
    from directvoxgo_tpu_torch import rays as ray_lib
    rays = [x.reshape(-1, 3) for x in ray_lib.get_rays_of_a_view(
        h, w, K, c2w, True, False, False, False)]
    gate = render_lib.WINDOWED_RENDER_MIN_PLANE
    try:
        render_lib.WINDOWED_RENDER_MIN_PLANE = 2 ** 62
        chunks = render_lib.render_rays_chunked(fn, model, *rays, 512)
        render_lib.WINDOWED_RENDER_MIN_PLANE = 0
        tiles = render_lib.render_frame_ndc_tiles(
            fn, model, h, w, K, c2w, rk, chunk=512, tile_hw=(16, 32),
            widths=(8, 16, 24, 48))
        windowed = render_lib.render_rays_chunked(fn, model, *rays, 512)
    finally:
        render_lib.WINDOWED_RENDER_MIN_PLANE = gate
    for what, out in (("NDC tiles", tiles), ("NDC windowed chunks",
                                             windowed)):
        err = max(float(np.abs(a - b).max()) for a, b in zip(out, chunks))
        log(f"[phase 1] {what} against the chunked render: max|rgb, depth "
            f"diff| {err:.3e}")
        if not err <= TILES_TOL:
            raise AssertionError(f"{what} differ from the chunked render by "
                                 f"{err}")
        errs[what] = err
    return errs


# -------------------------------------------- phase 1: graphed steps

def small_graph_checks(torch, dev):
    """On the card, in the f32 parity mode, each unfused step key kind
    replayed as a CUDA graph against the same steps run eagerly from one
    state (:func:`graph_vs_eager`; the first step eager, the second
    captured, the rest replays, each batch at its own offsets): an 8-step
    chunk over a clip box under plain Adam (full-size gradients), a
    composed-box window and a blocked step (region mode, box-sized Adam),
    an MPI window under dense and under sparse TV (K-F's box form)."""
    import numpy as np
    from directvoxgo_tpu_torch.config import ConfigDict
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.engine.draws import Draws
    from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops

    def cfg(n_rand, w_tv=0.0, skip=("density", "k0")):
        return ConfigDict(N_rand=n_rand, weight_main=1.0,
                          weight_entropy_last=0.001, weight_rgbper=0.01,
                          weight_tv_density=w_tv, weight_tv_k0=w_tv,
                          lrate_decay=20, lrate_density=1e-1, lrate_k0=1e-1,
                          lrate_rgbnet=1e-3, skip_zero_grad_fields=list(skip))

    def pool_of(o, d, rng):
        vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
        rgb = rng.uniform(0, 1, o.shape).astype(np.float32)
        return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                                   device=dev)
                for k, v in (("rays_o", o), ("rays_d", d), ("viewdirs", vd),
                             ("rgb", rgb))}

    def check(what, model, ct, rk, tv, axis, key, pool, sels, offs):
        opt = train_lib.create_optimizer_or_freeze_model(model, ct)
        return graph_vs_eager(torch, dev, what, model,
                              (opt, ct, rk, *tv), dict(axis=axis,
                                                       clip_sizes=key),
                              pool, np.asarray(sels), np.asarray(offs))

    dvgo_kw = dict(xyz_min=[-1] * 3, xyz_max=[1] * 3, alpha_init=1e-2,
                   fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_direct=True,
                   rgbnet_width=16, k_density=None, k_color=0)
    rk = dict(near=0.5, far=6.0, bg=1.0, stepsize=0.5)
    out = {}
    # a perspective fan along x: 8 uniform batches over the clip box under
    # plain Adam, then Morton segments of one class as composed boxes
    rng = np.random.default_rng(20)
    n = 8 * 512
    ang = rng.uniform(-0.04, 0.04, (n, 2))
    o = np.roll(np.tile([[0.15, -0.1, 3.0]], (n, 1)), -2, 1)
    d = np.roll(np.stack([np.tan(ang[:, 0]) + rng.uniform(-0.1, 0.1, n),
                          np.tan(ang[:, 1]), -np.ones(n)], -1), -2, 1)
    o, d = o.astype(np.float32), d.astype(np.float32)
    pool = pool_of(o, d, rng)
    model = _f32_model(torch, DirectVoxGO, dict(
        dvgo_kw, num_voxels=40 ** 3, num_voxels_base=40 ** 3),
        _blob([0.1, -0.05, 0.05], 0.75), 19, dev)
    sizes, offs = model.sweep_clip_for_axis(0, quantum=8)
    sels = np.stack([rng.permutation(n)[:512] for _ in range(8)])
    out["chunk over the clip box"] = check(
        "small, 8-step chunk over the clip box", model,
        cfg(512, skip=()), rk, (False, False), 0, sizes, pool, sels,
        np.broadcast_to(np.asarray(offs, np.int32), (8, 3)))
    box6 = tuple(float(x) for a, b in zip(offs, sizes) for x in (a, a + b - 1))
    bk = sweep_ops.build_ray_segments_2d(
        o, d, model.xyz_min, model.xyz_max, model.world_size, 0, n_rand=512,
        widths=(16, 24, 32), clip_box=box6)
    key = max((k for k in bk if k != (0, 0)
               and Draws._eff(k, *sizes[1:]) != tuple(sizes[1:])),
              key=lambda k: bk[k][0].shape[0])
    eu, ev = Draws._eff(key, *sizes[1:])
    idx, ulo, vlo = bk[key]
    rows = range(min(5, idx.shape[0]))
    out["window"] = check(
        "small, composed-box window", model, cfg(512), rk, (False, False),
        0, (sizes[0], eu, ev), pool, idx[list(rows)],
        [Draws._clamped(offs, sizes[1:], (eu, ev), ulo[r], vlo[r])
         for r in rows])

    # a blocked step
    rng = np.random.default_rng(32)
    n = 6 * 512
    ang = rng.uniform(-0.12, 0.12, (n, 2))
    o = np.tile([[0.1, 0.1, 3.0]], (n, 1)).astype(np.float32)
    d = np.stack([np.tan(ang[:, 0]) + 0.05, np.tan(ang[:, 1]), -np.ones(n)],
                 -1).astype(np.float32)
    model = _f32_model(torch, DirectVoxGO, dict(
        dvgo_kw, num_voxels=48 ** 3, num_voxels_base=48 ** 3),
        _blob([0.05, -0.1, 0.0], 0.6), 31, dev)
    bk = sweep_ops.build_ray_segments_blocked(
        o, d, model.xyz_min, model.xyz_max, model.world_size, 2, n_rand=512,
        n_blocks=4, widths=(16, 24, 32, 40))
    key = max((k for k in bk if k != (0, 0)),
              key=lambda k: bk[k][0].shape[0])
    idx, uo, vo = bk[key]
    rows = list(range(min(5, idx.shape[0])))
    gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[2][1:])
    out["blocked"] = check(
        "small, blocked", model, cfg(512), rk, (False, False), 2,
        ("blk", uo.shape[1], *Draws._eff(key, gu, gv)), pool_of(o, d, rng),
        idx[rows], [np.stack([uo[r], vo[r]], 1) for r in rows])

    # MPI image tiles under dense and under sparse TV
    rng = np.random.default_rng(3)
    mpi_kw = dict(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                  num_voxels=48 * 48 * 32, mpi_depth=32,
                  fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=16)
    n = 4096
    o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                  np.zeros(n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
                  np.ones(n)], -1).astype(np.float32)
    pool = pool_of(o, d, rng)
    for tv_form, tv in (("dense", (True, True)), ("sparse", (True, False))):
        model = _f32_model(torch, DirectMPIGO, mpi_kw, lambda m: np.random
                           .default_rng(4).normal(0, 1, tuple(m.world_size))
                           .astype(np.float32), 5, dev)
        bk = sweep_ops.build_ray_segments_2d(
            o, d, model.xyz_min, model.xyz_max, model.world_size, 2,
            n_rand=256, widths=(16, 24, 32))
        gp, gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[2])
        key = max((k for k in bk if k != (0, 0)),
                  key=lambda k: bk[k][0].shape[0])
        eu, ev = Draws._eff(key, gu, gv)
        idx, ulo, vlo = bk[key]
        rows = list(range(min(5, idx.shape[0])))
        out[f"mpi window, {tv_form} TV"] = check(
            f"small, MPI window, {tv_form} TV", model, cfg(256, 1e-2),
            dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0), tv, 2,
            (gp, eu, ev), pool, idx[rows],
            [Draws._clamped(np.zeros(3, np.int32), (gu, gv), (eu, ev),
                            ulo[r], vlo[r]) for r in rows])
    return out


# ----------------------------------------------------------------- phase 5

def write_train_config():
    os.makedirs(CKPT_DIR, exist_ok=True)
    with open(TRAIN_CONFIG, "w") as f:
        f.write(f"_base_ = {TRAIN_BASE!r}\n"
                "expname = 'train_lego'\n"
                "basedir = './logs/chip_smoke'\n"
                f"coarse_train = {{'N_iters': {N_COARSE}}}\n"
                f"fine_train = {{'N_iters': {N_FINE}, "
                f"'pg_scale': {PG_SCALE}}}\n")
    return TRAIN_CONFIG


def draw_kind(key):
    """The kind of a batch by the step key ``Draws.next_chunk`` drew for it
    (None: the stage's clip box)."""
    if key is None:
        return "plain"
    return {"fblk": "fused", "blk": "blocked"}.get(key[0], "window")


def step_form(stage, kind):
    """The path form of a step's sweeps: "fine step", "fine window step",
    "fine blocked step", ..."""
    return f"{stage} {'' if kind == 'plain' else kind + ' '}step"


def sweep_launches(steps):
    """K-A (and K-C) launches of these recorded steps: one a step, one a
    block of a blocked step, none in a fused step."""
    return sum(s[7][1] if s[6] == "blocked" else 1 for s in steps
               if s[6] != "fused")


class StepRecorder:
    """Wraps ``engine.graphs.StepGraphs.call``, through which every train
    step runs (eagerly, captured as a CUDA graph, or replayed): each step is
    synchronised and timed on the host clock, and its PSNR, stage (coarse:
    no colour MLP), grid size, the draw it took (``Draws.next_chunk``,
    wrapped too: its kind and step key) and how it ran are recorded, with
    its inputs, so that it can be run again eagerly. Wraps
    ``engine.train.make_train_step`` to know what each step was made of."""

    RECENT = 8    # the last batches kept per step key

    def __init__(self, train_lib):
        from directvoxgo_tpu_torch.engine import draws as draws_lib
        from directvoxgo_tpu_torch.engine import graphs as graphs_lib
        self.train_lib, self.graphs_cls = train_lib, graphs_lib.StepGraphs
        self.orig = train_lib.make_train_step
        self.orig_call = graphs_lib.StepGraphs.call
        # (stage, voxels, ms, psnr, loss, fused step?, draw kind, draw key,
        #  how it ran: "eager", "capture" or "replay")
        self.steps = []
        self.last = {}    # (stage, fused step?) -> (step, args, kwargs)
        self.last_kind = {}   # (stage, draw kind) -> (step, args, kwargs)
        self.last_tv = {}   # TV form of a step ("dense", "sparse", "none")
        #                     -> (step, args, kwargs, voxels)
        self.made = {}    # id(step) -> (model, args, kwargs) it was made of
        self.kept = []    # the steps made (their ids stay theirs)
        self.recent = {}  # id(step) -> its last RECENT (pool, sel, off)
        self.kind_of = {}  # id(step) -> (stage, draw kind, TV form, voxels)
        self.inside = None   # (stage, kind) of the step being taken, if any
        self.draw = None     # step key of the last draw
        self.draws_cls = draws_lib.Draws
        self.orig_draw = draws_lib.Draws.next_chunk
        rec = self

        def next_chunk(draws, n_sub, apply_tv):
            out = rec.orig_draw(draws, n_sub, apply_tv)
            rec.draw = out[2]
            return out

        def call(graphs, key, step, pool, row, n_rand, off_shape, out,
                 host_off=None):
            return rec.call(graphs, key, step, pool, row, n_rand, off_shape,
                            out, host_off)

        draws_lib.Draws.next_chunk = next_chunk
        graphs_lib.StepGraphs.call = call
        train_lib.make_train_step = self

    def form(self, *_, **__):
        """The form of a sweep launched now: a step's, or (between steps)
        a counted view's of the per-voxel lr."""
        return step_form(*self.inside) if self.inside else "counted view"

    def __call__(self, model, *args, **kw):
        step = self.orig(model, *args, **kw)
        self.made[id(step)] = (model, args, kw)
        self.kept.append(step)
        return step

    def call(self, graphs, key, step, pool, row, n_rand, off_shape, out,
             host_off):
        import torch
        model, args, kw = self.made[id(step)]
        stage = "fine" if model.rgbnet is not None else "coarse"
        clip = kw.get("clip_sizes")
        fused = clip is not None and clip[0] == "fblk"
        tv = ("dense" if args[4] else "sparse") if args[3] else "none"
        kind, dkey = draw_kind(self.draw), self.draw
        voxels = int(np_prod(model.world_size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.inside = (stage, kind)
        try:
            how = self.orig_call(graphs, key, step, pool, row, n_rand,
                                 off_shape, out, host_off)
        finally:
            self.inside = None
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        a = (pool, row[:n_rand].clone(), host_off if host_off is not None
             else row[n_rand:].to(torch.int32).reshape(off_shape).clone())
        self.last[(stage, fused)] = (step, a, {})
        self.last_kind[(stage, kind)] = (step, a, {})
        self.last_tv[tv] = (step, a, {}, voxels)
        self.recent.setdefault(id(step), collections.deque(
            maxlen=self.RECENT)).append(a)
        self.kind_of[id(step)] = (stage, kind, tv, voxels)
        self.steps.append((stage, voxels, ms, float(out[1]), float(out[0]),
                           fused, kind, dkey, how))
        return how

    def restore(self):
        self.train_lib.make_train_step = self.orig
        self.draws_cls.next_chunk = self.orig_draw
        self.graphs_cls.call = self.orig_call

    def unwindowed(self, step):
        """The step that ``step`` (a recorded step) would be over the clip
        box of its model's current mask, untimed: the same model,
        optimizer and TV state. Returns (step, clip offsets)."""
        model, args, kw = self.made[id(step)]
        sizes, offs = model.sweep_clip_for_axis(kw["axis"])
        return self.orig(model, *args, axis=kw["axis"],
                         clip_sizes=sizes), offs


class PerReplay:
    """Registers counters by form (``collections.Counter`` attributes
    ``counts`` of a :class:`Capture` or a recorder) with the train steps'
    CUDA graphs (``engine.graphs.COUNTERS``), so that, like the kernels'
    own counters, they count each replay and not the capture."""

    def __init__(self, *objs):
        from directvoxgo_tpu_torch.engine import graphs as graphs_lib
        self.graphs_lib = graphs_lib
        self.added = [(o, "counts") for o in objs]
        graphs_lib.COUNTERS.extend(self.added)

    def restore(self):
        for item in self.added:
            self.graphs_lib.COUNTERS.remove(item)


def how_steps_ran(steps):
    """Share of these recorded steps replayed from a CUDA graph, and the
    counts of eager steps and captures."""
    by = collections.Counter(s[8] for s in steps)
    return {"replayed_share": by["replay"] / max(len(steps), 1),
            "captures": by["capture"], "eager": by["eager"],
            "replays": by["replay"]}


def np_prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def median(xs):
    xs = sorted(xs)
    return float(xs[len(xs) // 2])


# The first versions of K-A, K-C, K-F, K-B, K-D and K-E, kept
# beside their redesign as the yardstick of its `prev_ms` (never loaded by
# the port).
PREV_KERNELS = ("sweep_fwd_v1", "sweep_bwd_v1", "tv_add_grad_first",
                "render_frame_first", "train_fused_fwd_first",
                "train_fused_bwd_first")


def _prev_lib(name):
    """(library, its launch function) of a first-version kernel, with the
    C signature its wrapper declared."""
    import ctypes
    from directvoxgo_tpu_torch.ops import _build
    lib = _build.load(name)
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    limits = []
    if name == "sweep_fwd_v1":
        fn = lib.dvgo_sweep_fwd
        limits = [lib.dvgo_sweep_fwd_max_channels]
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    elif name == "sweep_bwd_v1":
        fn = lib.dvgo_sweep_bwd
        limits = [lib.dvgo_sweep_bwd_max_channels]
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
    elif name == "tv_add_grad_first":
        fn = lib.dvgo_tv_add_grad
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    elif name == "train_fused_fwd_first":
        fn = lib.dvgo_train_fused_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                       + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    elif name == "train_fused_bwd_first":
        fn = lib.dvgo_train_fused_bwd
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 15
                       + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    else:
        fn = lib.dvgo_render_frame
        limits = [lib.dvgo_render_frame_max_features,
                  lib.dvgo_render_frame_max_emb]
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 12
                       + [ctypes.c_float] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for f in limits:
        f.argtypes, f.restype = [], ctypes.c_int
    return lib, fn


def _prev_check(lib, err):
    if err:
        raise RuntimeError("first-version launch failed: "
                           + lib.dvgo_error_string(err).decode())


def prev_fwd_call(torch, slabs, rays, k, v_base=None, wv=0):
    """K-A's first version on these inputs, as its wrapper called it: one
    launch over contiguous slabs (a padded view is copied before, outside
    the call), into a fresh [S, C, N] f32 output."""
    lib, fn = _prev_lib("sweep_fwd_v1")
    slabs = slabs.contiguous()
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    stream = torch.cuda.current_stream(slabs.device).cuda_stream

    def call():
        out = torch.empty((s_total, c, n), dtype=torch.float32,
                          device=slabs.device)
        _prev_check(lib, fn(
            slabs.data_ptr(), int(slabs.dtype == torch.bfloat16),
            rays.data_ptr(), v_base.data_ptr() if wv else None,
            out.data_ptr(), n, s_total, gu, gv, c, int(k), int(wv),
            512, stream))
        return out
    return call


def prev_bwd_call(torch, g, rays, k, shape, dtype, v_base=None, wv=0):
    """K-C's first version on these inputs, as its wrapper called it: a
    zero f32 accumulator, one launch over the [S, C, N] cotangent made
    contiguous (before, outside the call, as the first version's autograd
    function copied it), the cast to the grid dtype."""
    from directvoxgo_tpu_torch.ops import sweep_bwd as kc
    lib, fn = _prev_lib("sweep_bwd_v1")
    g = g.contiguous()
    gp, gu, gv, c = shape
    s_total, _, n = g.shape
    wv, segment = kc._window_form(v_base, wv, n)
    stream = torch.cuda.current_stream(g.device).cuda_stream

    def call():
        acc = torch.zeros((gp, gu, gv, c), dtype=torch.float32,
                          device=g.device)
        _prev_check(lib, fn(
            g.data_ptr(), rays.data_ptr(), v_base.data_ptr() if wv else None,
            acc.data_ptr(), n, s_total, gu, gv, c, int(k),
            int(dtype == torch.bfloat16), wv,
            0 if not wv else (2 if segment else 1), 512,
            v_base.shape[0] - 1 if segment else 0, stream))
        return acc.to(dtype)
    return call


def prev_tv_call(torch, name, args, kw):
    """K-F's first version on the inputs of a call of ``tv.<name>``
    (``total_variation_add_grad`` or ``tv_add_grad_box``), as its wrapper
    called it: one thread per element through the gradient's strides, into
    a fresh output."""
    import inspect
    from directvoxgo_tpu_torch.ops import tv
    lib, fn = _prev_lib("tv_add_grad_first")
    bound = inspect.signature(getattr(tv, name)).bind(*args, **kw)
    bound.apply_defaults()
    a = bound.arguments
    param = a["param"]
    grad = a["grad_box"] if name == "tv_add_grad_box" else a["grad"]
    offs = tuple(int(o) for o in a.get("offs", (0, 0, 0)))
    w = tv._axis_weights(a["wx"], a["wy"], a["wz"], a["bug_compat"])
    dims = tuple(int(d) for d in param.shape[:3])
    sizes = tuple(int(d) for d in grad.shape[:3])
    c = int(param.shape[3]) if param.dim() == 4 else 1
    g_strides = tuple(grad.stride()) + ((1,) if param.dim() == 3 else ())
    stream = torch.cuda.current_stream(param.device).cuda_stream

    def call():
        out = torch.empty(grad.shape, dtype=torch.float32,
                          device=grad.device)
        _prev_check(lib, fn(param.data_ptr(), grad.data_ptr(),
                            out.data_ptr(), *dims, c, *offs, *sizes,
                            *g_strides, *(float(x) for x in w),
                            int(bool(a["dense_mode"])), stream))
        return out
    return call


def prev_frame_call(torch, f):
    """K-B's first version on the frame ``f`` (``render_frame``'s keyword
    arguments), as its wrapper called it: the MLP packed as f32
    (``pack_mlp``, outside the timed call, as the wrapper's cache kept it),
    one thread per pixel, fresh outputs."""
    from directvoxgo_tpu_torch.ops import render_frame as kb
    lib, fn = _prev_lib("render_frame_first")
    dev = f["dnorm"].device
    s_total, gu, gv, _ = f["d_geo"].shape
    hi, wi = f["dnorm"].shape
    c0 = 3 if f["rgb_mode"] == "logit_plus_k0" else 0
    shared1 = f.get("shared1")
    emb_dim = width = 0
    mlp = emb = None
    f_k0 = 0 if f["d_k0"] is None else f["d_k0"].shape[3]
    if f["has_mlp"]:
        layers = f["layers"]
        width = layers[1][0].shape[0]
        if shared1 is None:
            emb_dim = f["vd_emb"].shape[-1]
            emb = f["vd_emb"]
        else:
            emb = shared1
        mlp = kb.pack_mlp(layers, layers[0][0].shape[0] - emb_dim)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        rgb = torch.empty((3, hi, wi), dtype=torch.float32, device=dev)
        depth = torch.empty((hi, wi), dtype=torch.float32, device=dev)
        tcum = torch.empty((hi, wi), dtype=torch.float32, device=dev)
        _prev_check(lib, fn(
            ptr(f["d_geo"]), ptr(f["d_k0"]), ptr(emb), ptr(f["dnorm"]),
            ptr(f["dclip"]), ptr(f["ur"]), ptr(f["vr"]), ptr(mlp),
            ptr(f["activity"]), ptr(rgb), ptr(depth), ptr(tcum), s_total,
            gu, gv, hi, wi, f_k0, c0, emb_dim, width, int(f["has_mlp"]),
            int(shared1 is not None),
            int(f.get("k0_order", "v_first") == "u_first"),
            *[float(x) for x in f["scalars"]], stream))
        return rgb, depth, tcum
    return call


def prev_fused_call(torch, args, cfg, gp=None, cot=None, mode=0):
    """K-D's first version (K-E's with ``gp`` and ``cot``) on the inputs
    ``args`` of a ``train_fwd`` call, as its wrapper called it: the operands
    padded to the tensor-core tiles (sh1 per ray, w1a to 16 rows, w3 and b3
    to 16 columns), fresh (K-E: zero-filled) outputs and scratch, one
    launch. Returns the wrapper's results: pack, or K-E's eight cotangents."""
    from directvoxgo_tpu_torch.ops import train_fused as tf
    slabs, rays16, sh1_t, w1a, w2, b2, w3, b3, desc, uvb = args
    bwd = cot is not None
    lib, fn = _prev_lib("train_fused_bwd_first" if bwd
                        else "train_fused_fwd_first")
    dev = slabs.device
    s_real, gu, gv, c = slabs.shape
    n = rays16.shape[1]
    width, f = cfg.width, cfg.f
    s_pad, p0, pstep = tf.march_scalars(s_real, cfg.k, cfg.s_blk, desc)
    _, _, wu_e, wv_e, windowed = tf._window_plan(cfg, gu, gv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = [int(cfg.direct), int(bool(desc)), cfg.nt, int(windowed), wu_e,
            wv_e] + ([cfg.k] if bwd else []) + [
        p0, pstep, cfg.act_shift, cfg.thres, cfg.bg, int(mode), stream]

    def operands():
        w1a_p = torch.zeros((16, width), dtype=torch.bfloat16, device=dev)
        w1a_p[:f] = w1a
        w3_p = torch.zeros((width, 16), dtype=torch.bfloat16, device=dev)
        w3_p[:, :3] = w3
        b3_p = torch.zeros(16, dtype=torch.float32, device=dev)
        b3_p[:3] = b3
        return sh1_t.t().contiguous(), w1a_p, w3_p, b3_p

    def fwd():
        sh1, w1a_p, w3_p, b3_p = operands()
        pack = torch.empty((8, n), dtype=torch.float32, device=dev)
        _prev_check(lib, fn(
            slabs.data_ptr(), rays16.data_ptr(), sh1.data_ptr(),
            w1a_p.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3_p.data_ptr(),
            b3_p.data_ptr(), uvb.data_ptr() if windowed else None,
            pack.data_ptr(), n, s_real, s_pad, gu, gv, c, f, width, *tail))
        return pack

    def bwd_call():
        sh1, w1a_p, w3_p, b3_p = operands()
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa
                                       device=dev)
        outs = [z(gp, gu, gv), z(gp, gu, gv, c - 2), z(n, width),
                z(16, width), z(width, width), z(width), z(width, 16), z(16)]
        t_chk = torch.empty((s_pad // cfg.s_blk, n), dtype=torch.float32,
                            device=dev)
        a_buf = torch.empty((s_pad, n), dtype=torch.float32, device=dev)
        _prev_check(lib, fn(
            slabs.data_ptr(), rays16.data_ptr(), cot.data_ptr(),
            sh1.data_ptr(), w1a_p.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3_p.data_ptr(), b3_p.data_ptr(),
            uvb.data_ptr() if windowed else None, t_chk.data_ptr(),
            a_buf.data_ptr(), *[o.data_ptr() for o in outs], n, s_real,
            s_pad, gu, gv, c, f, width, *tail))
        d_density, d_k0, d_sh1, d_w1a, d_w2, d_b2, d_w3, d_b3 = outs
        return (d_density, d_k0, d_sh1.t(), d_w1a[:f], d_w2, d_b2,
                d_w3[:, :3], d_b3[:3])
    return bwd_call if bwd else fwd


def gate_fingerprint(torch, tf, args, cfg):
    """[3, N] per ray: the count of samples whose weight passes the gate,
    the sum of (ms + 1) and of (ms + 1)^2 over them (march station ms),
    from the plain version's march: what K-D writes into pack rows 5-7
    under ``MODE_GATES``."""
    slabs, rays16 = args[0], args[1]
    st = tf._March(slabs, rays16, cfg, args[8], args[9])
    ms, ray = st.sel
    m1 = (ms + 1).double()
    n = rays16.shape[1]
    return torch.stack([torch.bincount(ray, weights=w, minlength=n)
                        for w in (torch.ones_like(m1), m1, m1 * m1)]).float()


USAGE = {}   # (library, mangled kernel) -> (registers, spill bytes), phase 0


def ptxas_usage(logs):
    """{(library, mangled kernel name): (registers, spill store bytes, spill
    load bytes)} from the ``-Xptxas -v`` output of the builds."""
    import re
    usage = {}
    for lib, text in logs.items():
        cur, spill = None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                usage[(lib, cur)] = (int(m.group(1)), *spill)
    return usage


def kernel_usage(lib, kernel, *targs):
    """{"registers", "spills"} (spill stores + loads, bytes) of the instance
    ``kernel<targs...>`` in library ``lib``, from the phase-0 build; None
    where the build printed nothing (a library built before this run)."""
    code = {"bf16": "13__nv_bfloat16", "f32": "f"}
    args = "".join(f"Lb{int(a)}E" if isinstance(a, bool) else
                   f"Li{a}E" if isinstance(a, int) else code[a]
                   for a in targs)
    want = f"{len(kernel)}{kernel}" + (f"I{args}E" if targs else "E")
    for (name, mangled), (regs, st, ld) in USAGE.items():
        if name == lib and want in mangled:
            return {"registers": regs, "spills": st + ld}
    return {"registers": None, "spills": None}


def fwd_numbers(torch, ka, slabs, rays, k, v_base=None, wv=0):
    """K-A on these inputs: its time, its plain version's, one
    ``grid_sample`` call's, and its bound (the distinct slab voxels its taps
    weight, the rays and window starts read once, the [S, C, N] f32 output
    written once; two operations per tap and channel plus the
    coordinates)."""
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    inst = ka.instance(slabs, n)
    prev_call = prev_fwd_call(torch, slabs, rays, k, v_base, wv)
    prev = cuda_time(prev_call, 20, device_only=True)
    ms = cuda_time(lambda: ka.sweep_fwd(slabs, rays, k, v_base, wv), 20,
                   device_only=True)
    prev_again = cuda_time(prev_call, 20, device_only=True)
    plain = cuda_time(lambda: ka.sweep_fwd_plain(slabs, rays, k, v_base, wv),
                      3, warmup=1)
    lib = cuda_time(grid_sample_call(torch, slabs, rays, k), 20,
                    device_only=True)
    voxels = sweep_voxels(torch, slabs, rays, k)
    n_bytes = voxels * c * slabs.element_size() + rays.numel() * 4 \
        + (v_base.numel() * 4 if wv else 0) + s_total * c * n * 4
    ops = s_total * n * (4 * c * 2 + 16)
    by = "bytes" if n_bytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return {"ms": ms, "plain_ms": plain,
            "bound_ms": max(n_bytes / HBM_BPS, ops / F32_FLOPS) * 1e3,
            "bound_by": by, "library_ms": lib,
            "prev_ms": min(prev, prev_again), "prev_ms_runs": [prev, prev_again],
            "form": ka.form(inst, bool(wv)),
            **kernel_usage("sweep_fwd", "sweep_fwd_kernel", *inst),
            "bytes": n_bytes, "slab_voxels_read": voxels,
            "shape": f"S={s_total} slab={gu}x{gv}x{c} "
                     f"{str(slabs.dtype).split('.')[-1]} N={n}"
                     + (f" wv={wv}" if wv else "")}


def bwd_numbers(torch, kc, g, rays, k, shape, dtype, v_base, wv):
    """K-C on these inputs: its time, its plain version's, the backward of
    one ``grid_sample`` call, and its bound (the cotangent and the rays read
    once, the voxels it touches written once in the grid dtype; six
    operations per tap of a nonzero cotangent plus the coordinates)."""
    gp, gu, gv, c = shape
    s_total, _, n = g.shape
    shared, chunks = kc.plan(gu, gv, c, n, s_total,
                             kc.device_limits(g.device.index))
    inst = kc.instance(shared, c, dtype == torch.bfloat16)
    prev_call = prev_bwd_call(torch, g, rays, k, shape, dtype, v_base, wv)
    prev = cuda_time(prev_call, 20, device_only=True)
    ms = cuda_time(lambda: kc.sweep_bwd(g, rays, k, shape, dtype, v_base,
                                        wv), 20, device_only=True)
    prev_again = cuda_time(prev_call, 20, device_only=True)
    # The first version's autograd function copied the cotangent to
    # [S, C, N] before the call; the redesign reads it through its strides.
    copy = 0.0 if g.is_contiguous() else cuda_time(
        lambda: g.contiguous(), 10, device_only=True)
    plain = cuda_time(lambda: kc.sweep_bwd_plain(g, rays, k, shape, dtype,
                                                 v_base, wv), 3, warmup=1)
    lib = cuda_time(grid_sample_backward_call(torch, g, rays, k, shape), 10,
                    device_only=True)
    out = kc.sweep_bwd(g, rays, k, shape, dtype, v_base, wv)
    touched = int((out != 0).any(-1).sum())
    nnz = int((g != 0).sum())
    n_bytes = g.numel() * 4 + rays.numel() * 4 \
        + touched * shape[3] * out.element_size()
    ops = nnz * 4 * 6 + g.shape[0] * g.shape[2] * 16
    by = "bytes" if n_bytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    return {"ms": ms, "plain_ms": plain,
            "bound_ms": max(n_bytes / HBM_BPS, ops / F32_FLOPS) * 1e3,
            "bound_by": by, "library_ms": lib,
            "prev_ms": min(prev, prev_again), "prev_ms_runs": [prev, prev_again],
            "prev_cotangent_copy_ms": copy,
            "form": kc.form(inst, kc.station_major(g)), "shared_chunks": chunks,
            **kernel_usage("sweep_bwd", *inst),
            "bytes": n_bytes, "operations": ops, "nonzero_cotangents": nnz,
            "voxels_touched": touched,
            "shape": f"g={tuple(g.shape)} grid={tuple(shape)} "
                     f"{str(dtype).split('.')[-1]} "
                     f"nonzero={nnz / g.numel():.4f}"}


def ka_form(ka):
    """K-A's own form of a call (channel instance, load width, stations a
    thread, windowed or not), from the call's arguments."""
    return lambda slabs, rays, k, v_base=None, wv=0: ka.form(
        ka.instance(slabs, rays.shape[1]), bool(wv))


def kc_form(torch, kc):
    """K-C's own form of a call (shared or global, channel instance, interp
    dtype, cotangent layout), from the call's arguments."""
    def form(g, rays, k, shape, dtype, v_base=None, wv=0, **_):
        shared, _ = kc.plan(shape[1], shape[2], shape[3], g.shape[2],
                            g.shape[0], kc.device_limits(g.device.index))
        return kc.form(kc.instance(shared, shape[3], dtype == torch.bfloat16),
                       kc.station_major(g))
    return form


def check_kernel_forms(ka, kc, cap_ka, cap_kc, what):
    """Every form K-A and K-C took in a run (:func:`ka_form`,
    :func:`kc_form`: windows and boxes of new shapes may pick forms the
    path forms do not show), on the inputs of its last call, against the
    plain version. Returns {kernel and form: max abs error}."""
    errs = {}
    for form, (args, _) in cap_ka.forms.items():
        slabs, rays, k, vb, wv = (*args, None, 0)[:5]
        slabs = slabs.detach()      # at k = 1 the slabs are the step's grid
        errs[f"sweep_fwd {form}"] = check_sweep_rel(
            ka, slabs, rays, k, vb, wv, f"{what}, K-A form {form}",
            zero_slab=not bool(slabs.any()))
    for form, (args, _) in cap_kc.forms.items():
        errs[f"sweep_bwd {form}"] = check_bwd(
            kc, *args[:7], f"{what}, K-C form {form}")
    return errs


def draw_classes(steps):
    """Per step key drawn ("clip box" for the stage's own box): its share of
    these steps, their count and median host-clock ms."""
    by = collections.defaultdict(list)
    for s in steps:
        by["clip box" if s[7] is None else str(s[7])].append(s[2])
    return {key: {"share": len(ms) / max(len(steps), 1), "steps": len(ms),
                  "median_ms": median(ms)}
            for key, ms in sorted(by.items(), key=lambda kv: -len(kv[1]))}


def window_vs_unwindowed(torch, rec, key, share_of=()):
    """The last recorded step of ``key`` ((stage, draw kind)) and the same
    batch through the step over its model's clip box, each traced
    (:func:`profile_step`; both train on, nothing is saved): the window's
    device time and idle share beside the whole box's. None when no step
    of that kind ran."""
    if key not in rec.last_kind:
        return None
    step, a, k = rec.last_kind[key]
    plain, offs = rec.unwindowed(step)
    model, _, kw = rec.made[id(step)]
    return {"window_key": str(kw["clip_sizes"]),
            "clip_box": str(model.sweep_clip_for_axis(kw["axis"])[0]),
            "window": profile_step(torch, step, a, k, share_of=share_of),
            "unwindowed": profile_step(torch, plain, (a[0], a[1], offs), {},
                                       share_of=share_of)}


def train_phase(torch, dev, ka, kb, kc, sweep_ops):
    """Phase 5; returns the kernels-line entries of the training path (K-A
    and K-C in each form that path launches, K-A's windowed form) and a
    summary of the training run."""
    import numpy as np
    from directvoxgo_tpu_torch import rays as ray_lib
    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import draws as draws_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO

    cfg_path = write_train_config()
    cfg = Config.fromfile(cfg_path)
    data = load_everything(None, cfg)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    n_views = len(data["i_train"])

    # The last call of every form the path launches (a coarse step's, a
    # fine step's, a counted view's) is kept for the checks below.
    rec = StepRecorder(train_lib)
    cap_a = Capture(sweep_ops, "sweep_fwd", form=rec.form)
    cap_c = Capture(sweep_ops, "sweep_bwd", form=rec.form)
    cap_ka = Capture(sweep_ops, "sweep_fwd", form=ka_form(ka))
    cap_kc = Capture(sweep_ops, "sweep_bwd", form=kc_form(torch, kc))
    count_timer = CallTimer(torch, [
        (DirectVoxGO, "voxel_count_views"),
        (draws_lib.Draws, "_build_segments")])
    per_replay = PerReplay(cap_a, cap_c, cap_ka, cap_kc)
    ka.launches = ka.launches_windowed = kb.launches = kc.launches = 0
    ka.launches_by_form.clear()
    kc.launches_by_form.clear()
    t0 = time.time()
    try:
        run_lib.main(["--config", cfg_path, "--no_reload", "--i_print", "100",
                      "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        rec.restore()
        per_replay.restore()
        for cap in (cap_kc, cap_ka, cap_c, cap_a):
            cap.restore()
        count_timer.restore()
    train_launches = {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches,
                      "render_frame": kb.launches,
                      "sweep_fwd_windowed": ka.launches_windowed}
    forms = {"sweep_fwd": dict(ka.launches_by_form),
             "sweep_bwd": dict(kc.launches_by_form)}
    coarse = [s for s in rec.steps if s[0] == "coarse"]
    fine = [s for s in rec.steps if s[0] == "fine"]
    top = max(s[1] for s in fine)
    fine_top = [s for s in fine if s[1] == top]
    log(f"[phase 5] run.main trained {len(coarse)} coarse + {len(fine)} "
        f"fine steps (pg_scale {PG_SCALE}, {len(fine_top)} at {top} voxels) "
        f"in {time.time() - t0:.1f} s; launches {train_launches}; "
        f"{n_views} views counted")
    # Every step is one K-A and one K-C launch (a blocked step one per
    # block); so is every counted view of the coarse stage's per-voxel lr.
    # The fine stage draws window classes once its grid passes 1.1 M
    # voxels.
    run_steps = list(rec.steps)
    want = collections.Counter({"counted view": n_views})
    for st in run_steps:
        want[step_form(st[0], st[6])] += sweep_launches([st])
    want = dict(want)
    kinds = collections.Counter(f"{st[0]} {st[6]}" for st in run_steps)
    if not (len(coarse) == N_COARSE and len(fine) == N_FINE
            and len(fine_top) >= MIN_TOP_STEPS
            and kinds["fine window"] > 0
            and dict(cap_a.counts) == want and dict(cap_c.counts) == want
            and train_launches["sweep_fwd"] == sum(want.values())
            and train_launches["sweep_bwd"] == sum(want.values())
            and train_launches["sweep_fwd_windowed"] == 0
            and train_launches["render_frame"] == 0):
        raise AssertionError(
            f"launches {train_launches} (K-A by form {dict(cap_a.counts)}, "
            f"K-C {dict(cap_c.counts)}) do not match {want}; draws "
            f"{dict(kinds)}")
    # Each path form ran its own channel instance of both kernels (coarse
    # C=5, fine C=14, counted view C=1), every launch counted by form.
    log(f"[phase 5] draws {dict(kinds)}; kernel forms launched: {forms}; "
        f"voxel_count_views and bucket builds {count_timer.seconds} s")
    for name, cap in (("sweep_fwd", cap_a), ("sweep_bwd", cap_c)):
        by_c = collections.Counter()
        for key, count in forms[name].items():
            by_c[key.split("C=")[1].split()[0]] += count
        c_of = {form: (cap.forms[form][0][0].shape[3] if name == "sweep_fwd"
                       else cap.forms[form][0][3][3]) for form in want}
        want_c = collections.Counter()
        for f in want:
            want_c[str(c_of[f]) if c_of[f] in ka.CHANNEL_INSTANCES
                   else "generic"] += want[f]
        if (sum(forms[name].values()) != train_launches[name]
                or any(by_c[c] != n for c, n in want_c.items())):
            raise AssertionError(f"{name} launches by form {forms[name]} do "
                                 f"not match {want} (channels {c_of})")
    classes = draw_classes(fine_top)
    log(f"[phase 5] fine draws at {top} voxels by step key: {classes}")
    # The steps ran as CUDA graphs: replayed after each key's eager first
    # step and its capture; a whole chunk keeps one axis.
    ran = {stage: how_steps_ran(st) for stage, st in (("coarse", coarse),
                                                      ("fine", fine))}
    log(f"[phase 5] steps by how they ran: {ran}; median fine step at "
        f"{top} voxels {median([s[2] for s in fine_top]):.2f} ms (eager "
        f"engine: {EAGER_STEP_MS['lego fine at 160^3']} ms)")
    if not all(r["replayed_share"] > MIN_REPLAYED_SHARE
               for r in ran.values()):
        raise AssertionError(f"too few steps were replayed: {ran}")

    # Where a fine step's time goes: three more steps of the last one,
    # traced (the checkpoints are written; these steps are not saved).
    step_trace = profile_step(torch, *rec.last[("fine", False)],
                              share_of=("sweep_fwd", "sweep_bwd"))
    log(f"[phase 5] trace of the last fine step: {step_trace}")
    # The last window step against the same batch over the clip box.
    window_trace = window_vs_unwindowed(torch, rec, ("fine", "window"),
                                        share_of=("sweep_fwd", "sweep_bwd"))
    log(f"[phase 5] the last fine window step and its batch over the clip "
        f"box, traced: {window_trace}")
    if not all(np.isfinite(s[3]) and np.isfinite(s[4]) for s in rec.steps):
        raise AssertionError("a train step's loss or PSNR is not finite")
    psnr_first = float(np.mean([s[3] for s in coarse[:50]]))
    psnr_last = float(np.mean([s[3] for s in fine[-50:]]))
    step_ms = {"coarse": median([s[2] for s in coarse[len(coarse) // 10:]]),
               "fine_top": median([s[2] for s in
                                   fine_top[len(fine_top) // 10:]])}
    log(f"[phase 5] train PSNR: first 50 coarse steps {psnr_first:.2f} dB, "
        f"last 50 fine steps {psnr_last:.2f} dB; median step "
        f"{step_ms['coarse']:.2f} ms coarse, {step_ms['fine_top']:.2f} ms "
        f"fine at {top} voxels (host clock around a synced step)")
    if not psnr_last > psnr_first:
        raise AssertionError(f"train PSNR did not rise: {psnr_first} -> "
                             f"{psnr_last}")

    # The checkpoints load back, with finite parameters.
    models = {}
    for stage in ("coarse", "fine"):
        path = os.path.join(logdir, f"{stage}_last.tar")
        st = ckpt_lib.load_checkpoint_file(path)
        models[stage] = ckpt_lib.load_model(DirectVoxGO, path, device=dev)
        finite = all(bool(torch.isfinite(p).all())
                     for p in models[stage].parameters())
        log(f"[phase 5] {path}: step {st['global_step']}, world_size "
            f"{models[stage].world_size}, optimizer step "
            f"{int(st['optimizer_state_dict']['step'])}, finite {finite}")
        if not (finite and st["global_step"] == (
                N_COARSE if stage == "coarse" else N_FINE)):
            raise AssertionError(f"{path}: step {st['global_step']}, "
                                 f"finite {finite}")

    # One checked step: under the clip box the full-size density cotangent
    # is exactly zero outside the box (skip_zero_grad relies on it).
    cm = models["coarse"]
    v = int(data["i_train"][0])
    H, W = (int(x) for x in data["HW"][v])
    ro, rd, vd = (torch.as_tensor(x.reshape(-1, 3), device=dev)
                  for x in ray_lib.get_rays_of_a_view(
                      H, W, data["Ks"][v], data["poses"][v], False, False,
                      False, False))
    gt = torch.as_tensor(np.asarray(data["images"][v], np.float32).reshape(
        -1, 3), device=dev)
    axes = sweep_ops.dominant_axis(rd.cpu().numpy(), cm.xyz_min, cm.xyz_max,
                                   cm.world_size)
    axis = int(np.bincount(axes, minlength=3).argmax())
    sel = torch.as_tensor(np.flatnonzero(axes == axis)[::7][:8192],
                          device=dev)
    # the occupancy the fine stage takes from this checkpoint
    # (mask_cache_thres), so that the box is the object's
    from directvoxgo_tpu_torch.ops import grid as grid_ops
    with torch.no_grad():
        cm.mask = cm.mask & (cm.activate_density(grid_ops.max_pool3d_same(
            cm.density)) >= cfg.fine_model_and_render.mask_cache_thres)
    clip_sizes, clip_off = cm.sweep_clip_for_axis(axis, CLIP_QUANTUM)
    if clip_sizes is None:
        raise AssertionError("the coarse model's occupancy box does not "
                             "clip the sweep")
    rk = {"near": data["near"], "far": data["far"], "bg": 1.0,
          "stepsize": cfg.coarse_model_and_render.stepsize}
    ret = cm.forward_sweep(ro[sel], rd[sel], vd[sel], axis,
                           clip_sizes=clip_sizes, clip_offsets=clip_off, **rk)
    g_dens, = torch.autograd.grad(
        torch.mean((ret["rgb_marched"] - gt[sel]) ** 2), cm.density)
    inv = {ax: i for i, ax in enumerate(sweep_ops._PERMS[axis])}
    inside = torch.zeros(cm.world_size, dtype=torch.bool, device=dev)
    inside[tuple(slice(int(clip_off[inv[a]]),
                       int(clip_off[inv[a]]) + clip_sizes[inv[a]])
                 for a in range(3))] = True
    n_out = int((g_dens[~inside] != 0).sum())
    n_in = int((g_dens[inside] != 0).sum())
    log(f"[phase 5] clip box {clip_sizes} at {clip_off.tolist()} of "
        f"{cm.world_size} (axis {axis}): density cotangent nonzero at {n_in} "
        f"voxels inside, {n_out} outside")
    if n_out != 0 or n_in == 0:
        raise AssertionError(f"density cotangent: {n_out} nonzero voxels "
                             f"outside the clip box, {n_in} inside")

    # Re-entering run.main resumes without training and renders the test
    # views of the trained model through K-B / K-A.
    cap_r = Capture(run_lib, "render_viewpoints", results=True)
    ka.launches = kb.launches = kc.launches = 0
    try:
        run_lib.main(["--config", cfg_path, "--render_test", "--device",
                      str(dev)])
        torch.cuda.synchronize()
    finally:
        cap_r.restore()
    stats = cap_r.results[0][2]
    psnr_test = float(np.mean(stats["psnr"]))
    white = [float(-10.0 * np.log10(np.mean(
        (1.0 - np.asarray(data["images"][i], np.float32)) ** 2)))
        for i in data["i_test"]]
    log(f"[phase 5] --render_test of fine_last.tar: paths {stats['path']}, "
        f"K-B launches {kb.launches}, K-A launches {ka.launches}, K-C "
        f"launches {kc.launches}; test PSNR {psnr_test:.2f} dB, a white "
        f"frame scores {float(np.mean(white)):.2f} dB")
    if not (kc.launches == 0 and kb.launches + ka.launches > 0
            and psnr_test > float(np.mean(white))):
        raise AssertionError(f"render of the trained model: PSNR "
                             f"{psnr_test} vs white {np.mean(white)}, "
                             f"launches K-B {kb.launches} K-A {ka.launches} "
                             f"K-C {kc.launches}")

    # A few train steps with per-ray-tile v-windows (which only unclipped
    # sweeps take) on the trained fine model: K-A's and K-C's per-tile
    # windowed forms in a train step. This is a side path of this script:
    # the engine's window draws ride the clip box, so run.main launches
    # neither. The tiles come from `build_tile_buckets`, those with the
    # most rays through the occupancy first (tiles of rays that miss the
    # grid have the narrowest windows); their windows widen to the widest
    # class taken.
    fm = models["fine"]
    rk_f = {"near": data["near"], "far": data["far"], "bg": 1.0,
            "stepsize": cfg.fine_model_and_render.stepsize}
    rd_np, ro_np = rd.cpu().numpy(), ro.cpu().numpy()
    axes = sweep_ops.dominant_axis(rd_np, fm.xyz_min, fm.xyz_max,
                                   fm.world_size)
    axis = int(np.bincount(axes, minlength=3).argmax())
    idx = np.flatnonzero(axes == axis)
    n_rand = int(cfg.fine_train.N_rand)
    bk = sweep_ops.build_tile_buckets(ro_np[idx], rd_np[idx], fm.xyz_min,
                                      fm.xyz_max, fm.world_size, axis)
    hit = fm.hit_coarse_geo(ro_np[idx], rd_np[idx], data["near"],
                            data["far"], cfg.fine_model_and_render.stepsize)
    tiles = sorted(((int(hit[r].sum()), w, r, vlo)
                    for w in bk if w for r, vlo in zip(*bk[w])),
                   key=lambda t: -t[0])[:n_rand // 512]
    if len(tiles) < n_rand // 512 or tiles[-1][0] == 0:
        raise AssertionError(f"the view's tile buckets {list(bk)} hold "
                             f"{len(tiles)} windowed tiles through the "
                             f"occupancy, not {n_rand // 512}")
    wv = max(t[1] for t in tiles)
    sel = torch.as_tensor(idx[np.stack([t[2] for t in tiles]).reshape(-1)],
                          device=dev)
    v_base = torch.as_tensor([t[3] for t in tiles], dtype=torch.int32,
                             device=dev)
    gv = int(fm.world_size[sweep_ops._PERMS[axis][2]])
    if not 0 < wv < gv:
        raise AssertionError(f"tile windows of width {wv} do not narrow the "
                             f"{gv}-wide sweep")
    full = fm.forward_sweep(ro[sel], rd[sel], vd[sel], axis, **rk_f)
    cap_w = Capture(sweep_ops, "sweep_fwd", keep=1)
    try:
        win = fm.forward_sweep(ro[sel], rd[sel], vd[sel], axis,
                               tile_windows=(v_base, wv), **rk_f)
    finally:
        cap_w.restore()
    w_err = float((win["rgb_marched"] - full["rgb_marched"]).detach().abs()
                  .max())
    log(f"[phase 5] tile windows: axis {axis}, {n_rand // 512} tiles, wv "
        f"{wv} of {gv}; windowed vs full sweep max|rgb diff| {w_err:.3e}")
    if not w_err <= 1e-6:
        raise AssertionError(f"windowed sweep differs from the full sweep by "
                             f"{w_err}")
    opt = train_lib.create_optimizer_or_freeze_model(fm, cfg.fine_train)
    step = train_lib.make_train_step(fm, opt, cfg.fine_train, rk_f, False,
                                     False, axis=axis, clip_sizes=None,
                                     wv=wv)
    pool = {"rgb": gt, "rays_o": ro, "rays_d": rd, "viewdirs": vd}
    ka.launches_windowed = kc.launches = 0
    for _ in range(3):
        loss_w, _ = step(pool, sel, np.zeros(3, np.int32), v_base)
    torch.cuda.synchronize()
    win_launches = ka.launches_windowed
    log(f"[phase 5] 3 windowed train steps (side path): loss {float(loss_w):.6f}, "
        f"windowed K-A launches {win_launches}, K-C launches {kc.launches}")
    if not (win_launches == 3 and kc.launches == 3
            and np.isfinite(float(loss_w))):
        raise AssertionError("windowed train steps did not run through the "
                             "windowed kernels")

    # Graphed steps against eager ones from one state, at full width: an
    # 8-step coarse chunk, a fine window step at the top grid, a blocked
    # step (its batches built here from the fine pool).
    graph_checks = {}
    for name, stage, kind, vox in (("lego coarse chunk", "coarse", "plain",
                                    None),
                                   ("lego fine window", "fine", "window",
                                    top)):
        st = busiest_step(rec, stage, kind, voxels=vox)
        model_g, args_g, kw_g = rec.made[id(st)]
        # phase 12 takes these steps through the data-parallel step
        DP_INPUTS[name] = (model_g, args_g, kw_g, *recent_batches(rec, st))
        graph_checks[name] = graph_vs_eager(
            torch, dev, name, model_g, args_g, kw_g, *DP_INPUTS[name][3:])
    model_g, args_g, kw_g = rec.made[id(st)]
    pool_g = rec.recent[id(st)][0][0]
    b_key, b_sels, b_offs = blocked_batches(torch, model_g, pool_g,
                                            kw_g["axis"],
                                            int(cfg.fine_train.N_rand))
    graph_checks["lego fine blocked"] = graph_vs_eager(
        torch, dev, "lego fine blocked", model_g, args_g,
        dict(kw_g, clip_sizes=b_key), pool_g, b_sels, b_offs)

    # Every form the training path launched, on the inputs of its last
    # call there, against the plain version and timed.
    entries = []
    for form in want:
        (slabs, f_rays, f_k, f_vb, f_wv), _ = cap_a.forms[form]
        zero_slab = not bool(slabs.any())
        err = check_sweep_rel(ka, slabs, f_rays, f_k, f_vb, f_wv,
                              f"training path, {form}", zero_slab=zero_slab)
        if zero_slab:
            # A counted view sweeps a zero grid (only its transpose is
            # wanted), which checks no tap: the same rays over a seeded
            # random slab of that shape and dtype do.
            gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
            rand = torch.randn(slabs.shape, generator=gen).to(
                slabs.dtype).to(dev)
            err = max(err, check_sweep_rel(
                ka, rand, f_rays, f_k, f_vb, f_wv,
                f"training path, {form}, seeded random slab"))
        nums = fwd_numbers(torch, ka, slabs, f_rays, f_k, f_vb, f_wv)
        log(f"[phase 5] K-A {form}: {nums}")
        entries.append(dict(
            {"name": f"sweep_fwd [{form}]", "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
             "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
             "launches": cap_a.counts[form], "max_abs_err": err}, **nums))

    # K-A windowed, on the inputs of the windowed steps above. No entry
    # point launches this form yet: its count is of those three steps.
    (w_slabs, w_rays, w_k, w_vb, w_wv), _ = cap_w.calls[0]
    err_w = check_sweep_rel(ka, w_slabs, w_rays, w_k, w_vb, w_wv,
                            "windowed, fine model")
    nums = fwd_numbers(torch, ka, w_slabs, w_rays, w_k, w_vb, w_wv)
    log(f"[phase 5] K-A windowed: {nums}")
    entries.append(dict(
        {"name": "sweep_fwd_windowed", "route": "cuda",
         "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
         "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85 "
                     "(windowed pallas_call :198)",
         "launches": win_launches, "max_abs_err": err_w,
         "launches_of": "3 windowed train steps built by this script; "
                        "run.main launched this form "
                        f"{train_launches['sweep_fwd_windowed']} times"},
        **nums))

    form_errs = check_kernel_forms(ka, kc, cap_ka, cap_kc,
                                   "training path")
    for form in want:
        (g, c_rays, c_k, c_shape, c_dtype, c_vb, c_wv), _ = cap_c.forms[form]
        err = check_bwd(kc, g, c_rays, c_k, c_shape, c_dtype, c_vb, c_wv,
                        f"training path, {form}")
        nums = bwd_numbers(torch, kc, g, c_rays, c_k, c_shape, c_dtype, c_vb,
                           c_wv)
        log(f"[phase 5] K-C {form}: {nums}")
        entries.append(dict(
            {"name": f"sweep_bwd [{form}]", "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/sweep_bwd.cu",
             "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:247 "
                         "(fold_bwd_partials :356)",
             "launches": cap_c.counts[form], "max_abs_err": err}, **nums))
    summary = {"steps": [N_COARSE, N_FINE], "pg_scale": PG_SCALE,
               "counted_views": n_views, "top_voxels": top,
               "steps_at_top": len(fine_top),
               "coarse_step_ms": step_ms["coarse"],
               "fine_step_ms": step_ms["fine_top"],
               "train_psnr_first50_coarse": psnr_first,
               "train_psnr_last50_fine": psnr_last, "test_psnr": psnr_test,
               "white_psnr": float(np.mean(white)),
               "sweep_launches_per_step": 1,
               "sweep_launches_per_counted_view": 1,
               "sweep_launches_by_form": forms,
               "voxel_count_views_s": count_timer.seconds.get(
                   "voxel_count_views"),
               "bucket_build_s": count_timer.seconds.get("_build_segments"),
               "draw_kinds": dict(kinds),
               "fine_draw_classes_at_top": classes,
               "fine_step_trace": step_trace,
               "fine_window_vs_unwindowed": window_trace,
               "steps_by_how_they_ran": ran,
               "graphed_vs_eager": graph_checks,
               "kernel_forms_checked": form_errs}
    return entries, summary


# ----------------------------------------------------------------- phase 6

FUSED_CONFIG = os.path.join(CKPT_DIR, "train_lego_fused.py")
GATED_EVERY = 50    # every how many fused steps the gated samples are counted


class GatedCounter:
    """Wraps ``train_fused.train_fwd`` in its module: the call still launches
    (and counts) as before; the inputs of the last call are kept, and at
    every ``GATED_EVERY``-th call the samples whose weight passes the gate
    are counted with the plain version's march."""

    def __init__(self, tf):
        self.tf, self.orig = tf, tf.train_fwd
        self.calls, self.last, self.gated = 0, None, []
        tf.train_fwd = self

    def __call__(self, *args, cfg):
        self.last = (args, cfg)
        if self.calls % GATED_EVERY == 0:
            st = self.tf._March(args[0], args[1], cfg, args[8], args[9])
            self.gated.append(int(st.sel[0].numel()))
        self.calls += 1
        return self.orig(*args, cfg=cfg)

    def restore(self):
        self.tf.train_fwd = self.orig


# The diagnostic forms of K-D and K-E timed beside each (train_fused.py's
# MODE_* bits): the march and gates alone; K-E without its MLP, without its
# per-sample global scatters, without its reverse walk.
FUSED_FORMS = {"train_fwd": (("no_mlp", "MODE_NO_MLP"),),
               "train_bwd": (("no_mlp", "MODE_NO_MLP"),
                             ("no_scatter", "MODE_NO_SCATTER"),
                             ("no_phase2", "MODE_NO_PHASE2"))}


def fused_numbers(torch, tf, args, cfg, gp, cot):
    """K-D and K-E on these inputs: their times, their plain versions', and
    their bounds from what this batch needs. Bytes: the distinct slab voxels
    the marched stations tap (density and mask) and the gated samples tap
    (features), rays, sh1, window cells, weights and the outputs (K-E: the
    touched voxels of the two f32 accumulators, d_sh1 and the weight
    gradients); each input once, although K-E taps the slabs twice, and
    without K-E's scratch (T per march block and dL/dw_eff per gated
    sample, 4 bytes each). Operations: the MLP of the gated samples on the
    tensor cores (once for K-D, three times for K-E: forward again and two
    products per layer backward) plus about 60 f32 operations per marched
    station (120 for K-E, which marches twice and scatters)."""
    slabs, rays16, sh1_t, w1a, w2, b2, w3, b3, desc, uvb = args
    s_real, gu, gv, c = slabs.shape
    n = rays16.shape[1]
    width, f = cfg.width, cfg.f
    st = tf._March(slabs, rays16, cfg, desc, uvb)
    gated = int(st.sel[0].numel())
    # stations the march visits: on a slab, inside [t_lo, t_hi], alive
    any_w = (st.wu[0] + st.wu[1] > 0) & (st.wv[0] + st.wv[1] > 0)
    op, dp, tlo, thi = rays16[0], rays16[3], rays16[6], rays16[7]
    s_pad, p0, pstep = tf.march_scalars(s_real, cfg.k, cfg.s_blk, desc)
    ms = torch.arange(s_pad, device=slabs.device, dtype=torch.float32)
    t = ((p0 + pstep * ms)[:, None] - op[None]) / dp[None]
    marched = any_w & st.live & (t >= tlo[None]) & (t <= thi[None]) \
        & (thi > tlo)[None]

    def voxels(sel):
        hit = torch.zeros((s_real, gu, gv), dtype=torch.bool,
                          device=slabs.device)
        ms_i, ray_i = sel
        for a in (0, 1):
            for b in (0, 1):
                ok = (st.wu[a][ms_i, ray_i] > 0) & (st.wv[b][ms_i, ray_i] > 0)
                hit[st.sidx_c[ms_i][ok], st.iu[a][ms_i, ray_i][ok],
                    st.iv[b][ms_i, ray_i][ok]] = True
        return int(hit.sum())

    # How evenly the work falls on the kernels' blocks (64 rays each) and on
    # groups of 16 rays: gated samples per block, mean and largest.
    per_ray = torch.bincount(st.sel[1], minlength=n).float()
    spread = {f"{r}_rays": [float(per_ray.reshape(-1, r).sum(1).mean()),
                            float(per_ray.reshape(-1, r).sum(1).max())]
              for r in (16, 64)}
    geo_vox = voxels(torch.nonzero(marched, as_tuple=True))
    feat_vox = voxels(st.sel)
    n_marched = int(marched.sum())
    weights = (w1a.numel() + w2.numel() + w3.numel()) * 2 \
        + (b2.numel() + b3.numel()) * 4
    common = geo_vox * 2 * 2 + feat_vox * (c - 2) * 2 + 12 * n * 4 \
        + width * n * 4 + (uvb.numel() * 4 if uvb is not None else 0) \
        + weights
    mlp = gated * 2 * (f * width + width * width + 3 * width)

    b_args = list(args[:2]) + [cot] + list(args[2:])
    kernel = {"train_fwd": lambda mode=0: lambda: tf.train_fwd(
                  *args, cfg=cfg, mode=mode),
              "train_bwd": lambda mode=0: lambda: tf.train_bwd(
                  *b_args, cfg=cfg, gp=gp, mode=mode)}
    first = {"train_fwd": lambda mode=0: prev_fused_call(
                 torch, args, cfg, mode=mode),
             "train_bwd": lambda mode=0: prev_fused_call(
                 torch, args, cfg, gp, cot, mode=mode)}
    outs = kernel["train_bwd"]()()
    touched = (int((outs[0] != 0).sum()), int((outs[1] != 0).any(-1).sum()))
    out = {}
    for name, plain, n_bytes, t_ops in (
            ("train_fwd",
             lambda: tf.train_fwd_plain(*args, cfg=cfg),
             common + 8 * n * 4,
             mlp / BF16_FLOPS + n_marched * 60 / F32_FLOPS),
            ("train_bwd",
             lambda: tf.train_bwd_plain(*b_args, cfg=cfg, gp=gp),
             common + 6 * n * 4 + touched[0] * 4 + touched[1] * (c - 2) * 4
             + width * n * 4 + weights * 2,
             3 * mlp / BF16_FLOPS + n_marched * 120 / F32_FLOPS)):
        by = "bytes" if n_bytes / HBM_BPS >= t_ops else "operations"
        # Device time only, the first version in turns with the kernel.
        prev = cuda_time(first[name](), 20, device_only=True)
        ms = cuda_time(kernel[name](), 20, device_only=True)
        prev_again = cuda_time(first[name](), 20, device_only=True)
        # The diagnostic forms (FUSED_FORMS) of both versions: where the
        # time goes.
        forms = {form: cuda_time(kernel[name](getattr(tf, mode)), 10,
                                 device_only=True)
                 for form, mode in FUSED_FORMS[name]}
        prev_forms = {form: cuda_time(first[name](getattr(tf, mode)), 10,
                                      device_only=True)
                      for form, mode in FUSED_FORMS[name]}
        lib = f"train_fused_{name[6:]}"
        out[name] = {
            "ms": ms, "plain_ms": cuda_time(plain, 3, warmup=1),
            "prev_ms": min(prev, prev_again),
            "prev_ms_runs": [prev, prev_again],
            "forms_ms": forms, "prev_forms_ms": prev_forms,
            "usage": {w: kernel_usage(lib, f"{lib}_kernel", w)
                      for w in (32, 64, 128)},
            "prev_usage": {w: kernel_usage(f"{lib}_first", f"{lib}_kernel",
                                           w) for w in (32, 64, 128)},
            "bound_ms": max(n_bytes / HBM_BPS, t_ops) * 1e3, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes the march, "
                       "the gates and the MLP together",
            "bytes": n_bytes, "mlp_operations": mlp * (1 if name ==
                                                       "train_fwd" else 3),
            "gated_samples": gated, "marched_stations": n_marched,
            "gated_per_block_mean_max": spread,
            "slab_voxels_read": [geo_vox, feat_vox],
            "shape": f"S={s_real} slab={gu}x{gv}x{c} N={n} W={width} F={f} "
                     f"window={'%dx%d' % (cfg.wu, cfg.wv) if uvb is not None else 'none'}"}
    out["train_bwd"]["voxels_touched"] = list(touched)
    return out


def profile_step(torch, step, args, kwargs, n_steps=3, share_of=()):
    """``n_steps`` more calls of a train step (or render) under
    ``torch.profiler``, after one untraced call: ``tools.trace_step.
    profile_steps``'s numbers per step (wall, busy, idle share, launches,
    top kernels and operators, the busy share of each name in
    ``share_of``)."""
    from directvoxgo_tpu_torch.tools.trace_step import profile_steps

    def steps():
        for _ in range(n_steps):
            step(*args, **kwargs)
    return profile_steps(steps, n_steps, share_of,
                         warm=lambda: step(*args, **kwargs))


# ----------------------------------------- train steps: graphed vs eager

# The eager engine's median step wall ms, host clock around a synced step,
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5): lego fine at
# 160^3 over all draws, fern at the top grid with dense and with sparse TV.
# Earlier figures, logged beside this run's medians on stderr only: the
# JSON lines carry what this run measured.
EAGER_STEP_MS = {"lego fine at 160^3": 11.45, "fern dense TV": 22.39,
                 "fern sparse TV": 10.51}
# The share of a training run's steps that must have been replayed from a
# CUDA graph (the rest: each key's eager first step and its capture).
MIN_REPLAYED_SHARE = 0.5
def graph_vs_eager(torch, dev, what, model, make_args, make_kw, pool, sels,
                   offs):
    """The steps of one step key on ``sels`` [n, N] and ``offs`` [n, ...]
    (host arrays), from one state (copies of ``model`` and its optimizer,
    ``make_args[0]``), replayed as CUDA graphs (``StepGraphs``: the first
    step eager, the second captured) and run eagerly (``graphed=False``):
    the losses agree within ``WINDOW_TOL[0]`` relative and the parameters
    within ``WINDOW_TOL[1]`` of their scale (K-C sums in another order each
    run, and Adam turns such noise near zero gradients into steps). Then
    both go on over the same batches, timed and traced; returns the
    numbers."""
    import copy
    import numpy as np
    from directvoxgo_tpu_torch.engine import graphs as graphs_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.tools.trace_step import profile_steps
    n = sels.shape[0]
    key = (make_kw["axis"], make_kw.get("clip_sizes"))
    runs = {}
    for graphed in (True, False):
        m, opt = copy.deepcopy((model, make_args[0]))
        step = train_lib.make_train_step(m, opt, *make_args[1:], **make_kw)
        sg = graphs_lib.StepGraphs(dev, graphed=graphed)
        sg.reset(scratch=(np_prod(m.world_size), 2 + m.k0_dim))
        res = sg.run(key, step, pool, sels, offs).cpu().numpy()
        runs[graphed] = (m, step, sg, res)
    (mg, _, sg_g, res_g), (me, _, sg_e, res_e) = runs[True], runs[False]
    d_loss = np.abs(res_g[:, 0] - res_e[:, 0])
    d_par, scale = [], []
    for a, b in zip(mg.parameters(), me.parameters()):
        d_par.append(float((a - b).detach().abs().max()))
        scale.append(max(1.0, float(b.detach().abs().max())))
    ok = (np.isfinite(res_g).all() and np.isfinite(res_e).all()
          and bool(np.all(d_loss <= WINDOW_TOL[0]
                          * np.maximum(1.0, np.abs(res_e[:, 0]))))
          and all(d <= WINDOW_TOL[1] * sc for d, sc in zip(d_par, scale))
          and dict(sg_g.stats) == {"eager": 1, "capture": 1,
                                   "replay": n - 2})
    log(f"[graphs] {what}: key {key}, {n} steps ({dict(sg_g.stats)}): "
        f"largest loss difference {float(d_loss.max()):.3e} (loss "
        f"{float(res_e[-1, 0]):.6f}), largest parameter difference "
        f"{max(d_par):.3e}")
    if not ok:
        raise AssertionError(f"graphed steps of {what} differ from eager "
                             f"ones: loss {d_loss.tolist()}, parameters "
                             f"{d_par}, runs {dict(sg_g.stats)}")
    out = {"key": str(key), "steps": n, "max_loss_diff": float(d_loss.max()),
           "max_param_diff": max(d_par),
           "capture_s": next(iter(sg_g.capture_s.values()))}
    for graphed, name in ((True, "graphed"), (False, "eager")):
        m, step, sg, _ = runs[graphed]
        chunk = (lambda sg=sg, step=step:
                 sg.run(key, step, pool, sels, offs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / n
        out[f"{name}_trace"] = profile_steps(chunk, n)
    log(f"[graphs] {what}: {out}")
    del runs
    return out


def blocked_batches(torch, model, pool, axis, n_rand, n_max=8):
    """A blocked step key ``('blk', B, eu, ev)`` of ``model`` and up to
    ``n_max`` of its batches (pool indices [n, N], per-block (u, v) starts
    [n, B, 2]): the axis group's rays of the pool (a seeded subset of at
    most 400,000) through ``build_ray_segments_blocked``, the most
    populous window class."""
    import numpy as np
    from directvoxgo_tpu_torch.engine import draws as draws_lib
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    ro = pool["rays_o"].cpu().numpy()
    rd = pool["rays_d"].cpu().numpy()
    g = np.flatnonzero(sweep_ops.sweep_axes(model, rd) == axis)
    if g.size > 400_000:
        g = np.sort(np.random.default_rng(SEED).choice(g, 400_000,
                                                       replace=False))
    ws = tuple(int(x) for x in model.world_size)
    bk = sweep_ops.build_ray_segments_blocked(
        ro[g], rd[g], model.xyz_min, model.xyz_max, ws, axis,
        n_rand=n_rand, n_blocks=6, widths=draws_lib.WINDOW_WIDTHS,
        max_classes=4)
    cls = max((k for k in bk if k != (0, 0)),
              key=lambda k: bk[k][0].shape[0])
    idx, uo, vo = bk[cls]
    # at least three batches (eager, capture, a replay); a class of fewer
    # segments repeats them
    n = max(3, min(n_max, idx.shape[0]))
    idx, uo, vo = (np.resize(x, (n, *x.shape[1:])) for x in (idx, uo, vo))
    perm = sweep_ops._PERMS[axis]
    key = ("blk", int(uo.shape[1]),
           *draws_lib.Draws._eff(cls, ws[perm[1]], ws[perm[2]]))
    offs = np.stack([np.stack([uo[r], vo[r]], 1) for r in range(n)])
    return key, g[idx[:n]], offs.astype(np.int32)


def recent_batches(rec, step):
    """The last batches of a recorded step: (pool, sels [n, N], offs [n,
    ...]) as host arrays."""
    import numpy as np
    batches = list(rec.recent[id(step)])
    sels = np.stack([b[1].cpu().numpy() for b in batches])
    offs = np.stack([np.asarray(b[2].cpu() if hasattr(b[2], "cpu")
                                else b[2]) for b in batches])
    return batches[0][0], sels, offs


def busiest_step(rec, stage, kind, tv=None, voxels=None):
    """Of the recorded steps of ``stage`` (None: any) and draw ``kind``
    (and TV form, grid size), the step object with the most recent
    batches; None if there is none."""
    best = None
    for st in rec.kept:
        form = rec.kind_of.get(id(st))
        if (form is None or form[1] != kind
                or (stage is not None and form[0] != stage)
                or (tv is not None and form[2] != tv)
                or (voxels is not None and form[3] != voxels)):
            continue
        if best is None or len(rec.recent[id(st)]) > len(
                rec.recent[id(best)]):
            best = st
    return best


def fused_phase(torch, dev, tf, ka, kc, sweep_ops, phase5):
    """Phase 6; returns the kernels-line entries of K-D and K-E and a summary
    of the fused training run."""
    import shutil
    import numpy as np
    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import draws as draws_lib
    from directvoxgo_tpu_torch.engine import train as train_lib

    with open(FUSED_CONFIG, "w") as f:
        f.write(f"_base_ = {TRAIN_BASE!r}\n"
                "expname = 'train_lego_fused'\n"
                "basedir = './logs/chip_smoke'\n"
                f"coarse_train = {{'N_iters': {N_COARSE}}}\n"
                f"fine_train = {{'N_iters': {N_FINE}, "
                f"'pg_scale': {PG_SCALE}}}\n")
    cfg = Config.fromfile(FUSED_CONFIG)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    shutil.rmtree(logdir, ignore_errors=True)
    os.makedirs(logdir)
    # The coarse stage is not trained twice: phase 5's checkpoint is this
    # run's, so run.main finds the stage done and goes on to the fine one.
    shutil.copy(os.path.join(cfg.basedir, "train_lego", "coarse_last.tar"),
                os.path.join(logdir, "coarse_last.tar"))

    rec = StepRecorder(train_lib)
    counter = GatedCounter(tf)
    cap_e = Capture(tf, "train_bwd", keep=1)
    cap_t = Capture(sweep_ops, "build_ray_tiles_blocktile", results=True)
    cap_ka = Capture(sweep_ops, "sweep_fwd", form=ka_form(ka))
    cap_kc = Capture(sweep_ops, "sweep_bwd", form=kc_form(torch, kc))
    builds = CallTimer(torch, [(draws_lib.Draws, "_build_fused")])
    per_replay = PerReplay(cap_ka, cap_kc)
    tf.launches_fwd = tf.launches_bwd = ka.launches = kc.launches = 0
    env_before = os.environ.get("DVGO_FUSED_TRAIN")
    os.environ["DVGO_FUSED_TRAIN"] = "1"
    t0 = time.time()
    try:
        run_lib.main(["--config", FUSED_CONFIG, "--i_print", "100",
                      "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        if env_before is None:
            del os.environ["DVGO_FUSED_TRAIN"]
        else:
            os.environ["DVGO_FUSED_TRAIN"] = env_before
        rec.restore()
        per_replay.restore()
        counter.restore()
        for cap in (cap_kc, cap_ka, cap_t, cap_e):
            cap.restore()
        builds.restore()
    launches = {"train_fwd": tf.launches_fwd, "train_bwd": tf.launches_bwd,
                "sweep_fwd": ka.launches, "sweep_bwd": kc.launches}
    run_steps = list(rec.steps)
    fused = [s for s in run_steps if s[5]]
    plain = [s for s in run_steps if not s[5]]
    top = max(s[1] for s in run_steps)
    fused_top = [s for s in fused if s[1] == top]
    kinds = collections.Counter(s[6] for s in run_steps)
    log(f"[phase 6] run.main (DVGO_FUSED_TRAIN=1) trained {len(run_steps)} "
        f"fine steps in {time.time() - t0:.1f} s: {len(fused)} fused, "
        f"{len(plain)} unfused (draws {dict(kinds)}); launches {launches}; "
        f"tile builds {builds.seconds} s")
    # One K-D and one K-E launch per fused step; the unfused steps (the
    # remainder: over the clip box, or re-bucketed into 2D windows and
    # per-block windows where windows engage) one K-A and one K-C launch
    # each, or one per block. As in the JAX engine, steps fuse only where
    # it takes one step a dispatch (grids past 1.1 M voxels): there at
    # least half of them do, and none below.
    allowed = [s for s in run_steps
               if s[1] > draws_lib.SMALL_GRID_VOXELS]
    log(f"[phase 6] fusing allowed on {len(allowed)} of {len(run_steps)} "
        f"steps; steps by how they ran: {how_steps_ran(run_steps)}")
    if not (all(s[0] == "fine" for s in run_steps)
            and len(run_steps) == N_FINE and allowed
            and 2 * len(fused) >= len(allowed)
            and all(s[1] > draws_lib.SMALL_GRID_VOXELS for s in fused)
            and len(fused_top) >= MIN_TOP_STEPS // 2
            and kinds["window"] + kinds["blocked"] > 0
            and launches["train_fwd"] == launches["train_bwd"] == len(fused)
            and launches["sweep_fwd"] == launches["sweep_bwd"]
            == sweep_launches(plain)):
        raise AssertionError(
            f"{len(run_steps)} steps ({len(fused)} fused, {len(fused_top)} "
            f"at the top grid; draws {dict(kinds)}) do not match the "
            f"launches {launches}")
    classes = draw_classes([s for s in run_steps if s[1] == top])
    log(f"[phase 6] draws at {top} voxels by step key: {classes}")
    form_errs = check_kernel_forms(ka, kc, cap_ka, cap_kc,
                                   "fused run's unfused steps")
    if not all(np.isfinite(s[3]) and np.isfinite(s[4]) for s in rec.steps):
        raise AssertionError("a fused run's loss or PSNR is not finite")

    # Tile classes per axis (the last build of each axis: the top grid) and
    # the share of tiled rays no class covers.
    tiles = {}
    for (args, kw), res in zip(cap_t.calls, cap_t.results):
        n_all = sum(v.size for v in res.values())
        tiles[int(args[5])] = {
            "classes": {f"{k[0]}x{k[1]}{'+' if k[2] > 0 else '-'}":
                        int(v.shape[0]) for k, v in res.items() if k[2]},
            "remainder_share": (res[(0, 0, 0)].size / n_all
                                if (0, 0, 0) in res else 0.0),
            "box": kw.get("clip_box")}
    for ax, info in sorted(tiles.items()):
        log(f"[phase 6] tiles of axis {ax} at the top grid: {info}")
    step_ms = median([s[2] for s in fused_top[len(fused_top) // 10:]])
    plain_ms = median([s[2] for s in plain]) if plain else None
    psnr_last = float(np.mean([s[3] for s in rec.steps[-50:]]))
    log(f"[phase 6] median fused step at {top} voxels {step_ms:.2f} ms "
        f"(phase 5's unfused fine step {phase5['fine_step_ms']:.2f} ms; "
        f"unfused remainder steps of this run: {plain_ms}); samples with "
        f"w_eff > 0 per fused step, every {GATED_EVERY}th: {counter.gated}; "
        f"train PSNR of the last 50 steps {psnr_last:.2f} dB (phase 5 "
        f"{phase5['train_psnr_last50_fine']:.2f})")

    # Where a step's time goes: a few more steps of the last fused and the
    # last unfused (remainder) step of the run, traced (the checkpoint is
    # written; these steps train on and are not saved).
    profiles = {}
    for name, key in (("fused", ("fine", "fused")),
                      ("unfused", ("fine", "plain")),
                      ("window", ("fine", "window")),
                      ("blocked", ("fine", "blocked"))):
        if key in rec.last_kind:
            profiles[name] = profile_step(torch, *rec.last_kind[key])
            log(f"[phase 6] trace of the last {name} fine step: "
                f"{profiles[name]}")

    st = ckpt_lib.load_checkpoint_file(os.path.join(logdir, "fine_last.tar"))
    if st["global_step"] != N_FINE:
        raise AssertionError(f"fine_last.tar at step {st['global_step']}")
    cap_r = Capture(run_lib, "render_viewpoints", results=True)
    try:
        run_lib.main(["--config", FUSED_CONFIG, "--render_test", "--device",
                      str(dev)])
        torch.cuda.synchronize()
    finally:
        cap_r.restore()
    psnr_test = float(np.mean(cap_r.results[0][2]["psnr"]))
    log(f"[phase 6] --render_test of the fused run's fine_last.tar: test "
        f"PSNR {psnr_test:.2f} dB (phase 5's unfused run "
        f"{phase5['test_psnr']:.2f} dB, a white frame "
        f"{phase5['white_psnr']:.2f} dB)")
    if not psnr_test >= phase5["white_psnr"] + 3.0:
        raise AssertionError(f"fused run's test PSNR {psnr_test} is not 3 dB "
                             f"above a white frame's {phase5['white_psnr']}")

    # Both kernels on the inputs of the last fused step, against their plain
    # versions and timed.
    args, f_cfg = counter.last
    (b_args, b_kw), = cap_e.calls
    case = dict(zip(("slabs", "rays16", "sh1_t", "w1a", "w2", "b2", "w3",
                     "b3", "desc", "uvb"), args), cfg=f_cfg, gp=b_kw["gp"],
                cot=b_args[2])
    with torch.no_grad():
        err_f, err_b = check_fused(tf, case,
                                   "training path, last fused step")
        nums = fused_numbers(torch, tf, list(args), f_cfg, b_kw["gp"],
                             b_args[2])
    entries = []
    for name, err, line, tpu in (
            ("train_fwd", err_f, 170, "train_fwd_pallas"),
            ("train_bwd", err_b, 396, "train_bwd_pallas")):
        log(f"[phase 6] {name}: {nums[name]}")
        entries.append(dict(
            {"name": f"train_fused_{name[6:]}", "route": "cuda",
             "source": f"directvoxgo_tpu_torch/csrc/train_fused_{name[6:]}.cu",
             "replaces": f"directvoxgo_tpu/ops/pallas_train_fused.py:{line} "
                         f"({tpu})",
             "launches": launches[name], "max_abs_err": err}, **nums[name]))
    summary = {"steps": N_FINE, "fused_steps": len(fused),
               "unfused_steps": len(plain), "fused_steps_at_top":
               len(fused_top), "fused_step_ms": step_ms,
               "unfused_remainder_step_ms": plain_ms,
               "unfused_fine_step_ms_phase5": phase5["fine_step_ms"],
               "gated_samples_per_step": counter.gated,
               "train_psnr_last50": psnr_last, "test_psnr": psnr_test,
               "test_psnr_unfused_phase5": phase5["test_psnr"],
               "white_psnr": phase5["white_psnr"], "tiles": tiles,
               "draw_kinds": dict(kinds), "draw_classes_at_top": classes,
               "tile_build_s": builds.seconds.get("_build_fused"),
               "fusing_allowed_steps": len(allowed),
               "steps_by_how_they_ran": how_steps_ran(run_steps),
               "step_traces": profiles,
               "remainder_kernel_forms_checked": form_errs}
    return entries, summary


# ----------------------------------------------------------------- phase 7

FERN_CONFIG = os.path.join(CKPT_DIR, "train_fern.py")
FERN_BASE = '../../configs/synthetic/fixture_ndc_fern.py'
# The cuts of configs/synthetic/fixture_ndc_fern.py, iteration counts only:
# fine N_iters 25000 -> 1000, pg_scale [2000, 4000, 6000, 8000] -> [100,
# 200, 300, 400], tv_dense_before 10000 -> 700 (so both TV phases run at
# the top grid). Everything else is the config's: 17 views at 756x1008,
# N_rand 4096, 256^3 voxels at mpi_depth 128 (88x92x128 growing to
# 352x371x128), rgbnet_dim 9, width 64, top-K 64, TV weights 1e-5 on every
# step.
FERN_ITERS = 1000
FERN_PG_SCALE = [100, 200, 300, 400]
FERN_TV_DENSE_BEFORE = 700


def write_fern_config():
    os.makedirs(CKPT_DIR, exist_ok=True)
    with open(FERN_CONFIG, "w") as f:
        f.write(f"_base_ = {FERN_BASE!r}\n"
                "expname = 'train_fern'\n"
                "basedir = './logs/chip_smoke'\n"
                f"fine_train = {{'N_iters': {FERN_ITERS}, "
                f"'pg_scale': {FERN_PG_SCALE}, "
                f"'tv_dense_before': {FERN_TV_DENSE_BEFORE}}}\n")
    return FERN_CONFIG


class CallTimer:
    """Wraps functions in their module (or class) namespace and keeps the
    seconds of every call, ending in a device sync (``seconds``: name ->
    list); the calls still run as before."""

    def __init__(self, torch, targets):
        self.seconds = {}
        self.wrapped = []
        for owner, name in targets:
            orig = getattr(owner, name)
            self.wrapped.append((owner, name, orig))
            setattr(owner, name, self._wrap(torch, name, orig))

    def _wrap(self, torch, name, orig):
        def call(*a, **k):
            t0 = time.time()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(
                round(time.time() - t0, 4))
            return out
        return call

    def restore(self):
        for owner, name, orig in self.wrapped:
            setattr(owner, name, orig)


class TVRecorder:
    """Wraps the two entry points of K-F where the engine reaches them (the
    whole-grid ``total_variation_add_grad`` as the MPI model imported it,
    the boxed ``tv_add_grad_box`` in its module): every call still launches
    (and counts) as before; calls are counted by form (dense or sparse,
    whole grid or box, k0 or density, and the kernel's path,
    ``tv.path_of``), and the inputs of a form's last eager call are
    cloned (the train steps replay as CUDA graphs; each step key's first
    call is eager), so that every form can be replayed exactly."""

    def __init__(self, torch, tv_mod, mpi_mod):
        self.torch = torch
        self.tv = tv_mod
        self.counts = collections.Counter()
        self.kept = {}      # form -> (entry, args, kwargs)
        self.wrapped = []
        for mod, name in ((mpi_mod, "total_variation_add_grad"),
                          (tv_mod, "tv_add_grad_box")):
            orig = getattr(mod, name)
            self.wrapped.append((mod, name, orig))
            setattr(mod, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        boxed = name == "tv_add_grad_box"

        def call(param, grad, *args, **kw):
            # (wx, wy, wz, dense_mode) / (offs, wx, wy, wz[, dense_mode])
            dense = kw.get("dense_mode", args[3] if not boxed
                           else (args[4] if len(args) > 4 else False))
            path = self.tv.path_of(param, grad,
                                   args[0] if boxed else (0, 0, 0))
            form = (f"{'dense' if dense else 'sparse'}"
                    f"{' box' if boxed else ''} "
                    f"{'k0' if param.dim() == 4 else 'density'}, {path}")
            self.counts[form] += 1
            # Each eager call keeps its inputs (the last eager call of a
            # form: a step key's first call at the top grid); a call made
            # while a step is captured as a CUDA graph keeps none (its
            # tensors lie in the graphs' shared pool, which other graphs'
            # replays overwrite).
            if not self.torch.cuda.is_current_stream_capturing():
                self.kept[form] = (name, (param.detach().clone(),
                                          grad.clone(), *args), dict(kw))
            return orig(param, grad, *args, **kw)

        return call

    def restore(self):
        for mod, name, orig in self.wrapped:
            setattr(mod, name, orig)


def tv_numbers(torch, tv, name, args, kw, phase="7"):
    """K-F on these inputs, against its plain version and timed: the
    largest error beside the largest |TV| entry (the plain output minus the
    gradient), the zero patterns, and the bound: the gradient read and the
    output written once, and the parameter once where the stencil needs it
    (dense: the box and its 1-voxel halo inside the grid; sparse: the
    elements whose gradient is nonzero and their six neighbours), about 27
    f32 operations per element that takes the term."""
    param, grad = args[0], args[1]
    fn = getattr(tv, name)
    plain = getattr(tv, name + "_plain")
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    term = (ref - grad).abs()
    err = float((out - ref).abs().max())
    scale = float(term.max())
    zeros_differ = int(((out == 0) != (ref == 0)).sum())
    boxed = name == "tv_add_grad_box"
    dense = kw.get("dense_mode", args[5] if not boxed else
                   (args[6] if len(args) > 6 else False))
    gated_exact = True
    if not dense:
        off = grad == 0
        gated_exact = bool(torch.equal(out[off], grad[off] + 0.0))
    offs = tuple(int(o) for o in args[2]) if boxed else (0, 0, 0)
    c = int(param.shape[3]) if param.dim() == 4 else 1
    g4 = grad.reshape(*grad.shape[:3], c)
    dims = tuple(int(d) for d in param.shape[:3])
    sizes = tuple(int(d) for d in grad.shape[:3])
    start, hs = tv._halo_box(dims, offs, sizes)
    if dense:
        n_param = int(np_prod(hs)) * c
        n_term = grad.numel()
    else:
        need = torch.zeros((*hs, c), dtype=torch.bool, device=grad.device)
        inner = tuple(slice(o - s, o - s + z)
                      for o, s, z in zip(offs, start, sizes))
        need[inner] = g4 != 0
        core = need.clone()
        for ax in range(3):
            n = hs[ax]
            if n > 1:
                need.narrow(ax, 1, n - 1).logical_or_(core.narrow(ax, 0, n - 1))
                need.narrow(ax, 0, n - 1).logical_or_(core.narrow(ax, 1, n - 1))
        n_param = int(need.sum())
        n_term = int(core.sum())
    n_bytes = 4 * (n_param + 2 * grad.numel())
    ops = 27 * n_term + grad.numel()
    path = tv.path_of(param, grad, args[2] if boxed else offs)
    prev_call = prev_tv_call(torch, name, args, kw)
    prev_out = prev_call()
    prev_same = bool(torch.equal(prev_out, out))
    prev = cuda_time(prev_call, 20, device_only=True)
    ms = cuda_time(lambda: fn(*args, **kw), 20, device_only=True)
    prev_again = cuda_time(prev_call, 20, device_only=True)
    plain_ms = cuda_time(lambda: plain(*args, **kw), 5)
    by = "bytes" if n_bytes / HBM_BPS >= ops / F32_FLOPS else "operations"
    # (kernel, template arguments) of the instance, as csrc/tv_add_grad.cu
    # launches it
    kernel = (("tv_add_grad_kernel",) if path == "strided" else
              ("tv_rows_kernel", bool(dense)))
    log(f"[phase {phase}] K-F tv_add_grad {'box' if boxed else 'grid'} "
        f"{'dense' if dense else 'sparse'} param {tuple(param.shape)} box "
        f"{sizes} at {offs}: max|kernel-plain|={err:.3e} of the largest "
        f"|TV| {scale:.3e}, zero pattern differs at {zeros_differ}, gated "
        f"elements exactly the gradient: {gated_exact}, gradient nonzero "
        f"share {float((grad != 0).float().mean()):.4f}")
    if not (err == 0.0 and scale > 0 and zeros_differ == 0 and prev_same
            and gated_exact and bool(torch.isfinite(out).all())):
        raise AssertionError(f"K-F: err {err} of {scale}, zero pattern "
                             f"differs at {zeros_differ}, gated exact "
                             f"{gated_exact}, equal to the first version "
                             f"{prev_same}")
    return err, {"ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(n_bytes / HBM_BPS, ops / F32_FLOPS) * 1e3,
                 "bound_by": by, "library_ms": None,
                 "prev_ms": min(prev, prev_again),
                 "prev_ms_runs": [prev, prev_again],
                 "form": path,
                 **kernel_usage("tv_add_grad", *kernel),
                 "prev_usage": kernel_usage("tv_add_grad_first",
                                            "tv_add_grad_kernel"),
                 "bytes": n_bytes,
                 "param_elements_read": n_param,
                 "elements_with_term": n_term, "largest_tv": scale,
                 "shape": f"param {tuple(param.shape)} box {sizes} at "
                          f"{offs}, gradient nonzero "
                          f"{float((grad != 0).float().mean()):.4f}"}


def mpi_phase(torch, dev, tv, ka, kc, sweep_ops):
    """Phase 7; returns the kernels-line entries of the NDC path (K-F in
    each form the run launched, K-A on a step and a render chunk, K-C on a
    step) and a summary of the run."""
    import numpy as np
    from directvoxgo_tpu_torch import convert
    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import draws as draws_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models import dmpigo as mpi_mod

    cfg_path = write_fern_config()
    cfg = Config.fromfile(cfg_path)
    logdir = os.path.join(cfg.basedir, cfg.expname)

    rec = StepRecorder(train_lib)
    tvr = TVRecorder(torch, tv, mpi_mod)
    cap_a = Capture(sweep_ops, "sweep_fwd", form=rec.form)
    cap_c = Capture(sweep_ops, "sweep_bwd", form=rec.form)
    cap_ka = Capture(sweep_ops, "sweep_fwd", form=ka_form(ka))
    cap_kc = Capture(sweep_ops, "sweep_bwd", form=kc_form(torch, kc))
    stage_s = []
    orig_stage = train_lib.scene_rep_reconstruction

    def timed_stage(*a, **k):
        t_s = time.time()
        out = orig_stage(*a, **k)
        torch.cuda.synchronize()
        stage_s.append(time.time() - t_s)
        return out

    # Seconds of the work between steps: the state surgery (pg events,
    # renewals) and the checkpoint's parts (optimizer state to the host,
    # the f16 compaction, the pickled write of which it is a part, reads).
    timer = CallTimer(torch, [
        (mpi_mod.DirectMPIGO, "scale_volume_grid"),
        (mpi_mod.DirectMPIGO, "update_occupancy_cache"),
        (convert, "opt_state_to_jax"), (ckpt_lib, "_compact"),
        (ckpt_lib, "save_checkpoint_file"),
        (ckpt_lib, "load_checkpoint_file"),
        (draws_lib.Draws, "_build_segments")])
    train_lib.scene_rep_reconstruction = timed_stage
    per_replay = PerReplay(cap_a, cap_c, cap_ka, cap_kc, tvr)
    ka.launches = kc.launches = tv.launches = 0
    ka.launches_by_form.clear()
    kc.launches_by_form.clear()
    t0 = time.time()
    try:
        run_lib.main(["--config", cfg_path, "--no_reload", "--i_print",
                      "100", "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        timer.restore()
        train_lib.scene_rep_reconstruction = orig_stage
        rec.restore()
        per_replay.restore()
        tvr.restore()
        for cap in (cap_kc, cap_ka, cap_c, cap_a):
            cap.restore()
    wall_s = time.time() - t0
    launches = {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches,
                "tv_add_grad": tv.launches}
    forms = {"sweep_fwd": dict(ka.launches_by_form),
             "sweep_bwd": dict(kc.launches_by_form)}
    steps = list(rec.steps)
    top = max(s[1] for s in steps)
    top_steps = [s for s in steps if s[1] == top]
    steps_s = sum(s[2] for s in steps) / 1e3
    log(f"[phase 7] run.main trained {len(steps)} MPI steps (pg_scale "
        f"{FERN_PG_SCALE}, {len(top_steps)} at {top} voxels) in "
        f"{wall_s:.1f} s, the stage in {stage_s} s: steps {steps_s:.1f} s, "
        f"between steps {timer.seconds} s; launches {launches}; K-F calls "
        f"by form {dict(tvr.counts)}")
    # One K-A and one K-C launch per step, two K-F launches per TV step
    # (every step of this schedule): density and k0. Past 1.1 M voxels
    # the steps draw 2D window classes.
    kinds = collections.Counter(s[6] for s in steps)
    classes = draw_classes(top_steps)
    log(f"[phase 7] draws {dict(kinds)}; at {top} voxels by step key: "
        f"{classes}")
    if not (len(steps) == FERN_ITERS and launches["sweep_fwd"] == FERN_ITERS
            and kinds["window"] > 0 and set(kinds) <= {"plain", "window"}
            and launches["sweep_bwd"] == FERN_ITERS
            and launches["tv_add_grad"] == 2 * FERN_ITERS
            and sum(tvr.counts.values()) == 2 * FERN_ITERS
            and len(top_steps) >= FERN_ITERS - FERN_PG_SCALE[-1]):
        raise AssertionError(f"{len(steps)} steps do not match the launches "
                             f"{launches} (K-F by form {dict(tvr.counts)})")
    # Every step ran the instance of its channel count (11 at fern width)
    # of K-A and of K-C.
    c = next(iter(cap_a.forms.values()))[0][0].shape[3]
    inst = f" C={c if c in ka.CHANNEL_INSTANCES else 'generic'} "
    log(f"[phase 7] kernel forms launched: {forms}")
    for name, by_form in forms.items():
        if sum(n for key, n in by_form.items()
               if inst in f" {key} ") != FERN_ITERS:
            raise AssertionError(f"{name} launches by form {by_form}: not "
                                 f"{FERN_ITERS} of the{inst}instance")
    if not all(np.isfinite(s[3]) and np.isfinite(s[4]) for s in steps):
        raise AssertionError("an MPI step's loss or PSNR is not finite")
    psnr_first = float(np.mean([s[3] for s in steps[:50]]))
    psnr_last = float(np.mean([s[3] for s in steps[-50:]]))
    dense_top = [s[2] for i, s in enumerate(steps)
                 if s[1] == top and i + 1 < FERN_TV_DENSE_BEFORE]
    sparse_top = [s[2] for i, s in enumerate(steps)
                  if s[1] == top and i + 1 >= FERN_TV_DENSE_BEFORE]
    step_ms = {"dense_tv": median(dense_top[len(dense_top) // 10:]),
               "sparse_tv": median(sparse_top[len(sparse_top) // 10:])}
    log(f"[phase 7] train PSNR: first 50 steps {psnr_first:.2f} dB, last 50 "
        f"{psnr_last:.2f} dB; median step at {top} voxels "
        f"{step_ms['dense_tv']:.2f} ms with dense TV ({len(dense_top)} "
        f"steps), {step_ms['sparse_tv']:.2f} ms with sparse TV "
        f"({len(sparse_top)} steps) (host clock around a synced step)")
    if not psnr_last > psnr_first:
        raise AssertionError(f"train PSNR did not rise: {psnr_first} -> "
                             f"{psnr_last}")
    ran = how_steps_ran(steps)
    log(f"[phase 7] steps by how they ran: {ran}; median top-grid step "
        f"{step_ms['dense_tv']:.2f} ms dense TV, {step_ms['sparse_tv']:.2f} "
        f"ms sparse TV (eager engine: {EAGER_STEP_MS['fern dense TV']} ms "
        f"dense TV, {EAGER_STEP_MS['fern sparse TV']} ms sparse TV)")
    if not ran["replayed_share"] > MIN_REPLAYED_SHARE:
        raise AssertionError(f"too few steps were replayed: {ran}")
    # Graphed window steps against eager ones from one state, at the top
    # grid: under dense TV (full-size gradients, whole-grid K-F and Adam)
    # and under sparse TV (region mode, K-F's box form on device offsets).
    graph_checks = {}
    for tv_form in ("dense", "sparse"):
        st = busiest_step(rec, None, "window", tv=tv_form, voxels=top)
        model_g, args_g, kw_g = rec.made[id(st)]
        graph_checks[f"fern window, {tv_form} TV"] = graph_vs_eager(
            torch, dev, f"fern window, {tv_form} TV", model_g, args_g, kw_g,
            *recent_batches(rec, st))

    # The checkpoint loads back, with finite parameters at the top grid.
    path = os.path.join(logdir, "fine_last.tar")
    st = ckpt_lib.load_checkpoint_file(path)
    model = ckpt_lib.load_model(mpi_mod.DirectMPIGO, path, device=dev)
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    world_size = [int(x) for x in model.world_size]
    log(f"[phase 7] {path}: step {st['global_step']}, world_size "
        f"{model.world_size}, optimizer step "
        f"{int(st['optimizer_state_dict']['step'])}, finite {finite}")
    if not (finite and st["global_step"] == FERN_ITERS
            and np_prod(model.world_size) == top):
        raise AssertionError(f"{path}: step {st['global_step']}, world_size "
                             f"{model.world_size}, finite {finite}")
    del model

    # Where a step's time goes: three more steps of the last dense-TV and
    # the last sparse-TV step at the top grid, traced (the checkpoint is
    # written; these steps train on and are not saved).
    profiles = {}
    for tv_form in ("dense", "sparse"):
        step, a, k, vox = rec.last_tv[tv_form]
        if vox == top:
            profiles[f"{tv_form} TV"] = profile_step(
                torch, step, a, k, share_of=("tv_add_grad",
                                             "sweep_fwd", "sweep_bwd"))
            log(f"[phase 7] trace of an MPI step with {tv_form} TV at the "
                f"top grid: {profiles[f'{tv_form} TV']}")
            plain, offs = rec.unwindowed(step)
            profiles[f"{tv_form} TV, its batch over the clip box"] = \
                profile_step(torch, plain, (a[0], a[1], offs), {},
                             share_of=("tv_add_grad", "sweep_fwd",
                                       "sweep_bwd"))
            log(f"[phase 7] the same batch over the clip box: "
                f"{profiles[f'{tv_form} TV, its batch over the clip box']}")

    # --render_test of the trained model: every test view per ray along z.
    data = load_everything(None, cfg)
    cap_r = Capture(run_lib, "render_viewpoints", results=True)
    cap_ar = Capture(sweep_ops, "sweep_fwd")
    rtimer = CallTimer(torch, [(ckpt_lib, "load_checkpoint_file")])
    ka.launches = kc.launches = tv.launches = 0
    t0 = time.time()
    try:
        run_lib.main(["--config", cfg_path, "--render_test", "--device",
                      str(dev)])
        torch.cuda.synchronize()
    finally:
        rtimer.restore()
        cap_r.restore()
        cap_ar.restore()
    render_s = time.time() - t0
    rgbs, _, stats = cap_r.results[0]
    render_launches = ka.launches
    psnr_test = float(np.mean(stats["psnr"]))
    black = float(np.mean([-10.0 * np.log10(np.mean(np.asarray(
        data["images"][i], np.float32) ** 2)) for i in data["i_test"]]))
    log(f"[phase 7] --render_test of fine_last.tar: {len(stats['psnr'])} "
        f"views at {rgbs.shape[1]}x{rgbs.shape[2]} in {render_s:.1f} s "
        f"(checkpoint reads {rtimer.seconds} s), "
        f"paths {stats['path']}, K-A launches {render_launches}, K-C "
        f"{kc.launches}; test PSNR {psnr_test:.2f} dB, an all-black frame "
        f"scores {black:.2f} dB")
    if not (np.isfinite(rgbs).all() and kc.launches == 0
            and render_launches > 0 and psnr_test >= black + 3.0):
        raise AssertionError(f"render of the MPI model: PSNR {psnr_test} vs "
                             f"black {black}, launches K-A "
                             f"{render_launches}, K-C {kc.launches}")

    # Where a view's time goes: one test view rendered as run.py renders it,
    # and a trace of one 8192-ray chunk through the same render function.
    from directvoxgo_tpu_torch import rays as ray_lib
    from directvoxgo_tpu_torch.engine import render as render_lib
    model = ckpt_lib.load_model(mpi_mod.DirectMPIGO, path, device=dev)
    v = int(data["i_test"][-1])
    H, W = (int(x) for x in data["HW"][v])
    rk = {"near": data["near"], "far": data["far"], "bg": 0,
          "stepsize": cfg.fine_model_and_render.stepsize,
          "inverse_y": False, "render_depth": True}
    view_ms = host_time(lambda: render_lib.render_viewpoints(
        model, data["poses"][[v]], data["HW"][[v]], data["Ks"][[v]], True,
        rk, verbose=False), 2)
    # The same view per ray: in Morton-segment windows, and in plain chunks
    # over the clip box (the windows' gate raised); tiles against chunks.
    fn = render_lib.make_render_fn(model, rk)
    rays_v = [x.reshape(-1, 3) for x in ray_lib.get_rays_of_a_view(
        H, W, data["Ks"][v], data["poses"][v], True, False, False, False)]
    view_ms_windowed = host_time(lambda: render_lib.render_rays_chunked(
        fn, model, *rays_v, 8192), 2)
    gate = render_lib.WINDOWED_RENDER_MIN_PLANE
    render_lib.WINDOWED_RENDER_MIN_PLANE = 2 ** 62
    try:
        view_ms_chunks = host_time(lambda: render_lib.render_rays_chunked(
            fn, model, *rays_v, 8192), 2)
        rgb_chunks, _ = render_lib.render_rays_chunked(fn, model, *rays_v,
                                                       8192)
    finally:
        render_lib.WINDOWED_RENDER_MIN_PLANE = gate
    rgb_tiles, _ = render_lib.render_frame_ndc_tiles(
        fn, model, H, W, data["Ks"][v], data["poses"][v], rk)
    tiles_vs_chunks = {
        "max_abs_diff": float(np.abs(rgb_tiles - rgb_chunks).max()),
        "psnr": float(psnr(torch.as_tensor(rgb_tiles),
                           torch.as_tensor(rgb_chunks)))}
    view_trace = profile_step(
        torch, lambda: render_lib.render_frame_ndc_tiles(
            fn, model, H, W, data["Ks"][v], data["poses"][v], rk), (), {},
        n_steps=1, share_of=("sweep_fwd",))
    log(f"[phase 7] one {H}x{W} view: tiles {view_ms:.1f} ms, per ray in "
        f"windows {view_ms_windowed:.1f} ms, per ray in plain chunks "
        f"{view_ms_chunks:.1f} ms; tiles against chunks {tiles_vs_chunks}; "
        f"trace of the tiles: {view_trace}")
    ro, rd, vd = (torch.as_tensor(x.reshape(-1, 3)[H * W // 2:][:8192],
                                  device=dev)
                  for x in ray_lib.get_rays_of_a_view(
                      H, W, data["Ks"][v], data["poses"][v], True, False,
                      False, False))
    render_fn = render_lib.make_render_fn(model, rk)
    clip = model.sweep_clip_for_axis(2)
    chunk_trace = profile_step(
        torch, render_fn, (ro, rd, vd, 2, *clip), {},
        share_of=("sweep_fwd",))
    log(f"[phase 7] trace of one 8192-ray plain render chunk: "
        f"{chunk_trace}")
    del model

    summary = {"config": "configs/synthetic/fixture_ndc_fern.py",
               "steps": FERN_ITERS, "pg_scale": FERN_PG_SCALE,
               "tv_dense_before": FERN_TV_DENSE_BEFORE, "top_voxels": top,
               "top_world_size": world_size,
               "steps_at_top": len(top_steps), "step_ms_at_top": step_ms,
               "stage_s": stage_s, "train_wall_s": wall_s,
               "train_psnr_first50": psnr_first,
               "train_psnr_last50": psnr_last, "test_psnr": psnr_test,
               "black_psnr": black, "render_s": render_s,
               "render_checkpoint_reads_s": rtimer.seconds,
               "steps_s": steps_s, "between_steps_s": timer.seconds,
               "view_ms": view_ms, "view_ms_rays_windowed":
               view_ms_windowed, "view_ms_rays_chunks": view_ms_chunks,
               "tiles_vs_chunks": tiles_vs_chunks,
               "view_tiles_trace": view_trace,
               "render_chunk_trace": chunk_trace,
               "draw_kinds": dict(kinds), "draw_classes_at_top": classes,
               "steps_by_how_they_ran": ran,
               "graphed_vs_eager": graph_checks,
               "bucket_build_s": timer.seconds.get("_build_segments"),
               "render_sweep_launches": render_launches,
               "tv_calls_by_form": dict(tvr.counts),
               "sweep_launches_by_form": forms,
               "step_traces": profiles}
    summary["kernel_forms_checked"] = check_kernel_forms(
        ka, kc, cap_ka, cap_kc, "NDC path")
    return mpi_kernel_checks(torch, tv, ka, kc, tvr, cap_a, cap_ar, cap_c,
                             render_launches, len(stats["psnr"])), summary


def mpi_kernel_checks(torch, tv, ka, kc, tvr, cap_a, cap_ar, cap_c,
                      render_launches, n_views):
    """Phase 7's kernel checks: each kernel of the NDC path against its
    plain version and timed, on the inputs of the run's calls."""
    entries = []
    # K-F in every form the run launched, most on the inputs of its last
    # call.
    for form, (name, args, kw) in sorted(tvr.kept.items()):
        err, nums = tv_numbers(torch, tv, name, args, kw)
        log(f"[phase 7] K-F {form}: {nums}")
        entries.append(dict(
            {"name": f"tv_add_grad [{form}]", "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/tv_add_grad.cu",
             "replaces": "directvoxgo_tpu/ops/tv.py:64 (_tv_rows_pallas)",
             "launches": tvr.counts[form], "max_abs_err": err}, **nums))
    # K-A and K-C on the last step of each path form (over the clip box, at
    # the grids below 1.1 M voxels; a window box), K-A on the middle tile
    # of the last test view.
    names = {"step": "mpi step", "window step": "mpi window step"}
    for form, (args, _) in cap_a.forms.items():
        slabs, a_rays, a_k, a_vb, a_wv = args
        slabs = slabs.detach()     # at k = 1 the slabs are the step's grid
        err_a = check_sweep_rel(ka, slabs, a_rays, a_k, a_vb, a_wv,
                                f"MPI {form}, last step")
        nums = fwd_numbers(torch, ka, slabs, a_rays, a_k, a_vb, a_wv)
        log(f"[phase 7] K-A {names[form.split(' ', 1)[1]]}: {nums}")
        entries.append(dict(
            {"name": f"sweep_fwd [{names[form.split(' ', 1)[1]]}]",
             "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
             "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
             "launches": cap_a.counts[form], "max_abs_err": err_a}, **nums))
    r_slabs, r_rays, r_k = cap_ar.calls[len(cap_ar.calls) - 1 - len(
        cap_ar.calls) // (2 * n_views)][0]
    err_r = check_sweep_rel(ka, r_slabs, r_rays, r_k, None, 0,
                            "MPI render tile, middle of the last view")
    nums = fwd_numbers(torch, ka, r_slabs, r_rays, r_k)
    log(f"[phase 7] K-A mpi render: {nums}")
    entries.append(dict(
        {"name": "sweep_fwd [mpi render]", "route": "cuda",
         "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
         "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
         "launches": render_launches, "max_abs_err": err_r}, **nums))
    for form, (args, _) in cap_c.forms.items():
        g, c_rays, c_k, c_shape, c_dtype, c_vb, c_wv = args
        err_c = check_bwd(kc, g, c_rays, c_k, c_shape, c_dtype, c_vb, c_wv,
                          f"MPI {form}, last step")
        nums = bwd_numbers(torch, kc, g, c_rays, c_k, c_shape, c_dtype, c_vb,
                           c_wv)
        log(f"[phase 7] K-C {names[form.split(' ', 1)[1]]}: {nums}")
        entries.append(dict(
            {"name": f"sweep_bwd [{names[form.split(' ', 1)[1]]}]",
             "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/sweep_bwd.cu",
             "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:247 "
                         "(fold_bwd_partials :356)",
             "launches": cap_c.counts[form], "max_abs_err": err_c}, **nums))
    return entries


def grid_sample_backward_call(torch, g, rays, k, grid_shape):
    """The backward of one ``grid_sample`` call over the station slabs: the
    library yardstick of K-C (per-station slab cotangents [S, C, Gu, Gv]
    in f32; it does not fold them onto the grid slabs). Coordinates and the
    forward are prepared outside the timed call."""
    gp, gu, gv, c = grid_shape
    s_total, _, n = g.shape
    op, ou, ov, dp, du, dv = rays
    p = torch.arange(s_total, dtype=torch.float32, device=rays.device) / k
    t = (p[:, None] - op[None]) / dp[None]
    u = ou[None] + t * du[None]
    v = ov[None] + t * dv[None]
    grid = torch.stack([v / (gv - 1) * 2 - 1, u / (gu - 1) * 2 - 1],
                       -1)[:, None]                        # [S, 1, N, 2]
    inp = torch.zeros((s_total, c, gu, gv), device=rays.device,
                      requires_grad=True)
    out = torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    g4 = g[:, :, None, :]
    return lambda: torch.autograd.grad(out, inp, g4, retain_graph=True)



# ----------------------------------------------------------------- phase 8

HARNESS_TIMED = 10      # CUDA-event runs of each full-shape frame timing


def harness_phase(torch, dev, kb):
    """Phase 8: the port's second entry point into the frame kernels, the
    frame-kernel harness, and the op probe. Runs ``bench_framekernel``
    check (the three colour modes, every form against its plain version)
    and perf (six variants at the bench shape) and ``probe_ops`` (every
    class's digest against its plain version, per-op costs), with the
    launch counts set to 0 just before; then holds the v1 and v3 forms
    against their plain versions at the bench shape and times them.
    Returns the ``kernels`` entries of the two forms and the twelve probe
    classes, and the harness's own numbers."""
    from directvoxgo_tpu_torch.ops import probe_ops as kg
    from directvoxgo_tpu_torch.tools import bench_framekernel as bench
    from directvoxgo_tpu_torch.tools import probe_ops as probe_tool

    for form in kb.launches_by_form:
        kb.launches_by_form[form] = 0
    for name in kg.launches:
        kg.launches[name] = 0
    t0 = time.time()
    held = bench.check(dev)
    perf = bench.perf(dev)
    rows = probe_tool.measure(dev)
    torch.cuda.synchronize()
    forms, probes = dict(kb.launches_by_form), dict(kg.launches)
    log(f"[phase 8] harness check + perf and probe in {time.time() - t0:.1f}"
        f" s; K-B launches by form {forms}, K-G launches {probes}")
    missing = [f for f in ("v1", "v3", "v4") if forms[f] < 1] \
        + [n for n, c in probes.items() if c < 1]
    if missing:
        raise AssertionError(f"phase 8 launched no kernel for {missing}")

    case = bench.to_device(bench.make_case(**bench.PERF_SHAPE), dev)
    shape = (f"{bench.PERF_SHAPE['hi']}x{bench.PERF_SHAPE['wi']} "
             f"intermediate, S={bench.PERF_SHAPE['s_total']}, slab "
             f"{bench.PERF_SHAPE['gu']}x{bench.PERF_SHAPE['gv']}, F 12, W 128,"
             f" occupancy {bench.PERF_SHAPE['occupancy']}")
    entries = []
    for form, name, replaces, args_fn, entry_fn in (
            ("v1", "render_frame [v1]",
             "directvoxgo_tpu/ops/pallas_render.py:49", bench.v1_args,
             bench.run_v1),
            ("v3", "render_frame [v3 shared1]",
             "directvoxgo_tpu/ops/pallas_render3.py:51", bench.v3_args,
             bench.run_v3),
            ("v4", "render_frame [v4 bench]",
             "directvoxgo_tpu/ops/pallas_render4.py:74", bench.v4_args,
             bench.run_v4)):
        args = args_fn(case)
        hold_frame(torch, kb, args, f"{form} at the bench shape")
        errs, stats = bench.hold_kernel(args)
        log(f"[phase 8] K-B {form} at the bench shape: kernel-plain "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f", visible samples {stats['visible_samples']}")
        if not bench.within_tol(errs):
            raise AssertionError(f"K-B {form}: {errs} outside "
                                 f"{bench.KERNEL_TOL}")
        nums = frame_numbers(torch, kb, args, HARNESS_TIMED)
        adapter_ms = cuda_time(lambda: args_fn(case), HARNESS_TIMED)
        entry_ms = cuda_time(lambda: entry_fn(case), HARNESS_TIMED)
        plain_ms = cuda_time(lambda: kb.render_frame_plain(**args), 3,
                             warmup=1)
        bound, by, n_bytes, mlp_flops, geo_flops = frame_bound(args, stats)
        small = max((max(errs_f[form]["rgb"], errs_f[form]["tcum"])
                     for errs_f in held.values()), default=None)
        entries.append(
            {"name": name, "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/render_frame.cu",
             "replaces": replaces, "launches": forms[form],
             "max_abs_err": max(errs["rgb"], errs["tcum"]), **nums,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None,
             "library": "none: no single PyTorch call computes the march, "
                        "the gates and the MLP",
             "adapter_ms": adapter_ms, "entry_ms": entry_ms,
             "depth_rel_err": errs["depth_rel"],
             "small_shape_max_abs_err": small, "bytes": n_bytes,
             "mlp_operations": mlp_flops, "geo_operations": geo_flops,
             "visible_samples": stats["visible_samples"],
             "live_samples": stats["live_samples"], "shape": shape})
        log(f"[phase 8] K-B {form}: kernel {nums}, adapter "
            f"{adapter_ms:.3f} ms, entry {entry_ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({by})")
    for cls, row in rows.items():
        per = "launch" if cls == "null" else "op"
        scale = 1.0 if per == "launch" else row["g"] * row["reps"]
        entry = {"name": f"probe_ops [{cls}]", "route": "cuda",
                 "source": "directvoxgo_tpu_torch/csrc/probe_ops.cu",
                 "replaces": "tools/probe_mosaic.py:44",
                 "launches": probes[cls],
                 "max_abs_err": abs(row["digest"] - row["plain_digest"]),
                 "rel_err": row["rel_err"], "per": per,
                 "ms": (row["launch_ms"] if per == "launch"
                        else row["op_us"] / 1e3),
                 "plain_ms": row["plain_ms"] / (1.0 if per == "launch"
                                                else row["reps"]),
                 "bound_ms": row["bound_ms"] / scale,
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_op_us"] / 1e3,
                 "launch_ms": row["launch_ms"], "g": row["g"],
                 "reps": row["reps"]}
        if cls == "null":
            entry.update(null_ms=row["null_ms"],
                         per_block_us=row["per_block_us"])
        entries.append(entry)
    log(f"[phase 8] probe, per op (us): " + ", ".join(
        f"{c} {r['op_us']:.3f} (bound {r['bound_op_us']:.3f}, library "
        f"{r['library_op_us']:.3f})" for c, r in rows.items() if c != "null"))
    harness = {"perf": perf, "check": {f"{m} mlp={h}": v
                                       for (m, h), v in held.items()}}
    return entries, harness


# ----------------------------------------------------------------- phase 9

# The cuts of configs/synthetic/fixture_lego_sparse.py for the gather path:
# query_mode 'gather' in both stages, and the iteration counts only (coarse
# 5000 -> 3000 with its per-voxel lr, now the exact view count; fine 20000
# -> 300, pg_scale [1000, 2000, 3000, 4000] -> [50, 100, 150, 200], so 100
# fine steps run at 160^3). Everything else is the config's. The gather
# coarse stage starts slowly on this fixture: its density gradients stay
# below Adam's eps for the first thousand steps or so (the JAX package's
# gather steps take the same losses, step for step, on the CPU), so it
# keeps phase 5's coarse count.
GATHER_CONFIG = os.path.join(CKPT_DIR, "train_lego_gather.py")
G_COARSE, G_FINE, G_PG_SCALE = 3000, 300, [50, 100, 150, 200]
# ... and of configs/synthetic/fixture_ndc_fern.py: query_mode 'gather',
# fine N_iters 25000 -> 300, pg_scale [2000, 4000, 6000, 8000] -> [50, 100,
# 150, 200], tv_dense_before 10000 -> 250 (both TV phases at the top grid,
# 352x371x128; TV on every step).
GATHER_FERN_CONFIG = os.path.join(CKPT_DIR, "train_fern_gather.py")
GF_ITERS, GF_PG_SCALE, GF_TV_DENSE_BEFORE = 300, [50, 100, 150, 200], 250
# The JAX package's bound on the freeze mask's agreement between the two
# view-count forms (tests/test_model.py:298-338).
COUNT_AGREEMENT_MIN = 0.97
# Card against CPU, one gather step from one state: loss relative, and the
# parameters against their scale.
GATHER_CPU_TOL = (1e-5, 1e-5)
# Grid-LIIF steps at lego fine width.
LIIF_STEPS = 4
# The frame kernel's 800^2 lego view (PERF.md section 6, K-B; NVIDIA H100
# 80GB HBM3 at 700 W), logged on stderr beside the per-ray gather view; the
# JSON lines carry only what this run measured.
FRAME_800_MS = 3.70


def write_gather_configs():
    os.makedirs(CKPT_DIR, exist_ok=True)
    with open(GATHER_CONFIG, "w") as f:
        f.write(f"_base_ = {TRAIN_BASE!r}\n"
                "expname = 'train_lego_gather'\n"
                "basedir = './logs/chip_smoke'\n"
                f"coarse_train = {{'N_iters': {G_COARSE}}}\n"
                f"fine_train = {{'N_iters': {G_FINE}, "
                f"'pg_scale': {G_PG_SCALE}}}\n"
                "coarse_model_and_render = {'query_mode': 'gather'}\n"
                "fine_model_and_render = {'query_mode': 'gather'}\n")
    with open(GATHER_FERN_CONFIG, "w") as f:
        f.write(f"_base_ = {FERN_BASE!r}\n"
                "expname = 'train_fern_gather'\n"
                "basedir = './logs/chip_smoke'\n"
                f"fine_train = {{'N_iters': {GF_ITERS}, "
                f"'pg_scale': {GF_PG_SCALE}, "
                f"'tv_dense_before': {GF_TV_DENSE_BEFORE}}}\n"
                "fine_model_and_render = {'query_mode': 'gather'}\n")


def zero_launches(ka, kb, kc, tf, tv):
    ka.launches = ka.launches_windowed = kb.launches = kc.launches = 0
    tf.launches_fwd = tf.launches_bwd = tv.launches = 0


def launch_counts(ka, kb, kc, tf, tv):
    return {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches,
            "render_frame": kb.launches, "train_fused_fwd": tf.launches_fwd,
            "train_fused_bwd": tf.launches_bwd, "tv_add_grad": tv.launches}


def gather_run(torch, cfg_path, render_test, timer_targets, tvr_mod=None,
               tv=None):
    """``run.main`` on a gather config (train, then ``--render_test`` when
    asked), in process, with its steps recorded (:class:`StepRecorder`),
    the K-F calls by form (``tvr_mod``: the model module whose TV the
    steps call) and the seconds of ``timer_targets``; returns (recorder,
    K-F recorder or None, timer, render stats or None, seconds, peak
    device bytes)."""
    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    rec = StepRecorder(train_lib)
    tvr = TVRecorder(torch, tv, tvr_mod) if tvr_mod is not None else None
    timer = CallTimer(torch, timer_targets)
    cap_r = Capture(run_lib, "render_viewpoints", results=True)
    per_replay = PerReplay(tvr) if tvr is not None else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        run_lib.main(["--config", cfg_path, "--no_reload", "--i_print",
                      "100", "--device", "cuda"]
                     + (["--render_test"] if render_test else []))
        torch.cuda.synchronize()
    finally:
        cap_r.restore()
        timer.restore()
        rec.restore()
        if tvr is not None:
            per_replay.restore()
            tvr.restore()
    stats = cap_r.results[0][2] if cap_r.results else None
    return (rec, tvr, timer, stats, time.time() - t0,
            torch.cuda.max_memory_allocated())


def gather_step_numbers(torch, rec, stage, voxels):
    """The recorded steps of ``stage`` at ``voxels``: their median host
    ms after the first tenth, and a trace of three more calls of the last
    one (busy ms, idle share), with the device memory those calls held at
    their peak and before them (bytes)."""
    steps = [s for s in rec.steps if s[0] == stage and s[1] == voxels]
    ms = median([s[2] for s in steps[len(steps) // 10:]])
    step, a, k = rec.last[(stage, False)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    trace = profile_step(torch, step, a, k)
    trace["peak_bytes"] = torch.cuda.max_memory_allocated()
    trace["bytes_before"] = before
    return len(steps), ms, trace


def count_agreement(torch, model, count_kw, exact):
    """The sweep form of the view count (``DVGO_COUNT_FORM=sweep``) on the
    rays and grid of an exact one (``voxel_count_views``' keywords
    ``count_kw``), timed, and the two freeze masks (count <= 2): (seconds,
    agreement, IoU, freeze shares)."""
    os.environ["DVGO_COUNT_FORM"] = "sweep"
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        sweep = model.voxel_count_views(**count_kw)
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
    finally:
        del os.environ["DVGO_COUNT_FORM"]
    fe, fs = exact <= 2, sweep <= 2
    agree = float((fe == fs).float().mean())
    iou = float((fe & fs).sum()) / max(float((fe | fs).sum()), 1.0)
    return sweep_s, agree, iou, float(fe.float().mean()), \
        float(fs.float().mean())


def gather_cpu_case(torch, mode, device, seed=3):
    """A small gather model of colour ``mode`` on ``device``, from seeded
    numpy (a density blob, random k0 and MLP), and its train step with
    512 rays along +-x from a pool of 1024: (model, optimizer, step, pool,
    batch)."""
    import numpy as np
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    kw = {"coarse": dict(rgbnet_dim=0),
          "fine direct": dict(rgbnet_dim=12, rgbnet_direct=True),
          "fine": dict(rgbnet_dim=12, rgbnet_direct=False),
          "posbase_pe": dict(rgbnet_dim=12, posbase_pe=3),
          "full_implicit": dict(rgbnet_dim=12, rgbnet_full_implicit=True),
          "liif unfold": dict(rgbnet_dim=6, implicit_voxel_feat=True,
                              feat_unfold=True),
          "liif": dict(rgbnet_dim=6, implicit_voxel_feat=True,
                       feat_unfold=False)}[mode]
    fine = kw["rgbnet_dim"] > 0
    model = DirectVoxGO(
        xyz_min=[-1.6, -1.0, -0.5], xyz_max=[1.6, 1.0, 0.5],
        num_voxels=32 * 20 * 10, num_voxels_base=32 * 20 * 10,
        alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_depth=3,
        rgbnet_width=32, query_mode="gather",
        k_density=48 if fine else None, k_color=16 if fine else 0,
        device=device, generator=torch.Generator().manual_seed(seed), **kw)
    rng = np.random.default_rng(seed)
    pts = model.grid_points().cpu().numpy()
    dens = (12.0 * np.exp(-(pts[..., 0] / 1.1) ** 2 - (pts[..., 1] / 0.35)
                          ** 2 - (pts[..., 2] / 0.3) ** 2) - 8.0
            + rng.normal(0, 0.5, pts.shape[:3]))
    with torch.no_grad():
        model.density.copy_(torch.as_tensor(dens.astype(np.float32)))
        model.k0.copy_(torch.as_tensor(rng.normal(
            0, 0.5, tuple(model.k0.shape)).astype(np.float32)))
    model.update_occupancy_cache()
    cfg = Config.fromfile(os.path.join(REPO, "configs", "default.py"))
    ct = cfg.fine_train if fine else cfg.coarse_train
    ct.N_rand = 512
    ct.weight_tv_density = ct.weight_tv_k0 = 1e-3
    opt = train_lib.create_optimizer_or_freeze_model(model, ct)
    n = 1024
    ro = np.stack([np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0),
                   rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)],
                  -1).astype(np.float32)
    rd = np.stack([-np.sign(ro[:, 0]), rng.uniform(-0.15, 0.15, n),
                   rng.uniform(-0.15, 0.15, n)], -1).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    pool = {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                               device=device)
            for k, v in (("rgb", rng.uniform(0, 1, (n, 3))),
                         ("rays_o", ro), ("rays_d", rd), ("viewdirs", vd))}
    rk = {"near": 0.5, "far": 8.0, "bg": 1.0, "stepsize": 0.5}
    step = train_lib.make_train_step(model, opt, ct, rk, True, mode == "fine",
                                     axis=None)
    return model, opt, step, pool, rng.permutation(n)[:512], ct, rk


def gather_card_vs_cpu(torch, dev):
    """Phase 9 (c): one gather train step per colour mode on the card and
    on the CPU from one state (TV on: dense for 'fine', sparse else), the
    losses and the parameters compared; then graphed gather steps against
    eager ones. Returns {mode: (loss difference, parameter difference)}
    and the graph check's numbers."""
    import numpy as np
    out = {}
    for mode in ("coarse", "fine direct", "fine", "posbase_pe",
                 "full_implicit", "liif unfold", "liif"):
        res = {}
        for device in ("cpu", dev):
            model, opt, step, pool, sel, _, _ = gather_cpu_case(
                torch, mode, device)
            loss, _ = step(pool, torch.as_tensor(sel, device=device),
                           np.zeros(3, np.int32))
            res[str(device)] = (float(loss), {
                n: p.detach().cpu() for n, p in model.named_parameters()})
        (l_c, p_c), (l_g, p_g) = res["cpu"], res[str(dev)]
        d_loss = abs(l_g - l_c) / max(abs(l_c), 1e-12)
        d_par = max(float((p_g[n] - p_c[n]).abs().max())
                    / max(1.0, float(p_c[n].abs().max()))
                    for n in p_c if p_c[n].numel())
        out[mode] = {"loss": l_c, "loss_rel_diff": d_loss,
                     "param_diff_of_scale": d_par}
        log(f"[phase 9] card vs CPU, gather step {mode}: loss {l_c:.6f}, "
            f"relative difference {d_loss:.3e}; largest parameter "
            f"difference {d_par:.3e} of its scale")
        if not (np.isfinite(l_g) and d_loss <= GATHER_CPU_TOL[0]
                and d_par <= GATHER_CPU_TOL[1]):
            raise AssertionError(f"gather step {mode}: card and CPU differ "
                                 f"(loss {d_loss}, parameters {d_par})")
    # graphed against eager, on the card (a fine step, 6 batches)
    model, opt, _, pool, _, ct, rk = gather_cpu_case(torch, "fine", dev)
    rng = np.random.default_rng(SEED)
    sels = np.stack([rng.permutation(1024)[:512] for _ in range(6)])
    graphs = graph_vs_eager(torch, dev, "gather fine step", model,
                            (opt, ct, rk, True, False), {"axis": None},
                            pool, sels, np.zeros((6, 3), np.int32))
    return out, graphs


def gather_vs_sweep_step(torch, dev, fine_model, pool, rk, n=8):
    """The gather step against the sweep step at the same grid and state
    (the trained gather model's, copied into a sweep model) on the same
    ``n`` batches of 8192 rays of one sweep axis group, each graphed and
    eager (:func:`graph_vs_eager`: wall and busy ms); returns both."""
    import numpy as np
    from directvoxgo_tpu_torch import convert
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    cfg = Config.fromfile(CONFIG)
    ct = cfg.fine_train
    kw = dict(fine_model.get_kwargs(), query_mode="sweep")
    for key in ("act_shift", "voxel_size_ratio", "mask_cache_path"):
        kw.pop(key)
    sweep = DirectVoxGO(**kw, device=dev)
    params, mask = convert.params_to_jax(fine_model)
    sweep.load_state_dict(convert.params_from_jax(params, mask, device=dev))
    rd = pool["rays_d"].cpu().numpy()
    groups = sweep_ops.sweep_axes(sweep, rd)
    axis = int(np.bincount(groups, minlength=3).argmax())
    g = np.flatnonzero(groups == axis)
    rng = np.random.default_rng(SEED)
    sels = np.stack([rng.choice(g, int(ct.N_rand), replace=False)
                     for _ in range(n)])
    clip_sizes, clip_off = sweep.sweep_clip_for_axis(axis)
    out = {"axis": axis, "clip_sizes": None if clip_sizes is None
           else list(clip_sizes)}
    from directvoxgo_tpu_torch.engine import train as train_lib
    for name, model, make_kw, offs in (
            ("gather", fine_model, {"axis": None}, np.zeros((n, 3))),
            ("sweep", sweep, {"axis": axis, "clip_sizes": clip_sizes},
             np.broadcast_to(np.asarray(clip_off), (n, 3)))):
        opt = train_lib.create_optimizer_or_freeze_model(model, ct)
        out[name] = graph_vs_eager(
            torch, dev, f"lego fine {name} step at "
            f"{tuple(model.world_size)}", model, (opt, ct, rk, False, False),
            make_kw, pool, sels, np.asarray(offs, np.int32))
    log(f"[phase 9] the same state and batches, graphed wall / busy ms: "
        f"gather {out['gather']['graphed_wall_ms']:.2f} / "
        f"{out['gather']['graphed_trace']['device_busy_ms']:.2f}, sweep "
        f"{out['sweep']['graphed_wall_ms']:.2f} / "
        f"{out['sweep']['graphed_trace']['device_busy_ms']:.2f}")
    del sweep
    return out


def liif_full_width(torch, dev, fine_model, pool, rk):
    """Phase 9 (d): a few gather steps of grid-LIIF (``feat_unfold``,
    ``cell_decode``, ``local_ensemble``) at lego fine width: the trained
    gather model's grid, bbox and occupancy, k0 and MLP seeded; returns
    the step times, peak memory and losses."""
    import numpy as np
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    kw = dict(fine_model.get_kwargs(), implicit_voxel_feat=True,
              feat_unfold=True, cell_decode=True, local_ensemble=True)
    kw.pop("act_shift")
    kw.pop("voxel_size_ratio")
    kw.pop("mask_cache_path")
    kw["num_voxels"] = fine_model.num_voxels
    model = DirectVoxGO(**kw, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.density.copy_(fine_model.density)
        model.mask.copy_(fine_model.mask)
        model.k0.copy_(torch.randn(tuple(model.k0.shape), generator=torch
                                   .Generator().manual_seed(SEED)) * 0.1)
    cfg = Config.fromfile(CONFIG)
    ct = cfg.fine_train
    opt = train_lib.create_optimizer_or_freeze_model(model, ct)
    step = train_lib.make_train_step(model, opt, ct, rk, False, False,
                                     axis=None)
    n_pool = pool["rgb"].shape[0]
    rng = np.random.default_rng(SEED)
    ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LIIF_STEPS):
        sel = torch.as_tensor(rng.integers(0, n_pool, int(ct.N_rand)),
                              device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(pool, sel, np.zeros(3, np.int32))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    finite = (all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters()))
    out = {"world_size": list(model.world_size), "k0_dim": model.k0_dim,
           "mlp_in": model.rgbnet_dim0, "steps": LIIF_STEPS,
           "step_ms": ms, "median_step_ms": median(ms[1:]),
           "peak_bytes": peak, "losses": losses, "finite": finite}
    log(f"[phase 9] grid-LIIF (feat_unfold) at {model.world_size}: {out}")
    if not finite:
        raise AssertionError(f"grid-LIIF steps at full width: {out}")
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def gather_phase(torch, dev, ka, kb, kc, tf, tv):
    """Phase 9; returns the kernels-line entries of the gather path (K-F's
    whole-grid forms on the gather MPI steps) and a summary."""
    import numpy as np
    from directvoxgo_tpu_torch import rays as ray_lib
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import render as render_lib
    from directvoxgo_tpu_torch.models import dmpigo as mpi_mod
    from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    write_gather_configs()

    # (a) Lego, unfused, gather: train, count, render.
    counts = {}
    orig_count = DirectVoxGO.voxel_count_views

    def kept_count(self, **k):      # the engine passes keywords
        out = orig_count(self, **k)
        counts.setdefault("exact", (self, k, out))
        return out

    DirectVoxGO.voxel_count_views = kept_count
    zero_launches(ka, kb, kc, tf, tv)
    try:
        rec, _, timer, stats, wall_s, peak = gather_run(
            torch, GATHER_CONFIG, True,
            [(DirectVoxGO, "_voxel_count_views_exact")])
    finally:
        DirectVoxGO.voxel_count_views = orig_count
    launches = launch_counts(ka, kb, kc, tf, tv)
    coarse = [s for s in rec.steps if s[0] == "coarse"]
    fine = [s for s in rec.steps if s[0] == "fine"]
    top = max(s[1] for s in fine)
    ran = how_steps_ran(rec.steps)
    log(f"[phase 9] run.main trained {len(coarse)} coarse + {len(fine)} fine "
        f"gather steps (pg_scale {G_PG_SCALE}) and rendered the test views "
        f"in {wall_s:.1f} s; launches {launches}; steps by how they ran "
        f"{ran}; peak device memory {peak / 2**30:.2f} GiB")
    if not (len(coarse) == G_COARSE and len(fine) == G_FINE
            and top >= 160 ** 3 * 0.9 and all(v == 0 for v in
                                              launches.values())):
        raise AssertionError(f"gather run: {len(coarse)} + {len(fine)} "
                             f"steps, top grid {top}, launches {launches}")
    if not ran["replayed_share"] > MIN_REPLAYED_SHARE or {
            str(s[7]) for s in rec.steps} != {"None"}:
        raise AssertionError(f"gather steps: {ran}")
    if not all(np.isfinite(s[3]) and np.isfinite(s[4]) for s in rec.steps):
        raise AssertionError("a gather step's loss or PSNR is not finite")
    psnr_first = float(np.mean([s[3] for s in coarse[:50]]))
    psnr_last = float(np.mean([s[3] for s in fine[-50:]]))
    n_top, step_ms, step_trace = gather_step_numbers(torch, rec, "fine", top)
    coarse_ms = median([s[2] for s in coarse[len(coarse) // 10:]])
    psnr_by_500 = [float(np.mean([s[3] for s in coarse[i:i + 500]]))
                   for i in range(0, len(coarse), 500)]
    log(f"[phase 9] train PSNR: first 50 coarse steps {psnr_first:.2f} dB, "
        f"last 50 fine steps {psnr_last:.2f} dB; median gather step at "
        f"{top} voxels ({n_top} steps) {step_ms:.2f} ms (its peak device "
        f"memory {step_trace['peak_bytes'] / 2**30:.2f} GiB, "
        f"{step_trace['bytes_before'] / 2**30:.2f} held before), coarse "
        f"{coarse_ms:.2f} ms; coarse PSNR by 500 steps {psnr_by_500}; trace "
        f"of the last fine step: {step_trace}")
    if not psnr_last > psnr_first:
        raise AssertionError(f"gather train PSNR did not rise: {psnr_first} "
                             f"-> {psnr_last}")
    cfg = Config.fromfile(GATHER_CONFIG)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    fine_model = ckpt_lib.load_model(DirectVoxGO, os.path.join(
        logdir, "fine_last.tar"), device=dev)
    if not (fine_model.query_mode == "gather" and all(
            bool(torch.isfinite(p).all()) for p in fine_model.parameters())):
        raise AssertionError("the gather checkpoint is not a finite gather "
                             "model")
    data = load_everything(None, cfg)
    white = float(np.mean([float(-10.0 * np.log10(np.mean(
        (1.0 - np.asarray(data["images"][i], np.float32)) ** 2)))
        for i in data["i_test"]]))
    psnr_test = float(np.mean(stats["psnr"]))
    log(f"[phase 9] --render_test: paths {stats['path']}, test PSNR "
        f"{psnr_test:.2f} dB, a white frame scores {white:.2f} dB")
    if not (set(stats["path"]) == {"rays"} and psnr_test > white):
        raise AssertionError(f"gather render: paths {stats['path']}, PSNR "
                             f"{psnr_test} vs white {white}")

    # The exact count against the sweep form on the same rays and grid.
    c_model, c_kw, exact = counts["exact"]
    exact_s = timer.seconds["_voxel_count_views_exact"][0]
    sweep_s, agree, iou, f_exact, f_sweep = count_agreement(
        torch, c_model, c_kw, exact)
    n_views = len(data["i_train"])
    log(f"[phase 9] view count over {n_views} views at "
        f"{c_model.world_size}: exact form {exact_s:.3f} s "
        f"({exact_s / n_views * 1e3:.2f} ms a view), sweep form "
        f"{sweep_s:.3f} s ({sweep_s / n_views * 1e3:.2f} ms a view); freeze "
        f"masks (count <= 2) agree at {agree:.5f} of voxels, IoU {iou:.5f} "
        f"(frozen shares {f_exact:.4f} exact, {f_sweep:.4f} sweep)")
    if not agree >= COUNT_AGREEMENT_MIN:
        raise AssertionError(f"count forms agree at {agree}")

    # One 800^2 view per ray through the gather forward.
    v = int(data["i_test"][0])
    K2 = np.asarray(data["Ks"][v], np.float64).copy()
    K2[:2, :3] *= 2.0
    rk = {"near": data["near"], "far": data["far"], "bg": 1.0,
          "stepsize": cfg.fine_model_and_render.stepsize, "inverse_y": False,
          "render_depth": True}
    view_ms = host_time(lambda: render_lib.render_viewpoints(
        fine_model, data["poses"][[v]], np.array([[800, 800]]),
        K2[None], False, rk, verbose=False), 3)
    log(f"[phase 9] one 800^2 view per ray through the gather forward: "
        f"{view_ms:.1f} ms (the frame kernel's view in PERF.md: "
        f"{FRAME_800_MS} ms)")

    # (d) grid-LIIF at lego fine width, on rays of two training views.
    rays = [ray_lib.get_rays_of_a_view(400, 400, data["Ks"][i],
                                       data["poses"][i], False, False,
                                       False, False)
            for i in data["i_train"][:2]]
    pool = {"rgb": torch.as_tensor(np.concatenate(
        [np.asarray(data["images"][i], np.float32).reshape(-1, 3)
         for i in data["i_train"][:2]]), device=dev)}
    for j, name in enumerate(("rays_o", "rays_d", "viewdirs")):
        pool[name] = torch.as_tensor(np.concatenate(
            [r[j].reshape(-1, 3) for r in rays]).astype(np.float32),
            device=dev)
    vs_sweep = gather_vs_sweep_step(torch, dev, fine_model, pool, rk)
    liif = liif_full_width(torch, dev, fine_model, pool, rk)
    del fine_model, pool

    # (b) Fern, DirectMPIGO, gather, TV on every step.
    zero_launches(ka, kb, kc, tf, tv)
    frec, tvr, ftimer, fstats, f_wall, f_peak = gather_run(
        torch, GATHER_FERN_CONFIG, True, [], mpi_mod, tv)
    f_launches = launch_counts(ka, kb, kc, tf, tv)
    f_steps = list(frec.steps)
    f_top = max(s[1] for s in f_steps)
    f_ran = how_steps_ran(f_steps)
    log(f"[phase 9] run.main trained {len(f_steps)} gather MPI steps "
        f"(pg_scale {GF_PG_SCALE}) and rendered the test views in "
        f"{f_wall:.1f} s; launches {f_launches}; K-F calls by form "
        f"{dict(tvr.counts)}; steps by how they ran {f_ran}; peak device "
        f"memory {f_peak / 2**30:.2f} GiB")
    if not (len(f_steps) == GF_ITERS
            and f_launches["tv_add_grad"] == 2 * GF_ITERS
            and sum(tvr.counts.values()) == 2 * GF_ITERS
            and all(n == 0 for k, n in f_launches.items()
                    if k != "tv_add_grad")
            and f_ran["replayed_share"] > MIN_REPLAYED_SHARE):
        raise AssertionError(f"gather MPI run: {len(f_steps)} steps, "
                             f"launches {f_launches}, {f_ran}")
    f_psnr_first = float(np.mean([s[3] for s in f_steps[:50]]))
    f_psnr_last = float(np.mean([s[3] for s in f_steps[-50:]]))
    f_top_steps = [s for s in f_steps if s[1] == f_top]
    f_step_ms = median([s[2] for s in f_top_steps[len(f_top_steps) // 10:]])
    f_trace = {tv_form: profile_step(torch, *frec.last_tv[tv_form][:3])
               for tv_form in ("dense", "sparse") if tv_form in frec.last_tv}
    fcfg = Config.fromfile(GATHER_FERN_CONFIG)
    fdata = load_everything(None, fcfg)
    black = float(np.mean([float(-10.0 * np.log10(np.mean(
        np.asarray(fdata["images"][i], np.float32) ** 2)))
        for i in fdata["i_test"]]))
    f_psnr_test = float(np.mean(fstats["psnr"]))
    mpi = ckpt_lib.load_model(DirectMPIGO, os.path.join(
        fcfg.basedir, fcfg.expname, "fine_last.tar"), device=dev)
    f_finite = all(bool(torch.isfinite(p).all()) for p in mpi.parameters())
    log(f"[phase 9] gather MPI: train PSNR first 50 steps "
        f"{f_psnr_first:.2f} dB, last 50 {f_psnr_last:.2f} dB; median step "
        f"at {f_top} voxels {f_step_ms:.2f} ms; traces by TV form "
        f"{f_trace}; --render_test paths {fstats['path']}, test PSNR "
        f"{f_psnr_test:.2f} dB, an all-black frame {black:.2f} dB; world "
        f"size {mpi.world_size}, finite {f_finite}")
    if not (f_psnr_last > f_psnr_first and f_finite
            and set(fstats["path"]) == {"rays"} and f_psnr_test > black):
        raise AssertionError(f"gather MPI: PSNR {f_psnr_first} -> "
                             f"{f_psnr_last}, test {f_psnr_test} vs black "
                             f"{black}, finite {f_finite}, paths "
                             f"{fstats['path']}")
    del mpi

    entries = []
    for form, (name, args, kw) in sorted(tvr.kept.items()):
        err, nums = tv_numbers(torch, tv, name, args, kw, phase="9")
        log(f"[phase 9] K-F {form} on the gather step: {nums}")
        entries.append(dict(
            {"name": f"tv_add_grad [gather {form}]", "route": "cuda",
             "source": "directvoxgo_tpu_torch/csrc/tv_add_grad.cu",
             "replaces": "directvoxgo_tpu/ops/tv.py:64 (_tv_rows_pallas)",
             "launches": tvr.counts[form], "max_abs_err": err}, **nums))

    # (c) The card against the CPU, and graphed against eager.
    card_cpu, graphs = gather_card_vs_cpu(torch, dev)

    summary = {
        "lego": {"config": GATHER_CONFIG, "steps": [G_COARSE, G_FINE],
                 "pg_scale": G_PG_SCALE, "launches": launches,
                 "steps_by_how_they_ran": ran, "train_wall_s": wall_s,
                 "peak_bytes": peak, "top_voxels": top,
                 "steps_at_top": n_top, "step_ms_at_top": step_ms,
                 "coarse_step_ms": coarse_ms,
                 "coarse_psnr_by_500_steps": psnr_by_500,
                 "step_trace_at_top": step_trace,
                 "train_psnr_first50": psnr_first,
                 "train_psnr_last50": psnr_last, "test_psnr": psnr_test,
                 "white_psnr": white, "render_paths": stats["path"],
                 "count_exact_s": exact_s, "count_sweep_s": sweep_s,
                 "count_views": n_views,
                 "count_world_size": list(c_model.world_size),
                 "freeze_agreement": agree, "freeze_iou": iou,
                 "frozen_share_exact": f_exact,
                 "frozen_share_sweep": f_sweep,
                 "view_800_per_ray_ms": view_ms},
        "gather_vs_sweep_step": vs_sweep,
        "liif_full_width": liif,
        "fern": {"config": GATHER_FERN_CONFIG, "steps": GF_ITERS,
                 "pg_scale": GF_PG_SCALE,
                 "tv_dense_before": GF_TV_DENSE_BEFORE,
                 "launches": f_launches, "tv_calls_by_form": dict(tvr.counts),
                 "steps_by_how_they_ran": f_ran, "train_wall_s": f_wall,
                 "peak_bytes": f_peak, "top_voxels": f_top,
                 "step_ms_at_top": f_step_ms, "step_traces": f_trace,
                 "train_psnr_first50": f_psnr_first,
                 "train_psnr_last50": f_psnr_last,
                 "test_psnr": f_psnr_test, "black_psnr": black},
        "card_vs_cpu": card_cpu, "graphed_vs_eager": graphs}
    return entries, summary


# ----------------------------------------------------------------- main

def run(dev):
    import numpy as np
    import torch
    from directvoxgo_tpu_torch.ops import _build
    from directvoxgo_tpu_torch.ops import render_frame as kb
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    from directvoxgo_tpu_torch.ops import sweep_bwd as kc
    from directvoxgo_tpu_torch.ops import sweep_fwd as ka
    from directvoxgo_tpu_torch.ops import train_fused as tf
    from directvoxgo_tpu_torch.ops import tv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    logs = _build.build_all(_build.KERNELS + PREV_KERNELS)
    for name, text in logs.items():
        log(f"[phase 0] nvcc {name}.cu:\n{text.strip()}")
    log(f"[phase 0] built {list(logs)} in {time.time() - t0:.1f} s")
    USAGE.update(ptxas_usage(logs))

    errs = {}
    slabs, rays, k = small_sweep_case(torch, dev)
    errs["sweep_fwd"] = check_sweep(ka, slabs, rays, k, "small")
    errs.update(small_train_kernel_checks(torch, dev, ka, kc, sweep_ops))
    errs.update(small_fused_checks(torch, dev, tf))
    errs["tv_add_grad"] = small_tv_checks(torch, dev, tv)
    errs["render_frame"] = small_frame_checks(torch, dev, kb)
    errs["window"] = small_window_checks(torch, dev)
    errs["graphs"] = small_graph_checks(torch, dev)

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
    ka.launches_by_form.clear()
    t0 = time.time()
    try:
        run_lib.main(["--config", CONFIG, "--render_only", "--render_test",
                      "--ft_path", ckpt, "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        cap_a.restore()
        cap_b.restore()
    launches = {"sweep_fwd": ka.launches, "render_frame": kb.launches}
    render_forms = dict(ka.launches_by_form)
    log(f"[phase 3] run.main rendered {len(i_test)} views in "
        f"{time.time() - t0:.1f} s; launches {launches}, K-A by form "
        f"{render_forms}")
    if sum(render_forms.values()) != launches["sweep_fwd"]:
        raise AssertionError(f"K-A forms {render_forms} do not add up to its "
                             f"{launches['sweep_fwd']} launches")
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
    errs["render_frame"] = max(errs["render_frame"], err_b, hold_frame(
        torch, kb, f_case, "main path 400^2"))

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
    errs["render_frame"] = max(errs["render_frame"], hold_frame(
        torch, kb, f800, "800^2 frame"))
    nums_b = frame_numbers(torch, kb, f800, 10, geo=True)
    plain_b = cuda_time(lambda: kb.render_frame_plain(**f800), 3, warmup=1)
    frame_ms = host_time(lambda: render_sweep.render_frame_sweep(
        model, 800, 800, K2, c2w, rk), 5)
    nums_a = fwd_numbers(torch, ka, *s_args)
    # A view the sweep plan rejects, rendered per ray through
    # render_viewpoints as run.py calls it (20 chunks of 8192 rays at 400^2).
    r = rejected[0]
    rk_view = dict(rk, render_depth=True)
    rays_view_ms = host_time(lambda: render_lib.render_viewpoints(
        model, data["poses"][[r]], np.array([[400, 400]]), data["Ks"][[r]],
        False, rk_view, verbose=False), 3)

    # Bounds from this run's inputs: what the function must read and write
    # once, and the operations this run's data needs (see PERF.md).
    hi, wi = f800["dnorm"].shape
    bound_b, by_b, bytes_b, mlp_flops, geo_flops = frame_bound(f800, stats)
    log(f"[phase 4] 800^2 frame: inter {hi}x{wi}, S={f800['d_geo'].shape[0]},"
        f" {stats}; K-B {nums_b}, plain {plain_b:.1f} ms, whole frame "
        f"{frame_ms:.2f} ms; K-B bound {bound_b:.5f} ms ({by_b}: "
        f"{bytes_b} bytes, {mlp_flops} MLP + {geo_flops} f32 operations)")
    log(f"[phase 4] K-A on the middle chunk of the rejected view: {nums_a}; "
        f"rejected view {r} per ray at 400^2: {rays_view_ms:.2f} ms")
    kernels = [
        dict({"name": "sweep_fwd", "route": "cuda",
              "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
              "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
              "launches": launches["sweep_fwd"],
              "max_abs_err": errs["sweep_fwd"],
              "launches_by_form": render_forms,
              "rejected_view_ms": rays_view_ms}, **nums_a),
        dict({"name": "render_frame", "route": "cuda",
              "source": "directvoxgo_tpu_torch/csrc/render_frame.cu",
              "replaces": "directvoxgo_tpu/ops/pallas_render4.py:74",
              "launches": launches["render_frame"],
              "max_abs_err": errs["render_frame"]}, **nums_b,
             **{"plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
                "library_ms": None, "frame_ms": frame_ms,
                "shape": f"800^2 frame, intermediate {hi}x{wi}, "
                         f"S={f800['d_geo'].shape[0]}, "
                         f"{stats['visible_samples']} visible samples"}),
    ]
    # Phase 5: the training path. The render path's entries keep the
    # launches of their own run (phase 3).
    train_entries, training = train_phase(torch, dev, ka, kb, kc, sweep_ops)
    for entry in train_entries:
        small = {"sweep_fwd_windowed": "sweep_fwd_windowed",
                 "sweep_bwd [fine step]": "sweep_bwd"}.get(entry["name"])
        if small:
            entry["small_shape_max_abs_err"] = errs[small]
    kernels[0]["name"] = "sweep_fwd [render]"
    # Phase 6: the fused training path.
    fused_entries, training["fused"] = fused_phase(torch, dev, tf, ka, kc,
                                                   sweep_ops, training)
    for entry in fused_entries:
        entry["small_shape_max_abs_err"] = errs[entry["name"].replace(
            "train_fused_", "train_")]
    # Phase 7: the NDC path (DirectMPIGO at fern width).
    mpi_entries, training["mpi"] = mpi_phase(torch, dev, tv, ka, kc,
                                             sweep_ops)
    for entry in mpi_entries:
        if entry["name"].startswith("tv_add_grad"):
            entry["small_shape_max_rel_err"] = errs["tv_add_grad"]
    # Phase 8: the frame-kernel harness (v1, v3, v4) and the op probe.
    harness_entries, training["harness"] = harness_phase(torch, dev, kb)
    # Phase 9: the gather path (DirectVoxGO and DirectMPIGO).
    gather_entries, training["gather"] = gather_phase(torch, dev, ka, kb, kc,
                                                      tf, tv)
    for entry in gather_entries:
        entry["small_shape_max_rel_err"] = errs["tv_add_grad"]
    # Phase 10: the conditioned and multi-scene drivers.
    cond_entries, training["conditioned"] = conditioned_phase(
        torch, dev, ka, kb, kc, tf, sweep_ops)
    # Phase 11: the remaining loaders, the frame outputs and the flags.
    loader_entries, training["loaders"] = loaders_phase(
        torch, dev, ka, kb, kc, tf, sweep_ops,
        {"model": model, "H": 800, "W": 800, "K": K2, "c2w": c2w, "rk": rk})
    # Phase 12: data parallelism, the scan frame core, the watchdog.
    dp_entries, training["data_parallel"] = dp_phase(
        torch, dev, ka, kc,
        {"model": model, "H": 800, "W": 800, "K": K2, "c2w": c2w, "rk": rk})
    training["window_checks"] = errs["window"]
    training["small_graph_checks"] = errs["graphs"]
    fwd = [e for e in train_entries if e["name"].startswith("sweep_fwd")]
    return kernels[:1] + fwd + kernels[1:] \
        + [e for e in train_entries if e not in fwd] + fused_entries \
        + mpi_entries + harness_entries + gather_entries + cond_entries \
        + loader_entries + dp_entries, training


# ---------------------------------------------- phase 10: conditioned

# Configs of the conditioned drivers: each takes the JAX package's config
# of its task (its widths) with the data of fixture_lego_sparse.py (400^2,
# 40/2/4 views, lego teacher); only iteration counts and pg_scale are cut
# (pg_scale [1000, 2000, 3000, 4000] -> [50, 100, 150, 200]: the last 100
# fine steps at 160^3). The coarse stages take 2000 steps: this fixture's
# coarse geometry forms after about 1400 (phase 5), and the fine stages
# draw their rays from its occupancy.
COND_COARSE, COND_FINE, COND_PG = 2000, 300, [50, 100, 150, 200]
# The implicit model: a few dozen fine steps of the NeRF MLP (8 x 256,
# 8192 rays x 256 samples: ~30 GiB at the peak) on (a)'s coarse occupancy.
# At the config's lr its train PSNR over the occupancy's rays falls from
# the first steps on, its test view lands on either side of the white
# frame from run to run, and within a few hundred steps it settles into
# the transparent render (its alpha falls under fast_color_thres, whose
# gate then stops the density gradient; PERF.md section 6): its
# PSNRs are reported, not held to a rise or to the white frame.
MS_FINE = 60
# The joint multi-scene driver on two scenes, then the v1 driver's steps
# resumed from it with its lazy pools and prefetch thread.
V2_COARSE, V2_FINE, V1_STEPS = 300, 300, 20
V2_WEIGHTS = {"weight_consistency": 0.1, "weight_cosine": 0.01}
# Card against CPU, one step of each small model from one state: the loss
# relative, the parameters against their scale (TF32 off on the card).
COND_CPU_TOL = (1e-5, 1e-5)
LEGO_DATA = ("{'datadir': None, 'dataset_type': 'synthetic_fixture', "
             "'white_bkgd': True, 'fixture_kwargs': {'H': 400, 'W': 400, "
             "'n_train': 40, 'n_val': 2, 'n_test': 4, 'teacher_res': 128, "
             "'variant': 'lego'}}")


def write_cond_configs():
    os.makedirs(CKPT_DIR, exist_ok=True)
    specs = {
        "tri": ("tri_default.py", COND_COARSE, COND_FINE, COND_PG, {}, {}),
        "sr": ("sr_default.py", COND_COARSE, COND_FINE, COND_PG, {}, {}),
        "ms": ("multiscene_default.py", COND_COARSE, MS_FINE, None, {}, {}),
        "v2": ("tri_multiscene_default.py", V2_COARSE, V2_FINE, COND_PG,
               V2_WEIGHTS, {"compute_consistency": True,
                            "compute_cosine": True}),
    }
    paths = {}
    for name, (base, n_c, n_f, pg, train_kw, model_kw) in specs.items():
        fine = dict(train_kw, N_iters=n_f)
        if pg is not None:
            fine["pg_scale"] = pg
        paths[name] = os.path.join(CKPT_DIR, f"cond_{name}.py")
        with open(paths[name], "w") as f:
            f.write(f"_base_ = '../../configs/{base}'\n"
                    f"expname = 'cond_{name}'\n"
                    "basedir = './logs/chip_smoke'\n"
                    f"data = {LEGO_DATA}\n"
                    f"coarse_train = {{'N_iters': {n_c}}}\n"
                    f"fine_train = {fine!r}\n"
                    f"fine_model_and_render = {model_kw!r}\n")
    return paths


class CondSteps:
    """Wraps ``engine.train_conditioned.make_cond_train_step``: each
    conditioned step is synchronised and timed on the host clock, with the
    grid's voxels and its PSNR; the last step at each grid size is kept
    with its inputs, to run again."""

    def __init__(self, torch, cond_lib):
        self.torch, self.lib = torch, cond_lib
        self.orig = cond_lib.make_cond_train_step
        self.steps, self.last = [], {}
        cond_lib.make_cond_train_step = self

    def __call__(self, model, *a, **k):
        step = self.orig(model, *a, **k)
        torch = self.torch

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, mse = step(*args)
            torch.cuda.synchronize()
            voxels = int(np_prod(model.world_size))
            self.steps.append((voxels, (time.perf_counter() - t0) * 1e3,
                               -10.0 * float(torch.log10(mse)), float(loss)))
            self.last[voxels] = (step, args)
            return loss, mse
        return timed

    def restore(self):
        self.lib.make_cond_train_step = self.orig

    def summary(self, torch, what, rising=True):
        """(mean PSNR of the first and of the last 30 steps (a third of
        shorter runs), median step ms at the top grid, the trace of 3 more
        steps there). Fails on a loss or PSNR that is not finite, and with
        ``rising`` on a PSNR that did not rise."""
        top = max(s[0] for s in self.steps)
        at_top = [s[1] for s in self.steps if s[0] == top]
        w = max(1, min(30, len(self.steps) // 3))
        first = sum(s[2] for s in self.steps[:w]) / w
        last = sum(s[2] for s in self.steps[-w:]) / w
        step, args = self.last[top]
        torch.cuda.reset_peak_memory_stats()
        trace = profile_step(torch, step, args, {})
        trace["peak_bytes"] = torch.cuda.max_memory_allocated()
        out = {"steps": len(self.steps), "top_voxels": top,
               "steps_at_top": len(at_top), "psnr_first": first,
               "psnr_last": last, "psnr_window": w, "median_step_ms_at_top":
               median(at_top[len(at_top) // 10:]), "trace_at_top": trace}
        log(f"[phase 10] {what}: {out}")
        if not (all(math.isfinite(s[2]) and math.isfinite(s[3])
                    for s in self.steps) and (last > first or not rising)):
            raise AssertionError(f"{what}: train PSNR {first} -> {last} "
                                 "(not rising, or not finite)")
        return out


def _finite_model(torch, model, what):
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError(f"{what}: parameters not finite")


def _white_psnr(torch, imgs):
    return float(sum(psnr(torch.as_tensor(np_f32(im)),
                          torch.ones(np_f32(im).shape)) for im in imgs)
                 / len(imgs))


def np_f32(x):
    import numpy as np
    return np.asarray(x, np.float32)


def _eval(torch, run, what, white, n_views, beat=True):
    """Time an evaluation (``run() -> {split or scene: stats}``) and check
    that each of its splits is finite and (``beat``) beats the white
    frame."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stats = run()
    torch.cuda.synchronize()
    secs = time.time() - t0
    out = {k: float(sum(v["psnr"]) / len(v["psnr"])) for k, v in
           stats.items()}
    log(f"[phase 10] {what}: test PSNR {out} (white frame {white}), "
        f"{secs * 1e3 / n_views:.1f} ms a view, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) and (v > white or not beat)
               for v in out.values()):
        raise AssertionError(f"{what}: test PSNR {out} <= white {white}")
    return {"test_psnr": out, "white_psnr": white,
            "ms_per_view": secs * 1e3 / n_views}


def cond_coarse(torch, ka, kc, run_coarse, n_steps, n_views, what):
    """A coarse stage through the sweep path: K-A and K-C once per step and
    per counted view; returns (checkpoint, seconds, launches)."""
    ka.launches = kc.launches = 0
    t0 = time.time()
    ckpt = run_coarse()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches}
    log(f"[phase 10] {what} coarse: {n_steps} steps in {secs:.1f} s, "
        f"launches {launches} ({n_views} views counted)")
    if launches != {"sweep_fwd": n_steps + n_views,
                    "sweep_bwd": n_steps + n_views}:
        raise AssertionError(f"{what} coarse launches {launches}, expected "
                             f"{n_steps + n_views} each")
    return ckpt, secs, launches


def cond_fine(torch, ka, kb, kc, tf, cond_lib, run_fine, what):
    """A conditioned fine stage: no K-A to K-E launch; returns (model,
    CondSteps, seconds, peak bytes)."""
    ka.launches = kb.launches = kc.launches = 0
    tf.launches_fwd = tf.launches_bwd = 0
    rec = CondSteps(torch, cond_lib)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        model = run_fine()
        torch.cuda.synchronize()
    finally:
        rec.restore()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = [ka.launches, kb.launches, kc.launches, tf.launches_fwd,
                tf.launches_bwd]
    if any(launched):
        raise AssertionError(f"{what} fine stage launched K-A..K-E "
                             f"{launched}")
    _finite_model(torch, model, what)
    return model, rec, secs, peak


def cond_cpu_case(torch, kind, mode, device, full=False, seed=3):
    """One train step of a conditioned model on ``device`` from a seeded
    state (small widths; ``full``: the TriDVGO of tri_default.py at its
    widths on a 64^3 grid): (loss, {name: parameter on the CPU})."""
    import numpy as np
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.engine import train_conditioned as cond_lib
    from directvoxgo_tpu_torch.models import dvgo_multiscene as dms
    from directvoxgo_tpu_torch.models import multiscene_dvgo as msd
    from directvoxgo_tpu_torch.models import sr_dvgo, tri_dvgo
    from directvoxgo_tpu_torch.models import tri_dvgo_multiscene as tms
    cfg = Config.fromfile(os.path.join(REPO, "configs",
                                       "tri_multiscene_default.py"))
    small = dict(rgbnet_dim=4, rgbnet_width=16, n_feats=8, n_resblocks=2,
                 map_width=16, k_density=48, k_color=24,
                 interp_width=16, interp_depth=3)
    kw = dict(xyz_min=[-1.2] * 3, xyz_max=[1.2] * 3, num_voxels=24 ** 3,
              num_voxels_base=24 ** 3, alpha_init=1e-2,
              fast_color_thres=1e-4, device=device,
              generator=torch.Generator().manual_seed(seed))
    if full:
        kw.update(num_voxels=64 ** 3, num_voxels_base=64 ** 3,
                  k_density=256, k_color=64, rgbnet_dim=12, interp_width=64,
                  interp_depth=2)
    else:
        kw.update(small)
    kw.update(mode)
    model = {
        "tri": lambda: tri_dvgo.TriDVGO(**kw),
        "sr": lambda: sr_dvgo.SRDVGO(**dict(kw, rgbnet_dim=6)),
        "implicit": lambda: msd.MultiSceneImplicitDVGO(
            **dict(kw, rgbnet_depth=4, rgbnet_width=32)),
        "dvgo_ms": lambda: dms.DirectVoxGOMultiScene(**kw, n_scene=2),
        "tri_ms": lambda: tms.TriDVGOMultiScene(**kw, n_scene=2),
    }[kind]()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        if model.density is not None:
            model.density.copy_(torch.as_tensor(rng.normal(
                1.0, 2.0, tuple(model.density.shape)).astype(np.float32)))
        if kind == "dvgo_ms":
            model.k0.copy_(torch.as_tensor(rng.normal(
                0, 0.5, tuple(model.k0.shape)).astype(np.float32)))
    n = 1024 if full else 256
    o = rng.uniform(-0.2, 0.2, (n, 3)) + np.array([0.0, 0.0, 3.0])
    d = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, -1.0])
    pool = {"rgb": rng.uniform(0, 1, (n, 3)), "rays_o": o, "rays_d": d,
            "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True)}
    pool = {k: torch.as_tensor(v.astype(np.float32), device=device)
            for k, v in pool.items()}
    sel = torch.arange(n, device=device)
    rk = {"near": 0.5, "far": 6.0, "bg": 1.0, "stepsize": 0.5}
    cfg_train = cfg.fine_train
    cfg_train.N_rand = n
    optimizer = train_lib.create_optimizer_or_freeze_model(model, cfg_train)
    hw = (50, 50) if full else (16, 16)
    chans = 3 if kind == "sr" else 9
    rgb = torch.as_tensor(rng.uniform(-1, 1, (1 if kind == "sr" else 3,
                                              chans, *hw)).astype(np.float32),
                          device=device)
    from directvoxgo_tpu_torch.models.tri_dvgo import anchor_poses
    pose = torch.as_tensor((anchor_poses() + rng.normal(
        0, 0.05, (3, 4, 4))).astype(np.float32), device=device)
    if kind == "dvgo_ms":
        params = [p for g in optimizer.groups.values() for p in g["params"]]
        ret = model(pool["rays_o"], pool["rays_d"], pool["viewdirs"],
                    scene_id=1, **rk)
        loss, _ = cond_lib.conditioned_loss_terms(ret, pool["rgb"],
                                                  cfg_train, n)
        grads = iter(torch.autograd.grad(loss, params))
        loss = loss.detach()
        optimizer.step({name: [next(grads) for _ in g["params"]]
                        for name, g in optimizer.groups.items()})
    else:
        step = cond_lib.make_cond_train_step(
            model, optimizer, cfg_train, rk,
            aux_weights=V2_WEIGHTS if kind == "tri_ms" else None,
            multiscene=kind == "tri_ms")
        loss, _ = step(pool, sel, rgb, None if kind == "sr" else pose, 1)
    return float(loss), {k: v.detach().cpu() for k, v in
                         model.state_dict().items()}


COND_CPU_CASES = [
    ("tri", "concat", {}), ("tri", "sum", {"tri_aggregation": "sum"}),
    ("tri", "liif", {"liif": True}),
    ("tri", "liif feat_unfold", {"liif": True, "feat_unfold": True}),
    ("sr", "direct", {"rgbnet_direct": True}), ("implicit", "mipnerf", {}),
    ("dvgo_ms", "coarse", {"rgbnet_dim": 0}),
    ("tri_ms", "mlp_map", {"compute_consistency": True,
                           "compute_cosine": True}),
    ("tri_ms", "closed_map", {"mlp_map": False, "closed_map": True}),
    ("tri_ms", "conv_map", {"mlp_map": False, "conv_map": True}),
    ("tri_ms", "use_nl", {"mlp_map": False, "use_nl": True}),
    ("tri_ms", "anchor_liif", {"liif": True, "use_anchor_liif": True}),
]


def _step_diff(torch, a, b):
    """(loss relative difference, largest parameter difference against the
    scale of each parameter)."""
    (la, pa), (lb, pb) = a, b
    err = 0.0
    for k in pb:
        if pb[k].dtype.is_floating_point and pb[k].numel():
            scale = max(float(pb[k].abs().max()), 1e-6)
            err = max(err, float((pa[k] - pb[k]).abs().max()) / scale)
    return abs(la - lb) / max(abs(lb), 1e-12), err


def cond_card_vs_cpu(torch, dev):
    """Part (e): each model and mode, one step on the card (TF32 off) and
    on the CPU; then the TriDVGO of tri_default.py at full width with the
    settings the drivers train with (TF32 convolutions)."""
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for kind, name, mode in COND_CPU_CASES:
            d_loss, d_par = _step_diff(
                torch, cond_cpu_case(torch, kind, mode, dev),
                cond_cpu_case(torch, kind, mode, "cpu"))
            out[f"{kind} {name}"] = {"loss_rel": d_loss, "param_rel": d_par}
            if not (d_loss <= COND_CPU_TOL[0] and d_par <= COND_CPU_TOL[1]):
                raise AssertionError(f"{kind} {name}: card against CPU loss "
                                     f"{d_loss}, parameters {d_par}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.backends.cudnn.allow_tf32 = True
    d_loss, d_par = _step_diff(torch, cond_cpu_case(torch, "tri", {}, dev,
                                                    full=True),
                               cond_cpu_case(torch, "tri", {}, "cpu",
                                             full=True))
    out["tri full width, TF32 convolutions"] = {"loss_rel": d_loss,
                                                "param_rel": d_par}
    log(f"[phase 10] (e) card against CPU, one step each: {out}")
    return out


class FixtureScenes:
    """Scenes for the multi-scene drivers from one fixture: each scene the
    fixture's views with its RGB channels permuted (``perms``), the split
    ``idx`` of the data (train or test)."""

    def __init__(self, data, idx, perms):
        self.data, self.idx, self.perms = data, idx, perms
        self.scenes = ["".join("rgb"[c] for c in p) for p in perms]
        self.n_scene = len(perms)

    def scene_data(self, s):
        import numpy as np
        d, idx = self.data, self.idx
        return {"images": np.asarray(d["images"], np.float32)[idx][
                    ..., list(self.perms[s])],
                "poses": d["poses"][idx][:, :3, :4], "Ks": d["Ks"][idx],
                "HW": d["HW"][idx], "near": d["near"], "far": d["far"]}


def conditioned_phase(torch, dev, ka, kb, kc, tf, sweep_ops):
    """Phase 10; returns the kernels-line entries of the conditioned path
    (K-A and K-C of the coarse stages of (a) and (b)) and a summary."""
    import numpy as np
    from directvoxgo_tpu_torch import run_multiscene, run_sr, run_tri
    from directvoxgo_tpu_torch import run_tri_multiscene as v1
    from directvoxgo_tpu_torch import run_tri_multiscene_v2 as v2
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import train_conditioned as cond_lib
    from directvoxgo_tpu_torch.models.multiscene_dvgo import (
        MultiSceneImplicitDVGO)
    from directvoxgo_tpu_torch.ops.resize import area_resize
    paths = write_cond_configs()
    summary = {}
    t_phase = time.time()

    def args_of(path, *more):
        return run_tri.config_parser().parse_args(
            ["--config", path, "--i_print", "100", "--render_test",
             "--device", str(dev), *more])

    # The coarse stages of (a) and (b) through K-A and K-C: every form
    # kept (its last call) and counted, replays included.
    cap_ka = Capture(sweep_ops, "sweep_fwd", form=ka_form(ka))
    cap_kc = Capture(sweep_ops, "sweep_bwd", form=kc_form(torch, kc))
    per_replay = PerReplay(cap_ka, cap_kc)
    try:
        # (a) run_tri.
        args = args_of(paths["tri"], "--no_reload")
        cfg = Config.fromfile(paths["tri"])
        run_tri.setup(args)
        data = load_everything(args, cfg)
        n_views = len(data["i_train"])
        white = _white_psnr(torch, [data["images"][i]
                                    for i in data["i_test"]])
        ckpt, coarse_s, coarse_l = cond_coarse(
            torch, ka, kc, lambda: run_tri.coarse_stage(args, cfg, data, dev),
            COND_COARSE, n_views, "(a) run_tri")
        model, rec, fine_s, peak = cond_fine(
            torch, ka, kb, kc, tf, cond_lib,
            lambda: run_tri.fine_stage(args, cfg, data, ckpt, dev),
            "(a) run_tri")
        a = {"coarse_s": coarse_s, "coarse_launches": coarse_l,
             "fine_s": fine_s, "fine_peak_bytes": peak,
             **rec.summary(torch, "(a) TriDVGO fine")}
        if not os.path.isfile(os.path.join(cfg.basedir, cfg.expname,
                                           "fine_last.tar")):
            raise AssertionError("(a) fine_last.tar was not written")
        sc = run_tri.train_scene(data, data["i_train"])
        images = run_tri.images_on(sc, dev)
        enc = {}
        with torch.no_grad():
            for down in (1, 2, 4, 15):
                rgb, pose = cond_lib.build_conditioning_batch(
                    images, sc["poses"], sc["HW"], sc["Ks"], [0, 1, 2],
                    cfg.data, down=down)
                enc[down] = cuda_time(lambda: model.encode_feat(rgb, pose),
                                      5)
            h3, w3 = images.shape[1] // 3, images.shape[2] // 3
            resize_ms = cuda_time(lambda: area_resize(images[:3], h3, w3),
                                  10)
            batch_ms = cuda_time(lambda: cond_lib.build_conditioning_batch(
                images, sc["poses"], sc["HW"], sc["Ks"], [0, 1, 2],
                cfg.data, down=3), 10)
        a.update(encode_ms_by_down=enc, area_resize_ms_3_views_down_3=resize_ms,
                 conditioning_batch_ms_down_3=batch_ms)
        log(f"[phase 10] (a) EDSR encode of 3 views ms by down {enc}; area "
            f"resize of 3 views to {h3}x{w3} {resize_ms:.3f} ms; "
            f"conditioning batch {batch_ms:.3f} ms")
        del model, images
        a.update(_eval(torch, lambda: run_tri.eval_stage(args, cfg, data,
                                                         dev),
                       "(a) run_tri --render_test", white, 4))
        summary["a_run_tri"] = a

        # (b) run_sr, its LR data made by the area resize at down 4.
        args = args_of(paths["sr"], "--no_reload")
        cfg = Config.fromfile(paths["sr"])
        data = load_everything(args, cfg)
        h_lr = int(data["HW"][0][0]) // 4
        with torch.no_grad():
            data["images_lr"] = area_resize(torch.as_tensor(np.asarray(
                data["images"], np.float32), device=dev), h_lr, h_lr
            ).cpu().numpy()
        data["HW_lr"] = data["HW"] // 4
        data["Ks_lr"] = np.array(data["Ks"], np.float64)
        data["Ks_lr"][:, :2, :3] /= 4
        ckpt, coarse_s, coarse_l = cond_coarse(
            torch, ka, kc, lambda: run_sr.coarse_on_lr(args, cfg, data, dev),
            COND_COARSE, n_views, "(b) run_sr")
        model, rec, fine_s, peak = cond_fine(
            torch, ka, kb, kc, tf, cond_lib,
            lambda: run_sr.fine_stage(args, cfg, data, ckpt, dev),
            "(b) run_sr")
        b = {"coarse_s": coarse_s, "coarse_launches": coarse_l,
             "fine_s": fine_s, "fine_peak_bytes": peak,
             **rec.summary(torch, "(b) SRDVGO fine")}
        with torch.no_grad():
            lr = run_sr.lr_image(data, 0, dev)
            b["encode_ms_lr_view"] = cuda_time(lambda: model.encode_feat(lr),
                                               5)
        del model
        b.update(_eval(torch, lambda: run_sr.eval_stage(args, cfg, data,
                                                        dev),
                       "(b) run_sr --render_test", white, 4))
        summary["b_run_sr"] = b
    finally:
        per_replay.restore()
        cap_kc.restore()
        cap_ka.restore()
    launches = {"sweep_fwd": summary["a_run_tri"]["coarse_launches"][
        "sweep_fwd"] + summary["b_run_sr"]["coarse_launches"]["sweep_fwd"],
        "sweep_bwd": summary["a_run_tri"]["coarse_launches"]["sweep_bwd"]
        + summary["b_run_sr"]["coarse_launches"]["sweep_bwd"]}
    errs = check_kernel_forms(ka, kc, cap_ka, cap_kc, "phase 10 coarse")
    entries = []
    for name, cap, numbers in (
            ("sweep_fwd", cap_ka, lambda a: fwd_numbers(
                torch, ka, *(a[0].detach(), *a[1:], None, 0)[:5])),
            ("sweep_bwd", cap_kc, lambda a: bwd_numbers(torch, kc, *a[:7]))):
        form = cap.counts.most_common(1)[0][0]
        entries.append(dict({
            "name": f"{name} [conditioned coarse]", "route": "cuda",
            "source": f"directvoxgo_tpu_torch/csrc/{name}.cu",
            "replaces": ("directvoxgo_tpu/ops/pallas_sweep_train.py:85"
                         if name == "sweep_fwd" else
                         "directvoxgo_tpu/ops/pallas_sweep_train.py:247"),
            "launches": launches[name],
            "launches_by_form": dict(cap.counts),
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith(name))},
            **numbers(cap.forms[form][0])))

    # (c) run_multiscene: the implicit model, its fine stage on (a)'s
    # coarse checkpoint (the same coarse stage as run_tri's).
    args = args_of(paths["ms"], "--no_reload")
    cfg = Config.fromfile(paths["ms"])
    data = load_everything(args, cfg)
    ckpt = os.path.join(CKPT_DIR, "cond_tri", "coarse_last.tar")
    model, rec, fine_s, peak = cond_fine(
        torch, ka, kb, kc, tf, cond_lib,
        lambda: run_multiscene.fine_stage(args, cfg, data, ckpt, dev),
        "(c) run_multiscene")
    c = {"fine_s": fine_s, "fine_peak_bytes": peak,
         "N_rand": int(cfg.fine_train.N_rand),
         **rec.summary(torch, "(c) MultiSceneImplicitDVGO fine",
                       rising=False)}
    del model
    one = dict(data, i_test=data["i_test"][:1])
    c.update(_eval(torch, lambda: run_tri.eval_stage(
        args, cfg, one, dev, model_class=MultiSceneImplicitDVGO),
        "(c) run_multiscene, one test view", _white_psnr(
            torch, [data["images"][data["i_test"][0]]]), 1, beat=False))
    summary["c_run_multiscene"] = c

    # (d) run_tri_multiscene_v2 on two scenes: the lego fixture and its
    # views with the RGB channels permuted; then the v1 driver's steps.
    args = args_of(paths["v2"], "--no_reload")
    cfg = Config.fromfile(paths["v2"])
    perms = [(0, 1, 2), (1, 2, 0)]
    train_ds = FixtureScenes(data, data["i_train"], perms)
    test_ds = FixtureScenes(data, data["i_test"], perms)
    xyz_min, xyz_max = v2.union_bbox(cfg, train_ds)
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    ka.launches = kc.launches = 0
    t0 = time.time()
    coarse_path, _ = v2.coarse_stage(args, cfg, train_ds, xyz_min, xyz_max,
                                     dev)
    torch.cuda.synchronize()
    d = {"coarse_s": time.time() - t0}
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    c_dens = ckpt_lib.load_checkpoint_file(coarse_path)[
        "model_state_dict"]["density"]
    d["coarse_scene_density_diff"] = float(np.abs(c_dens[0] - c_dens[1])
                                           .max())
    if ka.launches or kc.launches:
        raise AssertionError(f"(d) the joint coarse stage launched K-A "
                             f"{ka.launches}, K-C {kc.launches}")
    model, rec, fine_s, peak = cond_fine(
        torch, ka, kb, kc, tf, cond_lib,
        lambda: v2.fine_stage(args, cfg, train_ds, xyz_min, xyz_max, dev),
        "(d) run_tri_multiscene_v2")
    d.update(fine_s=fine_s, fine_peak_bytes=peak,
             **rec.summary(torch, "(d) TriDVGOMultiScene fine"))
    d["fine_scene_density_diff"] = float(
        (model.density[0] - model.density[1]).detach().abs().max())
    if not d["fine_scene_density_diff"] > 1e-3:
        raise AssertionError(f"(d) the scenes' density grids do not differ: "
                             f"{d['fine_scene_density_diff']}")
    del model
    white_ms = {s: _white_psnr(torch, test_ds.scene_data(i)["images"])
                for i, s in enumerate(test_ds.scenes)}
    d.update(_eval(torch, lambda: v2.eval_stage(args, cfg, train_ds, dev,
                                                test_dataset=test_ds),
                   "(d) run_tri_multiscene_v2 --render_test per scene",
                   max(white_ms.values()), 4 * len(perms)))
    # v1: resumes v2's checkpoint and takes V1_STEPS steps over lazy pools.
    cfg.fine_train.N_iters = V2_FINE + V1_STEPS
    args = args_of(paths["v2"])
    model, rec, v1_s, _ = cond_fine(
        torch, ka, kb, kc, tf, cond_lib,
        lambda: v1.fine_stage(args, cfg, train_ds, xyz_min, xyz_max, dev),
        "(d) run_tri_multiscene v1")
    if len(rec.steps) != V1_STEPS:
        raise AssertionError(f"(d) v1 took {len(rec.steps)} steps")
    d["v1"] = {"steps": len(rec.steps), "seconds": v1_s,
               "median_step_ms": median([s[1] for s in rec.steps])}
    log(f"[phase 10] (d) v1 driver: {d['v1']}")
    del model
    summary["d_run_tri_multiscene"] = d
    torch.cuda.empty_cache()

    # (e) card against CPU.
    summary["e_card_vs_cpu"] = cond_card_vs_cpu(torch, dev)
    summary["seconds"] = time.time() - t_phase
    log(f"[phase 10] done in {summary['seconds']:.1f} s")
    return entries, summary


# --------------------------------- phase 11: remaining loaders and flags

# The fixture of phases 5 and 10 (400^2, 40/2/4 views, lego teacher) is
# written as a scene in each layout of the remaining loaders, under
# logs/chip_smoke/scenes/, and read back through the configs of configs/
# (their data paths replaced).
LOADER_FIXTURE = {"H": 400, "W": 400, "n_train": 40, "n_val": 2,
                  "n_test": 4, "teacher_res": 128, "variant": "lego"}
SCENES_DIR = os.path.join(CKPT_DIR, "scenes")
# layout -> (config read and trained, the written scene's directory name)
LAYOUT_CONFIGS = {"nsvf": "nsvf/Bike.py", "blendedmvs": "blendedmvs/Jade.py",
                  "tankstemple": "tankstemple/Barn.py",
                  "deepvoxels": "deepvoxels/cube.py",
                  "co3d": "co3d/donut_369_40208_78816.py"}
# The configs trained at full width, only the datadir, the iteration
# counts and pg_scale cut: layout -> (coarse steps, fine steps, fine
# pg_scale). NSVF trains no coarse stage (its config's); the others keep
# 2000 coarse steps, as phase 10 does on this fixture. The fine stages
# keep phase 5's 100 steps between rescales: at 50 (four rescales in 200
# steps) the Tanks&Temples fine grid emptied after its last rescales (its
# test views rendered nearly transparent on an H100; PERF.md section 6).
LOADER_TRAIN = {"nsvf": (0, 600, [100, 200, 300, 400]),
                "tankstemple": (2000, 600, [100, 200, 300, 400]),
                "co3d": (2000, 600, [100, 200, 300, 400])}
# run_tri_multiscene_v2 on two NSVF scenes: coarse and fine steps.
LOADER_MS_STEPS = (200, 30)
# Steps of the run traced with --profile_dir (coarse, fine).
PROFILE_STEPS = (20, 10)
# A fixture key that no cache holds (the lego fixture at another seed),
# rendered on the card; and a small one held against the CPU.
GT_KEY = dict(LOADER_FIXTURE, seed=1)
GT_SMALL = {"H": 32, "W": 40, "n_train": 2, "n_val": 1, "n_test": 1,
            "teacher_res": 32, "variant": "lego", "seed": 5}
GT_TOL = 1e-5
OUTPUT_TIMED = 10
FRAME_VS_RAYS_MIN_PSNR = 30.0
LAYOUT_RAYS_TOL = 1e-5
BLOCKED_MODULES = ("imageio", "cv2", "PIL")


class BlockedImports:
    """Makes ``import imageio``, ``cv2`` and ``PIL`` fail (as on a machine
    without them) until ``restore``."""

    def __init__(self):
        self.saved = {m: sys.modules.get(m) for m in BLOCKED_MODULES}
        for m in BLOCKED_MODULES:
            sys.modules[m] = None

    def restore(self):
        for m, mod in self.saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def layout_flags(cfg):
    return (bool(cfg.data.inverse_y), bool(cfg.data.flip_x),
            bool(cfg.data.flip_y))


def write_loader_config(name, base, data=None, iters=None):
    """``logs/chip_smoke/loaders_<name>.py``: ``_base_`` the config
    ``base`` (relative to that directory), its own expname, and ``data``
    and ``iters`` ((coarse steps, fine steps, fine pg_scale)) when given;
    returns its path."""
    os.makedirs(CKPT_DIR, exist_ok=True)
    lines = [f"_base_ = {base!r}", f"expname = 'loaders_{name}'",
             "basedir = './logs/chip_smoke'"]
    if data is not None:
        lines.append(f"data = {data!r}")
    if iters is not None:
        lines += [f"coarse_train = {{'N_iters': {iters[0]}}}",
                  f"fine_train = {{'N_iters': {iters[1]}, "
                  f"'pg_scale': {iters[2]!r}}}"]
    path = os.path.join(CKPT_DIR, f"loaders_{name}.py")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_loader_configs(scenes):
    """One config per layout, ``_base_`` the layout's config of configs/,
    with the written scene's paths and (for the trained ones) the cut
    iteration counts; returns {layout: path}."""
    return {layout: write_loader_config(
        layout, f"../../configs/{base}", scenes[layout]["data"],
        LOADER_TRAIN.get(layout)) for layout, base in LAYOUT_CONFIGS.items()}


def write_loader_scenes(torch, dev, data):
    """The fixture written as a scene in each layout under SCENES_DIR:
    8-bit PNGs, the poses in the layout's convention; for CO3D a mask of
    the object (the pixels not white), the NDC intrinsics, and every other
    view cropped with its principal point moved (two view sizes); for
    DeepVoxels the views resampled to its 512^2 target (bilinear on the
    card), so that one is held by its cameras and loaded only. Returns
    {layout: {"data": data paths of its config, "order": the fixture
    index of each view as its loader orders them, "crops", "expect":
    fixture index -> the 8-bit view it must load, in float64}}."""
    import shutil
    import numpy as np
    from directvoxgo_tpu_torch.tools import scene_layouts as sl
    shutil.rmtree(SCENES_DIR, ignore_errors=True)
    images, poses, Ks = data["images"], data["poses"], data["Ks"]
    tr, va, te = (list(map(int, data[k])) for k in ("i_train", "i_val",
                                                    "i_test"))
    h, w = images.shape[1:3]
    u8 = [sl.to_u8(im) for im in images]
    out = {}
    for layout in ("nsvf", "blendedmvs", "tankstemple"):
        root = os.path.join(SCENES_DIR, layout)
        splits = [tr, va, te] if layout == "nsvf" else [tr, te]
        order = sl.write_prefix_split(
            root, images, poses, Ks[0], splits, layout != "nsvf",
            render_traj=poses[te] if layout == "blendedmvs" else None)
        out[layout] = {"data": {"datadir": root}, "order": order,
                       "crops": None, "expect": lambda i: u8[i] / 255.0}
    masks = [(im < 0.98).any(-1).astype(np.float32) for im in images]
    crops = [(h // 24, w // 16, h - h // 8, w - w // 6) if i % 2 else None
             for i in range(len(images))]
    root = os.path.join(SCENES_DIR, "co3d")
    annot, split = sl.write_co3d(root, images, poses, Ks, tr, te,
                                 masks=masks, crops=crops, category="donut",
                                 sequence="369_40208_78816")
    order = tr + te

    def cut(x, i):
        y0, x0, hh, ww = crops[i] if crops[i] else (0, 0, h, w)
        return x[y0:y0 + hh, x0:x0 + ww]
    out["co3d"] = {"data": {"datadir": root, "annot_path": annot,
                            "split_path": split},
                   "order": order, "crops": crops,
                   "expect": lambda i: cut(u8[i], i) / 255.0 * cut(
                       masks[i], i).astype(np.float64)[..., None]}
    with torch.no_grad():
        up = torch.nn.functional.interpolate(
            torch.as_tensor(np.asarray(images, np.float32),
                            device=dev).permute(0, 3, 1, 2),
            size=(sl.DV_TARGET, sl.DV_TARGET), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).cpu().numpy()
    root = os.path.join(SCENES_DIR, "deepvoxels")
    sl.write_deepvoxels(root, "cube", up, poses, Ks[0], (h, w), [tr, va, te])
    out["deepvoxels"] = {"data": {"datadir": root}, "order": tr + va + te,
                         "crops": None,
                         "expect": lambda i: sl.to_u8(up[i]) / 255.0}
    return out


def check_loaded_scene(layout, cfg, loaded, scene, data):
    """A loaded scene against the fixture: its 8-bit views exactly, poses
    (in the layout's camera axes) and K to 1e-6, and the rays of each view (the loader's cameras with
    the config's inverse_y / flip_x / flip_y) against the fixture's at the
    same pixels to LAYOUT_RAYS_TOL; DeepVoxels' rays at its 512^2 pixel
    centres against the fixture camera's at the same points of the image.
    Returns the largest ray difference."""
    import numpy as np
    from directvoxgo_tpu_torch import rays as ray_lib
    from directvoxgo_tpu_torch.tools import scene_layouts as sl
    inv, fx, fy = layout_flags(cfg)
    order, crops = scene["order"], scene["crops"]
    # the camera axes of the layout's poses
    conv = {"deepvoxels": np.eye(4), "co3d": sl.GL_TO_P3D}.get(
        layout, sl.GL_TO_CV)
    h, w = data["images"].shape[1:3]
    if len(loaded["images"]) != len(order):
        raise AssertionError(f"{layout}: {len(loaded['images'])} views "
                             f"loaded, {len(order)} written")
    ray_err = 0.0
    for v, i in enumerate(order):
        want = np.asarray(scene["expect"](i), np.float64).astype(np.float32)
        got = np.asarray(loaded["images"][v])
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{layout} view {v}: loaded image differs "
                                 "from the fixture's 8-bit view")
        pose = np.asarray(loaded["poses"][v], np.float64)[:3, :4]
        c2w = np.eye(4)
        c2w[:3, :4] = data["poses"][i]
        pose_want = (c2w @ conv)[:3, :4]
        if not np.allclose(pose, pose_want, rtol=0, atol=1e-6):
            raise AssertionError(f"{layout} view {v}: pose differs by "
                                 f"{np.abs(pose - pose_want).max()}")
        K = np.asarray(loaded["Ks"][v], np.float64)[:3, :3]
        K0 = np.asarray(data["Ks"][i], np.float64)
        y0, x0, hh, ww = crops[i] if crops and crops[i] else (0, 0, h, w)
        if layout == "deepvoxels":
            s = 512.0 / h
            K_want = np.array([[K0[0, 0] * s, 0, 256.0],
                               [0, K0[1, 1] * s, 256.0], [0, 0, 1]])
        elif layout == "co3d":
            K_want = K0.copy()
            K_want[0, 2] = ww + x0 - K0[0, 2]
            K_want[1, 2] = hh + y0 - K0[1, 2]
        else:
            K_want = K0
        if not np.allclose(K, K_want, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"{layout} view {v}: K {K} against "
                                 f"{K_want}")
        H, W = (int(x) for x in loaded["HW"][v])
        ro, rd, _ = ray_lib.get_rays_of_a_view(
            H, W, loaded["Ks"][v], pose.astype(np.float32), False, inv, fx,
            fy)
        if layout == "deepvoxels":
            c2w = np.asarray(data["poses"][i], np.float64)
            u = (np.arange(W) + 0.5) * w / W
            t = (np.arange(H) + 0.5) * h / H
            uu, tt = np.meshgrid(u, t)
            dirs = np.stack([(uu - K0[0, 2]) / K0[0, 0],
                             -(tt - K0[1, 2]) / K0[1, 1],
                             -np.ones_like(uu)], -1)
            rd0 = dirs @ c2w[:3, :3].T
            ro0 = np.broadcast_to(c2w[:3, 3], rd0.shape)
        else:
            ro0, rd0, _ = ray_lib.get_rays_of_a_view(
                h, w, data["Ks"][i], data["poses"][i], False, False, False,
                False)
            ro0, rd0 = (x[y0:y0 + hh, x0:x0 + ww] for x in (ro0, rd0))
        ray_err = max(ray_err, float(np.abs(ro - ro0).max()),
                      float(np.abs(rd - rd0).max()))
    if not ray_err <= LAYOUT_RAYS_TOL:
        raise AssertionError(f"{layout}: rays differ from the fixture's by "
                             f"{ray_err}")
    return ray_err


def background_psnr(data, bg):
    import numpy as np
    return float(np.mean([
        -10.0 * np.log10(np.mean((np.asarray(data["images"][i], np.float32)
                                  - bg) ** 2)) for i in data["i_test"]]))


def frame_vs_rays(torch, ckpt, cfg, data, dev):
    """The first test view of ``data`` that the frame plan accepts for the
    model ``ckpt``, rendered whole (K-B) and per ray (K-A), with ``cfg``'s
    background and ray flags: {"view", "hw", "psnr"}, or None when the
    plan accepts none; ``content_share`` is the share of its pixels that
    the per-ray render sets apart from the background."""
    import numpy as np
    from directvoxgo_tpu_torch import rays as ray_lib
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import render as render_lib
    from directvoxgo_tpu_torch.engine import render_sweep
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    model = ckpt_lib.load_model(DirectVoxGO, ckpt, device=dev)
    inv, fx, fy = layout_flags(cfg)
    rk = {"near": data["near"], "far": data["far"],
          "bg": 1.0 if cfg.data.white_bkgd else 0.0,
          "stepsize": cfg.fine_model_and_render.stepsize, "inverse_y": inv,
          "flip_x": fx, "flip_y": fy}
    for i in data["i_test"]:
        H, W = (int(x) for x in data["HW"][i])
        K, c2w = data["Ks"][i], data["poses"][i]
        out = render_sweep.render_frame_sweep(model, H, W, K, c2w, rk)
        if out is None:
            continue
        ro, rd, vd = ray_lib.get_rays_of_a_view(H, W, K, c2w, False, inv,
                                                fx, fy)
        rgb_r, _ = render_lib.render_rays_chunked(
            render_lib.make_render_fn(model, rk), model, ro.reshape(-1, 3),
            rd.reshape(-1, 3), vd.reshape(-1, 3), 8192)
        return {"view": int(i), "hw": [H, W], "psnr": psnr(
            torch.as_tensor(out[0].reshape(-1, 3)), torch.as_tensor(rgb_r)),
            "content_share": float(np.mean(
                np.abs(rgb_r - rk["bg"]).max(-1) > 0.05))}
    return None


def loader_train(torch, dev, ka, kb, kc, sweep_ops, layout, cfg_path, cfg,
                 data, caps):
    """Train ``layout``'s config through ``run.main`` (in process) and
    render its test views with ``--render_test``: K-A and K-C once per
    step (a blocked step once per block) and per counted view, window
    draws past 1.1 M voxels, a rising train PSNR, finite checkpoints, a
    test PSNR above the background frame's, K-B once per view the frame
    plan accepts; then one accepted view whole against per ray
    (:func:`frame_vs_rays`, held by the caller). Returns a summary."""
    import numpy as np
    from directvoxgo_tpu_torch import run as run_lib
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import draws as draws_lib
    from directvoxgo_tpu_torch.engine import render_sweep
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    n_c, n_f, _ = LOADER_TRAIN[layout]
    n_views = len(data["i_train"]) if n_c > 0 and \
        cfg.coarse_train.pervoxel_lr else 0
    rec = StepRecorder(train_lib)
    cap_a = Capture(sweep_ops, "sweep_fwd", form=rec.form)
    cap_c = Capture(sweep_ops, "sweep_bwd", form=rec.form)
    per_replay = PerReplay(cap_a, cap_c)
    ka.launches = kb.launches = kc.launches = 0
    t0 = time.time()
    try:
        run_lib.main(["--config", cfg_path, "--no_reload", "--i_print",
                      "100", "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        per_replay.restore()
        cap_c.restore()
        cap_a.restore()
        rec.restore()
    secs = time.time() - t0
    launches = {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches,
                "render_frame": kb.launches}
    steps = list(rec.steps)
    coarse = [s for s in steps if s[0] == "coarse"]
    fine = [s for s in steps if s[0] == "fine"]
    want = collections.Counter({"counted view": n_views} if n_views else {})
    for st in steps:
        want[step_form(st[0], st[6])] += sweep_launches([st])
    want = dict(want)
    kinds = collections.Counter(f"{st[0]} {st[6]}" for st in steps)
    past = [s for s in fine if s[1] > draws_lib.SMALL_GRID_VOXELS]
    top = max(s[1] for s in fine)
    log(f"[phase 11] {layout}: run.main trained {len(coarse)} coarse + "
        f"{len(fine)} fine steps in {secs:.1f} s; launches {launches}; "
        f"{n_views} views counted; draws {dict(kinds)}; steps past 1.1 M "
        f"voxels {len(past)}, their draws "
        f"{dict(collections.Counter(s[6] for s in past))}")
    if not (len(coarse) == n_c and len(fine) == n_f
            and dict(cap_a.counts) == want and dict(cap_c.counts) == want
            and launches["sweep_fwd"] == sum(want.values())
            and launches["sweep_bwd"] == sum(want.values())
            and launches["render_frame"] == 0 and past):
        raise AssertionError(
            f"{layout}: launches {launches} (K-A by form "
            f"{dict(cap_a.counts)}, K-C {dict(cap_c.counts)}) against "
            f"{want}; steps {len(coarse)} + {len(fine)}; draws {dict(kinds)}")
    # A batch of background rays only can be rendered exactly (PSNR inf):
    # the PSNR of a window of steps is that of their mean squared error.
    if not all(np.isfinite(s[4]) and not np.isnan(s[3]) for s in steps):
        raise AssertionError(f"{layout}: a loss or PSNR is not finite")

    def window_psnr(window):
        mse = np.mean([10.0 ** (-s[3] / 10.0) for s in window])
        return float(-10.0 * np.log10(max(mse, 1e-30)))
    first, last = window_psnr(steps[:30]), window_psnr(fine[-30:])
    log(f"[phase 11] {layout}: train PSNR (of the mean squared error) of "
        f"the first 30 steps {first:.2f} dB, of the last 30 fine steps "
        f"{last:.2f} dB ({sum(np.isinf(s[3]) for s in steps)} batches "
        f"rendered exactly); median fine step at {top} "
        f"voxels {median([s[2] for s in fine if s[1] == top]):.2f} ms; "
        f"steps by how they ran {how_steps_ran(steps)}")
    if not last > first:
        raise AssertionError(f"{layout}: train PSNR {first} -> {last}")
    logdir = os.path.join(cfg.basedir, cfg.expname)
    for stage in (("coarse", "fine") if n_c else ("fine",)):
        model = ckpt_lib.load_model(DirectVoxGO, os.path.join(
            logdir, f"{stage}_last.tar"), device=dev)
        _finite_model(torch, model, f"{layout} {stage}_last.tar")

    # --render_test of the trained model: K-B for the views the frame plan
    # accepts, K-A per ray for the others.
    cap_r = Capture(run_lib, "render_viewpoints", results=True)
    cap_b = Capture(render_sweep, "render_frame", keep=1)
    ka.launches = kb.launches = kc.launches = 0
    try:
        run_lib.main(["--config", cfg_path, "--render_only", "--render_test",
                      "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        cap_b.restore()
        cap_r.restore()
    stats = cap_r.results[0][2]
    paths = collections.Counter(stats["path"])
    bg = 1.0 if cfg.data.white_bkgd else 0.0
    bg_psnr = background_psnr(data, bg)
    test_psnr = float(np.mean(stats["psnr"]))
    render = {"launches": {"render_frame": kb.launches,
                           "sweep_fwd": ka.launches,
                           "sweep_bwd": kc.launches},
              "views_by_path": dict(paths), "test_psnr": test_psnr,
              "background_psnr": bg_psnr}
    log(f"[phase 11] {layout}: --render_test {render}")
    if not (kb.launches == paths["frame"] and kc.launches == 0
            and (ka.launches > 0) == (paths["rays"] > 0)
            and test_psnr > bg_psnr):
        raise AssertionError(f"{layout}: render {render}")
    if cap_b.calls:
        caps["frame"] = cap_b.calls[-1]

    # One accepted view whole (K-B) against the same view per ray (K-A).
    frame_rays = frame_vs_rays(torch, os.path.join(logdir, "fine_last.tar"),
                               cfg, data, dev)
    log(f"[phase 11] {layout}: an accepted view whole against per ray: "
        f"{frame_rays}")
    return {"seconds": secs, "coarse_steps": len(coarse),
            "fine_steps": len(fine), "launches": launches,
            "counted_views": n_views, "draws": dict(kinds),
            "steps_past_1_1M": len(past), "top_voxels": top,
            "median_fine_ms_at_top": median([s[2] for s in fine
                                             if s[1] == top]),
            "train_psnr_first30": first, "train_psnr_last30": last,
            "render": render, "frame_vs_rays": frame_rays}


def frame_outputs_check(torch, model, H, W, K, c2w, rk):
    """The 800^2 lego frame in each output form: ``device_compact`` bit for
    bit against ``round(clip(f32 frame) * 255)`` and f16 depth,
    ``device_yuv420`` against its plain conversion in float64 on the host
    (within one level; the share exact), ms and bytes per frame."""
    import numpy as np
    from directvoxgo_tpu_torch.engine import render_sweep
    rgb, depth = render_sweep.render_frame_sweep(model, H, W, K, c2w, rk,
                                                 output="device")
    rgb_np, depth_np = rgb.cpu().numpy(), depth.cpu().numpy()
    c_rgb, c_depth = render_sweep.render_frame_sweep(
        model, H, W, K, c2w, rk, output="device_compact")
    compact_exact = bool(np.array_equal(
        c_rgb.cpu().numpy(),
        np.round(np.clip(rgb_np, 0, 1) * 255).astype(np.uint8))) and bool(
        np.array_equal(c_depth.cpu().numpy(), depth_np.astype(np.float16)))
    buf, y_depth = render_sweep.render_frame_sweep(
        model, H, W, K, c2w, rk, output="device_yuv420")
    x = rgb_np.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    u = -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 0.5
    v = 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 0.5

    def box(p):
        h2, w2 = -(-H // 2), -(-W // 2)
        pad = np.full((2 * h2, 2 * w2), np.nan)
        pad[:H, :W] = p
        return np.nanmean(pad.reshape(h2, 2, w2, 2), (1, 3))
    ref = np.concatenate([np.round(np.clip(a, 0, 1) * 255).reshape(-1)
                          for a in (y, box(u), box(v))])
    got = buf.cpu().numpy().astype(np.float64)
    yuv_diff = float(np.abs(got - ref).max()) if got.shape == ref.shape \
        else float("inf")
    out = {"compact_exact": compact_exact, "yuv420_max_level_diff": yuv_diff,
           "yuv420_exact_share": float(np.mean(got == ref))
           if got.shape == ref.shape else 0.0,
           "yuv420_depth_f16_exact": bool(np.array_equal(
               y_depth.cpu().numpy(), depth_np.astype(np.float16))),
           "ms_per_frame": {}, "bytes_per_frame": {}}
    for o in render_sweep.OUTPUTS:
        def call():
            res = render_sweep.render_frame_sweep(model, H, W, K, c2w, rk,
                                                  output=o)
            torch.cuda.synchronize()
            return res
        res = call()
        out["bytes_per_frame"][o] = int(sum(
            r.nbytes if isinstance(r, np.ndarray)
            else r.numel() * r.element_size() for r in res))
        out["ms_per_frame"][o] = host_time(call, OUTPUT_TIMED)
    log(f"[phase 11] (e) 800^2 frame outputs: {out}")
    if not (compact_exact and yuv_diff <= 1.0
            and out["yuv420_depth_f16_exact"]):
        raise AssertionError(f"frame outputs: {out}")
    return out


def export_checks(torch, dev):
    """The three export flags through ``run.main`` on phase 5's checkpoints
    (``logs/chip_smoke/train_lego``): the JAX driver's npz keys, shapes
    that follow the checkpoints, finite values."""
    import numpy as np
    from directvoxgo_tpu_torch import run as run_lib
    out = {}
    for flag, keys in (("export_bbox_and_cams_only",
                        ("xyz_min", "xyz_max", "cam_lst")),
                       ("export_coarse_only", ("alpha", "rgb")),
                       ("export_fine_only", ("alpha", "rgb"))):
        path = os.path.join(CKPT_DIR, f"{flag}.npz")
        t0 = time.time()
        run_lib.main(["--config", TRAIN_CONFIG, f"--{flag}", path,
                      "--device", str(dev)])
        with np.load(path) as z:
            shapes = {k: list(z[k].shape) for k in z.files}
            finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
        out[flag] = {"shapes": shapes, "seconds": time.time() - t0}
        ok = set(shapes) == set(keys) and finite and (
            shapes["cam_lst"][1:] == [5, 3] if "cam_lst" in keys
            else shapes["alpha"] == shapes["rgb"][:3])
        if not ok:
            raise AssertionError(f"--{flag}: {shapes}, finite {finite}")
    log(f"[phase 11] (e) export flags on phase 5's checkpoints: {out}")
    return out


def profile_check(torch, dev, cfg_path):
    """``--profile_dir`` over a short run of ``cfg_path`` (its iteration
    counts cut to PROFILE_STEPS): a trace.json whose kernel events name
    K-A and K-C."""
    from directvoxgo_tpu_torch import run as run_lib
    prof_cfg = write_loader_config("profile", os.path.basename(cfg_path),
                                   iters=(*PROFILE_STEPS, []))
    prof_dir = os.path.join(CKPT_DIR, "profile")
    t0 = time.time()
    run_lib.main(["--config", prof_cfg, "--no_reload", "--profile_dir",
                  prof_dir, "--device", str(dev)])
    secs = time.time() - t0
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(
        m.group(0) for m in (re.search(r"sweep_\w+", e.get("name", ""))
                             for e in events if e.get("cat") == "kernel")
        if m)
    out = {"seconds": secs, "events": len(events),
           "trace_bytes": os.path.getsize(os.path.join(prof_dir,
                                                       "trace.json")),
           "sweep_kernel_events": dict(kernels)}
    log(f"[phase 11] (e) --profile_dir: {out}")
    names = " ".join(kernels)
    if not ("sweep_fwd" in names and "sweep_bwd" in names):
        raise AssertionError(f"--profile_dir trace names no K-A or K-C: "
                             f"{out}")
    return out


def gt_checks(torch, dev):
    """The ground truth of an uncached fixture key rendered on the card
    (seconds), and a small key on the card against the CPU."""
    import shutil
    import numpy as np
    from directvoxgo_tpu_torch.data import synthetic
    cache = os.path.join(CKPT_DIR, "gt_cache")
    shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.time()
    d = synthetic.make_synthetic_dataset(cache_dir=cache, device=dev,
                                         **GT_KEY)
    secs = time.time() - t0
    small_card = synthetic.make_synthetic_dataset(device=dev, **GT_SMALL)
    small_cpu = synthetic.make_synthetic_dataset(device="cpu", **GT_SMALL)
    err = float(np.abs(small_card["images"] - small_cpu["images"]).max())
    out = {"key": GT_KEY, "views": len(d["images"]), "seconds": secs,
           "cached_files": sorted(os.listdir(cache)),
           "small_card_vs_cpu": err}
    log(f"[phase 11] (e) GT generation: {out}")
    if not (err <= GT_TOL and len(out["cached_files"]) == 1
            and np.isfinite(d["images"]).all()
            and np.abs(d["images"] - 1.0).max() > 0.1):
        raise AssertionError(f"GT generation: {out}")
    return out


def loaders_phase(torch, dev, ka, kb, kc, tf, sweep_ops, lego):
    """Phase 11; ``lego`` holds phase 4's model and 800^2 camera (``model``,
    ``H``, ``W``, ``K``, ``c2w``, ``rk``). Returns the kernels-line entries of K-A, K-B
    and K-C on the new loaders' runs and a summary."""
    import numpy as np
    from directvoxgo_tpu_torch import run_tri_multiscene_v2 as v2
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
    from directvoxgo_tpu_torch.engine import train_conditioned as cond_lib
    from directvoxgo_tpu_torch.tools import scene_layouts as sl
    t_phase = time.time()
    summary = {}
    fixture = make_synthetic_dataset(white_bkgd=True, **LOADER_FIXTURE)
    blocked = BlockedImports()
    try:
        # (a) write the scenes, (b) load them back without imageio / cv2.
        t0 = time.time()
        scenes = write_loader_scenes(torch, dev, fixture)
        paths = write_loader_configs(scenes)
        summary["write_s"] = time.time() - t0
        loads = {}
        for layout in LAYOUT_CONFIGS:
            cfg = Config.fromfile(paths[layout])
            t0 = time.time()
            loaded = load_everything(None, cfg)
            load_s = time.time() - t0
            err = check_loaded_scene(layout, cfg, loaded, scenes[layout],
                                     fixture)
            loads[layout] = {"seconds": load_s, "views": len(
                loaded["images"]), "irregular": bool(
                loaded["irregular_shape"]), "near": float(loaded["near"]),
                "far": float(loaded["far"]), "rays_max_diff": err}
            if layout == "co3d" and not loaded["irregular_shape"]:
                raise AssertionError("co3d: the views do not differ in size")
        log(f"[phase 11] (a, b) scenes written in {summary['write_s']:.1f} s "
            f"and loaded with {BLOCKED_MODULES} blocked: {loads}")
        summary["loads"] = loads

        # (c) train three of the layouts' configs at full width.
        cap_ka = Capture(sweep_ops, "sweep_fwd", form=ka_form(ka))
        cap_kc = Capture(sweep_ops, "sweep_bwd", form=kc_form(torch, kc))
        per_replay = PerReplay(cap_ka, cap_kc)
        caps, trained = {}, {}
        try:
            for layout in LOADER_TRAIN:
                cfg = Config.fromfile(paths[layout])
                data = load_everything(None, cfg)
                trained[layout] = loader_train(
                    torch, dev, ka, kb, kc, sweep_ops, layout, paths[layout],
                    cfg, data, caps)
        finally:
            per_replay.restore()
            cap_kc.restore()
            cap_ka.restore()
        summary["trained"] = trained
        # A whole frame against the same view per ray: NSVF and
        # Tanks&Temples on their own models; the CO3D cameras (flips, an
        # off-centre principal point, cropped views) on the Tanks&Temples
        # model, which sees the same fixture world (the CO3D model's black
        # background lets it keep floaters at its grid's edge, where the
        # frame's footprint and the per-ray march part ways: reported
        # only).
        co3d_cfg = Config.fromfile(paths["co3d"])
        trained["co3d"]["frame_vs_rays_on_tankstemple_model"] = \
            frame_vs_rays(torch, os.path.join(CKPT_DIR, "loaders_tankstemple",
                                              "fine_last.tar"), co3d_cfg,
                          load_everything(None, co3d_cfg), dev)
        held = {"nsvf": trained["nsvf"]["frame_vs_rays"],
                "tankstemple": trained["tankstemple"]["frame_vs_rays"],
                "co3d": trained["co3d"]["frame_vs_rays_on_tankstemple_model"]}
        log(f"[phase 11] (c) whole frames against per ray, held: {held}; "
            f"the CO3D model's own: {trained['co3d']['frame_vs_rays']}")
        if not all(v is not None and v["psnr"] > FRAME_VS_RAYS_MIN_PSNR
                   and v["content_share"] > 0.01 for v in held.values()):
            raise AssertionError(f"(c) frame against per ray: {held}")

        # (d) run_tri_multiscene_v2 on two NSVF scenes (the fixture and its
        # views with the RGB channels permuted) through the multi-scene
        # NSVF dataset.
        ms_root = os.path.join(SCENES_DIR, "nsvf_multi")
        for name, perm in (("Bike", [0, 1, 2]), ("Palace", [1, 2, 0])):
            sl.write_prefix_split(
                os.path.join(ms_root, name), fixture["images"][..., perm],
                fixture["poses"], fixture["Ks"][0],
                [list(fixture[k]) for k in ("i_train", "i_val", "i_test")],
                False)
        ms_cfg = write_loader_config(
            "multiscene", "../../configs/nsvf/tri_multiscene_nsvf.py",
            {"datadir": ms_root}, (*LOADER_MS_STEPS, []))
        cap_ds = Capture(v2, "load_multiscene", results=True)
        ka.launches = kb.launches = kc.launches = 0
        tf.launches_fwd = tf.launches_bwd = 0
        rec = CondSteps(torch, cond_lib)
        t0 = time.time()
        try:
            v2.main(["--config", ms_cfg, "--no_reload", "--device",
                     str(dev)])
            torch.cuda.synchronize()
        finally:
            rec.restore()
            cap_ds.restore()
        ds = cap_ds.results[0]
        ms = {"seconds": time.time() - t0, "scenes": list(ds.scenes),
              "near_far": [float(ds.near), float(ds.far)],
              "fine_steps": len(rec.steps),
              "median_fine_ms": median([s[1] for s in rec.steps]),
              "launches": [ka.launches, kb.launches, kc.launches,
                           tf.launches_fwd, tf.launches_bwd]}
        log(f"[phase 11] (d) run_tri_multiscene_v2 on two NSVF scenes: {ms}")
        if not (type(ds).__name__ == "MultisceneNSVFDataset"
                and ds.n_scene == 2 and len(rec.steps) == LOADER_MS_STEPS[1]
                and all(np.isfinite(s[2]) and np.isfinite(s[3])
                        for s in rec.steps) and not any(ms["launches"])):
            raise AssertionError(f"(d) multi-scene NSVF: {ms}")
        summary["multiscene_nsvf"] = ms
    finally:
        blocked.restore()

    # (e) the frame outputs, the export flags, --profile_dir, GT generation.
    summary["frame_outputs"] = frame_outputs_check(
        torch, lego["model"], lego["H"], lego["W"], lego["K"], lego["c2w"],
        lego["rk"])
    summary["exports"] = export_checks(torch, dev)
    summary["profile"] = profile_check(torch, dev, paths["tankstemple"])
    summary["gt_generation"] = gt_checks(torch, dev)

    # The kernels line: K-A and K-C over the three training runs and their
    # renders, checked and timed on the last call of their most common
    # form; K-B over the renders, on the last frame rendered.
    launches = {n: sum(t["launches"][n] + t["render"]["launches"][n]
                       for t in trained.values())
                for n in ("sweep_fwd", "sweep_bwd", "render_frame")}
    errs = check_kernel_forms(ka, kc, cap_ka, cap_kc, "phase 11")
    entries = []
    for name, cap, numbers in (
            ("sweep_fwd", cap_ka, lambda a: fwd_numbers(
                torch, ka, *(a[0].detach(), *a[1:], None, 0)[:5])),
            ("sweep_bwd", cap_kc, lambda a: bwd_numbers(torch, kc, *a[:7]))):
        form = cap.counts.most_common(1)[0][0]
        entries.append(dict({
            "name": f"{name} [loaders]", "route": "cuda",
            "source": f"directvoxgo_tpu_torch/csrc/{name}.cu",
            "replaces": ("directvoxgo_tpu/ops/pallas_sweep_train.py:85"
                         if name == "sweep_fwd" else
                         "directvoxgo_tpu/ops/pallas_sweep_train.py:247"),
            "launches": launches[name],
            "launches_by_form": dict(cap.counts),
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith(name))},
            **numbers(cap.forms[form][0])))
    if "frame" in caps:
        (args, kw) = caps["frame"]
        f = dict(zip(("d_geo", "d_k0", "vd_emb", "dnorm", "dclip", "ur",
                      "vr", "layers", "scalars", "activity"), args), **kw)
        stats = {}
        kb.render_frame_plain(**f, stats=stats)
        err_b = hold_frame(torch, kb, f, "phase 11 test view")
        nums_b = frame_numbers(torch, kb, f, 10)
        plain_b = cuda_time(lambda: kb.render_frame_plain(**f), 3, warmup=1)
        bound_b, by_b, _, _, _ = frame_bound(f, stats)
        hi, wi = f["dnorm"].shape
        entries.append(dict({
            "name": "render_frame [loaders]", "route": "cuda",
            "source": "directvoxgo_tpu_torch/csrc/render_frame.cu",
            "replaces": "directvoxgo_tpu/ops/pallas_render4.py:74",
            "launches": launches["render_frame"], "max_abs_err": err_b},
            **nums_b, **{"plain_ms": plain_b, "bound_ms": bound_b,
                         "bound_by": by_b, "library_ms": None,
                         "shape": f"test view, intermediate {hi}x{wi}, "
                                  f"S={f['d_geo'].shape[0]}, "
                                  f"{stats['visible_samples']} visible "
                                  "samples"}))
    if not launches["render_frame"]:
        raise AssertionError("phase 11: K-B rendered no test view")
    summary["launches"] = launches
    summary["seconds"] = time.time() - t_phase
    log(f"[phase 11] done in {summary['seconds']:.1f} s; launches "
        f"{launches}")
    return entries, summary


def frame_bound(f, stats):
    """K-B's bound on the frame ``f`` (``render_frame``'s keyword
    arguments), from its plain version's ``stats``: (ms, "bytes" or
    "operations", bytes, MLP operations, f32 geometry operations). Bytes:
    the slab voxels the live and visible samples read, the view input of
    the visible pixels (the embedding, or ``shared1`` in the v3 and v1
    forms), the per-pixel inputs of the live pixels, the weights and the
    outputs once. Operations: the MLP of the visible samples at the bf16
    rate (with the embedding's layer-1 half per visible pixel in the v4
    form) and ~40 f32 operations per live sample."""
    hi, wi = f["dnorm"].shape
    layers = f["layers"]
    width = layers[1][0].shape[0]
    if f.get("shared1") is None:
        view = f["vd_emb"].shape[-1]
        f_mlp = layers[0][0].shape[0] - view
        view_flops = stats["visible_pixels"] * view * width
    else:
        view, f_mlp, view_flops = width, layers[0][0].shape[0], 0
    f_k0 = f["d_k0"].shape[-1]
    n_bytes = (stats["geo_voxels"] * 2 * 2                 # density, mask
               + stats["k0_voxels"] * f_k0 * 2
               + stats["visible_pixels"] * view * 2        # vd_emb / shared1
               + stats["live_pixels"] * 2 * 4              # dnorm, dclip
               + (hi + wi) * 4 + f["activity"].numel() * 4
               + sum(w.numel() * 2 + (0 if b is None else b.numel() * 4)
                     for w, b in layers)
               + hi * wi * 5 * 4)                          # rgb, depth, T
    mlp_flops = 2 * (stats["visible_samples"] * (f_mlp * width
                                                 + width * width + 3 * width)
                     + view_flops)
    geo_flops = stats["live_samples"] * 40
    t_ops = mlp_flops / BF16_FLOPS + geo_flops / F32_FLOPS
    return (max(n_bytes / HBM_BPS, t_ops) * 1e3,
            "bytes" if n_bytes / HBM_BPS >= t_ops else "operations",
            n_bytes, mlp_flops, geo_flops)


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


# ---------------------------------------------------------------- phase 12

# Phase 5's graph-check inputs (train_phase fills it): name -> (model,
# make_train_step's args and kwargs, pool, sels [n, N], offs [n, ...]).
DP_INPUTS = {}
DP_DIR = os.path.join(CKPT_DIR, "data_parallel")
DP_STEPS = 4            # train steps of each two-rank case
DP_WORLD = 2
# tests/test_parallel.py's bars: loss (absolute), parameters rtol / atol.
DP_LOSS_TOL, DP_RTOL, DP_ATOL = 1e-5, 1e-2, 5e-4
SCAN_MIN_PSNR, SCAN_DEPTH_TOL = 55.0, 1e-2   # tests/test_render_sweep.py
WATCHDOG_S = 2
# Clock cycles of the spinning kernel the watchdog's child pulls behind
# (10 s at 2 GHz: the watchdog ends the child within two scans).
WATCHDOG_SPIN_CYCLES = 20_000_000_000


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# phase 12 (a): parameter elements in which the data-parallel run differs
# from the nearest plain run, in units of those in which two plain runs
# differ. A count, not a size: the f32 atomics' order flips a bf16 rounding
# of a few voxels' gradients (4-80 of 4-53 M elements on the card), and
# Adam turns each flip into a jump of up to ~5e-4, in one run and not the
# next (one pair's largest difference was 23x another's); a
# fault of the data-parallel step (a rounding lost) moves most elements.
DP_FLOOR_FACTOR = 3.0


def dp_nccl_checks(torch, dev, ka, kc):
    """(a) An NCCL group of one rank on the card: its all-reduce, captured
    in a CUDA graph, returns its input bit for bit; phase 5's 8-step
    coarse chunk and top-grid fine window steps through the data-parallel
    step (graphed, the all-reduce captured) against the same steps without
    a group, from one state, run three times (K-C sums with f32 atomics,
    so plain runs differ from each other: their spread is the noise
    floor). The data-parallel run's loss and PSNR must equal one plain
    run's bit for bit on every step, and the parameter elements in which
    it differs from the nearest plain run must be no more than
    ``DP_FLOOR_FACTOR`` times those in which two plain runs differ (at
    least 1). Returns
    (summary, K-A and K-C launches of the data-parallel runs, their last
    eager K-A and K-C inputs)."""
    import copy
    import numpy as np
    from directvoxgo_tpu_torch.engine import graphs as graphs_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    from directvoxgo_tpu_torch.parallel import all_reduce_mean, make_mesh
    t0 = time.time()
    mesh = make_mesh(dev, backend="nccl", world_size=1, rank=0,
                     init_method=f"tcp://localhost:{_free_port()}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 12)
    x = torch.randn(1 << 22, generator=gen).to(dev)
    buf = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        all_reduce_mean(mesh, [buf])
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = all_reduce_mean(mesh, [buf])[0]
    buf.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    reduce_bitwise = bool(torch.equal(out, x))
    log(f"[phase 12] (a) NCCL group of 1 in {time.time() - t0:.1f} s; "
        f"captured all-reduce returns its input bit for bit: "
        f"{reduce_bitwise}")
    if not reduce_bitwise:
        raise AssertionError("a one-rank NCCL all-reduce changed its input")

    out = {"captured_all_reduce_bitwise": reduce_bitwise}
    launches = {"sweep_fwd": 0, "sweep_bwd": 0}
    cap_a = cap_c = None
    for name, (model, args, kw, pool, sels, offs) in DP_INPUTS.items():
        key = (kw["axis"], kw.get("clip_sizes"))
        n = sels.shape[0]
        runs = {}
        for label, group in (("plain", None), ("data parallel", mesh),
                             ("plain again", None), ("plain third", None)):
            m, opt = copy.deepcopy((model, args[0]))
            step = train_lib.make_train_step(m, opt, *args[1:],
                                             **dict(kw, group=group))
            sg = graphs_lib.StepGraphs(dev)
            sg.reset(scratch=(np_prod(m.world_size), 2 + m.k0_dim))
            if group is not None:
                ka.launches = kc.launches = 0
                cap_a = Capture(sweep_ops, "sweep_fwd", keep=1)
                cap_c = Capture(sweep_ops, "sweep_bwd", keep=1)
            try:
                res = sg.run(key, step, pool, sels, offs).cpu().numpy()
                torch.cuda.synchronize()
            finally:
                if group is not None:
                    cap_c.restore()
                    cap_a.restore()
            if group is not None:
                launches["sweep_fwd"] += ka.launches
                launches["sweep_bwd"] += kc.launches
                n_kernel = ka.launches
            runs[label] = (m, step, sg, res)
        md, _, sgd, rd = runs["data parallel"]
        plains = [runs[k] for k in ("plain", "plain again", "plain third")]

        def par_diff(ma_, mb_):
            """(largest difference, parameter elements not bit for bit
            equal) of two runs' models"""
            pairs = list(zip(ma_.parameters(), mb_.parameters()))
            return (max(float((p - q).detach().abs().max())
                        for p, q in pairs),
                    sum(int((p != q).sum()) for p, q in pairs))

        # loss and PSNR of every step against each plain run
        steps_bitwise = [np.array_equal(rd, r) for _, _, _, r in plains]
        lead = 0
        while lead < n and np.array_equal(rd[lead], plains[0][3][lead]):
            lead += 1
        dpar = [par_diff(md, m) for m, _, _, _ in plains]
        floor = [par_diff(a[0], b[0]) for i, a in enumerate(plains)
                 for b in plains[i + 1:]]
        floor_par = max(f[0] for f in floor)
        floor_off = max(f[1] for f in floor)
        floor_loss = max(float(np.abs(a[3] - b[3]).max())
                         for i, a in enumerate(plains) for b in plains[i + 1:])
        ok = (np.isfinite(rd).all() and any(steps_bitwise)
              and dict(sgd.stats) == {"eager": 1, "capture": 1,
                                      "replay": n - 2}
              and n_kernel == n
              and min(d[1] for d in dpar)
              <= DP_FLOOR_FACTOR * max(floor_off, 1))
        # wall ms per step of more chunks, replays only, in turns (plain,
        # data parallel, data parallel, plain): the lower of each's two
        timed = {"plain": [], "data parallel": []}
        for label in ("plain", "data parallel", "data parallel", "plain"):
            m, step, sg, _ = runs[label]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sg.run(key, step, pool, sels, offs)
            torch.cuda.synchronize()
            timed[label].append((time.perf_counter() - t1) * 1e3 / n)
        timed = {k: min(v) for k, v in timed.items()}
        out[name] = {
            "key": str(key), "steps": n, "runs": dict(sgd.stats),
            "steps_bitwise_with_plain_runs": steps_bitwise,
            "bitwise_leading_steps_first_plain": lead,
            "param_diff_to_plain_runs": [d[0] for d in dpar],
            "params_off_to_plain_runs": [d[1] for d in dpar],
            "noise_floor_loss_diff": floor_loss,
            "noise_floor_param_diff": floor_par,
            "noise_floor_params_off": floor_off,
            "plain_ms_per_step": timed["plain"],
            "dp_ms_per_step": timed["data parallel"]}
        log(f"[phase 12] (a) {name}: {out[name]}")
        if not ok:
            raise AssertionError(
                f"(a) {name}: data-parallel steps of one NCCL rank differ "
                f"from plain ones: {out[name]}, K-A launches {n_kernel}")
        del runs
    import torch.distributed as dist
    dist.destroy_process_group()
    return out, launches, (cap_a.calls[-1][0], cap_c.calls[-1][0])


def dp_case_run(torch, case, dev, group):
    """A two-rank case's steps on ``dev`` (``group``: the rank's DataMesh,
    or None for one rank): losses, PSNRs, the kernels' launches and the
    parameters after (numpy, the JAX layout)."""
    from directvoxgo_tpu_torch import convert
    from directvoxgo_tpu_torch.config import ConfigDict
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    from directvoxgo_tpu_torch.ops import sweep_bwd as kc
    from directvoxgo_tpu_torch.ops import sweep_fwd as ka
    from directvoxgo_tpu_torch.ops import train_fused as tf
    model = ckpt_lib.load_model(DirectVoxGO, case["ckpt"], device=dev)
    cfg = ConfigDict(case["cfg"])
    opt = train_lib.create_optimizer_or_freeze_model(model, cfg)
    step = train_lib.make_train_step(model, opt, cfg, case["rk"],
                                     *case["tv"], axis=case["axis"],
                                     clip_sizes=case["clip_sizes"],
                                     group=group)
    pool = {k: torch.as_tensor(v, device=dev) for k, v in
            case["pool"].items()}
    ka.launches = kc.launches = tf.launches_fwd = tf.launches_bwd = 0
    losses, psnrs = [], []
    for sel, off in zip(case["sels"], case["offs"]):
        loss, psnr_ = step(pool, torch.as_tensor(sel, device=dev), off)
        losses.append(float(loss))
        psnrs.append(float(psnr_))
    return {"loss": losses, "psnr": psnrs,
            "launches": {"sweep_fwd": ka.launches, "sweep_bwd": kc.launches,
                         "train_fused_fwd": tf.launches_fwd,
                         "train_fused_bwd": tf.launches_bwd},
            "params": convert.params_to_jax(model)[0]}


def dp_rank_main(rank, world, workdir, port, device="cuda:0"):
    """A spawned rank of (b): gloo, tensors on ``device`` (the card);
    every case of ``workdir/cases.pt``; outputs to
    ``workdir/rank<rank>.pt``, or the error to ``workdir/rank<rank>.err``."""
    import torch
    from directvoxgo_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    try:
        mesh = make_mesh(dev, backend="gloo", world_size=world, rank=rank,
                         init_method=f"tcp://localhost:{port}")
        cases = torch.load(os.path.join(workdir, "cases.pt"),
                           weights_only=False)
        out = {name: dp_case_run(torch, case, dev, mesh)
               for name, case in cases.items()}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dp_gloo_cases(torch, dev):
    """(b)'s cases from phase 5's fine window steps at the top grid: the
    model (saved as a checkpoint), ``DP_STEPS`` of its batches (their rays
    as a pool of their own) as window steps and as gather steps (the same
    model with ``query_mode='gather'``), and one fused step over a class of
    direction-uniform 512-ray tiles of the axis group."""
    import numpy as np
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    from directvoxgo_tpu_torch.ops import train_fused as tf
    model, args, kw, pool, sels, offs = DP_INPUTS["lego fine window"]
    cfg, rk = dict(args[1]), dict(args[2])
    n_rand = int(cfg["N_rand"])
    os.makedirs(DP_DIR, exist_ok=True)
    sweep_ckpt = os.path.join(DP_DIR, "fine.tar")
    ckpt_lib.save_model_checkpoint(sweep_ckpt, model, 0)
    st = ckpt_lib.load_checkpoint_file(sweep_ckpt)
    st["model_kwargs"]["query_mode"] = "gather"
    gather_ckpt = os.path.join(DP_DIR, "fine_gather.tar")
    ckpt_lib.save_checkpoint_file(gather_ckpt, st)

    sels = np.asarray(sels[:DP_STEPS])
    idx = torch.as_tensor(sels.reshape(-1), device=pool["rgb"].device)
    sub = {k: v[idx].cpu().numpy() for k, v in pool.items()}
    local = np.arange(sels.size).reshape(sels.shape)
    tv = (args[3], args[4])
    cases = {
        "window": {"ckpt": sweep_ckpt, "cfg": cfg, "rk": rk, "tv": tv,
                   "axis": kw["axis"], "clip_sizes": kw["clip_sizes"],
                   "pool": sub, "sels": local,
                   "offs": np.asarray(offs[:DP_STEPS], np.int32)},
        "gather": {"ckpt": gather_ckpt, "cfg": cfg, "rk": rk,
                   "tv": (False, False), "axis": None, "clip_sizes": None,
                   "pool": sub, "sels": local,
                   "offs": np.zeros((DP_STEPS, 3), np.int32)}}

    # one fused step: same-class tiles of the axis group over its clip box
    axis = kw["axis"]
    ro = pool["rays_o"].cpu().numpy()
    rd = pool["rays_d"].cpu().numpy()
    g = np.flatnonzero(sweep_ops.sweep_axes(model, rd) == axis)
    if g.size > 400_000:
        g = np.sort(np.random.default_rng(SEED).choice(g, 400_000,
                                                       replace=False))
    # the engine's rule (Draws.box, Draws._build_fused): the clip box, or
    # the whole grid at zero offsets; the classes the fused step takes
    csz, coff = model.sweep_clip_for_axis(axis)
    box6 = None
    if csz is None:
        csz = tuple(int(model.world_size[a]) for a in sweep_ops._PERMS[axis])
        coff = np.zeros(3, np.int32)
    else:
        box6 = tuple(float(x) for o_, b in zip(coff, csz)
                     for x in (o_, o_ + b - 1))
    bp, bu, bv = (int(x) for x in csz)
    tiles = sweep_ops.build_ray_tiles_blocktile(
        ro[g], rd[g], model.xyz_min, model.xyz_max,
        tuple(int(x) for x in model.world_size), axis, rk["near"],
        rk["far"], rk["stepsize"], nt=tf.NT, clip_box=box6)
    need = n_rand // tf.NT
    fdim = model.k0_dim if model.rgbnet_direct else model.k0_dim - 3
    classes = {k: t for k, t in tiles.items()
               if t.shape[0] >= need and tf.fused_available(
                   n_rand, bu, bv, fdim, int(model.rgbnet_width),
                   float(model.fast_color_thres), int(model.rgbnet_depth),
                   wu=int(k[0]), wv=int(k[1]), device=dev)}
    windowed = {k: t for k, t in classes.items() if k[:2] != (0, 0)}
    pick = windowed or classes
    if not pick:
        raise AssertionError(f"(b) no tile class of {need} tiles: "
                             f"{ {k: t.shape[0] for k, t in tiles.items()} }")
    key = max(pick, key=lambda k: pick[k].shape[0])
    fsel = g[pick[key][:need].reshape(-1)]
    cases["fused"] = {
        "ckpt": sweep_ckpt, "cfg": cfg, "rk": rk, "tv": (False, False),
        "axis": axis, "clip_sizes": ("fblk", int(key[0]), int(key[1]), bp,
                                     bu, bv),
        "pool": {k: v[torch.as_tensor(fsel, device=v.device)].cpu().numpy()
                 for k, v in pool.items()},
        "sels": np.arange(fsel.size)[None],
        "offs": np.asarray(coff, np.int32)[None]}
    return cases


def _is_gloo_cuda_refusal(text):
    t = text.lower()
    return "gloo" in t and ("cuda" in t or "device type" in t) and (
        "not supported" in t or "unsupported" in t or "invalid" in t)


def dp_gloo_checks(torch, dev):
    """(b) Two spawned gloo ranks share the card, with CUDA tensors, and
    run (b)'s cases; one rank (this process, no group) runs them too.
    Both ranks end bit for bit equal; against one rank at
    ``tests/test_parallel.py``'s bars. A refusal of CUDA tensors by gloo
    is reported as it is."""
    import numpy as np
    t0 = time.time()
    os.makedirs(DP_DIR, exist_ok=True)
    for f in os.listdir(DP_DIR):
        if f.startswith("rank"):
            os.remove(os.path.join(DP_DIR, f))
    old = os.environ.get("DVGO_FUSED_TRAIN")
    os.environ["DVGO_FUSED_TRAIN"] = "force"
    procs = []
    try:
        cases = dp_gloo_cases(torch, dev)
        torch.save(cases, os.path.join(DP_DIR, "cases.pt"))
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.dp_rank_main({r}, {DP_WORLD}, "
             f"{DP_DIR!r}, {port}, {str(dev)!r})"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WORLD)]
        one = {name: dp_case_run(torch, case, dev, None)
               for name, case in cases.items()}
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        if old is None:
            os.environ.pop("DVGO_FUSED_TRAIN")
        else:
            os.environ["DVGO_FUSED_TRAIN"] = old
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [os.path.join(DP_DIR, f"rank{r}.err") for r in range(DP_WORLD)]
    if any(p.returncode for p in procs):
        text = "\n".join(open(e).read() for e in errs if os.path.isfile(e))
        if _is_gloo_cuda_refusal(text):
            log(f"[phase 12] (b) gloo refuses CUDA tensors: {text[-2000:]}")
            return {"refused": text.strip().splitlines()[-1]}
        raise AssertionError("(b) a gloo rank failed:\n"
                             + "\n".join(x[-3000:] for x in logs))
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    out = {"seconds": time.time() - t0}
    for name in cases:
        a, b, ref = ranks[0][name], ranks[1][name], one[name]
        same = (a["loss"] == b["loss"] and all(
            np.array_equal(x, y) for x, y in zip(_leaves(a["params"]),
                                                 _leaves(b["params"]))))
        d_loss = max(abs(x - y) for x, y in zip(a["loss"], ref["loss"]))
        worst = 0.0    # the largest |diff| / (atol + rtol |ref|)
        for x, y in zip(_leaves(a["params"]), _leaves(ref["params"])):
            worst = max(worst, float(np.max(np.abs(x - y) / (
                DP_ATOL + DP_RTOL * np.abs(y)))))
        out[name] = {"steps": len(a["loss"]), "loss": a["loss"],
                     "one_rank_loss": ref["loss"], "max_loss_diff": d_loss,
                     "param_diff_over_bar": worst, "ranks_bitwise": same,
                     "launches_rank0": a["launches"],
                     "launches_one_rank": ref["launches"]}
        log(f"[phase 12] (b) {name}: {out[name]}")
        kernel = ("train_fused_fwd" if name == "fused" else "sweep_fwd")
        want = len(a["loss"]) if name != "gather" else 0
        if not (same and d_loss < DP_LOSS_TOL and worst <= 1.0
                and np.isfinite(a["loss"]).all()
                and a["launches"][kernel] == want
                and (name != "gather" or not any(a["launches"].values()))):
            raise AssertionError(f"(b) {name}: two gloo ranks against one: "
                                 f"{out[name]}")
    log(f"[phase 12] (b) two gloo ranks on one card: {time.time() - t0:.1f} "
        "s")
    return out


def dp_scan_checks(torch, lego):
    """(c) The 800^2 lego frame through ``backend="scan"`` against K-B's
    frame: rgb PSNR and depth at the JAX package's bars; both timed."""
    import numpy as np
    from directvoxgo_tpu_torch.engine import render_sweep
    from directvoxgo_tpu_torch.ops import render_frame as kb
    args = (lego["model"], lego["H"], lego["W"], lego["K"], lego["c2w"],
            lego["rk"])
    kb.launches = 0
    rgb_k, dep_k = render_sweep.render_frame_sweep(*args)
    rgb_s, dep_s = render_sweep.render_frame_sweep(*args, backend="scan")
    scan_launches = kb.launches - 1
    p = float(-10.0 * np.log10(np.mean((rgb_s - rgb_k) ** 2) + 1e-20))
    d = float(np.abs(dep_s - dep_k).max())
    white = float(-10.0 * np.log10(np.mean((rgb_k - 1.0) ** 2) + 1e-20))

    def frame(backend):
        def go():
            render_sweep.render_frame_sweep(*args, output="device",
                                            backend=backend)
            torch.cuda.synchronize()
        return go

    out = {"psnr_vs_kernel": p, "max_depth_diff": d,
           "kernel_frame_vs_white_psnr": white,
           "kernel_launches_of_scan": scan_launches,
           "scan_ms": host_time(frame("scan"), 3),
           "kernel_ms": host_time(frame("kernel"), 5)}
    log(f"[phase 12] (c) scan frame core at {lego['H']}x{lego['W']}: {out}")
    if not (np.isfinite(rgb_s).all() and p >= SCAN_MIN_PSNR
            and d <= SCAN_DEPTH_TOL and scan_launches == 0 and white < 30):
        raise AssertionError(f"(c) the scan frame disagrees with K-B's: "
                             f"{out}")
    return out


WATCHDOG_CHILD = r"""
import sys, time
import torch
from directvoxgo_tpu_torch.engine import fetchguard
x = torch.ones(1 << 20, device="cuda")
torch.cuda.synchronize()
if sys.argv[1] == "spin":
    torch.cuda._sleep(int(sys.argv[2]))       # the stream spins ...
    with fetchguard.guarded("pull behind a spinning kernel"):
        float(x.sum())                        # ... and the pull waits
elif sys.argv[1] == "sleep":
    with fetchguard.guarded("sleep inside the guard"):
        time.sleep(60)
else:
    with fetchguard.guarded("quick pull"):
        float(x.sum())
    time.sleep(fetchguard.SCAN_S + 1.0)
print("finished")
"""


def dp_watchdog_checks(torch):
    """(d) Children with ``DVGO_FETCH_WATCHDOG=2``: a pull behind a
    spinning kernel and a sleep inside the guard each end with exit 17; a
    guard that finishes inside its deadline does not."""
    env = dict(os.environ, DVGO_FETCH_WATCHDOG=str(WATCHDOG_S),
               PYTHONPATH=REPO)
    out = {}
    for what, want in (("spin", 17), ("sleep", 17), ("quick", 0)):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", WATCHDOG_CHILD, what,
             str(WATCHDOG_SPIN_CYCLES)], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        out[what] = {"exit": proc.returncode,
                     "seconds": time.time() - t0}
        log(f"[phase 12] (d) watchdog child '{what}': exit "
            f"{proc.returncode} in {out[what]['seconds']:.1f} s; "
            f"{proc.stderr.strip()[-300:]}")
        if proc.returncode != want or (want == 0
                                       and "finished" not in proc.stdout):
            raise AssertionError(f"(d) watchdog child '{what}' exited "
                                 f"{proc.returncode}, not {want}")
    return out


def dp_phase(torch, dev, ka, kc, lego):
    """Phase 12: (a) data-parallel steps of one NCCL rank, graphed, against
    plain ones; (b) two gloo ranks on the card against one rank; (c) the
    scan frame core against K-B; (d) the watchdog. Returns the
    ``[data parallel]`` entries of K-A and K-C (launches of (a)'s
    data-parallel runs, checked and timed on their last eager inputs) and
    the summary."""
    t0 = time.time()
    summary = {}
    summary["nccl_one_rank"], launches, (a_in, c_in) = dp_nccl_checks(
        torch, dev, ka, kc)
    summary["gloo_two_ranks"] = dp_gloo_checks(torch, dev)
    summary["scan_frame"] = dp_scan_checks(torch, lego)
    summary["watchdog"] = dp_watchdog_checks(torch)
    slabs, rays, k, v_base, wv = a_in
    err_a = check_sweep_rel(ka, slabs, rays, k, v_base, wv,
                            "data parallel")
    nums_a = fwd_numbers(torch, ka, slabs, rays, k, v_base, wv)
    g, c_rays, c_k, shape, dtype, c_vb, c_wv = c_in
    err_c = check_bwd(kc, g, c_rays, c_k, shape, dtype, c_vb, c_wv,
                      "data parallel")
    nums_c = bwd_numbers(torch, kc, g, c_rays, c_k, shape, dtype, c_vb, c_wv)
    entries = [
        dict({"name": "sweep_fwd [data parallel]", "route": "cuda",
              "source": "directvoxgo_tpu_torch/csrc/sweep_fwd.cu",
              "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:85",
              "launches": launches["sweep_fwd"], "max_abs_err": err_a,
              "launches_of": "phase 12 (a): data-parallel steps of one "
                             "NCCL rank, replayed as CUDA graphs"},
             **nums_a),
        dict({"name": "sweep_bwd [data parallel]", "route": "cuda",
              "source": "directvoxgo_tpu_torch/csrc/sweep_bwd.cu",
              "replaces": "directvoxgo_tpu/ops/pallas_sweep_train.py:247 "
                          "(fold_bwd_partials :356)",
              "launches": launches["sweep_bwd"], "max_abs_err": err_c,
              "launches_of": "phase 12 (a): data-parallel steps of one "
                             "NCCL rank, replayed as CUDA graphs"},
             **nums_c)]
    summary["seconds"] = time.time() - t0
    log(f"[phase 12] done in {summary['seconds']:.1f} s")
    return entries, summary


def lego_frame(torch, dev, ckpt):
    """The 800^2 frame of an accepted lego test view, as phase 4 renders
    it: {"model", "H", "W", "K", "c2w", "rk"}."""
    from directvoxgo_tpu_torch.config import Config
    from directvoxgo_tpu_torch.data import load_everything
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
    from directvoxgo_tpu_torch.engine import render_sweep
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
    cfg = Config.fromfile(CONFIG)
    data = load_everything(None, cfg)
    model = ckpt_lib.load_model(DirectVoxGO, ckpt, device=dev)
    v = next(int(i) for i in data["i_test"] if render_sweep.plan_camera_sweep(
        model, 400, 400, data["Ks"][i], data["poses"][i], data["near"],
        data["far"]) is not None)
    K2 = data["Ks"][v].copy()
    K2[:2, :3] *= 2.0
    rk = {"near": data["near"], "far": data["far"], "bg": 1.0,
          "stepsize": cfg.fine_model_and_render.stepsize, "inverse_y": False}
    return {"model": model, "H": 800, "W": 800, "K": K2,
            "c2w": data["poses"][v], "rk": rk}


def phase12_alone():
    """Phase 12 on its own (with phase 5, whose steps it reuses, and the
    builds and checkpoint it needs): ``python3 -c "import chip_smoke;
    chip_smoke.phase12_alone()"``. Prints the phase's JSON summary."""
    import torch
    from directvoxgo_tpu_torch.ops import _build
    from directvoxgo_tpu_torch.ops import render_frame as kb
    from directvoxgo_tpu_torch.ops import sweep as sweep_ops
    from directvoxgo_tpu_torch.ops import sweep_bwd as kc
    from directvoxgo_tpu_torch.ops import sweep_fwd as ka
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(REPO)
    dev = torch.device("cuda", 0)
    logs = _build.build_all(_build.KERNELS + PREV_KERNELS)
    USAGE.update(ptxas_usage(logs))
    ckpt = build_checkpoint(torch, dev)
    train_phase(torch, dev, ka, kb, kc, sweep_ops)
    entries, summary = dp_phase(torch, dev, ka, kc,
                                lego_frame(torch, dev, ckpt))
    print(json.dumps({"kernels": entries, "data_parallel": summary}))


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
        kernels, training = run(torch.device("cuda", 0))
    except Exception:  # report the failed phase, print no result
        traceback.print_exc()
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": kernels, "training": training}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
