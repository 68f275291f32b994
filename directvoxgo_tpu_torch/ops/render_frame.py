"""Kernel K-B: the fused whole-frame renderer (``csrc/render_frame.cu``).

One intermediate-image frame of the camera sweep (``engine/render_sweep``):
every pixel (i, j) of the intermediate image is one ray through the camera
centre, and station s of the march lands on the slab at
``u = ou + lam*(ur[i] - ou)``, ``v = ov + lam*(vr[j] - ov)`` with
``lam = (p_s - op) * inv_span``. Per pixel and station, front to back:

  * density and mask by a bilinear hat-weight warp of the station slab
    (``t1 = au . D`` rounded to bf16, then ``. av``);
  * ``alpha = 1 - exp(-softplus(density + act_shift) * interval)`` (the
    ``1-exp`` form of the frame kernels, not ``-expm1``);
  * the gate ``near <= lam*dclip <= far``, ``mask > 0``,
    ``alpha > fast_thres`` and ``T >= 1e-3``; ``w = T*alpha``;
  * where ``w > 0``: the k0 features (``av`` first, rounded to bf16, then
    ``au``), the 3-layer colour MLP in bf16 with f32 accumulation (the view
    half of layer 1 kept in f32) and ``rgb += w*sigmoid(logit)``;
  * ``T *= 1 - alpha + 1e-10``.

Station-block/tile pairs that ``activity`` marks empty, and stations after a
tile's every ray has ``T < 1e-3``, change nothing and may be skipped.

Three forms, one per fused frame kernel of the JAX package, each its exact
function: ``v4`` (``render_frame_pallas4``, the default: the view half of
layer 1 computed in f32 from the view embedding), ``v3``
(``render_frame_pallas3``: that half is a bf16 input ``shared1``) and
``v1`` (``render_frame_pallas``: ``shared1`` and the k0 features contracted
``au`` first). :func:`render_frame_v3` and :func:`render_frame_v1` take the
v3 and v1 kernels' own layouts.

``render_frame`` launches the kernel for CUDA tensors (or raises) and runs
:func:`render_frame_plain`, the same arithmetic in plain PyTorch, for CPU
tensors. The kernel runs the MLP on the tensor cores (bf16 operands, f32
accumulation, the Pallas kernels' arithmetic in another summation order),
from weights packed once by :func:`pack_mlp_mma`; :func:`queue_stats`
reads its sample-queue counters.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .raymarch import T_EPS, T_TERMINATE

# Intermediate-image tile of the activity table and stations per activity
# block; the intermediate image and the station count are padded to them
# (engine/render_sweep.py).
TILE = 128
S_BLK = 16
# Stations per grid step of the v1 kernel: its station count is a multiple.
V1_S_BLK = 8
BF16 = torch.bfloat16
K0_ORDERS = ("v_first", "u_first")

launches = 0
launches_by_form = {"v4": 0, "v3": 0, "v1": 0}


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("render_frame")
    lib.dvgo_render_frame.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_float] * 12
        + [ctypes.c_void_p])
    lib.dvgo_render_frame.restype = ctypes.c_int
    for name in ("dvgo_render_frame_max_features",
                 "dvgo_render_frame_max_emb"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.dvgo_render_frame_queue_stats.argtypes = [ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.dvgo_render_frame_queue_stats.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def queue_stats(enable):
    """The kernel's sample-queue counters since the last call (flushes,
    queued samples, 16-row MMA tiles, and the mean fill of each), then
    zeroed; counting is on from here while ``enable``. Synchronises the
    device. Off by default (the count costs one atomic per flush)."""
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 3)()
    lib = _lib()
    err = lib.dvgo_render_frame_queue_stats(int(bool(enable)), buf)
    if err:
        raise RuntimeError("render_frame queue stats: "
                           + lib.dvgo_error_string(err).decode())
    flushes, rows, tiles = buf
    return {"flushes": flushes, "samples": rows, "tiles": tiles,
            "samples_per_flush": rows / flushes if flushes else None,
            "tile_fill": rows / (16 * tiles) if tiles else None}


def _rnd(x):
    """Round f32 values to bf16 and back."""
    return x.to(BF16).float()


def _hat_taps(x, g):
    """Two hat-function taps of coordinates ``x`` on a ``g``-long axis:
    (index0, index1, weight0, weight1, valid0, valid1), weights rounded to
    bf16 and zero where the index falls outside the axis."""
    i0 = torch.floor(x)
    i1 = i0 + 1.0
    w0 = _rnd(torch.clamp(1.0 - (x - i0).abs(), min=0.0))
    w1 = _rnd(torch.clamp(1.0 - (x - i1).abs(), min=0.0))
    ok0 = (i0 >= 0) & (i0 <= g - 1)
    ok1 = (i1 >= 0) & (i1 <= g - 1)
    w0 = torch.where(ok0, w0, torch.zeros_like(w0))
    w1 = torch.where(ok1, w1, torch.zeros_like(w1))
    i0 = torch.clamp(i0, 0, g - 1).long()
    i1 = torch.clamp(i1, 0, g - 1).long()
    return i0, i1, w0, w1


def _fma(a, b, c):
    """``a*b + c`` rounded once to f32, as a fused multiply-add (the f32
    product is exact in f64, so only the final rounding remains)."""
    return (a.double() * b.double() + c.double()).float()


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def pack_mlp(layers, f_mlp):
    """Flatten a 3-layer colour MLP into the f32 buffer of K-B's first
    version (``csrc/render_frame_first.cu``, the yardstick ``chip_smoke.py``
    times; :func:`pack_mlp_mma` packs the same bf16 weights for the kernel).

    ``layers``: [(w [in, out], b [out])] * 3 with layer 1's input ordered
    (k0 features, view embedding); in the ``shared1`` forms layer 1 is
    ``(w1a [F, W], None)``. Weights are rounded to bf16 (the kernel's
    compute type); biases stay f32. Layout: ``w1a [F, W]``, ``w1bt [W, E4]``
    (the view half transposed, E zero-padded to a multiple of 4; empty for
    ``shared1``), ``b1 [W]`` (zero for ``shared1``, and not read),
    ``b2 [W]``, ``w2t [W, W]`` (transposed), ``w3 [W, 3]``, ``b3 [3]``.
    """
    (w1, b1), (w2, b2), (w3, b3) = layers
    if b1 is None:
        b1 = torch.zeros_like(b2)
    w1bt = _rnd(w1[f_mlp:]).t()
    e_pad = -w1bt.shape[1] % 4
    w1bt = torch.nn.functional.pad(w1bt, (0, e_pad))
    parts = [_rnd(w1[:f_mlp]), w1bt, b1.float(), b2.float(),
             _rnd(w2).t(), _rnd(w3), b3.float()]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


# The tensor-core pack: m16n8k16 B fragments of a [16*kt, 8*nt] bf16 matrix,
# tile by tile (k-tile major), 32 lanes a tile and 4 values a lane: lane
# 4*n + q holds column n at rows 2q, 2q+1, 2q+8, 2q+9 of the tile.
MMA_K, MMA_N = 16, 8
E_TILES = 2         # k-tiles of the view embedding (E <= 32)


def _mma_fragments(w, k_tiles, n_tiles):
    """``w [K, N]`` rounded to bf16, zero-padded to ``[16*k_tiles,
    8*n_tiles]`` and laid out as the kernel's B fragments (flat bf16)."""
    wp = torch.zeros((MMA_K * k_tiles, MMA_N * n_tiles), dtype=torch.float32,
                     device=w.device)
    wp[:w.shape[0], :w.shape[1]] = _rnd(w)
    t = wp.reshape(k_tiles, 2, 4, 2, n_tiles, MMA_N)  # (kt, hi, q, e, nt, n)
    return t.permute(0, 4, 5, 2, 1, 3).reshape(-1).to(BF16)


def pack_mlp_mma(layers, f_mlp):
    """Flatten a 3-layer colour MLP into the tensor-core kernel's buffer
    (f32 words): ``b1 [W]`` (zero for ``shared1``), ``b2 [W]``, ``b3``
    padded to 8, then the bf16 B fragments (two per word) of ``w1a`` (K =
    F_mlp padded to 16), of the view half ``w1b`` (K = E padded to 32;
    absent for ``shared1``), of ``w2 [W, W]`` and of ``w3`` (N = 3 padded
    to 8). Weights are rounded to bf16 as :func:`pack_mlp` rounds them;
    biases stay f32. W is a multiple of 32."""
    (w1, b1), (w2, b2), (w3, b3) = layers
    width = w2.shape[0]
    if width % 32 or f_mlp > MMA_K:
        raise ValueError(f"pack_mlp_mma: width {width} (a multiple of 32) "
                         f"and {f_mlp} features (at most {MMA_K})")
    if b1 is None:
        b1 = torch.zeros_like(b2)
    nt, kt = width // MMA_N, width // MMA_K
    frags = [_mma_fragments(w1[:f_mlp], 1, nt)]
    if w1.shape[0] > f_mlp:
        if w1.shape[0] - f_mlp > MMA_K * E_TILES:
            raise ValueError("pack_mlp_mma: view embedding wider than "
                             f"{MMA_K * E_TILES}")
        frags.append(_mma_fragments(w1[f_mlp:], E_TILES, nt))
    frags += [_mma_fragments(w2, kt, nt), _mma_fragments(w3, kt, 1)]
    b3p = torch.nn.functional.pad(b3.float(), (0, MMA_N - b3.shape[0]))
    return torch.cat([b1.float(), b2.float(), b3p,
                      torch.cat(frags).view(torch.float32)]).contiguous()


_packed = None  # (key, layers, buffer) of the last MLP packed


def _packed_mlp(layers, f_mlp):
    """:func:`pack_mlp_mma`, reusing the last buffer while the same weights
    come again unmodified (same storage and in-place version), as they do
    frame after frame. The entry holds the layers, so their storage stays
    put."""
    global _packed
    key = (f_mlp,) + tuple(
        (x.device, x.dtype, x.data_ptr(), x._version, tuple(x.shape),
         x.stride()) for wb in layers for x in wb if x is not None)
    if _packed is None or _packed[0] != key:
        _packed = (key, layers, pack_mlp_mma(layers, f_mlp))
    return _packed[2]


def _tap_matrix(i0, i1, w0, w1, g):
    """[n, g] 0/1 matrix of the slab indices each coordinate reads with a
    nonzero weight."""
    m = torch.zeros((i0.shape[0], g), dtype=torch.float32, device=i0.device)
    rows = torch.arange(i0.shape[0], device=i0.device)
    m[rows, i0] += (w0 > 0).float()
    m[rows, i1] += (w1 > 0).float()
    return (m > 0).float()


def _form(shared1, k0_order):
    """The JAX frame kernel whose function this call computes."""
    if k0_order == "u_first":
        return "v1"
    return "v4" if shared1 is None else "v3"


def _check_form(has_mlp, d_k0, layers, vd_emb, shared1, k0_order):
    if k0_order not in K0_ORDERS:
        raise ValueError(f"render_frame: k0_order {k0_order!r}")
    if has_mlp and (d_k0 is None or layers is None
                    or (vd_emb is None) == (shared1 is None)):
        raise ValueError("render_frame: has_mlp needs d_k0, layers and "
                         "exactly one of vd_emb and shared1")
    if has_mlp and len(layers) != 3:
        raise ValueError(f"render_frame: the kernel runs a 3-layer MLP, "
                         f"got {len(layers)} layers")
    if has_mlp and k0_order == "u_first" and shared1 is None:
        raise ValueError("render_frame: the u-first (v1) form takes "
                         "shared1, not vd_emb")


def render_frame_plain(d_geo, d_k0, vd_emb, dnorm, dclip, ur, vr, layers,
                       scalars, activity, *, has_mlp, rgb_mode, shared1=None,
                       k0_order="v_first", stats=None):
    """Plain version of the kernel (station loop over whole-frame tensors).

    Arguments as :func:`render_frame`. Rounds where the TPU frame kernels
    round: hat rows and warp intermediates in bf16, MLP operands in bf16,
    sums in f32, the view half of layer 1 in f32 (``shared1``: the bf16
    input widened). ``stats``, when a dict,
    receives what this frame's data needs, for the kernel's bound:
    ``visible_samples`` (the (pixel, station) pairs with w > 0, each of
    which runs the colour MLP), ``live_samples`` (pairs in active blocks,
    not yet terminated, inside near/far: the warps that decide anything),
    ``geo_voxels`` and ``k0_voxels`` (distinct slab voxels that the live
    and the visible samples read), ``live_pixels`` and ``visible_pixels``
    (pixels with any such sample).
    """
    (op, ou, ov, inv_span, p_first, p_step, act_shift, interval_scale,
     fast_thres, near, far, bg) = [float(x) for x in scalars]
    dev = dnorm.device
    s_total, gu, gv, _ = d_geo.shape
    hi, wi = dnorm.shape
    f32 = torch.float32
    c0 = 3 if rgb_mode == "logit_plus_k0" else 0
    geo = d_geo.float()
    k0 = d_k0.float() if d_k0 is not None else None
    f = lambda x: torch.tensor(x, dtype=f32, device=dev)  # noqa: E731
    op, ou, ov, inv_span = f(op), f(ou), f(ov), f(inv_span)
    p_first, p_step = f(p_first), f(p_step)
    interval = dnorm * f(interval_scale)
    _check_form(has_mlp, d_k0, layers, vd_emb, shared1, k0_order)
    if has_mlp:
        (w1, b1), (w2, b2), (w3, b3) = layers
        if shared1 is None:
            f_mlp = w1.shape[0] - vd_emb.shape[-1]
            sh1 = (vd_emb.float().reshape(hi * wi, -1) @ _rnd(w1[f_mlp:])
                   + b1.float())
        else:
            f_mlp = w1.shape[0]
            sh1 = shared1.float().reshape(hi * wi, -1)
        w1a = _rnd(w1[:f_mlp])
        w2r, w3r = _rnd(w2), _rnd(w3)
    act = activity.bool()
    t_cum = torch.ones((hi, wi), dtype=f32, device=dev)
    rgb = torch.zeros((3, hi, wi), dtype=f32, device=dev)
    depth = torch.zeros((hi, wi), dtype=f32, device=dev)
    n_visible = n_live = geo_voxels = k0_voxels = 0
    any_live = torch.zeros((hi, wi), dtype=torch.bool, device=dev)
    any_vis = torch.zeros((hi, wi), dtype=torch.bool, device=dev)
    for s in range(s_total):
        sb = s // S_BLK
        blk = act[:, :, sb].repeat_interleave(TILE, 0).repeat_interleave(
            TILE, 1)
        p = _fma(p_step, f(float(s)), p_first)
        lam = (p - op) * inv_span
        u = _fma(lam, ur - ou, ou)                             # [Hi]
        v = _fma(lam, vr - ov, ov)                             # [Wi]
        ua, ub, wua, wub = _hat_taps(u, gu)
        va, vb, wva, wvb = _hat_taps(v, gv)
        # u-contraction first (t1 rows per pixel row and tap column), then v
        rows_a, rows_b = geo[s, ua], geo[s, ub]                # [Hi, Gv, 2]
        t1 = (wua[:, None, None] * rows_a + wub[:, None, None] * rows_b)
        t1 = _rnd(t1)
        g = (wva[None, :, None] * t1[:, va] + wvb[None, :, None] * t1[:, vb])
        density, maskv = g[..., 0], g[..., 1]
        alpha = 1.0 - torch.exp(-_softplus(density + act_shift) * interval)
        dist = lam * dnorm
        t_px = lam * dclip
        ok = ((t_px >= near) & (t_px <= far) & (maskv > 0.0)
              & (alpha > fast_thres) & (t_cum >= T_TERMINATE) & blk)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        w = t_cum * a
        if stats is not None:
            live = ((t_px >= near) & (t_px <= far) & (t_cum >= T_TERMINATE)
                    & blk)
            vis = w > 0.0
            tu = _tap_matrix(ua, ub, wua, wub, gu)             # [Hi, Gu]
            tv = _tap_matrix(va, vb, wva, wvb, gv)             # [Wi, Gv]
            geo_voxels += int((tu.t() @ live.float() @ tv > 0).sum())
            k0_voxels += int((tu.t() @ vis.float() @ tv > 0).sum())
            n_live += int(live.sum())
            any_live |= live
            any_vis |= vis
        t_cum = t_cum * (1.0 - a + T_EPS)
        idx = torch.nonzero(w.reshape(-1) > 0.0).squeeze(1)
        n_visible += idx.numel()
        if idx.numel() == 0:
            continue
        pi, pj = idx // wi, idx % wi
        w_sel = w.reshape(-1)[idx]
        if k0 is not None and k0_order == "u_first":
            # u-contraction first, rounded to bf16, then v
            tua = _rnd(wua[pi, None] * k0[s, ua[pi], va[pj]]
                       + wub[pi, None] * k0[s, ub[pi], va[pj]])
            tub = _rnd(wua[pi, None] * k0[s, ua[pi], vb[pj]]
                       + wub[pi, None] * k0[s, ub[pi], vb[pj]])
            cl = wva[pj, None] * tua + wvb[pj, None] * tub      # [M, F]
        elif k0 is not None:
            # v-contraction first, rounded to bf16, then u
            tva = _rnd(wva[pj, None] * k0[s, ua[pi], va[pj]]
                       + wvb[pj, None] * k0[s, ua[pi], vb[pj]])
            tvb = _rnd(wva[pj, None] * k0[s, ub[pi], va[pj]]
                       + wvb[pj, None] * k0[s, ub[pi], vb[pj]])
            cl = wua[pi, None] * tva + wub[pi, None] * tvb      # [M, F]
        if has_mlp:
            h = _rnd(cl[:, c0:]) @ w1a
            h = _rnd(torch.relu(h + sh1[idx]))
            h = _rnd(torch.relu(h @ w2r + b2.float()))
            logit = h @ w3r + b3.float()
            if c0:
                logit = logit + cl[:, :3]
            rgb_s = torch.sigmoid(logit)
        elif k0 is not None:
            rgb_s = torch.sigmoid(cl[:, :3])
        else:
            rgb_s = torch.full((idx.numel(), 3), 0.5, dtype=f32, device=dev)
        rgb.view(3, -1)[:, idx] += (w_sel[:, None] * rgb_s).t()
        depth.view(-1)[idx] += w_sel * dist.reshape(-1)[idx]
    if stats is not None:
        stats.update(visible_samples=n_visible, live_samples=n_live,
                     geo_voxels=geo_voxels, k0_voxels=k0_voxels,
                     live_pixels=int(any_live.sum()),
                     visible_pixels=int(any_vis.sum()))
    rgb = rgb + t_cum[None] * bg
    return rgb, depth, t_cum


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"render_frame: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"render_frame: {name} has dtype {x.dtype}, "
                        f"expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"render_frame: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"render_frame: {name} must be contiguous")


def render_frame(d_geo, d_k0, vd_emb, dnorm, dclip, ur, vr, layers,
                 scalars, activity, *, has_mlp, rgb_mode, shared1=None,
                 k0_order="v_first"):
    """Render one intermediate-image frame.

    Args:
      d_geo: [S, Gu, Gv, 2] bf16 station slabs (density, mask) in march
        order, S a multiple of ``S_BLK`` (padding slabs are zero).
      d_k0: [S, Gu, Gv, F] bf16 colour-feature station slabs, or None.
      vd_emb: [Hi, Wi, E] bf16 positional view embedding per pixel, or None
        without an MLP or with ``shared1``.
      dnorm, dclip: [Hi, Wi] f32 world |d| and |d . f_cam| per pixel.
      ur, vr: [Hi], [Wi] f32 reference-plane coordinates; Hi and Wi are
        multiples of ``TILE``.
      layers: [(w [in, out], b [out])] * 3 of the colour MLP (f32), or None;
        with ``shared1``, layer 1 is ``(w1a [F_mlp, W], None)``.
      scalars: 12 floats (op, ou, ov, inv_span, p_first, p_step, act_shift,
        interval_scale, fast_thres, near, far, bg), each an f32 value.
      activity: [Hi/TILE, Wi/TILE, S/S_BLK] int32, 0 where the tile's
        footprint holds no occupied voxel in that station block.
      has_mlp: run the 3-layer MLP (needs ``d_k0``); rgb_mode: "direct" or
        "logit_plus_k0" (features after the first 3 channels feed the MLP
        and the first 3 are added to its logits).
      shared1: [Hi, Wi, W] bf16 hoisted view half of layer 1
        (``vd_emb . W1b + b1``) in place of ``vd_emb`` (the v3 and v1
        forms).
      k0_order: "v_first" (v4, v3) or "u_first" (v1; with an MLP it takes
        ``shared1``).

    Returns (rgb [3, Hi, Wi], depth [Hi, Wi], T [Hi, Wi]) f32.
    """
    global launches
    _check_form(has_mlp, d_k0, layers, vd_emb, shared1, k0_order)
    if rgb_mode not in ("direct", "logit_plus_k0"):
        raise ValueError(f"render_frame: rgb_mode {rgb_mode!r}")
    if dnorm.device.type == "cpu":
        return render_frame_plain(d_geo, d_k0, vd_emb, dnorm, dclip, ur, vr,
                                  layers, scalars, activity, has_mlp=has_mlp,
                                  rgb_mode=rgb_mode, shared1=shared1,
                                  k0_order=k0_order)
    dev = dnorm.device
    if dev.type != "cuda":
        raise ValueError(f"render_frame: unsupported device {dev}")
    s_total, gu, gv, _ = d_geo.shape
    hi, wi = dnorm.shape
    if hi % TILE or wi % TILE or s_total % S_BLK:
        raise ValueError("render_frame: Hi, Wi must be multiples of "
                         f"{TILE} and S of {S_BLK}")
    _check("d_geo", d_geo, BF16, (s_total, gu, gv, 2), dev)
    f_k0 = 0
    if d_k0 is not None:
        f_k0 = d_k0.shape[3]
        _check("d_k0", d_k0, BF16, (s_total, gu, gv, f_k0), dev)
    for name, x in (("dnorm", dnorm), ("dclip", dclip)):
        _check(name, x, torch.float32, (hi, wi), dev)
    _check("ur", ur, torch.float32, (hi,), dev)
    _check("vr", vr, torch.float32, (wi,), dev)
    _check("activity", activity, torch.int32,
           (hi // TILE, wi // TILE, s_total // S_BLK), dev)
    lib = _lib()
    c0 = 3 if rgb_mode == "logit_plus_k0" else 0
    emb_dim = width = 0
    mlp = emb = None
    if has_mlp:
        width = layers[1][0].shape[0]
        if shared1 is None:
            emb_dim = vd_emb.shape[-1]
            _check("vd_emb", vd_emb, BF16, (hi, wi, emb_dim), dev)
            emb = vd_emb
        else:
            _check("shared1", shared1, BF16, (hi, wi, width), dev)
            if shared1.data_ptr() % 4:
                raise ValueError("render_frame: shared1 must be 4-byte "
                                 "aligned (the kernel reads bf16 pairs)")
            emb = shared1
        f_mlp = layers[0][0].shape[0] - emb_dim
        if f_mlp != f_k0 - c0:
            raise ValueError(f"render_frame: MLP takes {f_mlp} features, "
                             f"the slabs give {f_k0 - c0}")
        mlp = _packed_mlp(layers, f_mlp)
    if f_k0 > lib.dvgo_render_frame_max_features() \
            or emb_dim > lib.dvgo_render_frame_max_emb():
        raise ValueError("render_frame: too many k0 or embedding channels "
                         f"({f_k0}, {emb_dim}) for the kernel")
    rgb = torch.empty((3, hi, wi), dtype=torch.float32, device=dev)
    depth = torch.empty((hi, wi), dtype=torch.float32, device=dev)
    tcum = torch.empty((hi, wi), dtype=torch.float32, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    err = lib.dvgo_render_frame(
        ptr(d_geo), ptr(d_k0), ptr(emb), ptr(dnorm), ptr(dclip), ptr(ur),
        ptr(vr), ptr(mlp), ptr(activity), ptr(rgb), ptr(depth), ptr(tcum),
        s_total, gu, gv, hi, wi, f_k0, c0, emb_dim, width, int(has_mlp),
        int(shared1 is not None), int(k0_order == "u_first"),
        *[float(x) for x in scalars],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("render_frame launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    launches_by_form[_form(shared1, k0_order)] += 1
    return rgb, depth, tcum


# ---- The v3 and v1 kernels' own layouts -----------------------------------

def geo_from_channel_major(d_geo):
    """[S, Gu, 2*Gv] geometry slabs, channel-major (density | mask) as the
    JAX frame kernels take them, as K-B's [S, Gu, Gv, 2] (a view)."""
    s, gu, gv2 = d_geo.shape
    return d_geo.reshape(s, gu, 2, gv2 // 2).permute(0, 1, 3, 2)


def _shared1_layers(mlp_params):
    return [(mlp_params["w1a"], None), (mlp_params["w2"], mlp_params["b2"]),
            (mlp_params["w3"], mlp_params["b3"])]


def all_active(hi, wi, s_total, device):
    """An activity table with every (tile, station block) active."""
    return torch.ones((hi // TILE, wi // TILE, s_total // S_BLK),
                      dtype=torch.int32, device=device)


def v3_frame_args(d_geo, d_k0t, shared1, dnorm, dclip, ur, vr, mlp_params,
                  scalars, activity=None, *, guv, has_mlp, rgb_mode):
    """:func:`render_frame`'s keyword arguments for the v3 kernel's inputs
    (``render_frame_pallas3``): channel-major geometry ``[S, Gu, 2*Gv]``,
    colour slabs transposed ``[S, F*Gu, Gv]`` (row ``c*Gu + u``) or None,
    ``shared1 [Hi, Wi, W]`` bf16, ``mlp_params`` {w1a, w2, b2, w3, b3} and
    an optional activity table (None: every block active). The slabs are
    permuted into K-B's layouts (one copy each)."""
    gu, gv = guv
    s_total = d_geo.shape[0]
    hi, wi = dnorm.shape
    if hi % TILE or wi % TILE or s_total % S_BLK:
        raise ValueError(f"render_frame_v3: Hi, Wi must be multiples of "
                         f"{TILE} and S of {S_BLK}")
    if tuple(d_geo.shape) != (s_total, gu, 2 * gv):
        raise ValueError(f"render_frame_v3: d_geo has shape "
                         f"{tuple(d_geo.shape)}, expected "
                         f"{(s_total, gu, 2 * gv)}")
    k0 = None
    if d_k0t is not None:
        f_k0 = d_k0t.shape[1] // gu
        k0 = d_k0t.reshape(s_total, f_k0, gu, gv).permute(0, 2, 3, 1)
        k0 = k0.contiguous()
    if activity is None:
        activity = all_active(hi, wi, s_total, dnorm.device)
    return dict(d_geo=geo_from_channel_major(d_geo).contiguous(), d_k0=k0,
                vd_emb=None, dnorm=dnorm, dclip=dclip, ur=ur, vr=vr,
                layers=_shared1_layers(mlp_params) if has_mlp else None,
                scalars=scalars, activity=activity, has_mlp=has_mlp,
                rgb_mode=rgb_mode, shared1=shared1 if has_mlp else None,
                k0_order="v_first")


def render_frame_v3(d_geo, d_k0t, shared1, dnorm, dclip, ur, vr, mlp_params,
                    scalars, activity=None, *, guv, has_mlp, rgb_mode):
    """The v3 frame kernel's function (``render_frame_pallas3``) in its
    layouts, through K-B's ``shared1`` form (see :func:`v3_frame_args`).
    Returns (rgb [3, Hi, Wi], depth [Hi, Wi], T [Hi, Wi]) f32."""
    return render_frame(**v3_frame_args(
        d_geo, d_k0t, shared1, dnorm, dclip, ur, vr, mlp_params, scalars,
        activity, guv=guv, has_mlp=has_mlp, rgb_mode=rgb_mode))


def v1_frame_args(d_geo, d_k0, shared1, dnorm, dclip, ur, vr, mlp_params,
                  scalars, *, guv, has_mlp, rgb_mode):
    """:func:`render_frame`'s keyword arguments for the v1 kernel's inputs
    (``render_frame_pallas``): channel-major geometry ``[S, Gu, 2*Gv]``,
    colour slabs ``[S, F, Gu, Gv]`` (required), ``shared1 [Hi, Wi, W]``
    bf16 and ``mlp_params`` {w1a, w2, b2, w3, b3}; S a multiple of 8. The
    slabs are permuted into K-B's layouts and padded with zero slabs to a
    multiple of ``S_BLK`` (mask 0 gives alpha 0, and T*(1 - 0 + 1e-10)
    rounds back to T in f32); v1 has no activity table, so every block is
    active."""
    if d_k0 is None:
        raise ValueError("render_frame_v1: d_k0 is required (the v1 kernel "
                         "has no form without a colour grid)")
    gu, gv = guv
    s_total = d_geo.shape[0]
    hi, wi = dnorm.shape
    if hi % TILE or wi % TILE or s_total % V1_S_BLK:
        raise ValueError(f"render_frame_v1: Hi, Wi must be multiples of "
                         f"{TILE} and S of {V1_S_BLK}")
    f_k0 = d_k0.shape[1]
    for name, x, shape in (("d_geo", d_geo, (s_total, gu, 2 * gv)),
                           ("d_k0", d_k0, (s_total, f_k0, gu, gv))):
        if tuple(x.shape) != shape:
            raise ValueError(f"render_frame_v1: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
    s_pad = s_total + (-s_total % S_BLK)
    geo = d_geo.new_zeros((s_pad, gu, gv, 2))
    geo[:s_total] = geo_from_channel_major(d_geo)
    k0 = d_k0.new_zeros((s_pad, gu, gv, f_k0))
    k0[:s_total] = d_k0.permute(0, 2, 3, 1)
    return dict(d_geo=geo, d_k0=k0, vd_emb=None, dnorm=dnorm, dclip=dclip,
                ur=ur, vr=vr,
                layers=_shared1_layers(mlp_params) if has_mlp else None,
                scalars=scalars,
                activity=all_active(hi, wi, s_pad, dnorm.device),
                has_mlp=has_mlp, rgb_mode=rgb_mode,
                shared1=shared1 if has_mlp else None, k0_order="u_first")


def render_frame_v1(d_geo, d_k0, shared1, dnorm, dclip, ur, vr, mlp_params,
                    scalars, *, guv, has_mlp, rgb_mode):
    """The v1 frame kernel's function (``render_frame_pallas``) in its
    layouts, through K-B's ``shared1`` + ``u_first`` form (see
    :func:`v1_frame_args`). Returns (rgb [Hi, Wi, 3], depth [Hi, Wi],
    T [Hi, Wi]) f32."""
    rgb, depth, tcum = render_frame(**v1_frame_args(
        d_geo, d_k0, shared1, dnorm, dclip, ur, vr, mlp_params, scalars,
        guv=guv, has_mlp=has_mlp, rgb_mode=rgb_mode))
    return rgb.permute(1, 2, 0).contiguous(), depth, tcum
