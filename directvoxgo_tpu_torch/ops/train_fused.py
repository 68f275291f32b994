"""Kernels K-D and K-E: the fused fine-stage train step
(``csrc/train_fused_fwd.cu``, ``csrc/train_fused_bwd.cu``).

The unfused step samples every station of every ray into ``[C, N, S]``
(kernel K-A), then composites, selects and shades in separate passes over
``[N, S]``. The fused step keeps that whole per-ray chain inside two
kernels and hands only ``[N]``-sized results to device memory:

* :func:`train_fwd` (K-D): per ray, march the stations, tap the bf16 station
  slabs, ``alpha = 1 - exp(-softplus(density + shift) * interval)``, the
  live-gated transmittance recursion, the ``fast_color_thres`` gates, the
  colour MLP on the samples whose weight passes the gate, and the per-ray
  sums ``rgb_marched``, ``alphainv_last`` and ``rgbper_sum = sum_s w_eff *
  |rgb_s - target|^2``.
* :func:`train_bwd` (K-E): recompute alpha, ``T`` and the gates from the
  same taps, run the MLP forward and backward on the gated samples, carry
  the suffix sum ``R_k = sum_{j>k} dL/dw_j * w_j`` down each ray, and
  scatter the density and feature cotangents onto the permuted grid (the
  (1-f)/f split between the two grid slabs that bracket a station, as
  kernel K-C does), with the MLP's weight gradients and the cotangent of
  the hoisted view term ``sh1``.

No residual is saved between the two: K-E taps the slabs again, so both
see the same alpha, ``T`` and gates bit for bit (the taps are exact bf16
products summed in one order).

Batches are direction-uniform (every ray's ``dp`` has one sign): stations
are visited in march order, station ``ms`` at axis coordinate ``p0 +
pstep * ms``. With ``cfg.wu``/``cfg.wv`` every (``s_blk``-station block,
``nt``-ray tile) cell reads only its own ``(wu, wv)`` window of the slabs
(:func:`blocktile_uv_bases`) and cells without a station inside any of the
tile's ``[t_lo, t_hi]`` are skipped; exact when every cell's support fits
the class, which :func:`..ops.sweep.build_ray_tiles_blocktile` guarantees
for the batches it forms.

On CPU tensors the wrappers run the plain versions (:func:`train_fwd_plain`,
:func:`train_bwd_plain`); on CUDA tensors they launch the kernels or raise.
``DVGO_FUSED_TRAIN`` switches the engine to this step (:func:`fused_enabled`);
it is off by default.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from . import _build
from .raymarch import T_EPS, T_TERMINATE
from .sweep import _round_up, _station_slabs

S_BLK = 8      # stations per march block (the unit of a window cell)
NT = 512       # rays per tile (the unit of a window cell)
F_MAX = 14     # k0 feature channels the MLP's first layer takes, at most
U_ALIGN, V_ALIGN = 16, 8   # alignment of window bases (shared with the
#                            tile sort, which decides the classes)
KERNEL_WIDTHS = (32, 64, 128)   # MLP widths the CUDA kernels are built for
KERNEL_RAYS = 8                 # rays of the CUDA kernels' unit of work (a
#                                 group); must divide ``nt``

# Diagnostic forms of the kernels (a bit mask; 0 is the kernel): without
# the MLP's tensor-core products, without K-E's per-sample global scatters,
# without K-E's reverse walk; their outputs are meaningless. MODE_GATES
# (K-D): the kernel, with pack rows 5-7 set to each ray's count of gated
# samples, sum of (ms + 1) and sum of (ms + 1)^2 over them (march station
# ms), a fingerprint of the gates.
MODE_NO_MLP, MODE_NO_SCATTER, MODE_NO_PHASE2, MODE_GATES = 1, 2, 4, 8

launches_fwd = 0
launches_bwd = 0
# Calls that ran the plain versions (CPU tensors); the engine's tests read
# them to see that fused steps were taken.
plain_calls_fwd = 0
plain_calls_bwd = 0

BF16 = torch.bfloat16


class FusedCfg(NamedTuple):
    """Static configuration of one fused step."""
    k: int                 # stations per voxel along the sweep axis
    f: int                 # k0 feature channels feeding the MLP
    width: int             # MLP hidden width
    act_shift: float
    thres: float           # fast_color_thres (> 0 required)
    bg: float
    direct: bool           # rgbnet_direct: True = sigmoid(logit),
    #                        False = sigmoid(logit + k0[:3])
    wu: int = 0            # per-cell u window (0 = full extent)
    wv: int = 0            # per-cell v window (0 = full extent)
    s_blk: int = S_BLK
    nt: int = NT


def _window_plan(cfg, gu, gv):
    """(gu_p, gv_p, wu_e, wv_e, windowed) of a step over a (gu, gv) plane:
    windows are laid out on the plane padded to the base alignment, and a
    window as wide as the padded plane (or 0) means the full extent."""
    gu_p, gv_p = _round_up(gu, U_ALIGN), _round_up(gv, V_ALIGN)
    wu = cfg.wu if 0 < cfg.wu < gu_p else gu_p
    wv = cfg.wv if 0 < cfg.wv < gv_p else gv_p
    if wu == gu_p and wv == gv_p:
        return gu_p, gv_p, gu, gv, False
    return gu_p, gv_p, wu, wv, True


def march_scalars(s_real, k, s_blk, desc):
    """(s_pad, p0, pstep): march station ``ms`` of ``s_pad`` (the station
    count rounded up to whole blocks) sits at ``p0 + pstep * ms``. A
    descending batch starts at the far end, so its first ``s_pad - s_real``
    march stations lie beyond the last slab and read nothing."""
    s_pad = _round_up(s_real, s_blk)
    inv_k = 1.0 / k
    if desc:
        return s_pad, (s_pad - 1) * inv_k, -inv_k
    return s_pad, 0.0, inv_k


def build_slabs(density_pm, k0_pm, mask_pm, k):
    """Permuted f32 grids [Gp, Gu, Gv(, F)] -> bf16 station slabs
    [S, Gu, Gv, 2 + F], channel-minor (0 density, 1 mask, 2.. k0),
    S = k*(Gp-1)+1."""
    grid4 = torch.cat([density_pm.to(BF16)[..., None],
                       mask_pm.to(BF16)[..., None], k0_pm.to(BF16)], -1)
    return _station_slabs(grid4, k).contiguous()


def mlp_operands(w1, w2, w3, fdim):
    """``nn.Linear`` weights ([out, in]) of the three layers -> the kernels'
    bf16 operands: the k0 part of layer 0 ``w1a [F, W]``, ``w2 [W, W]`` and
    ``w3 [W, 3]`` (all [in, out])."""
    return (w1.t()[:fdim].to(BF16).contiguous(),
            w2.t().to(BF16).contiguous(), w3.t().to(BF16).contiguous())


def blocktile_uv_bases(rays16, p0, pstep, nsb, s_blk, gu_p, gv_p, wu, wv,
                       nt):
    """Per-(march block, ray tile) window cells of the fused kernels.

    March block ``mb`` holds stations ``mb*s_blk .. mb*s_blk + s_blk - 1``
    at axis coordinates ``p0 + pstep*ms``. A ray's in-plane coordinates are
    linear in t, so over the block's t range, clamped to the ray's
    ``[t_lo, t_hi]`` (stations outside it are gated off whatever the
    window), its (u, v) support is bounded by the two end values plus one
    voxel of hat support, clipped to ``[0, G]``.

    Returns ``(uvb [nsb, N//nt, 4] int32, fits [nsb, N//nt, 2] bool)``.
    ``uvb`` rows are (u_base // 16, v_base // 8, active, 0); cells with
    ``active == 0`` have no station of the block inside any ray's
    ``[t_lo, t_hi]`` and are skipped. ``fits`` flags cells whose support
    stays inside the (wu, wv) class.
    """
    n = rays16.shape[1]
    nnb = n // nt
    dev = rays16.device
    op, ou, ov, dp, du, dv, tlo, thi = rays16[:8]
    hit = thi > tlo
    p0 = torch.as_tensor(p0, dtype=torch.float32, device=dev)
    pstep = torch.as_tensor(pstep, dtype=torch.float32, device=dev)
    ms0 = (torch.arange(nsb, dtype=torch.float32, device=dev)
           * s_blk)[:, None]
    ms1 = ms0 + float(s_blk - 1)
    ta = (p0 + pstep * ms0 - op[None]) / dp[None]
    tb = (p0 + pstep * ms1 - op[None]) / dp[None]
    t0 = torch.maximum(torch.minimum(ta, tb), tlo[None])
    t1 = torch.minimum(torch.maximum(ta, tb), thi[None])
    act = (t1 >= t0) & hit[None]
    inf = torch.tensor(float("inf"), device=dev)

    def rng(o, d, g):
        a = o[None] + t0 * d[None]
        b = o[None] + t1 * d[None]
        lo = torch.where(act, torch.minimum(a, b) - 1.0, inf)
        hi = torch.where(act, torch.maximum(a, b) + 1.0, -inf)
        # inactive rays clip to (g, 0): neutral under the min/max below
        lo = lo.clamp(0.0, float(g)).reshape(nsb, nnb, nt).amin(-1)
        hi = hi.clamp(0.0, float(g)).reshape(nsb, nnb, nt).amax(-1)
        return lo, hi

    u_lo, u_hi = rng(ou, du, gu_p)
    v_lo, v_hi = rng(ov, dv, gv_p)

    def base(lo, g, w, align):
        b = torch.floor(lo).to(torch.int32)
        b = torch.div(b, align, rounding_mode="floor") * align
        return b.clamp(0, max(g - w, 0))

    ub = base(u_lo, gu_p, wu, U_ALIGN)
    vb = base(v_lo, gv_p, wv, V_ALIGN)
    active = act.reshape(nsb, nnb, nt).any(-1)
    fits = torch.stack(
        [~active | (torch.ceil(u_hi) <= (ub + wu).float()),
         ~active | (torch.ceil(v_hi) <= (vb + wv).float())], -1)
    uvb = torch.stack([ub // U_ALIGN, vb // V_ALIGN, active.to(torch.int32),
                       torch.zeros_like(ub)], -1)
    return uvb.contiguous(), fits


# ---------------------------------------------------------------------------
# Plain versions: the arithmetic of the kernels, vectorised over rays.
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """``a*b + c`` rounded once, as the kernels' fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


class _March:
    """The per-(march station, ray) state both plain versions share: the
    taps, alpha, the gates, ``T`` and the weights, all ``[S_pad, N]``."""

    def __init__(self, slabs, rays16, cfg, desc, uvb):
        s_real, gu, gv, _ = slabs.shape
        n = rays16.shape[1]
        dev = rays16.device
        self.slabs, self.cfg, self.n = slabs, cfg, n
        s_pad, p0, pstep = march_scalars(s_real, cfg.k, cfg.s_blk, desc)
        self.s_pad = s_pad
        op, ou, ov, dp, du, dv, tlo, thi, interval = rays16[:9]
        ms = torch.arange(s_pad, device=dev)
        p_s = (torch.tensor(p0, dtype=torch.float32, device=dev)
               + torch.tensor(pstep, dtype=torch.float32, device=dev)
               * ms.float())
        t = (p_s[:, None] - op[None]) / dp[None]
        u = _fma(t, du[None].expand_as(t), ou[None].expand_as(t))
        v = _fma(t, dv[None].expand_as(t), ov[None].expand_as(t))
        self.sidx = (s_pad - 1 - ms) if desc else ms        # slab of a march
        ok = (self.sidx < s_real)[:, None].expand(s_pad, n)  # station
        _, _, wu_e, wv_e, windowed = _window_plan(cfg, gu, gv)
        if windowed:
            if uvb is None:
                raise ValueError("train_fused: a windowed step needs uvb")
            cell = uvb[:, torch.arange(n, device=dev) // cfg.nt].long()
            cell = cell.repeat_interleave(cfg.s_blk, 0)      # [S_pad, N, 4]
            u_lo, v_lo = cell[..., 0] * U_ALIGN, cell[..., 1] * V_ALIGN
            u_hi, v_hi = u_lo + wu_e, v_lo + wv_e
            ok = ok & (cell[..., 2] != 0)
        else:
            u_lo = v_lo = torch.zeros((), dtype=torch.long, device=dev)
            u_hi = torch.full((), gu, dtype=torch.long, device=dev)
            v_hi = torch.full((), gv, dtype=torch.long, device=dev)
        # Nonzero hat support needs u in (-1, gu) and v in (-1, gv); the
        # test also rejects NaN and the huge t of rays along the stations.
        ok = ok & (u > -1) & (u < gu) & (v > -1) & (v < gv)
        zero = torch.zeros_like(u)
        u0 = torch.floor(torch.where(ok, u, zero)).long()
        v0 = torch.floor(torch.where(ok, v, zero)).long()
        self.iu, self.iv, self.wu, self.wv = [], [], [], []
        for a in (0, 1):
            iu = u0 + a
            w = torch.clamp(1.0 - (u - iu.float()).abs(), min=0.0)
            good = ok & (iu >= u_lo) & (iu < u_hi) & (iu >= 0) & (iu < gu)
            self.wu.append(torch.where(good, w.to(BF16).float(), zero))
            self.iu.append(iu.clamp(0, gu - 1))
            iv = v0 + a
            w = torch.clamp(1.0 - (v - iv.float()).abs(), min=0.0)
            good = ok & (iv >= v_lo) & (iv < v_hi) & (iv >= 0) & (iv < gv)
            self.wv.append(torch.where(good, w, zero))
            self.iv.append(iv.clamp(0, gv - 1))
        self.sidx_c = self.sidx.clamp(max=s_real - 1)

        every = (ms[:, None].expand(s_pad, n).reshape(-1),
                 torch.arange(n, device=dev)[None].expand(s_pad, n)
                 .reshape(-1))
        geo = self.tap(every, slice(0, 2)).reshape(s_pad, n, 2)
        dens, maskv = geo[..., 0], geo[..., 1]
        x = dens + cfg.act_shift
        softplus = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
        self.dens = dens
        self.araw = 1.0 - torch.exp(-softplus * interval[None])
        valid = ((t >= tlo[None]) & (t <= thi[None]) & (thi > tlo)[None]
                 & (maskv > 0.0))
        self.occ = valid & (self.araw > cfg.thres)
        self.a = torch.where(self.occ, self.araw, zero)
        self.om = torch.where(self.a > 0.0, 1.0 - self.a + T_EPS,
                              torch.ones_like(zero))
        t_cum = torch.ones(n, dtype=torch.float32, device=dev)
        t_in, live = [], []
        for s in range(s_pad):
            t_in.append(t_cum)
            live.append(t_cum >= T_TERMINATE)
            t_cum = torch.where(live[-1], t_cum * self.om[s], t_cum)
        self.t_fin = t_cum
        self.t_in, self.live = torch.stack(t_in), torch.stack(live)
        self.w = torch.where(self.live, self.t_in * self.a, zero)
        self.weff = torch.where(self.w > cfg.thres, self.w, zero)
        # The samples the MLP runs on, as (march station, ray) index pairs.
        self.sel = torch.nonzero(self.weff > 0.0, as_tuple=True)

    def tap(self, sel, channels):
        """Bilinear taps of slab ``channels`` at the (station, ray) pairs
        ``sel`` -> [M, C'] f32: the u blend of exact bf16 products first,
        then the f32 v weights."""
        ms, ray = sel
        slab = self.slabs[..., channels]
        sidx = self.sidx_c[ms]
        out = 0.0
        for b in (0, 1):
            tmp = 0.0
            for a in (0, 1):
                px = slab[sidx, self.iu[a][ms, ray], self.iv[b][ms, ray]]
                tmp = tmp + self.wu[a][ms, ray][:, None] * px.float()
            out = out + tmp * self.wv[b][ms, ray][:, None]
        return out

    def scatter(self, acc, sel, g):
        """Transpose of :meth:`tap`: add the cotangents ``g [M, C']`` of
        the samples ``sel`` onto the grid accumulator ``acc [Gp, Gu, Gv,
        C']``: per tap ``wu * rnd_bf16(wv * g)``, split (1-f)/f between the
        two grid slabs that bracket the station."""
        ms, ray = sel
        k = self.cfg.k
        sidx = self.sidx[ms]
        z, j = torch.div(sidx, k, rounding_mode="floor"), sidx % k
        f_hi = (j.double() / k).float()[:, None]
        f_lo = (1.0 - j.double() / k).float()[:, None]
        z_hi = (z + 1).clamp(max=acc.shape[0] - 1)   # unused where j == 0
        for a in (0, 1):
            for b in (0, 1):
                rhs = (self.wv[b][ms, ray][:, None] * g).to(BF16).float()
                x = self.wu[a][ms, ray][:, None] * rhs
                iu, iv = self.iu[a][ms, ray], self.iv[b][ms, ray]
                acc.index_put_((z, iu, iv), f_lo * x, accumulate=True)
                acc.index_put_((z_hi, iu, iv),
                               torch.where(j[:, None] > 0, f_hi * x,
                                           torch.zeros_like(x)),
                               accumulate=True)

    def mlp_forward(self, sh1_t, w1a, w2, b2, w3, b3):
        """The colour MLP on the gated samples: bf16 operands, f32 sums,
        hidden activations rounded to bf16 after the ReLU."""
        cfg = self.cfg
        coff = 2 + (0 if cfg.direct else 3)
        _, ray = self.sel
        feat = self.tap(self.sel, slice(coff, coff + cfg.f)).to(BF16)
        h1 = torch.relu(feat.float() @ w1a.float()
                        + sh1_t.t()[ray]).to(BF16)
        h2 = torch.relu(h1.float() @ w2.float() + b2).to(BF16)
        logit = h2.float() @ w3.float() + b3
        if not cfg.direct:
            logit = logit + self.tap(self.sel, slice(2, 5))
        return feat, h1, h2, torch.sigmoid(logit)


def train_fwd_plain(slabs, rays16, sh1_t, w1a, w2, b2, w3, b3, desc,
                    uvb=None, *, cfg):
    """Plain version of :func:`train_fwd`."""
    st = _March(slabs, rays16, cfg, desc, uvb)
    n = st.n
    _, ray = st.sel
    _, _, _, rgb = st.mlp_forward(sh1_t, w1a, w2, b2, w3, b3)
    weff = st.weff[st.sel]
    gt = rays16[9:12].t()[ray]
    pack = torch.zeros((8, n), dtype=torch.float32, device=rays16.device)
    acc = torch.zeros((n, 4), dtype=torch.float32, device=rays16.device)
    acc.index_add_(0, ray, torch.cat(
        [weff[:, None] * rgb,
         (weff * torch.sum((rgb - gt) ** 2, -1))[:, None]], -1))
    pack[0:3] = acc[:, :3].t() + st.t_fin[None] * cfg.bg
    pack[3] = st.t_fin
    pack[4] = acc[:, 3]
    return pack


def train_bwd_plain(slabs, rays16, cot, sh1_t, w1a, w2, b2, w3, b3, desc,
                    uvb=None, *, cfg, gp):
    """Plain version of :func:`train_bwd`."""
    st = _March(slabs, rays16, cfg, desc, uvb)
    n, dev = st.n, rays16.device
    _, gu, gv, c = slabs.shape
    k0_dim = c - 2
    ms, ray = st.sel
    feat, h1, h2, rgb = st.mlp_forward(sh1_t, w1a, w2, b2, w3, b3)
    weff = st.weff[st.sel]
    gt = rays16[9:12].t()[ray]
    g_rgb = cot[0:3].t()[ray]
    g_per = cot[4][ray]
    ga_ainv = cot[3] * cot[5]
    interval = rays16[8]

    # dL/dw_eff of a sample (the rgbper term's weights are detached)
    a_dense = torch.zeros((st.s_pad, n), dtype=torch.float32, device=dev)
    a_dense[st.sel] = torch.sum(rgb * g_rgb, -1)
    d_rgb = weff[:, None] * (g_rgb + g_per[:, None] * 2.0 * (rgb - gt))
    d_logit = d_rgb * rgb * (1.0 - rgb)
    d_logit_b = d_logit.to(BF16).float()
    d_w3 = h2.float().t() @ d_logit_b
    d_b3 = d_logit.sum(0)
    d_h2 = d_logit_b @ w3.float().t()
    d_h2 = torch.where(h2.float() > 0.0, d_h2, torch.zeros_like(d_h2))
    d_h2b = d_h2.to(BF16).float()
    d_w2 = h1.float().t() @ d_h2b
    d_b2 = d_h2.sum(0)
    d_h1 = d_h2b @ w2.float().t()
    d_h1 = torch.where(h1.float() > 0.0, d_h1, torch.zeros_like(d_h1))
    d_h1b = d_h1.to(BF16).float()
    d_w1a = feat.float().t() @ d_h1b
    d_feat = d_h1b @ w1a.float().t()
    d_sh1 = torch.zeros((n, cfg.width), dtype=torch.float32, device=dev)
    d_sh1.index_add_(0, ray, d_h1)

    # Down each ray in reverse march order: the suffix sum R and d_alpha.
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    r_suf = zero
    d_dens = torch.zeros((st.s_pad, n), dtype=torch.float32, device=dev)
    for s in range(st.s_pad - 1, -1, -1):
        d_w = torch.where(st.w[s] > cfg.thres, a_dense[s], zero)
        keep = st.occ[s] & st.live[s]
        a_term = torch.where(st.live[s], ga_ainv, zero)
        inv_om = torch.where(st.occ[s],
                             1.0 / torch.clamp(st.om[s], min=T_EPS), zero)
        d_alpha = torch.where(keep, d_w * st.t_in[s], zero) \
            - (r_suf + a_term) * inv_om
        d_dens[s] = d_alpha * interval \
            * torch.sigmoid(st.dens[s] + cfg.act_shift) * (1.0 - st.araw[s])
        r_suf = r_suf + d_w * st.w[s]

    d_density = torch.zeros((gp, gu, gv, 1), dtype=torch.float32, device=dev)
    sel_d = torch.nonzero(d_dens != 0.0, as_tuple=True)
    st.scatter(d_density, sel_d, d_dens[sel_d][:, None])
    d_k0 = torch.zeros((gp, gu, gv, k0_dim), dtype=torch.float32, device=dev)
    g_k0 = d_feat if cfg.direct else torch.cat([d_logit, d_feat], -1)
    st.scatter(d_k0, st.sel, g_k0)
    return (d_density[..., 0], d_k0, d_sh1.t(), d_w1a, d_w2, d_b2, d_w3,
            d_b3)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _error(lib, what, err):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.dvgo_error_string(err).decode())


def _lib_fwd():
    """K-D's library, with every C function's signature declared."""
    lib = _build.load("train_fused_fwd")
    lib.dvgo_train_fused_fwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
        + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    lib.dvgo_train_fused_fwd.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def _lib_bwd():
    """K-E's library, with every C function's signature declared."""
    lib = _build.load("train_fused_bwd")
    lib.dvgo_train_fused_bwd.argtypes = (
        [ctypes.c_void_p] * 20 + [ctypes.c_int] * 15
        + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    lib.dvgo_train_fused_bwd.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, slabs, rays16, sh1_t, w1a, w2, b2, w3, b3, uvb, cfg,
           extra=None):
    """Shape, dtype and device checks shared by the two wrappers; returns
    whether the step is windowed."""
    if slabs.dim() != 4 or slabs.dtype != BF16:
        raise TypeError(f"{name}: slabs must be [S, Gu, Gv, C] bfloat16")
    s_real, gu, gv, c = slabs.shape
    n = rays16.shape[-1]
    width, f = cfg.width, cfg.f
    coff = 2 + (0 if cfg.direct else 3)
    if rays16.shape != (16, n) or rays16.dtype != torch.float32:
        raise ValueError(f"{name}: rays16 must be [16, N] float32")
    if n % cfg.nt or not 1 <= f <= F_MAX or c != coff + f or cfg.thres <= 0:
        raise ValueError(f"{name}: N={n} nt={cfg.nt} F={f} C={c} thres="
                         f"{cfg.thres} outside the fused step's shapes")
    shapes = {"sh1_t": (sh1_t, (width, n), torch.float32),
              "w1a": (w1a, (f, width), BF16), "w2": (w2, (width, width), BF16),
              "b2": (b2, (width,), torch.float32),
              "w3": (w3, (width, 3), BF16), "b3": (b3, (3,), torch.float32)}
    extra = extra or {}
    shapes.update(extra)
    for key, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    windowed = _window_plan(cfg, gu, gv)[4]
    if windowed:
        s_pad = _round_up(s_real, cfg.s_blk)
        if (uvb is None or uvb.dtype != torch.int32
                or tuple(uvb.shape) != (s_pad // cfg.s_blk, n // cfg.nt, 4)):
            raise ValueError(f"{name}: a windowed step needs uvb int32 "
                             f"[{s_pad // cfg.s_blk}, {n // cfg.nt}, 4]")
    tensors = [slabs, rays16, sh1_t, w1a, w2, b2, w3, b3] \
        + [x for x, _, _ in extra.values()] + ([uvb] if windowed else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")
    return windowed


def _check_cuda(name, tensors, cfg):
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: expects contiguous tensors on one CUDA "
                         "device")
    if (cfg.width not in KERNEL_WIDTHS or cfg.s_blk != S_BLK
            or cfg.nt % KERNEL_RAYS):
        raise ValueError(f"{name}: the kernel is built for widths "
                         f"{KERNEL_WIDTHS}, s_blk {S_BLK} and nt a multiple "
                         f"of {KERNEL_RAYS}")


def _kernel_operands(sh1_t, w1a, w3, b3):
    """The kernels' layouts: per-ray rows of ``sh1``; ``w1a`` padded to 16
    input rows, ``w3``/``b3`` to 16 output columns (zeros, exact), the
    shapes of the tensor-core tiles."""
    width = w1a.shape[1]
    w1a_p = torch.zeros((16, width), dtype=BF16, device=w1a.device)
    w1a_p[: w1a.shape[0]] = w1a
    w3_p = torch.zeros((width, 16), dtype=BF16, device=w3.device)
    w3_p[:, :3] = w3
    b3_p = torch.zeros(16, dtype=torch.float32, device=b3.device)
    b3_p[:3] = b3
    return sh1_t.t().contiguous(), w1a_p, w3_p, b3_p


def train_fwd(slabs, rays16, sh1_t, w1a, w2, b2, w3, b3, desc, uvb=None, *,
              cfg, mode=0):
    """K-D. slabs [S, Gu, Gv, C] bf16 station slabs in slab order
    (:func:`build_slabs`); rays16 [16, N] f32 rows (op, ou, ov, dp_safe, du,
    dv, t_lo, t_hi, interval, gt_r, gt_g, gt_b, 0...) in the slabs' voxel
    frame, every ``dp`` of one sign; sh1_t [W, N] f32 the hoisted view term
    ``(vd_emb @ W1[F:] + b1).T``; w1a [F, W], w2 [W, W], w3 [W, 3] bf16; b2
    [W], b3 [3] f32; ``desc``: the batch marches towards lower axis
    coordinates; uvb [S_pad // s_blk, N // nt, 4] int32 window cells when
    ``cfg`` windows. Returns pack [8, N] f32: rows rgb_marched (3),
    alphainv_last, rgbper_sum, then zeros. ``mode`` (CUDA only): a
    diagnostic form, :data:`MODE_NO_MLP` or :data:`MODE_GATES`, which
    ``chip_smoke.py`` runs to see where the time goes and to compare the
    gates."""
    global launches_fwd, plain_calls_fwd
    windowed = _check("train_fwd", slabs, rays16, sh1_t, w1a, w2, b2, w3, b3,
                      uvb, cfg)
    if slabs.device.type == "cpu":
        if mode:
            raise ValueError("train_fwd: the diagnostic modes are CUDA's")
        plain_calls_fwd += 1
        return train_fwd_plain(slabs, rays16, sh1_t, w1a, w2, b2, w3, b3,
                               desc, uvb, cfg=cfg)
    uvb = uvb if windowed else None
    _check_cuda("train_fwd", [slabs, rays16, sh1_t, w1a, w2, b2, w3, b3]
                + ([uvb] if windowed else []), cfg)
    s_real, gu, gv, c = slabs.shape
    n = rays16.shape[1]
    s_pad, p0, pstep = march_scalars(s_real, cfg.k, cfg.s_blk, desc)
    _, _, wu_e, wv_e, _ = _window_plan(cfg, gu, gv)
    sh1, w1a_p, w3_p, b3_p = _kernel_operands(sh1_t, w1a, w3, b3)
    pack = torch.empty((8, n), dtype=torch.float32, device=slabs.device)
    lib = _lib_fwd()
    err = lib.dvgo_train_fused_fwd(
        slabs.data_ptr(), rays16.data_ptr(), sh1.data_ptr(),
        w1a_p.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3_p.data_ptr(),
        b3_p.data_ptr(), uvb.data_ptr() if windowed else None,
        pack.data_ptr(), n, s_real, s_pad, gu, gv, c, cfg.f, cfg.width,
        int(cfg.direct), int(bool(desc)), cfg.nt, int(windowed), wu_e, wv_e,
        p0, pstep, cfg.act_shift, cfg.thres, cfg.bg, int(mode),
        torch.cuda.current_stream(slabs.device).cuda_stream)
    _error(lib, "train_fwd", err)
    launches_fwd += 1
    return pack


def train_bwd(slabs, rays16, cot, sh1_t, w1a, w2, b2, w3, b3, desc,
              uvb=None, *, cfg, gp, mode=0):
    """K-E. Inputs as :func:`train_fwd`, plus cot [8, N] f32 rows (g_rgb (3),
    g_ainv, g_rgbper, alphainv_last, 0, 0) and the grid's sweep extent
    ``gp`` (S = k*(gp-1)+1). Returns f32 ``(d_density [Gp, Gu, Gv], d_k0
    [Gp, Gu, Gv, C-2], d_sh1 [W, N], d_w1a [F, W], d_w2 [W, W], d_b2 [W],
    d_w3 [W, 3], d_b3 [3])``; voxels no sample touches stay exactly zero.
    ``mode`` (CUDA only): a diagnostic form, a mask of :data:`MODE_NO_MLP`,
    :data:`MODE_NO_SCATTER` and :data:`MODE_NO_PHASE2`."""
    global launches_bwd, plain_calls_bwd
    n = rays16.shape[-1]
    windowed = _check("train_bwd", slabs, rays16, sh1_t, w1a, w2, b2, w3, b3,
                      uvb, cfg,
                      extra={"cot": (cot, (8, n), torch.float32)})
    s_real, gu, gv, c = slabs.shape
    if s_real != cfg.k * (gp - 1) + 1:
        raise ValueError(f"train_bwd: {s_real} stations do not match gp={gp} "
                         f"at k={cfg.k}")
    if slabs.device.type == "cpu":
        if mode:
            raise ValueError("train_bwd: the diagnostic modes are CUDA's")
        plain_calls_bwd += 1
        return train_bwd_plain(slabs, rays16, cot, sh1_t, w1a, w2, b2, w3,
                               b3, desc, uvb, cfg=cfg, gp=gp)
    uvb = uvb if windowed else None
    _check_cuda("train_bwd", [slabs, rays16, cot, sh1_t, w1a, w2, b2, w3, b3]
                + ([uvb] if windowed else []), cfg)
    dev = slabs.device
    width, f = cfg.width, cfg.f
    s_pad, p0, pstep = march_scalars(s_real, cfg.k, cfg.s_blk, desc)
    _, _, wu_e, wv_e, _ = _window_plan(cfg, gu, gv)
    sh1, w1a_p, w3_p, b3_p = _kernel_operands(sh1_t, w1a, w3, b3)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    d_density, d_k0 = zeros(gp, gu, gv), zeros(gp, gu, gv, c - 2)
    d_sh1 = zeros(n, width)
    d_w1a, d_w2, d_b2 = zeros(16, width), zeros(width, width), zeros(width)
    d_w3, d_b3 = zeros(width, 16), zeros(16)
    # Scratch of one launch: T entering each march block, and dL/dw_eff of
    # the gated samples (read back only where it was written).
    t_chk = torch.empty((s_pad // cfg.s_blk, n), dtype=torch.float32,
                        device=dev)
    a_buf = torch.empty((s_pad, n), dtype=torch.float32, device=dev)
    lib = _lib_bwd()
    err = lib.dvgo_train_fused_bwd(
        slabs.data_ptr(), rays16.data_ptr(), cot.data_ptr(), sh1.data_ptr(),
        w1a_p.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3_p.data_ptr(),
        b3_p.data_ptr(), uvb.data_ptr() if windowed else None,
        t_chk.data_ptr(), a_buf.data_ptr(), d_density.data_ptr(),
        d_k0.data_ptr(), d_sh1.data_ptr(), d_w1a.data_ptr(),
        d_w2.data_ptr(), d_b2.data_ptr(), d_w3.data_ptr(), d_b3.data_ptr(),
        n, s_real, s_pad, gu, gv, c, f, width, int(cfg.direct),
        int(bool(desc)), cfg.nt, int(windowed), wu_e, wv_e, cfg.k,
        p0, pstep, cfg.act_shift, cfg.thres, cfg.bg, int(mode),
        torch.cuda.current_stream(dev).cuda_stream)
    _error(lib, "train_bwd", err)
    launches_bwd += 1
    return (d_density, d_k0, d_sh1.t(), d_w1a[:f], d_w2, d_b2, d_w3[:, :3],
            d_b3[:3])


# ---------------------------------------------------------------------------
# The differentiable chain the model calls
# ---------------------------------------------------------------------------

class _FusedChain(torch.autograd.Function):
    """K-D forward, K-E backward. The grid cotangents are those of the
    permuted f32 grids (the bf16 cast of the slabs is passed straight
    through); the view rows of layer 0 and ``b1`` get their gradient through
    ``sh1_t``; rays and mask get none."""

    @staticmethod
    def forward(ctx, cfg, density_pm, k0_pm, mask_pm, rays16, sh1_t, w1, w2,
                b2, w3, b3):
        gp, gu, gv = density_pm.shape
        slabs = build_slabs(density_pm, k0_pm, mask_pm, cfg.k)
        rays16 = rays16.contiguous()
        sh1_t = sh1_t.contiguous()
        desc = bool(rays16[3, 0] < 0)
        gu_p, gv_p, wu_e, wv_e, windowed = _window_plan(cfg, gu, gv)
        uvb = None
        if windowed:
            s_pad, p0, pstep = march_scalars(slabs.shape[0], cfg.k,
                                             cfg.s_blk, desc)
            uvb, _ = blocktile_uv_bases(
                rays16, p0, pstep, s_pad // cfg.s_blk, cfg.s_blk, gu_p, gv_p,
                wu_e, wv_e, cfg.nt)
        ops = mlp_operands(w1, w2, w3, cfg.f)
        b2c, b3c = b2.float().contiguous(), b3.float().contiguous()
        pack = train_fwd(slabs, rays16, sh1_t, ops[0], ops[1], b2c, ops[2],
                         b3c, desc, uvb, cfg=cfg)
        ctx.save_for_backward(slabs, rays16, sh1_t, *ops, b2c, b3c, pack[3],
                              uvb if windowed else rays16.new_zeros(0))
        ctx.fused = (cfg, desc, gp, windowed, w1.shape)
        return pack[0:3].t(), pack[3], pack[4]

    @staticmethod
    def backward(ctx, g_rgb, g_ainv, g_rgbper):
        slabs, rays16, sh1_t, w1a, w2o, w3o, b2, b3, ainv, uvb = \
            ctx.saved_tensors
        cfg, desc, gp, windowed, w1_shape = ctx.fused
        n = rays16.shape[1]
        zero = torch.zeros(n, dtype=torch.float32, device=rays16.device)
        g_rgb = zero[:, None].expand(n, 3) if g_rgb is None else g_rgb
        g_ainv = zero if g_ainv is None else g_ainv
        g_rgbper = zero if g_rgbper is None else g_rgbper
        # rgb_marched = sum_s w_s rgb_s + alphainv_last * bg: the rgb
        # cotangent also reaches alphainv_last through the background term.
        g_ainv = g_ainv + cfg.bg * torch.sum(g_rgb, -1)
        cot = torch.cat([g_rgb.t().float(), g_ainv[None].float(),
                         g_rgbper[None].float(), ainv[None],
                         torch.zeros((2, n), dtype=torch.float32,
                                     device=rays16.device)]).contiguous()
        d_density, d_k0, d_sh1, d_w1a, d_w2, d_b2, d_w3, d_b3 = train_bwd(
            slabs, rays16, cot, sh1_t, w1a, w2o, b2, w3o, b3, desc,
            uvb if windowed else None, cfg=cfg, gp=gp)
        d_w1 = torch.zeros(w1_shape, dtype=torch.float32,
                           device=rays16.device)
        d_w1[:, : cfg.f] = d_w1a.t()
        return (None, d_density, d_k0, None, None, d_sh1, d_w1, d_w2.t(),
                d_b2, d_w3.t(), d_b3)


def fused_chain(cfg, density_pm, k0_pm, mask_pm, rays16, sh1_t, rgbnet):
    """Fused train forward, differentiable in the grids, ``sh1_t`` and the
    MLP.

    density_pm, k0_pm, mask_pm: f32 grids already permuted to sweep order
    [Gp, Gu, Gv(, F)] (and already sliced to the clip box in region mode);
    rays16 [16, N] f32 (see :func:`train_fwd`), direction-uniform; sh1_t
    [W, N] f32; rgbnet: the model's three-layer :class:`..models.mlp.MLP`.
    Returns (rgb_marched [N, 3], alphainv_last [N], rgbper_sum [N])."""
    l0, l1, l2 = rgbnet.layers
    return _FusedChain.apply(cfg, density_pm, k0_pm, mask_pm.float(),
                             rays16, sh1_t, l0.weight, l1.weight, l1.bias,
                             l2.weight, l2.bias)


def fused_enabled(device=None):
    """The switch alone (the engine reads it before it pays for the tile
    sort): ``DVGO_FUSED_TRAIN=1`` turns the fused step on for CUDA devices,
    ``=force`` also on the CPU (through the plain versions); off by
    default."""
    env = os.environ.get("DVGO_FUSED_TRAIN", "0")
    if env == "0":
        return False
    return env == "force" or (device is not None
                              and torch.device(device).type == "cuda")


def fused_available(n, gu, gv, fdim, width, thres, depth, s_blk=S_BLK,
                    nt=NT, wu=0, wv=0, device=None):
    """Whether the fused step takes these shapes: the switch, a three-layer
    split MLP, a positive ``fast_color_thres`` (the gates depend on it),
    whole ray tiles, aligned windows that fit the padded plane and, on a
    CUDA device, a width and tiling the kernels are built for."""
    if not fused_enabled(device):
        return False
    if depth != 3 or width < 8 or fdim < 1 or fdim > F_MAX:
        return False
    if thres <= 0 or n % nt or gu < 2 or gv < 2:
        return False
    if wu or wv:
        gu, gv = _round_up(gu, U_ALIGN), _round_up(gv, V_ALIGN)
        if wu % U_ALIGN or wv % V_ALIGN or wu > gu or wv > gv:
            return False
    if device is not None and torch.device(device).type == "cuda":
        return (width in KERNEL_WIDTHS and s_blk == S_BLK
                and nt % KERNEL_RAYS == 0)
    return True
