"""K-B's tensor-core MLP on the CPU: the weight pack the kernel reads
(``pack_mlp_mma``), and the MLP computed in the order the kernel's
``mma.sync.m16n8k16`` instructions compute it, against the plain version
of the frame kernel (``render_frame_plain``); plus the C entry points that
this kernel and K-F's rows path add.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
its plain version and its first version there). Here the layout of its B
fragments is written out independently of the packing code, and the
frame's MLP is recomputed from bf16 operands with f32 accumulation, one
16-deep k-chunk after another, as the tensor cores sum them.
"""

import pytest
import torch

from directvoxgo_tpu_torch.ops import render_frame as kb
from directvoxgo_tpu_torch.tools import bench_framekernel as bench


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(seed, f_mlp, e_dim, width):
    g = torch.Generator().manual_seed(seed)
    dims = [f_mlp + e_dim, width, width, 3]
    return [(torch.randn((dims[i], dims[i + 1]), generator=g),
             torch.randn(dims[i + 1], generator=g)) for i in range(3)]


def _unpack_fragments(frags, pos, k_tiles, n_tiles):
    """A [16*k_tiles, 8*n_tiles] matrix from m16n8k16 B fragments stored
    tile by tile (k-tile major), 32 lanes a tile: lane l holds column
    l // 4 of the tile at rows 2q, 2q+1, 2q+8, 2q+9 (q = l % 4)."""
    m = torch.zeros((16 * k_tiles, 8 * n_tiles))
    for kt in range(k_tiles):
        for nt in range(n_tiles):
            for lane in range(32):
                n, q = nt * 8 + lane // 4, lane % 4
                for v, k in enumerate((2 * q, 2 * q + 1, 2 * q + 8,
                                       2 * q + 9)):
                    m[kt * 16 + k, n] = frags[pos + v]
                pos += 4
    return m, pos


@pytest.mark.parametrize("width", [32, 64, 128])
@pytest.mark.parametrize("f_mlp,e_dim", [(12, 27), (16, 27), (9, 0),
                                         (16, 0)])
def test_mma_pack_unpacks_to_pack_mlp(width, f_mlp, e_dim):
    """The tensor-core pack holds exactly ``pack_mlp``'s bf16 weights and
    f32 biases, zero in the padding (F to 16, E to 32, layer 3's N to 8);
    without a view half (the ``shared1`` forms) b1 is zero and no view
    fragments are stored."""
    layers = _layers(width + f_mlp + e_dim, f_mlp, e_dim, width)
    if e_dim == 0:
        layers[0] = (layers[0][0], None)
    buf = kb.pack_mlp_mma(layers, f_mlp)
    ref = kb.pack_mlp(layers, f_mlp)
    e4 = -(-e_dim // 4) * 4
    sizes = [f_mlp * width, width * e4, width, width, width * width,
             width * 3, 3]
    parts = torch.split(ref, sizes)
    w1a, w1bt, b1, b2, w2t, w3, b3 = parts
    assert torch.equal(buf[:width], b1)
    assert torch.equal(buf[width:2 * width], b2)
    assert torch.equal(buf[2 * width:2 * width + 3], b3)
    assert torch.equal(buf[2 * width + 3:2 * width + 8], torch.zeros(5))
    frags = buf[2 * width + 8:].view(torch.bfloat16).float()
    nt, kt = width // 8, width // 16
    m1, pos = _unpack_fragments(frags, 0, 1, nt)
    assert torch.equal(m1[:f_mlp], w1a.reshape(f_mlp, width))
    assert not m1[f_mlp:].any()
    if e_dim:
        me, pos = _unpack_fragments(frags, pos, 2, nt)
        assert torch.equal(me[:e_dim],
                           w1bt.reshape(width, e4)[:, :e_dim].t())
        assert not me[e_dim:].any()
    m2, pos = _unpack_fragments(frags, pos, kt, nt)
    assert torch.equal(m2, w2t.reshape(width, width).t())
    m3, pos = _unpack_fragments(frags, pos, kt, 1)
    assert torch.equal(m3[:, :3], w3.reshape(width, 3))
    assert not m3[:, 3:].any()
    assert pos == frags.numel()


def _mm_k16(a, b):
    """``a [M, K] @ b [K, N]`` as the tensor cores take it: both operands
    bf16 values, f32 accumulators, one 16-deep k-chunk added after the
    other (K zero-padded to a multiple of 16)."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ b[k:k + 16]
    return acc


def _render_mma(d_geo, d_k0, vd_emb, dnorm, dclip, ur, vr, layers, scalars,
                activity, *, has_mlp, rgb_mode, shared1=None,
                k0_order="v_first"):
    """The frame as K-B computes it: the plain version's march and
    rounding points, with the colour MLP in the tensor-core order of
    :func:`_mm_k16` (v4's view term too: its own accumulator, then b1)."""
    (op, ou, ov, inv_span, p_first, p_step, act_shift, interval_scale,
     fast_thres, near, far, bg) = [torch.tensor(float(x)) for x in scalars]
    rnd = kb._rnd
    s_total, gu, gv, _ = d_geo.shape
    hi, wi = dnorm.shape
    c0 = 3 if rgb_mode == "logit_plus_k0" else 0
    geo, k0 = d_geo.float(), d_k0.float() if d_k0 is not None else None
    if has_mlp:
        (w1, b1), (w2, b2), (w3, b3) = layers
        if shared1 is None:
            f_mlp = w1.shape[0] - vd_emb.shape[-1]
            sh1 = _mm_k16(vd_emb.float().reshape(hi * wi, -1),
                          rnd(w1[f_mlp:])) + b1
        else:
            f_mlp = w1.shape[0]
            sh1 = shared1.float().reshape(hi * wi, -1)
    act = activity.bool()
    t_cum = torch.ones((hi, wi))
    rgb = torch.zeros((3, hi, wi))
    depth = torch.zeros((hi, wi))
    interval = dnorm * interval_scale
    for s in range(s_total):
        blk = act[:, :, s // kb.S_BLK].repeat_interleave(
            kb.TILE, 0).repeat_interleave(kb.TILE, 1)
        lam = (kb._fma(p_step, torch.tensor(float(s)), p_first) - op) \
            * inv_span
        ua, ub, wua, wub = kb._hat_taps(kb._fma(lam, ur - ou, ou), gu)
        va, vb, wva, wvb = kb._hat_taps(kb._fma(lam, vr - ov, ov), gv)
        t1 = rnd(wua[:, None, None] * geo[s, ua]
                 + wub[:, None, None] * geo[s, ub])
        g = wva[None, :, None] * t1[:, va] + wvb[None, :, None] * t1[:, vb]
        alpha = 1.0 - torch.exp(-kb._softplus(g[..., 0] + act_shift)
                                * interval)
        t_px = lam * dclip
        ok = ((t_px >= near) & (t_px <= far) & (g[..., 1] > 0.0)
              & (alpha > fast_thres) & (t_cum >= kb.T_TERMINATE) & blk)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        w = t_cum * a
        t_cum = t_cum * (1.0 - a + kb.T_EPS)
        idx = torch.nonzero(w.reshape(-1) > 0.0).squeeze(1)
        if idx.numel() == 0:
            continue
        pi, pj = idx // wi, idx % wi
        w_sel = w.reshape(-1)[idx]
        if k0 is not None and k0_order == "u_first":
            tua = rnd(wua[pi, None] * k0[s, ua[pi], va[pj]]
                      + wub[pi, None] * k0[s, ub[pi], va[pj]])
            tub = rnd(wua[pi, None] * k0[s, ua[pi], vb[pj]]
                      + wub[pi, None] * k0[s, ub[pi], vb[pj]])
            cl = wva[pj, None] * tua + wvb[pj, None] * tub
        elif k0 is not None:
            tva = rnd(wva[pj, None] * k0[s, ua[pi], va[pj]]
                      + wvb[pj, None] * k0[s, ua[pi], vb[pj]])
            tvb = rnd(wva[pj, None] * k0[s, ub[pi], va[pj]]
                      + wvb[pj, None] * k0[s, ub[pi], vb[pj]])
            cl = wua[pi, None] * tva + wub[pi, None] * tvb
        if has_mlp:
            h = _mm_k16(rnd(cl[:, c0:]), rnd(w1[:f_mlp]))
            h = rnd(torch.relu(h + sh1[idx]))
            h = rnd(torch.relu(_mm_k16(h, rnd(w2)) + b2))
            logit = _mm_k16(h, rnd(w3)) + b3
            if c0:
                logit = logit + cl[:, :3]
            rgb_s = torch.sigmoid(logit)
        elif k0 is not None:
            rgb_s = torch.sigmoid(cl[:, :3])
        else:
            rgb_s = torch.full((idx.numel(), 3), 0.5)
        rgb.view(3, -1)[:, idx] += (w_sel[:, None] * rgb_s).t()
        depth.view(-1)[idx] += w_sel * (lam * dnorm).reshape(-1)[idx]
    return rgb + t_cum[None] * bg, depth, t_cum


@pytest.mark.parametrize("rgb_mode,has_mlp", bench.CHECK_MODES)
def test_mma_order_mlp_matches_the_plain_frame(rgb_mode, has_mlp):
    """On the harness's check cases (three colour modes, every form), the
    frame with its MLP summed as the tensor cores sum it agrees with
    ``render_frame_plain`` within ``KERNEL_TOL``: T and depth exactly (the
    MLP does not reach them), rgb to 1e-3, because the summation order can
    flip one bf16 rounding of a hidden unit (h1 and h2 are rounded to bf16
    after the relu), which moves a colour by up to a few 1e-4."""
    hi, wi, s_total, gu, gv = bench.CHECK_SHAPE
    case = bench.make_case(*bench.CHECK_SHAPE, has_mlp=has_mlp,
                           rgb_mode=rgb_mode, occupancy=0.15)
    if not has_mlp:
        case["d_k0"] = case["d_k0"][:, :3].contiguous()
        case["d_k0t"] = case["d_k0"].reshape(s_total, 3 * gu, gv)
    visible = 0
    for form, args_fn in (("v1", bench.v1_args), ("v3", bench.v3_args),
                          ("v4", bench.v4_args)):
        args = args_fn(case)
        stats = {}
        r_p, d_p, t_p = kb.render_frame_plain(**args, stats=stats)
        r_m, d_m, t_m = _render_mma(**args)
        assert torch.equal(t_m, t_p), form
        assert torch.equal(d_m, d_p), form
        err = float((r_m - r_p).abs().max())
        assert err <= bench.KERNEL_TOL["rgb"], (form, err)
        visible = stats["visible_samples"]
    assert visible > 1000


def test_new_entry_points_are_declared(monkeypatch):
    """K-F's rows path and K-B's queue counters are C entry points that the
    wrappers declare, with the argument counts of their prototypes (the
    signature test of ``test_torch_kernels.py`` covers every entry point;
    this one names the new ones)."""
    import re
    import types
    from directvoxgo_tpu_torch.ops import _build
    from directvoxgo_tpu_torch.ops import tv as kf

    def fake_load(name):
        src = open(f"{_build.CSRC}/{name}.cu").read()
        c_api = src[src.index('extern "C"'):]
        fns = {m.group(1): m.group(2) for m in re.finditer(
            r"^\S.*?\b(dvgo_\w+)\(([^)]*)\)\s*\{", c_api, re.M | re.S)}
        lib = types.SimpleNamespace(**{f: types.SimpleNamespace()
                                       for f in fns})
        lib.prototypes = fns
        return lib

    monkeypatch.setattr(_build, "load", fake_load)
    f_lib, b_lib = kf._lib(), kb._lib()
    assert set(f_lib.prototypes) == {"dvgo_error_string", "dvgo_tv_add_grad",
                                     "dvgo_tv_add_grad_rows"}
    assert {"dvgo_render_frame", "dvgo_render_frame_queue_stats"} <= set(
        b_lib.prototypes)
    for lib, fn, n in ((f_lib, "dvgo_tv_add_grad_rows", 23),
                       (f_lib, "dvgo_tv_add_grad", 23),
                       (b_lib, "dvgo_render_frame_queue_stats", 2),
                       (b_lib, "dvgo_render_frame", 37)):
        params = [p for p in lib.prototypes[fn].split(",") if p.strip()]
        assert len(params) == n and len(getattr(lib, fn).argtypes) == n, fn
