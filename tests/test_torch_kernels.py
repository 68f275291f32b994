"""The port's two kernels, through their plain PyTorch versions on the CPU,
against the JAX package's Pallas kernels run in interpret mode.

K-B (``directvoxgo_tpu_torch.ops.render_frame``) replaces the fused frame
kernels ``render_frame_pallas4`` and ``render_frame_pallas3``; K-A
(``directvoxgo_tpu_torch.ops.sweep_fwd``) replaces the full-Gv form of
``sweep_fwd_pallas``. Inputs are made once with numpy from a seed and
handed to both packages in each one's layout. K-A's windowed form and K-C
(the sweep's backward) are held against JAX in ``test_torch_sweep_bwd.py``;
the signature test here covers all three sources.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.ops import pallas_sweep_train as pst
from directvoxgo_tpu.ops import sweep as jax_sweep
from directvoxgo_tpu.ops.pallas_render3 import render_frame_pallas3
from directvoxgo_tpu.ops.pallas_render4 import render_frame_pallas4
from directvoxgo_tpu_torch.ops import render_frame as kb
from directvoxgo_tpu_torch.ops import sweep_bwd as kc
from directvoxgo_tpu_torch.ops import sweep_fwd as ka
from directvoxgo_tpu_torch.ops import sweep as torch_sweep

S, GU, GV, EMB, WIDTH = 32, 24, 24, 27, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids idle spinning of the
    thread pool next to the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame_inputs(seed, n_ti, n_tj, f_k0, has_mlp, rgb_mode, sign):
    """One frame's kernel inputs as numpy arrays (port layout)."""
    rng = np.random.default_rng(seed)
    hi, wi = n_ti * kb.TILE, n_tj * kb.TILE
    dens = rng.normal(0.0, 4.0, (S, GU, GV)).astype(np.float32)
    mask = (rng.uniform(size=(S, GU, GV)) < 0.85).astype(np.float32)
    d_geo = np.stack([dens, mask], -1)
    d_k0 = rng.normal(size=(S, GU, GV, f_k0)).astype(np.float32)
    ur = np.linspace(-4.0, GU + 3.0, hi).astype(np.float32)
    vr = np.linspace(-4.0, GV + 3.0, wi).astype(np.float32)
    dnorm = (30.0 + rng.uniform(size=(hi, wi))).astype(np.float32)
    dclip = (dnorm * (0.9 + 0.1 * rng.uniform(size=(hi, wi)))
             ).astype(np.float32)
    vd_emb = rng.uniform(-1, 1, (hi, wi, EMB)).astype(np.float32)
    f_mlp = f_k0 - (3 if rgb_mode == "logit_plus_k0" else 0)
    dims = [f_mlp + EMB, WIDTH, WIDTH, 3]
    layers = [((rng.uniform(-1, 1, (dims[i], dims[i + 1]))
                / np.sqrt(dims[i])).astype(np.float32),
               rng.uniform(-0.1, 0.1, dims[i + 1]).astype(np.float32))
              for i in range(3)]
    activity = (rng.uniform(size=(n_ti, n_tj, S // kb.S_BLK)) < 0.8
                ).astype(np.int32)
    op, p_ref = -20.0, float(S - 1) / 2.0
    p_first, p_step = (0.0, 0.5) if sign > 0 else ((S - 1) / 2.0, -0.5)
    scalars = np.asarray([op, GU / 2.0, GV / 2.0, 1.0 / (p_ref - op),
                          p_first, p_step, -4.6, 0.02, 1e-4, 20.0, 60.0,
                          1.0], np.float32)
    return dict(d_geo=d_geo, d_k0=d_k0, vd_emb=vd_emb, dnorm=dnorm,
                dclip=dclip, ur=ur, vr=vr, layers=layers, scalars=scalars,
                activity=activity, has_mlp=has_mlp, rgb_mode=rgb_mode,
                f_mlp=f_mlp)


def _render_port(x):
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    t = torch.tensor
    return [o.numpy() for o in kb.render_frame(
        bf(x["d_geo"]), bf(x["d_k0"]),
        bf(x["vd_emb"]) if x["has_mlp"] else None, t(x["dnorm"]),
        t(x["dclip"]), t(x["ur"]), t(x["vr"]),
        [(t(w), t(b)) for w, b in x["layers"]] if x["has_mlp"] else None,
        [float(v) for v in x["scalars"]], t(x["activity"]),
        has_mlp=x["has_mlp"], rgb_mode=x["rgb_mode"])]


def _render_jax(x, version):
    """The same frame through render_frame_pallas4/3 in interpret mode."""
    bf = jnp.bfloat16
    f_k0 = x["d_k0"].shape[-1]
    # channel-major geometry [S, Gu, 2*Gv] and transposed colour slabs
    # [S, F*Gu, Gv] (row c*Gu + U)
    d_geo = jnp.asarray(np.transpose(x["d_geo"], (0, 1, 3, 2)).reshape(
        S, GU, 2 * GV), bf)
    d_k0t = jnp.asarray(np.transpose(x["d_k0"], (0, 3, 1, 2)).reshape(
        S, f_k0 * GU, GV), bf)
    mlp_params = vd_in = None
    if x["has_mlp"]:
        (w1, b1), (w2, b2), (w3, b3) = [(jnp.asarray(w), jnp.asarray(b))
                                        for w, b in x["layers"]]
        f_mlp = x["f_mlp"]
        mlp_params = {"w1a": w1[:f_mlp], "w2": w2, "b2": b2, "w3": w3,
                      "b3": b3}
        vd_emb = jnp.asarray(x["vd_emb"])
        if version == 4:
            vd_in = jnp.transpose(vd_emb, (2, 0, 1)).astype(bf)
            mlp_params.update(w1b=w1[f_mlp:], b1=b1)
        else:
            vd_in = (jnp.dot(vd_emb.astype(bf), w1[f_mlp:].astype(bf),
                             preferred_element_type=jnp.float32)
                     + b1).astype(bf)
    fn = render_frame_pallas4 if version == 4 else render_frame_pallas3
    out = fn(d_geo, d_k0t, vd_in, jnp.asarray(x["dnorm"]),
             jnp.asarray(x["dclip"]), jnp.asarray(x["ur"]),
             jnp.asarray(x["vr"]), mlp_params, jnp.asarray(x["scalars"]),
             activity=jnp.asarray(x["activity"]), guv=(GU, GV),
             has_mlp=x["has_mlp"], rgb_mode=x["rgb_mode"], interpret=True)
    return [np.asarray(o) for o in out]


FRAME_CASES = [
    # (tiles (n_ti, n_tj), F, has_mlp, rgb_mode, march sign)
    ((1, 1), 12, True, "direct", 1),
    ((1, 2), 6, True, "logit_plus_k0", -1),
    ((2, 2), 12, True, "logit_plus_k0", 1),
    ((1, 1), 3, False, "direct", -1),
]


@pytest.mark.parametrize("tiles,f_k0,has_mlp,rgb_mode,sign", FRAME_CASES)
def test_render_frame_plain_matches_pallas4(tiles, f_k0, has_mlp, rgb_mode,
                                            sign):
    x = _frame_inputs(1, *tiles, f_k0, has_mlp, rgb_mode, sign)
    rgb, depth, tcum = _render_port(x)
    rgb4, depth4, tcum4 = _render_jax(x, 4)
    # The frame must not be trivially empty or opaque.
    assert 0.01 < float((tcum4 < 0.5).mean()) < 0.95
    # Same rounding points and sums of two nonzero terms in the warps; the
    # MLP's f32 sums and the exp/log1p ulps of two libraries differ.
    assert np.abs(rgb - rgb4).max() < 1e-4
    assert np.abs(tcum - tcum4).max() < 1e-4
    assert (np.abs(depth - depth4) / np.maximum(1.0, np.abs(depth4))
            ).max() < 1e-3


@pytest.mark.parametrize("tiles,f_k0,has_mlp,rgb_mode,sign",
                         [c for c in FRAME_CASES if c[2]][:2])
def test_render_frame_plain_matches_pallas3(tiles, f_k0, has_mlp, rgb_mode,
                                            sign):
    x = _frame_inputs(2, *tiles, f_k0, has_mlp, rgb_mode, sign)
    rgb, depth, tcum = _render_port(x)
    rgb3, depth3, tcum3 = _render_jax(x, 3)
    # v3 rounds the hoisted view term shared1 = emb.W1b + b1 to bf16 before
    # the layer-1 add, where K-B (like v4) keeps it f32: one extra bf16
    # rounding of a pre-activation (relative 2^-9) reaches the logits
    # through two layers, so rgb gets a wider bound than v4's; the geometry
    # (T, depth) does not involve the MLP and keeps v4's.
    assert np.abs(rgb - rgb3).max() < 1e-3
    assert np.abs(tcum - tcum3).max() < 1e-4
    assert (np.abs(depth - depth3) / np.maximum(1.0, np.abs(depth3))
            ).max() < 1e-3


def test_render_frame_cuda_only_on_cuda_or_cpu():
    """The wrapper takes the plain version only for CPU tensors; a device
    other than the CPU or a CUDA card is refused rather than rerouted."""
    x = _frame_inputs(3, 1, 1, 3, False, "direct", 1)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kb.render_frame(
            torch.empty(x["d_geo"].shape, dtype=torch.bfloat16, device=meta),
            None, None, torch.empty(x["dnorm"].shape, device=meta),
            torch.empty(x["dclip"].shape, device=meta),
            torch.empty(x["ur"].shape, device=meta),
            torch.empty(x["vr"].shape, device=meta), None,
            [float(v) for v in x["scalars"]],
            torch.empty(x["activity"].shape, dtype=torch.int32,
                        device=meta), has_mlp=False, rgb_mode="direct")


def _sweep_inputs(seed=3):
    """The setup of the JAX package's train-sweep kernel test."""
    rng = np.random.default_rng(seed)
    gp, gu, gv, c, k = 9, 16, 24, 5, 2
    n = pst.NT
    grid = rng.normal(size=(gp, gu, gv, c)).astype(np.float32)
    rays = np.stack([
        rng.uniform(-2, gp + 2, n), rng.uniform(-1, gu, n),
        rng.uniform(-1, gv, n),
        rng.uniform(0.3, 1.0, n) * rng.choice([-1.0, 1.0], n),
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)]
    ).astype(np.float32)
    return grid, rays, k


def _sweep_port(grid, rays, k, dtype):
    slabs = torch_sweep._station_slabs(torch.tensor(grid).to(dtype), k)
    return ka.sweep_fwd(slabs.contiguous(), torch.tensor(rays), k).numpy()


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_bf16", "xla_f32"])
def test_sweep_fwd_plain_matches_jax(ref):
    grid, rays, k = _sweep_inputs()
    gp, gu, gv, c = grid.shape
    s = k * (gp - 1) + 1
    rays_j = [jnp.asarray(r) for r in rays]
    rays_pv = (tuple(rays_j[:3]), tuple(rays_j[3:]))
    dtype = torch.float32 if ref == "xla_f32" else torch.bfloat16
    out = _sweep_port(grid, rays, k, dtype)                    # [S, C, N]
    if ref == "pallas_interpret":
        grid_p, cp = pst.pad_channels(
            jnp.asarray(grid.reshape(gp, gu, gv * c), jnp.bfloat16), c)
        slabs = jax_sweep._station_slabs(grid_p, k)
        s_pad = pst._round_up(s, pst.S_BLK)
        slabs = jnp.concatenate(
            [slabs, jnp.zeros((s_pad - s, gu, gv * cp), slabs.dtype)])
        rp = jnp.concatenate([jnp.asarray(rays),
                              jnp.zeros((2, rays.shape[1]), jnp.float32)])
        ref_vals = np.asarray(pst.sweep_fwd_pallas(
            slabs, rp, c=c, cp=cp, k=k, gu=gu, gv=gv, interpret=True))[:s]
        tol = 1e-2    # the JAX package's own kernel-vs-scan bound
    else:
        jdt = jnp.float32 if ref == "xla_f32" else jnp.bfloat16
        vals, _ = jax_sweep._sweep_fwd_impl(
            jnp.asarray(grid.reshape(gp, gu, gv * c), jdt), rays_pv, c, k,
            (gu, gv), jdt)
        ref_vals = np.transpose(np.asarray(vals), (2, 0, 1))
        # bf16: the same rounded hat rows and exact bf16 products; f32: sums
        # of at most four taps in another order.
        tol = 1e-2 if ref == "xla_bf16" else 1e-5
    assert out.shape == ref_vals.shape
    assert np.abs(out - ref_vals).max() < tol
    # Hat semantics, not clamping: taps beyond one voxel of the slab are 0.
    assert np.abs(out).max() > 0.1


def test_sweep_fwd_reads_zero_off_the_slab():
    grid, rays, k = _sweep_inputs(4)
    gp, gu, gv, _ = grid.shape
    rays[1] = gu + 1.5          # u beyond the last index by more than 1
    rays[4] = 0.0
    out = _sweep_port(grid, rays, k, torch.float32)
    assert np.all(out == 0.0)
    rays[1] = -0.25             # u in (-1, 0) still weights index 0
    out = _sweep_port(grid, rays, k, torch.float32)
    assert np.abs(out).max() > 0.0


def test_kernel_signatures_match_their_c_prototypes(monkeypatch):
    """Each wrapper declares every C function's ctypes signature; the
    argument counts follow the ``extern "C"`` prototypes in ``csrc/``."""
    import re
    import types
    from directvoxgo_tpu_torch.ops import _build

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
    # K-A and K-C keep their library once declared: drop it around the fake
    ka._lib.cache_clear()
    kc._lib.cache_clear()
    from directvoxgo_tpu_torch.ops import probe_ops as kg
    from directvoxgo_tpu_torch.ops import train_fused as kde
    from directvoxgo_tpu_torch.ops import tv as kf
    import chip_smoke
    prev = [lambda name=name: chip_smoke._prev_lib(name)[0]
            for name in chip_smoke.PREV_KERNELS]
    for load_lib in (ka._lib, kb._lib, kc._lib, kde._lib_fwd, kde._lib_bwd,
                     kf._lib, kg._lib, *prev):
        lib = load_lib()
        assert lib.prototypes
        for fn, params in lib.prototypes.items():
            n = len([p for p in params.split(",") if p.strip()])
            assert len(getattr(lib, fn).argtypes) == n, fn
            assert getattr(lib, fn).restype is not None, fn
    # K-A and K-C: every entry point of the redesign is declared (and the
    # first versions' above, which chip_smoke.py times beside them).
    assert set(ka._lib().prototypes) == {
        "dvgo_error_string", "dvgo_sweep_fwd_max_channels", "dvgo_sweep_fwd"}
    assert set(kc._lib().prototypes) == {
        "dvgo_error_string", "dvgo_sweep_bwd_max_channels",
        "dvgo_sweep_bwd_limits", "dvgo_sweep_bwd", "dvgo_sweep_bwd_finish"}
    assert len(ka._lib().dvgo_sweep_fwd.argtypes) == 16
    assert len(kc._lib().dvgo_sweep_bwd.argtypes) == 23
    ka._lib.cache_clear()
    kc._lib.cache_clear()


def test_packed_mlp_follows_the_weights():
    """K-B's packed MLP buffer is reused for the same weights and repacked
    after they change in place."""
    g = torch.Generator().manual_seed(0)
    layers = [(torch.randn((d_in, d_out), generator=g), torch.randn(
        d_out, generator=g)) for d_in, d_out in ((9, 8), (8, 8), (8, 3))]
    buf = kb._packed_mlp(layers, 6)
    assert kb._packed_mlp(list(layers), 6) is buf
    assert torch.equal(buf, kb.pack_mlp(layers, 6))
    layers[1][0].mul_(2.0)
    again = kb._packed_mlp(layers, 6)
    assert again is not buf and torch.equal(again, kb.pack_mlp(layers, 6))
