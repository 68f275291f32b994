"""K-B's exact forms of the v1 and v3 frame kernels, through their plain
PyTorch versions on the CPU, against the JAX package's
``render_frame_pallas`` (v1) and ``render_frame_pallas3`` (v3) in interpret
mode; and the port's frame-kernel harness against the JAX one's inputs.

The v1 form contracts the colour slabs ``au`` first and takes the bf16 view
term ``shared1``; the v3 form contracts ``av`` first and takes ``shared1``.
Both are held to the v4 test's bounds (``test_torch_kernels.py``): rgb and
T to 1e-4, depth to 1e-3 relative. Inputs are made once with numpy from a
seed and handed to both packages.
"""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.ops.pallas_render import render_frame_pallas
from directvoxgo_tpu.ops.pallas_render3 import render_frame_pallas3
from directvoxgo_tpu_torch.ops import render_frame as kb
from directvoxgo_tpu_torch.tools import bench_framekernel as port_bench

GU, GV, WIDTH = 24, 24, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, tiles, s_total, f_k0, has_mlp, rgb_mode, sign):
    """One frame in the v1/v3 kernels' layouts, as numpy arrays."""
    rng = np.random.default_rng(seed)
    hi, wi = tiles[0] * kb.TILE, tiles[1] * kb.TILE
    dens = rng.normal(0.0, 4.0, (s_total, GU, GV)).astype(np.float32)
    mask = (rng.uniform(size=(s_total, GU, GV)) < 0.85).astype(np.float32)
    d_k0 = rng.normal(size=(s_total, f_k0, GU, GV)).astype(np.float32)
    ur = np.linspace(-4.0, GU + 3.0, hi).astype(np.float32)
    vr = np.linspace(-4.0, GV + 3.0, wi).astype(np.float32)
    dnorm = (30.0 + rng.uniform(size=(hi, wi))).astype(np.float32)
    dclip = (dnorm * (0.9 + 0.1 * rng.uniform(size=(hi, wi)))
             ).astype(np.float32)
    f_mlp = f_k0 - (3 if rgb_mode == "logit_plus_k0" else 0)
    dims = [f_mlp, WIDTH, WIDTH, 3]
    mlp = {}
    for i, (w, b) in enumerate((("w1a", None), ("w2", "b2"), ("w3", "b3"))):
        mlp[w] = (rng.uniform(-1, 1, (dims[i], dims[i + 1]))
                  / np.sqrt(dims[i])).astype(np.float32)
        if b:
            mlp[b] = rng.uniform(-0.1, 0.1, dims[i + 1]).astype(np.float32)
    shared1 = rng.normal(0.0, 0.5, (hi, wi, WIDTH)).astype(np.float32)
    activity = (rng.uniform(size=(tiles[0], tiles[1], s_total // kb.S_BLK))
                < 0.8).astype(np.int32)
    op, p_ref = -20.0, float(s_total - 1) / 2.0
    p_first, p_step = (0.0, 0.5) if sign > 0 else ((s_total - 1) / 2.0, -0.5)
    scalars = np.asarray([op, GU / 2.0, GV / 2.0, 1.0 / (p_ref - op),
                          p_first, p_step, -4.6, 0.02, 1e-4, 20.0, 60.0,
                          1.0], np.float32)
    return dict(d_geo=np.concatenate([dens, mask], axis=2), d_k0=d_k0,
                shared1=shared1, dnorm=dnorm, dclip=dclip, ur=ur, vr=vr,
                mlp=mlp, scalars=scalars, activity=activity,
                has_mlp=has_mlp, rgb_mode=rgb_mode)


def _port(x, version):
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    t = torch.tensor
    s_total, f_k0 = x["d_k0"].shape[:2]
    mlp = ({k: t(v) for k, v in x["mlp"].items()} if x["has_mlp"]
           else None)
    shared1 = bf(x["shared1"]) if x["has_mlp"] else None
    common = (t(x["dnorm"]), t(x["dclip"]), t(x["ur"]), t(x["vr"]), mlp,
              [float(v) for v in x["scalars"]])
    kw = dict(guv=(GU, GV), has_mlp=x["has_mlp"], rgb_mode=x["rgb_mode"])
    if version == 1:
        out = kb.render_frame_v1(bf(x["d_geo"]), bf(x["d_k0"]), shared1,
                                 *common, **kw)
    else:
        d_k0t = bf(x["d_k0"].reshape(s_total, f_k0 * GU, GV))
        rgb, depth, tcum = kb.render_frame_v3(
            bf(x["d_geo"]), d_k0t, shared1, *common,
            activity=t(x["activity"]), **kw)
        out = rgb.permute(1, 2, 0), depth, tcum
    return [o.numpy() for o in out]


def _jax(x, version):
    bf = jnp.bfloat16
    s_total, f_k0 = x["d_k0"].shape[:2]
    mlp = ({k: jnp.asarray(v) for k, v in x["mlp"].items()}
           if x["has_mlp"] else None)
    shared1 = jnp.asarray(x["shared1"], bf) if x["has_mlp"] else None
    common = (jnp.asarray(x["dnorm"]), jnp.asarray(x["dclip"]),
              jnp.asarray(x["ur"]), jnp.asarray(x["vr"]), mlp,
              jnp.asarray(x["scalars"]))
    kw = dict(guv=(GU, GV), has_mlp=x["has_mlp"], rgb_mode=x["rgb_mode"],
              interpret=True)
    if version == 1:
        out = render_frame_pallas(jnp.asarray(x["d_geo"], bf),
                                  jnp.asarray(x["d_k0"], bf), shared1,
                                  *common, **kw)
    else:
        d_k0t = jnp.asarray(x["d_k0"].reshape(s_total, f_k0 * GU, GV), bf)
        rgb, depth, tcum = render_frame_pallas3(
            jnp.asarray(x["d_geo"], bf), d_k0t, shared1, *common,
            activity=jnp.asarray(x["activity"]), **kw)
        out = jnp.transpose(rgb, (1, 2, 0)), depth, tcum
    return [np.asarray(o) for o in out]


def _assert_close(port, ref):
    rgb, depth, tcum = port
    rgb_r, depth_r, tcum_r = ref
    assert rgb.shape == rgb_r.shape
    # The frame must be neither empty nor opaque.
    assert 0.01 < float((tcum_r < 0.5).mean()) < 0.95
    # Same rounding points and sums of two nonzero terms in the warps; the
    # MLP's f32 sums and the exp/log1p ulps of two libraries differ.
    assert np.abs(rgb - rgb_r).max() < 1e-4
    assert np.abs(tcum - tcum_r).max() < 1e-4
    assert (np.abs(depth - depth_r) / np.maximum(1.0, np.abs(depth_r))
            ).max() < 1e-3


V1_CASES = [
    # (tiles, S, F, has_mlp, rgb_mode, march sign)
    ((1, 1), 32, 12, True, "direct", 1),
    ((1, 2), 32, 6, True, "logit_plus_k0", -1),
    ((1, 1), 32, 3, False, "direct", -1),
    ((1, 1), 24, 12, True, "direct", -1),       # S not a multiple of 16
    ((2, 1), 24, 9, True, "logit_plus_k0", 1),
]


@pytest.mark.parametrize("tiles,s_total,f_k0,has_mlp,rgb_mode,sign",
                         V1_CASES)
def test_v1_form_plain_matches_pallas(tiles, s_total, f_k0, has_mlp,
                                      rgb_mode, sign):
    x = _inputs(10 + s_total, tiles, s_total, f_k0, has_mlp, rgb_mode, sign)
    _assert_close(_port(x, 1), _jax(x, 1))


@pytest.mark.parametrize("tiles,f_k0,rgb_mode,sign", [
    ((1, 1), 12, "direct", 1),
    ((1, 2), 6, "logit_plus_k0", -1),
])
def test_v3_shared1_form_plain_matches_pallas3(tiles, f_k0, rgb_mode, sign):
    x = _inputs(20, tiles, 32, f_k0, True, rgb_mode, sign)
    _assert_close(_port(x, 3), _jax(x, 3))


def test_v1_forms_differ_where_the_kernels_do():
    """v1 and v3 differ only in the k0 contraction order: on the same
    inputs the port's two forms differ (not trivially equal) but agree to
    the JAX harness's 2e-2."""
    x = _inputs(30, (1, 1), 32, 12, True, "direct", 1)
    rgb1 = _port(x, 1)[0]
    rgb3 = _port(dict(x, activity=np.ones_like(x["activity"])), 3)[0]
    err = np.abs(rgb1 - rgb3).max()
    assert 0.0 < err < 2e-2 * np.abs(rgb1).max()


def test_v1_needs_a_colour_grid():
    x = _inputs(40, (1, 1), 16, 3, False, "direct", 1)
    t = torch.tensor
    with pytest.raises(ValueError):
        kb.render_frame_v1(
            t(x["d_geo"]).to(torch.bfloat16), None, None, t(x["dnorm"]),
            t(x["dclip"]), t(x["ur"]), t(x["vr"]), None,
            [float(v) for v in x["scalars"]], guv=(GU, GV), has_mlp=False,
            rgb_mode="direct")


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_framekernel",
        os.path.join(REPO, "tools", "bench_framekernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rgb_mode,has_mlp", port_bench.CHECK_MODES)
def test_make_case_matches_the_jax_harness(rgb_mode, has_mlp):
    ref = _jax_harness().make_case(*port_bench.CHECK_SHAPE, has_mlp=has_mlp,
                                   rgb_mode=rgb_mode, occupancy=0.15)
    got = port_bench.make_case(*port_bench.CHECK_SHAPE, has_mlp=has_mlp,
                               rgb_mode=rgb_mode, occupancy=0.15)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "mlp":
            assert set(got[k]) == set(v)
            for n, w in v.items():
                np.testing.assert_array_equal(got[k][n].numpy(),
                                              np.asarray(w))
        elif k in ("guv", "has_mlp", "rgb_mode"):
            assert got[k] == v
        else:
            assert got[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16
                                    else torch.float32), k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(v, np.float32), err_msg=k)
