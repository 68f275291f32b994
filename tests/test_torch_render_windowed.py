"""The port's windowed NDC renders on the CPU: per-ray Morton-segment
windows (``_render_rays_windowed_2d``, taken by ``render_rays_chunked``
for forced-axis models) and whole-frame pixel tiles
(``render_frame_ndc_tiles``, the ``"tiles"`` path of
``render_viewpoints``), each against the port's plain chunked render and
against the JAX package's windowed render on the same grids.

Windows are exact, so the tolerance is the JAX package's own for the same
comparison, 2e-3 on rgb and depth (``tests/test_render_windowed.py``);
both packages sweep in f32 here (the parity mode).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu import rays as jax_rays
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.models.dmpigo import DirectMPIGO as JaxMPIGO
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.engine import render as torch_render
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO as TorchMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO

H = W = 48
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
C2W = np.eye(4, dtype=np.float32)[:3]
RK = dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    jm = JaxMPIGO(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                  num_voxels=96 * 96 * 48, mpi_depth=48,
                  fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=32,
                  viewbase_pe=4, k_color=8, seed=3)
    rng = np.random.default_rng(11)
    # structured grids, so that a misplaced window shows
    jm.params["density"] = jnp.asarray(rng.normal(
        0.0, 1.5, jm.params["density"].shape).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0.0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    tm = TorchMPIGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), np.asarray(jm.mask)))
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    ro, rd, vd = (np.asarray(x).reshape(-1, 3).astype(np.float32)
                  for x in jax_rays.get_rays_of_a_view(
                      H, W, K, C2W, ndc=True, inverse_y=False,
                      flip_x=False, flip_y=False))
    return jm, tm, ro, rd, vd


def _port(tm, rays, chunk, monkeypatch, min_plane):
    monkeypatch.setattr(torch_render, "WINDOWED_RENDER_MIN_PLANE", min_plane)
    return torch_render.render_rays_chunked(
        torch_render.make_render_fn(tm, RK), tm, *rays, chunk)


def _jax(jm, rays, chunk, monkeypatch, min_plane):
    monkeypatch.setattr(jax_render, "WINDOWED_RENDER_MIN_PLANE", min_plane)
    return jax_render.render_rays_chunked(
        jax_render.make_render_fn(jm, RK), jm, *rays, chunk)


def _close(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n", [H * W, 512 * 3 + 197])
def test_windowed_chunks_match_plain_and_jax(scene, monkeypatch, n):
    """The whole frame, and a ray count that is no multiple of the chunk
    (the rays padded with copies of ray 0, classed like real rays and
    dropped after)."""
    jm, tm, *rays = scene
    rays = [a[:n] for a in rays]
    calls = []
    orig = torch_render._render_rays_windowed_2d

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(torch_render, "_render_rays_windowed_2d", spy)
    plain = _port(tm, rays, 512, monkeypatch, 10 ** 9)
    windowed = _port(tm, rays, 512, monkeypatch, 0)
    assert calls == [False, True]
    assert windowed[0].shape == (n, 3) and windowed[1].shape == (n,)
    _close(windowed, plain)
    _close(windowed, _jax(jm, rays, 512, monkeypatch, 0))


def test_windowed_gate_respects_min_plane(scene, monkeypatch):
    """Below the plane-area gate both windowed renders decline."""
    jm, tm, ro, rd, vd = scene
    monkeypatch.setattr(torch_render, "WINDOWED_RENDER_MIN_PLANE", 10 ** 9)
    fn = torch_render.make_render_fn(tm, RK)
    assert torch_render._render_rays_windowed_2d(
        fn, tm, ro[:512], rd[:512], vd[:512], 512, 2) is None
    assert torch_render.render_frame_ndc_tiles(
        fn, tm, H, W, K, C2W, RK, chunk=512, tile_hw=(16, 32)) is None


def test_ndc_tiles_match_chunked_and_jax(scene, monkeypatch):
    """The frame as 16x32 pixel tiles (rays made by the port in torch)
    against the plain chunks and the JAX package's tiles."""
    jm, tm, *rays = scene
    plain = _port(tm, rays, 512, monkeypatch, 10 ** 9)
    monkeypatch.setattr(torch_render, "WINDOWED_RENDER_MIN_PLANE", 0)
    monkeypatch.setattr(jax_render, "WINDOWED_RENDER_MIN_PLANE", 0)
    kw = dict(chunk=512, tile_hw=(16, 32), widths=(8, 16, 24, 48))
    tiles = torch_render.render_frame_ndc_tiles(
        torch_render.make_render_fn(tm, RK), tm, H, W, K, C2W, RK, **kw)
    assert tiles is not None
    assert tiles[0].shape == (H * W, 3) and tiles[1].shape == (H * W,)
    _close(tiles, plain)
    _close(tiles, jax_render.render_frame_ndc_tiles(
        jax_render.make_render_fn(jm, RK), jm, H, W, K, C2W, RK, **kw))


def test_ndc_rays_made_in_torch_match_numpy():
    """The tiles' rays, made with torch, against the host's numpy rays."""
    for flips in ((False, False), (True, False), (False, True)):
        want = [np.asarray(x).reshape(-1, 3) for x in
                jax_rays.get_rays_of_a_view(H, W, K, C2W, True, False,
                                            *flips)]
        got = torch_render.rays_of_view_ndc(K, C2W, H, W, False, *flips,
                                            "cpu")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_render_viewpoints_reports_the_tiles_path(scene, monkeypatch):
    """An NDC view takes the tiles where they engage, else per-ray chunks,
    and says which."""
    jm, tm, *rays = scene
    args = (tm, np.stack([np.eye(4, dtype=np.float32)]), np.array([[H, W]]),
            K[None], True, dict(RK, inverse_y=False))
    monkeypatch.setattr(torch_render, "WINDOWED_RENDER_MIN_PLANE", 0)
    rgb_t, _, st_t = torch_render.render_viewpoints(*args, chunk=512,
                                                    verbose=False)
    monkeypatch.setattr(torch_render, "WINDOWED_RENDER_MIN_PLANE", 10 ** 9)
    rgb_r, _, st_r = torch_render.render_viewpoints(*args, chunk=512,
                                                    verbose=False)
    assert st_t["path"] == ["tiles"] and st_r["path"] == ["rays"]
    np.testing.assert_allclose(rgb_t, rgb_r, atol=2e-3, rtol=0)


def test_models_without_a_forced_axis_decline():
    """A perspective model (no forced sweep axis) takes neither windowed
    render."""
    tm = TorchDVGO(xyz_min=[-1] * 3, xyz_max=[1] * 3, num_voxels=16 ** 3,
                   num_voxels_base=16 ** 3, alpha_init=1e-2, device="cpu")
    assert torch_render.render_frame_ndc_tiles(
        None, tm, H, W, K, C2W, RK) is None

    class _NoSweep:
        forced_sweep_axis = None
    assert torch_render.render_frame_ndc_tiles(
        None, _NoSweep(), H, W, K, C2W, RK) is None
