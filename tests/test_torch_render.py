"""The port's render path against the JAX package on the CPU: the per-ray
``forward_sweep``, whole views through both packages' ``render_viewpoints``
from one checkpoint, and the port's driver on the tiny fixture.

The JAX frame path runs its Pallas kernel in interpret mode; the port runs
its kernels' plain versions (CPU tensors).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu.data import synthetic as jax_synthetic
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import render as jax_render
from directvoxgo_tpu.engine import render_sweep as jax_render_sweep
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.engine import render as torch_render
from directvoxgo_tpu_torch.engine import render_sweep as torch_render_sweep
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RK = dict(near=2.0, far=6.0, bg=1.0, stepsize=0.5, inverse_y=False,
          flip_x=False, flip_y=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids idle spinning of the
    thread pool next to the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    return -10.0 * np.log10(np.mean((a - b) ** 2) + 1e-20)


def _jax_model(seed, rgbnet_dim, rgbnet_direct, grid_kw, density_fn,
               topk=0):
    rng = np.random.default_rng(seed)
    model = JaxDVGO(alpha_init=1e-2, fast_color_thres=1e-4,
                    rgbnet_dim=rgbnet_dim, rgbnet_direct=rgbnet_direct,
                    rgbnet_depth=3, rgbnet_width=32, k_density=None,
                    k_color=0, sweep_color_topk=topk, **grid_kw)
    pts = np.asarray(model.grid_points())
    model.params["density"] = jnp.asarray(
        (density_fn(pts) + rng.normal(0, 0.5, pts.shape[:3])
         ).astype(np.float32))
    model.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, model.params["k0"].shape).astype(np.float32))
    model.update_occupancy_cache()
    return model


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A small JAX fine model saved in the checkpoint format."""
    model = _jax_model(
        0, 6, True, dict(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                         num_voxels=40 ** 3, num_voxels_base=40 ** 3),
        lambda p: 10.0 * np.exp(-4.0 * (p ** 2).sum(-1)) - 3.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "fine_small.tar")
    jax_ckpt.save_model_checkpoint(path, model, 0)
    return model, path


@pytest.mark.parametrize("mode", ["direct", "logit_plus_k0", "coarse"])
def test_forward_sweep_matches_jax_f32(mode):
    """A 64-deep grid clipped to its occupancy box, top-K compaction on,
    both packages in f32 parity mode (f32 slabs, f32 MLP)."""
    grid_kw = dict(xyz_min=[-1.6, -1.0, -0.5], xyz_max=[1.6, 1.0, 0.5],
                   num_voxels=64 * 40 * 20, num_voxels_base=64 * 40 * 20)
    rgbnet_dim = {"direct": 12, "logit_plus_k0": 12, "coarse": 0}[mode]
    jm = _jax_model(1, rgbnet_dim, mode == "direct", grid_kw, lambda p: (
        12.0 * np.exp(-(p[..., 0] / 1.1) ** 2 - (p[..., 1] / 0.35) ** 2
                      - (p[..., 2] / 0.3) ** 2) - 8.0), topk=48)
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), np.asarray(jm.mask)))
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    assert tm.world_size[0] >= 63

    axis = 0
    clip_sizes, clip_off = jm.sweep_clip_for_axis(axis)
    t_sizes, t_off = tm.sweep_clip_for_axis(axis)
    assert clip_sizes == t_sizes and np.array_equal(clip_off, t_off)
    assert clip_sizes is not None and 2 * (clip_sizes[0] - 1) + 1 > 96

    rng = np.random.default_rng(2)
    n = 1024
    ro = np.stack([np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0),
                   rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)],
                  -1).astype(np.float32)
    rd = np.stack([-np.sign(ro[:, 0]), rng.uniform(-0.15, 0.15, n),
                   rng.uniform(-0.15, 0.15, n)], -1).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    kw = dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5, render_depth=True)
    rj = jm.forward_sweep(jm.params, jm.mask, jnp.asarray(ro),
                          jnp.asarray(rd), jnp.asarray(vd), axis,
                          clip_sizes=clip_sizes,
                          clip_offsets=jnp.asarray(clip_off), **kw)
    rt = tm.forward_sweep(torch.tensor(ro), torch.tensor(rd),
                          torch.tensor(vd), axis, clip_sizes=t_sizes,
                          clip_offsets=t_off, **kw)
    rgb_j = np.asarray(rj["rgb_marched"])
    assert np.abs(rgb_j - 1.0).max() > 0.1        # rays hit the blob
    assert np.abs(rt["rgb_marched"].numpy() - rgb_j).max() < 2e-5
    assert np.abs(rt["alphainv_last"].numpy()
                  - np.asarray(rj["alphainv_last"])).max() < 2e-5
    assert np.abs(rt["depth"].numpy() - np.asarray(rj["depth"])).max() < 1e-3


def test_render_viewpoints_matches_jax(ckpt, monkeypatch):
    """One view the sweep plan accepts (frame kernel) and one it rejects
    (per-ray kernel), rendered by both packages from one checkpoint."""
    jm, path = ckpt
    tm = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    data = jax_synthetic.make_synthetic_dataset(H=64, W=64)
    plans = [torch_render_sweep.plan_camera_sweep(
        tm, 64, 64, data["Ks"][i], data["poses"][i], 2.0, 6.0)
        for i in range(len(data["poses"]))]
    accepted = [i for i, p in enumerate(plans) if p is not None]
    rejected = [i for i, p in enumerate(plans) if p is None]
    assert accepted and rejected
    views = [accepted[0], rejected[0]]
    for i in views:
        assert (jax_render_sweep.plan_camera_sweep(
            jm, 64, 64, data["Ks"][i], data["poses"][i], 2.0, 6.0)
            is None) == (plans[i] is None)
    monkeypatch.setattr(jax_render_sweep, "render_frame_sweep",
                        functools.partial(jax_render_sweep.render_frame_sweep,
                                          backend="pallas_interpret"))
    args = (data["poses"][views], data["HW"][views], data["Ks"][views],
            False, RK)
    rgb_j, dep_j, _ = jax_render.render_viewpoints(jm, *args, chunk=2048,
                                                   verbose=False)
    rgb_t, dep_t, stats = torch_render.render_viewpoints(
        tm, *args, chunk=2048, verbose=False)
    assert stats["path"] == ["frame", "rays"]
    for v in range(2):
        assert np.abs(rgb_j[v] - 1.0).max() > 0.1      # not an empty view
        assert _psnr(rgb_t[v], rgb_j[v]) >= 45.0, v


def test_driver_renders_fixture_tiny(ckpt, tmp_path):
    """``python -m directvoxgo_tpu_torch.run --render_only --render_test``
    on the tiny fixture, on the CPU."""
    _, path = ckpt
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "directvoxgo_tpu_torch.run", "--config",
         os.path.join(REPO, "configs", "synthetic", "fixture_tiny.py"),
         "--render_only", "--render_test", "--eval_ssim", "--device", "cpu",
         "--ft_path", path], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Testing psnr" in proc.stdout and "Testing ssim" in proc.stdout
    out = tmp_path / "logs" / "synthetic" / "fixture_tiny" / \
        "render_test_fine_small"
    assert sorted(p.name for p in out.glob("0*.png")) == [
        f"{i:03d}.png" for i in range(4)]


def test_entry_points_need_cuda_or_an_explicit_cpu(ckpt):
    """Without a card, the default device is refused, never replaced."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_ckpt.load_model(TorchDVGO, ckpt[1])


@pytest.mark.parametrize("gather_mode", ["onehot", "gather"])
def test_topk_station_select_matches_jax(gather_mode):
    """Per-ray top-K stations by weight, ties (the many zero weights) in
    ascending station order, in both selection forms."""
    from directvoxgo_tpu.ops import sweep as jax_sweep
    from directvoxgo_tpu_torch.ops import sweep as torch_sweep
    rng = np.random.default_rng(5)
    w = rng.uniform(size=(64, 40)).astype(np.float32)
    w[w < 0.6] = 0.0
    w[:, 7] = w[:, 3]                       # a tie between nonzero weights
    x = rng.normal(size=(5, 64, 40)).astype(np.float32)
    ij, nk_j, cl_j = jax_sweep.topk_station_select(jnp.asarray(w), 12,
                                                   gather_mode)
    it, nk_t, cl_t = torch_sweep.topk_station_select(torch.tensor(w), 12,
                                                     gather_mode)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(nk_t(torch.tensor(w)).numpy(),
                               np.asarray(nk_j(jnp.asarray(w))))
    # the JAX one-hot form selects through bf16; compare at that precision
    tol = 1e-2 if gather_mode == "onehot" else 0.0
    np.testing.assert_allclose(cl_t(torch.tensor(x)).numpy(),
                               np.asarray(cl_j(jnp.asarray(x))), atol=tol)


@pytest.mark.parametrize("change", ["density", "k0", "mask"])
def test_station_slab_caches_follow_the_grids(change):
    """The per-ray and whole-frame station slabs are built once and reused,
    and rebuilt after an in-place change of any grid or of the mask."""
    tm = TorchDVGO(xyz_min=[-1] * 3, xyz_max=[1] * 3, num_voxels=12 ** 3,
                   num_voxels_base=12 ** 3, alpha_init=1e-2, rgbnet_dim=6,
                   rgbnet_direct=True, rgbnet_width=8, device="cpu")

    def slabs():
        return (tm._sweep_slabs(0, 2, None, None),
                torch_render_sweep._get_render_slabs(tm, 1, -1.0, 2, 2, 20,
                                                     11))

    first = slabs()
    assert all(a is b for a, b in zip(slabs(), first))
    with torch.no_grad():
        if change == "mask":
            tm.mask.logical_not_()
        else:
            getattr(tm, change).add_(1.0)
    again = slabs()
    assert not any(a is b for a, b in zip(again, first))
    ch = {"density": 0, "mask": 1, "k0": 2}[change]
    assert not torch.equal(again[0][..., ch], first[0][..., ch])
