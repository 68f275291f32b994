"""The port's configs, rays, data and checkpoints against the JAX package's,
and the port's independence from JAX."""

import importlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from directvoxgo_tpu import config as jax_config
from directvoxgo_tpu import rays as jax_rays
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu_torch import config as torch_config
from directvoxgo_tpu_torch import rays as torch_rays
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO

# (each data package's __init__ re-exports the function load_data)
jax_load_data = importlib.import_module("directvoxgo_tpu.data.load_data")
torch_load_data = importlib.import_module(
    "directvoxgo_tpu_torch.data.load_data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids idle spinning of the
    thread pool next to the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(a, b, path="root"):
    """Recursive equality of dicts, lists and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("cfg", ["nerf/lego.py",
                                 "synthetic/fixture_lego_sparse.py",
                                 "synthetic/fixture_tiny.py"])
def test_config_matches_jax(cfg):
    path = os.path.join(REPO, "configs", cfg)
    _assert_same(dict(torch_config.Config.fromfile(path)),
                 dict(jax_config.Config.fromfile(path)))


@pytest.mark.parametrize("inverse_y,flip_x,flip_y,ndc", [
    (False, False, False, False), (True, True, False, False),
    (False, False, True, True)])
def test_rays_match_jax(inverse_y, flip_x, flip_y, ndc):
    rng = np.random.default_rng(0)
    H, W = 12, 17
    K = np.array([[20.0, 0, 8.5], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1)) - [[0], [0], [4]]],
                         1).astype(np.float32)
    _assert_same(
        torch_rays.get_rays_of_a_view(H, W, K, c2w, ndc, inverse_y, flip_x,
                                      flip_y),
        tuple(np.asarray(x) for x in jax_rays.get_rays_of_a_view(
            H, W, K, c2w, ndc, inverse_y, flip_x, flip_y)))


def test_fixture_data_matches_jax():
    cfg = jax_config.Config.fromfile(os.path.join(
        REPO, "configs", "synthetic", "fixture_lego_sparse.py"))
    _assert_same(torch_load_data.load_everything(None, cfg),
                 jax_load_data.load_everything(None, cfg))


def test_blender_data_matches_jax(tmp_path):
    """A two-views-per-split nerf_synthetic layout written on the fly."""
    import imageio.v2 as imageio
    rng = np.random.default_rng(1)
    for split in ("train", "val", "test"):
        frames = []
        for i in range(2):
            name = f"{split}/r_{i}"
            os.makedirs(tmp_path / split, exist_ok=True)
            imageio.imwrite(tmp_path / f"{name}.png", rng.integers(
                0, 256, (8, 8, 4), dtype=np.uint8))
            frames.append({"file_path": f"./{name}", "transform_matrix":
                           rng.normal(size=(4, 4)).tolist()})
        (tmp_path / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.69, "frames": frames}))
    args = jax_config.ConfigDict(
        dataset_type="blender", datadir=str(tmp_path), half_res=False,
        testskip=1, down=1, white_bkgd=True, task="")
    _assert_same(torch_load_data.load_data(args),
                 jax_load_data.load_data(args))


@pytest.mark.parametrize("bounds,quantum", [
    (([-1, -1, -1], [1, 1, 1]), 8),
    (([-0.67, -1.15, -0.38], [0.66, 1.2, 1.05]), 8),
    (([-0.67, -1.15, -0.38], [0.66, 1.2, 1.05]), 1)])
def test_world_size_of_lego_fine_kwargs(bounds, quantum):
    """The grid resolution of the lego fine stage (160^3 voxels), without
    allocating either model's grids."""
    cfg = jax_config.Config.fromfile(os.path.join(REPO, "configs", "nerf",
                                                  "lego.py"))
    num_voxels = cfg.fine_model_and_render.num_voxels
    sizes = []
    for cls in (JaxDVGO, TorchDVGO):
        obj = types.SimpleNamespace(
            xyz_min=np.asarray(bounds[0], np.float32),
            xyz_max=np.asarray(bounds[1], np.float32),
            world_size_quantum=quantum, voxel_size_base=0.0125)
        cls._set_grid_resolution(obj, num_voxels)
        sizes.append((obj.world_size, obj.voxel_size_ratio))
    assert sizes[0] == sizes[1]
    if quantum > 1:
        assert all(v % quantum == 0 for v in sizes[0][0])


def _jax_model(n, seed=0):
    rng = np.random.default_rng(seed)
    model = JaxDVGO(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                    num_voxels=n ** 3, num_voxels_base=n ** 3,
                    alpha_init=1e-2, fast_color_thres=1e-4, rgbnet_dim=6,
                    rgbnet_direct=False, rgbnet_width=16,
                    world_size_quantum=8, sweep_color_topk=48)
    model.params["density"] = jnp.asarray(
        rng.normal(size=model.world_size).astype(np.float32))
    model.params["k0"] = jnp.asarray(
        rng.normal(size=model.params["k0"].shape).astype(np.float32))
    model.update_occupancy_cache()
    return model


def test_checkpoint_jax_to_port(tmp_path):
    jm = _jax_model(20)
    path = str(tmp_path / "fine_last.tar")
    jax_ckpt.save_model_checkpoint(path, jm, 7)
    tm = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    assert tm.world_size == jm.world_size
    assert tm.get_kwargs().keys() == jm.get_kwargs().keys()
    np.testing.assert_array_equal(tm.density.detach().numpy(),
                                  np.asarray(jm.params["density"]))
    np.testing.assert_array_equal(tm.k0.detach().numpy(),
                                  np.asarray(jm.params["k0"]))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(tm.grid_points().numpy(),
                                  np.asarray(jm.grid_points()))
    for layer, jl in zip(tm.rgbnet.layers, jm.params["rgbnet"]["layers"]):
        # nn.Linear's [out, in] is the JAX [in, out] transposed once
        np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                      np.asarray(jl["w"]))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(jl["b"]))


def test_checkpoint_port_to_jax_compact(tmp_path):
    """A port checkpoint with its big grid stored as float16 loads in the
    JAX package, re-widened to float32."""
    tm = TorchDVGO(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                   num_voxels=104 ** 3, num_voxels_base=104 ** 3,
                   alpha_init=1e-2, rgbnet_dim=3, rgbnet_direct=True,
                   rgbnet_width=16, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        tm.density.copy_(torch.randn(tm.density.shape, generator=g))
        tm.k0.copy_(torch.randn(tm.k0.shape, generator=g))
        tm.mask.copy_(tm.density > 0)
    assert tm.k0.numel() >= torch_ckpt._COMPACT_MIN_ELEMS
    path = str(tmp_path / "fine_last.tar")
    torch_ckpt.save_model_checkpoint(path, tm, 3, compact=True)
    raw = torch_ckpt._RestrictedUnpickler(open(path, "rb")).load()
    assert raw["model_state_dict"]["k0"].dtype == np.float16
    jm = jax_ckpt.load_model(JaxDVGO, path)
    assert jm.world_size == tm.world_size
    np.testing.assert_array_equal(
        np.asarray(jm.params["k0"]),
        tm.k0.detach().numpy().astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jm.mask), tm.mask.numpy())
    for layer, jl in zip(tm.rgbnet.layers, jm.params["rgbnet"]["layers"]):
        np.testing.assert_array_equal(np.asarray(jl["w"]),
                                      layer.weight.detach().numpy().T)
    # and back into the port
    tm2 = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    np.testing.assert_array_equal(tm2.k0.detach().numpy(),
                                  np.asarray(jm.params["k0"]))


def test_checkpoint_half_casts_match_numpy():
    """The compaction's float32 -> float16 cast and the load's widening
    give numpy's ``astype`` bit for bit: normal, subnormal, overflowing,
    halfway and signed-zero values."""
    rng = np.random.default_rng(3)
    # big enough to be compacted (_COMPACT_MIN_ELEMS)
    x = np.concatenate([
        rng.normal(0, 3, 1_000_000), rng.normal(0, 1e-6, 10_000),
        [0.0, -0.0, 6.5e4, 6.6e4, -1e6, np.inf, -np.inf, 2.0 ** -25,
         2.0 ** -24, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11]]).astype(
        np.float32)
    half = torch_ckpt._compact({"g": x})["g"]
    assert half.dtype == np.float16
    np.testing.assert_array_equal(half.view(np.uint16),
                                  x.astype(np.float16).view(np.uint16))
    wide = torch_ckpt._restore_f32({"g": half})["g"]
    np.testing.assert_array_equal(wide.view(np.uint32),
                                  half.astype(np.float32).view(np.uint32))


def test_checkpoint_loader_refuses_code(tmp_path):
    path = tmp_path / "evil.tar"
    import pickle
    path.write_bytes(pickle.dumps({"x": os.system}))
    with pytest.raises(pickle.UnpicklingError):
        torch_ckpt.load_checkpoint_file(str(path))


# the conditioned and multi-scene slice: models, engine, data, drivers
CONDITIONED_MODULES = (
    "ops.resize", "models.backbone", "models.nets", "models.tri_dvgo",
    "models.sr_dvgo", "models.multiscene_dvgo", "models.dvgo_multiscene",
    "models.tri_dvgo_multiscene", "engine.train_conditioned",
    "engine.render_conditioned", "data.datasets", "run_tri", "run_sr",
    "run_multiscene", "run_tri_multiscene_v2", "run_tri_multiscene",
    # the remaining loaders, their image files and the scene writers
    "data.image_io", "data.load_nsvf", "data.load_blendedmvs",
    "data.load_tankstemple", "data.load_deepvoxels", "data.load_co3d",
    "tools.scene_layouts",
    # data parallelism, the fetch watchdog and its restart wrapper
    "parallel", "parallel.mesh", "engine.fetchguard", "tools.resilient_run",
    "tools.check_data_parallel",
    # the last entry points and the JPEG decoder
    "eval_metrics", "tools.visualize_feature", "tools.crop_image",
    "data.jpeg")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import directvoxgo_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'directvoxgo_tpu'\n"
        "       or m.startswith('directvoxgo_tpu.')\n"
        "       or (m.startswith('jax') and sys.modules[m] is not None)]\n"
        "print('loaded', len([m for m in sys.modules\n"
        "                     if m.startswith('directvoxgo_tpu_torch')]))\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {CONDITIONED_MODULES!r}\n"
        "           if 'directvoxgo_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 15


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "directvoxgo_tpu." not in src
