"""The port's driver flags and frame outputs against the JAX package's on
the CPU: the ``device_compact`` and ``device_yuv420`` frames (bit for bit
at even sizes; the whole I420 buffer at odd ones), the export flags' npz
files from one pair of checkpoints, ``--profile_dir``, the LPIPS gate, the
fixtures' ground truth rendered when it is not cached, and the one flag
still refused.
"""

import functools
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directvoxgo_tpu.data import synthetic as jax_synthetic
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.engine import metrics as jax_metrics
from directvoxgo_tpu.engine import render_sweep as jax_render_sweep
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu_torch import run as torch_run
from directvoxgo_tpu_torch.data import synthetic as t_synthetic
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.engine import metrics as t_metrics
from directvoxgo_tpu_torch.engine import render as torch_render
from directvoxgo_tpu_torch.engine import render_sweep as t_render_sweep
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "fixture_tiny.py")
RK = dict(near=2.0, far=6.0, bg=1.0, stepsize=0.5, inverse_y=False,
          flip_x=False, flip_y=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(n, rgbnet_dim, seed=0):
    rng = np.random.default_rng(seed)
    model = JaxDVGO(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                    num_voxels=n ** 3, num_voxels_base=n ** 3,
                    alpha_init=1e-2, fast_color_thres=1e-4,
                    rgbnet_dim=rgbnet_dim, rgbnet_direct=True,
                    rgbnet_depth=3, rgbnet_width=32, k_density=None,
                    k_color=0, sweep_color_topk=0)
    pts = np.asarray(model.grid_points())
    model.params["density"] = jnp.asarray(
        (10.0 * np.exp(-4.0 * (pts ** 2).sum(-1)) - 3.0
         + rng.normal(0, 0.5, pts.shape[:3])).astype(np.float32))
    model.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, model.params["k0"].shape).astype(np.float32))
    model.update_occupancy_cache()
    return model


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A small JAX fine model and the port's model from its checkpoint,
    with the 64^2 fixture's cameras."""
    jm = _jax_model(40, 6)
    path = str(tmp_path_factory.mktemp("ckpt") / "fine_last.tar")
    jax_ckpt.save_model_checkpoint(path, jm, 0)
    tm = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    data = jax_synthetic.make_synthetic_dataset(H=64, W=64)
    return jm, tm, data


def _accepted_view(tm, data, h, w):
    for i in range(len(data["poses"])):
        K = np.array(data["Ks"][i], np.float64)
        K[0] *= w / 64
        K[1] *= h / 64
        if t_render_sweep.plan_camera_sweep(tm, h, w, K, data["poses"][i],
                                            2.0, 6.0) is not None:
            return K, data["poses"][i]
    raise AssertionError("no view the sweep plan accepts")


def test_compact_and_yuv420_frames_match_jax(pair, monkeypatch):
    """At an even size the port's conversion of JAX's f32 frame gives
    JAX's uint8 rgb, f16 depth and I420 buffer bit for bit. JAX's warp
    sampler is replaced by one that returns fixed values in [-0.1, 1.1],
    so that the clipping and rounding meet every case."""
    jm, tm, data = pair
    h, w = 58, 62
    K, c2w = _accepted_view(tm, data, h, w)
    fake = np.random.default_rng(7).uniform(-0.1, 1.1, (h, w, 5)).astype(
        np.float32)
    from directvoxgo_tpu.ops import grid as jax_grid
    monkeypatch.setattr(jax_grid, "bilinear_sample_parts",
                        lambda packed, u, v: jnp.asarray(fake))
    fused = jax_render_sweep._render_frame_fused
    if hasattr(fused, "clear_cache"):
        fused.clear_cache()
    render = functools.partial(jax_render_sweep.render_frame_sweep, jm, h, w,
                               K, c2w, RK, backend="pallas_interpret")
    rgb, depth = (np.asarray(x) for x in render(output="device"))
    assert (rgb < 0).any() and (rgb > 1).any() and (rgb == 1.0).any()
    rgb8, depth16 = (np.asarray(x) for x in render(output="device_compact"))
    buf, depth16b = (np.asarray(x) for x in render(output="device_yuv420"))
    if hasattr(fused, "clear_cache"):
        fused.clear_cache()
    t_rgb, t_depth = torch.as_tensor(rgb), torch.as_tensor(depth)
    c_rgb, c_depth = t_render_sweep.frame_outputs(t_rgb, t_depth,
                                                  "device_compact")
    y_buf, y_depth = t_render_sweep.frame_outputs(t_rgb, t_depth,
                                                  "device_yuv420")
    assert c_rgb.dtype == torch.uint8 and c_depth.dtype == torch.float16
    np.testing.assert_array_equal(c_rgb.numpy(), rgb8)
    np.testing.assert_array_equal(c_depth.numpy().view(np.uint16),
                                  depth16.view(np.uint16))
    assert y_buf.shape == buf.shape == (h * w * 3 // 2,)
    np.testing.assert_array_equal(y_buf.numpy(), buf)
    np.testing.assert_array_equal(y_depth.numpy().view(np.uint16),
                                  depth16b.view(np.uint16))


@pytest.mark.parametrize("hw", [(58, 62), (57, 63)])
def test_port_frame_outputs_of_a_rendered_frame(pair, hw):
    """The port's frame in each output form against its f32 frame; at odd
    sizes the I420 buffer holds ``ceil(H/2) x ceil(W/2)`` chroma samples,
    the last row and column averaging the pixels they have."""
    _, tm, data = pair
    h, w = hw
    K, c2w = _accepted_view(tm, data, h, w)
    out = {o: t_render_sweep.render_frame_sweep(tm, h, w, K, c2w, RK,
                                                output=o)
           for o in t_render_sweep.OUTPUTS}
    rgb, depth = out["device"]
    np.testing.assert_array_equal(out["numpy"][0], rgb.numpy())
    assert np.abs(rgb.numpy() - 1.0).max() > 0.1       # not an empty frame
    np.testing.assert_array_equal(
        out["device_compact"][0].numpy(),
        np.round(np.clip(rgb.numpy(), 0, 1) * 255).astype(np.uint8))
    buf = out["device_yuv420"][0]
    h2, w2 = -(-h // 2), -(-w // 2)
    assert buf.dtype == torch.uint8 and buf.shape == (h * w + 2 * h2 * w2,)
    x = rgb.double().numpy()
    u = (-0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2]
         + 0.5)
    pad = np.full((2 * h2, 2 * w2), np.nan)
    pad[:h, :w] = u
    u_mean = np.nanmean(pad.reshape(h2, 2, w2, 2), (1, 3))
    u8 = np.round(np.clip(u_mean, 0, 1) * 255)
    got = buf[h * w:h * w + h2 * w2].numpy().reshape(h2, w2).astype(float)
    assert np.abs(got - u8).max() <= 1
    with pytest.raises(ValueError, match="output"):
        t_render_sweep.render_frame_sweep(tm, h, w, K, c2w, RK, output="x")


# ------------------------------------------------------------ the flags

def _load_jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_run_driver", os.path.join(REPO, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_config(tmp_path, **train):
    path = tmp_path / "tiny.py"
    coarse = dict(train.get("coarse", {}))
    fine = dict(train.get("fine", {}))
    path.write_text(f"_base_ = {TINY!r}\nexpname = 'tiny'\n"
                    f"basedir = {str(tmp_path / 'logs')!r}\n"
                    f"coarse_train = {coarse!r}\nfine_train = {fine!r}\n")
    return str(path)


def test_export_flags_match_the_jax_driver(tmp_path, monkeypatch):
    """``--export_bbox_and_cams_only``, ``--export_coarse_only`` and
    ``--export_fine_only`` write the JAX driver's npz keys and values from
    the same checkpoints (a JAX coarse one, a port fine one)."""
    cfg = _tiny_config(tmp_path)
    logdir = tmp_path / "logs" / "tiny"
    os.makedirs(logdir)
    jax_ckpt.save_model_checkpoint(str(logdir / "coarse_last.tar"),
                                   _jax_model(24, 0, seed=1), 5)
    fine = TorchDVGO(**_jax_model(32, 6, seed=2).get_kwargs(), device="cpu",
                     seed=3)
    with torch.no_grad():
        fine.density.normal_(0, 2, generator=torch.Generator().manual_seed(4))
    torch_ckpt.save_model_checkpoint(str(logdir / "fine_last.tar"), fine, 7)
    jax_run = _load_jax_driver()
    for flag in ("export_bbox_and_cams_only", "export_coarse_only",
                 "export_fine_only"):
        out_j, out_t = str(tmp_path / f"j_{flag}.npz"), str(
            tmp_path / f"t_{flag}.npz")
        monkeypatch.setattr(sys, "argv", ["run.py", "--config", cfg,
                                          f"--{flag}", out_j])
        with pytest.raises(SystemExit):
            jax_run.main()
        torch_run.main(["--config", cfg, f"--{flag}", out_t,
                        "--device", "cpu"])
        with np.load(out_j) as zj, np.load(out_t) as zt:
            assert set(zj.files) == set(zt.files)
            for k in zj.files:
                assert zj[k].shape == zt[k].shape, (flag, k)
                if k == "alpha":
                    np.testing.assert_allclose(zt[k], zj[k], atol=1e-6)
                else:
                    np.testing.assert_array_equal(zt[k], zj[k])
    assert not os.path.exists(logdir / "render_test_fine_last")


def test_profile_dir_writes_a_trace(tmp_path):
    cfg = _tiny_config(tmp_path, coarse={"N_iters": 3, "N_rand": 256},
                       fine={"N_iters": 3, "N_rand": 256, "pg_scale": []})
    prof = tmp_path / "prof"
    torch_run.main(["--config", cfg, "--profile_dir", str(prof),
                    "--device", "cpu"])
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any(n.startswith("aten::") for n in names)
    assert os.path.isfile(tmp_path / "logs" / "tiny" / "fine_last.tar")


def test_lpips_gate_raises_before_rendering(tmp_path, pair):
    """Without the ``lpips`` package, the JAX package's ``RuntimeError``,
    before any view renders."""
    try:
        import lpips  # noqa: F401
        pytest.skip("the lpips package is installed here")
    except ImportError:
        pass
    with pytest.raises(RuntimeError) as ej:
        jax_metrics.rgb_lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))
    with pytest.raises(RuntimeError) as et:
        t_metrics.rgb_lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))
    assert str(et.value) == str(ej.value)
    _, tm, data = pair
    for kw in ({"eval_lpips_alex": True}, {"eval_lpips_vgg": True}):
        with pytest.raises(RuntimeError, match="lpips"):
            torch_render.render_viewpoints(
                None, data["poses"][:1], data["HW"][:1], data["Ks"][:1],
                False, RK, gt_imgs=data["images"][:1],
                savedir=str(tmp_path / "never"), **kw)
    assert not os.path.exists(tmp_path / "never")
    cfg = _tiny_config(tmp_path)
    with pytest.raises(RuntimeError, match="lpips"):
        torch_run.main(["--config", cfg, "--render_only", "--render_test",
                        "--eval_lpips_vgg", "--device", "cpu"])


def test_data_parallel_runs_the_tiny_fixture_on_one_device(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """Every flag is ported: ``--data_parallel`` with one device (no
    ``torchrun`` environment) trains there, as the JAX package does with
    one device, and says so."""
    assert not getattr(torch_run, "_NOT_PORTED", None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = _tiny_config(tmp_path, coarse={"N_iters": 3, "N_rand": 256},
                       fine={"N_iters": 3, "N_rand": 256, "pg_scale": []})
    torch_run.main(["--config", cfg, "--data_parallel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "data_parallel: one device (cpu); training on it" in out
    assert os.path.isfile(tmp_path / "logs" / "tiny" / "fine_last.tar")


# -------------------------------------------------------- GT generation

@pytest.mark.parametrize("kind", ["inward", "ndc"])
def test_uncached_fixture_ground_truth_matches_jax(tmp_path, monkeypatch,
                                                   kind):
    """A key in no cache: the port renders the teacher as the JAX package
    does (1e-5), writes only to the ``cache_dir`` it is given, and each
    package reads the other's file."""
    monkeypatch.setattr(jax_synthetic, "_REPO_CACHE", str(tmp_path / "jr"))
    if kind == "inward":
        kw = dict(n_train=2, n_val=1, n_test=1, H=20, W=24, teacher_res=20,
                  variant="lego", white_bkgd=False)
        make_j = jax_synthetic.make_synthetic_dataset
        make_t = t_synthetic.make_synthetic_dataset
    else:
        kw = dict(n_train=2, n_val=1, n_test=1, H=16, W=20, teacher_res=16)
        make_j = jax_synthetic.make_ndc_fixture_dataset
        make_t = t_synthetic.make_ndc_fixture_dataset
    repo_files = sorted(os.listdir(t_synthetic.REPO_CACHE))
    j = make_j(cache_dir=str(tmp_path / "j"), **kw)
    t = make_t(cache_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert np.abs(t["images"] - j["images"]).max() < 1e-5
    assert np.abs(t["images"] - 1.0).max() > 0.1
    for k in ("poses", "Ks", "HW", "i_train", "i_test"):
        np.testing.assert_array_equal(t[k], j[k])
    (name,) = os.listdir(tmp_path / "t")
    assert os.listdir(tmp_path / "j") == [name]
    np.testing.assert_array_equal(
        make_t(cache_dir=str(tmp_path / "j"), device="cpu", **kw)["images"],
        j["images"].astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(
        make_j(cache_dir=str(tmp_path / "t"), **kw)["images"],
        t["images"].astype(np.float16).astype(np.float32))
    # without a cache_dir nothing is written, not even the repository's
    make_t(device="cpu", **kw)
    assert sorted(os.listdir(t_synthetic.REPO_CACHE)) == repo_files
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_t(**kw)
