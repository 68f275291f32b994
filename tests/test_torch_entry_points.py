"""The port's last three entry points against the JAX package's on the
CPU: ``eval_metrics`` against the root ``eval_metrics.py`` (the printed
metric lines and ``_metrics.txt``), ``tools.visualize_feature``'s panels
against those the JAX tool plots (captured from matplotlib) on
checkpoints written by either package, and ``tools.crop_image`` against
the JAX tool's output pixels.
"""

import importlib.util
import os
import sys

import imageio.v2 as imageio
import jax.numpy as jnp
import matplotlib
import matplotlib.axes
import numpy as np
import pytest
import torch
from PIL import Image

from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.data import load_everything as jax_load_everything
from directvoxgo_tpu.engine import checkpoint as jax_ckpt
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu_torch import eval_metrics
from directvoxgo_tpu_torch.data import image_io
from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.tools import crop_image, visualize_feature

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "fixture_tiny.py")


def _jax_script(rel):
    """The JAX package's root script ``rel`` as a module."""
    name = "jax_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------- eval_metrics

@pytest.fixture(scope="module")
def tiny_renders(tmp_path_factory):
    """PNG 'renders' of fixture_tiny's splits: the ground truth plus
    seeded noise, one directory per split."""
    data = jax_load_everything(None, JaxConfig.fromfile(TINY))
    dirs = {}
    rng = np.random.default_rng(0)
    for split in ("test", "val"):
        d = tmp_path_factory.mktemp(f"render_{split}")
        for n, i in enumerate(data[f"i_{split}"]):
            gt = np.asarray(data["images"][i], np.float32)
            img = gt + rng.normal(0.0, 0.04, gt.shape)
            image_io.write_png(str(d / f"{n:03d}.png"),
                               (255 * np.clip(img, 0, 1)).astype(np.uint8))
        dirs[split] = str(d)
    return dirs


def _metric_lines(text):
    return [x for x in text.splitlines()
            if x.split(" ")[0] in ("psnr", "ssim", "lpips_alex", "lpips_vgg",
                                   "wrote")]


@pytest.mark.parametrize("split,flags", [("test", ["--eval_ssim"]),
                                         ("val", [])])
def test_eval_metrics_matches_jax(tiny_renders, monkeypatch, capsys, split,
                                  flags):
    render_dir = tiny_renders[split]
    argv = ["--render_dir", render_dir, "--config", TINY, "--split",
            split] + flags
    out_file = os.path.join(render_dir, "_metrics.txt")
    jax_main = _jax_script("eval_metrics.py").main
    monkeypatch.setattr(sys, "argv", ["eval_metrics.py"] + argv)
    capsys.readouterr()
    jax_main()
    want_out = _metric_lines(capsys.readouterr().out)
    want_txt = open(out_file).read()
    os.remove(out_file)
    means = eval_metrics.main(argv)
    got_out = _metric_lines(capsys.readouterr().out)
    assert got_out == want_out
    assert open(out_file).read() == want_txt
    assert set(means) == ({"psnr", "ssim"} if flags else {"psnr"})
    assert want_out[0].startswith("psnr ") and len(want_out) == 2 + bool(
        flags)


def test_eval_metrics_skips_depth_frames_and_needs_lpips(tiny_renders,
                                                         tmp_path):
    """The port's driver writes depth_*.png beside the frames: they are not
    scored. LPIPS without the ``lpips`` package raises as JAX's does."""
    import shutil
    d = str(tmp_path / "with_depth")
    shutil.copytree(tiny_renders["test"], d)
    for f in sorted(os.listdir(d)):
        if f.endswith(".png"):
            image_io.write_png(os.path.join(d, "depth_" + f),
                               np.zeros((8, 8, 3), np.uint8))
    plain = eval_metrics.main(["--render_dir", tiny_renders["test"],
                               "--config", TINY])
    assert eval_metrics.main(["--render_dir", d, "--config", TINY]) == plain
    try:
        import lpips  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="lpips"):
            eval_metrics.main(["--render_dir", d, "--config", TINY,
                               "--eval_lpips_alex"])


# --------------------------------------------------- visualize_feature

def _checkpoint(path, writer, n=16, rgbnet_dim=6):
    """A DirectVoxGO checkpoint with random grids, written by ``writer``
    ("jax" or "port")."""
    rng = np.random.default_rng(3)
    kw = dict(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=n ** 3,
              num_voxels_base=n ** 3, alpha_init=1e-2, rgbnet_dim=rgbnet_dim,
              rgbnet_direct=False, rgbnet_width=16)
    if writer == "jax":
        jm = JaxDVGO(**kw, fast_color_thres=1e-4, world_size_quantum=8,
                     sweep_color_topk=48)
        jm.params["density"] = jnp.asarray(
            rng.normal(0, 4, jm.world_size).astype(np.float32))
        jm.params["k0"] = jnp.asarray(
            rng.normal(size=jm.params["k0"].shape).astype(np.float32))
        jax_ckpt.save_model_checkpoint(path, jm, 7)
    else:
        tm = TorchDVGO(**kw, device="cpu", seed=0)
        with torch.no_grad():
            tm.density.copy_(torch.as_tensor(
                rng.normal(0, 4, tm.density.shape).astype(np.float32)))
            tm.k0.copy_(torch.as_tensor(
                rng.normal(size=tm.k0.shape).astype(np.float32)))
        torch_ckpt.save_model_checkpoint(path, tm, 3)


class _Plotted:
    """Records the arrays and titles given to matplotlib's Axes."""

    def __init__(self, monkeypatch):
        self.panels, self.titles = [], []
        imshow, set_title = matplotlib.axes.Axes.imshow, \
            matplotlib.axes.Axes.set_title

        def _imshow(ax, x, *a, **k):
            self.panels.append(np.asarray(x).T.copy())
            return imshow(ax, x, *a, **k)

        def _set_title(ax, t, *a, **k):
            self.titles.append(t)
            return set_title(ax, t, *a, **k)

        monkeypatch.setattr(matplotlib.axes.Axes, "imshow", _imshow)
        monkeypatch.setattr(matplotlib.axes.Axes, "set_title", _set_title)


@pytest.mark.parametrize("writer,args", [
    ("jax", []), ("port", []),
    ("jax", ["--slice_axis", "0", "--n_slices", "3", "--max_channels", "4"]),
    ("port", ["--slice_axis", "1", "--max_channels", "20"])])
def test_feature_panels_match_jax(tmp_path, monkeypatch, writer, args):
    ckpt = str(tmp_path / "fine_last.tar")
    _checkpoint(ckpt, writer)
    plotted = _Plotted(monkeypatch)
    jax_main = _jax_script(os.path.join("tools",
                                        "visualize_feature.py")).main
    monkeypatch.setattr(sys, "argv", [
        "visualize_feature.py", "--ckpt", ckpt,
        "--out", str(tmp_path / "jax.png")] + args)
    jax_main()
    want_p, want_t = plotted.panels[:], plotted.titles[:]

    st = torch_ckpt.load_checkpoint_file(ckpt)
    opts = dict(zip(("slice_axis", "n_slices", "max_channels"), (2, 6, 12)))
    for flag, value in zip(args[::2], args[1::2]):
        opts[flag[2:]] = int(value)
    panels, titles = visualize_feature.feature_panels(
        st["model_state_dict"], st["model_kwargs"], device="cpu", **opts)
    assert titles == want_t
    assert len(panels) == opts["n_slices"] + min(6, opts["max_channels"])
    for p, w in zip(panels, want_p):
        assert p.shape == w.shape and p.dtype == np.float32
        np.testing.assert_allclose(p, w, rtol=0, atol=1e-6)

    plotted.panels.clear()
    plotted.titles.clear()
    out = str(tmp_path / "port.png")
    visualize_feature.main(["--ckpt", ckpt, "--out", out, "--device", "cpu"]
                           + args)
    assert plotted.titles == want_t
    for p, w in zip(plotted.panels, want_p):
        np.testing.assert_allclose(p, w, rtol=0, atol=1e-6)
    assert image_io.read_png(out).ndim == 3


def test_visualize_feature_needs_matplotlib_and_the_card(tmp_path,
                                                         monkeypatch):
    ckpt = str(tmp_path / "fine_last.tar")
    _checkpoint(ckpt, "port")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize_feature.main(["--ckpt", ckpt, "--out",
                                str(tmp_path / "x.png"), "--device", "cpu"])
    if not torch.cuda.is_available():
        st = torch_ckpt.load_checkpoint_file(ckpt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            visualize_feature.feature_panels(st["model_state_dict"],
                                             st["model_kwargs"])


# ---------------------------------------------------------- crop_image

def _crop_input(tmp_path, kind):
    rng = np.random.default_rng({"rgb": 1, "rgba": 2, "jpeg": 3}[kind])
    ch = 4 if kind == "rgba" else 3
    img = rng.integers(0, 256, (61, 83, ch)).astype(np.uint8)
    if kind == "jpeg":
        path = str(tmp_path / "in.jpg")
        Image.fromarray(img).save(path, quality=90)
    else:
        path = str(tmp_path / "in.png")
        image_io.write_png(path, img)
    return path


@pytest.mark.parametrize("kind", ["rgb", "rgba", "jpeg"])
def test_crop_image_matches_jax(tmp_path, monkeypatch, kind):
    src = _crop_input(tmp_path, kind)
    box = ["--x0", "7", "--y0", "11", "--x1", "70", "--y1", "50"]
    jax_main = _jax_script(os.path.join("tools", "crop_image.py")).main
    want_path = str(tmp_path / "jax.png")
    monkeypatch.setattr(sys, "argv", ["crop_image.py", src, want_path]
                        + box)
    jax_main()
    got_path = str(tmp_path / "port.png")
    crop_image.main([src, got_path] + box)
    want = imageio.imread(want_path)
    got = imageio.imread(got_path)
    assert got.shape == want.shape == (39, 63, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.read_png(got_path), want)


def test_crop_image_writes_png_only(tmp_path):
    src = _crop_input(tmp_path, "rgb")
    with pytest.raises(ValueError, match=r"\.png"):
        crop_image.main([src, str(tmp_path / "out.jpg")])
    assert not os.path.exists(tmp_path / "out.jpg")
