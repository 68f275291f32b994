"""The port's image files and dataset loaders against the JAX package's on
the CPU: ``read_png`` against ``imageio`` on PNGs that OpenCV, Pillow and
imageio write (every colour type and bit depth the loaders meet, every row
filter), the area resize against OpenCV, the NSVF, BlendedMVS,
Tanks&Temples, DeepVoxels and CO3D loaders and the multi-scene NSVF dataset
on scenes written here, the written scenes' rays against the fixture's,
three train steps on an NSVF and a CO3D scene against JAX's, the PNG
loaders with ``imageio``, ``cv2`` and Pillow blocked, and so a JPEG CO3D
scene and a raw JPEG LLFF scene against the JAX loaders.
"""

import importlib
import os
import struct
import subprocess
import sys
import zlib

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from directvoxgo_tpu.config import Config as JaxConfig
from directvoxgo_tpu.config import ConfigDict as JaxConfigDict
from directvoxgo_tpu.data import datasets as jax_datasets
from directvoxgo_tpu.engine import train as jax_train
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO
from directvoxgo_tpu.optim import MaskedAdam as JaxAdam
from directvoxgo_tpu_torch import convert
from directvoxgo_tpu_torch import rays as torch_rays
from directvoxgo_tpu_torch.config import Config as TorchConfig
from directvoxgo_tpu_torch.config import ConfigDict as TorchConfigDict
from directvoxgo_tpu_torch.data import datasets as t_datasets
from directvoxgo_tpu_torch.data import image_io
from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu_torch.engine import train as torch_train
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
from directvoxgo_tpu_torch.ops import sweep as sweep_ops
from directvoxgo_tpu_torch.tools import scene_layouts

jax_load_data = importlib.import_module("directvoxgo_tpu.data.load_data")
t_load_data = importlib.import_module("directvoxgo_tpu_torch.data.load_data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CFG = os.path.join(REPO, "configs", "default.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(a, b, path="root"):
    """Recursive equality of dicts, lists and numpy arrays (object arrays
    element by element)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) or (
            isinstance(a, np.ndarray) and a.dtype == object):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


# ------------------------------------------------------------ read_png

def _image(kind, seed):
    """A random (``seed`` odd) or smooth (even) uint8/uint16 image."""
    rng = np.random.default_rng(seed)
    h, w = 23, 31
    ch = {"gray": 1, "la": 2, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")
                                                   .split("_")[0]]
    if seed % 2:
        x = rng.integers(0, 65536, (h, w, ch))
    else:
        yy, xx = np.mgrid[:h, :w]
        x = np.stack([(yy * 2311 + xx * 977 * (c + 1)) % 65536
                      for c in range(ch)], -1)
    return x if ch > 1 else x[..., 0]


def _write_cv2(path, kind, seed):
    x = _image(kind, seed)
    if kind.endswith("16"):
        cv2.imwrite(path, x.astype(np.uint16))
    else:
        cv2.imwrite(path, (x >> 8).astype(np.uint8))


def _write_pil(path, kind, seed):
    base = kind.split("_")[0]
    x = _image({"pal": "rgb", "bit1": "gray"}.get(base, base), seed)
    x8 = (x >> 8).astype(np.uint8)
    if kind.startswith("pal"):
        n = int(kind.split("_")[1])
        Image.fromarray(x8).quantize(n).save(path)
    elif kind == "bit1":
        Image.fromarray(x8 > 100).save(path)
    elif kind == "la":
        Image.fromarray(x8, "LA").save(path)
    elif kind == "gray16":
        Image.fromarray(x.astype(np.uint16)).save(path)
    else:
        Image.fromarray(x8).save(path)


def _filtered(rows, bpp):
    """Filter the byte rows of an image with the filter types 0-4 in
    turn, as a PNG encoder does (the reference loops of the spec)."""
    out, prev = [], [0] * len(rows[0])
    for r, row in enumerate(rows):
        ft = r % 5
        f = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            elif ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = 0
            f.append((x - pred) % 256)
        out.append(bytes([ft]) + bytes(f))
        prev = row
    return b"".join(out)


def _write_all_filters(path, kind, seed):
    """A PNG whose rows use every filter type, 8 or 16 bits per sample."""
    x = _image(kind, seed)
    depth = 16 if kind.endswith("16") else 8
    x = x.astype(">u2") if depth == 16 else (x >> 8).astype(np.uint8)
    h, w = x.shape[:2]
    ch = 1 if x.ndim == 2 else x.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    raw = x.reshape(h, -1).view(np.uint8).reshape(h, -1)
    body = _filtered([r.tolist() for r in raw], ch * depth // 8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


PNG_CASES = (
    [("cv2", k) for k in ("gray", "gray16", "rgb", "rgb16", "rgba",
                          "rgba16")]
    + [("pil", k) for k in ("gray", "gray16", "la", "rgb", "rgba", "pal_256",
                            "pal_12", "pal_4", "pal_2", "bit1")]
    + [("imageio", k) for k in ("rgb", "rgba")]
    + [("filters", k) for k in ("gray", "la", "rgb", "rgba", "rgb16",
                                "rgba16", "la16")])


@pytest.mark.parametrize("writer,kind", PNG_CASES)
def test_read_png_matches_imageio(tmp_path, writer, kind):
    """``read_png`` returns ``imageio.v2.imread``'s array bit for bit, on a
    random and on a smooth image (encoders pick other row filters)."""
    for seed in (0, 1):
        path = str(tmp_path / f"{writer}_{kind}_{seed}.png")
        if writer == "cv2":
            _write_cv2(path, kind, seed)
        elif writer == "pil":
            _write_pil(path, kind, seed)
        elif writer == "imageio":
            imageio.imwrite(path, (_image(kind, seed) >> 8).astype(np.uint8))
        else:
            _write_all_filters(path, kind, seed)
        want = imageio.imread(path)
        got = image_io.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
        assert image_io.image_size(path) == want.shape[:2]


def test_read_png_refuses_interlaced_and_other_files(tmp_path):
    path = str(tmp_path / "interlaced.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, interlace=1)
    with Image.open(path) as im:
        interlaced = im.info.get("interlace")
    if interlaced:
        with pytest.raises(ValueError, match="interlaced.png"):
            image_io.read_png(path)
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.zeros((9, 14, 3), np.uint8))
    with pytest.raises(ValueError, match="x.jpg"):
        image_io.read_png(jpg)
    assert image_io.image_size(jpg) == (9, 14)
    assert np.array_equal(image_io.read_image(jpg), imageio.imread(jpg))


@pytest.mark.parametrize("hw,out", [((40, 40), (20, 20)),
                                    ((40, 30), (13, 10)),
                                    ((33, 47), (11, 23))])
def test_area_resize_np_matches_cv2(hw, out):
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(0, 1, (*hw, 4)).astype(np.float32)
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_AREA)
    got = image_io.area_resize_np(img, *out)
    assert got.dtype == np.float32 and np.abs(got - want).max() < 1e-6
    u8 = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = cv2.resize(u8, out[::-1], interpolation=cv2.INTER_AREA)
    assert np.abs(image_io.area_resize_u8(u8, *out).astype(int)
                  - want).max() <= (0 if hw[0] % out[0] == 0
                                    and hw[1] % out[1] == 0 else 1)


# ---------------------------------------------------------- the loaders

def _random_views(n, hw=(12, 16), ch=3, seed=0):
    """``n`` quantized random views, GL c2w poses around the origin and a
    pixel K."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, *hw, ch)).astype(np.float32) / 255.0
    poses = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses.append(np.concatenate([q, rng.normal(0, 2, (3, 1))], 1))
    K = np.array([[14.0, 0, hw[1] / 2], [0, 14.0, hw[0] / 2], [0, 0, 1]])
    return images, np.array(poses, np.float32), K


def _load_both(**data):
    cfg_j = JaxConfigDict(**data)
    cfg_t = TorchConfigDict(**data)
    return t_load_data.load_data(cfg_t), jax_load_data.load_data(cfg_j)


def _same_loaded(t, j, resized=False):
    assert set(t) == set(j)
    for k in t:
        if k == "images" and resized:
            assert np.abs(np.asarray(t[k]) - np.asarray(j[k])).max() < 1e-6
        else:
            _assert_same(t[k], j[k], k)


@pytest.mark.parametrize("down", [1, 2])
def test_nsvf_matches_jax(tmp_path, down):
    images, poses, K = _random_views(7, ch=4)
    scene_layouts.write_prefix_split(str(tmp_path), images, poses, K,
                                     [[0, 1, 2], [3], [4, 5, 6]], False)
    t, j = _load_both(dataset_type="nsvf", datadir=str(tmp_path), down=down,
                      white_bkgd=True)
    _same_loaded(t, j, resized=down > 1)
    assert t["images"].shape == (7, 12 // down, 16 // down, 3)
    assert list(t["i_val"]) == [3] and t["near"] == 0.05 * t["far"]


def test_blendedmvs_matches_jax(tmp_path):
    images, poses, K = _random_views(5)
    scene_layouts.write_prefix_split(str(tmp_path), images, poses, K,
                                     [[0, 1, 2], [3, 4]], True,
                                     render_traj=poses[:2])
    t, j = _load_both(dataset_type="blendedmvs", datadir=str(tmp_path),
                      white_bkgd=True)
    _same_loaded(t, j)
    assert t["Ks"].shape == (5, 4, 4) and t["render_poses"].shape == (2, 4, 4)


@pytest.mark.parametrize("traj", [True, False])
def test_tankstemple_matches_jax(tmp_path, traj):
    images, poses, K = _random_views(5, ch=4, seed=2)
    scene_layouts.write_prefix_split(
        str(tmp_path), images, poses, K, [[0, 1, 2], [3, 4]], True,
        render_traj=poses[:3] if traj else None)
    t, j = _load_both(dataset_type="tankstemple", datadir=str(tmp_path),
                      white_bkgd=False)
    _same_loaded(t, j)
    assert t["near"] == 0 and len(t["render_poses"]) == (3 if traj else 2)


def test_deepvoxels_matches_jax(tmp_path):
    """512^2 views, two a split, intrinsics of a 400^2 source."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (6, 512, 512, 3)).astype(
        np.float32) / 255.0
    _, poses, _ = _random_views(6, seed=3)
    K = np.array([[350.0, 0, 205.0], [0, 350.0, 198.0], [0, 0, 1]])
    scene_layouts.write_deepvoxels(str(tmp_path), "cube", images, poses, K,
                                   (400, 400), [[0, 1], [2, 3], [4, 5]])
    t, j = _load_both(dataset_type="deepvoxels", datadir=str(tmp_path),
                      scene="cube", testskip=1, white_bkgd=True)
    _same_loaded(t, j)
    assert t["hwf"][:2] == [512, 512] and t["hwf"][2] == 350.0 * 512 / 400
    np.testing.assert_allclose(t["poses"], poses[:, :3, :4], atol=1e-6)


@pytest.mark.parametrize("white", [True, False])
def test_co3d_matches_jax(tmp_path, white):
    """Two view sizes (half the views cropped), one view with an empty mask
    and one annotated with mass 0 (both dropped)."""
    images, poses, K = _random_views(7, hw=(20, 24), seed=4)
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(7, 20, 24)) > 0.3).astype(np.float32)
    masks[2] = 0.0
    crops = [None, (2, 3, 15, 17), None, (1, 0, 15, 17), None, None,
             (0, 4, 15, 17)]
    annot, split = scene_layouts.write_co3d(
        str(tmp_path), images, poses, np.repeat(K[None], 7, 0),
        [0, 1, 2, 3, 4], [5, 6], masks=masks, crops=crops, empty_mass=(4,))
    t, j = _load_both(dataset_type="co3d", datadir=str(tmp_path),
                      annot_path=annot, split_path=split,
                      sequence_name="0_0_0", white_bkgd=white)
    _same_loaded(t, j)
    assert t["images"].dtype == object and len(t["images"]) == 5
    assert list(t["i_train"]) == [0, 1, 2] and list(t["i_test"]) == [3, 4]
    assert t["Ks"].shape == (5, 3, 3) and t["near"] == 0


@pytest.mark.parametrize("split", ["train", "test"])
def test_multiscene_nsvf_dataset_matches_jax(tmp_path, split):
    for s, name in enumerate(("Bike", "Toad", "Wineholder")):
        images, poses, K = _random_views(5, ch=4, seed=10 + s)
        scene_layouts.write_prefix_split(str(tmp_path / name), images, poses,
                                         K, [[0, 1], [2], [3, 4]], False)
    kw = dict(basedir=str(tmp_path), split=split, down=2,
              test_scenes=("Wineholder",))
    j = jax_datasets.MultisceneNSVFDataset(**kw)
    t = t_datasets.MultisceneNSVFDataset(**kw)
    assert t.scenes == j.scenes and t.n_scene == j.n_scene
    assert (t.near, t.far) == (j.near, j.far)
    for s in range(t.n_scene):
        a, b = t.scene_data(s), j.scene_data(s)
        assert np.abs(a["images"] - b["images"]).max() < 1e-6
        for k in ("poses", "Ks", "HW", "near", "far"):
            _assert_same(a[k], b[k], k)


def test_load_data_takes_every_dataset_type_of_the_jax_hub():
    """The hub's dispatch names every type the JAX hub's does."""
    import inspect
    import re
    types_of = [set(re.findall(r'dataset_type == "(\w+)"',
                               inspect.getsource(m.load_data)))
                for m in (jax_load_data, t_load_data)]
    assert types_of[0] == types_of[1] and len(types_of[0]) == 9


# ------------------------------------------ written scenes, fixture rays

@pytest.fixture(scope="module")
def fixture40():
    return make_synthetic_dataset(n_train=10, n_val=1, n_test=2, H=40, W=40)


LAYOUT_FLAGS = {"nsvf": (True, False, False),
                "blendedmvs": (True, False, False),
                "tankstemple": (True, False, False),
                "co3d": (True, True, True)}


def write_layout(root, layout, d):
    """``d`` (a fixture's data_dict) written as a ``layout`` scene; returns
    its data config and the fixture index of each loaded view."""
    images, poses, Ks = d["images"], d["poses"], d["Ks"]
    tr, va, te = (list(d[k]) for k in ("i_train", "i_val", "i_test"))
    if layout in ("nsvf", "blendedmvs", "tankstemple"):
        full_k = layout != "nsvf"
        splits = [tr, va, te] if layout == "nsvf" else [tr, te]
        order = scene_layouts.write_prefix_split(
            root, images, poses, Ks[0], splits, full_k,
            render_traj=poses[te] if layout == "blendedmvs" else None)
        data = dict(dataset_type=layout, datadir=root, down=1,
                    white_bkgd=True)
    else:
        h, w = images.shape[1:3]
        crops = [(2, 1, h - 5, w - 3) if i % 2 else None
                 for i in range(len(images))]
        annot, split = scene_layouts.write_co3d(root, images, poses, Ks, tr,
                                                te, crops=crops)
        order = tr + te
        data = dict(dataset_type="co3d", datadir=root, annot_path=annot,
                    split_path=split, sequence_name="0_0_0",
                    white_bkgd=True)
    inv, fx, fy = LAYOUT_FLAGS[layout]
    data.update(inverse_y=inv, flip_x=fx, flip_y=fy, ndc=False)
    return data, order, crops if layout == "co3d" else None


@pytest.mark.parametrize("layout", sorted(LAYOUT_FLAGS))
def test_written_scene_gives_the_fixture_rays(tmp_path, fixture40, layout):
    """A fixture written in a layout and read back by its loader: the
    8-bit images, and each view's rays (with the layout's ``inverse_y``/
    ``flip_x``/``flip_y``) against the fixture's rays at the same pixels,
    to 1e-5."""
    d = fixture40
    data, order, crops = write_layout(str(tmp_path), layout, d)
    got = t_load_data.load_data(TorchConfigDict(**data))
    inv, fx, fy = LAYOUT_FLAGS[layout]
    for v, i in enumerate(order):
        y0, x0, h, w = crops[i] if crops and crops[i] else (0, 0, 40, 40)
        want = scene_layouts.to_u8(d["images"][i])[y0:y0 + h, x0:x0 + w]
        assert np.array_equal(scene_layouts.to_u8(got["images"][v]), want)
        H, W = (int(x) for x in got["HW"][v])
        ro, rd, _ = torch_rays.get_rays_of_a_view(
            H, W, got["Ks"][v], got["poses"][v][:3, :4].astype(np.float32),
            False, inv, fx, fy)
        ro0, rd0, _ = torch_rays.get_rays_of_a_view(
            40, 40, d["Ks"][i], d["poses"][i], False, False, False, False)
        np.testing.assert_allclose(ro, ro0[y0:y0 + h, x0:x0 + w], atol=1e-5)
        np.testing.assert_allclose(rd, rd0[y0:y0 + h, x0:x0 + w], atol=1e-5)


def test_deepvoxels_scene_gives_the_fixture_cameras(tmp_path, fixture40):
    """The fixture's poses and focal length, rescaled to the 512^2 target
    (views resampled; the loader reads them as written)."""
    d = fixture40
    up = torch.nn.functional.interpolate(
        torch.as_tensor(d["images"]).permute(0, 3, 1, 2), size=(512, 512),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    splits = [list(d["i_train"]), list(d["i_val"]), list(d["i_test"])]
    scene_layouts.write_deepvoxels(str(tmp_path), "fixture", up, d["poses"],
                                   d["Ks"][0], (40, 40), splits)
    got = t_load_data.load_data(TorchConfigDict(
        dataset_type="deepvoxels", datadir=str(tmp_path), scene="fixture",
        testskip=1, white_bkgd=True))
    np.testing.assert_allclose(got["poses"], d["poses"], atol=1e-6)
    np.testing.assert_allclose(got["Ks"][0], d["Ks"][0] * [[12.8], [12.8],
                                                           [1]], atol=1e-4)
    assert np.array_equal(scene_layouts.to_u8(got["images"]),
                          scene_layouts.to_u8(up))


# ------------------------------------------- train steps on the layouts

def _model_pair(xyz_min, xyz_max, n, rgbnet_dim, seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxDVGO(xyz_min=xyz_min, xyz_max=xyz_max, num_voxels=n ** 3,
                 num_voxels_base=n ** 3, alpha_init=1e-2,
                 fast_color_thres=1e-4, rgbnet_dim=rgbnet_dim,
                 rgbnet_direct=True, rgbnet_depth=3, rgbnet_width=32,
                 k_density=None, k_color=0, sweep_color_topk=48)
    pts = np.asarray(jm.grid_points())
    dens = 12.0 * np.exp(-np.sum((pts / 0.6) ** 2, -1)) - 8.0
    jm.params["density"] = jnp.asarray(
        (dens + rng.normal(0, 0.5, dens.shape)).astype(np.float32))
    jm.params["k0"] = jnp.asarray(rng.normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    tm = TorchDVGO(**jm.get_kwargs(), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), np.asarray(jm.mask)))
    jm.sweep_dtype, jm.mlp_dtype = jnp.float32, None
    tm.sweep_dtype, tm.mlp_dtype = torch.float32, None
    return jm, tm


@pytest.mark.parametrize("layout", ["nsvf", "co3d"])
def test_three_train_steps_on_a_layout_match_jax(tmp_path, fixture40,
                                                 layout):
    """The fixture written as an NSVF scene (``inverse_y``; a fine-style
    step: MLP colours, region mode) and as a CO3D scene (per-view K,
    ``flip_x``/``flip_y``, views of two sizes, the ``flatten`` sampler; a
    coarse-style step with a per-voxel lr): both packages load it, build
    their ray pools (equal) and take three steps on the same rays of one
    sweep axis, at the tolerances of
    ``test_torch_train.py::test_three_train_steps_match_jax``."""
    data, _, _ = write_layout(str(tmp_path), layout, fixture40)
    fine = layout == "nsvf"
    d_t = t_load_data.load_everything(
        None, TorchConfigDict(data=TorchConfigDict(**data)))
    d_j = jax_load_data.load_everything(
        None, JaxConfigDict(data=JaxConfigDict(**data)))
    jcfg, tcfg = JaxConfig.fromfile(DEFAULT_CFG), TorchConfig.fromfile(
        DEFAULT_CFG)
    for c in (jcfg, tcfg):
        c.data.update(data)
    j_ct = jcfg.fine_train if fine else jcfg.coarse_train
    t_ct = tcfg.fine_train if fine else tcfg.coarse_train
    for ct in (j_ct, t_ct):
        ct.N_rand = 256
        ct.ray_sampler = "flatten"
    jm, tm = _model_pair([-1.2] * 3, [1.2] * 3, 40, 12 if fine else 0)
    rk = dict(near=float(d_t["near"]), far=float(d_t["far"]), bg=1.0,
              stepsize=0.5, inverse_y=data["inverse_y"],
              flip_x=data["flip_x"], flip_y=data["flip_y"])
    pool_j = jax_train.gather_training_rays(jm, jcfg, j_ct, d_j, rk)
    pool_t = torch_train.gather_training_rays(tm, tcfg, t_ct, d_t, rk)
    for a, b in zip(pool_t[:4], pool_j[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rgb, ro, rd, vd = (np.asarray(x, np.float32).reshape(-1, 3)
                       for x in pool_t[:4])
    axes = sweep_ops.dominant_axis(rd, tm.xyz_min, tm.xyz_max, tm.world_size)
    axis = int(np.bincount(axes, minlength=3).argmax())
    on_axis = np.nonzero(axes == axis)[0]
    clip_sizes, clip_off = jm.sweep_clip_for_axis(axis)
    assert clip_sizes == tm.sweep_clip_for_axis(axis)[0]

    j_opt = jax_train.create_optimizer_or_freeze_model(jm, j_ct)
    j_state = j_opt.init(jm.params)
    t_opt = torch_train.create_optimizer_or_freeze_model(tm, t_ct)
    if not fine:
        cnt = np.random.default_rng(5).integers(
            0, 12, tm.world_size).astype(np.float32)
        j_state = JaxAdam.set_pervoxel_lr(j_state, jnp.asarray(cnt))
        t_opt.set_pervoxel_lr(torch.tensor(cnt))
    convert.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, j_state),
                               t_opt)
    j_step = jax_train.make_train_step(jm, j_opt, j_ct, rk, False, False,
                                       axis=axis, clip_sizes=clip_sizes)
    t_step = torch_train.make_train_step(tm, t_opt, t_ct, rk, False, False,
                                         axis=axis, clip_sizes=clip_sizes)
    j_pool = {"rgb": jnp.asarray(rgb), "rays_o": jnp.asarray(ro),
              "rays_d": jnp.asarray(rd), "viewdirs": jnp.asarray(vd)}
    t_pool = {k: torch.tensor(np.asarray(v)) for k, v in j_pool.items()}
    p0 = np.asarray(jm.params["density"]).copy()
    params = jm.params
    for i in range(3):
        sel = np.random.default_rng(10 + i).permutation(on_axis)[:256]
        params, j_state, loss_j, psnr_j = j_step(
            params, jm.mask, j_state, j_pool, jnp.asarray(sel, jnp.int32),
            jnp.asarray(clip_off))
        loss_t, psnr_t = t_step(t_pool, torch.tensor(sel), clip_off)
        assert abs(float(loss_t) - float(loss_j)) < 1e-4 * float(loss_j)
        assert abs(float(psnr_t) - float(psnr_j)) < 1e-3
    t_params, _ = convert.params_to_jax(tm)
    moved = np.abs(np.asarray(params["density"]) - p0).max()
    assert moved > 1e-3
    for name in ("density", "k0"):
        err = np.abs(t_params[name] - np.asarray(params[name]))
        assert err.max() < 2e-2 * moved, name
        assert np.mean(err < 1e-5) > 0.995, name


# ------------------------------------------ no imageio, cv2 or Pillow

def test_png_loaders_need_no_imageio_cv2_or_pil(tmp_path, fixture40):
    """Every PNG loader, with ``imageio``, ``cv2`` and ``PIL`` blocked (as
    on a machine that has none of them): the five layouts, a Blender scene
    with ``half_res``, an LLFF scene that makes its ``images_2`` folder,
    the Blender and multi-scene NSVF datasets."""
    d = fixture40
    cfgs = {}
    for layout in LAYOUT_FLAGS:
        cfgs[layout] = write_layout(str(tmp_path / layout), layout, d)[0]
    up = np.repeat(np.repeat(d["images"], 13, 1), 13, 2)[:, :512, :512]
    scene_layouts.write_deepvoxels(
        str(tmp_path / "dv"), "s", up, d["poses"], d["Ks"][0], (40, 40),
        [list(d["i_train"]), list(d["i_val"]), list(d["i_test"])])
    cfgs["deepvoxels"] = dict(dataset_type="deepvoxels",
                              datadir=str(tmp_path / "dv"), scene="s",
                              testskip=1, white_bkgd=True)
    blender = tmp_path / "blender"
    for split in ("train", "val", "test"):
        os.makedirs(blender / split)
        frames = []
        for i in range(2):
            image_io.write_png(str(blender / split / f"r_{i}.png"),
                               scene_layouts.to_u8(d["images"][i]))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.eye(4).tolist()})
        (blender / f"transforms_{split}.json").write_text(
            __import__("json").dumps({"camera_angle_x": 0.7,
                                      "frames": frames}))
    cfgs["blender"] = dict(dataset_type="blender", datadir=str(blender),
                           half_res=True, testskip=1, down=1,
                           white_bkgd=True, task="")
    llff = tmp_path / "llff"
    os.makedirs(llff / "images")
    rows = []
    for i in range(4):
        image_io.write_png(str(llff / "images" / f"{i:03d}.png"),
                           scene_layouts.to_u8(d["images"][i]))
        pose = np.concatenate([np.eye(3), np.zeros((3, 1)) + i * 0.1,
                               [[40], [40], [30.0]]], 1)
        rows.append(np.concatenate([pose.ravel(), [2.0, 8.0]]))
    np.save(llff / "poses_bounds.npy", np.stack(rows))
    cfgs["llff"] = dict(dataset_type="llff", datadir=str(llff), factor=2,
                        width=None, height=None, spherify=False, llffhold=2,
                        ndc=True, load_depths=False, white_bkgd=False)
    for name in ("Bike", "Toad"):
        scene_layouts.write_prefix_split(
            str(tmp_path / "ms" / name), d["images"], d["poses"], d["Ks"][0],
            [list(d["i_train"]), list(d["i_val"]), list(d["i_test"])], False)
    code = (
        "import sys\n"
        "for m in ('imageio', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from directvoxgo_tpu_torch.config import ConfigDict\n"
        "from directvoxgo_tpu_torch.data import load_data, datasets\n"
        f"cfgs = {cfgs!r}\n"
        "for name, c in cfgs.items():\n"
        "    d = load_data(ConfigDict(**c))\n"
        "    print(name, len(d['images']))\n"
        f"ds = datasets.MultisceneNSVFDataset({str(tmp_path / 'ms')!r})\n"
        f"bd = datasets.BlenderDataset({str(blender)!r}, down=2)\n"
        "print('multiscene', ds.n_scene, 'blender', bd.images.shape)\n"
        "assert not [m for m in ('imageio', 'cv2', 'PIL')\n"
        "            if sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.split("\n")
    assert sum(1 for x in lines if x.split(" ")[0] in cfgs) == len(cfgs)
    assert "multiscene 2 blender (2, 20, 20, 3)" in proc.stdout


def _co3d_as_jpeg(root):
    """Re-encode the frames of a CO3D scene written by ``write_co3d`` as
    JPEGs (4:2:0, quality 90, as CO3D ships them) and point its
    annotations and set lists at them."""
    import gzip
    import json
    cat = os.path.join(root, "fixture")
    annot_path = os.path.join(cat, "frame_annotations.jgz")
    with gzip.open(annot_path, "rt") as f:
        annots = json.load(f)
    for a in annots:
        png = a["image"]["path"]
        jpg = png[:-4] + ".jpg"
        Image.open(os.path.join(root, png)).save(
            os.path.join(root, jpg), quality=90, subsampling=2)
        os.remove(os.path.join(root, png))
        a["image"]["path"] = jpg
    with gzip.open(annot_path, "wt") as f:
        json.dump(annots, f)
    split_path = os.path.join(cat, "set_lists.json")
    with open(split_path) as f:
        sets = json.load(f)
    sets = {k: [[s, i, p[:-4] + ".jpg"] for s, i, p in v]
            for k, v in sets.items()}
    with open(split_path, "w") as f:
        json.dump(sets, f)


def test_jpeg_loaders_need_no_imageio_cv2_or_pil(tmp_path, fixture40):
    """A CO3D scene whose frames are JPEGs and a raw LLFF scene whose
    ``images/`` are JPEGs (``_minify`` makes ``images_2`` from them), loaded
    by the port with ``imageio``, ``cv2`` and ``PIL`` blocked, against the
    JAX loaders on the same files (loaded before, with them)."""
    import pickle
    import shutil
    d = fixture40
    co3d_cfg = write_layout(str(tmp_path / "co3d"), "co3d", d)[0]
    _co3d_as_jpeg(str(tmp_path / "co3d"))
    llff_cfgs = {who: dict(
        dataset_type="llff", datadir=str(tmp_path / f"llff_{who}"),
        factor=2, width=None, height=None, spherify=False, llffhold=2,
        ndc=True, load_depths=False, white_bkgd=False)
        for who in ("jax", "port")}
    os.makedirs(tmp_path / "llff_jax" / "images")
    rows = []
    for i in range(4):
        img = scene_layouts.to_u8(d["images"][i])[:38, :, :]  # 38x40
        Image.fromarray(img).save(
            str(tmp_path / "llff_jax" / "images" / f"IMG_{i:03d}.JPG"),
            quality=85, subsampling=2)
        pose = np.concatenate([np.eye(3), np.zeros((3, 1)) + i * 0.1,
                               [[38], [40], [30.0]]], 1)
        rows.append(np.concatenate([pose.ravel(), [2.0, 8.0]]))
    np.save(tmp_path / "llff_jax" / "poses_bounds.npy", np.stack(rows))
    shutil.copytree(tmp_path / "llff_jax" / "images",
                    tmp_path / "llff_port" / "images")
    shutil.copy(tmp_path / "llff_jax" / "poses_bounds.npy",
                tmp_path / "llff_port" / "poses_bounds.npy")
    want = {"co3d": jax_load_data.load_data(JaxConfigDict(**co3d_cfg)),
            "llff": jax_load_data.load_data(JaxConfigDict(
                **llff_cfgs["jax"]))}
    out = str(tmp_path / "port.pkl")
    cfgs = {"co3d": co3d_cfg, "llff": llff_cfgs["port"]}
    code = (
        "import pickle, sys\n"
        "for m in ('imageio', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from directvoxgo_tpu_torch.config import ConfigDict\n"
        "from directvoxgo_tpu_torch.data import load_data\n"
        f"cfgs = {cfgs!r}\n"
        "got = {k: load_data(ConfigDict(**c)) for k, c in cfgs.items()}\n"
        f"pickle.dump(got, open({out!r}, 'wb'))\n"
        "assert not [m for m in ('imageio', 'cv2', 'PIL')\n"
        "            if sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = pickle.load(open(out, "rb"))
    for name in ("co3d", "llff"):
        _same_loaded(got[name], want[name])
    assert "minifying to" in proc.stdout
    assert sorted(os.listdir(tmp_path / "llff_port" / "images_2")) == [
        f"IMG_{i:03d}.png" for i in range(4)]
    assert got["llff"]["images"].shape[1:3] == (19, 20)
    assert len(got["co3d"]["images"]) == len(d["i_train"]) + len(d["i_test"])
