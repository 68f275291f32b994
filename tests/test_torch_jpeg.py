"""The port's JPEG decoder against ``imageio.v2.imread`` (Pillow and
libjpeg-turbo) on the CPU: files that Pillow encodes here (every chroma
subsampling at two qualities and two odd sizes, restart markers, an EXIF
orientation, 16-bit quantisation tables in an extended sequential frame,
optimised Huffman tables, an RGB colour space, tiny images), the files it
refuses, ``read_image``'s dispatch on content, and the committed samples
of ``tests/data/torch_jpeg`` (the oracle of ``chip_smoke.py``'s phase 13)
against their ``expected.json`` and ``imageio``.
"""

import hashlib
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from directvoxgo_tpu_torch.data import image_io, jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "tests", "data", "torch_jpeg")
EXPECTED = json.load(open(os.path.join(SAMPLES, "expected.json")))
SUBSAMPLING = {"gray": None, "444": 0, "422": 1, "420": 2}


def _image(h, w, seed, gray=False):
    """Gradients, a checker pattern and seeded noise: every frequency."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     ((x // 3 + y // 5) % 2) * 180.0 + 30.0], -1)
    noise = np.random.default_rng(seed).normal(0.0, 25.0, (h, w, 3))
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _same_as_imageio(path):
    want = imageio.imread(path)
    got = image_io.read_jpeg(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


ENCODED = {}
for _sub in SUBSAMPLING:
    for _q in (75, 95):
        for _h, _w in ((37, 53), (61, 47)):
            ENCODED[f"{_sub}_q{_q}_{_h}x{_w}"] = (_sub, _h, _w, dict(
                quality=_q))
_EXIF = Image.Exif()
_EXIF[0x0112] = 6
ENCODED.update({
    "restart_blocks_420": ("420", 61, 47, dict(
        quality=90, restart_marker_blocks=3)),
    "restart_rows_422": ("422", 37, 53, dict(
        quality=90, restart_marker_rows=1)),
    "exif_orientation_6": ("420", 37, 53, dict(
        quality=90, exif=_EXIF.tobytes())),
    "sof1_qt16_420": ("420", 61, 47, dict(qtables=[
        list(range(1, 65)), [300 + i for i in range(64)]])),
    "optimized_huffman_444": ("444", 61, 47, dict(quality=80,
                                                  optimize=True)),
    "rgb_colour_space": ("444", 37, 53, dict(quality=90, keep_rgb=True)),
    "quality_5_420": ("420", 61, 47, dict(quality=5)),
    "quality_100_444": ("444", 37, 53, dict(quality=100)),
    "tiny_4x3_420": ("420", 4, 3, dict(quality=90)),
    "tiny_2x9_422": ("422", 2, 9, dict(quality=90)),
    "one_pixel_420": ("420", 1, 1, dict(quality=90)),
})


@pytest.mark.parametrize("case", sorted(ENCODED))
def test_read_jpeg_matches_imageio(tmp_path, case):
    sub, h, w, kw = ENCODED[case]
    img = _image(h, w, seed=len(case) * 7 + h, gray=sub == "gray")
    if sub != "gray":
        kw = dict(kw, subsampling=SUBSAMPLING[sub])
    path = str(tmp_path / f"{case}.jpg")
    Image.fromarray(img).save(path, **kw)
    got = _same_as_imageio(path)
    assert got.shape == ((h, w) if sub == "gray" else (h, w, 3))
    data = open(path, "rb").read()
    if case.startswith("sof1"):
        # an extended sequential frame, and a 16-bit table (Pq 1, Tq 1)
        assert b"\xff\xc1" in data and b"\xff\xc0" not in data
        assert b"\xff\xdb\x00\x83\x11" in data
    if case.startswith("restart"):
        assert b"\xff\xd0" in data and b"\xff\xdd" in data


def _baseline_file(tmp_path, name, **kw):
    path = str(tmp_path / name)
    Image.fromarray(_image(37, 53, seed=3)).save(path, quality=90, **kw)
    return path


def _patched_sof(tmp_path, name, marker=None, precision=None,
                 sampling=None):
    """A baseline file with its SOF0 header changed (a frame type, the
    sample precision, the luma sampling factors)."""
    data = bytearray(open(_baseline_file(tmp_path, "base.jpg",
                                         subsampling=2), "rb").read())
    at = data.index(b"\xff\xc0")
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    if sampling is not None:
        data[at + 11] = sampling
    path = str(tmp_path / name)
    open(path, "wb").write(bytes(data))
    return path


def _cmyk_file(tmp_path, name):
    path = str(tmp_path / name)
    Image.fromarray(_image(37, 53, seed=4)).convert("CMYK").save(
        path, quality=90)
    assert imageio.imread(path).shape == (37, 53, 4)
    return path


REFUSED = {
    "progressive": (lambda p: _baseline_file(p, "prog.jpg",
                                             progressive=True),
                    "progressive"),
    "cmyk": (lambda p: _cmyk_file(p, "cmyk.jpg"), "four components"),
    "arithmetic": (lambda p: _patched_sof(p, "arith.jpg", marker=0xC9),
                   "arithmetic-coded"),
    "twelve_bit": (lambda p: _patched_sof(p, "p12.jpg", precision=12),
                   "12-bit"),
    "sampling_411": (lambda p: _patched_sof(p, "s411.jpg", sampling=0x41),
                     "sampling factors"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_read_jpeg_refuses_and_names_the_file(tmp_path, kind):
    make, words = REFUSED[kind]
    path = make(tmp_path)
    with pytest.raises(ValueError) as e:
        image_io.read_jpeg(path)
    assert path in str(e.value) and words in str(e.value)
    with pytest.raises(ValueError):
        image_io.read_image(path)


def test_read_image_dispatches_on_content(tmp_path):
    img = _image(37, 53, seed=5)
    as_png = str(tmp_path / "jpeg_named.png")
    Image.fromarray(img).save(as_png, format="JPEG", quality=90)
    np.testing.assert_array_equal(image_io.read_image(as_png),
                                  imageio.imread(as_png))
    as_jpg = str(tmp_path / "png_named.jpg")
    image_io.write_png(as_jpg, img)
    np.testing.assert_array_equal(image_io.read_image(as_jpg), img)
    other = tmp_path / "neither.png"
    other.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_io.read_image(str(other))


def _digest(px):
    px = np.ascontiguousarray(px)
    return {"shape": list(px.shape), "dtype": str(px.dtype),
            "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_committed_sample(name):
    """The committed sample's ``imageio`` decode equals its entry in
    ``expected.json`` (so the card's oracle stays true), and so does the
    port's; the samples the port refuses raise and name themselves."""
    path = os.path.join(SAMPLES, name)
    want = EXPECTED[name]
    if "raises" in want:
        with pytest.raises(ValueError) as e:
            jpeg.read_jpeg(path)
        assert path in str(e.value) and want["raises"] in str(e.value)
        return
    assert _digest(imageio.imread(path)) == want
    assert _digest(jpeg.read_jpeg(path)) == want


def test_committed_samples_cover_the_oracle():
    names = set(EXPECTED)
    for sub in ("gray", "444", "422", "420"):
        for q in (75, 95):
            assert {f"{sub}_q{q}_37x53.jpg", f"{sub}_q{q}_61x47.jpg"} <= names
    assert EXPECTED["lego_800_420_q95.jpg"]["shape"] == [800, 800, 3]
    assert EXPECTED["exif6_422_37x53.jpg"]["shape"] == [37, 53, 3]
    assert EXPECTED["progressive_37x53.jpg"] == {"raises": "progressive"}
    assert EXPECTED["cmyk_37x53.jpg"] == {"raises": "four components"}
    total = sum(os.path.getsize(os.path.join(SAMPLES, n)) for n in names)
    assert total <= 256 * 1024
    data = open(os.path.join(SAMPLES, "restart_420_61x47.jpg"), "rb").read()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data


def test_idct_range_limit_wraps_as_libjpeg():
    """A DC far past the sample range wraps modulo 1024 before the clamp,
    as libjpeg's post-IDCT table does; within range it is the mean."""
    coef = np.zeros((3, 8, 8), np.int64)
    coef[0, 0, 0] = 8 * 40            # mean +40 -> 168
    coef[1, 0, 0] = 8 * 200           # +200 -> clamped to 255
    coef[2, 0, 0] = 8 * 600           # +600 wraps to -424 -> 0
    out = jpeg.idct_islow(coef)
    assert out.dtype == np.uint8
    assert (out[0] == 168).all() and (out[1] == 255).all()
    assert (out[2] == 0).all()
