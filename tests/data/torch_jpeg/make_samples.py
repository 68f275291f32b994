"""Writes the JPEG samples of this directory and ``expected.json``.

  python tests/data/torch_jpeg/make_samples.py

Needs Pillow and imageio. The samples are views of the lego fixture
(``fixture_cache/fixture_40_2_4_400_400_128_1_0_v2_lego.npz``) with seeded
noise, encoded by Pillow (libjpeg-turbo); ``expected.json`` holds the
shape, dtype and sha256 of the pixels ``imageio.v2.imread`` returns for
each, or the words of the error the port's decoder must raise. They are
the oracle of ``directvoxgo_tpu_torch.data.jpeg.read_jpeg`` on a machine
without Pillow (``chip_smoke.py``'s phase 13).
"""

import hashlib
import json
import os

import imageio.v2 as imageio
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LEGO = os.path.join(REPO, "fixture_cache",
                    "fixture_40_2_4_400_400_128_1_0_v2_lego.npz")
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
BIG = "lego_800_420_q95.jpg"


def view(i, h, w, seed):
    """A ``h x w`` crop of lego view ``i`` with seeded noise, uint8."""
    img = np.load(LEGO)["images"][i].astype(np.float32)
    y0, x0 = (400 - h) // 2, (400 - w) // 2
    crop = img[y0:y0 + h, x0:x0 + w] * 255.0
    noise = np.random.default_rng(seed).normal(0.0, 12.0, crop.shape)
    return np.clip(np.rint(crop + noise), 0, 255).astype(np.uint8)


def upsampled_view(i):
    """Lego view ``i`` upsampled bilinearly to 800x800, uint8."""
    img = np.load(LEGO)["images"][i].astype(np.float32)
    c = (np.arange(800) + 0.5) / 2.0 - 0.5
    lo = np.clip(np.floor(c).astype(int), 0, 399)
    hi = np.clip(lo + 1, 0, 399)
    f = np.clip(c - lo, 0.0, 1.0)[:, None]
    rows = img[lo] * (1 - f[..., None]) + img[hi] * f[..., None]
    cols = rows[:, lo] * (1 - f[None]) + rows[:, hi] * f[None]
    return np.clip(np.rint(cols * 255.0), 0, 255).astype(np.uint8)


def samples():
    """{file name: (uint8 image, Pillow save keywords)}."""
    out = {}
    sizes = ((37, 53), (61, 47))
    for s, sub in enumerate(("gray",) + tuple(SUBSAMPLING)):
        for q in (75, 95):
            for j, (h, w) in enumerate(sizes):
                img = view(s, h, w, seed=100 * s + q + j)
                kw = {"quality": q}
                if sub == "gray":
                    img = img[..., 1]
                else:
                    kw["subsampling"] = SUBSAMPLING[sub]
                out[f"{sub}_q{q}_{h}x{w}.jpg"] = (img, kw)
    out["restart_420_61x47.jpg"] = (view(5, 61, 47, 7), dict(
        quality=90, subsampling=2, restart_marker_blocks=3))
    exif = Image.Exif()
    exif[0x0112] = 6                      # orientation: rotate 90 CW
    out["exif6_422_37x53.jpg"] = (view(6, 37, 53, 8), dict(
        quality=90, subsampling=1, exif=exif.tobytes()))
    out["sof1_qt16_420_37x53.jpg"] = (view(7, 37, 53, 9), dict(
        subsampling=2, qtables=[list(range(1, 65)),
                                [300 + i for i in range(64)]]))
    out["progressive_37x53.jpg"] = (view(8, 37, 53, 10), dict(
        quality=90, progressive=True))
    out["cmyk_37x53.jpg"] = (view(9, 37, 53, 11), dict(quality=90))
    out[BIG] = (upsampled_view(40), dict(quality=95, subsampling=2))
    return out


RAISES = {"progressive_37x53.jpg": "progressive",
          "cmyk_37x53.jpg": "four components"}


def main():
    expected = {}
    for name, (img, kw) in samples().items():
        path = os.path.join(HERE, name)
        im = Image.fromarray(img)
        if name.startswith("cmyk"):
            im = im.convert("CMYK")
        im.save(path, **kw)
        if name in RAISES:
            expected[name] = {"raises": RAISES[name]}
            continue
        px = np.ascontiguousarray(imageio.imread(path))
        expected[name] = {"shape": list(px.shape), "dtype": str(px.dtype),
                          "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in expected)
    print(f"wrote {len(expected)} samples, {total} bytes")


if __name__ == "__main__":
    main()
