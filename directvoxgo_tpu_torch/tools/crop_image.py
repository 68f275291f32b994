"""Crop of a rendered PNG for a figure: an RGBA image is composited onto
white (through float32, as the JAX package's ``tools/crop_image.py``
does), the ``[y0:y1, x0:x1]`` region cut out and written as a PNG. The
JAX tool's command line; the image is read by
:func:`..data.image_io.read_image` and written by
:func:`..data.image_io.write_png`, so the output path must end in
``.png``. Usage::

  python -m directvoxgo_tpu_torch.tools.crop_image IN.png OUT.png \\
      --x0 300 --y0 300 --x1 500 --y1 500
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.image_io import read_image, write_png
from ..engine.metrics import to8b


def composite_on_white(img):
    """uint8 ``[H, W, 3|4]`` -> uint8 ``[H, W, 3]`` (or the image as it
    is, without an alpha channel), RGBA composited onto white."""
    image = (np.asarray(img) / 255.0).astype(np.float32)
    if image.shape[-1] == 4:
        image = image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
    return to8b(image)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--x0", type=int, default=300)
    ap.add_argument("--y0", type=int, default=300)
    ap.add_argument("--x1", type=int, default=500)
    ap.add_argument("--y1", type=int, default=500)
    args = ap.parse_args(argv)
    if not args.output.lower().endswith(".png"):
        raise ValueError(f"{args.output}: crop_image writes PNG files only "
                         "(the output path must end in .png)")
    img = composite_on_white(read_image(args.input))
    write_png(args.output, img[args.y0:args.y1, args.x0:args.x1])
    print(f"wrote {args.output} "
          f"({args.y1 - args.y0}x{args.x1 - args.x0} crop)")


if __name__ == "__main__":
    main()
