"""Image files of the loaders, in numpy and the standard library.

:func:`read_png` decodes a PNG as ``imageio.v2.imread`` returns it (its
Pillow plugin), so that the port loads a scene on a machine without
``imageio``, ``cv2`` or Pillow:

- 8-bit gray, gray + alpha, RGB and RGBA: uint8 ``[H, W]``, ``[H, W, 2]``,
  ``[H, W, 3]``, ``[H, W, 4]``;
- 16-bit gray: uint16 ``[H, W]``; 16-bit RGB and RGBA: the high byte of
  each sample, uint8 (Pillow decodes them to 8 bits); 16-bit gray + alpha:
  the high bytes as RGBA, the gray in each colour channel;
- 1-, 2- and 4-bit gray: bool, and values scaled to 0-255;
- palette images at 1, 2, 4 or 8 bits: the palette's RGB, uint8
  ``[H, W, 3]`` (a ``tRNS`` chunk is ignored, as Pillow's conversion does).

The five row filters are undone along the image's anti-diagonals: each
byte depends only on its left, upper and upper-left neighbours, which lie
on the two diagonals before its own, so a diagonal is one vector step.
Interlaced files raise.

:func:`area_resize_np` is the numpy form of :func:`..ops.resize.area_resize`
(OpenCV's ``INTER_AREA`` weights). :func:`image_size` reads the size of a
PNG or JPEG from its header. :func:`read_jpeg` (from :mod:`.jpeg`) decodes
a sequential JPEG as ``imageio.v2.imread`` does, and :func:`read_image`
picks the decoder by the file's first bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops.resize import area_weights
from .jpeg import read_jpeg  # noqa: F401  (part of this module's interface)

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _chunks(data, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _unfilter(raw, h, row_bytes, bpp):
    """Undo the per-row filters: ``raw`` holds ``h`` rows of a filter-type
    byte and ``row_bytes`` filtered bytes; returns uint8 ``[h, row_bytes]``.
    Bytes are grouped into pixels of ``bpp`` bytes (1 below 8 bits)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int16)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    npx = row_bytes // bpp
    if (ftype <= 2).all():
        # no Average or Paeth row: rows in order, each one vector step
        out = np.zeros((h + 1, npx, bpp), np.uint8)
        filt = rows[:, 1:].reshape(h, npx, bpp)
        for r in range(h):
            if ftype[r] == 1:
                out[r + 1] = np.cumsum(filt[r], 0, dtype=np.uint8)
            elif ftype[r] == 2:
                out[r + 1] = filt[r] + out[r]
            else:
                out[r + 1] = filt[r]
        return out[1:].reshape(h, row_bytes)
    filt = rows[:, 1:].reshape(h, npx, bpp).astype(np.int16)
    # padded by one zero row above and one zero pixel on the left
    out = np.zeros((h + 1, npx + 1, bpp), np.int16)
    for d in range(h + npx - 1):
        r = np.arange(max(0, d - npx + 1), min(h - 1, d) + 1)
        p = d - r
        a = out[r + 1, p]              # left
        b = out[r, p + 1]              # up
        c = out[r, p]                  # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        out[r + 1, p + 1] = (filt[r, p] + pred) & 0xFF
    return out[1:, 1:].reshape(h, row_bytes).astype(np.uint8)


def read_png(path):
    """The image of a non-interlaced PNG file, as ``imageio.v2.imread``
    returns it (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, plte, idat = None, None, []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits "
                         "is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    row_bytes = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (row_bytes + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = _unfilter(raw[:h * (row_bytes + 1)], h, row_bytes,
                     max(1, ch * depth // 8))
    if depth == 16:
        samples = rows.view(">u2").reshape(h, w, ch)
        if ch == 1:
            return samples[..., 0].astype(np.uint16)
        if ch == 2:
            samples = samples[..., [0, 0, 0, 1]]
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bits.reshape(h, w, depth) * weights).sum(-1)
        if ctype == 3:
            return _palette(plte, samples)
        if depth == 1:
            return samples.astype(bool)
        return (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    samples = rows.reshape(h, w, ch)
    if ctype == 3:
        return _palette(plte, samples[..., 0])
    return samples[..., 0].copy() if ch == 1 else samples


def _palette(plte, index):
    table = np.zeros((256, 3), np.uint8)
    table[:len(plte)] = plte[:256]
    return table[index]


def image_size(path):
    """``(height, width)`` of a PNG or JPEG file, read from its header."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == _SIGNATURE:
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                break
            if marker[1] in (0x01, *range(0xD0, 0xD8)):
                continue                     # markers without a length
            (n,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8,
                                                                0xCC):
                h, w = struct.unpack(">xHH", f.read(5))
                return int(h), int(w)
            f.seek(n - 2, 1)
    raise ValueError(f"{path}: JPEG without a frame header")


def read_image(path):
    """A PNG through :func:`read_png`, a JPEG through :func:`read_jpeg`,
    told apart by their first bytes (as ``imageio`` does, whatever the
    file's extension); any other file raises."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIGNATURE:
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def area_resize_np(img, out_h, out_w):
    """``img [..., H, W, C]`` float -> ``[..., out_h, out_w, C]`` float32,
    as ``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)``
    gives each float32 image (OpenCV's area weights, summed in float64)."""
    img = np.asarray(img)
    if img.ndim > 3:
        return np.stack([area_resize_np(x, out_h, out_w) for x in img])
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (out_h, out_w):
        return img.astype(np.float32)
    cols = np.einsum("hwc,pw->hpc", img.astype(np.float64),
                     area_weights(w, out_w))
    return np.einsum("oh,hpc->opc", area_weights(h, out_h),
                     cols).astype(np.float32)


def area_resize_u8(img, out_h, out_w):
    """A uint8 image resized by area, rounded as OpenCV rounds its uint8
    area resize: at a whole factor ``(sum + area / 2) // area``, else the
    weighted mean rounded half to even."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    fy, fx = h // out_h, w // out_w
    if h == fy * out_h and w == fx * out_w:
        blocks = img[:out_h * fy, :out_w * fx].reshape(
            out_h, fy, out_w, fx, *img.shape[2:]).astype(np.int64)
        total = blocks.sum((1, 3))
        return ((total + fy * fx // 2) // (fy * fx)).astype(np.uint8)
    mean = area_resize_np(img.reshape(h, w, -1), out_h, out_w)
    return np.clip(np.rint(mean), 0, 255).astype(np.uint8).reshape(
        out_h, out_w, *img.shape[2:])


def write_png(path, img):
    """Write a uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` image as an
    8-bit gray, RGB or RGBA PNG (filter type 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
