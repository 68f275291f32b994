"""Sequential JPEG decoding in numpy and the standard library.

:func:`read_jpeg` returns what ``imageio.v2.imread`` returns for a JPEG
file (its Pillow plugin, decoding through libjpeg-turbo with its defaults),
bit for bit, so that the port loads JPEG scenes on a machine without
``imageio``, ``cv2`` or Pillow:

- frames: baseline (SOF0) and extended sequential (SOF1), 8-bit samples,
  Huffman-coded, interleaved or not (one scan per component);
- one component: uint8 ``[H, W]``; three (YCbCr, or RGB where an Adobe
  marker or the component ids say so): uint8 ``[H, W, 3]``, with the
  chroma at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2);
- the EXIF orientation is ignored, as ``imageio.v2.imread`` ignores it.

Progressive, lossless, hierarchical and arithmetic-coded frames, samples
of other than 8 bits, four components (CMYK, YCCK) and other sampling
factors raise a ``ValueError`` that names the file.

The entropy decoding is serial: a table lookup per Huffman symbol on the
16-bit windows of the unstuffed scan data at every bit offset (computed in
numpy a chunk at a time). Everything after it runs on all blocks at once:
the dequantisation, libjpeg's integer IDCT (``jidctint.c``, its range
limit included), libjpeg-turbo's fancy (triangle) upsampling
(``jdsample.c``) and its fixed-point YCbCr to RGB tables (``jdcolor.c``).
"""

from __future__ import annotations

import re
import struct
from array import array

import numpy as np

# the natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

_SOF_REFUSED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
_CHUNK = 1 << 16        # scan bytes whose bit windows are made at once
_PAD = 1024             # bytes of windows past a chunk (> one block's bits)
_IDCT_BLOCKS = 1 << 15  # blocks through the IDCT at once
_MARKER_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


class _Corrupt(Exception):
    pass


def _extend(bits, size):
    """JPEG's sign extension of a ``size``-bit magnitude category value."""
    return np.where(bits < (1 << (size - 1)), bits - (1 << size) + 1, bits)


def _huffman_tables(counts, symbols):
    """Lookup tables over every 16-bit window of the bit stream:
    ``slow[w]`` = ``length << 8 | symbol`` of the code that starts ``w``
    (-1: no code does), and ``fast[w]`` = ``(bits consumed, run + 1,
    value)`` where the code and its value bits fit in the window (``(0, 0,
    0)`` elsewhere). The run of an end of block is 128."""
    slow = np.full(65536, -1, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            slow[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    length, sym = slow >> 8, slow & 255
    size, run = sym & 15, sym >> 4
    total = length + size
    ok = (slow >= 0) & (total <= 16)
    bits = (np.arange(65536) >> np.clip(16 - total, 0, 16)) \
        & ((1 << size) - 1)
    value = np.where(size > 0, _extend(bits, np.maximum(size, 1)), 0)
    # with no value bits: ZRL (run 15) or, for any other run, end of block
    run = np.where(size == 0, np.where(run == 15, 15, 128), run)
    fast = list(zip(np.where(ok, total, 0).tolist(),
                    np.where(ok, run + 1, 0).tolist(),
                    np.where(ok, value, 0).tolist()))
    return slow.tolist(), fast


def _windows(buf, start):
    """The 16-bit windows at every bit offset of ``buf[start:start +
    _CHUNK + _PAD]`` (``buf`` is zero-padded past its end)."""
    b = np.frombuffer(buf, np.uint8, _CHUNK + _PAD + 2, start).astype(
        np.uint32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return ((w24[:, None] >> (8 - np.arange(8, dtype=np.uint32)))
            & 0xFFFF).ravel().tolist()


def _scan_segments(data, pos):
    """The entropy-coded data from ``pos`` up to the next marker other
    than RSTn: (its restart intervals unstuffed and concatenated, each
    interval's start byte in that buffer, the position of the marker)."""
    m = _MARKER_END.search(data, pos)
    end = m.start() if m else len(data)
    parts = _RST.split(data[pos:end].rstrip(b"\xff"))
    starts, n = [], 0
    for i, p in enumerate(parts):
        parts[i] = p.replace(b"\xff\x00", b"\xff")
        starts.append(n)
        n += len(parts[i])
    buf = b"".join(parts) + bytes(2 * (_CHUNK + _PAD + 2))
    return buf, starts, end


def _decode_scan(buf, starts, blocks, plan, restart, out):
    """Huffman-decode the blocks of one scan. ``blocks`` holds each
    block's first coefficient slot in decode order, ``plan`` the
    ``(component, DC tables, AC tables)`` of each block of an MCU, and
    ``restart`` the blocks between restart markers (0: none). Appends
    ``slot << 16 | value & 0xFFFF`` of every nonzero coefficient, and of
    every DC, to ``out`` (the slot in zigzag order; the value kept to 16
    bits, as libjpeg's ``JCOEF``)."""
    per_mcu = len(plan)
    pred = [0] * (1 + max(e[0] for e in plan))
    seg = 0
    base = 8 * starts[0]          # bit offset of the windows' first bit
    win = _windows(buf, base >> 3)
    p = 0                         # bit offset in the windows
    limit = 8 * _CHUNK
    append = out.append
    for n, b64 in enumerate(blocks):
        if restart and n and n % restart == 0:
            seg += 1
            if seg >= len(starts):
                raise _Corrupt("fewer restart markers than intervals")
            pred = [0] * len(pred)
            base, p = 8 * starts[seg], 0
            win = _windows(buf, base >> 3)
        elif p > limit:
            base, p = base + (p & ~7), p & 7
            win = _windows(buf, base >> 3)
        ci, dc_slow, dc_fast, ac_slow, ac_fast = plan[n % per_mcu]
        t, _, v = dc_fast[win[p]]
        if t:
            p += t
        else:
            e = dc_slow[win[p]]
            if e < 0:
                raise _Corrupt("bad Huffman code")
            p += e >> 8
            s = e & 15
            if s:
                bits = win[p] >> (16 - s)
                p += s
                v = bits if bits >> (s - 1) else bits - (1 << s) + 1
        pred[ci] += v
        append(b64 << 16 | pred[ci] & 0xFFFF)
        b63 = b64 - 1
        k = 1                     # the next coefficient's zigzag index
        while k < 64:
            t, r1, v = ac_fast[win[p]]
            if t:
                p += t
            else:
                e = ac_slow[win[p]]
                if e < 0:
                    raise _Corrupt("bad Huffman code")
                p += e >> 8
                r1, s = (e >> 4 & 15) + 1, e & 15
                if s:
                    bits = win[p] >> (16 - s)
                    p += s
                    v = bits if bits >> (s - 1) else bits - (1 << s) + 1
                else:
                    v = 0
                    r1 = 16 if r1 == 16 else 129
            k += r1
            if v:
                append((b63 + k) << 16 | v & 0xFFFF)
        if 64 < k < 130:
            raise _Corrupt("coefficient index past 63")


# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(x, shift):
    """libjpeg's islow 8-point IDCT along the first axis of ``x``
    (int64 ``[8, ...]``), descaled by ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0 = t0 * 2446                              # FIX_0_298631336
    t1 = t1 * 16819                             # FIX_2_053119869
    t2 = t2 * 25172                             # FIX_3_072711026
    t3 = t3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3])
    return (out + (1 << (shift - 1))) >> shift


def idct_islow(coef):
    """Dequantised coefficients ``[N, 8, 8]`` (natural order, rows the
    vertical frequency) -> uint8 samples ``[N, 8, 8]``, as
    ``jpeg_idct_islow`` computes them (its range limit too: the result is
    taken modulo 1024 as a signed value, then clamped about 128)."""
    x = np.moveaxis(coef.astype(np.int64), 1, 0)          # [u, N, v]
    ws = _idct_1d(x, _CONST_BITS - _PASS1_BITS)           # columns: [y, N, v]
    out = _idct_1d(np.moveaxis(ws, 2, 0),                 # rows: [x, y, N]
                   _CONST_BITS + _PASS1_BITS + 3)
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8).transpose(2, 1, 0)


def _edge(x, axis, step):
    """``x`` shifted by one along ``axis`` (``step`` -1: each element's
    predecessor, +1: its successor), the edge element repeated."""
    n = x.shape[axis]
    take = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, take, axis=axis)


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample_h2v1(x):
    """libjpeg-turbo's ``h2v1_fancy_upsample``: ``[h, w]`` -> ``[h, 2w]``."""
    x = x.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(x, 2, 1)
    three = 3 * x
    return _interleave((three + _edge(x, 1, -1) + 1) >> 2,
                       (three + _edge(x, 1, 1) + 2) >> 2, 1)


def upsample_h2v2(x):
    """libjpeg-turbo's ``h2v2_fancy_upsample``: ``[h, w]`` -> ``[2h, 2w]``,
    the rows past either edge repeating the edge row."""
    x = x.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(np.repeat(x, 2, 0), 2, 1)
    three = 3 * x
    cols = _interleave(three + _edge(x, 0, -1), three + _edge(x, 0, 1), 0)
    three = 3 * cols
    return _interleave((three + _edge(cols, 1, -1) + 8) >> 4,
                       (three + _edge(cols, 1, 1) + 7) >> 4, 1)


def _fix(x):
    return int(x * (1 << 16) + 0.5)


def ycc_to_rgb(y, cb, cr):
    """``jdcolor.c``'s ``ycc_rgb_convert`` on uint8-valued planes."""
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128
    y = y.astype(np.int32)
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _next_segment(data, pos, path):
    """``(marker, body, position after the body)`` of the marker segment
    at or after ``pos``; None at EOI, or where the data ends without one
    (libjpeg warns and keeps what it decoded)."""
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                       # garbage between segments
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1                       # fill bytes
        if pos >= len(data) or data[pos] == 0xD9:
            return None
        marker = data[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue                       # markers without a length
        if pos + 2 > len(data):
            raise ValueError(f"{path}: JPEG ends inside a marker segment")
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        return marker, data[pos + 2:pos + n], pos + n


def read_jpeg(path):
    """The image of a sequential JPEG file, as ``imageio.v2.imread``
    returns it (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _decode(data, path)
    except _Corrupt as e:
        raise ValueError(f"{path}: corrupt JPEG data ({e})") from None


def _decode(data, path):
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart = None, 0
    jfif, adobe = False, None
    comps, coef_q, coefs = [], {}, array("q")
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    while True:
        segment = _next_segment(data, pos, path)
        if segment is None:
            break
        marker, body, pos = segment
        if marker in _SOF_REFUSED:
            raise ValueError(f"{path}: {_SOF_REFUSED[marker]} JPEG frames "
                             "are not supported")
        if marker in (0xC0, 0xC1):
            prec, h, w, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG samples are not "
                                 "supported")
            if nf not in (1, 3):
                what = ("four components (CMYK or YCCK)" if nf == 4
                        else f"{nf} components")
                raise ValueError(f"{path}: JPEG with {what} is not "
                                 "supported")
            if h == 0:
                raise ValueError(f"{path}: JPEG height set by a DNL marker "
                                 "is not supported")
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = _frame_layout(comps, h, w, path)
        elif marker == 0xC4:
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                counts = list(body[q + 1:q + 17])
                symbols = list(body[q + 17:q + 17 + sum(counts)])
                (dc_tabs if tc == 0 else ac_tabs)[th] = _huffman_tables(
                    counts, symbols)
                q += 17 + sum(counts)
        elif marker == 0xDB:
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                if pq:
                    qt[tq] = np.frombuffer(body, ">u2", 64, q + 1).astype(
                        np.int64)
                    q += 129
                else:
                    qt[tq] = np.frombuffer(body, np.uint8, 64, q + 1).astype(
                        np.int64)
                    q += 65
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            pos = _read_scan(data, body, pos, comps, frame, qt, coef_q,
                             dc_tabs, ac_tabs, restart, coefs, path)
    if frame is None or not coef_q:
        raise ValueError(f"{path}: JPEG without a frame or a scan")
    return _pixels(comps, frame, coef_q, coefs, jfif, adobe)


def _frame_layout(comps, h, w, path):
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    off = 0
    for c in comps:
        if hmax % c["h"] or vmax % c["v"] or (
                len(comps) > 1 and (hmax // c["h"], vmax // c["v"])
                not in ((1, 1), (2, 1), (2, 2))):
            raise ValueError(
                f"{path}: JPEG sampling factors "
                f"{[(k['h'], k['v']) for k in comps]} are not supported "
                "(4:4:4, 4:2:2 and 4:2:0 are)")
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["w"] = -(-w * c["h"] // hmax)
        c["h_px"] = -(-h * c["v"] // vmax)
        c["off"] = off
        off += c["bw"] * c["bh"] * 64
    return {"h": h, "w": w, "hmax": hmax, "vmax": vmax, "mcux": mcux,
            "mcuy": mcuy}


def _read_scan(data, body, pos, comps, frame, qt, coef_q, dc_tabs, ac_tabs,
               restart, coefs, path):
    ns = body[0]
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    scan = []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{path}: JPEG scan names an unknown component")
        ci = by_id[cid]
        if t >> 4 not in dc_tabs or t & 15 not in ac_tabs:
            raise ValueError(f"{path}: JPEG scan uses an undefined Huffman "
                             "table")
        if comps[ci]["tq"] not in qt:
            raise ValueError(f"{path}: JPEG scan uses an undefined "
                             "quantisation table")
        coef_q[ci] = qt[comps[ci]["tq"]].copy()     # latched at its scan
        scan.append((ci, dc_tabs[t >> 4], ac_tabs[t & 15]))
    if ns == 1:
        ci, dct, act = scan[0]
        c = comps[ci]
        ny, nx = np.mgrid[0:-(-c["h_px"] // 8), 0:-(-c["w"] // 8)]
        blocks = (c["off"] + 64 * (ny * c["bw"] + nx)).ravel()
        plan = [(0, *dct, *act)]
    else:
        mcu = []
        plan = []
        for si, (ci, dct, act) in enumerate(scan):
            c = comps[ci]
            for v in range(c["v"]):
                for hh in range(c["h"]):
                    mcu.append((c, v, hh))
                    plan.append((si, *dct, *act))
        my, mx = np.mgrid[0:frame["mcuy"], 0:frame["mcux"]]
        blocks = np.stack([
            c["off"] + 64 * ((my * c["v"] + v) * c["bw"] + mx * c["h"] + hh)
            for c, v, hh in mcu], -1).ravel()
    buf, starts, end = _scan_segments(data, pos)
    _decode_scan(buf, starts, blocks.tolist(), plan, restart * len(plan),
                 coefs)
    return end


def _pixels(comps, frame, coef_q, coefs, jfif, adobe):
    total = sum(c["bw"] * c["bh"] * 64 for c in comps)
    packed = np.frombuffer(coefs, np.int64)
    coef = np.zeros(total, np.int32)
    coef[packed >> 16] = (packed & 0xFFFF).astype(np.uint16).view(np.int16)
    planes = []
    for ci, c in enumerate(comps):
        n = c["bw"] * c["bh"]
        # a component that no scan carried decodes as zero coefficients
        q = coef_q.get(ci, np.zeros(64, np.int64))
        zz = coef[c["off"]:c["off"] + 64 * n].reshape(n, 64)
        px = np.empty((n, 8, 8), np.uint8)
        for b0 in range(0, n, _IDCT_BLOCKS):
            part = zz[b0:b0 + _IDCT_BLOCKS]
            nat = np.empty(part.shape, np.int64)
            nat[:, ZIGZAG] = part * q
            px[b0:b0 + _IDCT_BLOCKS] = idct_islow(nat.reshape(-1, 8, 8))
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])
        plane = plane[:c["h_px"], :c["w"]]
        ratio = (frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        if ratio == (2, 1):
            plane = upsample_h2v1(plane)
        elif ratio == (2, 2):
            plane = upsample_h2v2(plane)
        planes.append(plane[:frame["h"], :frame["w"]])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c["id"] for c in comps)
    rgb = (not jfif) and (adobe == 0 if adobe is not None
                          else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)
