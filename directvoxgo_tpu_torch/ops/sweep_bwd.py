"""Kernel K-C: the station-sweep backward (``csrc/sweep_bwd.cu``).

``sweep_bwd(g, rays, k, grid_shape, interp_dtype)`` is the transpose of
:func:`.sweep_fwd.sweep_fwd` with respect to the permuted grid: station
``s = z*k + j`` of ray ``n`` adds ``wu * rnd(wv * g[s, c, n])`` at its four
taps, ``(1 - j/k)`` of it to grid slab ``z`` and ``j/k`` to slab ``z + 1``.
One function serves the three forms of the JAX backward: the full
transpose, the per-ray-tile windowed form (``v_base`` of ``n_tiles``
entries) and the segment form (``n_tiles + 1`` entries, the last one the
whole batch's window). On a CUDA tensor it launches the kernel (or raises);
on a CPU tensor it runs :func:`sweep_bwd_plain`.

The kernel sums with f32 atomics, whose order varies from run to run: two
runs agree to f32 rounding of the sums (and, after the cast to a bf16 grid
dtype, to one bf16 ulp), not bit for bit. The plain version is
deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sweep_fwd import TILE_N, check_window, station_uv, window_rows

launches = 0


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("sweep_bwd")
    lib.dvgo_sweep_bwd.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.dvgo_sweep_bwd.restype = ctypes.c_int
    lib.dvgo_sweep_bwd_max_channels.argtypes = []
    lib.dvgo_sweep_bwd_max_channels.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def _window_form(v_base, wv, n):
    """(wv, segment?) of a window argument pair; wv 0 = full transpose."""
    wv = int(wv)
    if not wv or v_base is None or v_base.shape[0] == 0:
        return 0, False
    n_tiles = -(-n // TILE_N)
    return wv, v_base.shape[0] == n_tiles + 1


def sweep_bwd_plain(g, rays, k, grid_shape, interp_dtype, v_base=None, wv=0):
    """Plain version: per station the dense hat rows ``wu [N, Gu]`` (rounded
    to ``interp_dtype``), ``rhs = rnd(wv[N, Gv] * g)``, ``wu^T @ rhs`` in
    f32, split (1-f)/f onto the two bracketing grid slabs. Returns the f32
    accumulator [Gp, Gu, Gv, C]."""
    gp, gu, gv, c = grid_shape
    s_total, _, n = g.shape
    dev = rays.device
    wv, segment = _window_form(v_base, wv, n)
    iota_u = torch.arange(gu, dtype=torch.float32, device=dev)
    iota_v = torch.arange(gv, dtype=torch.float32, device=dev)
    win = window_rows(v_base, wv, n, gv, dev, segment) if wv else None
    acc = torch.zeros((gp, gu, gv, c), dtype=torch.float32, device=dev)
    for s in range(s_total):
        u, v = station_uv(rays, s, k)
        wu = torch.clamp(1.0 - (u[:, None] - iota_u).abs(), min=0.0)
        wu = wu.to(interp_dtype).float()
        w_v = torch.clamp(1.0 - (v[:, None] - iota_v).abs(), min=0.0)
        if win is not None:
            w_v = torch.where(win, w_v, torch.zeros_like(w_v))
        rhs = (w_v[:, :, None] * g[s].t()[:, None, :]).to(interp_dtype)
        d_st = (wu.t() @ rhs.float().reshape(n, gv * c)).reshape(gu, gv, c)
        z, j = divmod(s, k)
        f = j / k
        acc[z] += (1.0 - f) * d_st
        if j:
            acc[z + 1] += f * d_st
    return acc


def sweep_bwd(g, rays, k, grid_shape, interp_dtype, v_base=None, wv=0,
              out_dtype=None):
    """g [S, C, N] f32 contiguous station cotangents; rays [6, N] f32 rows
    (op, ou, ov, dp, du, dv), ``dp`` already nonzero; ``grid_shape`` (Gp, Gu,
    Gv, C) with S = k*(Gp-1)+1; ``interp_dtype`` bf16 or f32 (the sweep's
    rounding points). Optional ``v_base`` int32 of ``n_tiles`` (per-tile
    windows) or ``n_tiles + 1`` entries (segment: the last entry is the
    batch's window) with width ``wv``. Returns the grid cotangent
    [Gp, Gu, Gv, C] in ``out_dtype`` (default: ``interp_dtype``)."""
    global launches
    gp, gu, gv, c = (int(x) for x in grid_shape)
    out_dtype = out_dtype or interp_dtype
    if g.dim() != 3 or rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError("sweep_bwd: expects g [S, C, N] and rays [6, N]")
    s_total, c_g, n = g.shape
    if c_g != c or s_total != k * (gp - 1) + 1 or rays.shape[1] != n:
        raise ValueError(f"sweep_bwd: g {tuple(g.shape)} does not match grid "
                         f"{(gp, gu, gv, c)} at k={k}, N={rays.shape[1]}")
    if interp_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sweep_bwd: interp dtype {interp_dtype}")
    if g.dtype != torch.float32 or rays.dtype != torch.float32:
        raise TypeError("sweep_bwd: g and rays must be float32")
    wv, segment = _window_form(v_base, wv, n)
    if wv:
        n_tiles = -(-n // TILE_N)
        check_window("sweep_bwd", v_base, wv, n, rays.device,
                     {n_tiles, n_tiles + 1})
    if g.device.type == "cpu" and rays.device.type == "cpu":
        return sweep_bwd_plain(g, rays, k, (gp, gu, gv, c), interp_dtype,
                               v_base, wv).to(out_dtype)
    if not (g.is_cuda and rays.device == g.device):
        raise ValueError("sweep_bwd: g and rays must be on one CUDA device")
    if not (g.is_contiguous() and rays.is_contiguous()):
        raise ValueError("sweep_bwd: expects contiguous g and rays")
    lib = _lib()
    if c > lib.dvgo_sweep_bwd_max_channels():
        raise ValueError(f"sweep_bwd: {c} channels exceed the kernel's "
                         "register budget")
    acc = torch.zeros((gp, gu, gv, c), dtype=torch.float32, device=g.device)
    err = lib.dvgo_sweep_bwd(
        g.data_ptr(), rays.data_ptr(), v_base.data_ptr() if wv else None,
        acc.data_ptr(), n, s_total, gu, gv, c, int(k),
        int(interp_dtype == torch.bfloat16), wv,
        0 if not wv else (2 if segment else 1), TILE_N,
        v_base.shape[0] - 1 if segment else 0,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError("sweep_bwd launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    return acc.to(out_dtype)
