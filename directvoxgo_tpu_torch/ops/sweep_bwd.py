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

The kernel has two forms (:func:`form`): the global one, one thread per
(ray, station) reducing each tap into the f32 accumulator in device memory,
and the shared one for station planes that fit in a block's shared memory,
which sums a station's taps there first (:func:`shared_form` picks it from
the shape and the card's limits). The accumulator is a scratch buffer per
device that stays zero between calls; a byte per voxel marks the voxels a
call touched, and the finishing pass copies only those into the
zero-filled output and zeroes them again in the scratch.

The kernel sums with f32 reductions, whose order varies from run to run:
two runs agree to f32 rounding of the sums (and, after the cast to a bf16
grid dtype, to one bf16 ulp), not bit for bit. The plain version is
deterministic.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from .sweep_fwd import (CHANNEL_INSTANCES, TILE_N, check_window, station_uv,
                        window_rows)

launches = 0
launches_by_form = collections.Counter()   # of ``launches``, by :func:`form`

# Threads of a shared-form block (csrc/sweep_bwd.cu: SHARED_THREADS).
SHARED_THREADS = 512
# Waves of shared-form blocks: more blocks than SM slots keep the card
# busy while some blocks zero or flush their plane.
SHARED_WAVES = 4
# torch.device -> [f32 scratch accumulator (zero between calls), uint8
# touch marks, the last call's epoch 1..255] (:func:`take_scratch`).
_scratch = {}
_limits = {}   # device index -> device_limits()


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("sweep_bwd")
    lib.dvgo_sweep_bwd.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 13
        + [ctypes.c_void_p])
    lib.dvgo_sweep_bwd.restype = ctypes.c_int
    lib.dvgo_sweep_bwd_finish.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p])
    lib.dvgo_sweep_bwd_finish.restype = ctypes.c_int
    lib.dvgo_sweep_bwd_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.dvgo_sweep_bwd_limits.restype = ctypes.c_int
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


def acc_stride(c):
    """Channel stride of the kernel's f32 accumulator: 1 for one channel,
    else C rounded up to whole 16-byte vectors (its reductions are
    ``red.global.add.v4.f32``)."""
    return 1 if c == 1 else -(-c // 4) * 4


def shared_form(gu, gv, c, n, smem_optin):
    """Whether K-C takes its shared-memory form: one station plane of f32
    accumulators ``[Gu, Gv, C]`` fits in the dynamic shared memory a block
    may opt into, and the batch brings at least 16 taps (four rays) a voxel
    of the plane. Zeroing and flushing a plane costs a block in proportion
    to the plane; only dense batches (a counted view: 160,000 rays over
    104x96 voxels) contend enough on the plane for that to pay, while a
    step's 8192 scattered rays do better in the global form."""
    return gu * gv * c * 4 <= smem_optin and n >= 4 * gu * gv


def shared_chunks(n, s_total, plane_bytes, smem_per_sm, n_sms):
    """Ray chunks per station of the shared form: enough blocks for
    ``SHARED_WAVES`` waves of the card (blocks per SM by shared memory, 1 KB
    of it reserved per block, and by threads), each chunk at least four
    rays a thread."""
    per_sm = max(1, min(smem_per_sm // (plane_bytes + 1024),
                        2048 // SHARED_THREADS))
    want = max(1, SHARED_WAVES * per_sm * n_sms // s_total)
    return max(1, min(want, n // (4 * SHARED_THREADS)))


def plan(gu, gv, c, n, s_total, limits):
    """(shared form?, ray chunks per station or 0) of a launch, from the
    shape and the card's ``limits`` (:func:`device_limits`)."""
    smem_optin, smem_per_sm, n_sms = limits
    if not shared_form(gu, gv, c, n, smem_optin):
        return False, 0
    return True, shared_chunks(n, s_total, gu * gv * c * 4, smem_per_sm,
                               n_sms)


def instance(shared, c, interp_bf16):
    """(kernel, interp dtype is bf16, the instance's channel count (0:
    generic)) of the scatter kernel a launch runs."""
    return ("sweep_bwd_shared" if shared else "sweep_bwd_global",
            bool(interp_bf16), c if c in CHANNEL_INSTANCES else 0)


def form(inst, s_fast):
    """Name of a launch's kernel instance (:func:`instance`) and of the
    cotangent layout it read."""
    kernel, bf16, c = inst
    return (f"{kernel.rsplit('_', 1)[1]} C={c or 'generic'} "
            f"{'bf16' if bf16 else 'f32'}"
            + (" station-major g" if s_fast else ""))


def station_major(g):
    """Whether the kernel reads cotangent ``g`` [S, C, N] with its lanes
    along stations (the station axis has unit stride, the ray axis not)."""
    return g.stride(0) == 1 and g.stride(2) != 1


def device_limits(device):
    """(opt-in shared memory per block, shared memory per SM, SMs) of CUDA
    device ``device`` (an index)."""
    if device not in _limits:
        lib = _lib()
        out = (ctypes.c_int * 3)()
        err = lib.dvgo_sweep_bwd_limits(device, out)
        if err:
            raise RuntimeError("sweep_bwd: device limits: "
                               + lib.dvgo_error_string(err).decode())
        _limits[device] = tuple(out)
    return _limits[device]


def take_scratch(device, n_vox, a_s):
    """The scratch of ``device`` (a ``torch.device``; grown to ``n_vox``
    voxels of ``a_s`` floats, zero between calls) and its touch marks, with
    this call's epoch: marks of earlier calls never equal it (all are
    cleared when the epoch wraps past 255)."""
    st = _scratch.get(device)
    if st is None or st[0].numel() < n_vox * a_s or st[1].numel() < n_vox:
        old = (0, 0) if st is None else (st[0].numel(), st[1].numel())
        st = [torch.zeros(max(n_vox * a_s, old[0]), dtype=torch.float32,
                          device=device),
              torch.zeros(max(n_vox, old[1]), dtype=torch.uint8,
                          device=device), 0]
        _scratch[device] = st
    st[2] += 1
    if st[2] > 255:
        st[1].zero_()
        st[2] = 1
    return st


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
    """g [S, C, N] f32 station cotangents (any strides); rays [6, N] f32 rows
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
    if not rays.is_contiguous():
        raise ValueError("sweep_bwd: expects contiguous rays")
    lib = _lib()
    if c > lib.dvgo_sweep_bwd_max_channels():
        raise ValueError(f"sweep_bwd: {c} channels exceed the kernel's "
                         "register budget")
    shared, chunks = plan(gu, gv, c, n, s_total,
                          device_limits(g.device.index))
    n_vox, a_s = gp * gu * gv, acc_stride(c)
    acc, marks, epoch = take_scratch(g.device, n_vox, a_s)
    direct = out_dtype in (torch.bfloat16, torch.float32)
    out = torch.zeros((gp, gu, gv, c), device=g.device,
                      dtype=out_dtype if direct else torch.float32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dvgo_sweep_bwd(
        g.data_ptr(), *g.stride(), rays.data_ptr(),
        v_base.data_ptr() if wv else None, acc.data_ptr(), a_s,
        marks.data_ptr(), epoch, n, s_total, gu, gv, c, int(k),
        int(interp_dtype == torch.bfloat16), wv,
        0 if not wv else (2 if segment else 1), TILE_N,
        v_base.shape[0] - 1 if segment else 0, chunks, stream)
    if not err:
        err = lib.dvgo_sweep_bwd_finish(
            acc.data_ptr(), a_s, marks.data_ptr(), epoch, out.data_ptr(),
            int(out.dtype == torch.bfloat16), n_vox, c, stream)
    if err:
        # the scratch may hold sums now: a later call starts a fresh one
        del _scratch[g.device]
        raise RuntimeError("sweep_bwd launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    launches_by_form[form(instance(shared, c, interp_dtype == torch.bfloat16),
                          station_major(g))] += 1
    return out if direct else out.to(out_dtype)
