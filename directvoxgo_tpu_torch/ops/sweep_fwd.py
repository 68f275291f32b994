"""Kernel K-A: the station-sweep forward (``csrc/sweep_fwd.cu``).

``sweep_fwd(slabs, rays, k)`` samples every station slab along every ray:
``out[s, c, n] = sum_v wv * sum_u wu * slab[s, u, v, c]`` with hat weights
at ``(u, v) = (ou, ov) + t*(du, dv)``, ``t = (s/k - op)/dp``. With
``v_base``/``wv`` ray ``n`` of tile ``n // TILE_N`` reads only the v-window
``[v_base[tile], v_base[tile] + wv)`` of every slab. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs
:func:`sweep_fwd_plain`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

launches = 0
launches_windowed = 0   # those of ``launches`` that took a v-window
launches_by_form = collections.Counter()   # of ``launches``, by :func:`form`

# Ray-tile width of the per-tile v-windows.
TILE_N = 512
# Channel counts with an instance of their own (the counted view, the coarse
# step, the MPI step, the fine step and render chunk); any other count up to
# the kernel's C_MAX runs through its generic instance.
CHANNEL_INSTANCES = (1, 5, 11, 14)
# The counts of consecutive stations a thread may take.
STATIONS_PER_THREAD_CHOICES = (1, 8)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("sweep_fwd")
    lib.dvgo_sweep_fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                   + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.dvgo_sweep_fwd.restype = ctypes.c_int
    lib.dvgo_sweep_fwd_max_channels.argtypes = []
    lib.dvgo_sweep_fwd_max_channels.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def load_width(c, elem_size, address):
    """Bytes per load of K-A over contiguous slabs of ``c`` channels of
    ``elem_size`` bytes at ``address``: the widest of 16, 8, 4 (and 2 for
    bf16) that divides a voxel's bytes and the address."""
    for vb in (16, 8, 4, 2):
        if vb >= elem_size and (c * elem_size) % vb == 0 and address % vb == 0:
            return vb
    raise ValueError(f"sweep_fwd: no load width for {c} channels of "
                     f"{elem_size} bytes at address {address:#x}")


def stations_per_thread(n, s_total):
    """Consecutive stations a thread takes: one for a step's or a render
    chunk's batch (a few million (ray, station) pairs: the card needs every
    thread), eight where rays x stations exceed 2^24 (a counted view's
    160,000 rays), which shares each ray's loads over the eight."""
    return 8 if n * s_total >= (1 << 24) else 1


def instance(slabs, n):
    """(slab dtype name, the instance's channel count (0: generic), load
    bytes, stations a thread) of the kernel instance that runs on
    contiguous ``slabs`` for ``n`` rays."""
    c = slabs.shape[-1]
    esize = slabs.element_size()
    return ("bf16" if esize == 2 else "f32",
            c if c in CHANNEL_INSTANCES else 0,
            load_width(c, esize, slabs.data_ptr()),
            stations_per_thread(n, slabs.shape[0]))


def form(inst, windowed):
    """Name of a launch's kernel instance (:func:`instance`) and form."""
    dtype, c, vec_bytes, spt = inst
    return (f"{dtype} C={c or 'generic'} {vec_bytes}B x{spt}"
            + (" windowed" if windowed else ""))


def station_uv(rays, s, k):
    """(u, v) [N] of every ray at station ``s`` as the kernels compute
    them: ``t`` by one division, then one fused multiply-add each."""
    op, ou, ov, dp, du, dv = rays
    t = (torch.tensor(s, dtype=torch.float32) / k - op) / dp
    u = (t.double() * du.double() + ou.double()).float()
    v = (t.double() * dv.double() + ov.double()).float()
    return u, v


def window_rows(v_base, wv, n, gv, device, segment=False):
    """[N, Gv] bool: the v columns each ray's window ``[vb, vb + wv)``
    covers (``segment``: every ray takes the last entry of ``v_base``)."""
    if segment:
        vb = v_base[-1:].expand(n)
    else:
        vb = v_base[torch.arange(n, device=device) // TILE_N]
    iota = torch.arange(gv, device=device)
    return (iota >= vb[:, None]) & (iota < vb[:, None] + wv)


def sweep_fwd_plain(slabs, rays, k, v_base=None, wv=0):
    """Plain version: per station, dense hat rows ``wu [N, Gu]`` (rounded to
    the slab dtype) times the slab in f32, then the f32 ``wv`` reduction
    (over the ray tile's v-window only when ``wv > 0``)."""
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    iota_u = torch.arange(gu, dtype=torch.float32, device=rays.device)
    iota_v = torch.arange(gv, dtype=torch.float32, device=rays.device)
    win = window_rows(v_base, wv, n, gv, rays.device) if wv else None
    out = torch.empty((s_total, c, n), dtype=torch.float32,
                      device=rays.device)
    for s in range(s_total):
        u, v = station_uv(rays, s, k)
        wu = torch.clamp(1.0 - (u[:, None] - iota_u).abs(), min=0.0)
        wu = wu.to(slabs.dtype).float()
        w_v = torch.clamp(1.0 - (v[:, None] - iota_v).abs(), min=0.0)
        if win is not None:
            w_v = torch.where(win, w_v, torch.zeros_like(w_v))
        tmp = wu @ slabs[s].reshape(gu, gv * c).float()
        out[s] = torch.einsum("nvc,nv->cn", tmp.reshape(n, gv, c), w_v)
    return out


def check_window(name, v_base, wv, n, device, entries):
    """Validate a v-window argument pair; ``entries``: allowed lengths."""
    if wv < 1 or v_base is None:
        raise ValueError(f"{name}: a window needs v_base and wv >= 1")
    if (v_base.dtype != torch.int32 or v_base.dim() != 1
            or v_base.device != device or not v_base.is_contiguous()
            or v_base.shape[0] not in entries):
        raise ValueError(f"{name}: v_base must be a contiguous int32 vector "
                         f"of length in {sorted(entries)} on {device}")


def sweep_fwd(slabs, rays, k, v_base=None, wv=0):
    """slabs [S, Gu, Gv, C] bf16 or f32 station slabs (channel-minor);
    rays [6, N] f32 rows (op, ou, ov, dp, du, dv), ``dp`` already nonzero;
    k stations per voxel; optional ``v_base`` [ceil(N / TILE_N)] int32
    window starts with width ``wv``. Returns [S, C, N] f32."""
    global launches, launches_windowed
    wv = int(wv)
    if wv:
        check_window("sweep_fwd", v_base, wv, rays.shape[1], rays.device,
                     {-(-rays.shape[1] // TILE_N)})
    if slabs.device.type == "cpu" and rays.device.type == "cpu":
        return sweep_fwd_plain(slabs, rays, k, v_base, wv)
    if not (slabs.is_cuda and rays.device == slabs.device):
        raise ValueError("sweep_fwd: slabs and rays must be on one CUDA "
                         "device")
    if slabs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sweep_fwd: slab dtype {slabs.dtype}")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError("sweep_fwd: rays must be [6, N] float32")
    if slabs.dim() != 4 or not (slabs.is_contiguous()
                                and rays.is_contiguous()):
        raise ValueError("sweep_fwd: expects contiguous [S, Gu, Gv, C] "
                         "slabs and [6, N] rays")
    s_total, gu, gv, c = slabs.shape
    n = rays.shape[1]
    lib = _lib()
    if c > lib.dvgo_sweep_fwd_max_channels():
        raise ValueError(f"sweep_fwd: {c} channels exceed the kernel's "
                         "register budget")
    inst = instance(slabs, n)
    out = torch.empty((s_total, c, n), dtype=torch.float32,
                      device=slabs.device)
    err = lib.dvgo_sweep_fwd(
        slabs.data_ptr(), int(slabs.dtype == torch.bfloat16),
        rays.data_ptr(), v_base.data_ptr() if wv else None, out.data_ptr(),
        n, s_total, gu, gv, c, inst[2], int(k), wv, TILE_N, inst[3],
        torch.cuda.current_stream(slabs.device).cuda_stream)
    if err:
        raise RuntimeError("sweep_fwd launch failed: "
                           + lib.dvgo_error_string(err).decode())
    launches += 1
    launches_windowed += bool(wv)
    launches_by_form[form(inst, bool(wv))] += 1
    return out
