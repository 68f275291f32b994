"""Kernel K-G: the per-op cost probe (``csrc/probe_ops.cu``).

The Hopper counterpart of the JAX package's Mosaic probe
(``tools/probe_mosaic.py``): eleven op classes at the fused frame kernels'
shapes, plus a null body. One launch runs ``g`` blocks; each block runs
``reps`` op bodies, rep ``i`` reading its own weight slice ``w[i]``, and
sums every element of every output into its digest ``partial[block]``
(f64). The digest of the launch is the sum of the partials. Per-op cost is
``(t(g) - t_null(g)) / (g * reps)`` (``tools/probe_ops.py``).

Classes (x, w[i] -> output of one op; bf16 operands, f32 results):

  * ``null``   x [8,128] f32 -> x * 1.0001 (no w);
  * ``b12``    [12,128,160] x [12,160,128] batched;
  * ``b8geo``  [8,128,160] x [8,160,320] batched;
  * ``lead``   [12,128,128] contracted over the leading dim with [12,128]
    (stored with 4 zero rows, [16,...], for the tensor cores' k of 16;
    the contraction is the same);
  * ``mm``     [128,160] @ [160,1920];  ``mmT``  [1920,160] @ [160,128]
    (the rep indexes the left operand);
  * ``small``  [128,160] . [128,160]^T;
  * ``acc``    bf16 product of [128,128,128] by a [1,128] row, rounded to
    bf16;
  * ``r3dot``  [128,128,128] @ [128,128];  ``r3f``  [16384,128] @ [128,128];
  * ``vpu2d``  f32 exp(x * w) on [128,128];  ``vpu3d8`` on [8,128,128].

:func:`probe` launches the kernel for CUDA tensors (or raises) and runs
:func:`probe_plain`, the same digest in plain PyTorch, for CPU tensors.
The matmul classes run on ``wgmma`` from shared memory in the loop order
:func:`gemm_plan` sets out (reps inner: the operand without the rep index
held across them); :func:`probe_first` launches the first version
(``csrc/probe_ops_first.cu``), kept as the redesign's yardstick and never
used by the port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

BF16 = torch.bfloat16
F32 = torch.float32
G = 512          # blocks of a timed launch (the TPU probe's grid)
R = 8            # weight slices per class

# name: (x shape, x dtype, w shape or None, reps, body). A gemm body is
# (batch, m, n, k, a_bat, a_rep, lda, a_col, b_bat, b_rep, ldb, b_col) in
# elements; an elementwise body is (kind, period) as csrc/probe_ops.cu's
# elem_probe takes them.
CLASSES = {
    "null": ((8, 128), F32, None, 1, ("elem", 0, 1)),
    "b12": ((12, 128, 160), BF16, (R, 12, 160, 128), 8,
            ("gemm", 12, 128, 128, 160, 128 * 160, 0, 160, 0,
             160 * 128, 12 * 160 * 128, 128, 0)),
    "b8geo": ((8, 128, 160), BF16, (R, 8, 160, 320), 8,
              ("gemm", 8, 128, 320, 160, 128 * 160, 0, 160, 0,
               160 * 320, 8 * 160 * 320, 320, 0)),
    "lead": ((16, 128, 128), BF16, (R, 16, 128), 4,
             ("gemm", 1, 128 * 128, 128, 16, 0, 0, 128 * 128, 1,
              0, 16 * 128, 128, 0)),
    "mm": ((128, 160), BF16, (R, 160, 1920), 8,
           ("gemm", 1, 128, 1920, 160, 0, 0, 160, 0,
            0, 160 * 1920, 1920, 0)),
    "mmT": ((R, 1920, 160), BF16, (160, 128), 8,
            ("gemm", 1, 1920, 128, 160, 0, 1920 * 160, 160, 0,
             0, 0, 128, 0)),
    "small": ((128, 160), BF16, (R, 128, 160), 8,
              ("gemm", 1, 128, 128, 160, 0, 0, 160, 0,
               0, 128 * 160, 160, 1)),
    "acc": ((128, 128, 128), BF16, (R, 1, 128), 8, ("elem", 1, 128)),
    "r3dot": ((128, 128, 128), BF16, (R, 128, 128), 4,
              ("gemm", 1, 128 * 128, 128, 128, 0, 0, 128, 0,
               0, 128 * 128, 128, 0)),
    "r3f": ((128 * 128, 128), BF16, (R, 128, 128), 4,
            ("gemm", 1, 128 * 128, 128, 128, 0, 0, 128, 0,
             0, 128 * 128, 128, 0)),
    "vpu2d": ((128, 128), F32, (R, 128, 128), 8, ("elem", 2, 1)),
    "vpu3d8": ((8, 128, 128), F32, (R, 8, 128, 128), 8, ("elem", 2, 1)),
}
# Contracted length each matmul class needs (lead's k is 12 of its 16).
K_TRUE = {"lead": 12}

launches = {name: 0 for name in CLASSES}

# The kernel's loop for a matmul class (csrc/probe_ops.cu's Plan, in this
# order): for o < n_o the held operand takes slot o % h_slots (n_h tiles
# from held(o, h) = base + o*h_so + h*h_sh); then for j < n_j one streamed
# tile from base + o*s_so + (j // s_jdiv)*s_sj1 + (j % s_jdiv)*s_sj2 through
# a ring of ``stages``, and its products. A and B are read as [a_total][lda]
# and [b_total][ldb] (the kernel's TMA tensor maps); a tile spans a_rows x
# a_cols of A, a B tile b_rows x b_cols; mt and n are the M and N of a step,
# k its K; a_mn / b_mn mark an operand stored MN-major; a_sw / b_sw are the
# bytes of its swizzle (128 where its tile's contiguous extent holds whole
# 64-column atoms, else 64).
PLAN_FIELDS = ("n_o", "n_j", "n_h", "h_slots", "stages", "a_streamed",
               "a_total", "b_total", "a_rows", "a_cols", "lda", "b_rows",
               "b_cols", "ldb", "s_so", "s_jdiv", "s_sj1", "s_sj2", "h_so",
               "h_sh", "mt", "n", "k", "a_mn", "b_mn", "a_sw", "b_sw")
# Dynamic shared memory a plan may take: the H100's 227 KB a block, less
# 1 KB for the static barriers and sums.
SMEM_LIMIT = 232448 - 1024
MAX_STAGES = 8
TILE_BYTES = 32768     # A tiles streamed by the classes with m > 128
N_TILES = (128, 64)    # B's n-tile: the first that divides n


def gemm_plan(name, reps):
    """The loop of class ``name``'s matmul body at ``reps`` reps as a dict
    of :data:`PLAN_FIELDS`: the operand without the rep index is held in
    shared memory across the reps, the rep-indexed one streams. mmT holds
    w and streams 128-row tiles of x[i]; r3dot, r3f and lead (m > 128)
    hold every rep's w[i] and stream x in tiles of TILE_BYTES; the others
    (m = 128) hold x (a batch entry at a time, two slots) and stream w[i]
    in n-tiles of :data:`N_TILES` (b8geo's n = 320 is above wgmma's 256:
    tiles of 64, which leave room for 7 stages where 160 left 2). The ring
    takes what shared memory the held slots leave, up to MAX_STAGES."""
    body = CLASSES[name][4]
    if body[0] != "gemm":
        raise ValueError(f"probe {name}: not a matmul class")
    (batch, m, n, k, a_bat, a_rep, lda, a_col,
     b_bat, b_rep, ldb, b_col) = body[1:]
    x_shape, _, w_shape = CLASSES[name][:3]
    p = dict(n_o=batch, lda=lda, ldb=ldb, k=k, a_mn=a_col, b_mn=1 - b_col,
             a_total=math.prod(x_shape) // lda,
             b_total=math.prod(w_shape) // ldb)
    if a_rep:
        mt, nt = 128, n
        p.update(a_streamed=1, n_h=1, h_slots=1, n_j=reps * (m // mt),
                 s_so=a_bat, s_jdiv=m // mt, s_sj1=a_rep,
                 s_sj2=mt if a_col else mt * lda, h_so=b_bat, h_sh=0)
    elif m > 128:
        mt, nt = min(m, 128 * max(1, TILE_BYTES // (2 * k * 128))), n
        p.update(a_streamed=1, n_h=reps, h_slots=1, n_j=m // mt, s_so=a_bat,
                 s_jdiv=1, s_sj1=mt if a_col else mt * lda, s_sj2=0,
                 h_so=b_bat, h_sh=b_rep)
    else:
        mt, nt = m, next(t for t in N_TILES if n % t == 0)
        p.update(a_streamed=0, n_h=1, h_slots=min(2, batch),
                 n_j=reps * (n // nt), s_so=b_bat, s_jdiv=n // nt,
                 s_sj1=b_rep, s_sj2=nt * ldb if b_col else nt, h_so=a_bat,
                 h_sh=0)
    p.update(mt=mt, n=nt, stages=0)
    p["a_rows"], p["a_cols"] = (k, mt) if a_col else (mt, k)
    p["b_rows"], p["b_cols"] = (nt, k) if b_col else (k, nt)
    p["a_sw"], p["b_sw"] = (64 if p[c] % 64 else 128
                            for c in ("a_cols", "b_cols"))
    s_bytes = 2 * (p["a_rows"] * p["a_cols"] if p["a_streamed"]
                   else p["b_rows"] * p["b_cols"])
    p["stages"] = min(MAX_STAGES, p["n_o"] * p["n_j"],
                      (SMEM_LIMIT - plan_smem(p)) // s_bytes)
    if p["stages"] < 2 or m % mt or nt > 256 or k % 16:
        raise ValueError(f"probe {name}: no plan fits shared memory")
    return p


def plan_smem(p):
    """Dynamic shared memory bytes of plan ``p``: its held slots, its ring
    and 1024 for the base's alignment (as csrc/probe_ops.cu counts them)."""
    a_bytes = 2 * p["a_rows"] * p["a_cols"]
    b_bytes = 2 * p["b_rows"] * p["b_cols"]
    s_bytes, h_bytes = (a_bytes, b_bytes) if p["a_streamed"] else (
        b_bytes, a_bytes)
    return p["h_slots"] * p["n_h"] * h_bytes + p["stages"] * s_bytes + 1024


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("probe_ops")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dvgo_probe_gemm.argtypes = [p, p, p, ctypes.POINTER(ll), i, i, p]
    lib.dvgo_probe_elem.argtypes = [i, p, p, p, i, ll, i, i, i, p]
    lib.dvgo_probe_plan_len.argtypes = []
    for fn in (lib.dvgo_probe_gemm, lib.dvgo_probe_elem,
               lib.dvgo_probe_plan_len):
        fn.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def _lib_first():
    """The first version's library (``csrc/probe_ops_first.cu``), with its
    C signatures declared."""
    lib = _build.load("probe_ops_first")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dvgo_probe_gemm.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, ll,
                                    ll, i, i, i, i, p]
    lib.dvgo_probe_elem.argtypes = [i, p, p, p, i, ll, i, i, i, p]
    for fn in (lib.dvgo_probe_gemm, lib.dvgo_probe_elem):
        fn.restype = ctypes.c_int
    lib.dvgo_error_string.argtypes = [ctypes.c_int]
    lib.dvgo_error_string.restype = ctypes.c_char_p
    return lib


def body_plain(name, x, w, i):
    """Rep ``i`` of class ``name``: its f32 output in plain PyTorch (f32
    arithmetic on the bf16 values: products exact, sums in f32)."""
    if name == "null":
        return x * 1.0001
    xf = x.float()
    wf = w.float()
    if name in ("b12", "b8geo"):
        return torch.bmm(xf, wf[i])
    if name == "lead":
        return torch.einsum("kab,kc->abc", xf, wf[i])
    if name in ("mm", "r3dot", "r3f"):
        return xf @ wf[i]
    if name == "mmT":
        return xf[i] @ wf
    if name == "small":
        return xf @ wf[i].t()
    if name == "acc":
        return (xf * wf[i]).to(BF16).float()
    if name in ("vpu2d", "vpu3d8"):
        return torch.exp(x * w[i])
    raise ValueError(f"probe: unknown class {name!r}")


def probe_plain(name, x, w, g, reps=None, terms=None):
    """Plain version of the kernel: every block computes the same digest,
    so it is computed once (f64 sum of each rep's f32 output) and repeated
    ``g`` times. ``terms``, when a dict, receives ``abs_sum``: the sum of
    |output element| over the launch, the scale of the digest's error."""
    reps = CLASSES[name][3] if reps is None else reps
    digest = torch.zeros((), dtype=torch.float64, device=x.device)
    abs_sum = 0.0
    for i in range(reps):
        out = body_plain(name, x, w, i).double()
        digest += out.sum()
        if terms is not None:
            abs_sum += float(out.abs().sum())
    if terms is not None:
        terms["abs_sum"] = g * abs_sum
    return digest.expand(g).clone()


def _check(name, x, w, reps):
    if name not in CLASSES:
        raise ValueError(f"probe: unknown class {name!r}")
    x_shape, x_dtype, w_shape = CLASSES[name][:3]
    for what, t, shape, dtype in (("x", x, x_shape, x_dtype),
                                  ("w", w, w_shape, x_dtype)):
        if shape is None:
            if t is not None:
                raise ValueError(f"probe {name}: takes no {what}")
            continue
        if t is None or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"probe {name}: {what} must be {dtype} of shape {shape}, "
                f"got {None if t is None else (t.dtype, tuple(t.shape))}")
        if t.device != x.device:
            raise ValueError(f"probe {name}: {what} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe {name}: {what} must be contiguous")
    if not 1 <= reps <= R:
        raise ValueError(f"probe {name}: reps {reps} out of range")


def _launch(name, x, w, g, reps, first):
    """Digest partials of one launch of the kernel (or of its first
    version) on CUDA tensors; raises if the launch is refused."""
    body = CLASSES[name][4]
    dev = x.device
    partial = torch.empty(g, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib_first() if first else _lib()
    # TMA and 16-byte loads; the first version's wmma fragment loads, 32.
    align = 32 if first and body[0] == "gemm" else 16
    for what, t in (("x", x), ("w", w)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"probe {name}: {what} must be {align}-byte "
                             "aligned")
    if body[0] == "gemm":
        if first:
            err = lib.dvgo_probe_gemm(x.data_ptr(), w.data_ptr(),
                                      partial.data_ptr(), *body[1:], g, reps,
                                      stream)
        else:
            plan = gemm_plan(name, reps)
            if lib.dvgo_probe_plan_len() != len(PLAN_FIELDS):
                raise RuntimeError("probe: the kernel's plan has "
                                   f"{lib.dvgo_probe_plan_len()} fields, "
                                   f"the wrapper's {len(PLAN_FIELDS)}")
            arr = (ctypes.c_longlong * len(PLAN_FIELDS))(
                *(plan[f] for f in PLAN_FIELDS))
            err = lib.dvgo_probe_gemm(x.data_ptr(), w.data_ptr(),
                                      partial.data_ptr(), arr,
                                      len(PLAN_FIELDS), g, stream)
    else:
        kind, period = body[1:]
        w_rep = 0 if w is None else w[0].numel()
        err = lib.dvgo_probe_elem(kind, x.data_ptr(),
                                  (x if w is None else w).data_ptr(),
                                  partial.data_ptr(), x.numel(), w_rep,
                                  period, g, reps, stream)
    if err:
        raise RuntimeError(f"probe {name} launch failed: "
                           + lib.dvgo_error_string(err).decode())
    return partial


def _run(name, x, w, g, reps, first):
    reps = CLASSES[name][3] if reps is None else reps
    _check(name, x, w, reps)
    dev = x.device
    if dev.type == "cpu":
        return probe_plain(name, x, w, g, reps)
    if dev.type != "cuda":
        raise ValueError(f"probe: unsupported device {dev}")
    partial = _launch(name, x, w, g, reps, first)
    if not first:
        launches[name] += 1
    return partial


def probe(name, x, w, g, reps=None):
    """Digest partials ``[g]`` f64 of ``g`` blocks of ``reps`` op bodies of
    class ``name`` (default: the class's reps) on inputs ``x``, ``w`` of the
    class's shapes (:data:`CLASSES`)."""
    return _run(name, x, w, g, reps, first=False)


def probe_first(name, x, w, g, reps=None):
    """:func:`probe` through the first version of the kernel
    (``csrc/probe_ops_first.cu``), on the same inputs; uncounted."""
    return _run(name, x, w, g, reps, first=True)
