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
"""

from __future__ import annotations

import ctypes

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


def _lib():
    """The kernel library, with every C function's signature declared."""
    lib = _build.load("probe_ops")
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


def probe(name, x, w, g, reps=None):
    """Digest partials ``[g]`` f64 of ``g`` blocks of ``reps`` op bodies of
    class ``name`` (default: the class's reps) on inputs ``x``, ``w`` of the
    class's shapes (:data:`CLASSES`)."""
    reps = CLASSES[name][3] if reps is None else reps
    _check(name, x, w, reps)
    dev = x.device
    if dev.type == "cpu":
        return probe_plain(name, x, w, g, reps)
    if dev.type != "cuda":
        raise ValueError(f"probe: unsupported device {dev}")
    body = CLASSES[name][4]
    partial = torch.empty(g, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if body[0] == "gemm":
        if x.data_ptr() % 32 or w.data_ptr() % 32:
            raise ValueError(f"probe {name}: operands must be 32-byte "
                             "aligned (wmma fragment loads)")
        err = lib.dvgo_probe_gemm(x.data_ptr(), w.data_ptr(),
                                  partial.data_ptr(), *body[1:], g, reps,
                                  stream)
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
    launches[name] += 1
    return partial
