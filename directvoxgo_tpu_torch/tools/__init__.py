"""Harnesses of the port's kernels (each runnable with ``python -m``):

  * ``bench_framekernel`` — the fused frame kernel's three forms (v1, v3,
    v4), numerics and timing;
  * ``probe_ops``         — per-op costs of the frame kernels' op classes
    (kernel K-G);
  * ``trace_step``        — the device time and operators of eager unfused
    window train steps at full lego width.
"""
