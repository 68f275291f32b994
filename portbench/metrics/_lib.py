"""What the metric readers share. A reader is ``metrics/<metric>.py``
with ``read(rec)``: the metric's value from the run's record, or None when
the run has nothing to read for it (the harness then leaves it out)."""

from portbench import counts, devtrace

# Kernel names (as the profiler reports them) of the port's kernels.
KERNELS = {"ka": ("sweep_fwd_kernel",),
           "kc": ("sweep_bwd_global", "sweep_bwd_shared", "sweep_bwd_finish"),
           "kf": ("tv_add_grad_kernel", "tv_rows_kernel")}


def per_unit_ms(rec, unit):
    """Window milliseconds per completed step or view."""
    if rec.get("unit") != unit or not rec.get("units"):
        return None
    return rec["window_s"] * 1e3 / rec["units"]


def idle_share(rec, unit):
    """Per cent of the traced window with nothing running on the device."""
    tr = rec.get("trace")
    if rec.get("unit") != unit or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(rec, unit):
    """Per cent of the card's float32 peak: the model FLOPs of the
    window's steps or views over the window's time."""
    c, peaks = rec.get("counts"), rec.get("peaks")
    if rec.get("unit") != unit or not c or not peaks or not c.get("flops"):
        return None
    return 100.0 * c["flops"] * rec["units"] / (
        rec["window_s"] * peaks["f32_flops"])


def roofline(rec, unit, kernel):
    """Per cent of the memory roofline: the least time the kernel's bytes
    (counted from the model's work) take at the card's bandwidth, over the
    kernel's device time in the trace."""
    c, peaks, tr = rec.get("counts"), rec.get("peaks"), rec.get("trace")
    if rec.get("unit") != unit or not c or not peaks or tr is None \
            or not c.get(kernel):
        return None
    t = devtrace.kernel_seconds(tr, KERNELS[kernel])
    if t <= 0:
        return None
    bound = counts.bound_seconds(0.0, c[kernel] * rec["units"], peaks)
    return 100.0 * bound / t
