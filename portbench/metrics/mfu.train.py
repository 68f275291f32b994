"""mfu.train (%, of 67 TFLOP/s float32): model FLOPs of the window's
train steps (counts.step_flops) over the window's time. FLOP-bound."""

from portbench.metrics._lib import mfu


def read(rec):
    return mfu(rec, "step")
