"""kc_roofline.train (%, device trace): K-C's bytes of the window's
steps (counts.kc_bytes) at 3.35 TB/s over K-C's device time (its
global, shared and finishing passes). Bytes-bound."""

from portbench.metrics._lib import roofline


def read(rec):
    return roofline(rec, "step", "kc")
