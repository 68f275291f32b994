"""ka_roofline.train (%, device trace): K-A's bytes of the window's
steps (counts.ka_bytes) at 3.35 TB/s over K-A's device time. Bytes-bound."""

from portbench.metrics._lib import roofline


def read(rec):
    return roofline(rec, "step", "ka")
