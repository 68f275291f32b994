"""kf_roofline.train (%, device trace): K-F's bytes of the window's
steps (counts.kf_bytes: dense over the grid, sparse over the voxels whose
gradient is nonzero) at 3.35 TB/s over K-F's device time. Bytes-bound."""

from portbench.metrics._lib import roofline


def read(rec):
    return roofline(rec, "step", "kf")
