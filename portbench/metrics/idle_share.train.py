"""idle_share.train (%, device trace): share of the traced window in
which no kernel, copy or fill ran on the device (union of intervals)."""

from portbench.metrics._lib import idle_share


def read(rec):
    return idle_share(rec, "step")
