"""train_step_ms (ms, host clock): the window's wall time, ending in a
device sync, over the train steps it completed."""

from portbench.metrics._lib import per_unit_ms


def read(rec):
    return per_unit_ms(rec, "step")
