"""forward_busy_ms.train: the device's busy time inside the device extent
of the step's loss (`cut.train.forward`: the backbone's forward, the DSNT
head (K2) and the NLL), mean per traced step, in ms; nothing where the
trace holds no extent of that span."""

from portbench.metrics import _spans


def read(reading, ctx):
    busy = _spans.busy_under(reading, "cut.train.forward")
    return None if busy is None else 1e3 * busy
