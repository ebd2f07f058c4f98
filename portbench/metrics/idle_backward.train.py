"""idle_backward.train: the device's idle time charged to the step's
`loss.backward()` (`cut.train.backward`), in % of the traced window."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.idle_share(reading, ("cut.train.backward",))
