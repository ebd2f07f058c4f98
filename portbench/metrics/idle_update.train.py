"""idle_update.train: the device's idle time charged to the optimizer:
`zero_grad` and the update (`cut.train.zero_grad`, `cut.train.update`),
in % of the traced window."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.idle_share(reading, ("cut.train.zero_grad", "cut.train.update"))
