"""idle_augment.train: the device's idle time charged to the step's
dequantise and augmentation (`cut.train.augment`), in % of the traced
window."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.idle_share(reading, ("cut.train.augment",))
