"""idle.train: the device's idle share of the traced window of the training path."""

from portbench.metrics import _shared


def read(reading, ctx):
    return _shared.idle(reading) if reading is not None and reading.kind == "train" else None
