"""k2_roofline.train: K2 (ops/dsnt_kernel.py -> csrc/dsnt_moments.cu, row
layout) on the training path: the least time of its launches'
bytes and operations (work.k2_work at each launch's heatmaps) over their
traced time."""

from portbench.metrics import _shared


def read(reading, ctx):
    if reading is None or reading.kind != "train":
        return None
    return _shared.roofline(reading, "k2", "dsnt_moments_kernel", exclude="cols")
