"""aspp_busy_ms.train: the device's busy time inside the device extent of
DeepLabV3's ASPP (`cut.model.aspp`: the 1x1, the three dilated 3x3 and the
pooling branches and their projection), mean per traced step, in ms;
nothing where the trace holds no extent of that span."""

from portbench.metrics import _spans


def read(reading, ctx):
    busy = _spans.busy_under(reading, "cut.model.aspp")
    return None if busy is None else 1e3 * busy
