"""head_busy_ms.train: the device's busy time inside the device extent of
DeepLabV3's head (`cut.model.head`: the 3x3 conv, norm, 1x1 conv, cast
and the bilinear upsampling to the input size), mean per traced step, in
ms; nothing where the trace holds no extent of that span."""

from portbench.metrics import _spans


def read(reading, ctx):
    busy = _spans.busy_under(reading, "cut.model.head")
    return None if busy is None else 1e3 * busy
