"""backbone_busy_ms.train: the device's busy time inside the device extent
of DeepLabV3's ResNet backbone (`cut.model.backbone`, opened inside
`cut.train.forward` by models/deeplabv3.py), mean per traced step, in ms;
nothing where the trace holds no extent of that span."""

from portbench.metrics import _spans


def read(reading, ctx):
    busy = _spans.busy_under(reading, "cut.model.backbone")
    return None if busy is None else 1e3 * busy
