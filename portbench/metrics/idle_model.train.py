"""idle_model.train: the device's idle time charged to the model's own
spans (`cut.model.backbone`, `cut.model.aspp`, `cut.model.head`, which
models/deeplabv3.py opens inside `cut.train.forward`), in % of the traced
window. Being innermost, they take this idle from `idle_forward.train`.
Nothing where the traced epoch holds none of them."""

from portbench.metrics import _spans

SPANS = ("cut.model.backbone", "cut.model.aspp", "cut.model.head")


def read(reading, ctx):
    if _spans.steps(reading) is None or not _spans.spans(reading, SPANS):
        return None
    return _spans.idle_share(reading, SPANS)
