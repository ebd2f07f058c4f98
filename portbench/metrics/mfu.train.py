"""mfu.train: the whole training step's share of the H100's f32 peak (67 TFLOP/s):
the backbone's FLOPs (reference/<model_name>.py `train_flops`) of the
traced part's images over its window."""

from portbench.metrics import _shared


def read(reading, ctx):
    return _shared.mfu(reading) if reading is not None and reading.kind == "train" else None
