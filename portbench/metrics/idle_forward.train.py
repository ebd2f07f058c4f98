"""idle_forward.train: the device's idle time charged to the step's
loss: the UNet forward, the DSNT head (K2) and the NLL
(`cut.train.forward`), in % of the traced window."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.idle_share(reading, ("cut.train.forward",))
