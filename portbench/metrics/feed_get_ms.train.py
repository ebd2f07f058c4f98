"""feed_get_ms.train: the program's own wait for each next item of its
device feed (`cut.feed.get` and `cut.feed.starved`, around the queue's
`get` in `train/trainer.py _device_prefetch`), mean over the traced
epoch's waits, in ms. The in-program counterpart of `feed_wait_ms`."""

from portbench.metrics import _spans


def read(reading, ctx):
    if _spans.steps(reading) is None:
        return None
    waits = [e - s for _, s, e in _spans.spans(reading, _spans.FEED)]
    return 1e3 * sum(waits) / len(waits) if waits else None
