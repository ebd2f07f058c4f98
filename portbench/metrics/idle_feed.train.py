"""idle_feed.train: the device's idle time charged to the feed's waits
(`cut.feed.get`, `cut.feed.starved`), in % of the traced window."""

from portbench.metrics import _spans


def read(reading, ctx):
    return _spans.idle_share(reading, _spans.FEED)
