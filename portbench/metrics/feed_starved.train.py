"""feed_starved.train: the share of the traced epoch's feed waits that
found the device feed's queue empty (`cut.feed.starved` over all
`cut.feed.*` spans), in %."""

from portbench.metrics import _spans


def read(reading, ctx):
    if _spans.steps(reading) is None:
        return None
    waits = [n for n, _, _ in _spans.spans(reading, _spans.FEED)]
    return 100.0 * waits.count("cut.feed.starved") / len(waits) if waits else None
