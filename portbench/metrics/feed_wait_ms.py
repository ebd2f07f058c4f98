"""feed_wait_ms: the host's wait for each next batch of the window
(the harness's span around `next` on the program's feed: the C++
prefetcher through the device prefetch thread), mean over the window's
steps, in ms."""


def read(reading, ctx):
    waits = ctx.spans.get("feed_wait", [])
    return 1e3 * sum(waits) / len(waits) if waits else None
