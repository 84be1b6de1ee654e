"""The 90th percentile of the time from due time to first token, over
every request due in the window (host clock). A per-layer reading: with
14 requests of one arrival order a window, it is about the 13th of 14,
and moves by a whole prefill pass when that request meets a pass or
waits behind it."""
from perfbench.harness import percentile


def read(run):
    v = percentile(run.ttfts(), 90)
    return None if v is None else 1e3 * v
