"""Median time from each request's due time to its first token, over every
request due in the window (host clock)."""
from perfbench.harness import percentile


def read(run):
    return 1e3 * percentile(run.ttfts(), 50)
