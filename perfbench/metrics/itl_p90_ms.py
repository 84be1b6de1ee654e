"""The 90th percentile of every gap between consecutive output tokens of
a request, both emitted in the window (host clock)."""
from perfbench.harness import percentile


def read(run):
    gaps = []
    for r in run.reqs.values():
        ts = [t for t in r.t_tokens if 0.0 <= t <= run.window_end]
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    v = percentile(gaps, 90)
    return None if v is None else 1e3 * v
