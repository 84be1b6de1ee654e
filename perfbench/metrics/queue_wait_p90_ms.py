"""The 90th percentile, over every request due in the window, of the time
from its due time to the start of the engine step in which it left the
queue for a prefill (host clock)."""
from perfbench.harness import percentile


def read(run):
    w = [(r.t_admit if r.t_admit is not None else run.window_end) - r.due
         for r in (run.reqs[rid] for rid in run.window_rids)]
    v = percentile(w, 90)
    return None if v is None else 1e3 * v
