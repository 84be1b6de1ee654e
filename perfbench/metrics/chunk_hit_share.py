"""Share of the cacheable segments (system prefix and retrieved chunks)
of the requests prefilled in the window that the chunk store served
(sum of Request.cache_hits over segments)."""


def read(run):
    rs = run.in_window_prefilled()
    seg = sum(r.segments for r in rs)
    return 100.0 * sum(r.cache_hits for r in rs) / seg if seg else None
