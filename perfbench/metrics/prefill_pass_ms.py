"""Mean packed prefill pass, from the engine's own device-synchronised
span (EngineStats.prefill_compute_s / prefill_batches) over the window."""


def read(run):
    n = run.delta("prefill_batches")
    return 1e3 * run.delta("prefill_compute_s") / n if n else None
