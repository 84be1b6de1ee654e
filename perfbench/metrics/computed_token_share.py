"""Share of the window's prompt tokens that prefill computed
(EngineStats.prefill_tokens_computed / prefill_tokens_total)."""


def read(run):
    tot = run.delta("prefill_tokens_total")
    return 100.0 * run.delta("prefill_tokens_computed") / tot if tot else None
