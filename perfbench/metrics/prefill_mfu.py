"""Closed-form FLOPs of every row the window's prefill passes computed,
over the engine's prefill pass time, as a share of the bf16 peak."""
from perfbench import counts, readers


def read(run):
    f = readers.prefill_flops(run)
    t = run.delta("prefill_compute_s")
    if f is None or t <= 0:
        return None
    return 100.0 * f / t / counts.PEAK_FLOPS["bfloat16"]
