"""Closed-form FLOPs of every token the window's decode steps produced,
over the engine's decode step time, as a share of the bf16 peak."""
from perfbench import counts, readers


def read(run):
    f = readers.decode_flops(run)
    t = run.delta("decode_compute_s")
    if f is None or t <= 0:
        return None
    return 100.0 * f / t / counts.PEAK_FLOPS["bfloat16"]
