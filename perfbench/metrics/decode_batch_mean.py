"""Mean rows of a decode step: tokens the window's decode steps produced
over those steps (EngineStats.decode_steps)."""
from perfbench import readers


def read(run):
    n = run.delta("decode_steps")
    return readers.decode_tokens(run) / n if n else None
