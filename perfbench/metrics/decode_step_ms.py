"""Mean decode step, from the engine's own device-synchronised span
(EngineStats.decode_compute_s / decode_steps) over the window."""


def read(run):
    n = run.delta("decode_steps")
    return 1e3 * run.delta("decode_compute_s") / n if n else None
