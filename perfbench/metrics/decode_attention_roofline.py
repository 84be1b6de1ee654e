"""Bound time of every decode-attention call in the traced window (its
live keys read once, counts.decode_call) over the device time of the
decode kernels in the trace."""
from perfbench import readers


def read(run):
    return readers.decode_roofline(run)
