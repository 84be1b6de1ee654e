"""Bound time of every chunk-attention call in the traced window (its live
query-key pairs and bytes read once, counts.chunk_call) over the device
time of the chunk kernels in the trace."""
from perfbench import readers


def read(run):
    return readers.chunk_roofline(run)
