"""Share of the traced window in which nothing ran on the card
(torch.profiler), in the decode cell."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
