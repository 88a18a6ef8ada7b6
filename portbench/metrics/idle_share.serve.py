"""Percent of the traced ticks' wall time in which the card ran nothing
(1 - union of device intervals / wall), averaged over the ranks."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
