"""Seconds a sample spends in the `pass1_cluster` ranges: pass 1's work on
each cluster the stream hands over (under `-r`, the pre-pass)."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "pass1_cluster")
