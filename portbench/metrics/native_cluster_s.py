"""Seconds a sample spends in the `native_cluster` ranges: BAM decode and
clustering (the port's `io/native.py`, `core/`, `native/cluster.cc`)."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "native_cluster")
