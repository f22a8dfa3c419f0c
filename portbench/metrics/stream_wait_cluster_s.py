"""Seconds a sample's main thread spends in the `stream_wait_cluster` ranges:
blocked until the native workers have clustered the next partition, with
its fused assembly or quant prep."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "stream_wait_cluster")
