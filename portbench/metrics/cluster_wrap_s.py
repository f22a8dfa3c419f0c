"""Seconds a sample spends in the `cluster_wrap` ranges: the main thread's
Python wrap of each clustered partition (views, lists and dicts) before its
clusters are handed on."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "cluster_wrap")
