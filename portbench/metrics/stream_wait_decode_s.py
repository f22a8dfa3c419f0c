"""Seconds a sample's main thread spends in the `stream_wait_decode` ranges:
blocked until the streaming decoder hands the next partition's block to the
clustering job, or the stream ends."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "stream_wait_decode")
