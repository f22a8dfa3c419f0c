"""Seconds a sample spends in the `locus_context` ranges: pass 2's
per-locus work on the main thread."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "locus_context")
