"""Seconds a sample spends in the `pass1_assemble` range: pass 1, the host
half of assembly (`assembly/splice_graph.py`, `flow.py`, `lemonns.py`), or
the pre-pass of `-r`."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "pass1_assemble")
