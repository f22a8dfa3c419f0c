"""Seconds a sample spends in the `pass2_quant` range: pass 2, the host
half of quantification (`quant/locus.py`, `bins.py`, `binweights.py`)."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "pass2_quant")
