"""Seconds a sample spends in the `device_em_fetch` ranges: the EM
dispatcher (`quant/device.py::EmDispatcher`) waiting for and copying back
the card's results."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "device_em_fetch")
