"""Seconds a sample spends in the `em_launch` ranges: the host's side of the
device EM (`quant/device.py::EmDispatcher._launch`), one range a launch:
padding a tier's batch, its copy to the card, the kernel's launch and the
queued copy of its answers back."""
from portbench.metrics import range_s


def read(run):
    return range_s(run, "em_launch")
