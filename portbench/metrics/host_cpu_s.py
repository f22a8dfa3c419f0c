"""Process CPU seconds (user and system, every thread) a sample takes:
what a cluster bills for the sample beside its wall. Read on the samples
that ran untraced."""
from portbench.metrics import untraced_mean


def read(run):
    return untraced_mean(run, lambda s: s.host_cpu_s)
