"""Thread-CPU seconds a sample spends in the native pools: the program's
`perfcnt.h` slots (`utils/profiling.py::native_counters`), the outer ones
alone (`portbench.run.NESTED` lie inside them). Read on the samples that ran
untraced."""
from portbench.metrics import untraced_mean


def read(run):
    return untraced_mean(run, lambda s: s.native_cpu_s)
