"""Per-metric readers: `portbench/metrics/<metric name>.py`, one a metric of
`BENCHMARK.json`, each with `read(run) -> Optional[float]`.

`run` is what `portbench.run` gathered (`Run` there): the window's samples,
each with its wall, its reads, its process CPU, its native-pool CPU and, in a
traced run, the summary of its trace (`portbench.trace.summarize`) where it
was one of the traced samples (every other one). A reader
that finds nothing to read returns None, and the metric is left out of the
result line. The helpers below are shared by the readers.
"""
from __future__ import annotations

import re
from typing import Optional


def per_sample_mean(run, value) -> Optional[float]:
    """The mean of `value(sample)` over the window's samples where it is not
    None, or None where it is None for every sample."""
    vals = [v for v in map(value, run.samples) if v is not None]
    if not vals:
        return None
    return sum(vals) / len(vals)


def untraced_mean(run, value) -> Optional[float]:
    """The same over the samples that ran without the profiler, whose own
    CPU would count in a traced one."""
    return per_sample_mean(run, lambda s: None if s.traced else value(s))


def range_s(run, name: str) -> Optional[float]:
    """Seconds a sample spends in the program's `name` ranges."""
    if not any(s.trace and name in s.trace["ranges"] for s in run.samples):
        return None
    return per_sample_mean(
        run, lambda s: s.trace["ranges"].get(name, 0.0) if s.trace else None)


def kernel_s(run, pattern: str) -> Optional[float]:
    """Device seconds a sample spends in kernels whose name matches."""
    rx = re.compile(pattern)

    def one(s):
        if not s.trace:
            return None
        t = sum(v for k, v in s.trace["kernels"].items() if rx.search(k))
        return t if any(rx.search(k) for k in s.trace["kernels"]) else None
    return per_sample_mean(run, one)
