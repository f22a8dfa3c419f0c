"""`em_launch_s` on a planted trace: the `em_launch` ranges summed by
`portbench.trace.summarize` and meaned over the traced samples; nothing from
a program that has no such range."""
import json

import pytest

from portbench import run as harness
from portbench.metrics import em_launch_s
from portbench.trace import summarize


def planted(path, launches):
    """A sample's trace: the dispatch ranges on the main thread, `launches`
    em_launch ranges of 2 ms each inside locus_context, and a kernel."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "locus_context",
           "ts": 0.0, "dur": 1e5, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "em_warp_kernel", "ts": 5e4,
           "dur": 10.0, "pid": 0, "tid": 7}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "em_launch",
            "ts": 1e3 + 1e4 * k, "dur": 2e3, "pid": 1, "tid": 1}
           for k in range(launches)]
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def sample(trace=None):
    s = harness.Sample(1.0, 100, True, "", 1.0, None,
                       traced=trace is not None)
    if trace is not None:
        t = summarize(trace)
        s.trace = {k: t[k] for k in ("ranges", "kernels", "busy_s",
                                     "span_s")}
    return s


def test_reads_the_planted_ranges(tmp_path):
    run = harness.Run(samples=[
        sample(planted(tmp_path / "a.json", 3)), sample(),
        sample(planted(tmp_path / "b.json", 5))])
    assert em_launch_s.read(run) == pytest.approx((3 + 5) * 0.002 / 2)


def test_finds_nothing_without_the_range(tmp_path):
    run = harness.Run(samples=[sample(planted(tmp_path / "a.json", 0)),
                               sample()])
    assert em_launch_s.read(run) is None
