"""The spans that split the port's native_cluster range, and the EM
dispatcher's em_launch: the benchmark's readers of them (portbench/metrics)
on hand-built runs and traces, and the native span recording of
utils/profiling.py in this process (a trace of the host on the CPU)."""
import ctypes as C
import json
import os

import pytest

from portbench import run as harness
from portbench.trace import summarize
from strawberry_tpu_torch.io.native import get_lib
from strawberry_tpu_torch.utils import profiling

READERS = {"stream_wait_decode_s": "stream_wait_decode",
           "stream_wait_cluster_s": "stream_wait_cluster",
           "cluster_wrap_s": "cluster_wrap",
           "pass1_cluster_s": "pass1_cluster",
           "em_launch_s": "em_launch"}
COUNTERS = ("asm_prep", "quant_prep", "frag_len", "cluster_scan",
            "cluster_collapse", "cluster_emit", "quant_weights", "scan_p2",
            "collapse_p2", "emit_p2", "flow_ns", "inflate", "bam_parse",
            "bam_merge")


def reader(metric):
    import importlib
    return importlib.import_module(f"portbench.metrics.{metric}").read


def sample(ranges=None):
    s = harness.Sample(1.0, 100, True, "", 1.0, None,
                       traced=ranges is not None)
    if ranges is not None:
        s.trace = {"ranges": ranges, "kernels": {}, "busy_s": 0.0,
                   "span_s": 1.0}
    return s


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_means_its_range_over_the_traced_samples(metric):
    """A sample's seconds in the range, the mean over the traced samples
    (one without the range reads 0 there); the untraced ones are left out."""
    span = READERS[metric]
    run = harness.Run(samples=[sample({span: 2.0, "native_cluster": 9.0}),
                               sample(),
                               sample({"native_cluster": 9.0}),
                               sample({span: 0.5})])
    assert reader(metric)(run) == pytest.approx(2.5 / 3)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_finds_nothing_in_a_program_without_the_range(metric):
    """A program that has no such range (the parent's) gives no number,
    and the result line leaves the metric out."""
    run = harness.Run(samples=[sample({"native_cluster": 2.5}), sample()])
    assert reader(metric)(run) is None
    assert reader(metric)(harness.Run(samples=[sample()])) is None


def test_native_events_neither_sum_nor_label_as_ranges(tmp_path):
    """summarize sums the user_annotation ranges by name and labels each
    idle gap with the innermost one; a native worker's span, however
    short, is neither."""
    def ev(cat, name, ts, dur, tid):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid}
    events = [ev("user_annotation", "native_cluster", 0.0, 1e6, 1),
              ev("user_annotation", "stream_wait_cluster", 1e5, 6e5, 1),
              ev("native", "scan_p2", 2e5, 4e5, 2),
              ev("native", "cluster_collapse", 3.9e5, 2e4, 2),
              ev("kernel", "k", 9e5, 1e3, 7)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = summarize(str(path))
    assert set(t["ranges"]) == {"native_cluster", "stream_wait_cluster"}
    assert t["ranges"]["stream_wait_cluster"] == pytest.approx(0.6)
    assert t["gaps"][0] == ("stream_wait_cluster", pytest.approx(0.9))


def scope(lib, n=1):
    """n native scopes on this thread (frag_len over no hits), each called
    without the interpreter lock."""
    i64p, i32p, i8p = (C.POINTER(t) for t in (C.c_int64, C.c_int32,
                                              C.c_int8))
    fld = lib.strawb_fld
    fld.restype = C.c_int64
    fld.argtypes = [C.c_int64, i64p, i8p, i64p, i32p,
                    C.c_int64, i64p, i8p, i64p, i32p, i32p]
    for _ in range(n):
        fld(0, None, None, None, None, 0, None, None, None, None, None)


@pytest.fixture
def traced_here(tmp_path, monkeypatch):
    monkeypatch.setenv("STRAWB_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    return profiling.Profiler(), get_lib()


def native_of(path):
    with open(path) as f:
        trace = json.load(f)
    return trace, [e for e in trace["traceEvents"]
                   if e.get("cat") == "native"]


def test_trace_holds_this_threads_scopes_on_its_clock(traced_here):
    """A scope run while the trace records is in its file, on this
    thread's id, inside the phase that ran it; one run before or after
    records nothing."""
    prof, lib = traced_here
    before = profiling.native_spans_recorded()
    scope(lib)
    assert profiling.native_spans_recorded() == before
    prof.start_trace()
    with prof.phase("a_phase"):
        scope(lib, 3)
    path = prof.stop_trace()
    scope(lib)
    assert profiling.native_spans_recorded() == before + 3
    trace, native = native_of(path)
    [rng] = [e for e in trace["traceEvents"] if e.get("name") == "a_phase"]
    assert [e["name"] for e in native] == ["frag_len"] * 3
    assert all(e["tid"] == rng["tid"] == C.CDLL(None).gettid()
               and "args" not in e for e in native)
    # the two clocks agree to well under a millisecond
    assert all(rng["ts"] - 1000 <= e["ts"]
               and e["ts"] + e["dur"] <= rng["ts"] + rng["dur"] + 1000
               for e in native)


def test_forked_child_records_no_span(traced_here):
    """A child forked while the parent traces (a -p worker) inherits the
    switch but records nothing."""
    prof, lib = traced_here
    prof.start_trace()
    before = profiling.native_spans_recorded()
    pid = os.fork()
    if pid == 0:
        code = 2
        try:
            scope(lib, 4)
            code = 0 if profiling.native_spans_recorded() == before else 1
        finally:
            os._exit(code)
    _, status = os.waitpid(pid, 0)
    scope(lib)
    path = prof.stop_trace()
    assert os.waitstatus_to_exitcode(status) == 0
    assert len(native_of(path)[1]) == 1


def test_full_native_buffer_is_counted_and_raises(traced_here, monkeypatch):
    """Spans past the buffer's room are counted; the trace is written with
    those held, then stopping it raises."""
    prof, lib = traced_here
    monkeypatch.setattr(profiling, "NATIVE_SPAN_CAP", 2)
    prof.start_trace()
    scope(lib, 5)
    with pytest.raises(profiling.NativeSpansDropped,
                       match="holds 2 of the 5") as e:
        prof.stop_trace()
    assert e.value.dropped == 3
    assert len(native_of(e.value.path)[1]) == 2
    # the buffer is gone: the next trace starts afresh
    prof.start_trace()
    scope(lib)
    assert len(native_of(prof.stop_trace())[1]) == 1


def test_threads_racing_start_and_stop_lose_no_span(traced_here):
    """More threads than cores run scopes without the interpreter lock
    while the trace starts and stops: every span counted while it ran is
    in the file, each inside the recording's window, and none after."""
    import threading
    import time
    prof, lib = traced_here
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            scope(lib, 50)
    threads = [threading.Thread(target=spin)
               for _ in range(2 * (os.cpu_count() or 4))]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        before = profiling.native_spans_recorded()
        t0 = time.time_ns()
        prof.start_trace()
        time.sleep(0.2)
        path = prof.stop_trace()
        t1 = time.time_ns()
        after = profiling.native_spans_recorded()
        time.sleep(0.05)
        assert profiling.native_spans_recorded() == after
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    trace, native = native_of(path)
    base = trace["baseTimeNanoseconds"]
    assert len(native) == after - before > 0
    assert all(t0 <= e["ts"] * 1e3 + base and
               e["ts"] * 1e3 + base + e["dur"] * 1e3 <= t1 for e in native)


def test_native_counters_empty_only_without_the_library(monkeypatch):
    """The 14 slots by name; {} where the host library cannot load; a read
    that fails once it has loaded raises."""
    from strawberry_tpu_torch.io import native
    assert tuple(profiling.native_counters()) == COUNTERS
    assert profiling._NATIVE_COUNTER_NAMES == COUNTERS

    def no_lib():
        raise OSError("no host library")
    monkeypatch.setattr(native, "get_lib", no_lib)
    assert profiling.native_counters() == {}
    monkeypatch.setattr(native, "get_lib", lambda: object())
    with pytest.raises(AttributeError):
        profiling.native_counters()
