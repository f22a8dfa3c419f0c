"""Phase timing + throughput counters (SURVEY §5: the reference has only a
single wall-clock timer, Strawberry.cpp:238; we add per-phase timing,
reads/sec counters, and an optional torch.profiler trace).

STRAWB_TRACE_DIR=<dir> records the run with torch.profiler, the counterpart
of the JAX package's jax.profiler trace: the host's torch ops and, as
ranges, the phases of the report; on the GPU every kernel and copy. Each
process writes one Chrome trace,
<dir>/<host>.<pid>[.rank<k>].<ns>.pt.trace.json (the rank in a
STRAWB_DIST_* launch; <ns> tells two traces of one process apart), which
opens in Perfetto (ui.perfetto.dev) or chrome://tracing.

A trace of the GPU holds every kernel launched while it ran, or stopping it
raises TraceIncomplete. torch.profiler keeps a kernel's record only inside
its capture window, which opens at the host clock's "now", while the
kernels' times come through a clock conversion calibrated once per process;
the two drift apart as the process ages, so kernels launched within that
lag of the trace's start are dropped. A run launches its first kernel
seconds after its trace starts; a trace started just before a launch in an
old process is what loses one.

The native pools' scopes (native/perfcnt.h, the slots of native_counters)
are in the same file while the trace runs: complete events of category
"native" on the native threads' ids, named by _NATIVE_COUNTER_NAMES, with
args {"part": k} where a clustering worker ran partition k. Their clock is
the trace's: an event's ts (us) x 1000 plus the file's baseTimeNanoseconds
is CLOCK_REALTIME in ns. A span the native buffer had no room for is
counted, and stopping the trace then raises NativeSpansDropped.

A range given args with annotate() carries them in the file (torch.profiler
writes none of its own): run_driver's heap range, the heap at the run's
start and end (Profiler.heap, also a line of the -v report).
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0
    cpu: float = 0.0   # thread-CPU seconds of the thread running the phase


class TraceIncomplete(RuntimeError):
    """A written trace lacks kernel records of launches it holds."""

    def __init__(self, path: str, launched: int, lost: int):
        super().__init__(
            f"STRAWB_TRACE_DIR: {path} holds {launched - lost} of the "
            f"{launched} kernels launched while it ran: torch.profiler "
            "dropped the records of the others (see utils/profiling.py)")
        self.path, self.launched, self.lost = path, launched, lost


class NativeSpansDropped(RuntimeError):
    """The native span buffer filled while a trace ran."""

    def __init__(self, path: str, held: int, dropped: int):
        super().__init__(
            f"STRAWB_TRACE_DIR: {path} holds {held} of the {held + dropped} "
            f"native spans recorded while it ran: the buffer of "
            f"{NATIVE_SPAN_CAP} spans was full")
        self.path, self.held, self.dropped = path, held, dropped


def lost_kernel_records(events) -> Tuple[int, int]:
    """(kernel launches, launches without a kernel record) in a Chrome
    trace's events: each launch call the profiler recorded on the host
    (cudaLaunchKernel, cuLaunchKernel and their kin) against the kernel
    records, matched by correlation id."""
    launched, ran = set(), set()
    for e in events:
        cat = str(e.get("cat", "")).lower()
        corr = e.get("args", {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and \
                "LaunchKernel" in e.get("name", ""):
            launched.add(corr)
        elif cat == "kernel":
            ran.add(corr)
    return len(launched), len(launched - ran)


class Profiler:
    """Accumulates per-phase wall time. Enable a trace with
    STRAWB_TRACE_DIR=<dir> (viewable in Perfetto or chrome://tracing)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: Dict[str, PhaseStats] = {}
        self._t0 = time.perf_counter()
        self._trace_dir = os.environ.get("STRAWB_TRACE_DIR")
        self._trace = None       # the running torch.profiler.profile
        self._trace_pid = None   # the process that started it
        self._trace_cuda = False
        self._native = None      # the host library while it records spans
        self._range_args = {}    # range name -> args for its trace event
        # the last run_driver's heap at its start and end (MB, from
        # malloctune.heap): start_resident_mb, start_in_use_mb, end_*
        self.heap: Dict[str, Optional[float]] = {}

    def start_trace(self, cuda: bool = True):
        """Start the trace if STRAWB_TRACE_DIR is set and none runs. It
        records the GPU's activity too, unless `cuda` is false (the -p
        parent, which must not touch CUDA before it forks) or
        STRAWB_PLATFORM=cpu; on STRAWB_PLATFORM=cuda without a GPU it
        raises. The directory is made now, so one that cannot be made
        fails the run before it starts."""
        if not self._trace_dir or self._trace is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        from .torchsetup import platform
        activities = [ProfilerActivity.CPU]
        if cuda and platform() == "cuda":
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "STRAWB_TRACE_DIR: the trace records the GPU "
                    "(STRAWB_PLATFORM=cuda) but CUDA is not available; set "
                    "STRAWB_PLATFORM=cpu for a trace of the host alone")
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self._trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        self._trace, self._trace_pid = prof, os.getpid()
        self._trace_cuda = ProfilerActivity.CUDA in activities
        self._native = _native_trace_start()

    def stop_trace(self):
        """Stop the running trace and write it; returns its path (None if
        no trace ran). The native spans recorded while it ran are added to
        the file. A trace that was not written raises OSError; a trace of
        the GPU that lacks a kernel it saw launched is written and then
        raises TraceIncomplete, and one whose native buffer filled,
        NativeSpansDropped."""
        if self._trace is None:
            return None
        prof, self._trace = self._trace, None
        if self._trace_cuda:
            import torch
            torch.cuda.synchronize()  # the last launches land in the trace
        lib, self._native = self._native, None
        spans, dropped = _native_trace_take(lib) \
            if lib is not None and self._trace_pid == os.getpid() \
            else (None, 0)
        held = len(spans["slot"]) if spans else 0
        notes, self._range_args = self._range_args, {}
        prof.stop()
        import torch.distributed as dist
        rank = (f".rank{dist.get_rank()}" if dist.is_available()
                and dist.is_initialized() else "")
        path = os.path.join(self._trace_dir, f"{socket.gethostname()}."
                            f"{os.getpid()}{rank}.{time.time_ns()}"
                            ".pt.trace.json")
        prof.export_chrome_trace(path)
        # the exporter logs a file it could not write and returns
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            raise OSError(f"STRAWB_TRACE_DIR: the trace was not written to "
                          f"{path}")
        if held or notes or self._trace_cuda:
            with open(path) as f:
                trace = json.load(f)
            if held:
                trace["traceEvents"].extend(native_events(
                    spans, trace.get("baseTimeNanoseconds", 0)))
            for e in trace["traceEvents"] if notes else ():
                if e.get("cat") == "user_annotation" and \
                        e.get("name") in notes:
                    e.setdefault("args", {}).update(notes[e["name"]])
            if held or notes:
                with open(path, "w") as f:
                    json.dump(trace, f, separators=(",", ":"))
            if self._trace_cuda:
                launched, lost = lost_kernel_records(trace["traceEvents"])
                if lost:
                    raise TraceIncomplete(path, launched, lost)
        if dropped:
            raise NativeSpansDropped(path, held, dropped)
        return path

    def annotate(self, name: str, args: dict):
        """Give the trace's range `name` these args: torch.profiler writes
        none of a range's own, so they are set in the file when the trace
        stops, on every range of that name. A no-op while no trace runs
        in this process."""
        if self._trace is not None and self._trace_pid == os.getpid():
            self._range_args[name] = dict(args)

    def _range(self, name: str):
        """A torch.profiler range named `name` while this process traces
        (a forked -p worker inherits the trace but does not record)."""
        if self._trace is None or self._trace_pid != os.getpid():
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def phase(self, name: str, items: int = 0):
        """A phase of the report and, while this process traces, a range
        of the trace; with neither, a shared no-op (the per-cluster phases
        run thousands of times a sample)."""
        if not self.enabled and self._trace is None:
            return _NO_PHASE
        return self._phase(name, items)

    @contextlib.contextmanager
    def _phase(self, name: str, items: int):
        with self._range(name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                dc = time.thread_time() - c0
                st = self.phases.setdefault(name, PhaseStats())
                st.seconds += dt
                st.cpu += dc
                st.calls += 1
                st.items += items

    def report(self, total_reads: int = 0) -> str:
        total = time.perf_counter() - self._t0
        lines = [f"total wall: {total:.3f}s"
                 + (f"  ({total_reads / total:,.0f} reads/s)"
                    if total_reads else "")]
        for name, st in sorted(self.phases.items(),
                               key=lambda kv: -kv[1].seconds):
            rate = f"  ({st.items / st.seconds:,.0f} items/s)" \
                if st.items and st.seconds > 0 else ""
            lines.append(f"  {name:<24s} {st.seconds:8.3f}s"
                         f"  x{st.calls}{rate}")
        if self.heap:
            h = {k: "n/a" if v is None else f"{v:,.1f}"
                 for k, v in self.heap.items()}
            lines.append(
                f"  heap MB: start resident {h['start_resident_mb']} in use "
                f"{h['start_in_use_mb']}; end resident "
                f"{h['end_resident_mb']} in use {h['end_in_use_mb']}")
        native = native_counters()
        if any(native.values()):
            lines.append("  native thread-CPU: " + "  ".join(
                f"{k}={v:.3f}s" for k, v in native.items() if v > 0))
        return "\n".join(lines)


GLOBAL = Profiler(enabled=False)
_NO_PHASE = contextlib.nullcontext()

# spans a trace's native buffer holds (32 bytes each, touched as filled)
NATIVE_SPAN_CAP = 1 << 21

_NATIVE_COUNTER_NAMES = ("asm_prep", "quant_prep", "frag_len",
                         "cluster_scan", "cluster_collapse", "cluster_emit",
                         "quant_weights", "scan_p2", "collapse_p2", "emit_p2",
                         "flow_ns", "inflate", "bam_parse", "bam_merge")


def native_counters(reset: bool = False) -> Dict[str, float]:
    """Cumulative native thread-CPU seconds per hot path (perfcnt.h slots,
    read via strawb_perf_read). Empty only where the host library cannot
    load; a read that fails once it has loaded raises."""
    import ctypes as C
    import numpy as np
    from ..io.native import get_lib
    try:
        lib = get_lib()
    except OSError:
        return {}
    lib.strawb_perf_read.restype = None
    lib.strawb_perf_read.argtypes = [C.POINTER(C.c_double), C.c_int32]
    out = np.zeros(len(_NATIVE_COUNTER_NAMES), np.float64)
    lib.strawb_perf_read(out.ctypes.data_as(C.POINTER(C.c_double)),
                         1 if reset else 0)
    return dict(zip(_NATIVE_COUNTER_NAMES, out.tolist()))


def _native_lib():
    """The host library bound for recording native spans, or None where it
    cannot load."""
    import ctypes as C
    from ..io.native import get_lib
    try:
        lib = get_lib()
    except OSError:
        return None
    i64p = C.POINTER(C.c_int64)
    lib.strawb_perf_trace_start.restype = C.c_int32
    lib.strawb_perf_trace_start.argtypes = [C.c_int64]
    lib.strawb_perf_trace_stop.restype = C.c_int64
    lib.strawb_perf_trace_stop.argtypes = [i64p]
    lib.strawb_perf_trace_take.restype = None
    lib.strawb_perf_trace_take.argtypes = [C.POINTER(C.c_int32)] * 2 + \
        [i64p] * 3 + [C.c_int64]
    lib.strawb_perf_trace_recorded.restype = C.c_int64
    lib.strawb_perf_trace_recorded.argtypes = []
    return lib


def _native_trace_start():
    """Start recording the native scopes as spans: the host library, or
    None where it cannot load or another trace records them."""
    lib = _native_lib()
    return lib if lib is not None and \
        lib.strawb_perf_trace_start(NATIVE_SPAN_CAP) == 0 else None


def _native_trace_take(lib):
    """Stop recording; (spans, dropped): the spans as arrays (slot, tid,
    part, t0 ns, t1 ns), and how many the full buffer refused."""
    import ctypes as C
    import numpy as np
    dropped = C.c_int64(0)
    n = lib.strawb_perf_trace_stop(C.byref(dropped))
    cols = [np.zeros(n, np.int32), np.zeros(n, np.int32)] + \
        [np.zeros(n, np.int64) for _ in range(3)]
    lib.strawb_perf_trace_take(*(c.ctypes.data_as(C.POINTER(
        np.ctypeslib.as_ctypes_type(c.dtype))) for c in cols), n)
    return dict(zip(("slot", "tid", "part", "t0", "t1"), cols)), \
        dropped.value


def native_spans_recorded() -> int:
    """Native spans recorded in this process's life (0 where the host
    library cannot load)."""
    lib = _native_lib()
    return 0 if lib is None else lib.strawb_perf_trace_recorded()


def native_events(spans, base_ns: int):
    """The native spans as Chrome trace complete events on the trace's
    clock (ts in us from the file's baseTimeNanoseconds)."""
    pid = os.getpid()
    rows = zip(spans["slot"].tolist(), spans["tid"].tolist(),
               spans["part"].tolist(), spans["t0"].tolist(),
               spans["t1"].tolist())
    return [{"ph": "X", "cat": "native", "name": _NATIVE_COUNTER_NAMES[k],
             "pid": pid, "tid": tid, "ts": (t0 - base_ns) / 1e3,
             "dur": (t1 - t0) / 1e3,
             **({"args": {"part": part}} if part >= 0 else {})}
            for k, tid, part, t0, t1 in rows]


def enable():
    GLOBAL.enabled = True
    GLOBAL._t0 = time.perf_counter()
