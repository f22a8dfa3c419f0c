"""Phase timing + throughput counters (SURVEY §5: the reference has only a
single wall-clock timer, Strawberry.cpp:238; we add per-phase timing,
reads/sec counters). STRAWB_TRACE_DIR (a device trace in the JAX package)
is refused by the port's driver."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0
    cpu: float = 0.0   # thread-CPU seconds of the thread running the phase


class Profiler:
    """Accumulates per-phase wall time."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: Dict[str, PhaseStats] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
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
        native = native_counters()
        if any(native.values()):
            lines.append("  native thread-CPU: " + "  ".join(
                f"{k}={v:.3f}s" for k, v in native.items() if v > 0))
        return "\n".join(lines)


GLOBAL = Profiler(enabled=False)

_NATIVE_COUNTER_NAMES = ("asm_prep", "quant_prep", "frag_len",
                         "cluster_scan", "cluster_collapse", "cluster_emit",
                         "quant_weights", "scan_p2", "collapse_p2", "emit_p2",
                         "flow_ns", "inflate", "bam_parse", "bam_merge")


def native_counters(reset: bool = False) -> Dict[str, float]:
    """Cumulative native thread-CPU seconds per hot path (perfcnt.h slots,
    read via strawb_perf_read). Empty when the native lib is unavailable."""
    try:
        import ctypes as C
        import numpy as np
        from ..io.native import get_lib
        lib = get_lib()
        lib.strawb_perf_read.restype = None
        lib.strawb_perf_read.argtypes = [C.POINTER(C.c_double), C.c_int32]
        out = np.zeros(len(_NATIVE_COUNTER_NAMES), np.float64)
        lib.strawb_perf_read(out.ctypes.data_as(C.POINTER(C.c_double)),
                             1 if reset else 0)
        return dict(zip(_NATIVE_COUNTER_NAMES, out.tolist()))
    except Exception:
        return {}


def enable():
    GLOBAL.enabled = True
    GLOBAL._t0 = time.perf_counter()
