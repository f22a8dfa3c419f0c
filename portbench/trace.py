"""What the benchmark reads from one torch.profiler Chrome trace.

The program writes one trace a sample (`STRAWB_TRACE_DIR`, its
`utils/profiling.py`): its phases as `record_function` ranges on the thread
that started the trace, and every kernel, copy and memset of the GPU.
`summarize` reduces one trace to sums the per-layer readers take.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(path: str) -> dict:
    """Seconds by range name, by kernel name, of device time (the union of
    its operations), and of the trace's span; the idle gaps of the device
    with the innermost range the host was in at their middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges: Dict[str, float] = {}
    range_iv: List[Tuple[float, float, str]] = []
    kernels: Dict[str, float] = {}
    dev: List[Tuple[float, float]] = []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if cat == "user_annotation":
            name = e.get("name", "")
            ranges[name] = ranges.get(name, 0.0) + dur * 1e-6
            range_iv.append((ts, ts + dur, name))
        elif cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                name = e.get("name", "")
                kernels[name] = kernels.get(name, 0.0) + dur * 1e-6
    busy = _union(dev)
    span = (hi - lo) * 1e-6 if hi > lo else 0.0
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            inner = [r for r in range_iv if r[0] <= mid <= r[1]]
            label = min(inner, key=lambda r: r[1] - r[0])[2] if inner \
                else "outside_ranges"
            gaps.append((label, (b - a) * 1e-6))
    return {"ranges": ranges, "kernels": kernels,
            "busy_s": sum(b - a for a, b in busy) * 1e-6, "span_s": span,
            "gaps": sorted(gaps, key=lambda g: -g[1])[:10]}
