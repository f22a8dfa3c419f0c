"""Dense min-cost circulation with lower bounds — the shared algorithm spec.

The CMPC flow graphs have at most one arc per ordered node pair (intron,
adjacency, constraint-shortcut, source/sink and circulation arcs are all
pair-unique, see assembly/flow.py), so the problem is dense (M x M)
matrices: has_arc, cost (int), lower (int), upper = INF.

Algorithm: lower-bound transformation + successive shortest paths, with
*synchronous* Bellman-Ford (min-plus relaxations over the residual matrix,
predecessor = lowest-index argmin, updated on strict improvement only —
which provably yields an acyclic predecessor graph). Every step is
deterministic integer arithmetic, so the numpy implementation here and the
batched JAX implementation in assembly/device.py agree bit-for-bit; golden
sweeps validate both against lemon NetworkSimplex's optimum
(ref: src/assembly.cpp:896-904).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

INF = np.int64(1) << 50


_native_mcf = None


def _get_native():
    global _native_mcf
    if _native_mcf is None:
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            lib.strawb_mcf_dense.restype = C.c_int32
            lib.strawb_mcf_dense.argtypes = [
                C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_uint8),
                C.POINTER(C.c_int64), C.POINTER(C.c_int64)]
            _native_mcf = lib.strawb_mcf_dense
        except Exception:
            _native_mcf = False
    return _native_mcf


def solve_dense(cost: np.ndarray, has_arc: np.ndarray,
                lower: np.ndarray) -> Optional[np.ndarray]:
    """cost/lower: (M,M) int64; has_arc: (M,M) bool. Upper bounds are
    infinite. Returns flow (M,M) int64 or None if infeasible."""
    M = cost.shape[0]
    fn = _get_native()
    if fn:
        import ctypes as C
        c = np.ascontiguousarray(cost, np.int64)
        h = np.ascontiguousarray(has_arc, np.uint8)
        lo = np.ascontiguousarray(lower, np.int64)
        out = np.zeros((M, M), np.int64)
        rc = fn(M, c.ctypes.data_as(C.POINTER(C.c_int64)),
                h.ctypes.data_as(C.POINTER(C.c_uint8)),
                lo.ctypes.data_as(C.POINTER(C.c_int64)),
                out.ctypes.data_as(C.POINTER(C.c_int64)))
        if rc == 1:
            return out
        if rc == 0:
            return None
        # rc < 0: inconsistency — run the numpy spec (which asserts)
    flow = lower.astype(np.int64).copy()
    excess = flow.sum(axis=0) - flow.sum(axis=1)   # in - out

    while True:
        pos = excess > 0
        if not pos.any():
            break
        # residual arcs: forward (has_arc, cap inf, +c), backward
        # (has_arc.T with flow>lower, cap flow-lower, -c)
        bwd_cap = (flow - lower).T                  # cap of arc v->u
        has_bwd = has_arc.T & (bwd_cap > 0)
        rc_fwd = np.where(has_arc, cost, INF)
        rc_bwd = np.where(has_bwd, -cost.T, INF)
        rc = np.minimum(rc_fwd, rc_bwd)
        # NB when both a forward arc u->v and a backward residual of arc
        # v->u exist, take the cheaper (tie: forward). Track which was used.
        use_bwd = rc_bwd < rc_fwd

        dist = np.where(pos, np.int64(0), INF)
        pred = np.full(M, -1, dtype=np.int64)
        for _ in range(M):
            cand = dist[:, None] + rc               # (u,v)
            cand = np.where(rc >= INF, INF, cand)
            best = cand.min(axis=0)
            bu = cand.argmin(axis=0)                # lowest index on ties
            improved = best < dist
            dist = np.where(improved, best, dist)
            pred = np.where(improved, bu, pred)
        neg = excess < 0
        if not neg.any():
            break
        tdist = np.where(neg, dist, INF)
        t = int(tdist.argmin())
        if tdist[t] >= INF:
            return None  # deficit unreachable: infeasible
        # walk back to a source (pred == -1), computing bottleneck
        path = []
        v = t
        while pred[v] != -1:
            u = int(pred[v])
            path.append((u, v))
            v = u
        s = v
        b = min(int(excess[s]), -int(excess[t]))
        for (u, v) in path:
            if use_bwd[u, v]:
                b = min(b, int(bwd_cap[u, v]))
        assert b >= 1
        for (u, v) in path:
            if use_bwd[u, v]:
                flow[v, u] -= b                     # cancel on arc v->u
            else:
                flow[u, v] += b
        excess[s] -= b
        excess[t] += b
    return flow
