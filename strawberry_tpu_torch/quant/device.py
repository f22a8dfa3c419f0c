"""Per-locus EM dispatch over fixed padded tiers, on the GPU: the
counterpart of strawberry_tpu/quant/device.py.

Loci are bucketed by padded shape into the same four tiers as the JAX
package, and each full bucket runs as one launch of the hand-written EM
kernel (quant/cuda_em.py, csrc/em_bucket.cu). The routing rules are the
JAX package's, with the defaults of routing.py: the golden f64 EM
solves on the host; STRAWB_DEVICE_EM=1 sends the f64 tiers to the
device; --fast-em sends them in f32 after its first STRAWB_FASTEM_AFTER
problems (by default it keeps every problem on the host);
STRAWB_FORCE_HOST keeps everything on the host; problems larger than the
last tier always solve on the host.

Launches are asynchronous and each result's copy back to the host is
queued behind its kernel, so the GPU solves EM while the host streams
clusters and prepares later loci; `finish()` synchronizes once.

The host half (`_get_native_em*`, `host_em_*`, `_host_em_batch`) is copied
from the JAX module, whose import would pull in jax.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..routing import em_force_host, fastem_after
from .cuda_em import bucket_to_torch, em_bucket

# (rows, cols, batch) per tier, as in strawberry_tpu/quant/device.py
_TIERS = (
    (32, 4, 128),      # typical short-read locus (median 8 rows x 1 iso)
    (128, 8, 64),
    (512, 32, 16),
    (2048, 128, 8),    # anything larger routes to the host solver
)


@dataclass
class LocusProblem:
    """One locus' EM inputs, produced on host from a LocusContext."""
    counts: np.ndarray          # (r,) int truncated bin counts (all rows)
    weights: np.ndarray         # (r, c) raw bin weights (all rows)

    def filtered(self):
        keep = (self.weights > 1e-5).any(axis=1)
        return self.counts[keep], self.weights[keep]


class EmDispatcher:
    """Incremental device EM dispatch over the fixed tier menu.

    `add()` routes each locus problem into the smallest tier that fits it
    and launches a device batch the moment a tier's fixed-size batch
    fills. `finish()` flushes partial batches, solves the host-routed
    problems, synchronizes with the device once, and returns per-problem
    theta (None = EM init failure: no surviving rows, matching
    EmSolver::init returning false, estimate.cpp:374-391).

    Counts device/host routing, and the device problems by tier, so the
    profile and the chip smoke can report the true device fraction."""

    def __init__(self, n_problems: int = 0, fast_em: bool = False):
        # grows on demand in add(); pass n_problems when known upfront
        self.results: List[Optional[np.ndarray]] = [None] * n_problems
        self.fast_em = fast_em and not os.environ.get("STRAWB_FORCE_HOST")
        self.dtype = torch.float32 if self.fast_em else torch.float64
        # routing.py's defaults (set from the H100's crossovers) under the
        # JAX package's environment overrides
        self.force_host = em_force_host(self.fast_em)
        # --fast-em keeps its first N problems on the host (None: every
        # one, and force_host is set)
        self.device_after = fastem_after()
        if self.force_host:
            self.device = None
        else:
            from ..utils.torchsetup import device
            self.device = device()  # raises when CUDA is asked for, absent
        self.n_seen = 0
        # per-tier fill state: list of (idx, u, F, total, niso)
        self._fills: List[List[tuple]] = [[] for _ in _TIERS]
        self._host_items: List[tuple] = []
        self._launched: List[tuple] = []  # (host theta, items) to read
        self.n_device = 0
        self.n_host = 0
        self.tier_counts = [0] * len(_TIERS)  # problems sent, by tier

    def add(self, idx: int, p: "LocusProblem"):
        if idx >= len(self.results):
            self.results.extend([None] * (idx + 1 - len(self.results)))
        total = float(p.counts.sum())
        niso = p.weights.shape[1]
        u, F = p.filtered()
        if u.size == 0:
            return  # init failure -> results[idx] stays None
        item = (idx, u, F, total, niso)
        self.n_seen += 1
        if not self.force_host and (not self.fast_em
                                    or self.n_seen > self.device_after):
            for t, (rb, cb, bb) in enumerate(_TIERS):
                if F.shape[0] <= rb and niso <= cb:
                    self._fills[t].append(item)
                    self.n_device += 1
                    self.tier_counts[t] += 1
                    if len(self._fills[t]) == bb:
                        self._launch(t)
                    return
        self._host_items.append(item)
        self.n_host += 1

    def _launch(self, tier: int):
        """Pad one tier batch, copy it to the device, launch the EM and
        queue the copy of theta back to the host — without waiting. The
        host's side of it is the `em_launch` range, one a launch."""
        from ..utils.profiling import GLOBAL as PROF
        items, self._fills[tier] = self._fills[tier], []
        with PROF.phase("em_launch", items=len(items)):
            theta, _failed = em_bucket(*bucket_to_torch(
                *pad_bucket(tier, items), self.device, self.dtype))
            self._launched.append((theta.to("cpu", non_blocking=True),
                                   items))

    def finish(self) -> List[Optional[np.ndarray]]:
        from ..utils.profiling import GLOBAL as PROF
        for t in range(len(_TIERS)):
            if self._fills[t]:
                self._launch(t)
        if self._host_items:
            with PROF.phase("host_em", items=self.n_host):
                _host_em_batch(self._host_items, self.results)
        # the problems routed, in the -v report and the range's trace args
        PROF.em = {"tier_counts": list(self.tier_counts),
                   "n_device": self.n_device, "n_host": self.n_host}
        PROF.annotate("device_em_fetch", PROF.em)
        with PROF.phase("device_em_fetch", items=self.n_device):
            if self._launched and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the run's one wait
            for theta_h, items in self._launched:
                theta = theta_h.numpy().astype(np.float64)
                for b, (idx, _uu, _FF, _total, niso) in enumerate(items):
                    self.results[idx] = theta[b, :niso]
            self._launched = []
        return self.results


def pad_bucket(tier: int, items: List[tuple]):
    """Numpy arrays (F, u, theta0, valid, active) of one tier batch of
    (idx, u, F, total, niso) items, zero-padded to the tier's shape."""
    rb, cb, bb = _TIERS[tier]
    F = np.zeros((bb, rb, cb), dtype=np.float64)
    u = np.zeros((bb, rb), dtype=np.float64)
    theta0 = np.zeros((bb, cb), dtype=np.float64)
    valid = np.zeros((bb, rb), dtype=bool)
    active = np.zeros((bb,), dtype=bool)
    for b, (idx, uu, FF, total, niso) in enumerate(items):
        r = FF.shape[0]
        F[b, :r, :niso] = FF
        u[b, :r] = uu
        theta0[b, :niso] = total / niso
        valid[b, :r] = True
        active[b] = True
    return F, u, theta0, valid, active


def batched_em(problems: List[LocusProblem],
               fast_em: bool = False) -> List[Optional[np.ndarray]]:
    """Solve many per-locus EMs with fixed-tier batching.

    Returns per-problem theta (or None when EM init fails — no surviving
    rows — matching EmSolver::init returning false)."""
    d = EmDispatcher(len(problems), fast_em=fast_em)
    for idx, p in enumerate(problems):
        d.add(idx, p)
    return d.finish()


_native_em = None


def _get_native_em():
    global _native_em
    if _native_em is None:
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            P64 = C.POINTER(C.c_int64)
            PD = C.POINTER(C.c_double)
            lib.strawb_em_batch.restype = None
            lib.strawb_em_batch.argtypes = [
                C.c_int64, P64, P64, P64, PD, PD, PD, P64, PD, C.c_int64]
            _native_em = lib.strawb_em_batch
        except Exception:
            _native_em = False
    return _native_em


_native_em_raw = None


def _get_native_em_raw():
    global _native_em_raw
    if _native_em_raw is None:
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            P64 = C.POINTER(C.c_int64)
            PD = C.POINTER(C.c_double)
            PU8 = C.POINTER(C.c_uint8)
            lib.strawb_em_batch_raw.restype = None
            lib.strawb_em_batch_raw.argtypes = [
                C.c_int64, P64, P64, PD, PD, P64, P64, PD, PU8, C.c_int64]
            _native_em_raw = lib.strawb_em_batch_raw
        except Exception:
            _native_em_raw = False
    return _native_em_raw


def host_em_raw_available() -> bool:
    return bool(_get_native_em_raw())


def host_em_batch_raw(counts_list, alpha_list, niso_list):
    """Solve raw quant-prep locus slices in one native call (em.cc
    strawb_em_batch_raw): trunc + pairwise total + row filter + theta0 +
    EM, per locus. Returns (theta_flat, th_off, status) — status 0 =
    init failure (results None upstream)."""
    import ctypes as C
    import os
    fn = _get_native_em_raw()
    n = len(counts_list)
    nb = np.fromiter((len(c) for c in counts_list), np.int64, n)
    niso = np.fromiter(niso_list, np.int64, n)
    bin_off = np.zeros(n + 1, np.int64)
    np.cumsum(nb, out=bin_off[1:])
    alpha_off = np.zeros(n + 1, np.int64)
    np.cumsum(nb * niso, out=alpha_off[1:])
    th_off = np.zeros(n + 1, np.int64)
    np.cumsum(niso, out=th_off[1:])
    counts_flat = np.ascontiguousarray(
        np.concatenate(counts_list) if n else np.zeros(0))
    alpha_flat = np.ascontiguousarray(
        np.concatenate(alpha_list) if n else np.zeros(0))
    theta = np.zeros(max(int(th_off[-1]), 1), np.float64)
    status = np.zeros(max(n, 1), np.uint8)

    def p(a, ct):
        return a.ctypes.data_as(C.POINTER(ct))

    fn(n, p(bin_off, C.c_int64), p(niso, C.c_int64),
       p(counts_flat, C.c_double), p(alpha_flat, C.c_double),
       p(alpha_off, C.c_int64), p(th_off, C.c_int64),
       p(theta, C.c_double), p(status, C.c_uint8),
       min(4, os.cpu_count() or 1))
    return theta, th_off, status


def _host_em_batch(items, results):
    """Solve host-routed EM problems in one native batch call (em.cc);
    per-problem numpy oracle fallback."""
    import ctypes as C
    fn = _get_native_em()
    if not fn:
        from .em import em_run
        for (idx, uu, FF, total, niso) in items:
            # rows here are already >1e-5-filtered; theta0 uses the
            # unfiltered count total, as EmSolver::init does
            theta0 = np.full(niso, total / niso, dtype=np.float64)
            theta = em_run(uu.astype(np.float64), FF, theta0)
            if theta is None:
                theta = theta0
            results[idx] = theta
        return
    n = len(items)
    u_off = np.zeros(n + 1, np.int64)
    F_off = np.zeros(n + 1, np.int64)
    th_off = np.zeros(n + 1, np.int64)
    ncol = np.zeros(n, np.int64)
    theta0 = np.zeros(n, np.float64)
    for k, (idx, uu, FF, total, niso) in enumerate(items):
        u_off[k + 1] = u_off[k] + len(uu)
        F_off[k + 1] = F_off[k] + FF.size
        th_off[k + 1] = th_off[k] + niso
        ncol[k] = niso
        theta0[k] = total / niso
    u_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(it[1], np.float64) for it in items]))
    F_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(it[2], np.float64).ravel()
                        for it in items]))
    out = np.zeros(int(th_off[-1]), np.float64)
    P64 = C.POINTER(C.c_int64)
    PD = C.POINTER(C.c_double)
    fn(n, u_off.ctypes.data_as(P64), F_off.ctypes.data_as(P64),
       ncol.ctypes.data_as(P64), theta0.ctypes.data_as(PD),
       u_flat.ctypes.data_as(PD), F_flat.ctypes.data_as(PD),
       th_off.ctypes.data_as(P64), out.ctypes.data_as(PD),
       min(2, os.cpu_count() or 1))
    for k, (idx, _uu, _FF, _total, niso) in enumerate(items):
        results[idx] = out[int(th_off[k]):int(th_off[k + 1])]
