"""Batched min-cost circulation over one padded node bucket: the
hand-written CUDA kernel (csrc/mcf_bucket.cu) and its plain PyTorch
version.

The counterpart of strawberry_tpu/assembly/device.py::_mcf_bucket (the XLA
program behind STRAWB_DEVICE_MCF=1). Both compute the integer
successive-shortest-path algorithm of assembly/mincostflow.py::solve_dense,
so the flows are array-equal to it.

- `mcf_bucket_cuda`: the kernel's wrapper (CUDA tensors only).
- `mcf_bucket_reference`: the plain PyTorch version, a transcription of
  `_mcf_bucket`: a Python loop over augmentations that synchronizes only
  to test `all(done)`, and fixed-count loops over the Bellman-Ford rounds
  and the path walk. The CPU tests run it, and the chip smoke holds the
  kernel against it.
- `mcf_bucket`: the plain version for CPU tensors, the kernel for CUDA
  tensors. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes as C

import torch

INF = 1 << 50
MAX_AUG = 4096
MAX_NODES = 256


def mcf_bucket_reference(cost, has_arc, lower, active, max_aug=MAX_AUG):
    """cost/lower: (B,M,M) int64; has_arc: (B,M,M) bool; active: (B,)
    bool. Returns (flow (B,M,M) int64, infeasible (B,) bool)."""
    B, M, _ = cost.shape
    dev = cost.device
    rows = torch.arange(B, device=dev)

    def excess_of(flow):
        return flow.sum(dim=1) - flow.sum(dim=2)   # in - out per node

    flow = lower.clone()
    done = ~active | ~(excess_of(flow) > 0).any(dim=1)
    infeasible = torch.zeros(B, dtype=torch.bool, device=dev)
    it = 0
    while it < max_aug and not bool(done.all()):
        excess = excess_of(flow)
        pos = excess > 0
        neg = excess < 0
        work = ~done & pos.any(dim=1)

        bwd_cap = (flow - lower).transpose(1, 2)
        has_bwd = has_arc.transpose(1, 2) & (bwd_cap > 0)
        rc_fwd = torch.where(has_arc, cost, INF)
        rc_bwd = torch.where(has_bwd, -cost.transpose(1, 2), INF)
        rc = torch.minimum(rc_fwd, rc_bwd)
        use_bwd = rc_bwd < rc_fwd
        no_arc = rc >= INF

        dist = torch.where(pos, 0, INF)
        pred = torch.full((B, M), -1, dtype=torch.int64, device=dev)
        for _ in range(M):
            cand = torch.where(no_arc, INF, dist[:, :, None] + rc)  # (B,u,v)
            best, bu = cand.min(dim=1)   # the first u of the minimum
            improved = best < dist
            dist = torch.where(improved, best, dist)
            pred = torch.where(improved, bu, pred)

        tdist = torch.where(neg, dist, INF)
        t = tdist.argmin(dim=1)
        t_unreach = tdist.gather(1, t[:, None])[:, 0] >= INF
        newly_infeasible = work & t_unreach

        # mark the path's edges by walking pred from t (at most M steps)
        cap = torch.where(use_bwd, bwd_cap, INF)
        onpath = torch.zeros((B, M, M), dtype=torch.bool, device=dev)
        bott = torch.full((B,), INF, dtype=torch.int64, device=dev)
        v = t
        src = t
        for _ in range(M):
            u = pred.gather(1, v[:, None])[:, 0]
            stop = u < 0
            uu = torch.where(stop, v, u)
            onpath[rows, uu, v] = onpath[rows, uu, v] | ~stop
            bott = torch.minimum(bott, torch.where(stop, INF,
                                                   cap[rows, uu, v]))
            src = torch.where(stop, v, src)
            v = uu

        exc_s = excess.gather(1, src[:, None])[:, 0]
        exc_t = -excess.gather(1, t[:, None])[:, 0]
        b = torch.minimum(torch.minimum(bott, exc_s), exc_t)
        b = torch.where(work & ~newly_infeasible, b, 0)

        delta = torch.where(onpath & use_bwd, -b[:, None, None], 0)
        add = torch.where(onpath & ~use_bwd, b[:, None, None], 0)
        flow = flow + add + delta.transpose(1, 2)   # cancellation on v->u

        infeasible = infeasible | newly_infeasible
        done = ~(excess_of(flow) > 0).any(dim=1) | infeasible
        it += 1
    return flow, infeasible


def _check(cost, has_arc, lower, active):
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"cost must be (B,M,M), got {tuple(cost.shape)}")
    B, M, _ = cost.shape
    if not 1 <= M <= MAX_NODES:
        raise ValueError(f"M must be in 1..{MAX_NODES}, got {M}")
    want = {"cost": (cost, (B, M, M), torch.int64),
            "has_arc": (has_arc, (B, M, M), torch.bool),
            "lower": (lower, (B, M, M), torch.int64),
            "active": (active, (B,), torch.bool)}
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != cost.device:
            raise ValueError(f"{name} is on {t.device}, cost on "
                             f"{cost.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mcf_bucket_cuda(cost, has_arc, lower, active, max_aug=MAX_AUG):
    """Launch csrc/mcf_bucket.cu on PyTorch's current stream; returns
    (flow (B,M,M), infeasible (B,)) without synchronizing. Counts its
    launches in `mcf_bucket_cuda.launches`."""
    if not cost.is_cuda:
        raise ValueError(f"mcf_bucket_cuda needs CUDA tensors, got "
                         f"{cost.device}")
    _check(cost, has_arc, lower, active)
    B, M, _ = cost.shape
    flow = torch.empty_like(cost)
    infeasible = torch.empty((B,), dtype=torch.bool, device=cost.device)
    if B == 0:
        return flow, infeasible
    workspace = torch.empty_like(cost)  # the residual costs, per locus
    from ..utils import kernels
    lib = kernels.load("mcf_bucket")
    fn = lib.strawb_mcf_bucket
    fn.restype = C.c_int
    fn.argtypes = [C.c_void_p] * 7 + [C.c_int] * 3 + [C.c_void_p]
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cost.data_ptr(), has_arc.data_ptr(), lower.data_ptr(),
                 active.data_ptr(), flow.data_ptr(), infeasible.data_ptr(),
                 workspace.data_ptr(), B, M, max_aug, stream)
    kernels.check(lib, err, "mcf_bucket launch")
    mcf_bucket_cuda.launches += 1
    return flow, infeasible


mcf_bucket_cuda.launches = 0


def mcf_bucket(cost, has_arc, lower, active, max_aug=MAX_AUG):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if cost.device.type == "cpu":
        return mcf_bucket_reference(cost, has_arc, lower, active, max_aug)
    return mcf_bucket_cuda(cost, has_arc, lower, active, max_aug)
