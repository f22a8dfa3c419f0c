"""Min-cost circulation over a ragged batch of flow problems: the
hand-written CUDA kernel (csrc/mcf_bucket.cu) and its plain PyTorch
version.

The counterpart of strawberry_tpu/assembly/device.py::_mcf_bucket (the XLA
program behind STRAWB_DEVICE_MCF=1). Both compute the integer
successive-shortest-path algorithm of assembly/mincostflow.py::solve_dense,
so the flows are array-equal to it.

- `pack_problems`: the problems back to back, sorted by node count, in one
  host buffer (`Packed`; `Packed.to` is one copy to the device).
- `mcf_ragged_cuda`: the kernel's wrapper (CUDA tensors only).
- `mcf_ragged_reference`: the plain version: each size class padded to its
  largest problem and solved by `mcf_bucket_reference`.
- `mcf_bucket_reference`: a transcription of `_mcf_bucket` on one padded
  bucket (B,M,M), the spec: a Python loop over augmentations that
  synchronizes only to test `all(done)`, and fixed-count loops over the
  Bellman-Ford rounds and the path walk.
- `mcf_ragged`: the plain version for CPU tensors, the kernel for CUDA
  tensors. It never falls back from one to the other.
- `Flows.cpu` brings a result back in one copy; `unpack_flows` hands each
  problem its (m, m) flow, or None where infeasible, in the callers' order.
"""
from __future__ import annotations

import ctypes as C
from dataclasses import dataclass
from functools import cached_property
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.kernels import Entry, stream_handle

INF = 1 << 50
MAX_AUG = 4096
MAX_NODES = 256
# the kernel's size classes, by largest node count: one warp a problem, one
# CTA with the residual costs in shared memory, one CTA with them in a
# global workspace
CLASSES = (("warp", 32), ("block", 128), ("block_global", 256))


@dataclass
class Packed:
    """Ragged flow problems, sorted by node count: every tensor is a view
    of `buf`, one uint8 buffer (cost, lower, offset, size, has_arc).

    cost, lower: (sum m^2,) int64, each problem's m x m matrix row-major
    from offset[b]; has_arc: (sum m^2,) uint8; offset: (B,) int64; size:
    (B,) int32. `sizes` is a host copy of size, `order[b]` the callers'
    index of problem b."""
    buf: torch.Tensor
    cost: torch.Tensor
    has_arc: torch.Tensor
    lower: torch.Tensor
    offset: torch.Tensor
    size: torch.Tensor
    sizes: np.ndarray
    order: np.ndarray

    def to(self, device) -> "Packed":
        """The same problems on `device`: one copy of the buffer, which
        does not block the host when the buffer is pinned."""
        return _packed_views(self.buf.to(device, non_blocking=True),
                             self.sizes, self.order)

    @cached_property
    def classes(self) -> List[Tuple[int, int]]:
        """(problem count, largest node count) of each size class."""
        k = np.searchsorted(self.sizes, [top for _n, top in CLASSES],
                            side="right")
        lo = np.concatenate([[0], k[:-1]])
        return [(int(b - a), int(self.sizes[b - 1]) if b > a else 0)
                for a, b in zip(lo, k)]


def _layout(sizes: np.ndarray):
    """Byte ranges of cost, lower, offset, size, has_arc in the buffer (the
    int64 arrays first, so every view is aligned) and the total."""
    N, B = int((sizes.astype(np.int64) ** 2).sum()), len(sizes)
    ends = np.cumsum([8 * N, 8 * N, 8 * B, 4 * B, N])
    starts = np.concatenate([[0], ends[:-1]])
    return list(zip(starts.tolist(), ends.tolist())), int(ends[-1])


def _packed_views(buf, sizes, order) -> Packed:
    (c, lo, off, sz, h), _ = _layout(sizes)
    return Packed(buf, cost=buf[c[0]:c[1]].view(torch.int64),
                  has_arc=buf[h[0]:h[1]],
                  lower=buf[lo[0]:lo[1]].view(torch.int64),
                  offset=buf[off[0]:off[1]].view(torch.int64),
                  size=buf[sz[0]:sz[1]].view(torch.int32),
                  sizes=sizes, order=order)


def pack_problems(problems: Sequence[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]],
                  pin: bool = False) -> Packed:
    """[(cost, has_arc, lower)] with (m,m) matrices, 1 <= m <= 256, packed
    into one host buffer (pinned if `pin`, for a copy that does not block),
    sorted by m (stable, so equal sizes keep the callers' order)."""
    sizes = np.array([p[0].shape[0] for p in problems], np.int32)
    if len(sizes) and not (1 <= sizes.min() and sizes.max() <= MAX_NODES):
        raise ValueError(f"node counts must be in 1..{MAX_NODES}, got "
                         f"{sizes.min()}..{sizes.max()}")
    order = np.argsort(sizes, kind="stable")
    sizes = sizes[order]
    _, total = _layout(sizes)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    x = _packed_views(buf, sizes, order)
    if len(sizes):
        ordered = [problems[i] for i in order]
        for k, (dst, dt) in enumerate(((x.cost, np.int64),
                                       (x.has_arc, np.uint8),
                                       (x.lower, np.int64))):
            np.concatenate([np.asarray(p[k], dt).ravel() for p in ordered],
                           out=dst.numpy())
        m2 = sizes.astype(np.int64) ** 2
        x.offset.numpy()[:] = np.cumsum(m2) - m2
        x.size.numpy()[:] = sizes
    return x


class Flows(NamedTuple):
    """A solve's result, in the packed order: flow (sum m^2,) int64 and
    infeasible (B,) bool, both views of `buf`."""
    flow: torch.Tensor
    infeasible: torch.Tensor
    buf: torch.Tensor

    def cpu(self) -> "Flows":
        """The result on the host: one copy of the buffer."""
        return _flows_views(self.buf.cpu(), len(self.infeasible))


def _flows_views(buf, B) -> Flows:
    n = (buf.numel() - B)
    return Flows(buf[:n].view(torch.int64), buf[n:].view(torch.bool), buf)


def _empty_flows(x: Packed) -> Flows:
    B = len(x.sizes)
    return _flows_views(torch.empty(8 * x.cost.numel() + B, dtype=torch.uint8,
                                    device=x.cost.device), B)


def unpack_flows(x: Packed, out: Flows) -> List[Optional[np.ndarray]]:
    """Each problem's (m,m) flow, or None where it is infeasible, in the
    callers' order (out on the host)."""
    flow, inf = out.flow.numpy(), out.infeasible.numpy()
    offs = x.offset.cpu().numpy()
    res: List[Optional[np.ndarray]] = [None] * len(x.sizes)
    for b, (i, m) in enumerate(zip(x.order, x.sizes)):
        if not inf[b]:
            o = int(offs[b])
            res[i] = flow[o:o + int(m) * int(m)].reshape(int(m), int(m))
    return res


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


def mcf_ragged_reference(x: Packed, max_aug: int = MAX_AUG) -> Flows:
    """The plain version of the ragged kernel: each size class present is
    zero-padded to its largest problem (padding adds nodes with no arc,
    which change no flow) and solved by mcf_bucket_reference."""
    _check_packed(x)
    out = _empty_flows(x)
    dev = x.cost.device
    offs = x.offset.cpu().numpy()
    first = 0
    for count, M in x.classes:
        if not count:
            continue
        sl = slice(first, first + count)
        first += count
        # flat index of entry (i, j) of each problem, where i, j < its m
        m = x.sizes[sl].astype(np.int64)[:, None, None]
        i = np.arange(M)[None, :, None]
        j = np.arange(M)[None, None, :]
        inside = torch.from_numpy(((i < m) & (j < m)).ravel()).to(dev)
        flat = torch.from_numpy((offs[sl, None, None] + i * m + j).ravel()
                                ).to(dev)[inside]
        pad = []
        for src, dt in ((x.cost, torch.int64), (x.has_arc, torch.bool),
                        (x.lower, torch.int64)):
            t = torch.zeros(count * M * M, dtype=dt, device=dev)
            t[inside] = src[flat].to(dt)
            pad.append(t.view(count, M, M))
        active = torch.ones(count, dtype=torch.bool, device=dev)
        flow, inf = mcf_bucket_reference(*pad, active, max_aug)
        out.flow[flat] = flow.reshape(-1)[inside]
        out.infeasible[sl] = inf
    return out


def _check_packed(x: Packed):
    B, N = len(x.sizes), int((x.sizes.astype(np.int64) ** 2).sum())
    want = {"cost": (x.cost, N, torch.int64),
            "has_arc": (x.has_arc, N, torch.uint8),
            "lower": (x.lower, N, torch.int64),
            "offset": (x.offset, B, torch.int64),
            "size": (x.size, B, torch.int32)}
    for name, (t, n, dt) in want.items():
        if tuple(t.shape) != (n,) or t.dtype != dt:
            raise ValueError(f"{name}: expected ({n},) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.cost.device:
            raise ValueError(f"{name} is on {t.device}, cost on "
                             f"{x.cost.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B and not (1 <= x.sizes[0] and x.sizes[-1] <= MAX_NODES
                  and (np.diff(x.sizes) >= 0).all()):
        raise ValueError("sizes must be sorted, each in 1..256")


_launch = Entry("mcf_bucket", "strawb_mcf_ragged",
                [C.c_void_p] * 8 + [C.c_int] * 7 + [C.c_void_p])


def mcf_ragged_cuda(x: Packed, max_aug: int = MAX_AUG) -> Flows:
    """Launch csrc/mcf_bucket.cu on PyTorch's current stream of the
    problems' device, one launch per size class present; returns the Flows
    without synchronizing. Counts its kernel launches in
    `mcf_ragged_cuda.launches`, those of each class in
    `mcf_ragged_cuda.class_launches`, and those of each `__global__`
    function in `mcf_ragged_cuda.function_launches` (both block classes
    launch mcf_block_kernel)."""
    dev = x.cost.device
    if dev.type != "cuda":
        raise ValueError(f"mcf_ragged_cuda needs CUDA tensors, got {dev}")
    _check_packed(x)
    out = _empty_flows(x)
    (n_warp, m_warp), (n_block, m_block), (n_glob, _m) = x.classes
    if not len(x.sizes):
        return out
    # the residual costs of the largest class, indexed as the costs are
    work = torch.empty_like(x.cost) if n_glob else None
    _launch(x.cost.data_ptr(), x.has_arc.data_ptr(), x.lower.data_ptr(),
            x.offset.data_ptr(), x.size.data_ptr(), out.flow.data_ptr(),
            out.infeasible.data_ptr(),
            None if work is None else work.data_ptr(), n_warp, m_warp,
            n_block, m_block, n_glob, max_aug, dev.index,
            stream_handle(dev.index))
    for (name, _top), n in zip(CLASSES, (n_warp, n_block, n_glob)):
        mcf_ragged_cuda.launches += n > 0
        mcf_ragged_cuda.class_launches[name] += n > 0
        mcf_ragged_cuda.function_launches[_FUNCTION[name]] += n > 0
    return out


mcf_ragged_cuda.launches = 0
mcf_ragged_cuda.class_launches = dict.fromkeys(
    (name for name, _top in CLASSES), 0)
# the __global__ function each size class launches
_FUNCTION = {"warp": "mcf_warp_kernel", "block": "mcf_block_kernel",
             "block_global": "mcf_block_kernel"}
mcf_ragged_cuda.function_launches = dict.fromkeys(_FUNCTION.values(), 0)


def mcf_ragged(x: Packed, max_aug: int = MAX_AUG) -> Flows:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.cost.device.type == "cpu":
        return mcf_ragged_reference(x, max_aug)
    return mcf_ragged_cuda(x, max_aug)
