"""Batched EM over one padded tier bucket: the hand-written CUDA kernel
(csrc/em_bucket.cu) and its plain PyTorch version.

The counterpart of strawberry_tpu/quant/pallas_em.py (the f32 Pallas
kernel behind --fast-em) and of strawberry_tpu/quant/device.py::_em_bucket
(the f64 XLA loop behind STRAWB_DEVICE_EM=1). One kernel, templated on
float and double, serves both; it also returns `failed`.

- `em_bucket_cuda`: the kernel's wrapper (CUDA tensors only).
- `em_bucket_plan`: the launch the kernel picks for a bucket shape (which
  kernel, CTAs a locus, shared memory), for the chip smoke's report;
  `kernel_function` names its `__global__` function without the GPU.
- `em_bucket_reference`: the plain PyTorch version, a masked loop like
  `_em_bucket`; the CPU tests run it, and the chip smoke holds the kernel
  against it. It can also count each locus' iterations.
- `em_bucket`: the plain version for CPU tensors, the kernel for CUDA
  tensors. It never falls back from one to the other.
- `bucket_to_torch`: the numpy bucket arrays the dispatcher pads into
  tensors on a device.
"""
from __future__ import annotations

import ctypes as C
from typing import Tuple

import torch

from ..utils.kernels import Entry
from ..utils.torchsetup import to_device  # also sets full-f32 matmuls

MAX_ITER = 1000
THETA_CHANGE_LIMIT = 1e-2

_FLOATS = (torch.float32, torch.float64)


def bucket_to_torch(F, u, theta0, valid, active, device, dtype
                    ) -> Tuple[torch.Tensor, ...]:
    """Numpy bucket arrays (F (B,R,C), u (B,R), theta0 (B,C), valid (B,R),
    active (B,)) -> contiguous tensors on `device`: the floats in `dtype`,
    the masks as bool. The system has no other state to carry across.

    A copy to the GPU does not block (torchsetup.to_device), so a bucket
    never waits for the previous buckets' EM."""
    return tuple(to_device(a, device, dt) for a, dt in (
        (F, dtype), (u, dtype), (theta0, dtype), (valid, torch.bool),
        (active, torch.bool)))


def em_bucket_reference(F_raw, u, theta0, valid, active, iterations=False):
    """Plain PyTorch batched EM; returns (theta (B,C), failed (B,)), and
    with `iterations` also each locus' count of E+M steps (B,) int64: the
    step that converged or failed included, at most MAX_ITER, 0 for an
    inactive locus.

    Iteration 1 runs on the raw weights, later ones on the once-normalized
    F; convergence keeps the previous theta; a zero denominator on a valid
    row resets the locus to theta0; inactive loci return theta0."""
    colsum = F_raw.sum(dim=1, keepdim=True)
    F_norm = torch.where(colsum != 0,
                         F_raw / torch.where(colsum == 0, 1.0, colsum), 0.0)

    def step_once(F, theta, done, failed):
        denom = torch.einsum("brc,bc->br", F, theta)
        newly_failed = ((denom == 0) & valid).any(dim=1) & ~done
        safe = torch.where(denom == 0, 1.0, denom)
        U = (u[:, :, None] * F * theta[:, None, :]) / safe[:, :, None]
        U = torch.where(valid[:, :, None], U, 0.0)
        next_theta = U.sum(dim=1)
        dist = torch.sqrt(((next_theta - theta) ** 2).sum(dim=1))
        converged = dist < THETA_CHANGE_LIMIT
        step = ~done & ~converged & ~newly_failed
        theta = torch.where(step[:, None], next_theta, theta)
        theta = torch.where(newly_failed[:, None], theta0, theta)
        return theta, done | converged | newly_failed, failed | newly_failed

    failed = torch.zeros_like(active)
    steps = active.to(torch.int64)
    theta, done, failed = step_once(F_raw, theta0, ~active, failed)
    it = 1
    while it < MAX_ITER and not bool(done.all()):
        steps += ~done
        theta, done, failed = step_once(F_norm, theta, done, failed)
        it += 1
    return (theta, failed, steps) if iterations else (theta, failed)


def _check(F, u, theta0, valid, active):
    if F.dim() != 3:
        raise ValueError(f"F must be (B,R,C), got {tuple(F.shape)}")
    B, R, C = F.shape
    if R == 0 or C == 0:
        raise ValueError(f"F must have rows and columns, got {(B, R, C)}")
    if F.dtype not in _FLOATS:
        raise TypeError(f"F must be float32 or float64, got {F.dtype}")
    want = {"u": (u, (B, R), F.dtype), "theta0": (theta0, (B, C), F.dtype),
            "valid": (valid, (B, R), torch.bool),
            "active": (active, (B,), torch.bool)}
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in [("F", F)] + [(n, v[0]) for n, v in want.items()]:
        if t.device != F.device:
            raise ValueError(f"{name} is on {t.device}, F on {F.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kernel_function(R, cols):
    """The `__global__` function csrc/em_bucket.cu launches for buckets of R
    rows and `cols` columns (its use_warp_kernel / use_rows_kernel rule)."""
    if R <= 128 and cols <= 8:
        return "em_warp_kernel"
    if R <= 512 and cols <= 32:
        return "em_rows_kernel"
    return "em_strip_kernel"


def em_bucket_cuda(F_raw, u, theta0, valid, active):
    """Launch csrc/em_bucket.cu on PyTorch's current stream; returns
    (theta (B,C), failed (B,)) without synchronizing. Counts its launches
    in `em_bucket_cuda.launches`, and those of each `__global__` function
    in `em_bucket_cuda.function_launches`."""
    if not F_raw.is_cuda:
        raise ValueError(f"em_bucket_cuda needs CUDA tensors, got "
                         f"{F_raw.device}")
    _check(F_raw, u, theta0, valid, active)
    B, R, C_ = F_raw.shape
    theta = torch.empty((B, C_), dtype=F_raw.dtype, device=F_raw.device)
    failed = torch.empty((B,), dtype=torch.bool, device=F_raw.device)
    if B == 0:
        return theta, failed
    launch = _launch[F_raw.dtype]
    with torch.cuda.device(F_raw.device):
        launch(F_raw.data_ptr(), u.data_ptr(), theta0.data_ptr(),
               valid.data_ptr(), active.data_ptr(), theta.data_ptr(),
               failed.data_ptr(), B, R, C_, MAX_ITER,
               torch.cuda.current_stream().cuda_stream)
    em_bucket_cuda.launches += 1
    em_bucket_cuda.function_launches[kernel_function(R, C_)] += 1
    return theta, failed


em_bucket_cuda.launches = 0
em_bucket_cuda.function_launches = dict.fromkeys(
    ("em_warp_kernel", "em_rows_kernel", "em_strip_kernel"), 0)
_ARGS = [C.c_void_p] * 7 + [C.c_int] * 4 + [C.c_void_p]
_launch = {torch.float64: Entry("em_bucket", "strawb_em_bucket_f64", _ARGS),
           torch.float32: Entry("em_bucket", "strawb_em_bucket_f32", _ARGS)}
_plan = Entry("em_bucket", "strawb_em_bucket_plan",
              [C.c_int] * 4 + [C.POINTER(C.c_int)])

PLAN_FIELDS = ("kernel", "ctas", "threads", "ctas_per_locus", "rows_per_cta",
               "smem_bytes", "max_active_clusters")


def em_bucket_plan(B, R, cols, dtype):
    """The launch csrc/em_bucket.cu makes for a (B,R,cols) bucket of `dtype`,
    as a dict: kernel ("warp" for tiers 0-1, "rows" for tier 2, "strip"
    for tier 3), CTAs, threads a CTA, CTAs a locus (the cluster size),
    rows a CTA, dynamic shared memory, and how many such clusters the card
    holds at once. Needs a GPU."""
    out = (C.c_int * len(PLAN_FIELDS))()
    _plan(torch.empty((), dtype=dtype).element_size(), B, R, cols, out)
    plan = dict(zip(PLAN_FIELDS, out))
    plan["kernel"] = ("warp", "rows", "strip")[plan["kernel"]]
    return plan


def em_bucket(F_raw, u, theta0, valid, active):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if F_raw.device.type == "cpu":
        return em_bucket_reference(F_raw, u, theta0, valid, active)
    return em_bucket_cuda(F_raw, u, theta0, valid, active)
