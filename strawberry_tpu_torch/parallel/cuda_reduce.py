"""The reduction over shard rows: the hand-written CUDA kernel
(csrc/shard_reduce.cu) and its plain PyTorch version.

The counterpart of the jitted `jnp.sum(h, axis=0)` under a 'dp' sharding in
strawberry_tpu/parallel/collectives.py::allreduce_hist (and of the same sum
over the global mesh in parallel/distributed.py::allreduce_rows_multihost):
one row per shard or per process, the fragment-length histogram with or
without the mapped-read count in its last slot, summed column by column.

- `shard_colsum_cuda`: the kernel's wrapper (CUDA tensors only).
- `shard_colsum_reference`: the plain PyTorch version, a loop over the rows
  in the kernel's order. The CPU tests run it, and the chip smoke holds the
  kernel against it.
- `shard_colsum`: the plain version for CPU tensors, the kernel for CUDA
  tensors. It never falls back from one to the other.

Each takes rows (N, H) float64 and returns (H,) float64,
out[h] = rows[0, h] + rows[1, h] + ... + rows[N-1, h], added in row order.
The rows hold counts (integers far below 2^53), so the sums are exact and
equal whatever the order; the fixed order makes them bit-identical for any
float64 input too.
"""
from __future__ import annotations

import ctypes as C

import torch

from ..utils.kernels import Entry, stream_handle


def _check(rows):
    if not isinstance(rows, torch.Tensor):
        raise TypeError(f"rows must be a tensor, got {type(rows).__name__}")
    if rows.dim() != 2:
        raise ValueError(f"rows must be (N, H), got {tuple(rows.shape)}")
    if rows.dtype != torch.float64:
        raise TypeError(f"rows must be float64, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")


def shard_colsum_reference(rows):
    """Plain PyTorch column sum of rows (N, H) float64, row by row."""
    _check(rows)
    if rows.shape[0] == 0:
        return torch.zeros(rows.shape[1], dtype=rows.dtype,
                           device=rows.device)
    acc = rows[0].clone()
    for k in range(1, rows.shape[0]):
        acc = acc + rows[k]
    return acc


_launch = Entry("shard_reduce", "strawb_shard_colsum",
                [C.c_void_p, C.c_int, C.c_longlong, C.c_void_p, C.c_int,
                 C.c_void_p])


def shard_colsum_cuda(rows):
    """Launch csrc/shard_reduce.cu on PyTorch's current stream of the rows'
    device; returns (H,) float64 without synchronizing. Counts its launches
    in `shard_colsum_cuda.launches` (and, as the other wrappers do, by
    `__global__` function in `shard_colsum_cuda.function_launches`).
    Refuses an input that is not a contiguous float64 (N, H) tensor on a
    GPU rather than converting it.
    The entry is bound once and the C side switches device only when the
    rows' device is not the current one, so no device guard is entered,
    and the stream is the raw handle (`utils.kernels.stream_handle`)."""
    _check(rows)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"shard_colsum_cuda needs a CUDA tensor, got {dev}")
    N, H = rows.shape
    out = torch.empty((H,), dtype=rows.dtype, device=dev)
    if H == 0:
        return out
    _launch(rows.data_ptr(), N, H, out.data_ptr(), dev.index,
            stream_handle(dev.index))
    shard_colsum_cuda.launches += 1
    shard_colsum_cuda.function_launches["shard_colsum_kernel"] += 1
    return out


shard_colsum_cuda.launches = 0
shard_colsum_cuda.function_launches = {"shard_colsum_kernel": 0}


def shard_colsum(rows):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if isinstance(rows, torch.Tensor) and rows.device.type == "cpu":
        return shard_colsum_reference(rows)
    return shard_colsum_cuda(rows)
