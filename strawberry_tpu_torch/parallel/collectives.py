"""Cross-shard reductions for global pipeline statistics: the counterpart
of strawberry_tpu/parallel/collectives.py.

The reference's only cross-locus state is tiny: the fragment-length
histogram and total mapped reads between pass 1 and pass 2
(src/alignments.cpp:1372,1401), and the global FPKM sum for TPM
normalization (alignments.cpp:1821-1829). These are KB-scale reductions;
correctness, not bandwidth, is what matters.

Single process: the per-shard rows go to the mesh's first device and are
summed there by the hand-written kernel (cuda_reduce.py,
csrc/shard_reduce.cu). Several processes: torch.distributed over gloo
carries the rows between the processes (CPU tensors; NCCL refuses two
ranks on one GPU), and every process sums the gathered rows with the same
kernel on its own device (distributed.py).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from ..utils.torchsetup import to_device
from . import cuda_reduce
from .mesh import Mesh

# a peer that never arrives fails the launch instead of hanging it
RENDEZVOUS_TIMEOUT_S = 600


def allreduce_hist(mesh: Mesh, local_hist: np.ndarray) -> np.ndarray:
    """Sum an identical-shape histogram contribution from every 'dp' shard.

    local_hist: (dp, H) per-shard rows -> returns (H,) total."""
    local_hist = np.asarray(local_hist, np.float64)
    dp = mesh.shape["dp"]
    if local_hist.ndim != 2 or local_hist.shape[0] % dp:
        raise ValueError(f"local_hist {local_hist.shape} does not shard "
                         f"over dp = {dp}")
    rows = to_device(local_hist, mesh.devices[0], torch.float64)
    return cuda_reduce.shard_colsum(rows).cpu().numpy()


def allreduce_scalar(mesh: Mesh, values: np.ndarray) -> float:
    """Sum one scalar per 'dp' shard (e.g. per-shard total_mapped_reads)."""
    out = allreduce_hist(mesh, np.asarray(values, np.float64)[:, None])
    return float(out[0])


def init_distributed(coordinator: str = "", num_processes: int = 1,
                     process_id: int = 0):
    """Multi-process entry (torch.distributed over gloo, rendezvous at
    tcp://coordinator); no-op for a single process."""
    if num_processes > 1:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
