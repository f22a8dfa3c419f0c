"""Device mesh and the sharded EM bucket: the counterpart of
strawberry_tpu/parallel/mesh.py.

The unit of parallelism is the gene locus (embarrassingly parallel): loci
shard data-parallel over the 'dp' mesh axis, one chunk of a bucket per
slot, each chunk one launch of the EM kernel (quant/cuda_em.py,
csrc/em_bucket.cu) on its slot's GPU and its own CUDA stream. The JAX
package also splits the isoform axis over a 'mdl' axis; here the largest
tier's tile fits one GPU and the EM kernel already splits a locus over a
cluster of CTAs, so 'mdl' is kept as a shape only: it pads C
(`pad_for_mesh`) and the result is the same for every `mdl`. Cross-locus
global statistics ride the reduction in collectives.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..quant.cuda_em import em_bucket_cuda, em_bucket_reference
from ..utils.torchsetup import device, to_device


@dataclass(frozen=True)
class Mesh:
    """`dp` slots, each with the device its chunk runs on, and the `mdl`
    extent (a shape only, see the module's text)."""
    devices: Tuple[torch.device, ...]  # one per 'dp' slot
    mdl: int = 1
    axis_names: Tuple[str, str] = ("dp", "mdl")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: self.mdl}


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "mdl"),
              mdl: Optional[int] = None) -> Mesh:
    """An n_devices mesh of (n_devices / mdl) 'dp' slots. By default every
    GPU (one device on STRAWB_PLATFORM=cpu); with more devices asked for
    than there are, device k of the mesh is GPU k modulo their count, so a
    mesh of any size runs on one GPU. Raises when CUDA is asked for (the
    default) and absent."""
    base = device()
    count = torch.cuda.device_count() if base.type == "cuda" else 1
    n = count if n_devices is None else n_devices
    if mdl is None:
        mdl = 2 if (n % 2 == 0 and n >= 4) else 1
    assert n % mdl == 0
    devs = tuple(torch.device("cuda", (k * mdl) % count)
                 if base.type == "cuda" else base for k in range(n // mdl))
    return Mesh(devs, mdl, tuple(axes))


def sharded_em_bucket(mesh: Mesh):
    """The EM bucket over the mesh: `run(F_raw, u, theta0, valid, active)`
    -> (theta (B,C), failed (B,)) cuts the B loci into `dp` contiguous
    chunks, launches each on its slot's device and stream, and joins the
    results on the first slot's device. B must be a multiple of dp (callers
    pad, `pad_for_mesh`). Takes numpy arrays or tensors; every locus is
    solved by the kernel that solves it in the whole bucket, so the result
    equals one launch over the whole bucket bit for bit. On CPU devices the
    chunks run through the plain version. Counts the kernel launches it
    makes in `sharded_em_bucket.launches`."""
    dp = len(mesh.devices)
    streams: Dict[int, torch.cuda.Stream] = {}

    def chunk(arrays, dev, lo, hi):
        # numpy arrays go over as float64 and bool, tensors keep their type
        return [a[lo:hi].to(dev).contiguous() if isinstance(a, torch.Tensor)
                else to_device(a[lo:hi], dev, dt)
                for a, dt in zip(arrays, (torch.float64,) * 3
                                 + (torch.bool,) * 2)]

    def run(F_raw, u, theta0, valid, active):
        arrays = (F_raw, u, theta0, valid, active)
        B = F_raw.shape[0]
        if B % dp:
            raise ValueError(f"{B} loci do not divide over dp = {dp}; pad "
                             "with pad_for_mesh")
        step = B // dp
        home = mesh.devices[0]
        src = F_raw.device if isinstance(F_raw, torch.Tensor) else None
        thetas, faileds, busy = [], [], []
        for k, dev in enumerate(mesh.devices):
            lo, hi = k * step, (k + 1) * step
            if dev.type == "cpu":
                theta, failed = em_bucket_reference(
                    *chunk(arrays, dev, lo, hi))
            else:
                s = streams.get(k)
                if s is None:
                    s = streams[k] = torch.cuda.Stream(dev)
                if src is not None and src.type == "cuda":
                    # the inputs may still be in flight on their stream
                    s.wait_stream(torch.cuda.current_stream(src))
                with torch.cuda.stream(s):
                    theta, failed = em_bucket_cuda(
                        *chunk(arrays, dev, lo, hi))
                    sharded_em_bucket.launches += int(hi > lo)
                    theta, failed = theta.to(home), failed.to(home)
                busy.append((s, theta, failed))
            thetas.append(theta)
            faileds.append(failed)
        # join only after every slot has its launch, so the slots overlap
        for s, theta, failed in busy:
            join = torch.cuda.current_stream(home)
            join.wait_stream(s)
            for t in (theta, failed):
                t.record_stream(join)  # read there, allocated on `s`
        return torch.cat(thetas), torch.cat(faileds)

    return run


sharded_em_bucket.launches = 0


def pad_for_mesh(B: int, C: int, mesh: Mesh) -> Tuple[int, int]:
    dp = mesh.shape["dp"]
    mdl = mesh.shape["mdl"]
    Bp = -(-B // dp) * dp
    Cp = -(-C // mdl) * mdl
    return Bp, Cp
