"""Central PyTorch runtime setup: the counterpart of
strawberry_tpu/utils/jaxsetup.py.

Device choice is explicit: STRAWB_PLATFORM=cpu|cuda, default cuda. A run
that needs the device (--fast-em, STRAWB_DEVICE_EM=1,
STRAWB_DEVICE_PREP=all|budget or STRAWB_DEVICE_MCF=1) asks `device()`,
which raises when CUDA is requested and absent; nothing carries on quietly
on the CPU. STRAWB_PLATFORM=cpu runs the kernels' plain PyTorch versions
on the CPU (the tests' path).
"""
from __future__ import annotations

import os

import numpy as np
import torch

# The f64 EM is held to 1e-9 against the host oracle and the f32 EM to the
# Pallas kernel's bars. TF32 keeps about three decimal digits, so any f32
# matmul or convolution a plain version routes through cuBLAS or cuDNN
# must run in full f32 (cuDNN's default is TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PLATFORMS = ("cpu", "cuda")


def platform() -> str:
    p = os.environ.get("STRAWB_PLATFORM", "cuda")
    if p not in PLATFORMS:
        raise ValueError(f"STRAWB_PLATFORM={p!r}: expected one of "
                         f"{', '.join(PLATFORMS)}")
    return p


def device() -> torch.device:
    """The device the EM, the quant prep and the flow solves run on.
    Raises when CUDA is asked for (the default) and absent."""
    p = platform()
    if p == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this run needs the GPU (--fast-em, STRAWB_DEVICE_EM=1, "
            "STRAWB_DEVICE_PREP or STRAWB_DEVICE_MCF) but CUDA is not "
            "available; set STRAWB_PLATFORM=cpu to run the kernels' plain "
            "PyTorch versions on the CPU")
    return torch.device(p)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A numpy array as a contiguous tensor on `device` (in `dtype` if
    given). A copy to the GPU goes through pinned memory and does not
    block: a blocking copy waits for every kernel queued before it on the
    stream."""
    h = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        h = h.to(dtype)
    if torch.device(device).type == "cpu":
        return h
    return h.pin_memory().to(device, non_blocking=True)
