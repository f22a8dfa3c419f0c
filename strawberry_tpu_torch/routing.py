"""The port's routing defaults: which work the host does and which the GPU
does when no environment variable says otherwise.

The JAX package sets the same four defaults from measurements made on its
own chip (strawberry_tpu/quant/device.py, assembly/device.py,
pipeline.py). The port sets them from the tools of
strawberry_tpu_torch/tools/, run on the H100; each constant cites its row
of PERF.md ("H100 crossovers"), which names the card, its power limit and
the tool's JSON line.

Every measurement kept the work on the host, so the constants hold on
both platforms (STRAWB_PLATFORM=cpu or cuda), and every default mode
runs as the JAX CLI's default does. On "cpu" that is a rule, not a
measurement: the plain PyTorch versions of the kernels exist for the
tests, never as a faster path. A constant that a later measurement sends
to the card therefore needs a "cpu" value of its own
(tests/test_torch_routing.py holds every constant to the host route).

The environment overrides the constants with the JAX package's semantics:
  STRAWB_FORCE_HOST=<any>    every EM (--fast-em too) and flow on the host
  STRAWB_DEVICE_EM=<any>     the f64 EM on the device
  STRAWB_FASTEM_AFTER=N      --fast-em keeps its first N problems on the
                             host and sends the rest to the device in f32
  STRAWB_DEVICE_PREP=0|false|'' off; 1|all|true all; anything else budget
  STRAWB_PREP_BUDGET=N       pairs a device granule in the budget mode
Work sent to the card on a machine without one raises where it starts
(torchsetup.device()); nothing falls back to the host.
"""
from __future__ import annotations

import os
from typing import Optional

# NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, "H100 crossovers").

# The golden f64 EM solves on the host: 15,115 of the 19,013 thetas of the
# 1M-fragment realistic set differ from the host batch's in some bit
# (PERF.md row "em: f64 default").
DEVICE_EM = False

# --fast-em keeps every problem on the host (None: no bound), so it takes
# the default's route and gives its bytes: the host finished the first k
# problems sooner than the f32 device path at every k measured, 250 to all
# 19,013 of the realistic set; no crossover up to 19,013 problems (PERF.md
# row "em: STRAWB_FASTEM_AFTER").
FASTEM_AFTER: Optional[int] = None

# The quant prep's auto mode: "all" and every budget granule had a higher
# median wall than "off" (PERF.md row "prep: auto mode").
PREP = "off"

# (hit x isoform) pairs a device granule in the "budget" mode: the budget
# mode's best median wall (PERF.md row "prep: granule").
PREP_GRANULE = 8192

# Under the opt-in STRAWB_DEVICE_MCF=1, problems with fewer nodes solve on
# the host: 0, because the card beat solve_dense per problem from the
# fewest nodes a flow problem has (2) to 256 (PERF.md row "mcf:
# device_min_nodes").
MCF_MIN_NODES = 0


def em_force_host(fast_em: bool) -> bool:
    """Whether the EM dispatcher keeps every problem on the host."""
    if os.environ.get("STRAWB_FORCE_HOST"):
        return True
    if fast_em:
        return fastem_after() is None
    return not (os.environ.get("STRAWB_DEVICE_EM") or DEVICE_EM)


def fastem_after() -> Optional[int]:
    """How many EM problems --fast-em solves on the host first (None:
    every one)."""
    v = os.environ.get("STRAWB_FASTEM_AFTER")
    return int(v) if v is not None else FASTEM_AFTER


def prep_mode(forced: Optional[bool] = None) -> str:
    """The quant-prep route: "all", "budget" or "off". `forced`
    (Config.device_prep) True/False means all/off, then
    STRAWB_DEVICE_PREP, then PREP."""
    if forced is not None:
        return "all" if forced else "off"
    env = os.environ.get("STRAWB_DEVICE_PREP")
    if env is None:
        return PREP
    if env in ("0", "false", ""):
        return "off"
    return "all" if env in ("1", "all", "true") else "budget"


def prep_granule() -> int:
    """(hit x isoform) pairs a device granule in the "budget" mode."""
    v = os.environ.get("STRAWB_PREP_BUDGET")
    return int(v) if v is not None else PREP_GRANULE


def mcf_min_nodes() -> int:
    """Under STRAWB_DEVICE_MCF=1, problems with fewer nodes solve on the
    host (STRAWB_FORCE_HOST sends every problem there)."""
    if os.environ.get("STRAWB_FORCE_HOST"):
        return 1 << 30
    return MCF_MIN_NODES
