"""The quant-prep crossover on the GPU: the port's counterpart of the JAX
package's bench.py prep modes (benchmarks/prep_crossover.json there).

    python -m strawberry_tpu_torch.tools.prep_crossover [--device cpu]
        [--shape realistic|easy|deep|small] [--n-frags N | --data DIR]
        [--reps 3] [--granules 2048,...] [--out]

`-g -r` on the set (with its shape's strand) in fresh processes, --reps
timed runs a mode after one untimed, in turns: STRAWB_DEVICE_PREP=0
("off": the prep fused into the native clustering workers), =all (every
eligible locus through the prep kernel) and =budget at each granule of
--granules (default 2048, 8192, 32768 and 131072 (hit x isoform) pairs:
one granule in flight, carved only when the card is idle). Per mode: the walls (median, best, spread),
the last run's prep_stats, each run's `locus_context` seconds (the main
thread's share of the prep), and whether every body equals the "off"
run's.

The rules routing.py applies: "all" or "budget" becomes the auto mode
only if its median wall beats "off" by more than the larger spread of the
two; the granule is the budget mode's best by median wall, but moves
from routing.PREP_GRANULE only if that best beats it by the same rule.
"""
from __future__ import annotations

import sys

from .. import routing
from . import common

GRANULES = (2048, 8192, 32768, 131072)


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0], data=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--granules", default=",".join(map(str, GRANULES)))
    args = p.parse_args(argv)
    common.setup(args)
    ds = common.dataset(args)
    granules = [int(x) for x in args.granules.split(",")]
    modes = {"off": ([], {"STRAWB_DEVICE_PREP": "0"}),
             "all": ([], {"STRAWB_DEVICE_PREP": "all"})}
    for g in granules:
        modes[f"budget_{g}"] = ([], {"STRAWB_DEVICE_PREP": "budget",
                                     "STRAWB_PREP_BUDGET": str(g)})
    with common.scratch_dir() as work:
        walls = common.cli_walls(
            modes, ["-g", ds.gtf, "-r", *ds.flags, ds.bam], args.reps,
            args.device, reference="off", runs_dir=work)
    budgets = {g: walls[f"budget_{g}"] for g in granules}
    granule = min(budgets, key=lambda g: budgets[g]["median_s"])
    now = routing.PREP_GRANULE
    if now in budgets and not common.beats(budgets[granule], budgets[now]):
        granule = now
    winners = [m for m in ("all", f"budget_{granule}")
               if common.beats(walls[m], walls["off"])]
    auto = min(winners, key=lambda m: walls[m]["median_s"]) \
        if winners else "off"
    common.emit("prep_crossover", args, {
        "device": args.device, "shape": ds.shape, "strand": ds.strand,
        "n_frags": ds.n_frags, "reps": args.reps, "modes": walls,
        "auto_rule": auto.split("_")[0], "granule_rule": granule,
        "note": "walls of cli.main on the host's clock to the device "
                "synchronized, each in a fresh process with the phase "
                "timer on (locus_context: the main thread's seconds)"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
