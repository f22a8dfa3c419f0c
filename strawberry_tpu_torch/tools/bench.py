"""The port's scoreboard: the counterpart of the JAX repo's bench.py, with
its sets, its repetitions and its record, measured in one process.

    python -m strawberry_tpu_torch.tools.bench [--device cpu] [--quick-only]
        [--n-frags 5000000] [--quick-frags 500000] [--data-dir DIR] [--out]

Every run goes through pipeline.run_driver with a null sink for its GTF
and its log (common.NullSink), as bench.py defines its runs, with the
Config that the CLI's `-g ann.gtf` and the set's strand flag build
(bench.py assembles and quantifies: no -r), one untimed warm-up run before
the timed ones of each route (bench.py:110-164). A null log takes
run_driver's null-log path, which no CLI run takes (the CLI always opens
a log): walls of the CLI in fresh processes are tools/realistic.py's.
  realistic  dataset_realistic at --n-frags, --fr: best of 4; its reads/s
             is the record's value
  easy       dataset_10m at --n-frags, --rf: best of 3 (easy_10m)
  quick      dataset_1m at --quick-frags, no strand flag: best of 3 each of
             the default, --fast-em at the default bound (routing.
             FASTEM_AFTER) and the f32 kernel route (--fast-em with
             STRAWB_FASTEM_AFTER=0), the best run's GTF kept
The sets are made first, side by side, each in a process of its own
(common.datasets), under --data-dir as <shape>_<n>, each with its
annotation's index written beforehand (common.index), so no run writes
it. This process imports no torch before its first run (common.setup asks
for CUDA in a child), so the realistic set's warm-up, the process's first
run, pays pass 2's first `import torch` as a user's run does: each set's
warm-up wall is its cold_wall_s. --quick-only runs the quick set alone, whose default then
gives the value (as bench.py's BENCH_FRAGS branch does).

Checks, and the exit code is 1 when one fails: --fast-em at the default
bound gives the default's GTF body byte for byte; the f32 route gives the
default's transcript set with TPM p99 relative error <= 1e-3
(common.tpm_check) and sent EM problems to the device. Prints bench.py's
record as one JSON line, the card first (with --out also written to
build/strawberry_tpu_torch/bench.json). Walls are the host's clock to the
device synchronized.
"""
from __future__ import annotations

import io
import os
import sys
import time
from typing import List, NamedTuple, Optional

from . import common
from .realistic import BASELINE_READS_PER_S

# bench.py's repetitions after the warm-up (bench.py:124,140,157,164)
REPS = {"realistic": 4, "easy": 3, "quick": 3}
F32 = {"STRAWB_FASTEM_AFTER": "0"}
FAST_EM_MODE = (
    "--fast-em keeps every EM problem on the host at the default bound "
    "(routing.FASTEM_AFTER = None: the default's route and bytes), and "
    "STRAWB_FASTEM_AFTER=N sends every tier-fitting problem past the first "
    "N to the card's f32 kernel (the fast_em_f32 fields: N = 0)")


class Runs(NamedTuple):
    cold_wall_s: float       # the untimed warm-up run
    walls_s: List[float]     # the timed runs
    sample: object           # the last run's Sample
    text: Optional[str]      # the best run's GTF, when captured

    @property
    def best_s(self) -> float:
        return min(self.walls_s)


def run_route(ds: common.DataSet, extra: List[str], reps: int,
              capture: bool = False) -> Runs:
    """One warm-up run of `-g` on the set with its strand flag and `extra`,
    then `reps` timed runs (bench.py's run_best)."""
    from .. import cli
    from ..pipeline import run_driver
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-g", ds.gtf, *ds.flags, *extra, ds.bam]))
    t0 = time.perf_counter()
    run_driver(ds.bam, cfg, common.NullSink(), common.NullSink())
    common.synchronize()
    cold = time.perf_counter() - t0
    walls, text, sample = [], None, None
    for _ in range(reps):
        sample = None  # free the previous table before the next run
        out = io.StringIO() if capture else common.NullSink()
        t0 = time.perf_counter()
        sample = run_driver(ds.bam, cfg, out, common.NullSink())
        common.synchronize()
        walls.append(time.perf_counter() - t0)
        if capture and walls[-1] == min(walls):
            text = out.getvalue()
    return Runs(cold, walls, sample, text)


def device_frac(sample) -> float:
    """bench.py's device_frac: EM problems and prep loci on the device
    over all of them."""
    em = getattr(sample, "em_stats", {})
    prep = getattr(sample, "prep_stats", None) or {}
    dev = em.get("device", 0) + prep.get("device_loci", 0)
    host = em.get("host", 0) + prep.get("host_loci", 0)
    return dev / (dev + host) if dev + host else 0.0


def quick_checks(default: Runs, fast: Runs, f32: Runs, work: str) -> dict:
    """The checks of the quick set's routes against its default."""
    paths = {}
    for name, runs in (("default", default), ("fast_em", fast),
                       ("fast_em_f32", f32)):
        paths[name] = os.path.join(work, name + ".gtf")
        with open(paths[name], "w") as f:
            f.write(runs.text)
    same = common.body(paths["fast_em"]) == common.body(paths["default"])
    tpm = common.tpm_check(paths["default"], paths["fast_em_f32"])
    f32_device = f32.sample.em_stats.get("device", 0)
    return {"fast_em_body_equals_default": same,
            "fast_em_tpm": common.tpm_check(paths["default"],
                                            paths["fast_em"]),
            "fast_em_f32_tpm": tpm, "fast_em_f32_device_problems": f32_device,
            "ok": same and tpm["ok"] and f32_device > 0}


def rate(runs: Runs) -> float:
    return len(runs.sample.table) / runs.best_s


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0])
    p.add_argument("--quick-only", action="store_true",
                   help="the quick set alone")
    p.add_argument("--n-frags", type=int, default=5_000_000,
                   help="fragments of the realistic and easy sets")
    p.add_argument("--quick-frags", type=int, default=500_000,
                   help="fragments of the quick set")
    p.add_argument("--data-dir", default=common.OUT_DIR,
                   help="where the sets <shape>_<n> are found or made")
    args = p.parse_args(argv)
    common.setup(args)
    wanted = ([] if args.quick_only else [("realistic", args.n_frags),
                                          ("easy", args.n_frags)])
    sets = common.datasets(wanted + [("quick", args.quick_frags)],
                           args.data_dir)
    runs, reads = {}, {}
    for shape, n in wanted:
        r = run_route(sets[shape, n], [], REPS[shape])
        reads[shape] = len(r.sample.table)
        if shape == "realistic":
            peak_mb, frac = common.peak_rss_mb(), device_frac(r.sample)
        runs[shape] = r._replace(sample=None)
        del r  # free the table before the next set
    quick = sets["quick", args.quick_frags]
    runs["quick"] = q = run_route(quick, [], REPS["quick"], capture=True)
    reads["quick"] = len(q.sample.table)
    if args.quick_only:
        peak_mb, frac = common.peak_rss_mb(), device_frac(q.sample)
    fast = run_route(quick, ["--fast-em"], REPS["quick"], capture=True)
    os.environ.update(F32)
    try:
        f32 = run_route(quick, ["--fast-em"], REPS["quick"], capture=True)
    finally:
        for k in F32:
            os.environ.pop(k)
    runs.update(quick_fast_em=fast, quick_fast_em_f32=f32)
    with common.scratch_dir() as work:
        checks = quick_checks(q, fast, f32, work)
    primary = "quick" if args.quick_only else "realistic"
    value = reads[primary] / runs[primary].best_s
    easy = {} if args.quick_only else {
        "reads_per_sec": reads["easy"] / runs["easy"].best_s,
        "vs_baseline": reads["easy"] / runs["easy"].best_s
        / BASELINE_READS_PER_S, "wall_s": runs["easy"].best_s}
    from .. import routing
    record = {
        "metric": "aligned_reads_per_sec_assembly_quant",
        "value": value, "unit": "reads/s/chip",
        "vs_baseline": value / BASELINE_READS_PER_S,
        "dataset": (f"bench.py's dataset_1m (quick) at {args.quick_frags} "
                    "fragments" if args.quick_only else
                    "bench.py's dataset_realistic: 24 chroms / <=20 "
                    f"isoforms / lognormal expression, {args.n_frags} "
                    "fragments, --fr"),
        "wall_s": runs[primary].best_s, "peak_rss_mb": peak_mb,
        "device_frac": frac, "easy_10m": easy,
        "reads_per_sec_1m": rate(q),
        "fast_em_reads_per_sec_1m": rate(fast),
        "fast_em_mode": FAST_EM_MODE,
        "fast_em_device_frac": device_frac(fast.sample),
        "fast_em_tpm_p99_rel_err": checks["fast_em_tpm"].get(
            "tpm_p99_rel_err"),
        "fast_em_f32_reads_per_sec_1m": rate(f32),
        "fast_em_f32_device_frac": device_frac(f32.sample),
        "fast_em_f32_tpm_p99_rel_err": checks["fast_em_f32_tpm"].get(
            "tpm_p99_rel_err"),
        "reads": reads,
        "cold_wall_s": {k: r.cold_wall_s for k, r in runs.items()},
        "walls_s": {k: r.walls_s for k, r in runs.items()},
        "em_stats_1m": {"default": q.sample.em_stats,
                        "fast_em": fast.sample.em_stats,
                        "fast_em_f32": f32.sample.em_stats},
        "routing": {k: getattr(routing, k) for k in (
            "DEVICE_EM", "FASTEM_AFTER", "PREP", "PREP_GRANULE",
            "MCF_MIN_NODES")},
        "device": args.device, "quick_only": args.quick_only,
        "checks": checks, "checks_ok": checks["ok"],
        "note": "one process, pipeline.run_driver with a null log, as "
                "bench.py (its null-log path, which no CLI run takes; the "
                "quick routes' GTF into memory), a warm-up then the best of "
                "REPS; cold_wall_s: each route's warm-up, the realistic "
                "set's the process's first run (its first import torch); "
                "peak_rss_mb: this process's own after the primary set "
                "(common.peak_rss_mb)"}
    common.emit("bench", args, record,
                out_dir=os.path.dirname(common.OUT_DIR))
    return 0 if checks["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
