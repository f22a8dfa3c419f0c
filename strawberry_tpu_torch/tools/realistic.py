"""The port on bench.py's sets at full size: the counterpart of the JAX
package's tools/bench_realistic.py (--shape realistic, the default) and
tools/bench_10m.py (--shape easy), with the port's own host route in
place of the C++ reference (the card's machine has neither JAX nor the
reference binary).

    python -m strawberry_tpu_torch.tools.realistic [--device cpu]
        [--shape realistic|easy] [--n-frags 5000000 | --data DIR]
        [--reps 3] [--warmup 1] [--out]

The set is bench.py's dataset_realistic (seed 303, 24 x 16 Mb, up to 20
isoforms, exons 2-9, lognormal, fr, indel 0.02, clip 0.03) or its
dataset_10m (--shape easy: seed 101, 16 x 2 Mb, up to 8 isoforms, rf, no
XS tag, indel 0.02, clip 0.03) at --n-frags fragments, generated once
(tools/common.py::dataset); every mode passes the shape's strand. Each
mode runs in fresh processes (tools/common.py::cli_walls): --warmup
untimed runs, under torch.profiler on the card (each __global__
function's kernel events and device milliseconds), then --reps timed runs
in turns, each process running its mode a second time (the warm wall).
Per mode: the cold walls (median, best, spread), the warm walls, the
reads and reads/s of the cold and the warm median against the reference's
83,000 reads/s (bench.py's baseline, as tools/bench_10m.py reports it),
the peak RSS after the first run of each process and after both, the EM
split with the problems each tier carried to the card, the prep split,
the flow split with the problems per MCF size class and those above 256
nodes (on the host), the launches per kernel and per __global__
function, and the check against its host twin (PERF.md section 2):
  g_r_default        -g -r, the default (every EM on the host)
  g_r_fast_em        -g -r --fast-em at the default bound (routing.py):
                     the default's body where no problem went to the
                     card, else the rule of g_r_fast_em_f32
  g_r_fast_em_f32    --fast-em with STRAWB_FASTEM_AFTER=0 (every
                     tier-fitting problem in f32 on the card): the
                     default's transcript set, TPM p99 relative error
                     <= 1e-3
  g_r_device_em      STRAWB_DEVICE_EM=1: the default's body byte for byte
  g_r_prep_all       STRAWB_DEVICE_PREP=all: the default's body
  g_default          -g, the default
  g_low_mem          -g --low-mem: g_default's body byte for byte
  g_mcf              -g with STRAWB_DEVICE_MCF=1: g_mcf_force_host's body
  g_mcf_force_host   the same with STRAWB_FORCE_HOST=1 (every flow on
                     mincostflow.solve_dense)
Prints one JSON line, the card first (with --out also written to
build/strawberry_tpu_torch/realistic.json, or realistic_<shape>.json for
another shape), and exits 1 when a mode differs from its twin. A tool,
not a benchmark: no speed is judged.
"""
from __future__ import annotations

import os
import sys

from . import common

MCF = {"STRAWB_DEVICE_MCF": "1"}
# the reference's published single-thread throughput (bench.py:5-7)
BASELINE_READS_PER_S = 83_000.0
# name: (the mode's argv before the BAM, its environment, its host twin,
# the rule it is held to: "bytes", "tpm" or "fast_em")
MODES = {
    "g_r_default": (["-r"], {}, None, None),
    "g_r_fast_em": (["-r", "--fast-em"], {}, "g_r_default", "fast_em"),
    "g_r_fast_em_f32": (["-r", "--fast-em"], {"STRAWB_FASTEM_AFTER": "0"},
                        "g_r_default", "tpm"),
    "g_r_device_em": (["-r"], {"STRAWB_DEVICE_EM": "1"}, "g_r_default",
                      "bytes"),
    "g_r_prep_all": (["-r"], {"STRAWB_DEVICE_PREP": "all"}, "g_r_default",
                     "bytes"),
    "g_default": ([], {}, None, None),
    "g_low_mem": (["--low-mem"], {}, "g_default", "bytes"),
    "g_mcf": ([], MCF, "g_mcf_force_host", "bytes"),
    "g_mcf_force_host": ([], {**MCF, "STRAWB_FORCE_HOST": "1"}, None, None),
}


def twin_check(name, walls):
    """Mode `name` against its host twin, by its rule."""
    _argv, _env, twin, rule = MODES[name]
    m, t = walls[name], walls[twin]
    same = m["body_sha256"] is not None and m["body_sha256"] == t[
        "body_sha256"]
    if rule == "fast_em" and m["em_stats"].get("device", 0) == 0:
        rule = "bytes"  # the default's route: its bytes
    if rule in ("fast_em", "tpm"):
        check = common.tpm_check(t["gtf"], m["gtf"])
        check["runs_agree"] = m["body_sha256"] is not None
    else:
        check = {"body_equal": same, "ok": same}
    return {"twin": twin, "rule": "bytes" if rule == "bytes" else "tpm",
            **check}


def summary(m):
    """What the JSON line keeps of a mode's cli_walls record, with the
    reads/s of its cold and warm medians against the baseline."""
    keep = ("walls_s", "median_s", "best_s", "spread_s", "warm_walls_s",
            "warm_median_s", "reads", "start_rss_mb", "first_run_rss_mb",
            "max_rss_mb",
            "em_stats", "prep_stats", "flow_stats", "launches",
            "function_launches", "profiled", "phases_s", "warm_phases_s",
            "body_sha256")
    out = {k: m[k] for k in keep if k in m}
    for pre, wall in (("", m["median_s"]), ("warm_", m["warm_median_s"])):
        out[pre + "reads_per_s"] = m["reads"] / wall
        out[pre + "vs_baseline"] = m["reads"] / wall / BASELINE_READS_PER_S
    return out


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0], data=True,
                      n_frags=5_000_000)
    p.add_argument("--reps", type=int, default=3,
                   help="timed fresh processes a mode (at least 1)")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed fresh processes a mode before them, "
                        "profiled on the card")
    args = p.parse_args(argv)
    if args.reps < 1:
        p.error("--reps must be at least 1")
    common.setup(args)
    ds = common.dataset(args)
    from .. import routing
    modes = {n: (["-g", ds.gtf, *argv_, *ds.flags], env)
             for n, (argv_, env, _twin, _rule) in MODES.items()}
    with common.scratch_dir() as work:
        walls = common.cli_walls(modes, [ds.bam], args.reps, args.device,
                                 reference=None, runs_dir=work, warm=True,
                                 warmup=args.warmup, profile=True)
        twins = {n: twin_check(n, walls) for n in modes if MODES[n][2]}
    result = {
        "device": args.device, "shape": ds.shape, "strand": ds.strand,
        "n_frags": ds.n_frags, "data": os.path.abspath(ds.dir),
        "reps": args.reps, "warmup": args.warmup,
        "baseline_reads_per_s": BASELINE_READS_PER_S,
        "routing": {k: getattr(routing, k) for k in (
            "DEVICE_EM", "FASTEM_AFTER", "PREP", "PREP_GRANULE",
            "MCF_MIN_NODES")},
        "modes": {n: summary(walls[n]) for n in modes},
        "twins": twins,
        "twins_ok": all(t["ok"] for t in twins.values()),
        "note": "walls of cli.main on the host's clock to the device "
                "synchronized, each cold run in a fresh process with the "
                "phase timer on, the warm run second in the same process; "
                "reads_per_s: reads over the median wall; "
                "start_rss_mb, first_run_rss_mb, max_rss_mb: the process's "
                "own peak before its cold run, after it and after both "
                "(common.peak_rss_mb); "
                "profiled: the untimed first process under torch.profiler "
                "(device activity only; on the card)"}
    common.emit("realistic", args, result,
                out_dir=os.path.dirname(common.OUT_DIR),
                stem="realistic" if ds.shape == "realistic"
                else f"realistic_{ds.shape}")
    return 0 if result["twins_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
