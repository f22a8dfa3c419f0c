"""Where the host's CPU goes per read, on the card's host: the counterpart
of the JAX repo's tools/budget_50x.py, with the -p scaling and the floor of
the peak resident set measured here.

    python -m strawberry_tpu_torch.tools.budget [--device cpu]
        [--n-frags 5000000 | --data DIR [--shape S]] [--p 1,2,4,8,16]
        [--p-reps 3] [--data-dir DIR] [--out]

Every part runs in fresh processes: this one imports no torch and stays
small, since on a machine without VmHWM a child's ru_maxrss starts from
its parent's peak (PERF.md section 6).
1. The accounting (budget_50x.py:60-98,187-196), in one process: `-g -r`
   with the set's strand (bench.py's realistic set at --n-frags by
   default) through pipeline.run_driver with a null sink for the GTF and
   the log (common.NullSink), as budget_50x.py runs it, and the phase timer
   on. A warm-up run, the process's first, whose phases are the cold ones
   (pass2_quant holds its first `import torch`), then a run after
   native_counters(reset=True): the reads, the wall, the process's user and
   system CPU (getrusage), each phase's wall and thread CPU, each native
   hot path's thread CPU, the host's cores (os.cpu_count() and those this
   process may use) and the CPU-bound wall floor (the total CPU over the
   usable cores), and what the 20x and 50x targets need at this per-read
   cost. Empty native counters raise. A null log takes run_driver's
   null-log path (common.NullSink), which no CLI run takes, so the same
   accounting is made again in another fresh process on the CLI's path,
   cli.main with -o and -T files (`cli_path`); part 2's walls are the
   CLI's too.
2. -p scaling: the CLI's `-g -r -p N` for each N of --p up to the cores
   this process may use, in fresh processes, in turns, --p-reps each
   (common.cli_walls); every body must equal -p 1's, else the exit code
   is 1.
3. The memory floor: the peak resident set (ru_maxrss, from wait4) of a
   fresh process that runs `pass`; `import torch`; `import torch` and one
   tensor on the device; the port's host library loaded
   (io/native.py::get_lib, built by part 1 already); `-g -r` on the small
   shape at PROBE_FRAGS fragments (made under --data-dir); the same with
   STRAWB_PLATFORM=cpu; and the same with MALLOC_ARENA_MAX=2.
chip_offload_bound: the card's copy rates and empty-launch round trip from
tools/device_character.py's JSON (build/strawberry_tpu_torch/crossover/),
or null with a note where it was not run on the card. Prints one JSON line,
the card first (with --out also written to
build/strawberry_tpu_torch/budget.json).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import resource
import subprocess
import sys
import time

from . import common
from .realistic import BASELINE_READS_PER_S

TARGETS = {"20x": 20 * BASELINE_READS_PER_S, "50x": 50 * BASELINE_READS_PER_S}
# the phases no other phase holds (pass 1 and 2 on the main thread, the
# annotation on its side thread): their thread CPU is a part of the
# process's
TOP_LEVEL = ("bam_open_stream", "bam_decode", "pass1_assemble",
             "pass2_quant", "gtf_parse", "gtf_ref_build")
# native counters whose scope lies inside another's (native/cluster.cc:
# run() holds the collapse and emit scopes; native/quantprep.cc: the
# weight loop runs inside strawb_quant_locus_pre's scope)
NESTED = {"cluster_collapse": "cluster_scan", "cluster_emit": "cluster_scan",
          "collapse_p2": "scan_p2", "emit_p2": "scan_p2",
          "quant_weights": "quant_prep"}
PROBE_FRAGS = 3000

_ACCOUNT = """
import json, sys
from strawberry_tpu_torch.tools.budget import account
print(json.dumps(account(json.loads(sys.argv[1]), sys.argv[2])))
"""


def phase_seconds(prof):
    return ({k: st.seconds for k, st in prof.phases.items()},
            {k: st.cpu for k, st in prof.phases.items()})


def account(argv, path="null"):
    """Part 1, in the process that calls it (a fresh one: see _ACCOUNT):
    on `path` "null", run_driver with null sinks (budget_50x.py's run);
    on "cli", cli.main with -o and -T files, as a user runs it (no Sample
    comes back, so no reads nor em_stats)."""
    from .. import cli
    from ..pipeline import run_driver
    from ..utils import profiling
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    prof = profiling.GLOBAL
    profiling.enable()
    with common.scratch_dir() as work:
        def run(k):
            if path == "null":
                return run_driver(args.bam, cfg, common.NullSink(),
                                  common.NullSink())
            out = os.path.join(work, f"run{k}")
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main([*argv, "-o", out + ".gtf", "-T",
                             out + ".log"]) != 0:
                    raise RuntimeError(f"cli.main {argv}: exit code != 0")
        t0 = time.perf_counter()
        run(0)
        common.synchronize()
        cold = {"wall_s": time.perf_counter() - t0}
        cold["phase_wall_s"], cold["phase_thread_cpu_s"] = phase_seconds(
            prof)
        prof.phases.clear()
        profiling.native_counters(reset=True)
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        sample = run(1)
        common.synchronize()
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    native = profiling.native_counters()
    if not native:
        raise RuntimeError("native_counters() is empty: the host library's "
                           "counters could not be read")
    phases, phase_cpu = phase_seconds(prof)
    return {"reads": sample and len(sample.table), "wall_s": wall,
            "cpu_user_s": ru1.ru_utime - ru0.ru_utime,
            "cpu_sys_s": ru1.ru_stime - ru0.ru_stime,
            "phase_wall_s": phases, "phase_thread_cpu_s": phase_cpu,
            "native_thread_cpu_s": native, "cold": cold,
            "peak_rss_mb": common.peak_rss_mb(),
            "em_stats": sample and sample.em_stats}


def accounting(argv, device, path="null"):
    env = {k: v for k, v in os.environ.items()
           if k not in common.ROUTING_VARS}
    proc = subprocess.run([sys.executable, "-c", _ACCOUNT, json.dumps(argv),
                           path], cwd=common.ROOT,
                          env=dict(env, STRAWB_PLATFORM=device),
                          capture_output=True, text=True,
                          timeout=common.PROCESS_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"accounting run ({path}) failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def with_cold(acc, cores):
    """budget() of an accounting run, with its cold run's phases beside
    the warm ones."""
    out, cold = budget(acc, cores), acc["cold"]
    out.update({
        "cold_wall_s": cold["wall_s"],
        "cold_phase_wall_s": cold["phase_wall_s"],
        "cold_phase_thread_cpu_s": cold["phase_thread_cpu_s"],
        "cold_minus_warm_phase_wall_s": {
            k: v - out["phase_wall_s"].get(k, 0.0)
            for k, v in cold["phase_wall_s"].items()},
        "accounting_peak_rss_mb": acc["peak_rss_mb"]})
    return out


def budget(acc, cores):
    """budget_50x.py's arithmetic on the accounting run."""
    reads, wall = acc["reads"], acc["wall_s"]
    total = acc["cpu_user_s"] + acc["cpu_sys_s"]
    top = sum(acc["phase_thread_cpu_s"].get(k, 0.0) for k in TOP_LEVEL)
    out = {"reads": reads, "wall_s": wall, "reads_per_sec": reads / wall,
           "vs_baseline": reads / wall / BASELINE_READS_PER_S,
           "cpu_user_s": acc["cpu_user_s"], "cpu_sys_s": acc["cpu_sys_s"],
           "total_cpu_s": total, "cpu_bound_wall_floor_s": total / cores,
           "phase_wall_s": acc["phase_wall_s"],
           "phase_thread_cpu_s": acc["phase_thread_cpu_s"],
           "native_thread_cpu_s": acc["native_thread_cpu_s"],
           "cpu_accounting": {
               "sum_phase_thread_cpu_s": sum(
                   acc["phase_thread_cpu_s"].values()),
               "top_level_phase_thread_cpu_s": top,
               "sum_native_thread_cpu_s": sum(
                   acc["native_thread_cpu_s"].values()),
               "sum_native_outer_thread_cpu_s": sum(
                   v for k, v in acc["native_thread_cpu_s"].items()
                   if k not in NESTED),
               "note": "total_cpu_s ~= the top-level phases' thread CPU "
                       f"({', '.join(TOP_LEVEL)}) + the native pools' "
                       "worker CPU (the outer counters: NESTED's lie "
                       "inside them) + unphased start-up; phases and "
                       "counters nest, so the raw sums count inner ones "
                       "twice"},
           "targets": {}}
    for name, rps in TARGETS.items():
        need_wall = reads / rps
        out["targets"][name] = {
            "reads_per_sec": rps, "required_wall_s": need_wall,
            "cores_needed_at_current_per_read_cost": total / need_wall,
            "or_work_reduction_factor_on_this_host":
                total / (need_wall * cores)}
    t50 = out["targets"]["50x"]
    out["verdict"] = (
        f"{reads} reads at 50x need a wall of at most "
        f"{t50['required_wall_s']:.3f} s; the run costs {total:.3f} s of "
        f"CPU, so on these {cores} cores the floor is "
        f"{total / cores:.3f} s at perfect overlap: 50x needs "
        f"{t50['cores_needed_at_current_per_read_cost']:.1f} cores at this "
        "per-read cost, or a "
        f"{t50['or_work_reduction_factor_on_this_host']:.2f}x cut of the "
        "work per read")
    return out


def p_scaling(ds, ns, reps, device):
    """Part 2: -p N against -p 1, fresh processes in turns."""
    modes = {f"p{n}": (["-p", str(n)], {}) for n in ns}
    with common.scratch_dir() as work:
        walls = common.cli_walls(modes, ["-g", ds.gtf, "-r", *ds.flags,
                                         ds.bam], reps, device,
                                 reference="p1", runs_dir=work, warmup=0)
    keep = ("walls_s", "median_s", "best_s", "spread_s", "start_rss_mb",
            "max_rss_mb", "body_equals_reference")
    return {n: {k: m[k] for k in keep} for n, m in walls.items()}


def probe_mb(argv, env):
    """The peak resident set of a fresh process (ru_maxrss from wait4,
    which also holds the peak of any child it waited for) and its wall."""
    t0 = time.perf_counter()
    with subprocess.Popen(argv, cwd=common.ROOT, env=env,
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE) as proc:
        err = proc.stderr.read()
        _pid, status, ru = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode != 0:
        raise RuntimeError(f"probe {argv} exit code {proc.returncode}:\n"
                           + err.decode(errors="replace")[-4000:])
    return {"peak_rss_mb": ru.ru_maxrss / 1024,
            "wall_s": time.perf_counter() - t0}


def memory_floor(small, device, work):
    """Part 3, one fresh process a probe."""
    py = [sys.executable, "-c"]
    gtf = os.path.join(work, "probe.gtf")
    cli = [sys.executable, "-m", "strawberry_tpu_torch.cli", "-g", small.gtf,
           "-r", *small.flags, "-o", gtf, "-T", gtf[:-4] + ".log",
           small.bam]
    probes = {
        "python_pass": (py + ["pass"], {}),
        "import_torch": (py + ["import torch"], {}),
        "import_torch_one_tensor": (py + [
            "import sys, torch; torch.ones(1, device=sys.argv[1])", device],
            {}),
        "host_library": (py + ["from strawberry_tpu_torch.io.native import "
                               "get_lib; get_lib()"], {}),
        "cli_small": (cli, {}),
        "cli_small_platform_cpu": (cli, {"STRAWB_PLATFORM": "cpu"}),
        "cli_small_malloc_arena_max_2": (cli, {"MALLOC_ARENA_MAX": "2"}),
    }
    base = {k: v for k, v in os.environ.items()
            if k not in common.ROUTING_VARS}
    out = {}
    for name, (argv, env) in probes.items():
        for path in (gtf, gtf[:-4] + ".log"):
            if os.path.exists(path):
                os.remove(path)
        out[name] = probe_mb(argv, {**base, "STRAWB_PLATFORM": device,
                                    **env})
    return out


def offload_bound():
    """The card's copy rates and round trip, from device_character's JSON
    when a run on the card wrote it."""
    path = os.path.join(common.OUT_DIR, "device_character.json")
    dc = None
    if os.path.exists(path):
        with open(path) as f:
            dc = json.load(f)
    if not dc or not dc.get("copy_gbps_pinned"):
        return None, ("no device_character.json of a run on the card: "
                      "python -m strawberry_tpu_torch.tools.device_character "
                      "--out first")
    pinned, pageable = dc["copy_gbps_pinned"], dc["copy_gbps_pageable"]
    return {"card": dc["card"], "source": os.path.relpath(path,
                                                          common.ROOT),
            "h2d_gbps_pinned": pinned["h2d"],
            "d2h_gbps_pinned": pinned["d2h"],
            "h2d_gbps_pageable": pageable["h2d"],
            "d2h_gbps_pageable": pageable["d2h"],
            "empty_launch_roundtrip_us": dc["empty_launch_roundtrip"]}, \
        "measured by tools/device_character.py on the card"


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0], data=True,
                      n_frags=5_000_000)
    p.add_argument("--p", default="1,2,4,8,16",
                   help="the -p values, those above the usable cores "
                        "dropped (1 always)")
    p.add_argument("--p-reps", type=int, default=3,
                   help="timed fresh processes a -p value")
    p.add_argument("--data-dir", default=common.OUT_DIR,
                   help=f"where the memory probes' small_{PROBE_FRAGS} set "
                        "is found or made")
    args = p.parse_args(argv)
    common.setup(args)
    ds = common.dataset(args)
    small = common.datasets([("small", PROBE_FRAGS)],
                            args.data_dir)["small", PROBE_FRAGS]
    cores, usable = os.cpu_count() or 1, len(os.sched_getaffinity(0))
    argv = ["-g", ds.gtf, "-r", *ds.flags, ds.bam]
    acc = accounting(argv, args.device)
    out = with_cold(acc, usable)
    cli_acc = accounting(argv, args.device, path="cli")
    cli_acc["reads"] = acc["reads"]  # the same set's
    cli_path = with_cold(cli_acc, usable)
    ns = sorted({1} | {int(n) for n in args.p.split(",") if int(n) <= usable})
    with common.scratch_dir() as work:
        floor = memory_floor(small, args.device, work)
    scaling = p_scaling(ds, ns, args.p_reps, args.device)
    bound, note = offload_bound()
    ok = all(m["body_equals_reference"] for m in scaling.values())
    common.emit("budget", args, {
        "device": args.device, "shape": ds.shape, "strand": ds.strand,
        "n_frags": ds.n_frags, "data": os.path.abspath(ds.dir),
        "host_cores": cores, "host_cores_usable": usable, **out,
        "em_stats": acc["em_stats"], "cli_path": cli_path,
        "p_scaling": scaling, "p_bodies_equal": ok,
        "memory_floor": floor, "tool_peak_rss_mb": common.peak_rss_mb(),
        "chip_offload_bound": bound, "chip_offload_bound_note": note,
        "note": "part 1 in one fresh process (the cold run its first) "
                "on run_driver's null-log path, as budget_50x.py; cli_path "
                "the same in another on cli.main's (the path users run); "
                "-p walls of cli.main in fresh processes, in turns; "
                "memory_floor: ru_maxrss of each fresh probe process, "
                "tool_peak_rss_mb the floor its parent could pass on"},
        out_dir=os.path.dirname(common.OUT_DIR))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
