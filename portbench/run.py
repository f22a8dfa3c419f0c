"""Run one cell of the benchmark and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the seed's set (an annotation, the cell's sample BAM and a small
warm-up BAM of the same annotation) is made by `portbench.gen` in a child
process, and the card is probed by another, before this process imports
torch or the port, so that neither's memory reaches this process's peak.
Then the port is imported and the warm-up BAM is run twice through the
cell's own entry (`strawberry_tpu_torch.cli.main`) and flags, which loads
torch, starts CUDA, builds or loads every kernel of the route and writes the
annotation's index (anew in every run), and the sample BAM once, which grows the process's
memory to its full size.

The window: the sample BAM is run whole, back to back, through the same
entry with the user's argv (`-o` and `-T` into the run's directory). A
sample is never cut: none starts that the last one's wall says would end
after `--seconds`. With `--trace 1` the program writes one torch.profiler
trace a sample, read and deleted here: every other sample of the window,
so that the host's CPU is read on the samples between (the profiler's own
CPU kept out of it), and from the full-size warm-up on, so that the
profiler's first start is in set-up but not in the cold warm-ups that
`cold_premium_s` compares.

After the window the peak RSS is read, the port's state freed, and the plain
reference the traffic names (`portbench/<check>.py`, run as a child process
that imports nothing of the program) judges every sample's output. The result is one JSON line: the
cell's end-to-end metrics (`--trace 0`) or its per-layer ones (`--trace 1`),
each from `portbench/metrics/<name>.py`.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
PROGRAM = "strawberry_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "strawberry_tpu")
# native counters whose scope lies inside another's, so that a sum over
# every slot counts them twice (native/cluster.cc: a scan holds its collapse
# and emit scopes; native/quantprep.cc: the weight loop runs inside the
# locus prep's scope)
NESTED = {"cluster_collapse": "cluster_scan", "cluster_emit": "cluster_scan",
          "collapse_p2": "scan_p2", "emit_p2": "scan_p2",
          "quant_weights": "quant_prep"}


@dataclass
class Sample:
    wall_s: float
    reads: int
    ok: bool
    output: str
    host_cpu_s: float
    native_cpu_s: Optional[float]
    trace: Optional[dict] = None
    traced: bool = False


@dataclass
class Run:
    setup_s: float = 0.0
    warmup_walls: List[float] = field(default_factory=list)
    samples: List[Sample] = field(default_factory=list)
    window_s: float = 0.0
    peak_rss_bytes: int = 0


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_state() -> dict:
    """The process's resident MB and threads, for the per-sample line on
    stderr; empty where /proc has neither."""
    st = {}
    try:
        with open("/proc/self/statm") as f:
            st["rss_mb"] = int(f.read().split()[1]) * \
                os.sysconf("SC_PAGE_SIZE") / 1e6
        with open("/proc/self/status") as f:
            st["threads"] = int(next(ln for ln in f
                                     if ln.startswith("Threads:")).split()[1])
    except (OSError, ValueError, IndexError, StopIteration):
        pass
    return st


def native_outer(counters: dict) -> float:
    """The native pools' thread CPU: the outer counters alone."""
    return sum(v for k, v in counters.items() if k not in NESTED)


def make_set(cfg_path: str, cfg: dict, seed: int, key: str):
    """The seed's set under build/portbench/sets/<config>/<key>, made in a
    child unless it is there; one set is kept a configuration."""
    base = os.path.join(ROOT, "build", "portbench", "sets", cfg["name"])
    out = os.path.join(base, key)
    if os.path.exists(os.path.join(out, "done.json")):
        return out, None
    if os.path.isdir(base):
        for d in os.listdir(base):
            shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    cmd = [sys.executable, "-m", "portbench.gen", "--config", cfg_path,
           "--seed", str(seed), "--out", out]
    return out, subprocess.Popen(cmd, cwd=ROOT)


def probe_card():
    """A child that imports torch and counts the cards, so that this process
    touches neither before its warm-up."""
    code = ("import torch, json; print(json.dumps([torch.cuda.is_available(),"
            " torch.cuda.device_count()]))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def argv_for(bam, gtf, cfg, traffic, out_gtf, log) -> List[str]:
    argv = [bam, "-g", gtf, *traffic["mode_flags"], f"--{cfg['protocol']}"]
    if traffic.get("insert_size_flag"):
        argv += ["-i", f"{cfg['frag_mean']}/{cfg['frag_sd']}"]
    return argv + ["-o", out_gtf, "-T", log]


def set_trace(trace_dir: Optional[str]):
    """Trace the program's next sample into `trace_dir`, or none. The
    program reads STRAWB_TRACE_DIR once, when it is imported, into its
    profiler; the harness sets that setting sample by sample."""
    from strawberry_tpu_torch.utils import profiling
    profiling.GLOBAL._trace_dir = trace_dir


def run_sample(cli_main, argv, trace_dir) -> tuple:
    """One whole sample through the CLI, traced into `trace_dir` if it is
    given: (ok, wall, cpu, native cpu, trace files)."""
    from strawberry_tpu_torch.utils.profiling import native_counters
    set_trace(trace_dir)
    before = native_counters()
    c0 = cpu_seconds()
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    except Exception as e:  # a failed sample counts; the window goes on
        print(f"portbench: sample failed: {e!r}", file=sys.stderr)
        rc = 1
    wall = time.perf_counter() - t0
    cpu = cpu_seconds() - c0
    after = native_counters()
    set_trace(None)
    native = native_outer(after) - native_outer(before) if after else None
    traces = []
    if trace_dir and os.path.isdir(trace_dir):
        traces = sorted(os.path.join(trace_dir, f)
                        for f in os.listdir(trace_dir))
    if trace_dir and rc == 0 and not traces:
        fail("the program wrote no trace of a traced sample", 1)
    return rc == 0, wall, cpu, native, traces


def window(one, seconds: float, clock=time.perf_counter):
    """Whole samples `one(k)` back to back: none starts that the last one's
    wall says would end after `seconds`, the first always does, and a
    failed one ends the window. (samples, seconds from the window's start
    to the last sample's end)."""
    samples: List[Sample] = []
    w0 = end = clock()
    while not samples or end - w0 + samples[-1].wall_s <= seconds:
        samples.append(one(len(samples)))
        end = clock()
        if not samples[-1].ok:
            break
    return samples, end - w0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for portbench's own tests on a CPU, never a measurement
    ap.add_argument("--cpu-test", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--frags", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chroms", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg_path = os.path.join(PKG, "configs", cell["config"] + ".json")
    cfg = load_json(cfg_path)
    traffic = load_json(os.path.join(PKG, "traffic",
                                     cell["traffic"] + ".json"))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = [m for m in bench[kind]
               if args.workload in m.get("workloads", [args.workload])]
    if importlib.util.find_spec(PROGRAM) is None:
        fail(f"the program ({PROGRAM}) is not in this checkout")
    key = str(args.seed)
    if args.frags or args.chroms:       # a test's smaller set
        cfg = dict(cfg, n_frags=args.frags or cfg["n_frags"],
                   n_chroms=args.chroms or cfg["n_chroms"])
        key += f"-{cfg['n_frags']}-{cfg['n_chroms']}"
        cfg_path = os.path.join(ROOT, "build", "portbench",
                                f"{cfg['name']}-{key}.json")
        os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

    # set-up: the set and the card's probe, in children
    set_dir, gen = make_set(cfg_path, cfg, args.seed, key)
    probe = None if args.cpu_test else probe_card()
    if probe is not None:
        out, _ = probe.communicate()
        avail, count = json.loads(out.strip().splitlines()[-1]) \
            if probe.returncode == 0 and out.strip() else (False, 0)
        if not avail or count < cell["chips"]:
            if gen is not None:
                gen.kill()
                gen.wait()
            fail(f"the cell needs {cell['chips']} CUDA device(s); "
                 f"torch.cuda.is_available()={avail}, device_count={count}")
    if gen is not None and gen.wait() != 0:
        fail("making the set failed")
    done = load_json(os.path.join(set_dir, "done.json"))

    # the port's environment: the route, its caches inside the checkout
    work = os.path.join(ROOT, "build", "portbench", "run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    trace_dir = os.path.join(work, "trace") if args.trace else None
    os.environ.update(traffic["env"])
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "portbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(
        ROOT, "build", "portbench", "triton")
    if args.cpu_test:
        os.environ["STRAWB_PLATFORM"] = "cpu"
    os.environ.pop("STRAWB_TRACE_DIR", None)   # traced here, sample by sample

    gtf = os.path.join(set_dir, "annotation.gtf")
    bam = os.path.join(set_dir, "sample.bam")
    # the program writes the annotation's index beside it on its first
    # read: in the first warm-up of every run, the set kept or not
    for f in os.listdir(set_dir):
        if f.endswith(".sbidx"):
            os.remove(os.path.join(set_dir, f))
    run = Run()
    t0 = time.perf_counter()
    from strawberry_tpu_torch.cli import main as cli_main
    warm_bam = os.path.join(set_dir, "warmup.bam")
    for k in range(2):
        w_argv = argv_for(warm_bam, gtf, cfg, traffic,
                          os.path.join(work, f"warmup{k}.gtf"),
                          os.path.join(work, f"warmup{k}.log"))
        if not run_sample(cli_main, w_argv, None)[0]:
            fail("a warm-up sample failed", 1)
        run.warmup_walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    # one whole sample more: a process's first full-size sample pays for
    # its memory's first touch (0.3-1.3 s on the paper set, PERF.md)
    # (traced in a traced run: the profiler's first start is set-up)
    if not run_sample(cli_main, argv_for(
            bam, gtf, cfg, traffic, os.path.join(work, "warmup2.gtf"),
            os.path.join(work, "warmup2.log")), trace_dir)[0]:
        fail("the full-size warm-up sample failed", 1)
    run.warmup_walls.append(time.perf_counter() - t0)
    if trace_dir:
        shutil.rmtree(trace_dir, ignore_errors=True)
    import torch
    on_card = not args.cpu_test
    if on_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            fail("no CUDA device after the warm-up")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        from strawberry_tpu_torch.utils.profiling import native_counters
        if not native_counters():
            fail("the program's native counters read empty", 1)
    run.setup_s = time.perf_counter() - t_start

    # the window: whole samples, back to back; in a traced run every other
    # one traced (the first among them)
    def one(k: int) -> Sample:
        out_gtf = os.path.join(work, f"sample{k}.gtf")
        log = os.path.join(work, f"sample{k}.log")
        traced = trace_dir is not None and k % 2 == 0
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        ok, wall, cpu, native, traces = run_sample(
            cli_main, argv_for(bam, gtf, cfg, traffic, out_gtf, log),
            trace_dir if traced else None)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        if os.path.exists(log):
            os.remove(log)      # the run's log: read by nothing here
        st = host_state()
        print(f"portbench: sample {k}{' traced' if traced else ''}: wall "
              f"{wall:.3f} s, CPU {cpu:.3f} s (system "
              f"{r1.ru_stime - r0.ru_stime:.3f} s, page faults "
              f"{r1.ru_minflt - r0.ru_minflt}), native CPU "
              f"{native if native is None else round(native, 3)} s"
              + "".join(f", {n} {v:.1f}" for n, v in st.items()),
              file=sys.stderr)
        s = Sample(wall, done["reads"], ok, out_gtf, cpu, native,
                   traced=traced)
        if traces:
            keep = os.path.join(work, f"trace{k}")
            os.makedirs(keep)
            s.trace = {"files": [shutil.move(p, keep) for p in traces]}
        return s

    run.samples, run.window_s = window(one, args.seconds)
    run.peak_rss_bytes = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
              if on_card else 0}
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    del cli_main
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the traces, read after the window
    breakdown = None
    if trace_dir:
        from portbench.trace import summarize
        ops, gaps = {}, []
        busy = span = 0.0
        for k, s in enumerate(run.samples):
            if not s.trace:
                continue
            sums = [summarize(p) for p in s.trace["files"]]
            s.trace = {"ranges": {}, "kernels": {}, "busy_s": 0.0,
                       "span_s": 0.0}
            for t in sums:
                for key in ("ranges", "kernels"):
                    for n, v in t[key].items():
                        s.trace[key][n] = s.trace[key].get(n, 0.0) + v
                s.trace["busy_s"] += t["busy_s"]
                s.trace["span_s"] += t["span_s"]
                gaps += t["gaps"]
            for n, v in s.trace["kernels"].items():
                ops[n] = ops.get(n, 0.0) + v
            busy += s.trace["busy_s"]
            span += s.trace["span_s"]
            shutil.rmtree(os.path.join(work, f"trace{k}"), ignore_errors=True)
        device["busy_s"] = busy / cell["chips"]
        device["window_s"] = span
        breakdown = {
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}

    # correctness: the traffic's plain reference (`portbench/<check>.py`),
    # in a child that imports nothing of the program
    check_cmd = [sys.executable, "-m", f"portbench.{traffic['check']}",
                 "--config", cfg_path, "--seed", str(args.seed),
                 "--traffic", os.path.join(PKG, "traffic",
                                           cell["traffic"] + ".json"),
                 "--outputs", *[s.output for s in run.samples if s.ok]]
    t_chk = time.perf_counter()
    chk = subprocess.run(check_cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         text=True)
    t_chk = time.perf_counter() - t_chk
    checks = {}
    if chk.returncode == 0 and chk.stdout.strip():
        checks = json.loads(chk.stdout.strip().splitlines()[-1])
    attempted = len(run.samples)
    failed = sum(not s.ok for s in run.samples)
    correct = bool(checks.get("correct")) and failed == 0

    values = {}
    for m in metrics:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks.get("numbers", {})
    shutil.rmtree(work, ignore_errors=True)
    print(f"portbench: set-up {run.setup_s:.3f} s (warm-ups "
          f"{', '.join(f'{w:.3f}' for w in run.warmup_walls)}); window "
          f"{run.window_s:.3f} s of {attempted} samples, walls "
          f"{', '.join(f'{s.wall_s:.3f}' for s in run.samples)}; the "
          f"check {t_chk:.3f} s", file=sys.stderr)
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
