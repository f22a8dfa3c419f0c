"""What the crossover tools share: the command line, the card's name and
power limit, the named shapes of the data sets (each with its strand),
CLI runs in fresh processes, and the one JSON line each tool prints."""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "build", "strawberry_tpu_torch", "crossover")

# every variable that moves work between the host and the card: a run of a
# tool sets the ones its mode names and clears the others
ROUTING_VARS = ("STRAWB_FORCE_HOST", "STRAWB_DEVICE_EM",
                "STRAWB_FASTEM_AFTER", "STRAWB_DEVICE_PREP",
                "STRAWB_PREP_BUDGET", "STRAWB_DEVICE_MCF")


def parser(description: str, data: bool = False,
           n_frags: int = 1_000_000) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu runs the kernels' plain PyTorch versions (for "
                        "the tests: its times are no times of the card)")
    p.add_argument("--out", action="store_true",
                   help=f"also write the JSON line to {OUT_DIR}/<tool>.json")
    if data:
        p.add_argument("--n-frags", type=int, default=n_frags,
                       help="fragments of a set the tool generates")
        p.add_argument("--shape", choices=sorted(SHAPES), default=None,
                       help="the set's shape (SHAPES), which gives its "
                            "strand; generated sets record theirs beside "
                            "them (default for a set generated here: "
                            "realistic)")
        p.add_argument("--data", default=None,
                       help="a sim.make_dataset directory (sample_01."
                            "sorted.bam, annotation.gtf) whose shape is "
                            "recorded beside it or given by --shape; "
                            "generated there on --shape when it holds none "
                            "(default: <shape>_<n-frags> under the output "
                            "directory)")
    return p


def setup(args) -> None:
    """Route the port to the asked device; a GPU run without a GPU fails
    (no tool falls back to the CPU). CUDA is asked for in a process of its
    own, so this one needs no torch: a CLI process it starts takes this
    process's peak resident set for the floor of its own (peak_rss_mb):
    4,623 MB on an H100 host where the tool had imported torch and asked
    for CUDA (PERF.md section 6). That process also builds the host
    library and, on the card, every kernel (each once an install), so no
    run a tool times pays a build."""
    os.environ["STRAWB_PLATFORM"] = args.device
    for k in ROUTING_VARS:
        os.environ.pop(k, None)
    rc = subprocess.run([sys.executable, "-c", _PREPARE, args.device],
                        cwd=ROOT).returncode
    if rc == _NO_CUDA:
        raise SystemExit(f"{sys.argv[0]}: CUDA is not available; "
                         "--device cpu runs the plain versions")
    if rc != 0:
        raise RuntimeError(f"building the host library or the kernels: "
                           f"exit code {rc}")


_NO_CUDA = 3
_PREPARE = f"""
import glob, os, sys
if sys.argv[1] == "cuda":
    import torch
    if not torch.cuda.is_available():
        sys.exit({_NO_CUDA})
from strawberry_tpu_torch.io.native import get_lib
get_lib()
if sys.argv[1] == "cuda":
    from strawberry_tpu_torch.utils import kernels
    kernels.build_all(sorted(os.path.basename(p)[:-3] for p in
                             glob.glob(os.path.join(kernels.CSRC, "*.cu"))))
"""


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device == "cpu":
        return "cpu"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def emit(tool: str, args, result: dict, out_dir: str = OUT_DIR,
         stem: Optional[str] = None) -> dict:
    """Print the tool's one JSON line, the card first; with --out also
    write it to <out_dir>/<stem, default the tool>.json."""
    line = {"card": card(args.device), "tool": tool, **result}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, (stem or tool) + ".json"), "w") as f:
            f.write(text + "\n")
    return line


# bench.py's dataset_realistic, less its fragment count: seed 303, 24
# chromosomes of 16 Mb, up to 20 isoforms, exons 2-9, lognormal
# expression, fr, indel 0.02, clip 0.03
REALISTIC = dict(seed=303, n_chroms=24, chrom_len=16_000_000,
                 max_isoforms=20, exon_range=(2, 9), abundance="lognormal",
                 protocol="fr", indel_rate=0.02, clip_rate=0.03)
# bench.py's dataset_10m (tools/bench_10m.py): seed 101, 16 chromosomes of
# 2 Mb, up to 8 isoforms, rf, no XS tag, indel 0.02, clip 0.03
EASY = dict(seed=101, n_chroms=16, chrom_len=2_000_000, max_isoforms=8,
            protocol="rf", with_xs=False, indel_rate=0.02, clip_rate=0.03)
# tools/bench_lowmem_scaling.py's dataset_deep: the easy set's reads on
# one chromosome of 32 Mb (seed 111)
DEEP = dict(EASY, seed=111, n_chroms=1, chrom_len=32_000_000)
# the tests' sets: sim.make_dataset's defaults at seed 9 (XS tags)
SMALL = dict(seed=9)
# bench.py's dataset_1m, the quick set: seed 77, 4 chromosomes of 2 Mb, up
# to 3 isoforms, the sim's default protocol; bench.py runs it with no
# strand flag (bench.py:153)
QUICK = dict(seed=77, n_chroms=4, chrom_len=2_000_000, max_isoforms=3)

# shape: (sim.make_dataset's arguments less n_frags, the CLI's strand flag
# or None for none)
SHAPES = {"realistic": (REALISTIC, "--fr"), "easy": (EASY, "--rf"),
          "deep": (DEEP, "--rf"), "small": (SMALL, "--fr"),
          "quick": (QUICK, None)}
# the record a generated set keeps beside it
SHAPE_FILE = "shape.json"


def set_dir(shape: str, n_frags: int, root: str = OUT_DIR) -> str:
    """Where the set of `shape` at `n_frags` fragments is generated."""
    return os.path.join(root, f"{shape}_{n_frags}")


def set_paths(d: str) -> Tuple[str, str]:
    """(bam, gtf) of a sim.make_dataset directory."""
    return (os.path.join(d, "sample_01.sorted.bam"),
            os.path.join(d, "annotation.gtf"))


def generate(d: str, shape: str, n_frags: int) -> None:
    """Make the set of `shape` at `n_frags` fragments in `d`, with its
    annotation's index (index()), and record its shape beside it (last: a
    record means a whole set)."""
    from ..sim import make_dataset
    kwargs, strand = SHAPES[shape]
    make_dataset(d, n_frags=n_frags, **kwargs)
    index(set_paths(d)[1])
    with open(os.path.join(d, SHAPE_FILE), "w") as f:
        json.dump({"shape": shape, "n_frags": n_frags, "strand": strand,
                   "make_dataset": kwargs}, f)


def index(gtf: str) -> None:
    """Write the annotation's index (io/gff.py's `<gtf>.sbidx` sidecar,
    which a run loads instead of parsing the GTF) where it is missing or
    stale: the first run a tool times on a set then does what every later
    one does, and writes nothing."""
    from ..io.gff import parse_native
    parse_native(gtf, cache=True)


def recorded_shape(d: str) -> Optional[dict]:
    """The shape record of the set in `d`, or None."""
    path = os.path.join(d, SHAPE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class DataSet(NamedTuple):
    dir: str
    bam: str
    gtf: str
    shape: str
    strand: Optional[str]    # None: the shape runs with no strand flag
    n_frags: Optional[int]   # None: a set given without a record

    @property
    def flags(self) -> List[str]:
        """The CLI's strand flag of the set, as argv items."""
        return [self.strand] if self.strand else []


def resolve(d: str, shape: Optional[str], n_frags: int,
            given: bool) -> DataSet:
    """The set in `d` with its shape: the recorded one, which a `shape`
    given must equal; for a set without a record the `shape` given, and
    none given (`given`: `d` came from the caller) is refused, since a
    strand is never guessed. A directory without a set gets `shape`
    (default realistic) at `n_frags`, unmade yet."""
    bam, gtf = set_paths(d)
    have = os.path.exists(bam) and os.path.exists(gtf)
    rec = recorded_shape(d) if have else None
    if rec is not None:
        if shape is not None and shape != rec["shape"]:
            raise SystemExit(f"{d}: a set of shape {rec['shape']!r}, not "
                             f"{shape!r}")
        shape, n_frags = rec["shape"], rec["n_frags"]
    elif have and given:
        if shape is None:
            raise SystemExit(f"--data {d}: no shape recorded beside the set "
                             f"({SHAPE_FILE}); give --shape, since the "
                             "strand follows from it")
        n_frags = None
    shape = shape or "realistic"
    return DataSet(d, bam, gtf, shape, SHAPES[shape][1], n_frags)


def dataset(args) -> DataSet:
    """--data (default: the directory of --shape at --n-frags) and its
    shape (resolve), generated on that shape at --n-frags when the
    directory holds no set, else indexed (start_preparing), in a process
    of its own: the generator's peak resident set (14 GB at 5M realistic
    fragments) stays out of this process and of the runs it starts
    (peak_rss_mb)."""
    shape = getattr(args, "shape", None)
    d = args.data or set_dir(shape or "realistic", args.n_frags)
    ds = resolve(d, shape, args.n_frags, given=args.data is not None)
    wait_generated(start_preparing(ds))
    return ds


def datasets(wanted: List[Tuple[str, int]], root: str = OUT_DIR
             ) -> Dict[Tuple[str, int], DataSet]:
    """The sets of `wanted` ((shape, n_frags) each) under `root` as
    <shape>_<n>, every missing one generated first, all side by side, each
    in a process of its own (as dataset())."""
    sets, started = {}, []
    for shape, n in wanted:
        d = set_dir(shape, n, root)
        sets[shape, n] = ds = resolve(d, shape, n, given=False)
        started.append(start_preparing(ds))
    for s in started:
        wait_generated(s)
    return sets


def start_generating(d: str, shape: str, n_frags: int,
                     log=None) -> Tuple[subprocess.Popen, str]:
    """Start generate() in a process of its own, which prints its seconds
    to stderr (or `log`); wait_generated() waits for it. Several run side
    by side."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _GENERATE, d, shape, str(n_frags)],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT if log else None)
    return proc, f"{shape} at {n_frags} fragments"


def start_preparing(ds: DataSet) -> Tuple[subprocess.Popen, str]:
    """start_generating() for a set not made yet; for one on disk, index()
    in a process of its own (its parse stays out of this process)."""
    if not (os.path.exists(ds.bam) and os.path.exists(ds.gtf)):
        return start_generating(ds.dir, ds.shape, ds.n_frags)
    proc = subprocess.Popen([sys.executable, "-c", _INDEX, ds.gtf],
                            cwd=ROOT)
    return proc, f"the index of {ds.gtf}"


def wait_generated(started) -> None:
    """Wait for a start_generating() or start_preparing() process; raise
    if it failed."""
    proc, what = started
    if proc.wait() != 0:
        raise RuntimeError(f"generating {what}: exit code {proc.returncode}")


_GENERATE = """
import sys, time
from strawberry_tpu_torch.tools.common import generate
t0 = time.perf_counter()
generate(sys.argv[1], sys.argv[2], int(sys.argv[3]))
print(f"generated {sys.argv[2]} at {sys.argv[3]} fragments in "
      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
"""


_INDEX = """
import sys
from strawberry_tpu_torch.tools.common import index
index(sys.argv[1])
"""


class NullSink:
    """The null sink of bench.py and budget_50x.py, for a run's GTF and
    log: pipeline.run_driver takes its null-log path (is_null: no log text
    built, and the vectorised quant preamble, pipeline.py's vec_ok), which
    a CLI run, always given a log file, never takes."""
    is_null = True

    def write(self, *_a):
        pass


def synchronize() -> None:
    """Wait for the device, where this process has used one; imports no
    torch that the runs did not import."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def scratch_dir():
    """A directory of this process's own (under TMPDIR) for the runs'
    outputs, removed at the end: no two runs of a tool share a path."""
    d = tempfile.mkdtemp(prefix="strawb_crossover_")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def body(path: str) -> str:
    """A GTF's body: every line but the # header."""
    with open(path) as f:
        return "".join(line for line in f if not line.startswith("#"))


def timed(fn, reps: int) -> Dict[str, float]:
    """fn() `reps` times after one untimed call: the best and the median
    seconds (fn ends with the work done, the device synchronized)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return {"best_s": min(ts), "median_s": statistics.median(ts)}


def digest(path: str) -> str:
    """The sha256 of a GTF's body."""
    h = hashlib.sha256()
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                h.update(line.encode())
    return h.hexdigest()


def tpms(path: str) -> Dict[str, float]:
    """{transcript_id: TPM} of a GTF's transcript lines."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("#") and "\ttranscript\t" in line:
                attrs = line.rsplit("\t", 1)[-1]
                tid = attrs.split('transcript_id "')[1].split('"')[0]
                out[tid] = float(attrs.split('TPM "')[1].split('"')[0])
    return out


# --fast-em's rule against the default run (PERF.md section 2)
TPM_P99_MAX = 1e-3


def tpm_check(ref_gtf: str, gtf: str) -> dict:
    """The --fast-em rule: the same transcript set as `ref_gtf`, every TPM
    finite, and the TPM relative error's p99 at most TPM_P99_MAX."""
    import numpy as np
    ref, got = tpms(ref_gtf), tpms(gtf)
    if not ref or set(ref) != set(got):
        return {"same_transcripts": False, "ok": False}
    a = np.array([ref[t] for t in sorted(ref)])
    b = np.array([got[t] for t in sorted(ref)])
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
    p99 = float(np.percentile(rel, 99))
    finite = bool(np.isfinite(b).all())
    return {"same_transcripts": True, "finite": finite,
            "tpm_p99_rel_err": p99, "tpm_max_rel_err": float(rel.max()),
            "ok": finite and p99 <= TPM_P99_MAX}


def peak_rss_mb(status: str = "/proc/self/status") -> float:
    """This process's peak resident set in MiB: VmHWM, which the kernel
    resets at exec, where `status` gives it; else getrusage's ru_maxrss,
    which after an exec also holds the peak its parent had reached when
    it forked (so dataset() makes a set in a process of its own, and a
    tool's own process stays small)."""
    with open(status) as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


# the kernels' wrappers (module, function), each counting its launches and
# those of each __global__ function it launches
WRAPPERS = {"em_bucket": ("strawberry_tpu_torch.quant.cuda_em",
                          "em_bucket_cuda"),
            "quant_prep": ("strawberry_tpu_torch.quant.cuda_prep",
                           "quant_prep_cuda"),
            "mcf_bucket": ("strawberry_tpu_torch.assembly.cuda_mcf",
                           "mcf_ragged_cuda"),
            "shard_colsum": ("strawberry_tpu_torch.parallel.cuda_reduce",
                             "shard_colsum_cuda")}

# CLI runs in this fresh process, one after another, with the pipeline's
# phase timer on: per run its exit code, wall (to the device
# synchronized), the reads it took (the hit table's length, as the JAX
# repo's tools/bench_10m.py counts them), EM / prep / flow splits, phase
# seconds, the process's peak RSS before its first run and so far
# (peak_rss_mb), whether CUDA was initialized, and each kernel's
# launches (and each
# __global__ function's), as one JSON list on the last line. The wrappers
# are imported after a run, never before the first: that would take
# `import torch` out of its wall. With profile=1 the first run is under
# torch.profiler (device activity only), which also adds each __global__
# function's kernel events and device milliseconds.
_RUNNER = """
import importlib, json, re, sys, time
from strawberry_tpu_torch import cli
from strawberry_tpu_torch.tools.common import WRAPPERS, peak_rss_mb
from strawberry_tpu_torch.utils import profiling
profiling.enable()
run = cli.run_driver
argvs, profile = json.loads(sys.argv[1]), sys.argv[2] == "1"
def wrappers():
    return {k: getattr(importlib.import_module(m), f)
            for k, (m, f) in WRAPPERS.items()}
out, start_rss = [], peak_rss_mb()
for i, argv in enumerate(argvs):
    samples = []
    cli.run_driver = lambda *a, **k: samples.append(run(*a, **k)) \\
        or samples[-1]
    profiling.GLOBAL.phases.clear()
    if i:
        for w in wrappers().values():
            w.launches = 0
            w.function_launches = dict.fromkeys(w.function_launches, 0)
    prof = None
    if profile and not i:
        from torch.profiler import ProfilerActivity, profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = samples[0] if samples else None
    ws = wrappers()
    fl = {fn: n for w in ws.values() for fn, n in w.function_launches.items()}
    r = {"rc": rc, "wall_s": wall,
         "start_rss_mb": start_rss, "max_rss_mb": peak_rss_mb(),
         "cuda_initialized": torch.cuda.is_initialized(),
         "reads": len(s.table) if s is not None else None,
         "em_stats": getattr(s, "em_stats", {}),
         "prep_stats": getattr(s, "prep_stats", None) or {},
         "flow_stats": getattr(s, "flow_stats", {}),
         "launches": {k: w.launches for k, w in ws.items()},
         "function_launches": fl,
         "phases_s": {k: v.seconds for k, v in
                      profiling.GLOBAL.phases.items()}}
    if prof is not None:
        prof.__exit__(None, None, None)
        ms, events = dict.fromkeys(fl, 0.0), dict.fromkeys(fl, 0)
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:  # older torch
                us = e.self_cuda_time_total
            for fn in fl:
                # whole names: the prep's kernel is not em_rows_kernel
                if re.search(rf"\\b{fn}\\b", e.key):
                    ms[fn] += us / 1e3
                    events[fn] += e.count
        r.update(kernel_ms=ms, kernel_events=events)
    out.append(r)
print(json.dumps(out))
"""

PROCESS_TIMEOUT_S = 900


def cli_process(argvs: List[List[str]], env: Dict[str, str],
                device: str, profile: bool = False) -> List[dict]:
    """Runs of the port's CLI, one after another in one fresh process
    under `env` (on top of this environment less ROUTING_VARS); with
    `profile` (on the card only) the first under torch.profiler."""
    full = {k: v for k, v in os.environ.items() if k not in ROUTING_VARS}
    full.update(env, STRAWB_PLATFORM=device)
    proc = subprocess.run([sys.executable, "-c", _RUNNER, json.dumps(argvs),
                           "1" if profile and device == "cuda" else "0"],
                          cwd=ROOT, env=full, capture_output=True, text=True,
                          timeout=PROCESS_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {argvs} under {env} failed:\n"
                           + proc.stderr[-4000:])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for argv, r in zip(argvs, res):
        if r["rc"] != 0:
            raise RuntimeError(f"CLI {argv} under {env}: exit code {r['rc']}")
    return res


def cli_walls(modes: Dict[str, Tuple[List[str], Dict[str, str]]],
              base: List[str], reps: int, device: str,
              reference: Optional[str], runs_dir: str, warm: bool = False,
              warmup: int = 1, profile: bool = False) -> Dict[str, dict]:
    """Each mode (name -> (extra argv, env)) of `base` in fresh processes,
    writing under `runs_dir`: `warmup` untimed runs each (under
    torch.profiler with `profile`, on the card: `kernel_ms` and
    `kernel_events` by __global__ function), then `reps` timed runs each,
    in turns (the order rotates each round, so no mode runs in a block).
    Per mode: the walls, their median, best and spread (max - min), the
    last run's reads, splits, launches and phase seconds, each process's
    peak RSS before its first run (`start_rss_mb`), after its timed run
    (`first_run_rss_mb`) and after its last (`max_rss_mb`),
    `locus_context` and `host_em` seconds, the sha256 of its GTF body
    (`body_sha256`, None when two runs differ), the path of its first
    run's GTF (`gtf`, kept; every later one is removed once read), and
    whether every run's GTF body equals the `reference` mode's first
    (with a reference). With `warm`, each timed process runs its mode a
    second time after the timed one (`warm_walls_s`, `warm_phases_s`):
    what a fresh process pays that a later run in the same process does
    not."""
    names = list(modes)
    out = {n: {"walls_s": [], "start_rss_mb": [], "first_run_rss_mb": [],
               "max_rss_mb": [], "locus_context_s": [], "host_em_s": []}
           for n in names}
    if warm:
        for n in names:
            out[n]["warm_walls_s"] = []
    digests = {n: set() for n in names}
    order = ([reference] if reference else []) + [n for n in names
                                                  if n != reference]
    for rnd in range(warmup + reps):
        k = rnd % len(order)
        for name in order[k:] + order[:k]:
            extra, env = modes[name]
            timed_run = rnd >= warmup
            gtfs = [os.path.join(runs_dir, f"{name}.{rnd}.{i}.gtf")
                    for i in range(2 if warm and timed_run else 1)]
            res = cli_process([extra + base + ["-o", g, "-T", g[:-4] + ".log"]
                               for g in gtfs], env, device,
                              profile=profile and not timed_run)
            for g in gtfs:
                digests[name].add(digest(g))
                if "gtf" not in out[name]:
                    out[name]["gtf"] = g
                else:
                    for path in (g, g[:-4] + ".log"):
                        os.remove(path)
            m = out[name]
            if not timed_run:
                for key in ("kernel_ms", "kernel_events", "launches",
                            "function_launches"):
                    if key in res[0]:
                        m.setdefault("profiled", {})[key] = res[0][key]
                continue
            m["walls_s"].append(res[0]["wall_s"])
            m["start_rss_mb"].append(res[0]["start_rss_mb"])
            m["first_run_rss_mb"].append(res[0]["max_rss_mb"])
            m["max_rss_mb"].append(res[-1]["max_rss_mb"])
            m["locus_context_s"].append(
                res[0]["phases_s"].get("locus_context", 0.0))
            m["host_em_s"].append(sum(res[0]["phases_s"].get(k, 0.0)
                                      for k in ("host_em", "host_em_wait")))
            for key in ("reads", "em_stats", "prep_stats", "flow_stats",
                        "launches", "function_launches", "phases_s"):
                m[key] = res[0][key]
            if warm:
                m["warm_walls_s"].append(res[1]["wall_s"])
                m["warm_phases_s"] = res[1]["phases_s"]
    for name in names:
        m = out[name]
        w = m["walls_s"]
        m.update(median_s=statistics.median(w), best_s=min(w),
                 spread_s=max(w) - min(w),
                 body_sha256=next(iter(digests[name]))
                 if len(digests[name]) == 1 else None)
        if reference:
            m["body_equals_reference"] = digests[name] == digests[reference]
        if warm:
            m["warm_median_s"] = statistics.median(m["warm_walls_s"])
    return out


def beats(a: dict, b: dict) -> bool:
    """Mode a beats mode b when a's median wall is below b's by more than
    the larger of the two spreads."""
    return b["median_s"] - a["median_s"] > max(a["spread_s"], b["spread_s"])
