"""What the crossover tools share: the command line, the card's name and
power limit, the realistic data set, CLI runs in fresh processes, and the
one JSON line each tool prints."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "build", "strawberry_tpu_torch", "crossover")

# the realistic shape and the tests' sets are fr-stranded
STRAND = "--fr"

# every variable that moves work between the host and the card: a run of a
# tool sets the ones its mode names and clears the others
ROUTING_VARS = ("STRAWB_FORCE_HOST", "STRAWB_DEVICE_EM",
                "STRAWB_FASTEM_AFTER", "STRAWB_DEVICE_PREP",
                "STRAWB_PREP_BUDGET", "STRAWB_DEVICE_MCF")


def parser(description: str, data: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu runs the kernels' plain PyTorch versions (for "
                        "the tests: its times are no times of the card)")
    p.add_argument("--out", action="store_true",
                   help=f"also write the JSON line to {OUT_DIR}/<tool>.json")
    if data:
        p.add_argument("--n-frags", type=int, default=1_000_000,
                       help="fragments of the realistic set")
        p.add_argument("--data", default=None,
                       help="a sim.make_dataset directory (sample_01."
                            "sorted.bam, annotation.gtf); generated there "
                            "on the realistic shape when it holds none "
                            "(default: realistic_<n-frags> under the output "
                            "directory)")
    return p


def setup(args):
    """Route the port to the asked device; a GPU run without a GPU fails
    (no tool falls back to the CPU). Returns the torch.device."""
    import torch
    os.environ["STRAWB_PLATFORM"] = args.device
    for k in ROUTING_VARS:
        os.environ.pop(k, None)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{sys.argv[0]}: CUDA is not available; "
                         "--device cpu runs the plain versions")
    return torch.device(args.device)


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device == "cpu":
        return "cpu"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def emit(tool: str, args, result: dict) -> dict:
    """Print the tool's one JSON line, the card first; with --out also
    write it to OUT_DIR/<tool>.json."""
    line = {"card": card(args.device), "tool": tool, **result}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, tool + ".json"), "w") as f:
            f.write(text + "\n")
    return line


def dataset(args) -> Tuple[str, str]:
    """(bam, gtf) of --data, generated on the bench's realistic shape
    (bench.py's dataset_realistic: seed 303, 24 chromosomes of 16 Mb, up
    to 20 isoforms, exons 2-9, lognormal expression, fr, indel 0.02, clip
    0.03) at --n-frags when the directory holds none."""
    d = args.data or os.path.join(OUT_DIR, f"realistic_{args.n_frags}")
    bam = os.path.join(d, "sample_01.sorted.bam")
    gtf = os.path.join(d, "annotation.gtf")
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        from ..sim import make_dataset
        make_dataset(d, seed=303, n_frags=args.n_frags, n_chroms=24,
                     chrom_len=16_000_000, max_isoforms=20,
                     exon_range=(2, 9), abundance="lognormal",
                     protocol="fr", indel_rate=0.02, clip_rate=0.03)
    return bam, gtf


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


# CLI runs in this fresh process, one after another, with the pipeline's
# phase timer on: per run its exit code, wall (to the device
# synchronized), EM / prep / flow splits and phase seconds, as one JSON
# list on the last line.
_RUNNER = """
import json, sys, time
from strawberry_tpu_torch import cli
from strawberry_tpu_torch.utils import profiling
profiling.enable()
run = cli.run_driver
out = []
for argv in json.loads(sys.argv[1]):
    samples = []
    cli.run_driver = lambda *a, **k: samples.append(run(*a, **k)) \\
        or samples[-1]
    profiling.GLOBAL.phases.clear()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = samples[0] if samples else None
    out.append({"rc": rc, "wall_s": wall,
                "em_stats": getattr(s, "em_stats", {}),
                "prep_stats": getattr(s, "prep_stats", None) or {},
                "flow_stats": getattr(s, "flow_stats", {}),
                "phases_s": {k: v.seconds for k, v in
                             profiling.GLOBAL.phases.items()}})
print(json.dumps(out))
"""

PROCESS_TIMEOUT_S = 900


def cli_process(argvs: List[List[str]], env: Dict[str, str],
                device: str) -> List[dict]:
    """Runs of the port's CLI, one after another in one fresh process
    under `env` (on top of this environment less ROUTING_VARS)."""
    full = {k: v for k, v in os.environ.items() if k not in ROUTING_VARS}
    full.update(env, STRAWB_PLATFORM=device)
    proc = subprocess.run([sys.executable, "-c", _RUNNER, json.dumps(argvs)],
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
              base: List[str], reps: int, device: str, reference: str,
              runs_dir: str, warm: bool = False) -> Dict[str, dict]:
    """Each mode (name -> (extra argv, env)) of `base` in fresh processes,
    writing under `runs_dir`: one untimed run each, then `reps` timed runs
    each, in turns (the order rotates each round, so no mode runs in a
    block). Per mode: the walls, their median, best and spread (max -
    min), the last run's splits and phase seconds, each run's
    `locus_context` and `host_em` seconds, and whether every run's GTF
    body equals the `reference` mode's first. With `warm`, each process
    runs its mode a second time after the timed one (`warm_walls_s`,
    `warm_phases_s`): what a fresh process pays that a later run in the
    same process does not."""
    names = list(modes)
    out = {n: {"walls_s": [], "locus_context_s": [], "host_em_s": []}
           for n in names}
    if warm:
        for n in names:
            out[n]["warm_walls_s"] = []
    ref_body, bodies_equal = None, {n: True for n in names}
    order = [reference] + [n for n in names if n != reference]
    for rnd in range(1 + reps):
        k = rnd % len(order)
        for name in order[k:] + order[:k]:
            extra, env = modes[name]
            gtfs = [os.path.join(runs_dir, f"{name}.{rnd}.{i}.gtf")
                    for i in range(2 if warm and rnd else 1)]
            res = cli_process([extra + base + ["-o", g, "-T", g[:-4] + ".log"]
                               for g in gtfs], env, device)
            for g in gtfs:
                b = body(g)
                if ref_body is None and name == reference:
                    ref_body = b
                if ref_body is not None and b != ref_body:
                    bodies_equal[name] = False
            if rnd == 0:
                continue
            m = out[name]
            m["walls_s"].append(res[0]["wall_s"])
            m["locus_context_s"].append(
                res[0]["phases_s"].get("locus_context", 0.0))
            m["host_em_s"].append(res[0]["phases_s"].get("host_em", 0.0))
            for key in ("em_stats", "prep_stats", "flow_stats", "phases_s"):
                m[key] = res[0][key]
            if warm:
                m["warm_walls_s"].append(res[1]["wall_s"])
                m["warm_phases_s"] = res[1]["phases_s"]
    for name in names:
        m = out[name]
        w = m["walls_s"]
        m.update(median_s=statistics.median(w), best_s=min(w),
                 spread_s=max(w) - min(w),
                 body_equals_reference=bodies_equal[name])
        if warm:
            m["warm_median_s"] = statistics.median(m["warm_walls_s"])
    return out


def beats(a: dict, b: dict) -> bool:
    """Mode a beats mode b when a's median wall is below b's by more than
    the larger of the two spreads."""
    return b["median_s"] - a["median_s"] > max(a["spread_s"], b["spread_s"])
