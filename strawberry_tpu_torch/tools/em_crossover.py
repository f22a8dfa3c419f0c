"""The EM crossover on the GPU: the port's counterpart of the JAX
package's tools/bench_em_crossover.py.

    python -m strawberry_tpu_torch.tools.em_crossover [--device cpu]
        [--shape realistic|easy|deep|small] [--n-frags N | --data DIR]
        [--reps 3] [--walls 3 [--warm]] [--out]

1. Capture. One `-g -r` run of the port hands every locus to the EM
   dispatcher the way the device route does (with the host route on, the
   pipeline sends most loci straight to host_em_batch_raw and they never
   reach EmDispatcher.add), with the solve itself on the host: nothing
   runs on the card. Every problem add() queues is kept, raw (truncated
   counts and weights, as the pipeline builds them), in order.
2. Four solvers on the identical problems, each on the first k problems
   for k in 250, 1000, 4000, 16000 and all of them (best and median of
   --reps timed passes after one untimed one):
   - host: quant/device.host_em_batch_raw in chunks of 2,048 loci, the
     route the default takes (the pipeline runs the same calls on its
     em-raw side thread), and --fast-em's while it keeps every problem
     on the host;
   - host_dispatch: the route --fast-em's first k problems take under
     STRAWB_FASTEM_AFTER=k: the pipeline's LocusProblem build, then
     EmDispatcher's add() and its host batch at finish();
   - f64: EmDispatcher under STRAWB_DEVICE_EM=1, from the LocusProblem
     build through the tier fill, padding, copies, kernel launches and
     the one synchronize of finish();
   - f32: the same under --fast-em with STRAWB_FASTEM_AFTER=0.
3. Exactness on every problem: how many f64 (and host_dispatch) thetas
   differ from the host's in any bit, and the largest relative
   difference, f64 and f32.
4. With --walls N: `-g -r` in fresh processes, N timed runs each after
   one untimed, in turns: the default, STRAWB_DEVICE_EM=1,
   STRAWB_FORCE_HOST=1 and --fast-em with STRAWB_FASTEM_AFTER=0; each
   run's GTF body against the STRAWB_FORCE_HOST=1 run's. --warm runs
   each timed process's mode a second time in the same process.

The rules routing.py applies to the numbers: the f64 EM goes to the card
by default only if its thetas are bit-identical on every problem, its
body equals its STRAWB_FORCE_HOST=1 twin's and its median wall is no
higher than the host default's. STRAWB_FASTEM_AFTER gets a bound only
where the f32 path finished all the problems sooner than the host route
beyond the spread of repeated passes (its median below the host's best):
then the largest k at which it did not beat host_dispatch, the route a
bound sends the first k problems, that way (0: none), provided it beat
the host route that way at every larger prefix; else "all" (no bound:
--fast-em takes the default's route).
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

from . import common

PREFIXES = (250, 1000, 4000, 16000)
RAW_CHUNK = 2048   # loci a host_em_batch_raw call, as the pipeline flushes


@contextlib.contextmanager
def environ(**env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def capture(bam, gtf, strand, out_dir):
    """Every EM problem of one `-g -r` run (writing its GTF and log under
    `out_dir`) as (counts, weights, niso), in the order the dispatcher was
    handed them, and the run's dispatcher counts (n_device + n_host: the
    problems it queued)."""
    from .. import cli
    from ..quant import device as qdev

    problems, made = [], []

    class Capturing(qdev.EmDispatcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            # every locus through add(), as on the device route (the
            # pipeline reads force_host to pick its route)
            self.force_host = False
            made.append(self)

        def add(self, idx, p):
            if p.filtered()[0].size:
                problems.append((p.counts.copy(),
                                 np.array(p.weights, np.float64).ravel(),
                                 p.weights.shape[1]))
            super().add(idx, p)

        def _launch(self, tier):
            # the solve stubbed: the bucket's problems solve on the host
            items, self._fills[tier] = self._fills[tier], []
            self._host_items.extend(items)

    out = os.path.join(out_dir, "em_capture.gtf")
    orig = qdev.EmDispatcher
    qdev.EmDispatcher = Capturing
    try:
        rc = cli.main(["-g", gtf, "-r", strand, "-o", out,
                       "-T", out[:-4] + ".log", bam])
    finally:
        qdev.EmDispatcher = orig
    if rc != 0:
        raise RuntimeError(f"capture run: exit code {rc}")
    counted = sum(d.n_device + d.n_host for d in made)
    return problems, {"dispatchers": len(made), "queued": counted,
                      "gtf": out}


def host_solve(problems):
    """The host route: host_em_batch_raw over chunks of RAW_CHUNK loci.
    Returns theta per problem (None on an init failure)."""
    from ..quant.device import host_em_batch_raw
    out = []
    for s in range(0, len(problems), RAW_CHUNK):
        chunk = problems[s:s + RAW_CHUNK]
        th, off, status = host_em_batch_raw([c for c, _a, _n in chunk],
                                            [a for _c, a, _n in chunk],
                                            [n for _c, _a, n in chunk])
        out += [th[off[m]:off[m + 1]] if status[m] else None
                for m in range(len(chunk))]
    return out


def dispatch(problems, fast_em):
    """The device route: the pipeline's LocusProblem build, then
    EmDispatcher's add() and finish(). Returns (thetas, dispatcher)."""
    from ..quant.device import EmDispatcher, LocusProblem
    d = EmDispatcher(len(problems), fast_em=fast_em)
    for i, (c, a, n) in enumerate(problems):
        d.add(i, LocusProblem(counts=np.trunc(c),
                              weights=np.array(a, np.float64).reshape(
                                  len(c), n)))
    return d.finish(), d


SOLVERS = ("host_dispatch", "f64", "f32")   # the dispatch() routes


def solve(name, problems):
    """(thetas, dispatcher) of the dispatch() route `name` on
    `problems`: host_dispatch is --fast-em bounded at all of them."""
    env = {"host_dispatch": {"STRAWB_FASTEM_AFTER": str(len(problems))},
           "f64": {"STRAWB_DEVICE_EM": "1"},
           "f32": {"STRAWB_FASTEM_AFTER": "0"}}[name]
    with environ(**env):
        return dispatch(problems, fast_em=name != "f64")


def sooner(a, b):
    """Solver a finished sooner than solver b beyond the spread of b's
    passes: a's median below b's best."""
    return a["median_s"] < b["best_s"]


def fastem_after_rule(prefixes):
    """"all" unless the f32 path finished all the problems sooner than the
    host route; else the largest k at which it did not finish sooner than
    host_dispatch (0: none), if it finished sooner than the host route at
    every larger k, else "all"."""
    rows = sorted(prefixes.values(), key=lambda r: r["k"])
    if not sooner(rows[-1]["f32"], rows[-1]["host"]):
        return "all"
    k = max([r["k"] for r in rows
             if not sooner(r["f32"], r["host_dispatch"])], default=0)
    if all(sooner(r["f32"], r["host"]) for r in rows if r["k"] > k):
        return k
    return "all"


def exactness(ref, got):
    """(problems whose theta differs in any bit, the largest relative
    difference, problems where one is None and the other not). A theta is
    an expected read count: the relative difference is taken against
    max(|host theta|, 1e-12), as the smoke's TPM check does."""
    bits, worst, none = 0, 0.0, 0
    for a, b in zip(ref, got):
        if a is None or b is None:
            none += (a is None) != (b is None)
            continue
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if a.shape != b.shape or not np.array_equal(a.view(np.uint64),
                                                    b.view(np.uint64)):
            bits += 1
            if a.shape == b.shape:
                rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
                worst = max(worst, float(rel.max()))
    return bits, worst, none


def shapes(problems):
    rows = sorted(len(c) for c, _a, _n in problems)
    isos = sorted(n for _c, _a, n in problems)
    q = lambda xs, f: xs[min(len(xs) - 1, int(len(xs) * f))]  # noqa: E731
    from ..quant.device import _TIERS
    tiers = [0] * (len(_TIERS) + 1)
    for c, a, n in problems:
        w = a.reshape(len(c), n)
        r = int((w > 1e-5).any(axis=1).sum())
        t = next((t for t, (rb, cb, _b) in enumerate(_TIERS)
                  if r <= rb and n <= cb), len(_TIERS))
        tiers[t] += 1
    return {"rows_p50": q(rows, .5), "rows_p95": q(rows, .95),
            "rows_max": rows[-1], "isos_p50": q(isos, .5),
            "isos_max": isos[-1], "tier_counts": tiers[:-1],
            "over_last_tier": tiers[-1]}


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0], data=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--walls", type=int, default=0,
                   help="timed fresh-process `-g -r` runs a mode (0: none)")
    p.add_argument("--warm", action="store_true",
                   help="with --walls: each timed process runs its mode a "
                        "second time")
    args = p.parse_args(argv)
    common.setup(args)
    import torch
    dev = torch.device(args.device)
    ds = common.dataset(args)
    with common.scratch_dir() as work:
        result = measure(args, dev, ds, work)
    common.emit("em_crossover", args, result)
    return 0


def measure(args, dev, ds, work):
    problems, counts = capture(ds.bam, ds.gtf, ds.strand, work)
    if not problems:
        raise SystemExit("em_crossover: the run made no EM problem")
    n = len(problems)
    counts.pop("gtf")

    host = host_solve(problems)
    thetas, made = {}, {}
    for name in SOLVERS:
        thetas[name], made[name] = solve(name, problems)
    exact = {name: exactness(host, th) for name, th in thetas.items()}

    sync = (lambda: __import__("torch").cuda.synchronize()) \
        if dev.type == "cuda" else (lambda: None)
    prefixes = {}
    for k in [k for k in PREFIXES if k < n] + [n]:
        sub = problems[:k]
        row = {"host": common.timed(lambda: host_solve(sub), args.reps)}
        for name in SOLVERS:
            row[name] = common.timed(lambda: (solve(name, sub), sync()),
                                     args.reps)
        prefixes["all" if k == n else str(k)] = dict(k=k, **row)

    result = {
        "device": args.device, "shape": ds.shape, "strand": ds.strand,
        "n_frags": ds.n_frags, "n_problems": n, "capture": counts,
        **shapes(problems),
        "device_solved": {name: d.n_device for name, d in made.items()},
        **{f"{name}_{what}": v for name, (bits, rel, none) in exact.items()
           for what, v in (("bit_mismatches", bits), ("max_rel_diff", rel),
                           ("none_mismatches", none))},
        "prefixes": prefixes,
        "fastem_after_rule": fastem_after_rule(prefixes),
        "note": "host = host_em_batch_raw in 2048-locus chunks; "
                "host_dispatch/f64/f32 = EmDispatcher from the LocusProblem "
                "build to finish(); seconds on the host's clock, the device "
                "synchronized"}
    if args.walls:
        base = ["-g", ds.gtf, "-r", ds.strand, ds.bam]
        walls = common.cli_walls(
            {"default": ([], {}),
             "device_em": ([], {"STRAWB_DEVICE_EM": "1"}),
             "force_host": ([], {"STRAWB_FORCE_HOST": "1"}),
             "fast_em": (["--fast-em"], {"STRAWB_FASTEM_AFTER": "0"})},
            base, args.walls, args.device, reference="force_host",
            runs_dir=work, warm=args.warm)
        result["walls"] = walls
        bits64, _rel, none64 = exact["f64"]
        result["f64_default_rule"] = {
            "bits_identical": bits64 == 0 and none64 == 0,
            "body_equals_force_host":
                walls["device_em"]["body_equals_reference"],
            "median_not_higher":
                walls["device_em"]["median_s"]
                <= walls["default"]["median_s"]}
    return result


if __name__ == "__main__":
    sys.exit(main())
