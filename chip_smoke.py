#!/usr/bin/env python3
"""Chip smoke for strawberry_tpu_torch: drives the port's main paths once on
one NVIDIA GPU and fails unless every phase holds.

    python3 chip_smoke.py [--n-frags N] [--big-frags M] [--easy-frags E]

Phases:
  1. the card's name and power limit (nvidia-smi); CUDA must be available.
  2. build the host C++ library (from strawberry_tpu_torch/native/, with
     g++) and the four kernels (csrc/em_bucket.cu, csrc/quant_prep.cu,
     csrc/mcf_bucket.cu, csrc/shard_reduce.cu) from this checkout, the
     kernels in parallel, timed; beside them an empty kernel (the floor
     of a launch) and `nvcc -Xptxas -v` on the prep kernel's sources
     (registers, spills, shared memory).
  3. the EM kernel against its plain PyTorch version at the four tier
     shapes, on seeded random buckets that include a zero-denominator
     locus, inactive loci and an all-zero column. f64: rtol/atol 1e-9
     against the plain version and the numpy host oracle
     (quant/em.py::em_run), and two runs bit-identical. f32: the bars of
     tests/test_pallas_em.py against the f64 and the f32 plain versions
     (median relative error < 1e-4, > 95% within 0.1, inactive loci
     exactly theta0). Per tier and type: the kernel's and the plain
     version's times from CUDA events, the plain version's iteration
     counts, the bound (the larger of the operations over the peak rate and
     the bytes over the HBM rate, counted for this bucket's data) and the
     share of it the kernel reaches, the launch plan; at tier 3 also the
     time with 8 CTAs a locus against the 16 the kernel picks.
  3b. the quant-prep kernel (one launch a chunk over locus tiles) against
     its plain version, array-equal, on seeded synthetic chunks that hit
     every edge case of `kern` (padded features, a candidate exon past the
     last one, an intron after the last exon, a hit with no features,
     64-exon isoforms, 16-feature hits, 128 segments) and on chunks at the
     edges of the tile design (a locus of 32,000 pairs, a locus of 200
     isoforms of 64 exons, loci with no hits, hits with no pairs).
     CUDA-event times, the time on the card with the calls queued back to
     back, and an empty launch of the same grid queued the same way.
  3c. the ragged min-cost-flow kernel against its plain version and
     mincostflow.solve_dense, array-equal, on seeded random CMPC problems
     of 3, 8, 13, 32, 33, 64, 128 and 256 nodes with an infeasible problem,
     all in one call (every size class launches) and each size alone (CUDA
     events, and the time on the card with the launches queued back to
     back); the augmentation cap against the plain version.
  3d. the shard-row reduction kernel against its plain version and against
     torch.sum(rows, dim=0), the one PyTorch call that computes the same
     function: seeded count rows up to 2^40 at (1, 600), (2, 1201),
     (8, 4097) and (8, 1), bit-identical to both and across two runs; bad
     inputs refused. CUDA-event times of all three (the kernel and
     torch.sum in turns), both device times from torch.profiler, the bytes
     bound, and the host time of each step of the wrapper's path.
  3e. sharded_em_bucket over a mesh of 4 (mdl 1) and of 8 (mdl 2), every
     slot on this GPU with its own stream, on phase 3's tier-1 and tier-2
     buckets: driven with its launch count set to 0 before and read after,
     then theta and failed bit-identical to one launch over the whole
     bucket in f64 (f32 reported) and within 1e-9 of the plain version.
  4. end to end through the CLI on the bench's realistic shape (bench.py
     dataset_realistic: seed 303, 24 x 16 Mb chromosomes, up to 20
     isoforms) at 1M fragments (~2M reads), generated once under
     build/chip_smoke/: `-g -r` host f64 (the default), `-g -r --fast-em`
     with STRAWB_FASTEM_AFTER=0 (every tier-fitting EM on the card; so
     are phase 5's and the parallel layer's --fast-em runs), `-g -r` with
     STRAWB_DEVICE_EM=1,
     `-g -r` with STRAWB_DEVICE_PREP=all and =budget, `-g` (the default),
     `-g` with STRAWB_DEVICE_MCF=1 and the same with STRAWB_FORCE_HOST=1
     (every flow on the host solver), and `-g --fast-em`. Every kernel
     launch count is set to 0 just before each run and read just after it.
     The fast-em transcript set must equal the default's with TPM p99
     relative error <= 1e-3, and every tier-fitting EM must have gone
     through the kernel. The prep runs must give the default's GTF body
     byte for byte, with device loci and prep launches; the MCF run must
     give the body of its host-solver twin byte for byte, with device
     problems and MCF launches. The fast-em, prep "all" and MCF runs are
     repeated under torch.profiler and the pipeline's phase timer
     (device busy time, each kernel's share, phase report). Each kernel
     is then held against its plain version again, with the same numbers
     as in phase 3, on inputs the main path made: the first full bucket of
     each EM tier, the first full prep chunk (and every prep chunk of the
     STRAWB_DEVICE_PREP=all run, array-equal), every MCF problem of the run
     (in one call) and the largest call alone. The profiled MCF run
     reports its copies each way and `flow_dp`. Then the parallel layer, each against
     the default
     `-g -r` body: `--shards 4` with STRAWB_DEVICE_EM=1 (byte for byte;
     repeated under the profiler) and with --fast-em (the fast-em bars),
     EM and reduction launches in both; two CLI processes joined by
     torch.distributed over gloo on 127.0.0.1, both on this GPU, with
     STRAWB_DEVICE_EM=1 (rank 0's body byte for byte, a ranged-ingest
     record and EM and reduction launches in each rank); `-p 2` in a fresh
     process (byte for byte, no launch, no CUDA context in the parent at
     the forks). The reduction kernel is held once more on the rows the
     sharded and the 2-process run summed.
  5. the STRAWB_TRACE_DIR trace held against the wrappers' launch counts:
     `-g -r --fast-em`, `-g -r` with STRAWB_DEVICE_PREP=all, `-g` with
     STRAWB_DEVICE_MCF=1 and `-g -r --shards 4` with STRAWB_DEVICE_EM=1,
     each in a fresh process with its own trace directory (the seconds
     spent starting and stopping the trace reported). Each must give
     the GTF body of its phase-4 twin and write one Chrome trace that holds,
     for every __global__ function of the four kernel sources, as many
     kernel events as the wrappers counted, with each function's total and
     mean kernel time; the device busy time and idle share read from each
     trace are printed beside the profiled reruns'.
     Then a traced `-p 2` (the default's body, one trace of the host alone,
     no CUDA context at the forks), and launches made right after a trace
     starts (phase 3c's 256-node MCF launch, 100 reduction launches) under
     the port's trace and under torch.profiler with CUDA activity alone, in
     a fresh process (held: every launch in the trace) and in this one
     (recorded with the process's age: torch.profiler drops such kernel
     records in an old process, see utils/profiling.py).
  6. the routing defaults (strawberry_tpu_torch/routing.py) on the card:
     its constants and what each default resolves to are printed; each
     default that sends work to the card runs beside its
     STRAWB_FORCE_HOST=1 twin (the same GTF body, its kernel launched);
     phase 4's default runs launched nothing the defaults keep on the
     host; `-g -r --fast-em` at the default STRAWB_FASTEM_AFTER (no bound:
     the default's body byte for byte, no launch, every theta the
     default's); the mixed route, `--fast-em` with STRAWB_FASTEM_AFTER at
     half the run's problems (the first half's thetas bit-identical to
     the default's, every tier-fitting problem past it through the f32
     kernel, TPM p99 relative error <= 1e-3); no STRAWB_DEVICE_MCF=1
     problem on the card lies below device_min_nodes.
  7. end to end on the same shape at 2.5M fragments (~4.9M reads;
     --big-frags; cut from bench.py's 5M to keep the smoke well inside
     its time with phase 8's set made beside it), generated once under
     build/strawberry_tpu_torch/crossover/ (where tools/realistic.py
     looks for it) by a process of its own that starts after phase 1 and
     runs beside phases 2-6 on the host's other cores (so phases 2-6's
     host-paced times are taken with it running): `-g -r` (the default),
     with STRAWB_DEVICE_EM=1 (the default's body byte for byte),
     `--fast-em` at the default bound (its route's launches; the
     default's body where nothing went to the card, else TPM p99 <=
     1e-3) and with STRAWB_FASTEM_AFTER=0 (TPM p99 <= 1e-3), with
     STRAWB_DEVICE_PREP=all (the default's body byte for byte), and `-g`
     with STRAWB_DEVICE_MCF=1 against its STRAWB_FORCE_HOST=1 twin (byte
     for byte). The EM tier counts and MCF size classes are printed on a
     line of their own, with the tiers and classes the 1M run left empty;
     then the kernels against their plain versions on what this run
     made, timed with their bounds: the first bucket of each EM tier, the
     first prep chunk of 100 loci (every chunk array-equal), every MCF
     problem in one call, the largest call, and each size class above the
     warp class.
  8. the same on bench.py's easy set (dataset_10m: seed 101, 16 x 2 Mb,
     up to 8 isoforms, rf, no XS tag; the reference's published 10M-read
     scale) at 5M fragments (--easy-frags), every run with --rf, its set
     generated as phase 7's, by a process of its own started beside it
     after phase 1, into build/strawberry_tpu_torch/crossover/easy_<n>/
     (where tools/realistic.py --shape easy and tools/lowmem_scaling.py
     look for it); besides phase 7's runs, `-g` (the default) against
     `-g --low-mem` (byte for byte, no launch in either); the first prep
     chunk is timed (its flushes of deep loci are halved to fit the prep
     tiers, so none holds 100 loci).

The prep and MCF times come with their bounds too. The line before the
last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}. Any failure exits nonzero without it.
"""
import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3
def random_bucket(rng, B, R, C):
    """A padded tier bucket like the dispatcher's, with the edge cases the
    kernel must get right: locus 0 hits a zero denominator on a valid row
    in iteration 2, locus 1 has an all-zero column, the last two loci are
    inactive padding. The port's tests use it too."""
    import numpy as np
    F = np.zeros((B, R, C))
    u = np.zeros((B, R))
    theta0 = np.zeros((B, C))
    for b in range(B):
        r = int(rng.integers(2, R + 1))
        c = int(rng.integers(2, C + 1))
        W = rng.random((r, c)) * rng.random((r, c))
        W[rng.random((r, c)) < 0.4] = 0.0
        F[b, :r, :c] = W
        u[b, :r] = rng.integers(0, 500, size=r)
        theta0[b, :c] = u[b, :r].sum() / c
    F[0] = 0.0
    u[0] = 0.0
    F[0, 0, 0], F[0, 1, 1] = 0.5, 0.4
    u[0, 0] = 10.0
    theta0[0] = 0.0
    theta0[0, :2] = 5.0
    F[1, :, 0] = 0.0
    valid = (F > 1e-5).any(axis=2)
    active = np.ones(B, bool)
    active[-2:] = False
    return F, u, theta0, valid, active


def capped_locus(R=40, scale=1e4):
    """Two nearly collinear columns: theta drifts for more than 1,000
    iterations, so the cap stops the locus (at 16 to 40 rows)."""
    import numpy as np
    rng = np.random.default_rng(0)
    base = rng.random(R) + 0.5
    F = np.stack([base, base * (1 + 1e-3 * rng.standard_normal(R))], axis=1)
    u = np.full(R, scale)
    theta0 = np.array([1.5, 0.5]) * scale * R / 2
    return F, u, theta0


def special_bucket(R=128, C=8):
    """A bucket of the edge cases the kernel's extent rule and loop must
    get right: locus 0 hits the iteration cap; locus 1 has a column with
    zero F and nonzero theta0, and another past its last column of F;
    locus 2 has a non-prefix valid mask (invalid rows with nonzero weights
    among valid ones); locus 3 is random; locus 4 is inactive. The port's
    tests use it too."""
    import numpy as np
    B = 5
    F = np.zeros((B, R, C))
    u = np.zeros((B, R))
    theta0 = np.zeros((B, C))
    valid = np.zeros((B, R), bool)
    Fc, uc, tc = capped_locus(min(40, R))
    F[0, :len(uc), :2], u[0, :len(uc)], theta0[0, :2] = Fc, uc, tc
    rng = np.random.default_rng(3)
    for b in (1, 2, 3):
        r, c = int(rng.integers(R // 2, R)), int(rng.integers(2, C))
        W = rng.random((r, c)) * rng.random((r, c))
        W[rng.random((r, c)) < 0.3] = 0.0
        F[b, :r, :c] = W
        u[b, :r] = rng.integers(1, 300, size=r)
        theta0[b, :c] = u[b, :r].sum() / c
    F[1, :, 1] = 0.0             # zero column, theta0 nonzero there
    theta0[1, C - 1] = 7.0       # ... and past the last column of F
    valid[:] = (F > 1e-5).any(axis=2)
    valid[2, 1::3] = False       # invalid rows that carry weights
    active = np.ones(B, bool)
    active[-1] = False
    return F, u, theta0, valid, active


# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W): HBM,
# float32 and float64 outside the tensor cores, and int8 in them, the
# highest integer rate, which bounds any integer kernel from below.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "f64": 34e12, "int": 1979e12}


def bound(ops, nbytes, peak):
    """The least time the card could take for work of `ops` operations at
    the `peak` rate that reads and writes `nbytes` once: the larger of the
    two times, and which one it is."""
    ops_ms = float(ops) / PEAK_OPS_S[peak] * 1e3
    bytes_ms = float(nbytes) / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": float(ops), "bytes": int(nbytes)}


def em_bound(bucket, iters, dt):
    """The EM bound of one bucket for this run's data: each active locus
    does 4 R C operations an iteration (a multiply-add per element of F in
    the E-step and one in the M-step) and R C for the column sums, over its
    own extents (rows to the last valid or weighted one, columns to the
    last one with F or theta0 nonzero) and the iterations the plain
    version counted; the padded inputs are read once and theta and failed
    written once."""
    import numpy as np
    F, u, theta0, valid, active = bucket
    B, R, C = F.shape
    rows = valid | (F != 0).any(axis=2)
    cols = (F != 0).any(axis=1) | (theta0 != 0)
    R_b = np.where(rows.any(1), R - np.argmax(rows[:, ::-1], axis=1), 0)
    C_b = np.where(cols.any(1), C - np.argmax(cols[:, ::-1], axis=1), 0)
    ops = ((4 * iters + 1) * R_b * C_b * active).sum()
    s = 4 if dt == "f32" else 8
    nbytes = (B * R * C + B * R + 2 * B * C) * s + B * R + 2 * B
    return bound(ops, nbytes, dt)


def cuda_ms(fn, reps):
    import torch
    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """The time on the card of one call of fn: CUDA events around `reps`
    calls queued behind a spin kernel (torch.cuda._sleep, about 30 ms)
    that keeps the card busy while the host queues them, so the card runs
    them back to back and the host's pace drops out (the card's own gaps
    between launches stay in)."""
    import torch
    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# An empty kernel: launches of it queued back to back (queued_ms) give the
# card's floor for a launch of a given grid, which no design of a kernel
# can go under. Built by phase 2 beside the kernels.
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int strawb_empty_launches(int g0, int g1, int threads,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g0 > 0) empty_kernel<<<g0, threads, 0, s>>>();
  if (g1 > 0) empty_kernel<<<g1, threads, 0, s>>>();
  return cudaGetLastError();
}
"""
EMPTY_LIB = os.path.join(WORK, "libempty_launch.so")


def start_probe_builds():
    """Start nvcc on the empty kernel, and `nvcc -Xptxas -v` on
    csrc/quant_prep.cu (registers, spills and shared memory of its
    __global__ function); returns the processes for
    finish_probe_builds."""
    from strawberry_tpu_torch.utils import kernels
    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(WORK, "empty_launch.cu")
    with open(src, "w") as f:
        f.write(EMPTY_CU)
    nvcc = kernels._nvcc()
    run = lambda argv: subprocess.Popen(  # noqa: E731
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return {"empty": run([nvcc, *kernels.NVCC_FLAGS, "-o", EMPTY_LIB, src]),
            "ptxas": run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
                          os.path.join(WORK, "quant_prep.cubin"),
                          os.path.join(kernels.CSRC, "quant_prep.cu")])}


def parse_ptxas(text, functions):
    """{function: {registers, spill_stores, spill_loads, smem_bytes}} from
    ptxas's -v report, for the named __global__ functions."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            fn = next((f for f in functions if f in m.group(1)), None)
            continue
        if fn is None:
            continue
        r = report.setdefault(fn, {})
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                r[key] = int(m.group(1))
    return report


def finish_probe_builds(procs):
    """Wait for start_probe_builds' processes; returns the prep kernel's
    ptxas report (parse_ptxas)."""
    texts = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        require(proc.returncode == 0, f"nvcc ({name}) failed:\n{err}")
        texts[name] = out + err
    functions = KERNEL_FUNCTIONS["quant_prep"]
    report = parse_ptxas(texts["ptxas"], functions)
    require(set(report) == set(functions),
            f"ptxas reported {sorted(report)} for quant_prep.cu")
    return report


def empty_launches_ms(grids, threads=256, reps=20):
    """The time on the card of launches of the empty kernel with these
    grids (one or two), queued as queued_ms queues them."""
    import ctypes as C
    from strawberry_tpu_torch.utils.kernels import stream_handle
    lib = C.CDLL(EMPTY_LIB)
    fn = lib.strawb_empty_launches
    fn.restype = C.c_int
    fn.argtypes = [C.c_int, C.c_int, C.c_int, C.c_void_p]
    g0, g1 = (list(grids) + [0])[:2]

    def launch():
        require(fn(g0, g1, threads, stream_handle(0)) == 0,
                "the empty kernel did not launch")
    return queued_ms(launch, reps)


def measured(x, fmt=".4f"):
    """A device time for a log line."""
    return "not measured" if x is None else f"{x:{fmt}} ms"


def device_ms(fn, reps, pattern):
    """The device time of one call of fn, from torch.profiler over `reps`
    calls: the self device time of the kernels whose names match the
    regular expression `pattern`, over reps (None where the profiler saw
    none of them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:  # older torch
            t = e.self_cuda_time_total
        if re.search(pattern, e.key):
            us += t
    return us / reps / 1e3 if us else None


def compare_bucket(dev, bucket, what, edge_cases=False, timed=True):
    """The kernel against its plain version (and em_run) on one bucket, in
    f64 and f32; returns {dtype: {ms, plain_ms, max_abs_err, the plain
    version's iteration counts (max and sum over the loci), bound_ms,
    bound_by, the share of the bound the kernel reaches, the launch plan}}.
    f32 is held to the Pallas bars, and every locus that stops before the
    iteration cap to within 5e-2 relative of the f32 plain version.
    Untimed, it checks and returns {dtype: {max_abs_err}}."""
    import numpy as np
    import torch
    from strawberry_tpu_torch.quant.em import em_run
    from strawberry_tpu_torch.quant.cuda_em import (MAX_ITER,
                                                    bucket_to_torch,
                                                    em_bucket_cuda,
                                                    em_bucket_plan,
                                                    em_bucket_reference)
    F, u, theta0, valid, active = bucket
    a64 = bucket_to_torch(*bucket, dev, torch.float64)
    a32 = bucket_to_torch(*bucket, dev, torch.float32)

    th_k, failed_k = em_bucket_cuda(*a64)
    th_k2, failed_k2 = em_bucket_cuda(*a64)
    th_r, failed_r = em_bucket_reference(*a64)
    torch.cuda.synchronize()
    require(torch.equal(th_k, th_k2) and torch.equal(failed_k, failed_k2),
            f"{what}: f64 kernel not bit-identical across runs")
    err64 = (th_k - th_r).abs().max().item()
    require(torch.allclose(th_k, th_r, rtol=1e-9, atol=1e-9),
            f"{what}: f64 kernel vs plain max abs err {err64}")
    require(torch.equal(failed_k, failed_r),
            f"{what}: f64 failed flags differ from plain")
    require(not edge_cases or (bool(failed_k[0])
                               and not failed_k[-2:].any().item()),
            f"{what}: zero-denominator/inactive flags wrong")
    th_np = th_k.cpu().numpy()
    for b in range(len(active)):
        if not active[b]:
            require(np.array_equal(th_np[b], theta0[b]),
                    f"{what}: inactive locus {b} is not theta0")
            continue
        rows = valid[b]
        # em_run drops invalid rows from the column sums, which the bucket
        # keeps: it is the oracle only where they carry no weight
        if F[b][~rows].any():
            continue
        host = em_run(u[b, rows], F[b, rows], theta0[b])
        host = theta0[b] if host is None else host
        require(np.allclose(th_np[b], host, rtol=1e-9, atol=1e-9),
                f"{what}: locus {b} differs from em_run by "
                f"{np.abs(th_np[b] - host).max()}")

    th32, _ = em_bucket_cuda(*a32)
    th32_r, _, it32 = em_bucket_reference(*a32, iterations=True)
    torch.cuda.synchronize()
    err32 = (th32 - th32_r).abs().max().item()
    t32 = th32.cpu().numpy()
    rel32 = {}
    for ref_name, ref in (("f64", th_np), ("f32 plain", th32_r.cpu().numpy())):
        rel32[ref_name] = rel = np.abs(t32 - ref) / np.maximum(1.0,
                                                             np.abs(ref))
        require(np.median(rel) < 1e-4 and (rel < 0.1).mean() > 0.95,
                f"{what}: f32 kernel vs {ref_name} misses the Pallas bars "
                f"(median {np.median(rel)}, within 0.1 "
                f"{(rel < 0.1).mean()})")
    # the Pallas bars alone would pass a few wrong loci. A locus that stops
    # before the cap may still stop an iteration apart in another summation
    # order and drift along a flat likelihood: the two plain versions, f32
    # and f64, differ by up to 1.2e-2 relative on such loci of these buckets
    uncapped = (it32 < MAX_ITER).cpu().numpy() & active
    rel_unc = (float(rel32["f32 plain"][uncapped].max()) if uncapped.any()
               else 0.0)
    require(rel_unc < 5e-2,
            f"{what}: f32 kernel off the f32 plain version by {rel_unc} "
            f"(relative) on a locus that stops before the cap")
    require(np.array_equal(t32[~active],
                           theta0[~active].astype(np.float32)),
            f"{what}: f32 inactive loci are not theta0")

    if not timed:
        return {"f64": {"max_abs_err": err64}, "f32": {"max_abs_err": err32}}
    out = {}
    for dt, args, err in (("f64", a64, err64), ("f32", a32, err32)):
        iters = em_bucket_reference(*args, iterations=True)[2].cpu().numpy()
        ms = cuda_ms(lambda: em_bucket_cuda(*args), reps=20)
        plain_ms = cuda_ms(lambda: em_bucket_reference(*args), reps=3)
        b = em_bound(bucket, iters, dt)
        out[dt] = r = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                       **({"max_rel_err_uncapped": rel_unc}
                          if dt == "f32" else {}),
                       "iters_max": int(iters.max()),
                       "iters_sum": int(iters.sum()), **b,
                       "bound_share": b["bound_ms"] / ms,
                       "plan": em_bucket_plan(*F.shape, args[0].dtype)}
        log(f"  {what} {tuple(F.shape)} {dt}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}; {100 * b['bound_ms'] / ms:.2f}% of it), "
            f"iterations max {r['iters_max']} sum {r['iters_sum']}, max abs "
            f"err vs plain {err:.3e}" + (
                f" (largest relative on loci under the cap {rel_unc:.3e})"
                if dt == "f32" else "") + f", plan {r['plan']}")
    return out


def check_kernel(dev):
    """Phase 3: the four tier shapes on seeded random buckets with the edge
    cases, then on special_bucket at each shape (checked, not timed);
    returns per dtype the tiers' results summed, each kept under `parts`
    keyed by "BxRxC"."""
    import numpy as np
    from strawberry_tpu_torch.quant.device import _TIERS

    report = {}
    for tier, (R, C, B) in enumerate(_TIERS):
        bucket = random_bucket(np.random.default_rng(1000 + tier), B, R, C)
        res = compare_bucket(dev, bucket, f"tier {tier}", edge_cases=True)
        if tier == 2:
            time_shared_memory_design(dev, bucket, res)
        for dt, r in res.items():
            report.setdefault(dt, {})[f"{B}x{R}x{C}"] = r
        compare_bucket(dev, special_bucket(R, C), f"tier {tier} edge cases "
                       "(iteration cap, zero column, non-prefix valid)",
                       timed=False)
    return {dt: summed(tiers) for dt, tiers in report.items()}


def time_shared_memory_design(dev, bucket, res):
    """Tier 2's bucket with one more, all-zero column: the same loci and
    answer, but C = 33 sends it to the strip kernel (F in shared memory,
    a cluster of 2 CTAs a locus), the design the tier-2 kernel (F in
    registers) replaced. Adds its time and plan to res[dtype]."""
    import numpy as np
    import torch
    from strawberry_tpu_torch.quant.cuda_em import (bucket_to_torch,
                                                    em_bucket_cuda,
                                                    em_bucket_plan)
    F, u, theta0, valid, active = bucket
    wide = (np.pad(F, ((0, 0), (0, 0), (0, 1))), u,
            np.pad(theta0, ((0, 0), (0, 1))), valid, active)
    for dt, torch_dt in (("f64", torch.float64), ("f32", torch.float32)):
        args = bucket_to_torch(*bucket, dev, torch_dt)
        wargs = bucket_to_torch(*wide, dev, torch_dt)
        plan = em_bucket_plan(*wargs[0].shape, torch_dt)
        require(plan["kernel"] == "strip",
                f"tier 2 + 1 column: plan {plan}, not the strip kernel")
        th, th_w = em_bucket_cuda(*args)[0], em_bucket_cuda(*wargs)[0]
        require(dt == "f32" or torch.allclose(th_w[:, :-1], th, rtol=1e-9,
                                              atol=1e-9),
                "tier 2 + 1 column: the strip kernel's f64 answer differs")
        ms = cuda_ms(lambda: em_bucket_cuda(*wargs), reps=20)
        res[dt]["shared_memory_design"] = {"ms": ms, "plan": plan}
        log(f"  tier 2 + 1 zero column {tuple(wargs[0].shape)} {dt}: "
            f"strip kernel (F in shared memory) {ms:.4f} ms against "
            f"{res[dt]['ms']:.4f} ms with F in registers, plan {plan}")


def summed(parts):
    """{ms, plain_ms, max_abs_err, bound_ms, bound_by} summed over the
    parts ({name: result}), each part kept under `parts`: the bound of the
    whole is the sum of the parts' bounds, set by what sets most of it."""
    by = {}
    for r in parts.values():
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    return {"ms": sum(r["ms"] for r in parts.values()),
            "plain_ms": sum(r["plain_ms"] for r in parts.values()),
            "max_abs_err": max(r["max_abs_err"] for r in parts.values()),
            "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
            "parts": parts}


# --------------------------------------------------------------- phase 3b
def prep_tables(rng, exon_counts):
    """Seeded isoform tables (exl, exr, nex, inl, inn) as
    device_prep.isoform_tables builds them (exr padded with INT32_MAX), an
    isoform a count of `exon_counts` (None: 1-64, drawn)."""
    import numpy as np
    n_iso = len(exon_counts)
    i32max = 2**31 - 1
    exl = np.zeros((n_iso, 64), np.int32)
    exr = np.full((n_iso, 64), i32max, np.int32)
    inl = np.zeros((n_iso, 64), np.int32)
    inn = np.zeros((n_iso, 64), np.int32)
    nex = np.zeros(n_iso, np.int32)
    for t, ne in enumerate(exon_counts):
        ne = int(rng.integers(1, 65)) if ne is None else ne
        pos = int(rng.integers(1000, 1_000_000))
        for e in range(ne):
            ln = int(rng.integers(5, 200))
            exl[t, e], exr[t, e] = pos, pos + ln - 1
            pos += ln
            if e < ne - 1:
                gap = int(rng.integers(1, 400))
                inl[t, e], inn[t, e] = pos, gap
                pos += gap
        nex[t] = ne
    return exl, exr, nex, inl, inn


def read_on(rng, tables, t):
    """A read's features drawn on isoform t, then perturbed: a feature
    shifted off its exon, an intron one base off, a MATCH past the last
    exon (candidate exon == exon count), an intron after the last exon, a
    non-MATCH first feature, gaps."""
    exl, exr, nex, inl, inn = tables
    ne = int(nex[t])
    e = int(rng.integers(0, ne))
    f = []
    for k in range(int(rng.integers(1, 9))):
        a = int(exl[t, e]) if f and f[-1][0] == 1 else \
            int(rng.integers(exl[t, e], exr[t, e] + 1))
        b = int(rng.integers(a, exr[t, e] + 1))
        f.append([0, a, b - a + 1])
        if e == ne - 1:
            break
        r = rng.random()
        if r < 0.65:    # the isoform's intron
            f.append([1, int(inl[t, e]), int(inn[t, e])])
            e += 1
        elif r < 0.8:   # a gap inside the exon
            f.append([2, b + 1, int(rng.integers(1, 30))])
        else:           # an intron one base off
            f.append([1, int(inl[t, e]) + 1, int(inn[t, e])])
            e += 1
    last = int(exr[t, ne - 1])
    r = rng.random()
    if r < 0.1:
        f[0][1] -= 1                       # may leave its exon
        f[0][2] += 1
    elif r < 0.2:
        f.append([0, last + 5, 20])        # past the last exon
    elif r < 0.3:
        f.append([1, last + 1, 50])        # intron after the last exon
    elif r < 0.35:
        f.insert(0, [2, f[0][1] - 10, 10])  # non-MATCH first feature
    return f[:16]


def long_read(tables, t, e0, n):
    """n features alternating MATCH/INTRON from exon e0 of isoform t"""
    exl, exr, _nex, inl, inn = tables
    f, e = [], e0
    while len(f) < n:
        f.append([0, int(exl[t, e]), int(exr[t, e] - exl[t, e] + 1)])
        if len(f) < n:
            f.append([1, int(inl[t, e]), int(inn[t, e])])
            e += 1
    return f


def assemble_prep_chunk(rng, tables, loc_iso, loc_hits, full_segs=(0,)):
    """The marshalled chunk (arrays, tables, P) of loci with the isoform
    ids `loc_iso` and the reads `loc_hits`, with seeded disjoint segments
    near each locus's isoforms: 128 for the loci in `full_segs`, 1-128
    (drawn) for the others."""
    import numpy as np
    from strawberry_tpu_torch.quant.device_prep import marshal
    exl = tables[0]
    hits = [h for hs in loc_hits for h in hs]
    feats = [x for h in hits for x in h]
    h_off = np.concatenate([[0], np.cumsum([len(h) for h in hits])])
    hit_loc = np.concatenate([[0], np.cumsum([len(hs) for hs in loc_hits])])
    d_iso_off = np.concatenate([[0], np.cumsum([len(i) for i in loc_iso])])
    d_iso_idx = np.array([i for ids in loc_iso for i in ids], np.int64)
    pair_base = np.concatenate([[0], np.cumsum(
        np.diff(hit_loc) * np.diff(d_iso_off))])
    seg_off, seg_l, seg_r = [0], [], []
    for loc, ids in enumerate(loc_iso):
        pos = (int(exl[ids].min()) if len(ids) else 1000) - 200
        for _ in range(128 if loc in full_segs else int(rng.integers(1, 129))):
            a = pos + int(rng.integers(0, 300))
            b = a + int(rng.integers(0, 300))
            seg_l.append(a)
            seg_r.append(b)
            pos = b + 1
        seg_off.append(len(seg_l))
    code, left, ln = (np.array([x[k] for x in feats], np.int64).reshape(-1)
                      for k in range(3))
    arrays = marshal(hit_loc.astype(np.int64), h_off.astype(np.int64),
                     code.astype(np.int8), left, ln.astype(np.int32),
                     d_iso_off.astype(np.int64), d_iso_idx,
                     pair_base.astype(np.int64), np.array(seg_off),
                     np.array(seg_l, np.int64), np.array(seg_r, np.int64),
                     np.arange(len(loc_iso)))
    return arrays, tables, int(pair_base[-1])


def synthetic_prep_chunk(seed, n_iso=32, n_loci=16):
    """The kernel inputs of a seeded synthetic chunk of device-prep loci,
    as quant/device_prep.py marshals them: (arrays, tables, P), tables =
    (exl, exr, nex, inl, inn). Reads are drawn on the loci's isoforms and
    then perturbed to hit the kernel's edge cases (read_on), with a hit
    with no features, a locus with no hits, isoforms of 1 and 64 exons
    (clamped candidate and cursor indices), 16-feature hits and a locus
    with 128 segments. The port's tests use it too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tables = prep_tables(rng, [1, 64, 2] + [None] * (n_iso - 3))
    exl, exr = tables[:2]
    loc_iso, loc_hits = [], []
    for loc in range(n_loci):
        ids = [0, 1, 2] if loc == 0 else \
            list(rng.choice(n_iso, int(rng.integers(1, 6)), replace=False))
        nh = 0 if loc == 3 else int(rng.integers(1, 26))
        hits = [read_on(rng, tables, int(rng.choice(ids))
                        if rng.random() < 0.85 else int(rng.integers(n_iso)))
                for _ in range(nh)]
        if loc == 0:
            e63 = int(exr[1, 63])
            hits += [long_read(tables, 1, 10, 16),
                     long_read(tables, 1, 48, 15),
                     [[0, int(exl[1, 63]), 5], [1, e63 + 1, 40]],
                     [[0, e63 + 5, 20], [1, e63 + 30, 40], [0, e63 + 80, 9]],
                     [[0, int(exl[0, 0]), 3], [1, int(exr[0, 0]) + 1, 7]],
                     []]                       # a hit with no features
        loc_iso.append([int(i) for i in ids])
        loc_hits.append(hits)
    return assemble_prep_chunk(rng, tables, loc_iso, loc_hits)


def edge_prep_chunks(seed=11):
    """{name: (arrays, tables, P)}: seeded chunks at the edges of the tile
    kernel's design, on one set of tables (24 isoforms of 1-64 exons, then
    200 of 64): a locus of 32,000 pairs (20 isoforms, 1,600 hits), which
    spans many tiles; a locus of 200 isoforms of 64 exons, whose tables
    exceed what a block stages at once; loci with no hits, first, last and
    in a row; and hits whose loci have no isoforms (P == 0, H > 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tables = prep_tables(rng, [None] * 24 + [64] * 200)

    def reads(ids, n):
        return [read_on(rng, tables, int(rng.choice(ids))) for _ in range(n)]

    small = [[20, 21], [22]]
    long_ids = list(range(20))
    many = list(range(24, 224))
    out = {}
    out["long_locus"] = assemble_prep_chunk(
        rng, tables, [long_ids] + small,
        [reads(long_ids, 1600)] + [reads(i, 7) for i in small])
    out["200_isoforms"] = assemble_prep_chunk(
        rng, tables, small + [many],
        [reads(i, 5) for i in small] + [reads(many, 12)], full_segs=(2,))
    no_hits = [[0, 1], [2], [3, 4, 5], [6], [7, 8], [9]]
    out["loci_without_hits"] = assemble_prep_chunk(
        rng, tables, no_hits,
        [reads(ids, n) for ids, n in zip(no_hits, (0, 6, 0, 0, 9, 0))])
    out["no_pairs"] = assemble_prep_chunk(
        rng, tables, [[], [], []],
        [reads([10, 11], 4), reads([12], 3), reads([13], 2)])
    return out


def prep_inputs(arrays, tables, dev):
    """PrepInputs on `dev` from marshalled arrays and isoform tables."""
    import torch
    from strawberry_tpu_torch.quant.cuda_prep import PrepInputs
    from strawberry_tpu_torch.quant.device_prep import tables_to_torch
    return PrepInputs(**{k: torch.from_numpy(v).to(dev)
                         for k, v in arrays.items()},
                      **tables_to_torch(*tables, dev))


def prep_bound(x, arrays, outputs):
    """The prep kernels' bound on one chunk: the inputs read once (of the
    isoform tables, which hold the whole annotation, only the rows of the
    chunk's isoforms) and the outputs written once; as operations, one
    comparison per feature of each (hit, isoform) pair and one per (hit,
    segment) of its locus, at the table's integer rate (the bytes bound is
    far larger either way)."""
    import numpy as np
    from strawberry_tpu_torch.quant.cuda_prep import I32MAX
    hit_off, nf, ni = arrays["hit_off"], arrays["nf"], arrays["ni"]
    feats = np.concatenate([[0], np.cumsum(nf, dtype=np.int64)])
    ops = 0
    for loc in range(len(ni)):
        h0, h1 = int(hit_off[loc]), int(hit_off[loc + 1])
        segs = int((arrays["segl"][loc] != I32MAX).sum())
        ops += int(ni[loc]) * int(feats[h1] - feats[h0]) + (h1 - h0) * segs
    tables = (x.exl, x.exr, x.nex, x.inl, x.inn)
    row_bytes = sum(t[0].numel() * t.element_size() for t in tables)
    # `kern`'s inputs (not the tile table, which is the kernel's own)
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (*x[:17], *outputs))
              - sum(t.numel() * t.element_size() for t in tables)
              + len(np.unique(arrays["iso_idx"])) * row_bytes)
    return bound(ops, nbytes, "int")


def compare_prep(dev, arrays, tables, P, what):
    """The prep kernel against its plain version on one chunk: array-equal,
    two runs identical; returns {ms (CUDA events over back-to-back calls),
    device_ms (the time on the card, queued_ms), launch_floor_ms (an empty
    kernel of the same grid, queued the same way), plain_ms, max_abs_err,
    bound_ms, bound_by}."""
    import torch
    from strawberry_tpu_torch.quant.cuda_prep import (quant_prep_cuda,
                                                      quant_prep_reference)
    x = prep_inputs(arrays, tables, dev)
    ck, rk = quant_prep_cuda(x, P)
    ck2, rk2 = quant_prep_cuda(x, P)
    cr, rr = quant_prep_reference(x, P)
    torch.cuda.synchronize()
    require(torch.equal(ck, ck2) and torch.equal(rk, rk2),
            f"{what}: prep kernel not identical across runs")
    err = max((ck.int() - cr.int()).abs().max().item() if P else 0,
              (rk.int() - rr.int()).abs().max().item() if len(rk) else 0)
    require(torch.equal(ck, cr) and torch.equal(rk, rr),
            f"{what}: prep kernel differs from the plain version "
            f"(max abs err {err})")
    n_ok = int(ck.sum().item())
    require(P == 0 or 0 < n_ok < P, f"{what}: {n_ok} of {P} pairs "
            "compatible; the chunk must have both")
    ms = cuda_ms(lambda: quant_prep_cuda(x, P), reps=20)
    dev_ms = queued_ms(lambda: quant_prep_cuda(x, P), reps=20)
    plain_ms = cuda_ms(lambda: quant_prep_reference(x, P), reps=3)
    grid = len(arrays["tiles"])
    floor_ms = empty_launches_ms([grid])
    b = prep_bound(x, arrays, (ck, rk))
    log(f"  {what}: {P} pairs ({n_ok} compatible), {len(rk)} hits, "
        f"{len(arrays['ni'])} loci, {grid} tiles: kernel {ms:.4f} ms (on "
        f"the card {dev_ms:.6f} ms; an empty launch of {grid} blocks "
        f"{floor_ms:.6f} ms), plain {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}), array-equal")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "launch_floor_ms": floor_ms, "tiles": grid,
            "max_abs_err": float(err), "pairs": P, "hits": len(rk), **b}


# --------------------------------------------------------------- phase 3c
def random_cmpc_problem(rng, n_exons, p_far=0.15):
    """Random DAG over exon nodes + source/sink + circulation arc, with
    lower bounds on a subset of arcs: the CMPC flow shape of
    tests/test_device_flow.py (p_far: the chance of a non-adjacent arc).
    The port's tests use it too."""
    import numpy as np
    M = n_exons + 2
    src, snk = n_exons, n_exons + 1
    has = np.zeros((M, M), bool)
    cost = np.zeros((M, M), np.int64)
    lower = np.zeros((M, M), np.int64)
    for u in range(n_exons):
        for v in range(u + 1, n_exons):
            if rng.random() < (0.6 if v == u + 1 else p_far):
                has[u, v] = True
                cost[u, v] = rng.integers(0, 50)
                lower[u, v] = 1 if rng.random() < 0.7 else 0
    for v in range(n_exons):
        if not has[:n_exons, v].any():
            has[src, v] = True
        if not has[v, :n_exons].any():
            has[v, snk] = True
    has[snk, src] = True
    return cost, has, lower


def infeasible_problem():
    """A lower bound on an arc into a node with no way back."""
    import numpy as np
    has = np.zeros((3, 3), bool)
    lower = np.zeros((3, 3), np.int64)
    has[0, 1] = True
    lower[0, 1] = 1
    return np.zeros((3, 3), np.int64), has, lower


def pad_mcf_bucket(problems, M, n_inactive=0):
    """Numpy (cost, has_arc, lower, active) of one node bucket, zero-padded
    as assembly/device.py pads it, with `n_inactive` all-zero loci after
    the problems."""
    import numpy as np
    B = len(problems) + n_inactive
    cost = np.zeros((B, M, M), np.int64)
    has = np.zeros((B, M, M), bool)
    low = np.zeros((B, M, M), np.int64)
    for b, (c, h, l) in enumerate(problems):
        m = c.shape[0]
        cost[b, :m, :m] = c
        has[b, :m, :m] = h
        low[b, :m, :m] = l
    act = np.zeros(B, bool)
    act[:len(problems)] = True
    return cost, has, low, act


# the node counts phase 3c times one by one: the main path's range (3-13),
# the edges of the kernel's size classes (32 | 33, 128 | 129) and the top
MCF_SIZES = (3, 8, 13, 32, 33, 64, 128, 256)


def flow_problems(seed, sizes, per_size=1):
    """Seeded CMPC problems (random_cmpc_problem, p_far = min(0.15, 4 / m))
    of the given node counts, `per_size` of each. The port's tests use it
    too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [random_cmpc_problem(rng, m - 2, p_far=min(0.15, 4.0 / m))
            for m in sizes for _ in range(per_size)]


def mcf_bound(x):
    """The MCF bound of packed problems (a host Packed): the inputs read once
    at the problems' own sizes (cost and lower int64, has_arc uint8, offset
    int64, size int32), the flows (int64) and the flags written once; as
    operations, one relaxation of every arc, at the table's integer rate
    (the shortest-path rounds it repeats are not counted)."""
    N, B = x.cost.numel(), len(x.sizes)
    return bound(int(x.has_arc.sum()), 17 * N + 12 * B + 8 * N + B, "int")


def compare_ragged(dev, problems, what, max_aug=None, timed=True):
    """The ragged MCF kernel against its plain version and (uncapped)
    mincostflow.solve_dense on `problems`, packed as batched_mcf packs them:
    array-equal, two runs identical, one launch per size class present.
    Timed: CUDA-event times of the kernel and the plain version, the
    kernel's time on the card (queued_ms), and the bound. Returns {ms,
    device_ms, plain_ms, max_abs_err, infeasible, problems, classes,
    bound_ms, bound_by, ...}."""
    import numpy as np
    import torch
    from strawberry_tpu_torch.assembly.cuda_mcf import (
        CLASSES, MAX_AUG, mcf_ragged_cuda, mcf_ragged_reference,
        pack_problems, unpack_flows)
    from strawberry_tpu_torch.assembly.mincostflow import solve_dense
    aug = MAX_AUG if max_aug is None else max_aug
    x = pack_problems(problems, pin=True)
    xd = x.to(dev)
    before = dict(mcf_ragged_cuda.class_launches)
    k1 = mcf_ragged_cuda(xd, aug)
    k2 = mcf_ragged_cuda(xd, aug)
    ref = mcf_ragged_reference(xd, aug)
    torch.cuda.synchronize()
    classes = {name: n for (name, _top), (n, _m) in zip(CLASSES,
                                                          x.classes)}
    launched = {k: mcf_ragged_cuda.class_launches[k] - before[k]
                for k in before}
    require(launched == {k: 2 * (n > 0) for k, n in classes.items()},
            f"{what}: class launches {launched} for classes {classes}")
    require(torch.equal(k1.buf, k2.buf),
            f"{what}: MCF kernel not identical across runs")
    err = (k1.flow - ref.flow).abs().max().item() if len(k1.flow) else 0
    require(torch.equal(k1.flow, ref.flow)
            and torch.equal(k1.infeasible, ref.infeasible),
            f"{what}: MCF kernel differs from the plain version (max abs "
            f"err {err}, infeasible flags equal: "
            f"{torch.equal(k1.infeasible, ref.infeasible)})")
    flows = unpack_flows(x, k1.cpu())
    if max_aug is None:
        for i, p in enumerate(problems):
            host = solve_dense(*[a.copy() for a in p])
            require((host is None) == (flows[i] is None) and (
                host is None or np.array_equal(host, flows[i])),
                f"{what}: problem {i} ({p[0].shape[0]} nodes) differs from "
                "solve_dense")
    n_inf = sum(f is None for f in flows)
    if not timed:
        return {"max_abs_err": float(err), "infeasible": n_inf}
    out = {"ms": cuda_ms(lambda: mcf_ragged_cuda(xd, aug), reps=20),
           "plain_ms": cuda_ms(lambda: mcf_ragged_reference(xd, aug), 1),
           "device_ms": queued_ms(lambda: mcf_ragged_cuda(xd, aug), 5)}
    b = mcf_bound(x)
    out.update(max_abs_err=float(err), infeasible=n_inf,
               problems=len(problems), classes=classes, **b)
    log(f"  {what}: {len(problems)} problems, sizes {int(x.sizes[0])}-"
        f"{int(x.sizes[-1])}, classes {classes}, {n_inf} infeasible; kernel "
        f"{out['ms']:.4f} ms (on the card {out['device_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.4f} ms, bound {b['bound_ms']:.6f} ms "
        f"({b['bound_by']}), array-equal")
    return out


def check_mcf(dev):
    """Phase 3c: seeded random CMPC problems of every node count in
    MCF_SIZES, four of each, with the infeasible problem, in one call (every
    size class: a launch each), against the plain version and solve_dense;
    then each size alone (one launch), timed; then the augmentation cap
    (max_aug 0, 1, 3) against the plain version. Returns the mixed call's
    numbers with `per_size`."""
    problems = flow_problems(2000, MCF_SIZES, per_size=4)
    problems.append(infeasible_problem())
    out = compare_ragged(dev, problems, "MCF seeded sizes, one call")
    require(out["infeasible"] >= 1,
            "the infeasible problem was not found infeasible")
    require(all(out["classes"].values()),
            f"the seeded sizes left a size class empty: {out['classes']}")
    out["per_size"] = {}
    for m in MCF_SIZES:
        one = [p for p in problems if p[0].shape[0] == m]
        r = compare_ragged(dev, one, f"MCF seeded, {m} nodes")
        out["per_size"][m] = {k: r[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "problems")}
    for max_aug in (0, 1, 3):
        compare_ragged(dev, problems[:12] + problems[-1:],
                       f"MCF max_aug={max_aug}", max_aug=max_aug,
                       timed=False)
    return out


# --------------------------------------------------------------- phase 3d
def compare_reduce(dev, rows_np, what):
    """The reduction kernel against its plain version and against the one
    PyTorch call that computes the same function, torch.sum(rows, dim=0),
    on one (N, H) array: bit-identical to both and across two runs. The
    kernel and torch.sum are timed by CUDA events in turns (torch.sum, the
    kernel, the kernel, torch.sum) and on the card by torch.profiler.
    Returns {ms, plain_ms, library_ms, turns_ms, device_ms, max_abs_err,
    bound_ms, bound_by}."""
    import torch
    from strawberry_tpu_torch.parallel.cuda_reduce import (
        shard_colsum_cuda, shard_colsum_reference)
    rows = torch.from_numpy(rows_np).to(dev)
    out, out2 = shard_colsum_cuda(rows), shard_colsum_cuda(rows)
    plain = shard_colsum_reference(rows)
    lib = torch.sum(rows, dim=0)
    torch.cuda.synchronize()
    err = max((out - plain).abs().max().item(),
              (out - lib).abs().max().item())
    require(torch.equal(out, out2),
            f"{what}: reduction kernel not bit-identical across runs")
    require(torch.equal(out, plain),
            f"{what}: reduction kernel differs from the plain version "
            f"(max abs err {err})")
    require(torch.equal(out, lib),
            f"{what}: reduction kernel differs from torch.sum(dim=0) (max "
            f"abs err {err})")
    # in turns: the library call, the kernel, the kernel, the library call
    t = [cuda_ms(lambda: torch.sum(rows, dim=0), reps=200),
         cuda_ms(lambda: shard_colsum_cuda(rows), reps=200),
         cuda_ms(lambda: shard_colsum_cuda(rows), reps=200),
         cuda_ms(lambda: torch.sum(rows, dim=0), reps=200)]
    ms, library_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    plain_ms = cuda_ms(lambda: shard_colsum_reference(rows), reps=20)
    dev_ms = reduce_device_ms(rows)
    dev_ms.update(queued_kernel=queued_ms(lambda: shard_colsum_cuda(rows), 50),
                  queued_torch_sum=queued_ms(lambda: torch.sum(rows, dim=0),
                                             50))
    N, H = rows_np.shape
    # every row read once and the sums written once; N - 1 additions a column
    b = bound((N - 1) * H, (N + 1) * H * 8, "f64")
    log(f"  {what} {N}x{H}: kernel {ms:.5f} ms, torch.sum(dim=0) "
        f"{library_ms:.5f} ms (in turns: {', '.join(f'{x:.5f}' for x in t)})"
        f", plain {plain_ms:.5f} ms, bound {b['bound_ms']:.7f} ms "
        f"({b['bound_by']}); on the card (torch.profiler) kernel "
        f"{measured(dev_ms['kernel'], '.6f')}, torch.sum "
        f"{measured(dev_ms['torch.sum'], '.6f')} a call, queued back to back "
        f"{dev_ms['queued_kernel']:.6f} / {dev_ms['queued_torch_sum']:.6f} "
        "ms; bit-identical to both")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "turns_ms": t, "device_ms": dev_ms,
            "max_abs_err": float(err), **b}


def reduce_device_ms(rows, reps=50):
    """The time on the card of a call of the reduction kernel and of
    torch.sum(rows, dim=0) (its reduce kernel), from torch.profiler."""
    import torch
    from strawberry_tpu_torch.parallel.cuda_reduce import shard_colsum_cuda
    return {"kernel": device_ms(lambda: shard_colsum_cuda(rows), reps,
                                r"\bshard_colsum_kernel\b"),
            "torch.sum": device_ms(lambda: torch.sum(rows, dim=0), reps,
                                   r"reduce_kernel")}


def wrapper_path_us(rows, reps=2000):
    """Host microseconds a call of each step on the reduction's path to its
    launch, and of the whole wrapper and of torch.sum(rows, dim=0), each
    over `reps` calls by the host clock (the device finishes each launch
    long before the host makes the next)."""
    import torch
    from strawberry_tpu_torch.parallel import cuda_reduce as cr
    from strawberry_tpu_torch.utils.kernels import stream_handle
    dev, (N, H) = rows.device, rows.shape
    out = torch.empty((H,), dtype=rows.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {
        "checks": lambda: cr._check(rows),
        "torch.empty": lambda: torch.empty((H,), dtype=rows.dtype,
                                           device=dev),
        "rows.new_empty": lambda: rows.new_empty((H,)),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_handle": lambda: stream_handle(dev.index),
        "ctypes call and launch": lambda: cr._launch(
            rows.data_ptr(), N, H, out.data_ptr(), dev.index, stream),
        "wrapper": lambda: cr.shard_colsum_cuda(rows),
        "torch.sum": lambda: torch.sum(rows, dim=0)}
    res = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / reps * 1e6
    log("  the reduction's path, host us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res.items()))
    return res


def check_reduce(dev):
    """Phase 3d: seeded rows of counts up to 2^40 (a fragment-length
    histogram row per shard) at one, two and eight shards and at the
    allreduce_scalar shape (8, 1); inputs the wrapper must refuse. Returns
    the parts summed, with `library_ms` summed too."""
    import numpy as np
    import torch
    from strawberry_tpu_torch.parallel.cuda_reduce import shard_colsum_cuda
    parts = {}
    for seed, (N, H) in enumerate(((1, 600), (2, 1201), (8, 4097), (8, 1))):
        rows = np.random.default_rng(3000 + seed).integers(
            0, 2**40, size=(N, H)).astype(np.float64)
        parts[f"{N}x{H}"] = compare_reduce(dev, rows, "seeded counts")
    good = torch.zeros((4, 64), dtype=torch.float64, device=dev)
    before = shard_colsum_cuda.launches
    for bad in (good.float(), good[:, ::2], good[0], good.cpu()):
        try:
            shard_colsum_cuda(bad)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("the reduction wrapper took a "
                           f"{tuple(bad.shape)} {bad.dtype} {bad.device} "
                           "input it must refuse")
    require(shard_colsum_cuda.launches == before,
            "a refused input counted as a launch")
    out = summed(parts)
    out["library_ms"] = sum(r["library_ms"] for r in parts.values())
    out["wrapper_path_us"] = wrapper_path_us(torch.from_numpy(
        np.random.default_rng(3002).integers(0, 2**40, size=(8, 4097)).astype(
            np.float64)).to(dev))
    return out


# --------------------------------------------------------------- phase 3e
def check_sharded_em(dev):
    """Phase 3e: phase 3's seeded tier-1 and tier-2 buckets through
    sharded_em_bucket over a mesh of 4 (mdl 1) and of 8 (mdl 2, 4 slots),
    every slot on this GPU with its own stream. The sharded runs are driven
    first, with their launch count set to 0 before and read after; then
    theta and failed are held bit for bit against one kernel launch over
    the whole bucket, in f64 and f32, and the f64 result within 1e-9 of
    the plain version. Returns {launches, ms (sharded), whole_ms, plain_ms,
    max_abs_err, bound_ms, bound_by, parts}."""
    import numpy as np
    import torch
    from strawberry_tpu_torch.parallel.mesh import (make_mesh,
                                                    sharded_em_bucket)
    from strawberry_tpu_torch.quant.cuda_em import (bucket_to_torch,
                                                    em_bucket_cuda,
                                                    em_bucket_reference)
    from strawberry_tpu_torch.quant.device import _TIERS
    meshes = {"4x1": make_mesh(4, mdl=1), "4x2": make_mesh(8)}
    require(all(m.shape["dp"] == 4 for m in meshes.values())
            and meshes["4x2"].shape["mdl"] == 2, f"meshes {meshes}")
    runs = {k: sharded_em_bucket(m) for k, m in meshes.items()}
    buckets = {}
    for tier in (1, 2):
        R, C, B = _TIERS[tier]
        bucket = random_bucket(np.random.default_rng(1000 + tier), B, R, C)
        buckets[tier] = (bucket, {
            dt: bucket_to_torch(*bucket, dev, torch_dt) for dt, torch_dt in
            (("f64", torch.float64), ("f32", torch.float32))})

    sharded_em_bucket.launches = 0
    results = {(tier, k, dt): run(*args[dt])
               for tier, (_b, args) in buckets.items()
               for k, run in runs.items() for dt in ("f64", "f32")}
    torch.cuda.synchronize()
    launches = sharded_em_bucket.launches
    require(launches == 4 * len(results),
            f"sharded_em_bucket: {launches} launches for {len(results)} "
            "runs over 4 slots")

    parts = {}
    f32_same = True
    for tier, (bucket, args) in buckets.items():
        whole = {dt: em_bucket_cuda(*args[dt]) for dt in args}
        plain, plain_failed, iters = em_bucket_reference(*args["f64"],
                                                         iterations=True)
        torch.cuda.synchronize()
        for k in runs:
            theta, failed = results[(tier, k, "f64")]
            require(torch.equal(theta, whole["f64"][0])
                    and torch.equal(failed, whole["f64"][1]),
                    f"tier {tier}, mesh {k}: sharded f64 result is not the "
                    "whole bucket's bit for bit")
            require(torch.allclose(theta, plain, rtol=1e-9, atol=1e-9)
                    and torch.equal(failed, plain_failed),
                    f"tier {tier}, mesh {k}: sharded f64 result off the "
                    f"plain version by {(theta - plain).abs().max().item()}")
            t32, f32 = results[(tier, k, "f32")]
            f32_same &= bool(torch.equal(t32, whole["f32"][0])
                             and torch.equal(f32, whole["f32"][1]))
        err = (results[(tier, "4x1", "f64")][0] - plain).abs().max().item()
        a64 = args["f64"]
        ms = cuda_ms(lambda: runs["4x1"](*a64), reps=20)
        whole_ms = cuda_ms(lambda: em_bucket_cuda(*a64), reps=20)
        plain_ms = cuda_ms(lambda: em_bucket_reference(*a64), reps=3)
        b = em_bound(bucket, iters.cpu().numpy(), "f64")
        shape = "x".join(map(str, bucket[0].shape))
        parts[shape] = {"ms": ms, "whole_ms": whole_ms, "plain_ms": plain_ms,
                        "max_abs_err": err, **b}
        log(f"  tier {tier} {shape} f64 over 4 slots: sharded {ms:.4f} ms, "
            f"one launch {whole_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}); bit-identical to "
            f"one launch on both meshes, max abs err vs plain {err:.3e}")
    log(f"  f32 sharded results bit-identical to one launch: {f32_same}")
    out = summed(parts)
    out.update(launches=launches, f32_bit_identical=f32_same,
               whole_ms=sum(r["whole_ms"] for r in parts.values()))
    return out


# ---------------------------------------------------------------- phase 4
def shape_paths(shape, n_frags):
    """The directory, BAM and GTF of the set of `shape` (tools/common.py
    SHAPES: realistic is bench.py's dataset_realistic, easy its
    dataset_10m) at `n_frags` fragments, and the shape's strand flag."""
    from strawberry_tpu_torch.tools import common
    d = common.set_dir(shape, n_frags)
    return (d, *common.set_paths(d), common.SHAPES[shape][1])


def realistic_set(n_frags):
    from strawberry_tpu_torch.tools.common import generate
    d, bam, gtf, _strand = shape_paths("realistic", n_frags)
    if not (os.path.exists(bam) and os.path.exists(gtf)):
        t0 = time.perf_counter()
        generate(d, "realistic", n_frags)
        log(f"  generated {n_frags} fragments in "
            f"{time.perf_counter() - t0:.1f} s")
    return bam, gtf


def tpms(path):
    from strawberry_tpu_torch.tools.common import tpms
    return tpms(path)


def body(path):
    with open(path) as f:
        return "".join(line for line in f if not line.startswith("#"))


def tpm_p99(ref_gtf, gtf, what):
    """The --fast-em rule against the default's GTF (tools/common.py
    tpm_check): the same transcript set, finite TPMs, TPM p99 relative
    error <= 1e-3. Returns the p99."""
    from strawberry_tpu_torch.tools.common import TPM_P99_MAX, tpm_check
    c = tpm_check(ref_gtf, gtf)
    require(c["same_transcripts"],
            f"{what}: transcript set differs from the default's")
    require(c["finite"], f"{what}: TPM not finite")
    require(c["ok"], f"{what}: TPM p99 rel err {c['tpm_p99_rel_err']} > "
            f"{TPM_P99_MAX}")
    return c["tpm_p99_rel_err"]


KERNELS = ("em_bucket", "quant_prep", "mcf_bucket", "shard_reduce")
# the __global__ functions of each kernel source, as the profiler names them
KERNEL_FUNCTIONS = {"em_bucket": ("em_warp_kernel", "em_rows_kernel",
                                  "em_strip_kernel"),
                    "quant_prep": ("prep_tile_kernel",),
                    "mcf_bucket": ("mcf_warp_kernel", "mcf_block_kernel"),
                    "shard_reduce": ("shard_colsum_kernel",)}


def launch_counters():
    """{kernel name: its wrapper} for every kernel the main paths run
    (sharded_em_bucket counts the EM launches it makes itself, over its
    mesh; they are counted under em_bucket too)."""
    from strawberry_tpu_torch.assembly.cuda_mcf import mcf_ragged_cuda
    from strawberry_tpu_torch.parallel.cuda_reduce import shard_colsum_cuda
    from strawberry_tpu_torch.parallel.mesh import sharded_em_bucket
    from strawberry_tpu_torch.quant.cuda_em import em_bucket_cuda
    from strawberry_tpu_torch.quant.cuda_prep import quant_prep_cuda
    return {"em_bucket": em_bucket_cuda, "quant_prep": quant_prep_cuda,
            "mcf_bucket": mcf_ragged_cuda, "shard_colsum": shard_colsum_cuda,
            "sharded_em_bucket": sharded_em_bucket}


def reset_counts(counters):
    """Set every launch count of the wrappers to 0, those of each
    __global__ function too."""
    for w in counters.values():
        w.launches = 0
        for fn in getattr(w, "function_launches", {}):
            w.function_launches[fn] = 0


def function_counts(counters):
    """{__global__ function: the launches the wrappers counted}."""
    return {fn: n for w in counters.values()
            for fn, n in getattr(w, "function_launches", {}).items()}


def run_cli(name, argv, env, dispatchers=1):
    """One CLI run in this process, with every launch count set to 0 just
    before it and read just after it. Returns the GTF path, the wall, the
    EM dispatch (device and host counts summed over the run's
    `dispatchers` EM dispatchers, one a shard under --shards; the first
    bucket of each tier, a full one where the tier filled one) with its
    tier-fitting count (in all and by tier) and expected launches, the
    Sample (None under --shards, which has one a shard), and the run's
    launch counts."""
    from types import SimpleNamespace
    from strawberry_tpu_torch import cli
    from strawberry_tpu_torch.quant import device as qdev

    class Recording(qdev.EmDispatcher):
        made = []

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.tier_of = []
            self.order = []    # the problems' indices, in add() order
            self.buckets = {}  # tier -> its first batch's arrays
            Recording.made.append(self)

        def _launch(self, tier):
            # a tier's first launch is a full bucket where the tier ever
            # fills one (the partial ones are flushed at finish())
            if tier not in self.buckets and self._fills[tier]:
                self.buckets[tier] = qdev.pad_bucket(tier, self._fills[tier])
            super()._launch(tier)

        def add(self, idx, p):
            u, F = p.filtered()
            if u.size:
                fit = [t for t, (rb, cb, _bb) in enumerate(qdev._TIERS)
                       if F.shape[0] <= rb and p.weights.shape[1] <= cb]
                self.tier_of.append(fit[0] if fit else None)
                self.order.append(idx)
            super().add(idx, p)

    out = os.path.join(WORK, "out", name + ".gtf")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for ext in (".gtf", ".log"):
        if os.path.exists(out[:-4] + ext):
            os.remove(out[:-4] + ext)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    orig, orig_run = qdev.EmDispatcher, cli.run_driver
    samples = []
    qdev.EmDispatcher = Recording
    cli.run_driver = lambda *a, **k: samples.append(orig_run(*a, **k)) \
        or samples[-1]
    counters = launch_counters()
    try:
        import torch
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", out, "-T", out[:-4] + ".log"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counters.items()}
    finally:
        qdev.EmDispatcher, cli.run_driver = orig, orig_run
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(rc == 0, f"{name}: CLI exit code {rc}")
    require(len(Recording.made) == dispatchers,
            f"{name}: {len(Recording.made)} EM dispatchers, expected "
            f"{dispatchers}")
    n_fit = [0] * len(qdev._TIERS)
    want = 0
    d = SimpleNamespace(n_device=0, n_host=0, buckets={})
    for made in Recording.made:
        fit = [0] * len(qdev._TIERS)
        # --fast-em keeps its first device_after problems on the host;
        # a dispatcher on the host route sends nothing to the card
        skip = made.device_after if made.fast_em else 0
        for i, t in enumerate(made.tier_of):
            if t is not None and not made.force_host and i >= skip:
                fit[t] += 1
        # every dispatcher flushes its own partial buckets
        want += sum(math.ceil(n / qdev._TIERS[t][2])
                    for t, n in enumerate(fit))
        n_fit = [a + b for a, b in zip(n_fit, fit)]
        d.n_device += made.n_device
        d.n_host += made.n_host
        for t, b in made.buckets.items():
            d.buckets.setdefault(t, b)
    sample = samples[0] if samples else None
    log(f"  {name}: wall {wall:.3f} s, EM device {d.n_device} / host "
        f"{d.n_host}, tier-fitting {sum(n_fit)} {n_fit}, flow "
        f"{getattr(sample, 'flow_stats', {})}, prep "
        f"{getattr(sample, 'prep_stats', {})}, launches {launches}")
    return SimpleNamespace(out=out, wall=wall, d=d, fit=sum(n_fit),
                           tiers=n_fit, want=want, sample=sample,
                           launches=launches,
                           dispatchers=list(Recording.made))


class CountingMcfCopies:
    """Counts the MCF route's copies while it is entered: each Packed.to
    (host to device) and each Flows.cpu (device to host), with its bytes."""

    def __enter__(self):
        from strawberry_tpu_torch.assembly import cuda_mcf
        self.counts = dict.fromkeys(("h2d_copies", "h2d_bytes",
                                     "d2h_copies", "d2h_bytes"), 0)
        self.saved = to, cpu = cuda_mcf.Packed.to, cuda_mcf.Flows.cpu
        counts = self.counts

        def counting_to(x, device):
            counts["h2d_copies"] += 1
            counts["h2d_bytes"] += x.buf.numel()
            return to(x, device)

        def counting_cpu(flows):
            counts["d2h_copies"] += 1
            counts["d2h_bytes"] += flows.buf.numel()
            return cpu(flows)
        cuda_mcf.Packed.to, cuda_mcf.Flows.cpu = counting_to, counting_cpu
        return self.counts

    def __exit__(self, *exc):
        from strawberry_tpu_torch.assembly import cuda_mcf
        cuda_mcf.Packed.to, cuda_mcf.Flows.cpu = self.saved


def profiled_run(name, argv, env=None, dispatchers=1):
    """The run again under torch.profiler (device activity only) and the
    pipeline's phase timer: device busy time, each kernel's share of it,
    the phase report and each phase's seconds, and the MCF route's copies
    (count and bytes each way)."""
    from torch.profiler import ProfilerActivity, profile
    from strawberry_tpu_torch.utils import profiling
    profiling.GLOBAL.phases.clear()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                CountingMcfCopies() as copies:
            wall = run_cli(name, argv, env or {}, dispatchers).wall
            phases = profiling.GLOBAL.report()  # before the trace is read
            phase_s = {k: v.seconds
                       for k, v in profiling.GLOBAL.phases.items()}
    finally:
        profiling.GLOBAL.enabled = False
    log(phases)
    if copies["h2d_copies"]:
        log(f"  {name}: MCF copies {copies}")
    busy = 0.0
    kern = dict.fromkeys(KERNELS, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = e.self_cuda_time_total
        busy += us / 1e3
        for k, fns in KERNEL_FUNCTIONS.items():
            # whole names: the prep's rows_kernel is not em_rows_kernel
            if any(re.search(rf"\b{f}\b", e.key) for f in fns):
                kern[k] += us / 1e3
    out = {"wall_s": wall, "phases_s": phase_s, "mcf_copies": copies}
    if busy == 0.0:
        log("  device busy time: not measured (the profiler saw no device "
            "activity)")
        return {**out, "device_busy_ms": None}
    log(f"  {name}: wall {wall:.3f} s, device busy {busy:.3f} ms "
        f"(kernels {kern} ms), idle share {1 - busy / (wall * 1e3):.4f}")
    return {**out, "device_busy_ms": busy, "kernel_ms": kern,
            "idle_share": 1 - busy / (wall * 1e3)}


# --fast-em on the f32 route from the first problem: by default it keeps
# every problem on the host (routing.FASTEM_AFTER, phase 6)
F32 = {"STRAWB_FASTEM_AFTER": "0"}


def require_no_launches(run, what):
    require(not any(run.launches.values()),
            f"{what}: kernels launched in a run that routes nothing to the "
            f"card: {run.launches}")


def prep_runs(base, host, modes=("all", "budget"), prefix=""):
    """`-g -r` under STRAWB_DEVICE_PREP=<mode> for each of `modes` (runs
    named with `prefix`): the default's GTF body byte for byte, device
    loci and prep launches in each. Returns ({mode: Run}, every chunk of
    the "all" run as (arrays, P), the isoform tables)."""
    import copy
    from strawberry_tpu_torch.quant import device_prep
    chunks, tables = [], []
    launch = device_prep.launch

    def recording_launch(state, arrays, P):
        if recording:
            chunks.append((copy.deepcopy(arrays), P))
            if not tables:
                tables.extend(state.tables[k].cpu().numpy()
                              for k in device_prep._TABLES)
        return launch(state, arrays, P)

    runs = {}
    device_prep.launch = recording_launch
    try:
        for mode in modes:
            recording = mode == "all"
            runs[mode] = r = run_cli(f"{prefix}g_r_prep_{mode}", base,
                                     {"STRAWB_DEVICE_PREP": mode})
            stats = r.sample.prep_stats
            require(body(r.out) == body(host.out),
                    f"STRAWB_DEVICE_PREP={mode}: GTF body differs from the "
                    "default's")
            require(stats["device_loci"] > 0 and r.launches["quant_prep"] > 0,
                    f"STRAWB_DEVICE_PREP={mode}: {stats}, "
                    f"{r.launches['quant_prep']} prep launches")
            require(r.launches["mcf_bucket"] == 0
                    and r.launches["em_bucket"] == 0,
                    f"STRAWB_DEVICE_PREP={mode}: other kernels launched: "
                    f"{r.launches}")
            log(f"  STRAWB_DEVICE_PREP={mode}: GTF body byte-identical to "
                f"the default's")
    finally:
        device_prep.launch = launch
    require(len(chunks) == runs["all"].launches["quant_prep"],
            f"STRAWB_DEVICE_PREP=all: {len(chunks)} chunks recorded, "
            f"{runs['all'].launches['quant_prep']} launches")
    return runs, chunks, tables


def chunk_shapes(chunks):
    """The shapes of a run's prep chunks: loci, pairs and hits a chunk, the
    pairs of its largest locus, and the isoforms, exons a locus's isoform
    and features a hit at most (min / median / max over the chunks)."""
    import numpy as np
    rows = []
    for arrays, P in chunks:
        nh = np.diff(arrays["hit_off"])
        rows.append((len(arrays["ni"]), P, len(arrays["goff"]),
                     int((nh * arrays["ni"]).max()),
                     int(arrays["ni"].max()), int(arrays["nf"].max())))
    a = np.array(rows)
    return {k: [int(a[:, i].min()), float(np.median(a[:, i])),
                int(a[:, i].max())]
            for i, k in enumerate(("loci", "pairs", "hits",
                                   "largest_locus_pairs", "max_isoforms",
                                   "max_features"))}


def main_path_prep(dev, chunks, tables, what, min_loci=100):
    """The prep kernel on the chunks a STRAWB_DEVICE_PREP=all run made:
    the first of at least `min_loci` device loci (100: a full 128-locus
    flush less its host-routed loci; build_batch_device halves a flush of
    deep loci until its hits fit the prep tiers) timed with its bound,
    and every chunk array-equal to the plain version."""
    chunk = next((c for c in chunks if len(c[0]["ni"]) >= min_loci), None)
    require(chunk, f"{what}: STRAWB_DEVICE_PREP=all made no chunk of "
            f"{min_loci} loci")
    out = compare_prep(dev, chunk[0], tables, chunk[1], what)
    out["all_chunks"] = check_prep_chunks(dev, chunks, tables)
    return out


def check_prep_chunks(dev, chunks, tables):
    """The prep kernel against its plain version on every chunk of a run,
    array-equal (the wrapper's launches here are not the run's)."""
    import torch
    from strawberry_tpu_torch.quant.cuda_prep import (quant_prep_cuda,
                                                      quant_prep_reference)
    for i, (arrays, P) in enumerate(chunks):
        x = prep_inputs(arrays, tables, dev)
        ck, rk = quant_prep_cuda(x, P)
        cr, rr = quant_prep_reference(x, P)
        require(torch.equal(ck, cr) and torch.equal(rk, rr),
                f"prep chunk {i} of the STRAWB_DEVICE_PREP=all run "
                f"({P} pairs, {len(rk)} hits): kernel differs from the "
                "plain version")
    shapes = chunk_shapes(chunks)
    log(f"  every one of the {len(chunks)} prep chunks of the "
        f"STRAWB_DEVICE_PREP=all run array-equal to the plain version; "
        f"chunk shapes (min / median / max) {shapes}")
    return {"chunks": len(chunks), "shapes": shapes}


def mcf_runs(gtf, bam, g_host, prefix="", strand="--fr"):
    """`-g` under STRAWB_DEVICE_MCF=1, against the same run with
    STRAWB_FORCE_HOST=1 added (every flow on mincostflow.solve_dense): the
    same GTF body, device problems and MCF launches. Returns ({name: Run}, the problems of each
    call the MCF run packed, as [(cost, has_arc, lower)] lists); the runs'
    names start with `prefix`, and their body is compared with the default
    `g_host` run's where one is given."""
    import numpy as np
    from strawberry_tpu_torch.assembly import device as adev
    calls = []
    pack = adev.pack_problems

    def recording_pack(problems, pin=False):
        calls.append([tuple(np.array(a) for a in p) for p in problems])
        return pack(problems, pin=pin)

    argv = ["-g", gtf, strand, bam]
    adev.pack_problems = recording_pack
    try:
        mcf = run_cli(prefix + "g_mcf", argv, {"STRAWB_DEVICE_MCF": "1"})
    finally:
        adev.pack_problems = pack
    host = run_cli(prefix + "g_mcf_force_host", argv,
                   {"STRAWB_DEVICE_MCF": "1", "STRAWB_FORCE_HOST": "1"})
    fs = mcf.sample.flow_stats
    require(fs.get("device", 0) > 0 and fs.get("host", 1) == 0
            and mcf.launches["mcf_bucket"] > 0,
            f"STRAWB_DEVICE_MCF=1: {fs}, {mcf.launches['mcf_bucket']} MCF "
            "launches; every problem must go through the kernel")
    require(sum(map(len, calls)) == fs["device"],
            f"recorded {sum(map(len, calls))} problems of {fs['device']}")
    require(host.sample.flow_stats.get("device", 1) == 0,
            "STRAWB_FORCE_HOST=1 sent flow problems to the card")
    require_no_launches(host, "STRAWB_DEVICE_MCF=1 STRAWB_FORCE_HOST=1")
    require(body(mcf.out) == body(host.out),
            "STRAWB_DEVICE_MCF=1: GTF body differs from the host solver's")
    same = g_host and body(mcf.out) == body(g_host.out)
    sizes = np.array([p[0].shape[0] for c in calls for p in c])
    log(f"  STRAWB_DEVICE_MCF=1: GTF body byte-identical to the host "
        f"solver's; to the default (lemon NetworkSimplex) run's: {same}; "
        f"{len(sizes)} problems in {len(calls)} calls (largest call "
        f"{max(map(len, calls))}), nodes median {np.median(sizes):.0f}, p99 "
        f"{np.percentile(sizes, 99):.0f}, max {sizes.max()}")
    return {"g_mcf": mcf, "g_mcf_force_host": host,
            "mcf_same_as_default": same}, calls


def main_path_mcf(dev, calls):
    """The MCF kernel on the problems the main path made: all of them in
    one call and the largest call alone, each against the plain version
    and solve_dense (array-equal), timed."""
    every = [p for c in calls for p in c]
    return {"all": compare_ragged(
        dev, every, f"main-path MCF, all {len(every)} problems in one call"),
        "largest_call": compare_ragged(dev, max(calls, key=len),
                                       "main-path MCF, the largest call")}


# Runs cli.main(argv) once in a fresh process, with jax and the JAX package
# blocked from import, and prints as JSON its exit code, its wall, every
# kernel's launch count (and each __global__ function's), the EM
# dispatchers' device and host counts, whether CUDA had been initialized at
# each fork the process made and at its end, and the seconds spent
# starting and stopping a STRAWB_TRACE_DIR trace (of the stop, exporting).
# With SMOKE_SAVE_ROWS=<path> it saves the rows it hands to the reduction.
_CLI_RUNNER = """
import json, os, sys, time
sys.path.insert(0, os.getcwd())
sys.modules["jax"] = None
sys.modules["strawberry_tpu"] = None
import torch
forks = []
os.register_at_fork(before=lambda: forks.append(torch.cuda.is_initialized()))
import chip_smoke
from strawberry_tpu_torch import cli
from strawberry_tpu_torch.parallel import cuda_reduce
from strawberry_tpu_torch.quant import device as qdev
split = {"device": 0, "host": 0}
finish = qdev.EmDispatcher.finish
def counting_finish(self):
    split["device"] += self.n_device
    split["host"] += self.n_host
    return finish(self)
qdev.EmDispatcher.finish = counting_finish
save = os.environ.get("SMOKE_SAVE_ROWS")
if save:
    colsum = cuda_reduce.shard_colsum
    def saving_colsum(rows):
        import numpy as np
        np.save(save, rows.cpu().numpy())
        return colsum(rows)
    cuda_reduce.shard_colsum = saving_colsum
from strawberry_tpu_torch.utils import profiling
trace_s = {"start": 0.0, "stop": 0.0, "export": 0.0}
def timed(key, fn):
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            trace_s[key] += time.perf_counter() - t
    return run
profiling.GLOBAL.start_trace = timed("start", profiling.GLOBAL.start_trace)
profiling.GLOBAL.stop_trace = timed("stop", profiling.GLOBAL.stop_trace)
torch.profiler.profile.export_chrome_trace = timed(
    "export", torch.profiler.profile.export_chrome_trace)
counters = chip_smoke.launch_counters()
t0 = time.perf_counter()
rc = cli.main(json.loads(sys.argv[1]))
if torch.cuda.is_initialized():
    torch.cuda.synchronize()
print(json.dumps({"rc": rc, "wall_s": time.perf_counter() - t0,
                  "launches": {k: w.launches for k, w in counters.items()},
                  "function_launches": chip_smoke.function_counts(counters),
                  "em_split": split, "cuda_at_fork": forks,
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "trace_s": trace_s}))
"""
PROCESS_TIMEOUT_S = 600


def cli_processes(name, per_process):
    """One fresh CLI process per (argv, env) of `per_process`, all started
    together; process k writes <name><k>.gtf and .log. Waits for all (a
    process that outlives PROCESS_TIMEOUT_S fails the smoke), kills whatever
    is left, and returns (the GTF paths, each process's report, the wall
    from the first start to the last exit)."""
    outs, procs = [], []
    t0 = time.perf_counter()
    try:
        for k, (argv, env) in enumerate(per_process):
            out = os.path.join(WORK, "out", f"{name}{k}.gtf")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            for ext in (".gtf", ".log"):
                if os.path.exists(out[:-4] + ext):
                    os.remove(out[:-4] + ext)
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CLI_RUNNER, json.dumps(
                    argv + ["-o", out, "-T", out[:-4] + ".log"])],
                cwd=ROOT, env=dict(os.environ, **env),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        reports = []
        for k, proc in enumerate(procs):
            stdout, err = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            require(proc.returncode == 0,
                    f"{name}{k}: exit code {proc.returncode}\n{err[-4000:]}")
            reports.append(json.loads(stdout.strip().splitlines()[-1]))
            require(reports[-1]["rc"] == 0, f"{name}{k}: CLI exit code "
                    f"{reports[-1]['rc']}\n{err[-4000:]}")
        wall = time.perf_counter() - t0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, r in enumerate(reports):
        log(f"  {name}{k}: wall {r['wall_s']:.3f} s in the process, EM "
            f"device {r['em_split']['device']} / host "
            f"{r['em_split']['host']}, launches {r['launches']}")
    return outs, reports, wall


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_runs(base, host, fast, ref):
    """The parallel layer on the realistic set, each against the default
    `-g -r` run (`host`): `--shards 4` with STRAWB_DEVICE_EM=1 (the body
    byte for byte) and with --fast-em (the fast-em bars), both with EM and
    reduction launches; two CLI processes joined over gloo on 127.0.0.1,
    both on this GPU, with STRAWB_DEVICE_EM=1 (rank 0's body byte for byte,
    each rank's ranged-ingest record, EM and reduction launches in each);
    `-p 2` (the body byte for byte, no kernel launched, no CUDA context in
    the parent at either fork). Returns the walls, launches and splits, and
    the rows each device route handed to the reduction."""
    import numpy as np
    from strawberry_tpu_torch.parallel import cuda_reduce
    want_body = body(host.out)
    rows_seen = {}
    colsum = cuda_reduce.shard_colsum

    def recording_colsum(rows):
        rows_seen.setdefault("x".join(map(str, rows.shape)),
                             rows.cpu().numpy())
        return colsum(rows)

    dev_env = {"STRAWB_DEVICE_EM": "1"}
    cuda_reduce.shard_colsum = recording_colsum
    try:
        sh = run_cli("g_r_shards4_device_em", base + ["--shards", "4"],
                     dev_env, dispatchers=4)
    finally:
        cuda_reduce.shard_colsum = colsum
    require(body(sh.out) == want_body,
            "--shards 4 STRAWB_DEVICE_EM=1: GTF body differs from the "
            "default's")
    require(sh.d.n_device == sh.fit and sh.launches["em_bucket"] == sh.want
            > 0, f"--shards 4 STRAWB_DEVICE_EM=1: {sh.d.n_device} EMs on "
            f"the card of {sh.fit}, {sh.launches['em_bucket']} launches of "
            f"{sh.want}")
    # the histogram rows and the per-shard mapped-read counts
    require(sh.launches["shard_colsum"] == 2 and len(rows_seen) == 2,
            f"--shards 4: {sh.launches['shard_colsum']} reduction launches, "
            f"rows {list(rows_seen)}")
    log("  --shards 4 STRAWB_DEVICE_EM=1: GTF body byte-identical to the "
        "default's")

    shf = run_cli("g_r_shards4_fast_em", base + ["--fast-em", "--shards",
                                                 "4"], F32, dispatchers=4)
    require(shf.d.n_device == shf.fit and shf.launches["em_bucket"]
            == shf.want > 0 and shf.launches["shard_colsum"] == 2,
            f"--shards 4 --fast-em: {shf.d.n_device} of {shf.fit} on the "
            f"card, launches {shf.launches} (EM expected {shf.want})")
    got = tpms(shf.out)
    require(set(got) == set(ref), "--shards 4 --fast-em transcript set "
            "differs from the default's")
    a = np.array([ref[t] for t in sorted(ref)])
    b = np.array([got[t] for t in sorted(ref)])
    require(np.isfinite(b).all(), "--shards 4 --fast-em TPM not finite")
    p99 = float(np.percentile(np.abs(a - b) / np.maximum(np.abs(a), 1e-12),
                              99))
    require(p99 <= 1e-3, f"--shards 4 --fast-em TPM p99 rel err {p99} > 1e-3")
    same_fast = body(shf.out) == body(fast.out)
    log(f"  --shards 4 --fast-em vs default: TPM p99 rel err {p99:.3e}; "
        f"GTF body equal to the single-process --fast-em run's: {same_fast}")

    prof = profiled_run("g_r_shards4_device_em_profiled",
                        base + ["--shards", "4"], dev_env, dispatchers=4)

    rows_path = os.path.join(WORK, "out", "dist_rows.npy")
    if os.path.exists(rows_path):
        os.remove(rows_path)
    coord = f"127.0.0.1:{free_port()}"
    outs, ranks, dist_wall = cli_processes("g_r_dist", [
        (base, {**dev_env, "STRAWB_DIST_COORD": coord,
                "STRAWB_DIST_NPROCS": "2", "STRAWB_DIST_PROCID": str(k),
                **({"SMOKE_SAVE_ROWS": rows_path} if k == 0 else {})})
        for k in range(2)])
    require(body(outs[0]) == want_body,
            "2 processes STRAWB_DEVICE_EM=1: rank 0's GTF body differs from "
            "the default's")
    shares = []
    for k, (out, r) in enumerate(zip(outs, ranks)):
        with open(out[:-4] + ".log") as f:
            m = re.search(r"ranged ingest: inflated (\d+) of (\d+)",
                          f.read())
        require(m, f"rank {k}: no ranged-ingest record in its -T log")
        shares.append(int(m.group(1)) / int(m.group(2)))
        require(r["launches"]["em_bucket"] > 0
                and r["launches"]["shard_colsum"] > 0
                and r["em_split"]["device"] > 0,
                f"rank {k}: launches {r['launches']}, EM {r['em_split']}")
    require(sum(shares) < 1.5 and max(shares) < 0.9,
            f"ranged ingest: shares {shares}")
    log(f"  2 processes STRAWB_DEVICE_EM=1: wall {dist_wall:.3f} s from the "
        f"first start to the last exit; rank 0's GTF body byte-identical to "
        f"the default's; ranged-ingest shares {shares}")
    rows_seen["dist"] = np.load(rows_path)
    require(rows_seen["dist"].shape[0] == 2,
            f"rank 0 summed rows of shape {rows_seen['dist'].shape}")

    (p_out,), (p,), p_wall = cli_processes("g_r_p2", [(base + ["-p", "2"],
                                                       {})])
    require(body(p_out) == want_body,
            "-p 2: GTF body differs from the default's")
    require(not any(p["launches"].values()),
            f"-p 2 launched kernels: {p['launches']}")
    require(p["cuda_at_fork"] == [False, False]
            and not p["cuda_initialized"],
            f"-p 2: CUDA initialized at the forks {p['cuda_at_fork']}, at "
            f"the end {p['cuda_initialized']}")
    log(f"  -p 2: wall {p_wall:.3f} s with the process's start; GTF body "
        "byte-identical to the default's; no kernel launched, no CUDA "
        "context in the parent")
    return {"rows": rows_seen, "profiled_shards4": prof, "out": sh.out,
            "walls_s": {"g_r_shards4_device_em": sh.wall,
                        "g_r_shards4_fast_em": shf.wall,
                        "g_r_dist2_device_em": dist_wall,
                        "g_r_dist2_in_process": [r["wall_s"] for r in ranks],
                        "g_r_p2": p_wall, "g_r_p2_in_process": p["wall_s"]},
            "em_split": {"g_r_shards4_device_em": [sh.d.n_device,
                                                   sh.d.n_host],
                         "g_r_shards4_fast_em": [shf.d.n_device,
                                                 shf.d.n_host],
                         "g_r_dist2_device_em": [
                             [r["em_split"]["device"], r["em_split"]["host"]]
                             for r in ranks]},
            "launches": {"shards4_device_em": sh.launches,
                         "shards4_fast_em": shf.launches,
                         "dist2_device_em": [r["launches"] for r in ranks],
                         "p2": p["launches"]},
            "ranged_ingest_shares": shares,
            "shards4_fast_em_tpm_p99": p99,
            "shards4_fast_em_same_as_fast_em": same_fast}


def end_to_end(n_frags, dev):
    import numpy as np

    bam, gtf = realistic_set(n_frags)
    base = ["-g", gtf, "-r", "--fr", bam]
    host = run_cli("g_r_host", base, {})
    require(host.d.n_device == 0 and host.d.n_host > 0,
            "default run must solve every EM on the host")
    require_no_launches(host, "default -g -r")

    fast = run_cli("g_r_fast_em", base + ["--fast-em"], F32)
    fast_launches = fast.launches["em_bucket"]
    require(fast_launches > 0, "--fast-em launched no kernel")
    require(fast.d.n_device == fast.fit,
            f"--fast-em: {fast.d.n_device} EMs on the card, {fast.fit} fit "
            "a tier")
    require(fast_launches == fast.want,
            f"--fast-em: {fast_launches} launches, {fast.want} expected")

    ref = tpms(host.out)
    fast_tpm = tpms(fast.out)
    require(ref and set(fast_tpm) == set(ref),
            "--fast-em transcript set differs from the default's")
    a = np.array([ref[t] for t in sorted(ref)])
    b = np.array([fast_tpm[t] for t in sorted(ref)])
    require(np.isfinite(b).all(), "--fast-em TPM not finite")
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
    p99 = float(np.percentile(rel, 99))
    log(f"  --fast-em vs default: {len(ref)} transcripts, TPM rel err "
        f"median {np.median(rel):.3e} p99 {p99:.3e} max {rel.max():.3e}")
    require(p99 <= 1e-3, f"--fast-em TPM p99 rel err {p99} > 1e-3")
    prof = profiled_run("g_r_fast_em_profiled", base + ["--fast-em"], F32)

    dev_em = run_cli("g_r_device_em", base, {"STRAWB_DEVICE_EM": "1"})
    dev_launches = dev_em.launches["em_bucket"]
    require(dev_em.d.n_device == dev_em.fit and dev_launches == dev_em.want
            > 0, f"STRAWB_DEVICE_EM=1: {dev_em.d.n_device} on the card of "
            f"{dev_em.fit}, {dev_launches} launches of {dev_em.want}")
    dev_same = body(dev_em.out) == body(host.out)
    log(f"  STRAWB_DEVICE_EM=1 GTF body byte-identical to default: "
        f"{dev_same}")
    require(set(tpms(dev_em.out)) == set(ref), "STRAWB_DEVICE_EM=1 "
            "transcript set differs from the default's")

    preps, prep_chunks, prep_tables = prep_runs(base, host)

    g_host = run_cli("g_host", ["-g", gtf, "--fr", bam], {})
    require_no_launches(g_host, "default -g")
    mcfs, mcf_calls = mcf_runs(gtf, bam, g_host)

    prof_prep = profiled_run("g_r_prep_all_profiled", base,
                             {"STRAWB_DEVICE_PREP": "all"})
    prof_mcf = profiled_run("g_mcf_profiled", ["-g", gtf, "--fr", bam],
                            {"STRAWB_DEVICE_MCF": "1"})

    g = run_cli("g_fast_em", ["-g", gtf, "--fr", "--fast-em", bam], F32)
    g_launches = g.launches["em_bucket"]
    require(g.d.n_device == g.fit and g_launches == g.want > 0,
            f"-g --fast-em: {g.d.n_device} on the card of {g.fit}, "
            f"{g_launches} launches of {g.want}")
    gt = tpms(g.out)
    require(gt and all(math.isfinite(v) for v in gt.values()),
            "-g --fast-em produced no finite TPMs")

    par = parallel_runs(base, host, fast, ref)
    outs = {"g_r_host": host.out, "g_r_fast_em": fast.out,
            "g_r_prep_all": preps["all"].out, "g_mcf": mcfs["g_mcf"].out,
            "g_r_shards4_device_em": par.pop("out")}

    log("  the main path's own inputs: the first full bucket of each EM "
        "tier, the first full prep chunk, every MCF problem, the rows the "
        "sharded and the 2-process run summed:")
    real = {"x".join(map(str, b[0].shape)):  # F's B x R x C
            compare_bucket(dev, b, f"main-path tier {t}")
            for t, b in sorted(fast.d.buckets.items())}
    require(real, "--fast-em filled no tier bucket")
    real_prep = main_path_prep(dev, prep_chunks, prep_tables,
                               "main-path prep chunk")
    real_mcf = main_path_mcf(dev, mcf_calls)
    real_rows = {("2 processes " if k == "dist" else "--shards 4 ")
                 + "x".join(map(str, r.shape)):
                 compare_reduce(dev, r, "main-path rows, " + (
                     "2 processes" if k == "dist" else "--shards 4"))
                 for k, r in par.pop("rows").items()}

    return {"outs": outs,
            "main_path_buckets": real, "main_path_prep_chunk": real_prep,
            "main_path_mcf": real_mcf, "main_path_rows": real_rows,
            "parallel": par, "profiled_fast_em": prof,
            "profiled_prep_all": prof_prep, "profiled_mcf": prof_mcf,
            "walls_s": {"g_r_host": host.wall, "g_r_fast_em": fast.wall,
                        "g_r_device_em": dev_em.wall,
                        "g_r_prep_all": preps["all"].wall,
                        "g_r_prep_budget": preps["budget"].wall,
                        "g_host": g_host.wall, "g_mcf": mcfs["g_mcf"].wall,
                        "g_mcf_force_host": mcfs["g_mcf_force_host"].wall,
                        "g_fast_em": g.wall},
            "em_split": {"g_r_fast_em": [fast.d.n_device, fast.d.n_host],
                         "g_r_device_em": [dev_em.d.n_device,
                                           dev_em.d.n_host],
                         "g_fast_em": [g.d.n_device, g.d.n_host]},
            "prep_stats": {m: r.sample.prep_stats for m, r in preps.items()},
            "flow_stats": {k: mcfs[k].sample.flow_stats
                           for k in ("g_mcf", "g_mcf_force_host")},
            "launches": {"em_bucket_f32": fast_launches,
                         "em_bucket_f64": dev_launches,
                         "g_fast_em": g_launches,
                         "quant_prep": preps["all"].launches["quant_prep"],
                         "quant_prep_budget":
                             preps["budget"].launches["quant_prep"],
                         "mcf_bucket": mcfs["g_mcf"].launches["mcf_bucket"]},
            "mcf_calls": len(mcf_calls),
            "main_path_mcf_sizes": [p[0].shape[0] for c in mcf_calls
                                    for p in c],
            "default_launches": {"g_r_host": host.launches,
                                 "g_host": g_host.launches},
            "tier_counts": fast.tiers,
            "tpm_p99": p99, "device_em_byte_identical": dev_same,
            "mcf_same_as_default": mcfs["mcf_same_as_default"]}


# --------------------------------------------------------------- phase 5
def read_trace(path):
    """A Chrome trace's kernel events of every __global__ function of
    KERNEL_FUNCTIONS (whole names, as profiled_run matches them), with
    each function's total and mean kernel duration (the events' `dur`),
    its device busy time (the kernels', copies' and sets' durations
    summed, as profiled_run sums the profiler's device times), its event
    count and the names of its phase ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {fn: 0 for fns in KERNEL_FUNCTIONS.values() for fn in fns}
    dur_us = dict.fromkeys(counts, 0.0)
    busy_us, ranges = 0.0, set()
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += float(e.get("dur", 0.0))
        if cat == "kernel":
            for fn in counts:
                if re.search(rf"\b{fn}\b", e.get("name", "")):
                    counts[fn] += 1
                    dur_us[fn] += float(e.get("dur", 0.0))
        elif cat == "user_annotation":
            ranges.add(e.get("name"))
    kernel_ms = {fn: {"total_ms": dur_us[fn] / 1e3,
                      "mean_ms": dur_us[fn] / 1e3 / counts[fn]}
                 for fn in counts if counts[fn]}
    return {"counts": counts, "kernel_ms": kernel_ms,
            "busy_ms": busy_us / 1e3, "events": len(events),
            "ranges": sorted(ranges)}


def traced_process(name, argv, env):
    """One fresh CLI process with STRAWB_TRACE_DIR set to a new directory:
    (the GTF path, the process's report, its one trace read)."""
    d = os.path.join(WORK, "trace", name)
    shutil.rmtree(d, ignore_errors=True)
    (out,), (rep,), _wall = cli_processes(
        "traced_" + name, [(argv, {**env, "STRAWB_TRACE_DIR": d})])
    files = os.listdir(d) if os.path.isdir(d) else []
    require(len(files) == 1 and files[0].endswith(".pt.trace.json"),
            f"traced {name}: trace directory holds {files}, not one trace")
    return out, rep, read_trace(os.path.join(d, files[0]))


def trace_phase(n_frags, e2e):
    """Phase 5: the four device modes of phase 4 traced, each in a fresh
    process, against their twins' GTF bodies and the wrappers' counts of
    each __global__ function; a traced -p 2; launches right after a trace
    starts, in a fresh process and in this one. Fails, with every count,
    if a trace of a fresh process holds another number of kernel events
    than was launched."""
    bam, gtf = realistic_set(n_frags)
    base = ["-g", gtf, "-r", "--fr", bam]
    modes = (
        ("g_r_fast_em", base + ["--fast-em"], F32, "profiled_fast_em"),
        ("g_r_prep_all", base, {"STRAWB_DEVICE_PREP": "all"},
         "profiled_prep_all"),
        ("g_mcf", ["-g", gtf, "--fr", bam], {"STRAWB_DEVICE_MCF": "1"},
         "profiled_mcf"),
        ("g_r_shards4_device_em", base + ["--shards", "4"],
         {"STRAWB_DEVICE_EM": "1"}, "profiled_shards4"))
    runs, mismatches = {}, []
    for name, argv, env, prof_key in modes:
        out, rep, tr = traced_process(name, argv, env)
        require(body(out) == body(e2e["outs"][name]),
                f"traced {name}: GTF body differs from the untraced run's")
        launched = rep["function_launches"]
        for fn, n in tr["counts"].items():
            if n != launched.get(fn, 0):
                mismatches.append(f"{name}: {fn} {n} kernel events in the "
                                  f"trace, {launched.get(fn, 0)} launched")
        require(any(launched.values()), f"traced {name}: no kernel launched")
        em_events = sum(tr["counts"][fn]
                        for fn in KERNEL_FUNCTIONS["em_bucket"])
        prof = (e2e["parallel"] if prof_key == "profiled_shards4"
                else e2e)[prof_key]
        wall_ms = rep["wall_s"] * 1e3
        runs[name] = r = {
            "wall_s": rep["wall_s"], "trace_s": rep["trace_s"],
            "launches": rep["launches"],
            "function_launches": launched, "trace_counts": tr["counts"],
            "trace_kernel_ms": tr["kernel_ms"],
            "trace_events": tr["events"], "ranges": tr["ranges"],
            "device_busy_ms": tr["busy_ms"],
            "idle_share": 1 - tr["busy_ms"] / wall_ms,
            "em_events": em_events,
            "profiled": {k: prof.get(k) for k in (
                "wall_s", "device_busy_ms", "idle_share")}}
        log(f"  traced {name}: GTF body byte-identical to the untraced "
            f"run's; kernel events {tr['counts']} against launches "
            f"{launched}, their device time {tr['kernel_ms']}; EM "
            f"events {em_events}, EM launches "
            f"{rep['launches']['em_bucket']}; {tr['events']} events; wall "
            f"{rep['wall_s']:.3f} s (starting the trace "
            f"{rep['trace_s']['start']:.3f} s, stopping it "
            f"{rep['trace_s']['stop']:.3f} s, of which the export "
            f"{rep['trace_s']['export']:.3f} s), device busy "
            f"{tr['busy_ms']:.3f} ms, "
            f"idle share {r['idle_share']:.4f} (profiled rerun: wall "
            f"{prof['wall_s']:.3f} s, busy "
            f"{measured(prof.get('device_busy_ms'), '.3f')}, idle share "
            f"{prof.get('idle_share')})")
        if rep["launches"]["em_bucket"] != em_events:
            mismatches.append(f"{name}: {em_events} EM kernel events, "
                              f"{rep['launches']['em_bucket']} EM launches")

    out, rep, tr = traced_process("g_r_p2", base + ["-p", "2"], {})
    require(body(out) == body(e2e["outs"]["g_r_host"]),
            "traced -p 2: GTF body differs from the default's")
    require(rep["cuda_at_fork"] == [False, False]
            and not rep["cuda_initialized"] and not any(
                rep["launches"].values()),
            f"traced -p 2: CUDA at the forks {rep['cuda_at_fork']}, at the "
            f"end {rep['cuda_initialized']}, launches {rep['launches']}")
    require(tr["busy_ms"] == 0 and "multiprocess_pipeline" in tr["ranges"],
            f"traced -p 2: device busy {tr['busy_ms']} ms, ranges "
            f"{tr['ranges']}; a trace of the host alone was expected")
    runs["g_r_p2"] = {"wall_s": rep["wall_s"], "trace_events": tr["events"],
                      "ranges": tr["ranges"]}
    log(f"  traced -p 2: GTF body byte-identical to the default's, no CUDA "
        f"context at the forks, {tr['events']} host events, ranges "
        f"{tr['ranges']}")

    # a trace a process, as the CLI makes it, must hold these too; this
    # old process's traces are recorded, not held to it
    after_start = after_start_traces()
    for name, c in after_start["fresh_process"].items():
        if name != "process_age_s" and \
                c["port_trace"]["events"] != c["launched"]:
            mismatches.append(f"{name} right after a trace starts in a fresh "
                              f"process: {c['port_trace']['events']} events "
                              f"in the trace, {c['launched']} launched")
    require(not mismatches, "the trace does not hold what was launched: "
            + "; ".join(mismatches))
    log("  every trace of a fresh process holds, for every __global__ "
        "function, as many kernel events as the wrappers launched")
    return {"runs": runs, "after_start": after_start}


def process_age_s():
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def traces_right_after_start():
    """Launches made just after a trace starts, where torch.profiler drops
    kernel records once the process is old (utils/profiling.py): phase
    3c's four seeded 256-node problems in one launch, and 100 launches of
    the reduction, each traced as STRAWB_TRACE_DIR traces a run
    (utils/profiling.Profiler: CPU and CUDA activity, a Chrome trace) and
    under torch.profiler with CUDA activity alone (as device_ms and
    profiled_run read the card). Returns, with this process's age, the
    launches and, per trace, the kernel events it holds and its device
    busy time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from strawberry_tpu_torch.assembly.cuda_mcf import (mcf_ragged_cuda,
                                                        pack_problems)
    from strawberry_tpu_torch.parallel.cuda_reduce import shard_colsum_cuda
    from strawberry_tpu_torch.utils import profiling
    dev = torch.device("cuda")
    problems = [p for p in flow_problems(2000, MCF_SIZES, per_size=4)
                if p[0].shape[0] == 256]
    x = pack_problems(problems, pin=True).to(dev)
    rows = torch.from_numpy(np.random.default_rng(3000).integers(
        0, 2**40, size=(1, 600)).astype(np.float64)).to(dev)
    cases = {"mcf_256": ("mcf_block_kernel", lambda: mcf_ragged_cuda(x)),
             "reduction_x100": ("shard_colsum_kernel", lambda: [
                 shard_colsum_cuda(rows) for _ in range(100)])}
    counters = launch_counters()
    d = os.path.join(WORK, "trace", f"after_start_{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    os.environ["STRAWB_TRACE_DIR"] = d
    try:
        tracer = profiling.Profiler(enabled=False)
    finally:
        del os.environ["STRAWB_TRACE_DIR"]
    out = {"process_age_s": process_age_s()}
    for name, (fn_name, fn) in cases.items():
        fn()  # warm
        torch.cuda.synchronize()
        before = function_counts(counters)[fn_name]
        tracer.start_trace()
        fn()
        try:
            path = tracer.stop_trace()
        except profiling.TraceIncomplete as e:
            path = e.path
        launched = function_counts(counters)[fn_name] - before
        port = read_trace(path)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(d, "cuda_only.json")
        prof.export_chrome_trace(path)
        cuda_only = read_trace(path)
        out[name] = {"launched": launched,
                     "port_trace": {"events": port["counts"][fn_name],
                                    "busy_ms": port["busy_ms"]},
                     "cuda_only": {"events": cuda_only["counts"][fn_name],
                                   "busy_ms": cuda_only["busy_ms"]}}
    return out


# Runs traces_right_after_start() in a fresh process (a trace a process, as
# the CLI traces a run) with jax and the JAX package blocked from import,
# and prints its result as JSON.
_AFTER_START_RUNNER = """
import json, os, sys
sys.path.insert(0, os.getcwd())
sys.modules["jax"] = None
sys.modules["strawberry_tpu"] = None
import chip_smoke
print(json.dumps(chip_smoke.traces_right_after_start()))
"""


def after_start_traces():
    """traces_right_after_start in a fresh process and in this one (old by
    now): {"fresh_process": ..., "this_process": ...}."""
    proc = subprocess.run([sys.executable, "-c", _AFTER_START_RUNNER],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=PROCESS_TIMEOUT_S)
    require(proc.returncode == 0, "traces right after start in a fresh "
            f"process: exit code {proc.returncode}\n{proc.stderr[-4000:]}")
    out = {"fresh_process": json.loads(proc.stdout.strip().splitlines()[-1]),
           "this_process": traces_right_after_start()}
    for where, r in out.items():
        log(f"  launches right after a trace starts, {where} (age "
            f"{r['process_age_s']:.1f} s): " + "; ".join(
                f"{name} {c['launched']} launched, {c['port_trace']['events']}"
                f" in the port's trace ({c['port_trace']['busy_ms']:.4f} ms "
                f"busy), {c['cuda_only']['events']} under CUDA activity alone "
                f"({c['cuda_only']['busy_ms']:.4f} ms)"
                for name, c in r.items() if name != "process_age_s"))
    return out


# --------------------------------------------------------------- phase 6
def routing_phase(n_frags, e2e):
    """Phase 6: the routing defaults (strawberry_tpu_torch/routing.py) on
    the card. Prints the constants and what each default resolves to
    here. A default that sends work to the card (the f64 EM, the prep
    auto mode) runs beside its STRAWB_FORCE_HOST=1 twin: the same GTF
    body, its kernel launched, the twin launching nothing; a default that
    keeps the work on the host launched nothing in phase 4's default
    runs. `--fast-em` at the default STRAWB_FASTEM_AFTER gives the
    default's body and, where the bound is at least the run's problems,
    launches nothing; the mixed route (a bound at half the problems)
    keeps its first problems on the host, bit for bit, and sends every
    tier-fitting one past them to the card. Under STRAWB_DEVICE_MCF=1
    (phase 4) every problem of at least device_min_nodes went through
    the kernel."""
    from strawberry_tpu_torch import routing
    constants = {k: getattr(routing, k) for k in (
        "DEVICE_EM", "FASTEM_AFTER", "PREP", "PREP_GRANULE",
        "MCF_MIN_NODES")}
    resolved = {"f64_em": "host" if routing.em_force_host(False)
                else "device",
                "fast_em": "host" if routing.em_force_host(True)
                else "device",
                "fastem_after": routing.fastem_after(),
                "prep": routing.prep_mode(),
                "prep_granule": routing.prep_granule(),
                "mcf_min_nodes": routing.mcf_min_nodes()}
    log(f"  routing defaults on the card: {constants}; resolved: "
        f"{resolved}")
    bam, gtf = realistic_set(n_frags)
    base = ["-g", gtf, "-r", "--fr", bam]
    host_body = body(e2e["outs"]["g_r_host"])
    out = {"constants": constants, "resolved": resolved}

    on_card = {k: kern for k, kern in (("f64_em", "em_bucket"),
                                        ("prep", "quant_prep"))
               if resolved[k] not in ("host", "off")}
    if on_card:
        dflt = run_cli("routing_default", base, {})
        twin = run_cli("routing_force_host", base,
                       {"STRAWB_FORCE_HOST": "1"})
        require(body(dflt.out) == body(twin.out),
                f"default -g -r ({on_card} on the card): GTF body differs "
                "from its STRAWB_FORCE_HOST=1 twin's")
        require_no_launches(twin, "STRAWB_FORCE_HOST=1")
        for k, kern in on_card.items():
            require(dflt.launches[kern] > 0,
                    f"the default sends {k} to the card; {kern} launched "
                    "nothing")
        out["default_vs_force_host"] = {"walls_s": [dflt.wall, twin.wall],
                                        "launches": dflt.launches}
    for name, launches in e2e["default_launches"].items():
        for k, kern in (("f64_em", "em_bucket"), ("prep", "quant_prep")):
            require(k in on_card or launches[kern] == 0,
                    f"{name}: {kern} launched where the default is host")
    log(f"  defaults on the card: {sorted(on_card) or 'none'}; phase 4's "
        "default runs launched nothing the defaults keep on the host")

    k = resolved["fastem_after"]
    fk = run_cli("routing_fast_em", base + ["--fast-em"], {})
    n = fk.d.n_device + fk.d.n_host
    require(fk.d.n_device == fk.fit and fk.launches["em_bucket"] == fk.want,
            f"--fast-em at STRAWB_FASTEM_AFTER={k}: {fk.d.n_device} EMs on "
            f"the card, {fk.fit} fit a tier past the first {k}; "
            f"{fk.launches['em_bucket']} launches of {fk.want}")
    same = body(fk.out) == host_body
    if k is None or n <= k:
        require(fk.d.n_device == 0 and not any(fk.launches.values())
                and same, f"--fast-em on {n} problems, bound {k}: "
                "expected the default's run, got "
                f"{fk.d.n_device} on the card, {fk.launches}, body equal "
                f"{same}")
    log(f"  --fast-em at STRAWB_FASTEM_AFTER={k}: {n} problems, "
        f"{fk.d.n_device} on the card, GTF body equal to the default's: "
        f"{same}")
    out["fast_em_default"] = {"problems": n, "device": fk.d.n_device,
                              "launches": fk.launches["em_bucket"],
                              "body_equals_default": same,
                              "wall_s": fk.wall}
    out["fast_em_mixed"] = mixed_fast_em(base, fk, e2e["outs"]["g_r_host"])

    # phase 4 held every problem of the STRAWB_DEVICE_MCF=1 run to the
    # kernel; none may lie below device_min_nodes
    sizes = e2e["main_path_mcf_sizes"]
    low = sum(m < resolved["mcf_min_nodes"] for m in sizes)
    require(sizes and low == 0,
            f"STRAWB_DEVICE_MCF=1: {low} of {len(sizes)} problems on the "
            f"card below device_min_nodes {resolved['mcf_min_nodes']}")
    out["mcf"] = {"device_problems": len(sizes), "min_nodes_seen": min(sizes)}
    return out


def same_bits(a, b):
    """Two thetas (or None) bit for bit."""
    import numpy as np
    if a is None or b is None:
        return a is None and b is None
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64),
                                                 b.view(np.uint64))


def mixed_fast_em(base, host_run, host_gtf):
    """`--fast-em` with STRAWB_FASTEM_AFTER at half the problems of
    `host_run` (a --fast-em run that solved every problem on the host):
    the first half solve on the host, bit for bit as `host_run` did them,
    and every tier-fitting problem past it through the f32 kernel; the
    TPMs within --fast-em's tolerance of the default's."""
    (ref,) = host_run.dispatchers
    require(not ref.n_device and ref.order,
            "the mixed route needs a --fast-em run on the host to compare")
    k = len(ref.order) // 2
    mx = run_cli("routing_fast_em_mixed", base + ["--fast-em"],
                 {"STRAWB_FASTEM_AFTER": str(k)})
    (d,) = mx.dispatchers
    launches = mx.launches["em_bucket"]
    require(d.order == ref.order, "the mixed run queued other problems")
    require(mx.d.n_device == mx.fit > 0 and launches == mx.want > 0,
            f"mixed --fast-em (bound {k}): {mx.d.n_device} EMs on the card "
            f"of {mx.fit} tier-fitting past the bound, {launches} launches "
            f"of {mx.want}")
    require(mx.d.n_host == k + sum(t is None for t in d.tier_of[k:]),
            f"mixed --fast-em: {mx.d.n_host} on the host, expected the "
            f"first {k} and the rest that fit no tier")
    host_part = [i for pos, i in enumerate(d.order)
                 if pos < k or d.tier_of[pos] is None]
    differ = sum(not same_bits(d.results[i], ref.results[i])
                 for i in host_part)
    require(differ == 0, f"mixed --fast-em: {differ} of {len(host_part)} "
            "problems kept on the host differ from the default's thetas")
    p99 = tpm_p99(host_gtf, mx.out, "mixed --fast-em")
    log(f"  mixed --fast-em, STRAWB_FASTEM_AFTER={k}: {mx.d.n_host} on the "
        f"host ({len(host_part)} bit-identical to the default's), "
        f"{mx.d.n_device} on the card in {launches} launches, TPM p99 rel "
        f"err {p99:.3e}")
    return {"bound": k, "host": mx.d.n_host, "device": mx.d.n_device,
            "launches": launches, "host_thetas_bit_identical":
            len(host_part), "tpm_p99": p99, "wall_s": mx.wall}


# --------------------------------------------------------------- phase 7
# bench.py's sets: dataset_realistic at half its size (phase 7; both sets
# are made beside phases 2-6, which share the host with them) and
# dataset_10m, the easy set, at its full size (phase 8)
BIG_FRAGS = 2_500_000
EASY_FRAGS = 5_000_000


def start_big_set(shape, n_frags):
    """Starts generating the set of `shape` at `n_frags` fragments in a
    process of its own (into a temporary directory, renamed when done), so
    that it runs beside phases 2-6; none when the set is already there.
    Returns the process (or None) and its log's path."""
    from strawberry_tpu_torch.tools import common
    d, bam, gtf, _strand = shape_paths(shape, n_frags)
    logf = os.path.join(WORK, f"generate_{shape}_{n_frags}.log")
    if os.path.exists(bam) and os.path.exists(gtf):
        return None, logf
    os.makedirs(WORK, exist_ok=True)
    shutil.rmtree(d + ".partial", ignore_errors=True)
    with open(logf, "w") as f:
        proc, _what = common.start_generating(d + ".partial", shape,
                                              n_frags, log=f)
    return proc, logf


def finish_big_set(shape, n_frags, gen):
    """Waits for start_big_set's process and moves its set in place."""
    d, bam, gtf, _strand = shape_paths(shape, n_frags)
    proc, logf = gen
    if proc is not None:
        t0 = time.perf_counter()
        rc = proc.wait()
        with open(logf) as f:
            text = f.read()
        require(rc == 0, f"generating {n_frags} fragments: exit code {rc}:\n"
                + text[-3000:])
        shutil.rmtree(d, ignore_errors=True)
        os.rename(d + ".partial", d)
        log(f"  {text.strip()} beside the phases before (waited "
            f"{time.perf_counter() - t0:.1f} s here)")
    require(os.path.exists(bam) and os.path.exists(gtf),
            f"no {shape} set of {n_frags} fragments")
    return bam, gtf


def big_phase(shape, n_frags, dev, gen, e2e, low_mem=False):
    """Phases 7 and 8: the main path on one of bench.py's sets at millions
    of fragments, with the shape's strand, each run against its
    host twin: `-g -r` (the default), `-g -r` with STRAWB_DEVICE_EM=1 (the
    default's body byte for byte, every tier-fitting problem through the
    kernel), `-g -r --fast-em` at the default bound (routing.FASTEM_AFTER:
    its route's launches, and the default's body where it sent nothing to
    the card, else TPM p99 <= 1e-3), `--fast-em` with STRAWB_FASTEM_AFTER=0
    (every tier-fitting problem in f32; TPM p99 <= 1e-3), `-g -r` with
    STRAWB_DEVICE_PREP=all (the default's body byte for byte), `-g` with
    STRAWB_DEVICE_MCF=1 against its STRAWB_FORCE_HOST=1 twin (byte for
    byte), and with `low_mem` `-g` (the default) against `-g --low-mem`
    (byte for byte, no launch in either). Prints the EM tier counts and
    the MCF size classes on a line of their own. Then the kernels on what
    this run made: the first bucket of every EM tier the run filled (f64
    and f32, as phase 3), the first prep chunk of 100 loci (on the easy
    set, whose flushes of deep loci are halved to fit the prep tiers, the
    first chunk; and every chunk, array-equal), and every MCF problem in
    one call, the largest call, and the problems of each size class above
    the warp class (as phase 3c), each against its plain version and
    timed with its bound. A tier or class the 1M run of phase 4 left empty
    is named as reached for the first time."""
    bam, gtf = finish_big_set(shape, n_frags, gen)
    strand = shape_paths(shape, n_frags)[3]
    tag = "%s %gM" % (shape, n_frags / 1e6)
    pre = "big_" if shape == "realistic" else f"{shape}_"
    base = ["-g", gtf, "-r", strand, bam]
    host = run_cli(pre + "g_r_host", base, {})
    require(host.d.n_device == 0 and host.d.n_host > 0,
            f"{tag} default run must solve every EM on the host")
    require_no_launches(host, f"{tag} default -g -r")

    dev_em = run_cli(pre + "g_r_device_em", base, {"STRAWB_DEVICE_EM": "1"})
    n = dev_em.launches["em_bucket"]
    require(dev_em.d.n_device == dev_em.fit and n == dev_em.want > 0,
            f"{tag} STRAWB_DEVICE_EM=1: {dev_em.d.n_device} on the card of "
            f"{dev_em.fit}, {n} launches of {dev_em.want}")
    require(dev_em.sample.em_stats["tiers"] == dev_em.tiers,
            f"{tag} STRAWB_DEVICE_EM=1: the dispatcher's tier counts "
            f"{dev_em.sample.em_stats['tiers']}, recorded {dev_em.tiers}")
    require(body(dev_em.out) == body(host.out),
            f"{tag} STRAWB_DEVICE_EM=1: GTF body differs from the default's")
    log(f"  {tag} STRAWB_DEVICE_EM=1: GTF body byte-identical to the "
        "default's")

    fk = run_cli(pre + "g_r_fast_em", base + ["--fast-em"], {})
    require(fk.d.n_device == fk.fit
            and fk.launches["em_bucket"] == fk.want,
            f"{tag} --fast-em at the default bound: {fk.d.n_device} on the "
            f"card of {fk.fit}, {fk.launches['em_bucket']} launches of "
            f"{fk.want}")
    if fk.d.n_device == 0:
        require(body(fk.out) == body(host.out),
                f"{tag} --fast-em on the host route: GTF body differs from "
                "the default's")
        fk_p99 = 0.0
    else:
        fk_p99 = tpm_p99(host.out, fk.out, f"{tag} --fast-em at the default")
    f32 = run_cli(pre + "g_r_fast_em_f32", base + ["--fast-em"], F32)
    require(f32.d.n_device == f32.fit
            and f32.launches["em_bucket"] == f32.want > 0,
            f"{tag} --fast-em, STRAWB_FASTEM_AFTER=0: {f32.d.n_device} on the "
            f"card of {f32.fit}, {f32.launches['em_bucket']} launches of "
            f"{f32.want}")
    f32_p99 = tpm_p99(host.out, f32.out, f"{tag} --fast-em in f32")
    log(f"  {tag} --fast-em at the default bound: {fk.d.n_device} on the "
        f"card, TPM p99 {fk_p99:.3e}; in f32 from the first problem: "
        f"{f32.d.n_device} on the card, TPM p99 {f32_p99:.3e}")

    preps, chunks, tables = prep_runs(base, host, modes=("all",),
                                      prefix=pre)
    walls = {}
    if low_mem:
        g_host = run_cli(pre + "g_host", ["-g", gtf, strand, bam], {})
        require_no_launches(g_host, f"{tag} default -g")
        lm = run_cli(pre + "g_low_mem", ["-g", gtf, strand, "--low-mem",
                                         bam], {})
        require_no_launches(lm, f"{tag} -g --low-mem")
        require(body(lm.out) == body(g_host.out),
                f"{tag} -g --low-mem: GTF body differs from the default's")
        log(f"  {tag} -g --low-mem: GTF body byte-identical to the "
            "default's")
        walls.update(g_host=g_host.wall, g_low_mem=lm.wall)
    mcfs, calls = mcf_runs(gtf, bam, None, prefix=pre, strand=strand)
    fs = mcfs["g_mcf"].sample.flow_stats
    counts = {"em_tiers": dev_em.tiers, "em_host_no_tier":
              dev_em.d.n_host, "mcf_classes": {
                  k[len("device_"):]: fs.get(k, 0) for k in (
                      "device_warp", "device_block", "device_block_global")},
              "mcf_host_over_256": fs.get("host_over_max", 0)}
    log(f"  {tag} tier and class counts: " + json.dumps(counts))

    first = {"em_tiers": [t for t, c in enumerate(dev_em.tiers)
                          if c and not e2e["tier_counts"][t]],
             "mcf_classes": [c for c, k in counts["mcf_classes"].items()
                             if k and not e2e["flow_stats"]["g_mcf"].get(
                                 "device_" + c)]}
    log(f"  reached for the first time at {tag}: {first}")
    buckets = {"x".join(map(str, b[0].shape)):
               compare_bucket(dev, b, f"{tag} main-path tier {t}")
               for t, b in sorted(dev_em.d.buckets.items())}
    prep = main_path_prep(dev, chunks, tables, f"{tag} main-path prep chunk",
                          min_loci=100 if shape == "realistic" else 1)
    mcf = main_path_mcf(dev, calls)
    every = [p for c in calls for p in c]
    from strawberry_tpu_torch.assembly.cuda_mcf import CLASSES
    lo = 0
    for name, top in CLASSES:
        of = [p for p in every if lo < p[0].shape[0] <= top]
        if of and name != "warp":
            mcf["class_" + name] = compare_ragged(
                dev, of, f"{tag} main-path MCF, the {name} class")
        lo = top
    walls.update(g_r_host=host.wall, g_r_device_em=dev_em.wall,
                 g_r_fast_em=fk.wall, g_r_fast_em_f32=f32.wall,
                 g_r_prep_all=preps["all"].wall, g_mcf=mcfs["g_mcf"].wall,
                 g_mcf_force_host=mcfs["g_mcf_force_host"].wall)
    return {"shape": shape, "n_frags": n_frags, "counts": counts,
            "first_reached": first, "walls_s": walls,
            "launches": {"em_bucket_f64": n,
                         "em_bucket_fast_em": fk.launches["em_bucket"],
                         "em_bucket_f32": f32.launches["em_bucket"],
                         "quant_prep": preps["all"].launches["quant_prep"],
                         "mcf_bucket": mcfs["g_mcf"].launches["mcf_bucket"]},
            "prep_stats": preps["all"].sample.prep_stats,
            "fast_em_device": fk.d.n_device, "fast_em_tpm_p99": fk_p99,
            "f32_tpm_p99": f32_p99, "main_path_buckets": buckets,
            "main_path_prep_chunk": prep, "main_path_mcf": mcf}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frags", type=int, default=1_000_000)
    ap.add_argument("--big-frags", type=int, default=BIG_FRAGS,
                    help="fragments of phase 7's realistic set")
    ap.add_argument("--easy-frags", type=int, default=EASY_FRAGS,
                    help="fragments of phase 8's easy set")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: {card}")
    sys.path.insert(0, ROOT)
    gens = {}
    try:
        gens["realistic"] = start_big_set("realistic", args.big_frags)
        gens["easy"] = start_big_set("easy", args.easy_frags)
        return phases(args, card, t_start, gens)
    finally:
        for proc, _logf in gens.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def phases(args, card, t_start, gens):
    """Phases 2-8 and the two last lines; the sets of phases 7 and 8 are
    generated by `gens` (start_big_set, by shape) meanwhile."""
    import torch
    dev = torch.device("cuda")

    log("phase 2: build")
    import threading
    from strawberry_tpu_torch.utils import kernels
    built = {}

    def build_kernels():
        t0 = time.perf_counter()
        try:
            kernels.build_all(KERNELS)
        except Exception as e:  # raised on the main thread below
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    probes = start_probe_builds()
    nvcc = threading.Thread(target=build_kernels)
    nvcc.start()  # nvcc runs while the host library builds
    t0 = time.perf_counter()
    from strawberry_tpu_torch.io.native import get_lib
    get_lib()
    host_build = time.perf_counter() - t0
    nvcc.join()
    if "error" in built:
        raise built["error"]
    for name in KERNELS:
        kernels.load(name)
    ptxas = finish_probe_builds(probes)
    log(f"  ptxas, csrc/quant_prep.cu: {ptxas}")
    require(torch.distributed.is_available()
            and torch.distributed.is_gloo_available(),
            "torch.distributed with gloo is needed for the 2-process run")
    log(f"  host library {host_build:.1f} s, kernels {built['s']:.1f} s "
        f"({', '.join(KERNELS)}, in parallel)")

    log("phase 3: EM kernel vs plain version at the four tier shapes")
    rep = check_kernel(dev)

    log("phase 3b: quant-prep kernel vs plain version, synthetic and edge "
        "chunks")
    prep_parts = {f"synthetic_{seed}": compare_prep(
        dev, *synthetic_prep_chunk(seed), f"synthetic chunk {seed}")
        for seed in (7, 8)}
    for name, chunk in edge_prep_chunks().items():
        prep_parts[name] = compare_prep(dev, *chunk, f"edge chunk {name}")
    prep = summed(prep_parts)
    prep["device_ms"] = sum(r["device_ms"] for r in prep["parts"].values())

    log("phase 3c: MCF kernel vs plain version and solve_dense")
    mcf = check_mcf(dev)

    log("phase 3d: reduction kernel vs plain version and torch.sum(dim=0)")
    red = check_reduce(dev)

    log("phase 3e: sharded_em_bucket vs one launch over the whole bucket")
    sharded = check_sharded_em(dev)

    log(f"phase 4: end to end, {args.n_frags} fragments")
    e2e = end_to_end(args.n_frags, dev)
    log("  " + json.dumps({k: v for k, v in e2e.items()
                           if not k.startswith("main_path")
                           and k != "outs"}))

    log("phase 5: the STRAWB_TRACE_DIR trace against the launch counts")
    traced = trace_phase(args.n_frags, e2e)
    log("  trace: " + json.dumps(traced))

    log("phase 6: the routing defaults on the card")
    routes = routing_phase(args.n_frags, e2e)
    log("  routing: " + json.dumps(routes))

    log(f"phase 7: end to end on bench.py's realistic set, "
        f"{args.big_frags} fragments")
    big = big_phase("realistic", args.big_frags, dev, gens["realistic"],
                    e2e)
    log("  " + json.dumps({k: v for k, v in big.items()
                           if not k.startswith("main_path")}))

    log(f"phase 8: end to end on bench.py's easy set (--rf, no XS tag), "
        f"{args.easy_frags} fragments")
    easy = big_phase("easy", args.easy_frags, dev, gens["easy"], e2e,
                     low_mem=True)
    log("  " + json.dumps({k: v for k, v in easy.items()
                           if not k.startswith("main_path")}))

    src = "strawberry_tpu_torch/csrc/em_bucket.cu"
    replaces = {"f32": "strawberry_tpu/quant/pallas_em.py:34",
                "f64": "strawberry_tpu/quant/device.py:56"}
    tolerance = {
        "f32": "vs the f32 plain version and the f64 one: median rel err "
               "< 1e-4, > 95% within 0.1 (tests/test_pallas_em.py); every "
               "locus under the iteration cap within 5e-2 rel of the f32 "
               "plain version; inactive loci exactly theta0",
        "f64": "rtol=atol=1e-9 vs the plain version and quant/em.py "
               "em_run; two runs bit-identical"}
    # no single PyTorch call computes any of these functions but the
    # reduction, which carries its own library_ms (torch.sum(dim=0))
    kernels_line = {"kernels": [{"library_ms": None, **k} for k in [
        {"name": f"em_bucket_{dt}", "route": "cuda", "source": src,
         "replaces": replaces[dt], "tolerance": tolerance[dt],
         "launches": e2e["launches"][f"em_bucket_{dt}"],
         **rep[dt], "main_path_buckets": {
             t: r[dt] for t, r in e2e["main_path_buckets"].items()},
         "main_path_buckets_realistic": {
             t: r[dt] for t, r in big["main_path_buckets"].items()},
         "main_path_buckets_easy": {
             t: r[dt] for t, r in easy["main_path_buckets"].items()}}
        for dt in ("f32", "f64")] + [
        {"name": "quant_prep", "route": "cuda",
         "source": "strawberry_tpu_torch/csrc/quant_prep.cu",
         "replaces": "strawberry_tpu/quant/device_prep.py:62",
         "tolerance": "array-equal to the plain version (compat and rows); "
                      "two runs identical",
         "launches": e2e["launches"]["quant_prep"], **prep,
         "ptxas": ptxas,
         "main_path_chunk": e2e["main_path_prep_chunk"],
         "main_path_chunk_realistic": big["main_path_prep_chunk"],
         "main_path_chunk_easy": easy["main_path_prep_chunk"]},
        {"name": "mcf_bucket", "route": "cuda",
         "source": "strawberry_tpu_torch/csrc/mcf_bucket.cu",
         "replaces": "strawberry_tpu/assembly/device.py:29",
         "tolerance": "array-equal to the plain version and to "
                      "mincostflow.solve_dense; two runs identical",
         "launches": e2e["launches"]["mcf_bucket"], **mcf,
         "main_path": e2e["main_path_mcf"],
         "main_path_realistic": big["main_path_mcf"],
         "main_path_easy": easy["main_path_mcf"]},
        {"name": "shard_colsum", "route": "cuda",
         "source": "strawberry_tpu_torch/csrc/shard_reduce.cu",
         "replaces": "strawberry_tpu/parallel/collectives.py:26",
         "tolerance": "bit-identical to the plain version and to "
                      "torch.sum(dim=0); two runs bit-identical",
         "launches": e2e["parallel"]["launches"]["shards4_device_em"][
             "shard_colsum"], **red,
         "main_path_rows": e2e["main_path_rows"]},
        {"name": "sharded_em_bucket", "route": "cuda", "source": src,
         "replaces": "strawberry_tpu/parallel/mesh.py:52",
         "tolerance": "f64 theta and failed bit-identical to one launch "
                      "over the whole bucket, rtol=atol=1e-9 vs the plain "
                      "version", **sharded}]]}
    shutil.rmtree(os.path.join(WORK, "out"), ignore_errors=True)
    log(f"  smoke wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
