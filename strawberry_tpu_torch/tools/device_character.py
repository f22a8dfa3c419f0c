"""The card's character, as far as the routing decisions need it: the
port's counterpart of the JAX package's tools/bench_device_character.py.

    python -m strawberry_tpu_torch.tools.device_character [--device cpu]
        [--out]

- f64 add, mul, div and sqrt on the card against numpy, bit for bit, on
  2^20 values spread over 16 orders of magnitude (PyTorch's elementwise
  kernels);
- a sequential f64 accumulation sum_i a_i b_i, one thread a sequence, in
  a probe kernel built with nvcc: as written (nvcc contracts a * b + s to
  an FMA by default), with __fma_rn, and with __dmul_rn / __dadd_rn (no
  FMA), each against the host's exact IEEE result with and without FMA;
  the host library (native/*.cc, g++ -O3 -march=native) contracts too
  where the CPU has FMA, so this says which the card must do to match it;
- host-to-device and device-to-host copy rates from pinned and from
  pageable memory (256 MiB, host clock to the copy synchronized);
- an empty launch's round trip: the probe's C loop of launch and
  cudaStreamSynchronize, and the same from Python (a ctypes launch and
  torch.cuda.synchronize);
- the int32 streaming rate (y = x + 7 over 64 Mi elements, bytes read and
  written) and the gather rate (x[idx], 16 Mi random int64 indices),
  by CUDA events over 20 calls.
Library calls are fine here: the tool measures the card and ports no
kernel. With --device cpu only the elementwise exactness runs (on
PyTorch's CPU kernels); every other field is null.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np

from . import common

PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
// mode 0: as written; 1: __fma_rn; 2: __dmul_rn then __dadd_rn
__global__ void seq_dot(const double* a, const double* b, int n, int len,
                        int mode, double* out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const double* x = a + (size_t)s * len;
  const double* y = b + (size_t)s * len;
  double acc = 0.0;
  for (int i = 0; i < len; ++i) {
    if (mode == 0) acc += x[i] * y[i];
    else if (mode == 1) acc = __fma_rn(x[i], y[i], acc);
    else acc = __dadd_rn(acc, __dmul_rn(x[i], y[i]));
  }
  out[s] = acc;
}
extern "C" int probe_seq_dot(const void* a, const void* b, int n, int len,
                             int mode, void* out) {
  seq_dot<<<(n + 127) / 128, 128>>>((const double*)a, (const double*)b, n,
                                    len, mode, (double*)out);
  return cudaGetLastError();
}
extern "C" int probe_empty(void) {
  empty_kernel<<<1, 32>>>();
  return cudaGetLastError();
}
extern "C" int probe_roundtrips(int n) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32>>>();
    cudaError_t e = cudaStreamSynchronize(0);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}
"""


def build_probe(d):
    """The probe library, built in the directory `d` (kept open while the
    library is loaded)."""
    from ..utils import kernels
    src, lib = os.path.join(d, "probe.cu"), os.path.join(d, "libprobe.so")
    with open(src, "w") as f:
        f.write(PROBE_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    probe = C.CDLL(lib)
    for fn, args in (("probe_seq_dot", [C.c_void_p, C.c_void_p, C.c_int,
                                        C.c_int, C.c_int, C.c_void_p]),
                     ("probe_empty", []), ("probe_roundtrips", [C.c_int])):
        getattr(probe, fn).restype = C.c_int
        getattr(probe, fn).argtypes = args
    return probe


def bits_differ(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a.view(np.uint64) == b.view(np.uint64)) | (np.isnan(a)
                                                       & np.isnan(b))
    return int((~same).sum())


def elementwise(dev, rng):
    import torch
    n = 1 << 20
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = {"add": (ta + tb, a + b), "mul": (ta * tb, a * b),
           "div": (ta / tb, a / b),
           "sqrt": (torch.sqrt(ta.abs()), np.sqrt(np.abs(a)))}
    return {k: bits_differ(d.cpu().numpy(), h) for k, (d, h) in got.items()}


def host_seq(a, b, fma):
    """Each row's sum_i a_i b_i in order, from 0.0: IEEE double with one
    rounding a multiply and an add, or one a fused multiply-add."""
    out = np.zeros(len(a))
    for s in range(len(a)):
        acc = 0.0
        for x, y in zip(a[s].tolist(), b[s].tolist()):
            acc = float(Fraction(x) * Fraction(y) + Fraction(acc)) \
                if fma else acc + x * y
        out[s] = acc
    return out


def sequential(probe, rng):
    import torch
    n, length = 1024, 64
    a = rng.standard_normal((n, length)) * 10.0 ** rng.uniform(-3, 3,
                                                              (n, length))
    b = rng.uniform(0, 1, (n, length))
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    host = {"fma": host_seq(a, b, True), "no_fma": host_seq(a, b, False)}
    out = {}
    for mode, name in enumerate(("as_written", "fma_rn", "mul_add_rn")):
        r = torch.empty(n, dtype=torch.float64, device="cuda")
        err = probe.probe_seq_dot(ta.data_ptr(), tb.data_ptr(), n, length,
                                  mode, r.data_ptr())
        if err:
            raise RuntimeError(f"probe_seq_dot: CUDA error {err}")
        r = r.cpu().numpy()
        out[name] = {f"vs_host_{h}": bits_differ(r, v)
                     for h, v in host.items()}
    out["sequences"], out["terms"] = n, length
    out["host_fma_vs_no_fma"] = bits_differ(host["fma"], host["no_fma"])
    return out


def copy_gbps(pinned):
    import torch
    nbytes = 256 << 20
    h = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    h.fill_(1)
    d = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for name, fn in (("h2d", lambda: d.copy_(h, non_blocking=pinned)),
                     ("d2h", lambda: h.copy_(d, non_blocking=pinned))):
        t = common.timed(lambda: (fn(), torch.cuda.synchronize()), 5)
        out[name] = nbytes / t["best_s"] / 1e9
    return out


def roundtrip_us(probe):
    import torch
    n = 1000
    probe.probe_roundtrips(10)
    t0 = time.perf_counter()
    if probe.probe_roundtrips(n):
        raise RuntimeError("probe_roundtrips failed")
    c_loop = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        probe.probe_empty()
        torch.cuda.synchronize()
    py = (time.perf_counter() - t0) / n * 1e6
    return {"c_loop_us": c_loop, "python_us": py}


def event_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def rates(rng):
    import torch
    n = 64 << 20
    x = torch.from_numpy(rng.integers(0, 1000, n, dtype=np.int32)).cuda()
    y = torch.empty_like(x)
    ms = event_ms(lambda: torch.add(x, 7, out=y))
    m = 16 << 20
    idx = torch.from_numpy(rng.integers(0, n, m)).cuda()
    g = torch.empty(m, dtype=torch.int32, device="cuda")
    gms = event_ms(lambda: torch.index_select(x, 0, idx, out=g))
    return {"i32_stream_gbps": 8 * n / ms / 1e6, "i32_stream_ms": ms,
            "gather_per_s": m / gms * 1e3, "gather_ms": gms}


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0])
    args = p.parse_args(argv)
    common.setup(args)
    import torch
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    result = {"device": args.device,
              "f64_bit_mismatches_per_2^20": elementwise(dev, rng),
              "seq_accumulation": None, "copy_gbps_pinned": None,
              "copy_gbps_pageable": None, "empty_launch_roundtrip": None,
              "rates": None}
    if dev.type == "cuda":
        with common.scratch_dir() as work:
            probe = build_probe(work)
            result.update(
                seq_accumulation=sequential(probe, rng),
                copy_gbps_pinned=copy_gbps(True),
                copy_gbps_pageable=copy_gbps(False),
                empty_launch_roundtrip=roundtrip_us(probe), rates=rates(rng))
    result["f64_elementwise_bit_exact"] = not any(
        result["f64_bit_mismatches_per_2^20"].values())
    common.emit("device_character", args, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
