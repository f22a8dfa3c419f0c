"""glibc malloc tuning for numpy-heavy host phases.

numpy routes large temporaries through malloc; with glibc defaults every
allocation above ~128KB becomes its own mmap/munmap pair, and under
virtualized hosts (firecracker) the resulting page-fault storm can spend
multiples of the actual compute time in the kernel (observed: 5.6s sys ->
0.3s on the 1M-read workload). Raising the mmap/trim thresholds keeps the
arena heap warm so large buffers are reused instead of re-faulted.

mallopt(3) applies at runtime, so this works without re-exec or env vars.
"""
from __future__ import annotations

import ctypes
import sys

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune(threshold: int = 1 << 30) -> bool:
    """Raise glibc's dynamic mmap/trim thresholds. Safe no-op on failure
    or non-glibc platforms. Returns True if applied."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
        mallopt.restype = ctypes.c_int
        mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        ok = mallopt(M_MMAP_THRESHOLD, threshold) == 1
        ok = mallopt(M_TRIM_THRESHOLD, threshold) == 1 and ok
        _done = ok
        return ok
    except Exception:
        return False


def trim() -> bool:
    """malloc_trim(0): hand freed arena pages back to the OS. Used by
    --low-mem at phase boundaries — tune() deliberately disables automatic
    trimming for speed, which otherwise leaves transient pass-1 spikes
    resident for the rest of the run."""
    try:
        libc = ctypes.CDLL(None)
        libc.malloc_trim.restype = ctypes.c_int
        libc.malloc_trim.argtypes = [ctypes.c_size_t]
        return bool(libc.malloc_trim(0))
    except Exception:
        return False


_gc_done = False


def tune_gc(threshold0: int = 100_000) -> None:
    """Raise CPython's gen-0 GC threshold and freeze the import-time heap.

    The pipeline allocates millions of short-lived tuples/feature lists;
    at the default gen-0 threshold (700) a realistic 10M-read run triggers
    ~2.8k collections, each also walking jax's gc callback (~0.4s of pure
    callback time, plus the collector's own scan). The pipeline's object
    graphs are acyclic (dataclasses holding ints/arrays), so collections
    recover nothing on the hot path — raise the threshold and park the
    already-imported module graph in the permanent generation."""
    global _gc_done
    if _gc_done:
        return
    import gc
    gc.collect()
    gc.freeze()
    gc.set_threshold(threshold0, 20, 20)
    _gc_done = True


_blas_done = False


def cap_blas_threads(n: int = 1) -> bool:
    """Pin numpy's OpenBLAS pool to one thread. The tiny dgemv/dgemm calls
    in this pipeline never benefit from BLAS threading, but OpenBLAS's
    spin-waiting blas_thread_server threads burn a measurable slice of the
    2-vCPU host (gprofng: ~30% of sampled CPU). Runtime call, so it works
    after numpy is already imported."""
    global _blas_done
    if _blas_done:
        return True
    try:
        import glob
        import os
        import numpy
        pats = [os.path.join(os.path.dirname(numpy.__file__), "..",
                             "numpy.libs", "libscipy_openblas*"),
                os.path.join(os.path.dirname(numpy.__file__), "..",
                             "numpy.libs", "libopenblas*")]
        for pat in pats:
            for so in glob.glob(pat):
                lib = ctypes.CDLL(so)
                for sym in ("scipy_openblas_set_num_threads64_",
                            "openblas_set_num_threads64_",
                            "openblas_set_num_threads"):
                    fn = getattr(lib, sym, None)
                    if fn is not None:
                        fn.argtypes = [ctypes.c_int]
                        fn.restype = None
                        fn(n)
                        _blas_done = True
                        return True
        return False
    except Exception:
        return False
