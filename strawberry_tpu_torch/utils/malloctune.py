"""glibc's heap policy for the host process, and what its heap holds.

History (the TPU host, a 2-vCPU firecracker VM): numpy routes large
temporaries through malloc; with glibc's defaults every allocation above
~128KB became its own mmap/munmap pair, and the page-fault storm spent
multiples of the compute time in the kernel (observed: 5.6s sys -> 0.3s on
the 1M-read workload once the mmap and trim thresholds were raised to
1 GiB, which keeps the arena heap warm so large buffers are reused).

On the H100's host a process that runs sample after sample (the benchmark's
warm cell, tools/bench.py, anyone embedding run_driver) kept growing under
that policy alone: the native pools start their threads anew every sample,
each new thread takes whichever of glibc's arenas is free (up to 8 a core),
and every arena keeps its own high-water mark, which malloc_trim does not
lower (it shrinks no arena's top but the main one's). On the 10M-read
paper set the peak grew from 6,832 MB after the first sample to 8,280
after fifteen, in 22 arenas holding 3,497 MB for 1,625 MB in use. The
policy now:

- M_ARENA_MAX 2 (ARENA_MAX), set before the pools start: every thread
  but the main one shares one arena, so what a sample freed is found
  again by the next. The benchmark's peak read 7,173-7,512 MB against the
  old policy's 8,039-8,358 (nine seeds, in turns), with 0.2-0.3 s less
  system CPU a sample; 8 arenas read 7,452-7,712.
- M_MMAP_THRESHOLD and M_TRIM_THRESHOLD 1 GiB, as before: large buffers
  come from the heap and stay there, no fault storm. Handing the freed
  heap back at every run (malloc_trim(0), 390-695 MB a sample) lowered
  that peak by 150 MB more but cost 0.3-0.4 s of system CPU a sample, in
  the faults that won the pages back; a trim threshold of 8 MiB cost
  1.2-1.5 s.

(PERF.md sections 5 and 6.) mallopt(3) applies at run time, so none of
this needs a re-exec or an environment variable.
"""
from __future__ import annotations

import ctypes
import os
import sys
from typing import Dict, Optional

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
M_ARENA_MAX = -8

THRESHOLD = 1 << 30
ARENA_MAX = 2

_done = False


def _libc():
    return ctypes.CDLL(None, use_errno=True)


def tune() -> bool:
    """Apply the policy above, once a process. Safe no-op on failure or
    non-glibc platforms. Returns True if applied."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        mallopt = _libc().mallopt
        mallopt.restype = ctypes.c_int
        mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        ok = mallopt(M_ARENA_MAX, ARENA_MAX) == 1
        ok = mallopt(M_MMAP_THRESHOLD, THRESHOLD) == 1 and ok
        ok = mallopt(M_TRIM_THRESHOLD, THRESHOLD) == 1 and ok
        _done = ok
        return ok
    except Exception:
        return False


def trim() -> bool:
    """malloc_trim(0): hand the free pages of every arena back to the OS,
    the main arena's top too but no other arena's. --low-mem calls it at
    its pass boundary, whose contract is to return memory."""
    try:
        libc = _libc()
        libc.malloc_trim.restype = ctypes.c_int
        libc.malloc_trim.argtypes = [ctypes.c_size_t]
        return bool(libc.malloc_trim(0))
    except Exception:
        return False


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def heap() -> Dict[str, Optional[float]]:
    """What the heap holds now, in MB (10^6 B), None where unreadable:
    resident_mb, statm's resident pages less its shared ones, which is
    RssAnon (on a host whose /proc counts no shared pages and gives no
    RssAnon, as the H100's did, the whole resident set); in_use_mb,
    malloc's bytes in use over every arena and mmap'd chunk (mallinfo2,
    glibc 2.33 on)."""
    out: Dict[str, Optional[float]] = {"resident_mb": None,
                                       "in_use_mb": None}
    try:
        with open("/proc/self/statm") as f:
            pages = f.read().split()
        out["resident_mb"] = (int(pages[1]) - int(pages[2])) * \
            os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        pass
    try:
        fn = _libc().mallinfo2
    except (OSError, AttributeError):
        return out
    fn.restype = _MallInfo2
    fn.argtypes = []
    m = fn()
    out["in_use_mb"] = (m.uordblks + m.hblkhd) / 1e6
    return out


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
