"""The host process's glibc heap policy (strawberry_tpu_torch/utils/
malloctune.py) and the heap counter of run_driver: the mallopt calls tune()
makes, recorded through a stub, and three cli.main runs back to back in this
process on a small portbench.gen set, each reporting the heap at its start
and end in the -v report and on the trace's heap range."""
import glob
import json
import os

import numpy.ctypeslib  # noqa: F401  (bound before the runs' threads)
import pytest

from portbench import gen
from strawberry_tpu_torch import cli
from strawberry_tpu_torch.utils import malloctune, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAP_KEYS = ("start_resident_mb", "start_in_use_mb", "end_resident_mb",
             "end_in_use_mb")


class FakeLibc:
    """Records mallopt(param, value) and accepts each, as glibc does."""

    def __init__(self):
        self.calls = []

        class Fn:
            def __call__(fn, param, value):
                self.calls.append((param, value))
                return 1
        self.mallopt = Fn()


def test_tune_applies_the_documented_policy_once(monkeypatch):
    """Two arenas, and the mmap and trim thresholds at 1 GiB (the module's
    docstring), set once a process."""
    fake = FakeLibc()
    monkeypatch.setattr(malloctune, "_libc", lambda: fake)
    monkeypatch.setattr(malloctune, "_done", False)
    assert malloctune.tune() is True
    assert fake.calls == [(-8, 2), (-3, 1 << 30), (-1, 1 << 30)]
    assert (malloctune.M_ARENA_MAX, malloctune.M_MMAP_THRESHOLD,
            malloctune.M_TRIM_THRESHOLD) == (-8, -3, -1)
    assert malloctune.tune() is True
    assert len(fake.calls) == 3
    doc = malloctune.__doc__
    assert "M_ARENA_MAX 2 (ARENA_MAX)" in doc and malloctune.ARENA_MAX == 2
    assert "M_MMAP_THRESHOLD and M_TRIM_THRESHOLD 1 GiB" in doc


def test_heap_reads_resident_and_in_use_mb():
    """heap() reads the anonymous resident set and malloc's bytes in use,
    each a positive number of MB (glibc on Linux); a buffer of 64 MB
    malloc'd and touched shows in both, and is gone from in-use once
    freed."""
    import ctypes
    libc = ctypes.CDLL(None)
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    # hand back the free pages an earlier test of this process left in
    # malloc's arenas (tune()'s 1-GiB trim threshold keeps them), so that
    # the block below is touched fresh and not reused already resident
    libc.malloc_trim(0)
    before = malloctune.heap()
    assert set(before) == {"resident_mb", "in_use_mb"}
    assert all(isinstance(v, float) and v > 0 for v in before.values())
    n = 64 << 20
    p = libc.malloc(n)
    try:
        ctypes.memset(p, 1, n)
        held = malloctune.heap()
    finally:
        libc.free(p)
    after = malloctune.heap()
    assert held["in_use_mb"] - before["in_use_mb"] >= n / 1e6 * 0.99
    assert held["resident_mb"] - before["resident_mb"] >= n / 1e6 * 0.9
    assert after["in_use_mb"] - before["in_use_mb"] < 1


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "paper_scale_rf.json")) as f:
        cfg = json.load(f)
    cfg.update(n_frags=3000, n_chroms=2)
    d = str(tmp_path_factory.mktemp("heapset"))
    gen.write_set(cfg, 2 ** 31 + 17, d)
    return d, cfg


def body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("#"))


def test_back_to_back_runs_report_the_heap(small_set, tmp_path, monkeypatch,
                                           capsys):
    """Three -v runs of cli.main in one process: the same GTF body each
    time, and each reports its heap: the -v report's line and the args of
    the heap range in its trace, start and end figures present and
    none negative."""
    d, cfg = small_set
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    monkeypatch.delenv("STRAWB_VERBOSE", raising=False)
    monkeypatch.setattr(profiling.GLOBAL, "enabled", False)
    monkeypatch.setattr(profiling.GLOBAL, "phases", {})
    bodies = []
    for k in range(3):
        trace_dir = str(tmp_path / f"trace{k}")
        monkeypatch.setattr(profiling.GLOBAL, "_trace_dir", trace_dir)
        out = str(tmp_path / f"run{k}.gtf")
        assert cli.main([os.path.join(d, "sample.bam"), "-g",
                         os.path.join(d, "annotation.gtf"), "-r", "--rf",
                         "-v", "-i", f"{cfg['frag_mean']}/{cfg['frag_sd']}",
                         "-o", out, "-T", out[:-4] + ".log"]) == 0
        bodies.append(body(out))
        heap = dict(profiling.GLOBAL.heap)
        assert set(heap) == set(HEAP_KEYS)
        assert all(isinstance(v, float) and v >= 0 for v in heap.values()), \
            heap
        assert heap["end_resident_mb"] > 0 and heap["end_in_use_mb"] > 0
        report = [ln for ln in capsys.readouterr().err.splitlines()
                  if ln.strip().startswith("heap MB:")]
        assert report == [
            f"  heap MB: start resident {heap['start_resident_mb']:,.1f} in "
            f"use {heap['start_in_use_mb']:,.1f}; end resident "
            f"{heap['end_resident_mb']:,.1f} in use "
            f"{heap['end_in_use_mb']:,.1f}"]
        [path] = glob.glob(os.path.join(trace_dir, "*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges = [e for e in events if e.get("name") == "heap"
                  and e.get("cat") == "user_annotation"]
        assert len(ranges) == 1
        assert {n: ranges[0]["args"][n] for n in HEAP_KEYS} == heap
    assert bodies[0] and bodies[0] == bodies[1] == bodies[2]
