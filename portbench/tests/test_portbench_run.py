"""The harness on the CPU (its test mode: the port's plain versions, a few
thousand fragments), its window, and what it refuses to do."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import run as harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in
         json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
SMALL = ["--frags", "3000", "--chroms", "2"]


def bench(*args, check=True):
    p = subprocess.run([sys.executable, "-m", "portbench.run", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, STRAWB_PLATFORM="cpu"))
    if check:
        assert p.returncode == 0, p.stderr[-3000:]
    return p


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(cell, trace):
    p = bench("--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds",
              "1", "--trace", str(trace), "--cpu-test", *SMALL)
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(res) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    # each number compared is printed beside its limit, last on stderr
    tail = p.stderr.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "limit" in line
               for line in tail)


def test_traced_run_reads_cpu_off_the_profiler():
    """A traced run traces every other sample, the first among them, and
    reads the host's CPU on the others; the native pools' CPU, the outer
    counters alone, is a part of the process's."""
    p = bench("--workload", CELLS[0], "--seed", "7", "--seconds", "3",
              "--trace", "1", "--cpu-test", *SMALL)
    res = json.loads(p.stdout.strip().splitlines()[-1])
    lines = [ln for ln in p.stderr.splitlines()
             if ln.startswith("portbench: sample ")]
    assert res["attempted"] == len(lines) >= 2
    assert all((" traced:" in ln) == (k % 2 == 0)
               for k, ln in enumerate(lines))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["native_cpu_s"] <= m["host_cpu_s"]
    assert m["sample_reads_per_s"] > 0


def test_sample_rate_reads_the_untraced_samples():
    from portbench.metrics import sample_reads_per_s
    S = harness.Sample
    run = harness.Run(samples=[
        S(2.0, 100, True, "", 1.0, None, traced=True),
        S(1.0, 100, True, "", 1.0, None),
        S(3.0, 100, True, "", 1.0, None)])
    assert sample_reads_per_s.read(run) == 50.0
    run.samples = run.samples[:1]
    assert sample_reads_per_s.read(run) is None


def test_nested_counters_are_not_summed():
    counters = {"cluster_scan": 4.0, "cluster_collapse": 1.0,
                "cluster_emit": 0.5, "quant_prep": 2.0, "quant_weights": 1.5,
                "bam_parse": 3.0}
    assert harness.native_outer(counters) == 9.0


def test_no_card_no_result():
    """A measurement run (no --cpu-test) on a machine without a card exits
    non-zero and prints no result."""
    p = bench("--workload", CELLS[0], "--seed", "3", "--seconds", "1",
              "--trace", "0", *SMALL, check=False)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("walls,seconds,n", [
    ([4.0] * 10, 10.0, 2),    # a third would end at 12 s
    ([3.0] * 10, 9.0, 3),     # the third ends at 9 s exactly
    ([20.0], 5.0, 1),         # the first always runs
    ([1.0, 5.0, 1.0] * 4, 7.5, 2),
])
def test_window_holds_whole_samples(walls, seconds, n):
    clock = Clock()

    def one(k):
        clock.t += walls[k]
        return harness.Sample(walls[k], 100, True, "", 0.0, None)
    samples, span = harness.window(one, seconds, clock)
    assert len(samples) == n
    assert span == pytest.approx(sum(walls[:n]))


def test_window_ends_at_a_failed_sample():
    clock = Clock()

    def one(k):
        clock.t += 1.0
        return harness.Sample(1.0, 100, k != 1, "", 0.0, None)
    samples, _ = harness.window(one, 100.0, clock)
    assert [s.ok for s in samples] == [True, False]


def test_forbidden_names_are_whole():
    sys.modules["strawberry_tpu"] = sys.modules["portbench"]
    try:
        assert harness.forbidden_modules() == ["strawberry_tpu"]
    finally:
        del sys.modules["strawberry_tpu"]
    assert "strawberry_tpu_torch" not in harness.FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"strawberry_tpu_torch", "torch", *harness.FORBIDDEN}


def test_alone_it_exits_without_a_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, there is no
    program to run: non-zero, no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
