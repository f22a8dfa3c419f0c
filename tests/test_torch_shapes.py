"""The tools' named shapes (strawberry_tpu_torch/tools/common.py SHAPES)
and the strand each gives: the shapes are the JAX repo's bench sets
(read from bench.py and tools/bench_lowmem_scaling.py), a set the tools
generate records its shape beside it, a set whose shape is neither
recorded nor given is refused, and tools/realistic.py --shape easy (the
counterpart of tools/bench_10m.py) runs every mode with --rf, under the
jax / JAX-package import block, each body held against its host twin."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strawberry_tpu_torch.sim import make_dataset
from strawberry_tpu_torch.tools import common, realistic
from test_torch_realistic import run_tool


def make_dataset_kwargs(path, function):
    """The keyword arguments of the make_dataset call in `function` of the
    file at `path`, less the output directory and the fragment count."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == function]
    (call,) = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "make_dataset"]
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg != "n_frags"}


@pytest.mark.parametrize("shape,path,function,strand", [
    ("realistic", "bench.py", "dataset_realistic", "--fr"),
    ("easy", "bench.py", "dataset_10m", "--rf"),
    ("easy", "tools/bench_10m.py", "ensure_dataset", "--rf"),
    ("easy", "tools/bench_lowmem_scaling.py", "dataset", "--rf"),
    ("deep", "tools/bench_lowmem_scaling.py", "dataset_deep", "--rf"),
])
def test_shapes_are_the_jax_repo_sets(shape, path, function, strand):
    kwargs, flag = common.SHAPES[shape]
    assert kwargs == make_dataset_kwargs(path, function)
    assert flag == strand == "--" + kwargs["protocol"]


def write_record(d, shape, n):
    with open(os.path.join(d, common.SHAPE_FILE), "w") as f:
        json.dump({"shape": shape, "n_frags": n}, f)


@pytest.fixture(scope="module")
def unrecorded(tmp_path_factory):
    """A set of the easy shape (rf, no XS tag) with no record beside it."""
    d = tmp_path_factory.mktemp("unrecorded")
    make_dataset(str(d), n_frags=300, **common.EASY)
    return str(d)


@pytest.mark.parametrize("shape,given,want", [
    (None, True, SystemExit),          # neither recorded nor given
    ("easy", True, ("easy", "--rf", None)),
    ("small", True, ("small", "--fr", None)),
    (None, False, ("realistic", "--fr", 300)),   # a default directory
])
def test_resolve_without_a_record(unrecorded, shape, given, want):
    if want is SystemExit:
        with pytest.raises(SystemExit, match="no shape recorded"):
            common.resolve(unrecorded, shape, 300, given)
    else:
        ds = common.resolve(unrecorded, shape, 300, given)
        assert (ds.shape, ds.strand, ds.n_frags) == want


@pytest.mark.parametrize("shape", [None, "easy", "realistic"])
def test_resolve_reads_the_record(tmp_path, unrecorded, shape):
    d = tmp_path / "d"
    d.mkdir()
    for name in ("sample_01.sorted.bam", "annotation.gtf"):
        os.symlink(os.path.join(unrecorded, name), d / name)
    write_record(str(d), "easy", 300)
    if shape == "realistic":
        # the strand follows the record: an rf set never runs as --fr
        with pytest.raises(SystemExit, match="shape 'easy', not 'realistic'"):
            common.resolve(str(d), shape, 999, True)
    else:
        ds = common.resolve(str(d), shape, 999, True)
        assert (ds.shape, ds.strand, ds.n_frags) == ("easy", "--rf", 300)


def test_an_empty_directory_gets_the_shape_asked(tmp_path):
    ds = common.resolve(str(tmp_path), "deep", 500, True)
    assert (ds.shape, ds.strand, ds.n_frags) == ("deep", "--rf", 500)
    ds = common.resolve(str(tmp_path), None, 500, True)
    assert (ds.shape, ds.strand) == ("realistic", "--fr")


@pytest.mark.parametrize("tool", ["realistic", "em_crossover",
                                  "prep_crossover"])
def test_a_tool_refuses_a_set_without_a_shape(tmp_path, unrecorded, tool):
    """--data of a set whose shape is neither recorded nor given: the tool
    stops before any run and prints no line."""
    proc = subprocess.run(
        [sys.executable, "-m", f"strawberry_tpu_torch.tools.{tool}",
         "--device", "cpu", "--data", unrecorded], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items()
             if k not in common.ROUTING_VARS + ("STRAWB_PLATFORM",)})
    assert proc.returncode != 0
    assert "no shape recorded" in proc.stderr and "give --shape" in \
        proc.stderr
    assert not proc.stdout.strip()


def test_a_tool_refuses_a_shape_against_the_record(tmp_path):
    d = tmp_path / "d"
    common.generate(str(d), "easy", 300)
    proc = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu_torch.tools.prep_crossover",
         "--device", "cpu", "--data", str(d), "--shape", "realistic"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "not 'realistic'" in proc.stderr
    assert not proc.stdout.strip()


@pytest.fixture(scope="module")
def easy(tmp_path_factory):
    """tools/realistic.py --shape easy at 3,000 fragments, the set made by
    the tool itself into an empty --data directory."""
    tmp = tmp_path_factory.mktemp("easy")
    data = tmp / "data"
    proc, pids = run_tool(tmp, "--shape", "easy", "--n-frags", "3000",
                          "--data", str(data), "--reps", "1", "--warmup",
                          "0")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(pids) >= 1 + len(realistic.MODES)
    return json.loads(proc.stdout.strip().splitlines()[-1]), str(data)


def test_easy_set_is_made_and_recorded(easy):
    line, data = easy
    rec = common.recorded_shape(data)
    assert rec["shape"] == "easy" and rec["n_frags"] == 3000
    assert rec["strand"] == "--rf"
    assert (line["shape"], line["strand"], line["n_frags"]) == (
        "easy", "--rf", 3000)
    assert line["data"] == os.path.abspath(data)


def test_easy_line_has_reads_per_second_and_first_run_rss(easy):
    line, _data = easy
    assert line["baseline_reads_per_s"] == realistic.BASELINE_READS_PER_S
    reads = {m["reads"] for m in line["modes"].values()}
    # paired fragments: about two reads each, the same in every mode
    assert len(reads) == 1 and 5000 < reads.pop() <= 6000
    for name, m in line["modes"].items():
        assert m["reads_per_s"] == pytest.approx(m["reads"] / m["median_s"])
        assert m["vs_baseline"] == pytest.approx(
            m["reads_per_s"] / realistic.BASELINE_READS_PER_S)
        assert m["warm_reads_per_s"] == pytest.approx(
            m["reads"] / m["warm_median_s"])
        assert len(m["first_run_rss_mb"]) == len(m["start_rss_mb"]) == 1
        assert 0 < m["start_rss_mb"][0] <= m["first_run_rss_mb"][0] \
            <= m["max_rss_mb"][0], name


def test_easy_modes_hold_against_their_twins(easy):
    line, _data = easy
    twins = line["twins"]
    assert twins["g_low_mem"] == {"twin": "g_default", "rule": "bytes",
                                  "body_equal": True, "ok": True}
    for name, t in twins.items():
        assert t["ok"], (name, t)
    assert line["twins_ok"] is True
    modes = line["modes"]
    assert modes["g_r_device_em"]["em_stats"]["device"] > 0
    assert modes["g_mcf"]["flow_stats"]["device"] > 0
    assert modes["g_r_prep_all"]["prep_stats"]["device_loci"] > 0


def test_easy_set_runs_with_its_own_strand(easy, tmp_path, monkeypatch):
    """The tool's default -g -r body is the --rf run's, which differs from
    the same set run as --fr (the fault a fixed --fr hid: a twin pair run
    with the wrong strand still agrees)."""
    from strawberry_tpu_torch import cli
    line, data = easy
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    for k in common.ROUTING_VARS:
        monkeypatch.delenv(k, raising=False)
    bam, gtf = common.set_paths(data)
    digests = {}
    for strand in ("--rf", "--fr"):
        out = str(tmp_path / f"{strand[2:]}.gtf")
        assert cli.main(["-g", gtf, "-r", strand, "-o", out, "-T",
                         out[:-4] + ".log", bam]) == 0
        digests[strand] = common.digest(out)
    assert digests["--rf"] != digests["--fr"]
    assert line["modes"]["g_r_default"]["body_sha256"] == digests["--rf"]
