"""strawberry_tpu_torch/tools/lowmem_scaling.py (the counterpart of the JAX
repo's tools/bench_lowmem_scaling.py) on the CPU at two tiny easy sizes
and one deep size: its rows and keys, each mode alone in a fresh process,
and every --low-mem body equal to the default's; then the port's CLI
against the JAX CLI on the deep shape (every read on one chromosome) with
`-g --rf --low-mem`, GTF body and -T log byte for byte."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strawberry_tpu_torch.tools import common, lowmem_scaling
from test_torch_modes import PACKAGES, run_package
from test_torch_pipeline import body, read

EASY_SIZES, DEEP_SIZE = (2000, 4000), 3000


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    root = tmp_path_factory.mktemp("lowmem")
    proc = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu_torch.tools.lowmem_scaling",
         "--device", "cpu", "--sizes", ",".join(map(str, EASY_SIZES)),
         "--deep-sizes", str(DEEP_SIZE), "--data-dir", str(root)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items()
             if k not in common.ROUTING_VARS + ("STRAWB_PLATFORM",)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout.strip().splitlines()[-1]
    assert text.startswith('{"card": "cpu", "tool": "lowmem_scaling"')
    return json.loads(text), str(root)


def test_rows_and_keys(scaling):
    line, _root = scaling
    assert line["device"] == "cpu" and set(line["shapes"]) == {"easy",
                                                               "deep"}
    easy, deep = line["shapes"]["easy"], line["shapes"]["deep"]
    assert [r["frags"] for r in easy["rows"]] == list(EASY_SIZES)
    assert [r["frags"] for r in deep["rows"]] == [DEEP_SIZE]
    for r in easy["rows"] + deep["rows"]:
        assert {"frags", "reads", "bam_mb", "annotation_sha256", "low_mem",
                "default", "body_equal", "low_mem_saving_mb"} <= set(r)
        # paired fragments: about two reads each
        assert 1.9 * r["frags"] < r["reads"] <= 2 * r["frags"]
        assert r["bam_mb"] > 0
        for mode in ("low_mem", "default"):
            m = r[mode]
            assert m["wall_s"] > 0
            assert 0 < m["start_rss_mb"] <= m["peak_rss_mb"]
            # the default route sends nothing to the card
            assert m["cuda_initialized"] is False
        assert r["low_mem_saving_mb"] == pytest.approx(
            r["default"]["peak_rss_mb"] - r["low_mem"]["peak_rss_mb"])
    g = easy["last_growth"]
    assert g["frags_ratio"] == 2.0
    assert set(g) == {"frags_ratio", "low_mem_pct", "default_pct"}
    assert deep["last_growth"] is None


def test_one_annotation_at_every_size(scaling):
    line, _root = scaling
    easy = line["shapes"]["easy"]
    assert easy["same_annotation"] is True
    assert len({r["annotation_sha256"] for r in easy["rows"]}) == 1
    deep = line["shapes"]["deep"]["rows"][0]["annotation_sha256"]
    assert deep != easy["rows"][0]["annotation_sha256"]


@pytest.mark.parametrize("shape,n", [("easy", n) for n in EASY_SIZES]
                         + [("deep", DEEP_SIZE)])
def test_low_mem_body_equals_the_default(scaling, shape, n):
    line, _root = scaling
    (r,) = [r for r in line["shapes"][shape]["rows"] if r["frags"] == n]
    assert r["body_equal"] is True
    assert line["bodies_equal"] is True


@pytest.mark.parametrize("shape,n", [("easy", n) for n in EASY_SIZES]
                         + [("deep", DEEP_SIZE)])
def test_sets_are_made_and_recorded(scaling, shape, n):
    _line, root = scaling
    d = common.set_dir(shape, n, root)
    rec = common.recorded_shape(d)
    assert rec["shape"] == shape and rec["n_frags"] == n
    assert rec["strand"] == "--rf"
    assert all(os.path.getsize(p) > 0 for p in common.set_paths(d))


def test_growth_is_over_the_last_two_rows():
    rows = [{"frags": 10, "low_mem": {"peak_rss_mb": 100.0},
             "default": {"peak_rss_mb": 200.0}},
            {"frags": 20, "low_mem": {"peak_rss_mb": 110.0},
             "default": {"peak_rss_mb": 300.0}}]
    g = lowmem_scaling.growth(rows)
    assert g["frags_ratio"] == 2.0
    assert g["low_mem_pct"] == pytest.approx(10.0)
    assert g["default_pct"] == pytest.approx(50.0)
    assert lowmem_scaling.growth(rows[:1]) is None


def test_deep_low_mem_run_is_the_jax_cli_run(scaling, tmp_path):
    """The port's `-g --rf --low-mem` on the deep shape (one chromosome,
    sub-chromosome blocks) against the JAX CLI's: GTF body and -T log
    byte for byte."""
    _line, root = scaling
    bam, gtf = common.set_paths(common.set_dir("deep", DEEP_SIZE, root))
    outs = {}
    for pkg in PACKAGES:
        stem = outs[pkg] = str(tmp_path / pkg)
        run_package(pkg, [["-g", gtf, "--rf", "--low-mem", "-o",
                           stem + ".gtf", "-T", stem + ".log", bam]],
                    stem + ".stderr")
    jax_out, port_out = (outs[pkg] for pkg in PACKAGES)
    want = body(jax_out + ".gtf")
    assert want.count("\ttranscript\t") > 0
    assert body(port_out + ".gtf") == want
    assert read(port_out + ".log") == read(jax_out + ".log")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_tool_process_imports_no_torch(device):
    """The tools that start CLI processes (and read their peak RSS) import
    no torch themselves, the CUDA check included (in a process of its
    own): on the card's machine a child's peak starts at its parent's."""
    code = ("import sys; from types import SimpleNamespace; "
            "from strawberry_tpu_torch.tools import common, lowmem_scaling, "
            "prep_crossover, realistic\n"
            "try:\n"
            f"    common.setup(SimpleNamespace(device={device!r}))\n"
            "except SystemExit as e:\n"
            "    print('refused', e)\n"
            "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"
