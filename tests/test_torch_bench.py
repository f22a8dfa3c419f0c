"""strawberry_tpu_torch/tools/bench.py (the counterpart of the JAX repo's
bench.py) on the CPU, at a few thousand fragments: the tool runs with jax
and the JAX package blocked from import; its last line is bench.py's
record with the port's fields, each set's reads are a run's own, the f32
route reaches the device route (the plain version here), a corrupted
--fast-em body fails the tool, and the quick shape carries no strand
flag."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strawberry_tpu_torch.tools import bench, common
from test_torch_realistic import BLOCK
from test_torch_shapes import make_dataset_kwargs

N = 3000
# bench.py's record (bench.py:167-189) less the TPU-era fast_em text's
# meaning, and the port's own fields
KEYS = {"metric", "value", "unit", "vs_baseline", "dataset", "wall_s",
        "peak_rss_mb", "device_frac", "easy_10m", "reads_per_sec_1m",
        "fast_em_reads_per_sec_1m", "fast_em_mode", "fast_em_device_frac",
        "fast_em_tpm_p99_rel_err", "card", "cold_wall_s",
        "fast_em_f32_reads_per_sec_1m", "fast_em_f32_device_frac",
        "fast_em_f32_tpm_p99_rel_err", "reads"}


def run_tool(tmp, module, *argv, device=("--device", "cpu")):
    """The tool in a subprocess whose imports of jax and the JAX package
    fail (as tests/test_torch_realistic.py blocks them)."""
    block = tmp / "block"
    block.mkdir(exist_ok=True)
    (block / "sitecustomize.py").write_text(BLOCK)
    env = {k: v for k, v in os.environ.items()
           if k not in common.ROUTING_VARS + ("STRAWB_PLATFORM",)}
    env["PYTHONPATH"] = str(block)
    return subprocess.run([sys.executable, "-m", module, *device, *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_sets")


@pytest.fixture(scope="module")
def line(tmp_path_factory, data_dir):
    tmp = tmp_path_factory.mktemp("bench")
    proc = run_tool(tmp, "strawberry_tpu_torch.tools.bench", "--n-frags",
                    str(N), "--quick-frags", str(N), "--data-dir",
                    str(data_dir))
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout.strip().splitlines()[-1]
    assert text.startswith('{"card": "cpu", "tool": "bench"')
    return json.loads(text)


def test_line_is_bench_py_record(line):
    assert KEYS <= set(line)
    assert line["metric"] == "aligned_reads_per_sec_assembly_quant"
    assert line["unit"] == "reads/s/chip"
    assert line["value"] == line["reads"]["realistic"] / line["wall_s"]
    assert line["vs_baseline"] == line["value"] / 83_000.0
    assert set(line["easy_10m"]) == {"reads_per_sec", "vs_baseline",
                                     "wall_s"}
    sets = {"realistic", "easy", "quick"}
    assert set(line["reads"]) == sets
    routes = sets | {"quick_fast_em", "quick_fast_em_f32"}
    assert set(line["cold_wall_s"]) == routes
    for route, n in dict.fromkeys(routes, 3).items():
        n = bench.REPS.get(route, n)
        assert len(line["walls_s"][route]) == n
        assert all(w > 0 for w in line["walls_s"][route])
    assert line["wall_s"] == min(line["walls_s"]["realistic"])
    # the realistic warm-up is the process's first run: its first import
    # torch is in it
    assert line["cold_wall_s"]["realistic"] > line["wall_s"]
    # the TPU-era benchmarks/*.json fields are not carried
    assert not {"realistic_golden", "lowmem_scaling"} & set(line)
    assert line["peak_rss_mb"] > 0 and line["device_frac"] == 0


@pytest.mark.parametrize("shape", ["realistic", "easy", "quick"])
def test_reads_are_a_run_own(line, data_dir, shape):
    n = N
    ds = common.datasets([(shape, n)], str(data_dir))[shape, n]
    runs = bench.run_route(ds, [], 1)
    assert line["reads"][shape] == len(runs.sample.table)


def test_f32_route_reaches_the_device(line):
    checks = line["checks"]
    assert line["checks_ok"] is True
    assert checks["fast_em_body_equals_default"] is True
    assert line["fast_em_device_frac"] == 0
    assert line["fast_em_tpm_p99_rel_err"] == 0
    assert line["fast_em_f32_device_frac"] > 0
    assert checks["fast_em_f32_device_problems"] > 0
    assert 0 < line["fast_em_f32_tpm_p99_rel_err"] <= common.TPM_P99_MAX
    assert line["em_stats_1m"]["fast_em_f32"]["tiers"][0] > 0


def test_corrupted_fast_em_body_fails(data_dir, monkeypatch, capsys):
    """A --fast-em run at the default bound whose GTF differs from the
    default's in one TPM makes the tool exit 1; --quick-only takes the
    quick set's default for the value."""
    run_route = bench.run_route

    def corrupting(ds, extra, reps, capture=False):
        runs = run_route(ds, extra, reps, capture)
        if extra == ["--fast-em"] and "STRAWB_FASTEM_AFTER" not in \
                os.environ:
            i = runs.text.index('TPM "') + len('TPM "')
            runs = runs._replace(text=runs.text[:i] + "9" + runs.text[i:])
        return runs
    monkeypatch.setattr(bench, "run_route", corrupting)
    # main() routes this process to the CPU and clears the routing
    # variables (common.setup); each is restored at the end
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    for k in common.ROUTING_VARS:
        monkeypatch.delenv(k, raising=False)
    rc = bench.main(["--device", "cpu", "--quick-only", "--quick-frags",
                     str(N), "--data-dir", str(data_dir)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and out["checks_ok"] is False
    assert out["checks"]["fast_em_body_equals_default"] is False
    assert out["checks"]["fast_em_f32_tpm"]["ok"] is True
    assert out["value"] == out["reads_per_sec_1m"]
    assert set(out["reads"]) == {"quick"} and out["easy_10m"] == {}


def test_quick_shape_is_bench_py_dataset_1m():
    kwargs, flag = common.SHAPES["quick"]
    assert kwargs == make_dataset_kwargs("bench.py", "dataset_1m")
    assert flag is None   # bench.py:153 passes no strand flag


@pytest.mark.parametrize("shape,flags", [("quick", []),
                                         ("realistic", ["--fr"]),
                                         ("easy", ["--rf"])])
def test_sets_record_their_strand(line, data_dir, shape, flags):
    """A quick set records no strand flag; a realistic or easy one keeps
    its flag."""
    with open(os.path.join(data_dir, f"{shape}_{N}", common.SHAPE_FILE)) as f:
        rec = json.load(f)
    assert rec["shape"] == shape
    assert rec["strand"] == (flags[0] if flags else None)
    ds = common.resolve(os.path.join(data_dir, f"{shape}_{N}"), None, 0,
                        given=True)
    assert ds.flags == flags


def test_sets_are_indexed_before_a_run(line, data_dir):
    """Every set the tool runs has its annotation's index written
    beforehand (common.index), so no timed run writes it; a set on disk
    without one gets it again."""
    from strawberry_tpu_torch.io import gff
    for shape in ("realistic", "easy", "quick"):
        gtf = common.set_paths(os.path.join(data_dir, f"{shape}_{N}"))[1]
        assert gff._load_sidecar(gtf) is not None, shape
    os.remove(gff._sidecar_path(gtf))
    common.datasets([("quick", N)], str(data_dir))
    assert gff._load_sidecar(gtf) is not None


def test_no_card_no_fallback(tmp_path):
    """On --device cuda (the default) without a card the tool stops at its
    start and prints no record."""
    proc = run_tool(tmp_path, "strawberry_tpu_torch.tools.bench",
                    "--quick-only", "--data-dir", str(tmp_path / "sets"),
                    device=())
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""
    assert not os.path.exists(tmp_path / "sets")
