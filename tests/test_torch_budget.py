"""strawberry_tpu_torch/tools/budget.py (the counterpart of the JAX repo's
tools/budget_50x.py) on the CPU, at 3,000 fragments: run with jax and the
JAX package blocked from import, it accounts the host's CPU by phase and
by native hot path, runs -p 1 and -p 2 with equal bodies, and reads every
memory-floor probe; empty native counters raise, the offload bound is read
only from a run of tools/device_character.py on the card, and on --device
cuda without a card nothing runs."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strawberry_tpu_torch.sim import make_dataset
from strawberry_tpu_torch.tools import budget, common
from strawberry_tpu_torch.utils import profiling
from test_torch_bench import run_tool

PROBES = {"python_pass", "import_torch", "import_torch_one_tensor",
          "host_library", "cli_small", "cli_small_platform_cpu",
          "cli_small_malloc_arena_max_2"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("budget_data")
    make_dataset(str(d), n_frags=3000, **common.SMALL)
    return str(d)


@pytest.fixture(scope="module")
def line(tmp_path_factory, small):
    tmp = tmp_path_factory.mktemp("budget")
    proc = run_tool(tmp, "strawberry_tpu_torch.tools.budget", "--data",
                    small, "--shape", "small", "--p", "1,2", "--p-reps",
                    "1", "--data-dir", str(tmp / "sets"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout.strip().splitlines()[-1]
    assert text.startswith('{"card": "cpu", "tool": "budget"')
    return json.loads(text)


def test_line_has_budget_50x_keys(line):
    assert {"reads", "host_cores", "host_cores_usable", "wall_s",
            "reads_per_sec", "vs_baseline", "cpu_user_s", "cpu_sys_s",
            "total_cpu_s", "cpu_bound_wall_floor_s", "phase_wall_s",
            "phase_thread_cpu_s", "native_thread_cpu_s", "cpu_accounting",
            "targets", "verdict", "cold_phase_wall_s", "p_scaling",
            "memory_floor", "chip_offload_bound"} <= set(line)
    assert line["host_cores_usable"] == len(os.sched_getaffinity(0))
    assert line["cpu_bound_wall_floor_s"] == (
        line["total_cpu_s"] / line["host_cores_usable"])
    assert line["reads"] > 0 and line["vs_baseline"] == (
        line["reads_per_sec"] / 83_000.0)


def test_cpu_is_accounted(line):
    native = line["native_thread_cpu_s"]
    assert native and any(v > 0 for v in native.values())
    assert set(native) >= {"inflate", "bam_parse", "quant_prep"}
    acc = line["cpu_accounting"]
    top = sum(line["phase_thread_cpu_s"].get(k, 0.0)
              for k in budget.TOP_LEVEL)
    assert acc["top_level_phase_thread_cpu_s"] == top > 0
    assert line["total_cpu_s"] >= 0.95 * top
    assert acc["sum_native_outer_thread_cpu_s"] == sum(
        v for k, v in native.items() if k not in budget.NESTED)
    assert set(budget.NESTED.values()) <= set(native)
    assert {"pass1_assemble", "pass2_quant"} <= set(line["phase_wall_s"])


def test_cold_run_holds_the_first_import_torch(line):
    cold = line["cold_phase_wall_s"]
    assert set(cold) >= {"pass1_assemble", "pass2_quant"}
    diff = line["cold_minus_warm_phase_wall_s"]
    assert diff["pass2_quant"] == (cold["pass2_quant"]
                                   - line["phase_wall_s"]["pass2_quant"])
    assert diff["pass2_quant"] > 0
    assert line["cold_wall_s"] > line["wall_s"]


def test_cli_path_is_accounted(line):
    """The same accounting on cli.main's path (a log file: not run_driver's
    null-log path), cold and warm, on the same set's reads."""
    cli = line["cli_path"]
    assert cli["reads"] == line["reads"]
    assert cli["native_thread_cpu_s"] and cli["total_cpu_s"] > 0
    top = sum(cli["phase_thread_cpu_s"].get(k, 0.0)
              for k in budget.TOP_LEVEL)
    assert cli["total_cpu_s"] >= 0.95 * top > 0
    assert {"pass1_assemble", "pass2_quant"} <= set(cli["phase_wall_s"])
    assert cli["cold_wall_s"] > cli["wall_s"]
    assert cli["cold_minus_warm_phase_wall_s"]["pass2_quant"] > 0
    assert cli["cpu_bound_wall_floor_s"] == (
        cli["total_cpu_s"] / line["host_cores_usable"])


def test_p_rows_have_equal_bodies(line):
    rows = line["p_scaling"]
    assert set(rows) == {"p1", "p2"}
    for row in rows.values():
        assert row["body_equals_reference"] is True
        assert len(row["walls_s"]) == 1 and row["median_s"] > 0
    assert line["p_bodies_equal"] is True


def test_every_memory_probe_reads(line):
    floor = line["memory_floor"]
    assert set(floor) == PROBES
    for name, row in floor.items():
        assert row["peak_rss_mb"] > 0 and row["wall_s"] > 0, name
    # the tool's own process stays small: it imports no torch
    assert line["tool_peak_rss_mb"] < floor["import_torch"]["peak_rss_mb"]
    assert floor["python_pass"]["peak_rss_mb"] < floor["cli_small"][
        "peak_rss_mb"]


def test_targets_arithmetic():
    acc = {"reads": 8_300_000, "wall_s": 10.0, "cpu_user_s": 30.0,
           "cpu_sys_s": 10.0, "phase_wall_s": {},
           "phase_thread_cpu_s": {"pass2_quant": 5.0},
           "native_thread_cpu_s": {"inflate": 1.0}}
    out = budget.budget(acc, 8)
    t50 = out["targets"]["50x"]
    assert t50["required_wall_s"] == pytest.approx(2.0)
    assert t50["cores_needed_at_current_per_read_cost"] == pytest.approx(20)
    assert t50["or_work_reduction_factor_on_this_host"] == pytest.approx(2.5)
    assert out["cpu_bound_wall_floor_s"] == 5.0
    assert out["cpu_accounting"]["top_level_phase_thread_cpu_s"] == 5.0


def test_empty_native_counters_raise(small, monkeypatch):
    monkeypatch.setattr(profiling, "native_counters", lambda reset=False: {})
    # account() turns the phase timer on: restored at the end
    monkeypatch.setattr(profiling.GLOBAL, "enabled", False)
    monkeypatch.setattr(profiling.GLOBAL, "phases", {})
    bam, gtf = common.set_paths(small)
    with pytest.raises(RuntimeError, match="native_counters"):
        budget.account(["-g", gtf, "-r", "--fr", bam])


def test_offload_bound_only_from_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    bound, note = budget.offload_bound()
    assert bound is None and "device_character" in note
    path = tmp_path / "device_character.json"
    path.write_text(json.dumps({"card": "cpu", "copy_gbps_pinned": None}))
    assert budget.offload_bound()[0] is None
    path.write_text(json.dumps({
        "card": "H, 700 W", "copy_gbps_pinned": {"h2d": 50.0, "d2h": 40.0},
        "copy_gbps_pageable": {"h2d": 10.0, "d2h": 8.0},
        "empty_launch_roundtrip": {"c_loop_us": 5.0, "python_us": 9.0}}))
    bound, _note = budget.offload_bound()
    assert bound["h2d_gbps_pinned"] == 50.0
    assert bound["d2h_gbps_pageable"] == 8.0
    assert bound["empty_launch_roundtrip_us"]["c_loop_us"] == 5.0
    assert bound["card"] == "H, 700 W"


def test_no_card_no_fallback(tmp_path, small):
    proc = run_tool(tmp_path, "strawberry_tpu_torch.tools.budget", "--data",
                    small, "--shape", "small", device=())
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""
