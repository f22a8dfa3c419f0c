"""The port's routing defaults (strawberry_tpu_torch/routing.py) and the
tools that set them from the card (strawberry_tpu_torch/tools/), on the
CPU: every default mode takes the host route on "cpu", and on "cuda"
(read here without a GPU) each default is routing.py's constant; each
environment variable overrides it as in the JAX package; the readers
(EmDispatcher, the prep route, batched_mcf) take the constants; and each
tool runs with --device cpu on a small set and prints its JSON line, the
card first."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu_torch import routing
from strawberry_tpu_torch.assembly.device import batched_mcf
from strawberry_tpu_torch.pipeline import Sample
from strawberry_tpu_torch.quant.device import EmDispatcher
from strawberry_tpu_torch.sim import make_dataset
from strawberry_tpu_torch.tools import common, em_crossover, mcf_crossover

CONSTANTS = {"device_em": "DEVICE_EM", "fastem_after": "FASTEM_AFTER",
             "prep": "PREP", "prep_granule": "PREP_GRANULE",
             "mcf_min_nodes": "MCF_MIN_NODES"}


@pytest.fixture
def env(monkeypatch):
    for var in common.ROUTING_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def resolved():
    return dict(device_em=not routing.em_force_host(False),
                fastem_after=routing.fastem_after(),
                prep=routing.prep_mode(),
                prep_granule=routing.prep_granule(),
                mcf_min_nodes=routing.mcf_min_nodes())


def constants():
    return {k: getattr(routing, c) for k, c in CONSTANTS.items()}


def test_cpu_routes_every_default_mode_to_the_host(env):
    """On "cpu" every default mode takes the host route. The constants
    hold on both platforms, so each of them must be a host route: one
    that a later measurement sends to the card needs a "cpu" value of its
    own."""
    env.setenv("STRAWB_PLATFORM", "cpu")
    got = resolved()
    assert got == constants()
    assert got["device_em"] is False and got["prep"] == "off"
    # --fast-em keeps every problem on the host: the default's route
    assert got["fastem_after"] is None and routing.em_force_host(True)
    d = EmDispatcher(fast_em=True)
    assert d.force_host is True and d.device is None
    # STRAWB_DEVICE_MCF=1 sends every problem to the plain version
    assert got["mcf_min_nodes"] == 0


@pytest.mark.parametrize("plat", ["cuda", None])
def test_cuda_resolves_to_the_table(env, plat):
    """routing.py's constants, read on this machine without a GPU (cuda
    is the platform when STRAWB_PLATFORM is unset)."""
    if plat:
        env.setenv("STRAWB_PLATFORM", plat)
    else:
        env.delenv("STRAWB_PLATFORM", raising=False)
    assert resolved() == constants()
    assert routing.PREP in ("off", "all", "budget")


@pytest.mark.parametrize("plat", ["cpu", "cuda"])
def test_environment_overrides_the_table(env, plat):
    env.setenv("STRAWB_PLATFORM", plat)
    env.setenv("STRAWB_DEVICE_EM", "1")
    assert routing.em_force_host(False) is False
    env.setenv("STRAWB_FORCE_HOST", "1")
    assert routing.em_force_host(False) and routing.em_force_host(True)
    assert routing.mcf_min_nodes() > 256
    assert routing.prep_mode() == "off"
    env.delenv("STRAWB_FORCE_HOST")
    env.delenv("STRAWB_DEVICE_EM")
    assert routing.em_force_host(True) is True       # --fast-em, no bound
    env.setenv("STRAWB_FASTEM_AFTER", "7")
    assert routing.fastem_after() == 7
    assert routing.em_force_host(True) is False      # --fast-em past 7
    env.setenv("STRAWB_FASTEM_AFTER", "0")
    assert routing.fastem_after() == 0
    assert routing.em_force_host(True) is False
    env.setenv("STRAWB_PREP_BUDGET", "123")
    assert routing.prep_granule() == 123
    for value, mode in [("0", "off"), ("false", "off"), ("", "off"),
                        ("1", "all"), ("all", "all"), ("true", "all"),
                        ("budget", "budget"), ("2", "budget")]:
        env.setenv("STRAWB_DEVICE_PREP", value)
        assert routing.prep_mode() == mode, value
        # Config.device_prep True/False wins over the variable
        assert routing.prep_mode(True) == "all"
        assert routing.prep_mode(False) == "off"


def with_row(env, plat, **change):
    env.setenv("STRAWB_PLATFORM", plat)
    for k, v in change.items():
        env.setattr(routing, CONSTANTS[k], v)


def test_readers_take_the_table(env):
    """EmDispatcher, the pipeline's prep route and its granule, and
    batched_mcf read their defaults from routing.py."""
    with_row(env, "cpu", device_em=True, fastem_after=3, prep="budget",
             prep_granule=77, mcf_min_nodes=10)
    d = EmDispatcher()
    assert d.force_host is False and str(d.device) == "cpu"
    d = EmDispatcher(fast_em=True)
    assert d.force_host is False and d.device_after == 3
    fake = SimpleNamespace(cfg=SimpleNamespace(device_prep=None))
    assert Sample._use_device_prep(fake) == "budget"
    assert routing.prep_granule() == 77
    rng = np.random.default_rng(3)
    problems = [mcf_crossover.make_problem(rng, m, 3) for m in (6, 12)]
    stats = {}
    batched_mcf(problems, stats=stats)
    assert stats["host"] == 1 and stats["device"] == 1
    env.setenv("STRAWB_FORCE_HOST", "1")
    assert EmDispatcher().force_host is True
    stats = {}
    batched_mcf(problems, stats=stats)
    assert stats == {"device": 0, "host": 2, "host_over_max": 0}


def test_a_table_that_routes_to_a_missing_gpu_raises(env):
    """A default that sends the f64 EM, or --fast-em past a bound, to the
    card raises where the work starts on a machine without one: no quiet
    host route."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the device is found, nothing raises")
    with_row(env, "cuda", device_em=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmDispatcher()
    with_row(env, "cuda", device_em=False, fastem_after=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmDispatcher(fast_em=True)


def prefix_rows(host, host_dispatch, f32):
    """em_crossover's prefix rows from (k, (median, best) seconds) of the
    host and (median, best) of the other two solvers."""
    def t(mb):
        return {"median_s": mb[0], "best_s": mb[1]}
    return {str(k): {"k": k, "host": t(h), "host_dispatch": t(hd),
                     "f32": t(f)}
            for (k, h), hd, f in zip(host, host_dispatch, f32)}


@pytest.mark.parametrize("case,want", [
    # the host route sooner at every k: no bound
    (([(250, (1.0, 0.9)), (1000, (2.0, 1.9))], [(1.5, 1.4), (3.0, 2.9)],
      [(2.0, 1.9), (4.0, 3.9)]), "all"),
    # the f32 path sooner on all problems, beyond the host's spread: the
    # largest k at which it did not beat host_dispatch that way
    (([(250, (1.0, 0.9)), (1000, (5.0, 4.8))], [(1.5, 1.4), (6.0, 5.8)],
      [(2.0, 1.9), (4.0, 3.9)]), 250),
    # host_dispatch beaten at every k: 0
    (([(250, (3.0, 2.9)), (1000, (5.0, 4.9))], [(2.5, 2.4), (6.0, 5.9)],
      [(2.0, 1.9), (4.0, 3.9)]), 0),
    # the f32 median lower on all problems, but not below the host's best
    # (within the spread of its repeats): no bound
    (([(250, (1.0, 0.9)), (1000, (4.0, 3.5))], [(1.5, 1.4), (6.0, 5.8)],
      [(2.0, 1.9), (3.8, 3.7)]), "all"),
    # the f32 path sooner on all problems, but not at a prefix past the
    # bound: no bound
    (([(250, (1.0, 0.9)), (1000, (5.0, 4.9)), (4000, (20.0, 19.0))],
      [(1.5, 1.4), (8.0, 7.9), (40.0, 39.0)],
      [(2.0, 1.9), (6.0, 5.9), (10.0, 9.9)]), "all"),
])
def test_fastem_after_rule(case, want):
    assert em_crossover.fastem_after_rule(prefix_rows(*case)) == want


# ---------------------------------------------------------------- tools
def fast_em_help():
    from strawberry_tpu_torch.cli import build_parser
    (action,) = [a for a in build_parser()._actions
                 if "--fast-em" in a.option_strings]
    return " ".join(action.help.split())


def help_states(text, bound):
    if bound is None:
        assert "every per-locus EM stays on the host" in text
        assert "as in the default run, whose output it gives" in text
    else:
        assert text.startswith("run the per-locus EM on the GPU in f32")
        assert f"after the first {bound} loci" in text


@pytest.mark.parametrize("bound", [None, 0, 12])
def test_fast_em_help_states_the_default_route(env, bound):
    """--fast-em's help says the route routing.FASTEM_AFTER gives: with no
    bound (the default), every EM on the host and the default run's
    output; with a bound N, the GPU in f32 past the first N loci; and
    STRAWB_FASTEM_AFTER, which overrides the constant, the same way."""
    help_states(fast_em_help(), routing.FASTEM_AFTER)
    env.setattr(routing, "FASTEM_AFTER", bound)
    help_states(fast_em_help(), bound)
    env.setenv("STRAWB_FASTEM_AFTER", "7")
    help_states(fast_em_help(), 7)


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("routing_set")
    bam, gtf, _ = make_dataset(str(d), seed=9, n_frags=3000)
    return str(d), bam, gtf


def run_tool(name, *argv):
    """`python -m strawberry_tpu_torch.tools.<name> --device cpu ...`:
    its JSON line, which must come last and start with the card."""
    proc = subprocess.run(
        [sys.executable, "-m", f"strawberry_tpu_torch.tools.{name}",
         "--device", "cpu", *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={k: v for k, v in os.environ.items()
             if k not in common.ROUTING_VARS + ("STRAWB_PLATFORM",)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith('{"card": "cpu", "tool": "%s"' % name)
    return json.loads(line)


def test_em_crossover_tool(small_set):
    d = run_tool("em_crossover", "--data", small_set[0], "--shape", "small",
                 "--reps", "1", "--walls", "1", "--warm")
    n = d["n_problems"]
    assert n > 0 and d["capture"]["queued"] == n
    assert set(d["prefixes"]) == {"all"} and d["prefixes"]["all"]["k"] == n
    for solver in ("host", "host_dispatch", "f64", "f32"):
        assert d["prefixes"]["all"][solver]["best_s"] > 0
    assert d["device_solved"] == {"host_dispatch": 0, "f64": n, "f32": n}
    # the dispatcher's host batch is the host route's solver
    assert d["host_dispatch_bit_mismatches"] == 0
    assert d["host_dispatch_max_rel_diff"] == 0.0
    assert 0 <= d["f64_bit_mismatches"] <= n
    assert d["f64_max_rel_diff"] < 1e-9 and d["f32_max_rel_diff"] < 1e-2
    assert d["f64_none_mismatches"] == d["f32_none_mismatches"] == 0
    assert d["fastem_after_rule"] == "all" or \
        0 <= d["fastem_after_rule"] <= n
    walls = d["walls"]
    assert set(walls) == {"default", "device_em", "force_host", "fast_em"}
    for mode in ("default", "device_em", "force_host"):
        assert walls[mode]["body_equals_reference"], mode
    for mode in walls.values():
        assert len(mode["warm_walls_s"]) == 1 and mode["warm_median_s"] > 0
        assert "locus_context" in mode["warm_phases_s"]
    assert walls["device_em"]["em_stats"]["device"] > 0
    assert walls["default"]["em_stats"]["device"] == 0
    assert set(d["f64_default_rule"]) == {
        "bits_identical", "body_equals_force_host", "median_not_higher"}


def test_em_crossover_captures_what_the_dispatcher_counted(env, small_set,
                                                           tmp_path):
    """Every problem a STRAWB_DEVICE_EM=1 run of the same set queues in
    its dispatcher (em_stats device + host) is captured, and the capture
    run (its solve on the host) writes the default's GTF body."""
    from strawberry_tpu_torch import cli
    _d, bam, gtf = small_set
    env.setenv("STRAWB_PLATFORM", "cpu")
    problems, counts = em_crossover.capture(bam, gtf, "--fr",
                                            str(tmp_path))
    assert len(problems) == counts["queued"] > 0
    env.setenv("STRAWB_DEVICE_EM", "1")
    samples = []
    run = cli.run_driver
    env.setattr(cli, "run_driver",
                lambda *a, **k: samples.append(run(*a, **k)) or samples[-1])
    out = str(tmp_path / "dev.gtf")
    assert cli.main(["-g", gtf, "-r", "--fr", "-o", out, "-T",
                     str(tmp_path / "dev.log"), bam]) == 0
    em = samples[0].em_stats
    assert em["device"] + em["host"] == len(problems)
    env.delenv("STRAWB_DEVICE_EM")
    ref = str(tmp_path / "host.gtf")
    assert cli.main(["-g", gtf, "-r", "--fr", "-o", ref, "-T",
                     str(tmp_path / "host.log"), bam]) == 0
    assert common.body(counts["gtf"]) == common.body(ref)
    # the host route's solver agrees with the dispatcher's own host solve
    thetas = em_crossover.host_solve(problems)
    assert all(t is not None for t in thetas)


def test_mcf_crossover_tool():
    d = run_tool("mcf_crossover", "--nodes", "2,3,8,33", "--batches",
                 "3,5", "--reps", "1")
    assert d["mismatches"] == 0
    assert [r["nodes"] for r in d["rows"]] == [2, 3, 8, 33]
    for r in d["rows"]:
        assert set(r["device"]) == {"3", "5"}
        assert r["host_solve_dense_us"] > 0 and r["host_network_simplex_us"] > 0
        assert 0 <= r["network_simplex_equal"] <= 5
    assert d["rows"][-1]["device"]["5"]["classes"]["device_block"] == 5
    assert d["device_min_nodes_rule"] in (None, 2, 3, 8, 33)


def test_prep_crossover_tool(small_set):
    d = run_tool("prep_crossover", "--data", small_set[0], "--shape",
                 "small", "--reps", "1", "--granules", "2048")
    assert set(d["modes"]) == {"off", "all", "budget_2048"}
    for name, m in d["modes"].items():
        assert m["body_equals_reference"], name
        assert len(m["walls_s"]) == len(m["locus_context_s"]) == 1
        assert m["median_s"] == m["best_s"] > 0 and m["spread_s"] == 0
    assert d["modes"]["off"]["prep_stats"] == {}
    assert d["modes"]["all"]["prep_stats"]["device_loci"] > 0
    assert d["modes"]["all"]["prep_stats"]["host_loci"] == 0
    assert d["auto_rule"] in ("off", "all", "budget")
    assert d["granule_rule"] == 2048


def test_device_character_tool_and_out(tmp_path):
    path = os.path.join(common.OUT_DIR, "device_character.json")
    if os.path.exists(path):
        os.remove(path)
    d = run_tool("device_character", "--out")
    assert set(d["f64_bit_mismatches_per_2^20"]) == {"add", "mul", "div",
                                                     "sqrt"}
    # the card's measurements are not made on the CPU
    for key in ("seq_accumulation", "copy_gbps_pinned",
                "copy_gbps_pageable", "empty_launch_roundtrip", "rates"):
        assert d[key] is None, key
    with open(path) as f:
        assert json.loads(f.read()) == d


def test_a_tool_without_a_gpu_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu_torch.tools.mcf_crossover",
         "--nodes", "3", "--batches", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not proc.stdout.strip()
