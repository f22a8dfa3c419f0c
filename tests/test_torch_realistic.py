"""strawberry_tpu_torch/tools/realistic.py on the CPU, at a few thousand
fragments: the tool and every CLI process it starts run with jax and the
JAX package blocked from import (a sitecustomize on PYTHONPATH, so the
block reaches the tool's own subprocesses); its JSON line has its keys,
every mode its walls, splits and the four EM tier counts, and every mode's
body holds against its host twin."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu_torch.sim import make_dataset
from strawberry_tpu_torch import routing
from strawberry_tpu_torch.tools import common, realistic

# every process that starts with this on its path records its pid and
# cannot import jax or the JAX package
BLOCK = """
import os, sys
sys.modules["jax"] = None
sys.modules["strawberry_tpu"] = None
open(os.path.join(os.path.dirname(__file__), "pid.%d" % os.getpid()),
     "w").close()
"""


def run_tool(tmp, *argv):
    block = tmp / "block"
    block.mkdir(exist_ok=True)
    (block / "sitecustomize.py").write_text(BLOCK)
    env = {k: v for k, v in os.environ.items()
           if k not in common.ROUTING_VARS + ("STRAWB_PLATFORM",)}
    env["PYTHONPATH"] = str(block)
    proc = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu_torch.tools.realistic",
         "--device", "cpu", *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env=env)
    pids = [p for p in os.listdir(block) if p.startswith("pid.")]
    return proc, pids


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("realistic")
    make_dataset(str(tmp / "data"), seed=9, n_frags=3000)
    proc, pids = run_tool(tmp, "--data", str(tmp / "data"), "--reps", "1",
                          "--warmup", "0")
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout.strip().splitlines()[-1]
    assert text.startswith('{"card": "cpu", "tool": "realistic"')
    # the tool and its eight CLI processes, all under the block
    assert len(pids) >= 1 + len(realistic.MODES)
    return json.loads(text)


def test_line_has_its_keys(line):
    assert {"card", "tool", "device", "n_frags", "data", "reps", "warmup",
            "routing", "modes", "twins", "twins_ok", "note"} <= set(line)
    assert line["device"] == "cpu" and line["reps"] == 1
    assert set(line["modes"]) == set(realistic.MODES)
    assert line["routing"] == {k: getattr(routing, k) for k in (
        "DEVICE_EM", "FASTEM_AFTER", "PREP", "PREP_GRANULE",
        "MCF_MIN_NODES")}


@pytest.mark.parametrize("name", list(realistic.MODES))
def test_every_mode_reports_walls_and_splits(line, name):
    m = line["modes"][name]
    assert len(m["walls_s"]) == len(m["warm_walls_s"]) == 1
    assert m["median_s"] == m["best_s"] > 0 and m["spread_s"] == 0
    assert m["warm_median_s"] > 0
    assert len(m["max_rss_mb"]) == 1 and m["max_rss_mb"][0] > 0
    assert m["body_sha256"], "two runs of one mode gave two bodies"
    em = m["em_stats"]
    # the four EM tiers (32x4, 128x8, 512x32, 2048x128), tier 3 included
    assert len(em["tiers"]) == 4 and sum(em["tiers"]) == em["device"]
    # on the CPU the plain versions run: no kernel launches
    assert set(m["launches"]) == set(common.WRAPPERS)
    assert not any(m["launches"].values())
    assert "profiled" not in m   # --warmup 0; never on the CPU


def test_routes_reach_what_they_name(line):
    modes = line["modes"]
    for name in ("g_r_default", "g_r_prep_all", "g_default"):
        assert modes[name]["em_stats"]["device"] == 0, name
    for name in ("g_r_fast_em_f32", "g_r_device_em"):
        em = modes[name]["em_stats"]
        assert em["device"] > 0 and em["tiers"][0] > 0, name
    assert modes["g_r_fast_em"]["em_stats"]["device"] == 0
    assert modes["g_r_prep_all"]["prep_stats"]["device_loci"] > 0
    fs = modes["g_mcf"]["flow_stats"]
    assert fs["device"] > 0 and fs["host"] == fs["host_over_max"] == 0
    assert fs["device"] == (fs["device_warp"] + fs["device_block"]
                            + fs["device_block_global"])
    twin = modes["g_mcf_force_host"]["flow_stats"]
    assert twin["device"] == 0 and twin["host"] == fs["device"]


def test_every_mode_holds_against_its_host_twin(line):
    twins = line["twins"]
    assert set(twins) == {n for n, m in realistic.MODES.items() if m[2]}
    for name, t in twins.items():
        assert t["ok"], (name, t)
        assert t["twin"] == realistic.MODES[name][2]
    assert twins["g_r_device_em"]["rule"] == "bytes"
    assert twins["g_mcf"]["rule"] == "bytes"
    f32 = twins["g_r_fast_em_f32"]
    assert f32["rule"] == "tpm" and f32["same_transcripts"]
    assert 0 < f32["tpm_p99_rel_err"] <= common.TPM_P99_MAX
    assert line["twins_ok"] is True


def gtf(path, tpms):
    with open(path, "w") as f:
        f.write("# header\n")
        for tid, tpm in tpms.items():
            f.write(f'c\tS\ttranscript\t1\t9\t.\t+\t.\ttranscript_id "{tid}"'
                    f'; TPM "{tpm}";\n')
    return str(path)


@pytest.mark.parametrize("got,ok", [
    ({"a": 10.0, "b": 5.0}, True),
    ({"a": 10.0, "b": 5.001}, True),     # p99 1.98e-4
    ({"a": 10.0, "b": 5.1}, False),
    ({"a": 10.0}, False),                # a transcript missing
    ({"a": 10.0, "b": float("nan")}, False),
])
def test_tpm_rule(tmp_path, got, ok):
    ref = gtf(tmp_path / "ref.gtf", {"a": 10.0, "b": 5.0})
    assert common.tpm_check(ref, gtf(tmp_path / "got.gtf", got))[
        "ok"] is ok


def test_fast_em_rule_follows_its_route(tmp_path):
    """--fast-em at the default bound is held byte for byte where no
    problem went to the card, else by the TPM rule."""
    ref = gtf(tmp_path / "ref.gtf", {"a": 10.0, "b": 5.0})
    got = gtf(tmp_path / "got.gtf", {"a": 10.0, "b": 5.0001})
    walls = {"g_r_default": {"gtf": ref, "body_sha256": common.digest(ref)},
             "g_r_fast_em": {"gtf": got, "body_sha256": common.digest(got),
                             "em_stats": {"device": 0}}}
    host = realistic.twin_check("g_r_fast_em", walls)
    assert host["rule"] == "bytes" and host["ok"] is False
    walls["g_r_fast_em"]["em_stats"]["device"] = 3
    card = realistic.twin_check("g_r_fast_em", walls)
    assert card["rule"] == "tpm" and card["ok"] is True
    # p99 of (0, 2e-5), interpolated
    assert np.isclose(card["tpm_p99_rel_err"], 0.99 * 2e-5)


def test_peak_rss_is_the_process_own(tmp_path):
    """A process started by one that holds 512 MiB reports its own peak
    resident set, not its parent's high-water mark."""
    child = ("from strawberry_tpu_torch.tools.common import peak_rss_mb; "
             "print(peak_rss_mb())")
    parent = ("import subprocess, sys; held = b'x' * (512 << 20); "
              "from strawberry_tpu_torch.tools.common import peak_rss_mb; "
              f"out = subprocess.run([sys.executable, '-c', {child!r}], "
              "capture_output=True, text=True, check=True).stdout; "
              "print(peak_rss_mb(), out)")
    proc = subprocess.run([sys.executable, "-c", parent], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    mine, child_mb = map(float, proc.stdout.split())
    assert mine > 512 and 0 < child_mb < 256


def test_peak_rss_falls_back_to_ru_maxrss(tmp_path):
    """Where /proc gives no VmHWM, the peak is getrusage's ru_maxrss."""
    import resource
    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmRSS:\t1000 kB\n")
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    got = common.peak_rss_mb(str(status))
    assert before <= got <= resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024


def test_dataset_is_made_in_a_process_of_its_own(tmp_path, monkeypatch):
    """dataset() makes a missing set outside the calling process (whose
    peak resident set would reach every run it starts), on the
    realistic shape."""
    from types import SimpleNamespace
    from strawberry_tpu_torch import sim

    def refuse(*a, **k):
        raise AssertionError("make_dataset ran in the calling process")
    monkeypatch.setattr(sim, "make_dataset", refuse)
    bam, gtf = common.dataset(SimpleNamespace(data=str(tmp_path / "d"),
                                              n_frags=500))
    assert os.path.getsize(bam) > 0
    with open(gtf) as f:
        chroms = {line.split("\t", 1)[0] for line in f
                  if not line.startswith("#")}
    assert len(chroms) == common.REALISTIC["n_chroms"]
