"""The device EM dispatcher's span and counts (quant/device.py::
EmDispatcher), on the CPU (STRAWB_PLATFORM=cpu: the kernel's plain version)
with STRAWB_DEVICE_EM=1: one `em_launch` range a launch in a trace, and the
problems routed (by tier to the device, and to the host) in the
`device_em_fetch` range's args and a line of the -v report."""
import glob
import json
import os

import numpy as np
import pytest

from portbench import gen
from strawberry_tpu_torch import cli
from strawberry_tpu_torch.quant import device as qdev
from strawberry_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def device_em(monkeypatch, tmp_path):
    """The device route on the CPU, a trace into tmp_path/trace, and the
    dispatcher's launches counted."""
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    monkeypatch.setenv("STRAWB_DEVICE_EM", "1")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    monkeypatch.delenv("STRAWB_VERBOSE", raising=False)
    monkeypatch.setattr(profiling.GLOBAL, "enabled", False)
    monkeypatch.setattr(profiling.GLOBAL, "phases", {})
    monkeypatch.setattr(profiling.GLOBAL, "_trace_dir",
                        str(tmp_path / "trace"))
    launches = []

    def counted(*args):
        launches.append(int(args[4].sum()))   # the batch's active problems
        return em_bucket(*args)
    em_bucket = qdev.em_bucket
    monkeypatch.setattr(qdev, "em_bucket", counted)
    return launches, str(tmp_path / "trace")


def trace_of(trace_dir):
    [path] = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def problem(rng, rows, cols):
    return qdev.LocusProblem(
        counts=rng.integers(1, 20, rows).astype(np.float64),
        weights=rng.uniform(0.1, 1.0, (rows, cols)))


def args_of(event):
    """A range's args less the profiler's own ids."""
    return {k: v for k, v in event.get("args", {}).items()
            if k not in ("Ev Idx", "External id", "Record function id")}


def test_one_em_launch_range_a_launch_and_the_counts(device_em):
    """130 problems of tier 0 (one full batch of 128, then one of 2 at
    finish) and one too large for any tier (the host's): two launches, two
    ranges, and counts that add up."""
    launches, trace_dir = device_em
    rng = np.random.default_rng(3)
    shapes = [(10, 2)] * 130 + [(3000, 4)]
    prof = profiling.GLOBAL
    prof.start_trace()
    d = qdev.EmDispatcher()
    for i, (r, c) in enumerate(shapes):
        d.add(i, problem(rng, r, c))
    thetas = d.finish()
    prof.stop_trace()
    assert all(t is not None for t in thetas)
    assert launches == [128, 2]
    ranges = trace_of(trace_dir)
    assert len([e for e in ranges if e["name"] == "em_launch"]) == 2
    want = {"tier_counts": [130, 0, 0, 0], "n_device": 130, "n_host": 1}
    assert prof.em == want
    [fetch] = [e for e in ranges if e["name"] == "device_em_fetch"]
    assert args_of(fetch) == want


def test_cli_run_traces_its_launches_and_reports_its_counts(device_em,
                                                            tmp_path,
                                                            capsys):
    """A traced -v -r run of the human configuration's shape, cut small:
    an em_launch range for each launch, the device_em_fetch args' tiers
    summing to n_device, the same counts on the -v report's line."""
    launches, trace_dir = device_em
    with open(os.path.join(ROOT, "portbench", "configs",
                           "human_scale_fr.json")) as f:
        cfg = json.load(f)
    cfg.update(n_frags=3000, n_chroms=1, chrom_len=400_000)
    d = str(tmp_path / "set")
    gen.write_set(cfg, 2 ** 31 + 29, d)
    out = str(tmp_path / "run.gtf")
    assert cli.main([os.path.join(d, "sample.bam"), "-g",
                     os.path.join(d, "annotation.gtf"), "-r", "--fr", "-v",
                     "-i", f"{cfg['frag_mean']}/{cfg['frag_sd']}",
                     "-o", out, "-T", out[:-4] + ".log"]) == 0
    ranges = trace_of(trace_dir)
    assert launches
    assert len([e for e in ranges if e["name"] == "em_launch"]) == \
        len(launches)
    [fetch] = [e for e in ranges if e["name"] == "device_em_fetch"]
    em = args_of(fetch)
    assert sum(em["tier_counts"]) == em["n_device"] == sum(launches) > 0
    assert em == profiling.GLOBAL.em
    report = [ln for ln in capsys.readouterr().err.splitlines()
              if ln.strip().startswith("em dispatch:")]
    assert report == [
        f"  em dispatch: device {em['n_device']} (tiers "
        f"{', '.join(map(str, em['tier_counts']))}), host {em['n_host']}"]
