"""The comparison that decides `correct` fails where it must: under the
program's own lower precision (the f32 EM in place of the f64 one), and
under faults planted in the timed path, with the rest of a run driven as
the benchmark drives it (the harness's test mode skips its look for a card).

`control(cell, seed, platform, frags, chroms)` is also what a run on the card
at a cell's own size calls (frags=None): see PERF.md."""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from portbench import run as harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    harness.ROOT, "BENCHMARK.json")))["workloads"]]
# a size a test run holds at which f32 already shows: the paper set's loci
# need some hundreds of reads each
SMALL = dict(frags=20000, chroms=2)


def drive(cell, seed, platform="cpu", frags=None, chroms=None, argv_extra=(),
          env=None):
    """One run of the harness in this process; its result line."""
    saved = dict(os.environ)
    argv_for = harness.argv_for
    harness.argv_for = lambda *a: argv_for(*a)[:1] + list(argv_extra) + \
        argv_for(*a)[1:]
    os.environ.update(env or {})
    args = ["--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", "0"]
    if platform == "cpu":
        args.append("--cpu-test")
    if frags:
        args += ["--frags", str(frags)]
    if chroms:
        args += ["--chroms", str(chroms)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            harness.main(args)
    finally:
        harness.argv_for = argv_for
        os.environ.clear()
        os.environ.update(saved)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def control(cell, seed, platform="cpu", frags=None, chroms=None):
    """The f32 EM route of the program (--fast-em, every problem that fits
    a tier on the device) in place of the cell's f64 one."""
    return drive(cell, seed, platform, frags, chroms,
                 argv_extra=["--fast-em"],
                 env={"STRAWB_FASTEM_AFTER": "0"})


def platforms():
    return ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def need(platform):
    if platform == "cuda":
        import torch
        if not torch.cuda.is_available():
            pytest.skip("no CUDA device")


@pytest.mark.parametrize("platform", platforms())
@pytest.mark.parametrize("cell", CELLS)
def test_the_route_itself_is_correct(cell, platform):
    need(platform)
    assert drive(cell, 11, platform, **SMALL)["correct"] is True


@pytest.mark.parametrize("platform", platforms())
@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_is_not_correct(cell, platform):
    need(platform)
    res = control(cell, 11, platform, **SMALL)
    assert res["correct"] is False
    assert res["checks"]["fpkm_gap"]["value"] > \
        res["checks"]["fpkm_gap"]["limit"]


def plant(monkeypatch, fault):
    """Break the EM's answers where the dispatcher hands them back."""
    from strawberry_tpu_torch.quant import device
    finish = device.EmDispatcher.finish

    def broken(self):
        res = finish(self)
        idx = [i for i, t in enumerate(res) if t is not None and len(t) > 1]
        if fault == "altered":          # one answer off where it is made
            res[idx[len(idx) // 2]] = res[idx[len(idx) // 2]] * \
                np.array([1.001] + [1.0] * (len(res[idx[0]]) - 1))[
                    :len(res[idx[len(idx) // 2]])]
        else:                            # half of the batch left out
            for i in idx[::2]:
                res[i] = None
        return res
    monkeypatch.setattr(device.EmDispatcher, "finish", broken)


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    res = drive(CELLS[0], 12, "cpu", **SMALL)
    assert res["correct"] is False


def test_an_output_unlike_the_first_is_not_correct(tmp_path):
    """One sample of the window whose body differs from the first's, in a
    locus no gene draw reaches, fails `differ`."""
    from portbench import reference
    line = ('chr1\tstrawberry\ttranscript\t1\t900\t1000\t+\t.\tgene_id "g"; '
            'transcript_id "t{}"; FPKM "{}"; Frac "1.000000"; TPM "{}";\n')
    paths = []
    for k, fpkm in enumerate(["2.000000", "2.000000", "2.000100"]):
        p = tmp_path / f"s{k}.gtf"
        p.write_text(f"#run {k}\n" + line.format(1, "1.000000", "1.0")
                     + line.format(2, fpkm, "1.0"))
        paths.append(str(p))
    same = reference.judge([], paths[:2])
    assert same["correct"] is True and same["numbers"]["differ"]["value"] == 0
    res = reference.judge([], paths)
    assert res["correct"] is False
    assert res["numbers"]["differ"]["value"] == 1
