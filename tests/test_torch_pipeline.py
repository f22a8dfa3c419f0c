"""The port's CLI (python -m strawberry_tpu_torch.cli) against the JAX
package's on small simulated sets, in subprocesses: byte-identical GTF
bodies and -T logs in the default modes, --fast-em (the plain f32 EM on
the CPU) within a TPM tolerance, and runs with jax and the JAX package
blocked from import, among them one through the device prep and flow
routes. The two packages are independent copies: the port's subprocesses
block both jax and strawberry_tpu throughout (this process imports them),
and report every shared library they mapped, so a test can show that the
port loads only the host library built from its own native/ sources."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.sim import make_dataset
from strawberry_tpu_torch import sim as port_sim

# name -> (make_dataset arguments, strandedness flag)
DATASETS = {"paired": (dict(seed=9, paired=True), "--fr"),
            "single": (dict(seed=11, paired=False), "--fr"),
            "paired_rf": (dict(seed=13, paired=True, protocol="rf",
                               with_xs=False), "--rf")}
MODES = {"g": ["-g", "{gtf}"], "g_r": ["-g", "{gtf}", "-r"], "abinitio": []}

# Runs every argv of the list through <package>.cli.main in one process and
# prints the exit codes, each run's flow-solve and prep counts, whether jax
# or the JAX package was imported, and the shared libraries the process
# mapped, as JSON. BLOCK_JAX=1 makes `import jax` and `import
# strawberry_tpu` fail.
_RUNNER = """
import json, os, sys
if os.environ.get("BLOCK_JAX"):
    sys.modules["jax"] = None
    sys.modules["strawberry_tpu"] = None
import importlib
cli = importlib.import_module(sys.argv[1] + ".cli")
samples = []
run = cli.run_driver
cli.run_driver = lambda *a, **k: samples.append(run(*a, **k)) or samples[-1]
rcs = [cli.main(argv) for argv in json.loads(sys.argv[2])]
with open("/proc/self/maps") as f:
    libs = sorted({l.split()[-1] for l in f if l.rstrip().endswith(".so")})
print(json.dumps({"rcs": rcs, "jax": sys.modules.get("jax") is not None,
                  "jax_package": any(
                      m.split(".")[0] == "strawberry_tpu"
                      and sys.modules[m] is not None for m in sys.modules),
                  "libs": libs,
                  "stats": [[s.flow_stats, getattr(s, "prep_stats", {})]
                            for s in samples]}))
"""


def run_cli(package, argvs, block_jax=False, **env):
    full_env = {k: v for k, v in os.environ.items()
                if k not in ("STRAWB_DEVICE_EM", "STRAWB_FORCE_HOST")}
    full_env.update(STRAWB_PLATFORM="cpu", **env)
    if block_jax:
        full_env["BLOCK_JAX"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, package, json.dumps(argvs)],
        cwd=ROOT, env=full_env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rcs"] == [0] * len(argvs), proc.stderr[-4000:]
    if block_jax:
        assert_standalone(res)
    return res


def assert_standalone(res):
    """Neither jax nor the JAX package was imported, and the only host
    library loaded is the port's own build (build/strawberry_tpu_torch/)."""
    assert res["jax"] is False and res["jax_package"] is False
    host = [lib for lib in res["libs"] if "libstrawberry_host" in lib]
    assert host and all(os.sep + os.path.join("build", "strawberry_tpu_torch")
                        + os.sep in lib for lib in host), host


def body(path):
    with open(path) as f:
        return "".join(line for line in f if not line.startswith("#"))


def read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every (dataset, mode) through both CLIs; returns their output
    paths keyed by (package, dataset, mode)."""
    root = tmp_path_factory.mktemp("torch_cli")
    argvs = {"strawberry_tpu": [], "strawberry_tpu_torch": []}
    paths = {}
    for ds, (kw, strand) in DATASETS.items():
        bam, gtf, _ = make_dataset(str(root / ds), n_frags=3000, **kw)
        for mode, flags in MODES.items():
            for pkg in argvs:
                stem = str(root / f"{pkg}_{ds}_{mode}")
                argvs[pkg].append(
                    [f.format(gtf=gtf) for f in flags]
                    + [strand, "-o", stem + ".gtf", "-T", stem + ".log",
                       bam])
                paths[(pkg, ds, mode)] = stem
        # the port's --fast-em next to the JAX default (mode g_r above)
        stem = str(root / f"fast_{ds}")
        argvs["strawberry_tpu_torch"].append(
            ["-g", gtf, "-r", "--fast-em", strand, "-o", stem + ".gtf",
             "-T", stem + ".log", bam])
        paths[("fast", ds)] = stem
    run_cli("strawberry_tpu", argvs["strawberry_tpu"])
    res = run_cli("strawberry_tpu_torch", argvs["strawberry_tpu_torch"],
                  block_jax=True)
    assert res["jax"] is False
    return paths


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("ds", sorted(DATASETS))
def test_port_cli_byte_identical_to_jax_cli(runs, ds, mode):
    jax_out = runs[("strawberry_tpu", ds, mode)]
    port_out = runs[("strawberry_tpu_torch", ds, mode)]
    assert body(jax_out + ".gtf").count("\ttranscript\t") > 0
    assert body(port_out + ".gtf") == body(jax_out + ".gtf")
    assert read(port_out + ".log") == read(jax_out + ".log")


def tpms(path):
    out = {}
    for line in body(path).splitlines():
        if "\ttranscript\t" in line:
            attrs = line.rsplit("\t", 1)[-1]
            tid = attrs.split('transcript_id "')[1].split('"')[0]
            out[tid] = float(attrs.split('TPM "')[1].split('"')[0])
    return out


@pytest.mark.parametrize("ds", sorted(DATASETS))
def test_port_fast_em_close_to_jax_default(runs, ds):
    ref = tpms(runs[("strawberry_tpu", ds, "g_r")] + ".gtf")
    fast = tpms(runs[("fast", ds)] + ".gtf")
    assert ref and set(fast) == set(ref)
    a = np.array([ref[t] for t in sorted(ref)])
    b = np.array([fast[t] for t in sorted(ref)])
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
    # a few-thousand-fragment set has few transcripts, so its p99 sits
    # near the maximum, where f32 and f64 can stop one iteration apart at
    # the 1e-2 convergence limit
    assert np.median(rel) < 1e-4
    assert np.percentile(rel, 99) <= 1e-2


def test_port_cli_runs_with_jax_blocked(tmp_path):
    bam, gtf, _ = make_dataset(str(tmp_path / "d"), seed=5, n_frags=1500)
    out = tmp_path / "o.gtf"
    res = run_cli("strawberry_tpu_torch",
                  [["-g", gtf, "-o", str(out), "-T",
                    str(tmp_path / "o.log"), bam]],
                  block_jax=True, STRAWB_DEVICE_EM="1")
    assert res["jax"] is False
    assert body(out).count("\ttranscript\t") > 0


def test_port_device_routes_run_with_jax_blocked(tmp_path):
    """STRAWB_DEVICE_MCF=1 (pass 1) and STRAWB_DEVICE_PREP=all (pass 2) in
    one `-g` run of the port with jax blocked, through the plain versions
    on the CPU: the GTF body of the JAX CLI under the same settings."""
    bam, gtf, _ = make_dataset(str(tmp_path / "d"), seed=5, n_frags=1500)
    env = dict(STRAWB_DEVICE_MCF="1", STRAWB_DEVICE_PREP="all")
    outs = {}
    for pkg in ("strawberry_tpu", "strawberry_tpu_torch"):
        outs[pkg] = str(tmp_path / f"{pkg}.gtf")
        res = run_cli(pkg, [["-g", gtf, "-o", outs[pkg], "-T",
                             outs[pkg] + ".log", bam]],
                      block_jax=pkg == "strawberry_tpu_torch", **env)
    assert res["jax"] is False
    [[flow_stats, prep_stats]] = res["stats"]
    assert flow_stats["device"] > 0, flow_stats
    assert prep_stats["device_loci"] > 0, prep_stats
    assert body(outs["strawberry_tpu"]).count("\ttranscript\t") > 0
    assert body(outs["strawberry_tpu_torch"]) == body(
        outs["strawberry_tpu"])


# Each case runs cli.main and must raise NotImplementedError naming the
# port; prints the messages as JSON.
_REFUSALS = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["strawberry_tpu"] = None
from strawberry_tpu_torch.cli import main
msgs = []
for argv, env in json.loads(sys.argv[1]):
    os.environ.update(env)
    try:
        main(argv)
    except NotImplementedError as e:
        msgs.append(str(e))
    else:
        msgs.append(None)
    for k in env:
        del os.environ[k]
print(json.dumps(msgs))
"""


def test_port_refuses_unported_paths(tmp_path):
    bam, _gtf, _ = make_dataset(str(tmp_path / "d"), seed=6, n_frags=800)
    cases = [([], {"STRAWB_TRACE_DIR": str(tmp_path)})]
    runs = [(a + ["-o", str(tmp_path / f"o{i}.gtf"), "-T",
                  str(tmp_path / f"o{i}.log"), bam], e)
            for i, (a, e) in enumerate(cases)]
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSALS, json.dumps(runs)], cwd=ROOT,
        env=dict(os.environ, STRAWB_PLATFORM="cpu"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    msgs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(msgs) == len(cases)
    for m in msgs:
        assert m is not None and "not ported to strawberry_tpu_torch" in m


def test_port_sim_writes_jax_package_bytes(tmp_path):
    """The port's copy of sim.make_dataset writes the JAX package's BAM and
    GTF bytes for one seed."""
    kw = dict(seed=17, n_frags=1200, max_isoforms=4, paired=True)
    outs = {name: mod(str(tmp_path / name), **kw)
            for name, mod in (("jax", make_dataset),
                              ("port", port_sim.make_dataset))}
    for k in range(2):  # bam, gtf
        with open(outs["jax"][k], "rb") as a, open(outs["port"][k], "rb") as b:
            assert a.read() == b.read(), outs["jax"][k]
