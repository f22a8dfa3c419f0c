"""The port's CLI (python -m strawberry_tpu_torch.cli) against the JAX
package's on small simulated sets, in subprocesses: byte-identical GTF
bodies and -T logs in the default modes and in --fast-em runs at both
packages' defaults (small runs stay on the host), --fast-em on the f32
route (the plain f32 EM on the CPU) within a TPM tolerance, and runs
with jax and the JAX package blocked from import, among them one through
the device prep and flow routes, and the STRAWB_TRACE_DIR trace of the
port (a torch.profiler Chrome trace). The two packages are independent copies: the port's subprocesses
block both jax and strawberry_tpu throughout (this process imports them),
and report every shared library they mapped, so a test can show that the
port loads only the host library built from its own native/ sources."""
import json
import os
import socket
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
# prints the exit codes, each run's flow-solve and prep counts (none for a
# -p run, whose work is in its workers) and EM counts, whether jax
# or the JAX package was imported, and the shared libraries the process
# mapped, as JSON. BLOCK_JAX=1 makes `import jax` and `import
# strawberry_tpu` fail.
_RUNNER = """
import json, os, sys
# bind numpy's lazily imported ctypeslib before either package starts its
# threads: run_driver's GTF-parse thread and its BAM open can touch
# np.ctypeslib first at once, and numpy's module __getattr__ then recurses
import numpy.ctypeslib
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
                  "em_stats": [getattr(s, "em_stats", {}) for s in samples],
                  "jax_package": any(
                      m.split(".")[0] == "strawberry_tpu"
                      and sys.modules[m] is not None for m in sys.modules),
                  "libs": libs,
                  "stats": [[getattr(s, "flow_stats", {}),
                             getattr(s, "prep_stats", {})]
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
    fast_default = []   # the port's, in a process of their own
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
        # the port's --fast-em on the f32 route (STRAWB_FASTEM_AFTER=0
        # below) next to the JAX default (mode g_r above)
        stem = str(root / f"fast_{ds}")
        argvs["strawberry_tpu_torch"].append(
            ["-g", gtf, "-r", "--fast-em", strand, "-o", stem + ".gtf",
             "-T", stem + ".log", bam])
        paths[("fast", ds)] = stem
        # both CLIs' --fast-em at their own STRAWB_FASTEM_AFTER defaults
        for pkg in argvs:
            stem = str(root / f"{pkg}_{ds}_fast_default")
            argv = ["-g", gtf, "-r", "--fast-em", strand, "-o",
                    stem + ".gtf", "-T", stem + ".log", bam]
            (fast_default if pkg == "strawberry_tpu_torch"
             else argvs[pkg]).append(argv)
            paths[(pkg, ds, "fast_default")] = stem
    run_cli("strawberry_tpu", argvs["strawberry_tpu"])
    res = run_cli("strawberry_tpu_torch", argvs["strawberry_tpu_torch"],
                  block_jax=True, STRAWB_FASTEM_AFTER="0")
    assert res["jax"] is False
    res = run_cli("strawberry_tpu_torch", fast_default, block_jax=True)
    for ds, em in zip(DATASETS, res["em_stats"]):
        paths[("fast_default_em_stats", ds)] = em
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


@pytest.mark.parametrize("ds", sorted(DATASETS))
def test_port_small_fast_em_run_is_jax_cli_fast_em_run(runs, ds):
    """--fast-em at both packages' defaults on a set of fewer loci than
    either keeps on the host (the port: every one, routing.FASTEM_AFTER,
    measured on the H100; the JAX package: 4000): every EM on the host,
    so the port gives the JAX CLI's --fast-em GTF body and -T log byte
    for byte, and both give the default's body."""
    from strawberry_tpu_torch import routing
    assert routing.FASTEM_AFTER is None
    em = runs[("fast_default_em_stats", ds)]
    assert em["device"] == 0 and 0 < em["host"] < 4000
    jax_out = runs[("strawberry_tpu", ds, "fast_default")]
    port_out = runs[("strawberry_tpu_torch", ds, "fast_default")]
    assert body(port_out + ".gtf") == body(jax_out + ".gtf")
    assert read(port_out + ".log") == read(jax_out + ".log")
    assert body(port_out + ".gtf") == body(
        runs[("strawberry_tpu", ds, "g_r")] + ".gtf")


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


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """`-g -r` and `-g -r -p 2` through the port's CLI with jax blocked on
    the CPU (STRAWB_PLATFORM=cpu): both untraced in one process, then each
    traced (STRAWB_TRACE_DIR) in a process of its own. Returns {run: (GTF
    path, trace directory, the runner's report)}."""
    root = tmp_path_factory.mktemp("torch_trace")
    bam, gtf, _ = make_dataset(str(root / "d"), seed=6, n_frags=800)

    def argv(name, extra):
        return ["-g", gtf, "-r", *extra, "-o", str(root / f"{name}.gtf"),
                "-T", str(root / f"{name}.log"), bam]

    runs = {"plain": [], "plain_p2": ["-p", "2"]}
    res = run_cli("strawberry_tpu_torch",
                  [argv(name, extra) for name, extra in runs.items()],
                  block_jax=True)
    out = {name: (str(root / f"{name}.gtf"), None, res) for name in runs}
    for name, extra in (("traced", []), ("traced_p2", ["-p", "2"])):
        d = root / f"trace_{name}"
        res = run_cli("strawberry_tpu_torch", [argv(name, extra)],
                      block_jax=True, STRAWB_TRACE_DIR=str(d))
        out[name] = (str(root / f"{name}.gtf"), d, res)
    return out


def trace_of(d):
    """The one Chrome trace in directory d, loaded."""
    files = sorted(os.listdir(d))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(d, files[0])) as f:
        return json.load(f)


@pytest.mark.parametrize("run", ["traced", "traced_p2"])
def test_port_trace_writes_one_chrome_trace(traced, run):
    _out, d, _res = traced[run]
    host = socket.gethostname()
    [name] = os.listdir(d)
    assert name.startswith(host + ".")
    assert name[len(host) + 1:].split(".")[0].isdigit()  # the pid
    events = trace_of(d)["traceEvents"]
    assert isinstance(events, list) and events


@pytest.mark.parametrize("run,phases", [
    ("traced", {"pass1_assemble", "pass2_quant"}),
    ("traced_p2", {"multiprocess_pipeline"})])
def test_port_trace_holds_phase_ranges(traced, run, phases):
    """The phases of the report are record_function ranges in the trace;
    the -p parent's trace holds its host side only."""
    events = trace_of(traced[run][1])["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert phases <= ranges, ranges
    assert not any(str(e.get("cat", "")).lower() == "kernel"
                   for e in events)


@pytest.mark.parametrize("run,twin", [("traced", "plain"),
                                      ("traced_p2", "plain_p2")])
def test_port_traced_run_gives_untraced_body(traced, run, twin):
    want = body(traced[twin][0])
    assert want.count("\ttranscript\t") > 0
    assert body(traced[run][0]) == want


def test_port_traced_runs_import_no_jax(traced):
    for _out, _d, res in traced.values():
        assert_standalone(res)


def test_port_trace_of_the_gpu_without_one_raises(tmp_path, monkeypatch):
    """STRAWB_PLATFORM=cuda (the default) traces the GPU: without one the
    trace raises, as a device route does, rather than trace the host
    alone; STRAWB_PLATFORM=cpu traces the host."""
    import torch
    from strawberry_tpu_torch.utils.profiling import Profiler
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    monkeypatch.setenv("STRAWB_TRACE_DIR", str(tmp_path / "t"))
    monkeypatch.setenv("STRAWB_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Profiler().start_trace()
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    prof = Profiler()
    prof.start_trace()
    with prof.phase("a_phase"):
        torch.ones(3).sum()
    path = prof.stop_trace()
    assert os.path.dirname(path) == str(tmp_path / "t")
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert "a_phase" in names
    assert prof.stop_trace() is None


def test_port_trace_that_cannot_be_written_raises(tmp_path, monkeypatch):
    """A trace directory that cannot be made fails the run at its start."""
    from strawberry_tpu_torch.utils.profiling import Profiler
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("STRAWB_TRACE_DIR", str(blocker / "trace"))
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    with pytest.raises(OSError):
        Profiler().start_trace()


def test_port_trace_counts_lost_kernel_records():
    """Each kernel launch the host recorded (cudaLaunchKernel,
    cuLaunchKernel and their kin) is matched to its kernel record by
    correlation id; copies and host ops do not count."""
    from strawberry_tpu_torch.utils.profiling import lost_kernel_records

    def ev(cat, name, corr=None):
        return {"cat": cat, "name": name,
                **({} if corr is None else {"args": {"correlation": corr}})}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 1),
              ev("cuda_runtime", "cudaLaunchKernelExC_v11060", 2),
              ev("cuda_driver", "cuLaunchKernel", 3),
              ev("cuda_runtime", "cudaMemcpyAsync", 4),
              ev("kernel", "void k<float>(float*)", 1),
              ev("kernel", "void k<double>(double*)", 3),
              ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 4),
              ev("cpu_op", "aten::add"), ev("user_annotation", "pass2_quant")]
    assert lost_kernel_records(events) == (3, 1)
    assert lost_kernel_records(events[:1] + events[4:5]) == (1, 0)
    assert lost_kernel_records(events[6:]) == (0, 0)


def test_port_trace_missing_kernel_records_raise(tmp_path, monkeypatch):
    """A trace of the GPU that lacks a launched kernel's record is written,
    then stop_trace raises TraceIncomplete naming it."""
    import torch
    from strawberry_tpu_torch.utils import profiling
    monkeypatch.setenv("STRAWB_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    prof = profiling.Profiler()
    prof.start_trace()
    prof._trace_cuda = True  # checked as a trace of the GPU is
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "lost_kernel_records", lambda ev: (5, 2))
    with pytest.raises(profiling.TraceIncomplete, match="3 of the 5") as e:
        prof.stop_trace()
    assert os.path.isfile(e.value.path) and e.value.lost == 2


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
