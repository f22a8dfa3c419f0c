"""The port's parallel layer (strawberry_tpu_torch/parallel/) against the
JAX package's, on the CPU, on seeded inputs:

- the plain shard-row reduction against the JAX allreduce_hist /
  allreduce_scalar on an 8-device CPU mesh: exact;
- sharded_em_bucket against the JAX one (theta within rtol = atol = 1e-9,
  failed equal) and against the port's unsharded plain version (bit for
  bit); pad_for_mesh, split_counts, split_by_chrom equal;
- run_sharded against the port's run_driver and the JAX run_sharded:
  string-equal;
- the multi-process CLI (torch.distributed over gloo on 127.0.0.1) and the
  forked `-p` CLI against the single-process port CLI and the JAX CLI: GTF
  bodies (and the -f fragment TSV) byte-identical.

Every subprocess of the port blocks jax and strawberry_tpu from import."""
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp

from strawberry_tpu.config import Config as JaxConfig
from strawberry_tpu.io.bamreader import load_bam as jax_load_bam
from strawberry_tpu.parallel import collectives as jax_coll
from strawberry_tpu.parallel import distributed as jax_dist
from strawberry_tpu.parallel import mesh as jax_mesh
from strawberry_tpu.sim import make_dataset, write_genome_fasta
from strawberry_tpu.io.fasta import build_fai
from strawberry_tpu_torch.config import Config
from strawberry_tpu_torch.io.bamreader import load_bam
from strawberry_tpu_torch.parallel import collectives, distributed, mesh
from strawberry_tpu_torch.parallel.cuda_reduce import (shard_colsum,
                                                       shard_colsum_cuda,
                                                       shard_colsum_reference)
from strawberry_tpu_torch.pipeline import run_driver
from strawberry_tpu_torch.quant.cuda_em import (bucket_to_torch,
                                                em_bucket_reference)
from test_torch_pipeline import body


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")


# ------------------------------------------------------------ reductions
def _hist_rows(case):
    """Seeded (dp, H) rows of counts: the dry run's histogram shape, the
    multi-process run's (8, H + 1) shape with counts up to 2^40, and a
    single row."""
    if case == "dryrun":
        return np.random.default_rng(0).integers(
            0, 10, size=(8, 128)).astype(np.float64)
    if case == "large_counts":
        return np.random.default_rng(1).integers(
            0, 2**40, size=(8, 4097)).astype(np.float64)
    return np.random.default_rng(2).integers(
        0, 1000, size=(1, 600)).astype(np.float64)


@pytest.mark.parametrize("case", ["dryrun", "large_counts", "one_row"])
def test_plain_reduction_equals_jax_allreduce_hist(case):
    rows = _hist_rows(case)
    dp = rows.shape[0]
    want = jax_coll.allreduce_hist(jax_mesh.make_mesh(dp, mdl=1), rows)
    got = shard_colsum_reference(torch.from_numpy(rows))
    assert got.dtype == torch.float64 and tuple(got.shape) == (rows.shape[1],)
    assert np.array_equal(got.numpy(), want)
    # the dispatching wrapper and the port's allreduce_hist, on the CPU
    assert torch.equal(shard_colsum(torch.from_numpy(rows)), got)
    assert np.array_equal(
        collectives.allreduce_hist(mesh.make_mesh(dp, mdl=1), rows), want)
    assert np.array_equal(got.numpy(), torch.sum(
        torch.from_numpy(rows), dim=0).numpy())


def test_plain_reduction_equals_jax_allreduce_scalar():
    values = np.arange(8, dtype=np.float64)
    want = jax_coll.allreduce_scalar(jax_mesh.make_mesh(8, mdl=1), values)
    got = collectives.allreduce_scalar(mesh.make_mesh(8, mdl=1), values)
    assert got == want == 28.0
    big = np.random.default_rng(3).integers(0, 2**40, 8).astype(np.float64)
    assert collectives.allreduce_scalar(mesh.make_mesh(8, mdl=1), big) == \
        jax_coll.allreduce_scalar(jax_mesh.make_mesh(8, mdl=1), big)


def test_reduction_refuses_bad_inputs():
    good = torch.zeros((2, 4), dtype=torch.float64)
    for bad, exc in ((good.float(), TypeError), (good[:, ::2], ValueError),
                     (good[0], ValueError), (good.numpy(), TypeError)):
        with pytest.raises(exc):
            shard_colsum_reference(bad)
        with pytest.raises(exc):
            shard_colsum_cuda(bad)
    with pytest.raises(ValueError):  # the kernel takes no CPU tensor
        shard_colsum_cuda(good)
    with pytest.raises(ValueError):  # 3 rows do not shard over dp = 2
        collectives.allreduce_hist(mesh.make_mesh(2, mdl=1),
                                   np.zeros((3, 4)))
    assert tuple(shard_colsum_reference(good[:0]).shape) == (4,)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,mdl", [(8, None), (8, 1), (4, None), (2, None),
                                   (1, None), (6, 3)])
def test_make_mesh_and_pad_for_mesh_equal_jax(n, mdl):
    jm = jax_mesh.make_mesh(n, mdl=mdl)
    pm = mesh.make_mesh(n, mdl=mdl)
    assert dict(pm.shape) == dict(jm.shape)
    assert all(d.type == "cpu" for d in pm.devices)
    rng = np.random.default_rng(n)
    for B, C in rng.integers(1, 200, size=(20, 2)):
        assert mesh.pad_for_mesh(int(B), int(C), pm) == \
            jax_mesh.pad_for_mesh(int(B), int(C), jm)


def test_make_mesh_needs_the_gpu_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setenv("STRAWB_PLATFORM", "cuda")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(4)


def _dryrun_bucket(jm):
    """The dry run's bucket (__graft_entry__.py): B = 2 dp, C = 2 mdl,
    R = 16, seed 0."""
    dp, mdl = jm.shape["dp"], jm.shape["mdl"]
    rng = np.random.default_rng(0)
    B, C = jax_mesh.pad_for_mesh(2 * dp, 2 * mdl, jm)
    R = 16
    F = rng.random((B, R, C))
    u = rng.integers(0, 50, size=(B, R)).astype(np.float64)
    return (F, u, np.full((B, C), 10.0), np.ones((B, R), bool),
            np.ones((B,), bool))


@pytest.mark.parametrize("mdl", [2, 1])
def test_sharded_em_bucket_equals_jax_and_unsharded(mdl):
    jm = jax_mesh.make_mesh(8, mdl=mdl)
    pm = mesh.make_mesh(8, mdl=mdl)
    bucket = _dryrun_bucket(jm)
    want_theta, want_failed = jax_mesh.sharded_em_bucket(jm)(
        *[jnp.asarray(a) for a in bucket])
    theta, failed = mesh.sharded_em_bucket(pm)(*bucket)
    assert tuple(theta.shape) == bucket[2].shape
    np.testing.assert_allclose(theta.numpy(), np.asarray(want_theta),
                               rtol=1e-9, atol=1e-9)
    assert np.array_equal(failed.numpy(), np.asarray(want_failed))
    whole = em_bucket_reference(*bucket_to_torch(*bucket, "cpu",
                                                 torch.float64))
    assert torch.equal(theta, whole[0]) and torch.equal(failed, whole[1])
    # tensors go through as they are
    t2, f2 = mesh.sharded_em_bucket(pm)(*bucket_to_torch(
        *bucket, "cpu", torch.float64))
    assert torch.equal(t2, theta) and torch.equal(f2, failed)


def test_sharded_em_bucket_edge_cases_and_padding():
    """chip_smoke's tier-1 random bucket (a zero-denominator locus, a zero
    column, inactive loci) over 4 slots: the unsharded plain version's bits;
    a bucket that does not divide over dp is refused."""
    from chip_smoke import random_bucket
    bucket = random_bucket(np.random.default_rng(1001), 64, 128, 8)
    run = mesh.sharded_em_bucket(mesh.make_mesh(4, mdl=1))
    theta, failed = run(*bucket)
    whole = em_bucket_reference(*bucket_to_torch(*bucket, "cpu",
                                                 torch.float64))
    assert torch.equal(theta, whole[0]) and torch.equal(failed, whole[1])
    assert bool(failed[0]) and not failed[1:].any()
    with pytest.raises(ValueError, match="pad_for_mesh"):
        run(*[a[:63] for a in bucket])


# ------------------------------------------------------- chromosome split
def test_split_counts_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(50):
        counts = rng.integers(0, 5000, size=int(rng.integers(1, 30)))
        counts[rng.random(len(counts)) < 0.2] = 0
        n = int(rng.integers(1, 10))
        assert distributed.split_counts(counts, n) == \
            jax_dist.split_counts(counts, n)
    zeros = np.zeros(5, np.int64)
    assert distributed.split_counts(zeros, 3) == \
        jax_dist.split_counts(zeros, 3)


@pytest.fixture(scope="module")
def sharded_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    bam, gtf, _ = make_dataset(str(d), seed=52, n_frags=5000,
                               max_isoforms=3, n_chroms=4)
    return bam, gtf


def test_split_by_chrom_and_shard_table_equal_jax(sharded_set):
    bam, _gtf = sharded_set
    pt, jt = load_bam(bam), jax_load_bam(bam)
    for n in (1, 2, 3, 4, 7):
        shards = distributed.split_by_chrom(pt, n)
        assert shards == jax_dist.split_by_chrom(jt, n)
        flat = [r for s in shards for r in s]
        assert flat == sorted(flat) and len(flat) == len(pt.ref_names)
    for ids in ([1, 2], [0, 3]):  # a pure slice, and the gather path
        ps, js = distributed.shard_table(pt, ids), \
            jax_dist.shard_table(jt, ids)
        for f in ("ref_id", "left", "right", "strand", "feat_off",
                  "feat_code", "feat_left", "feat_len", "read_id"):
            assert np.array_equal(getattr(ps, f), getattr(js, f)), (ids, f)


@pytest.mark.parametrize("mode", ["abinitio", "refguided", "quantonly"])
def test_run_sharded_matches_single_and_jax(sharded_set, mode):
    bam, gtf = sharded_set
    cfgs = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        if mode in ("refguided", "quantonly"):
            cfg = cfg.replace(ref_gtf_filename=gtf, utilize_ref_models=True)
        if mode == "quantonly":
            cfg = cfg.apply_no_assembly()
        cfgs.append(cfg)
    cfg, jcfg = cfgs

    single = io.StringIO()
    run_driver(bam, cfg, single)
    sharded = io.StringIO()
    distributed.run_sharded(load_bam(bam, cfg), cfg, bam, sharded,
                            n_shards=4, mesh=mesh.make_mesh(mdl=1))
    jax_sharded = io.StringIO()
    jax_dist.run_sharded(jax_load_bam(bam, jcfg), jcfg, bam, jax_sharded,
                         n_shards=4, mesh=jax_mesh.make_mesh(mdl=1))
    assert sharded.getvalue().count("\ttranscript\t") > 0
    assert sharded.getvalue() == single.getvalue()
    assert sharded.getvalue() == jax_sharded.getvalue()


# -------------------------------------------------------------- CLI runs
# Runs every argv of the list through strawberry_tpu_torch.cli.main in one
# process with jax and the JAX package blocked from import, and prints the
# exit codes, whether either was imported, and, at every fork the process
# makes, whether CUDA had been initialized, as JSON.
_PORT_RUNNER = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["strawberry_tpu"] = None
import torch
forks = []
os.register_at_fork(before=lambda: forks.append(torch.cuda.is_initialized()))
from strawberry_tpu_torch import cli
rcs = [cli.main(argv) for argv in json.loads(sys.argv[1])]
print(json.dumps({"rcs": rcs, "cuda_at_fork": forks,
                  "jax": sys.modules.get("jax") is not None,
                  "jax_package": any(
                      m.split(".")[0] == "strawberry_tpu"
                      and sys.modules[m] is not None for m in sys.modules)}))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("STRAWB_DEVICE_EM", "STRAWB_FORCE_HOST")
           and not k.startswith("STRAWB_DIST_")}
    env.update({"STRAWB_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu", **extra})
    return env


def _port_popen(argvs, **extra):
    return subprocess.Popen(
        [sys.executable, "-c", _PORT_RUNNER, json.dumps(argvs)], cwd=ROOT,
        env=_env(**extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(procs, n_argvs=1):
    """Wait for every process (killing all on a timeout) and return each
    one's report; every run of every process must have exited 0."""
    out = []
    for rank, p in enumerate(procs):
        try:
            stdout, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (rank, err[-3000:])
        res = json.loads(stdout.strip().splitlines()[-1])
        assert res["rcs"] == [0] * n_argvs, (rank, err[-3000:])
        assert res["jax"] is False and res["jax_package"] is False
        out.append(res)
    return out


def port_cli(argvs, **extra):
    return _finish([_port_popen(argvs, **extra)], len(argvs))[0]


def jax_cli(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "strawberry_tpu.cli", *argv], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_distributed(tmp, per_rank_args, bam, **extra):
    """One port CLI process per rank, joined over gloo on 127.0.0.1; returns
    rank 0's GTF path. Rank k writes dist<k>.gtf and dist<k>.log."""
    n = len(per_rank_args)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [_port_popen(
        [[*args, "-o", str(tmp / f"dist{k}.gtf"), "-T",
          str(tmp / f"dist{k}.log"), bam]],
        STRAWB_DIST_COORD=coord, STRAWB_DIST_NPROCS=str(n),
        STRAWB_DIST_PROCID=str(k), **extra)
        for k, args in enumerate(per_rank_args)]
    _finish(procs)
    return str(tmp / "dist0.gtf")


def _assert_ranged_ingest(tmp, nprocs):
    """Each process inflated only about 1/N of the compressed stream."""
    shares = []
    for k in range(nprocs):
        with open(tmp / f"dist{k}.log") as f:
            m = re.search(r"ranged ingest: inflated (\d+) of (\d+)", f.read())
        assert m, f"no ranged-ingest record in dist{k}.log"
        shares.append(int(m.group(1)) / int(m.group(2)))
    assert sum(shares) < 1.5, shares       # overlap blocks only
    for sh in shares:
        assert sh < 1.6 / nprocs + 0.1, shares


def _singles(tmp, args, bam):
    """The single-process port and JAX CLI runs of `args`; their GTF bodies
    must agree. Returns the body."""
    port_out, jax_out = str(tmp / "port1.gtf"), str(tmp / "jax1.gtf")
    port_cli([[*args, "-o", port_out, "-T", str(tmp / "port1.log"), bam]])
    jax_cli([*args, "-o", jax_out, "-T", str(tmp / "jax1.log"), bam])
    want = body(port_out)
    assert want.count("\ttranscript\t") > 0
    assert want == body(jax_out)
    return want


def test_sharded_cli_needs_the_gpu_unless_cpu_is_asked_for(tmp_path,
                                                           sharded_set):
    """--shards sums its statistics on the device: with CUDA asked for (the
    default) and absent it raises, and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    bam, gtf = sharded_set
    proc = _port_popen([["-g", gtf, "--shards", "2", "-o",
                         str(tmp_path / "o.gtf"), "-T",
                         str(tmp_path / "o.log"), bam]],
                       STRAWB_PLATFORM="cuda")
    _out, err = proc.communicate(timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in err
    assert body(str(tmp_path / "o.gtf")) == ""


@pytest.fixture(scope="module")
def multihost_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    bam, gtf, _ = make_dataset(str(d), seed=61, n_frags=4000, n_chroms=3,
                               chrom_len=400_000)
    return bam, gtf


@pytest.mark.parametrize("nprocs,mode", [(2, "full"), (2, "quant"),
                                         (3, "full")])
def test_multiprocess_cli_matches_single_process(tmp_path, multihost_set,
                                                 nprocs, mode):
    bam, gtf = multihost_set
    args = ["-g", gtf] + (["-r"] if mode == "quant" else [])
    want = _singles(tmp_path, args, bam)
    # the f64 EM through the device dispatch (its plain version here)
    got = port_distributed(tmp_path, [args] * nprocs, bam,
                           STRAWB_DEVICE_EM="1")
    assert body(got) == want
    _assert_ranged_ingest(tmp_path, nprocs)


def test_traced_multiprocess_and_sharded_cli(tmp_path, multihost_set):
    """STRAWB_TRACE_DIR in the two launches that do not go through
    run_driver: each rank of a two-process launch writes its own Chrome
    trace, named by its rank, and --shards one; both give the untraced
    single process's GTF body."""
    bam, gtf = multihost_set
    args = ["-g", gtf, "-r"]
    single = str(tmp_path / "single.gtf")
    port_cli([[*args, "-o", single, "-T", str(tmp_path / "single.log"),
               bam]])
    want = body(single)
    assert want.count("\ttranscript\t") > 0
    dist_dir, shards_dir = tmp_path / "trace_dist", tmp_path / "trace_shards"
    got = port_distributed(tmp_path, [args] * 2, bam,
                           STRAWB_TRACE_DIR=str(dist_dir))
    assert body(got) == want
    names = sorted(os.listdir(dist_dir))
    host = socket.gethostname()
    assert sorted(n[len(host) + 1:].split(".")[1] for n in names) == [
        "rank0", "rank1"], names
    sharded = str(tmp_path / "sharded.gtf")
    port_cli([[*args, "--shards", "2", "-o", sharded, "-T",
               str(tmp_path / "sharded.log"), bam]],
             STRAWB_TRACE_DIR=str(shards_dir))
    assert body(sharded) == want
    [name] = os.listdir(shards_dir)
    for d, n in [(dist_dir, names[0]), (shards_dir, name)]:
        with open(d / n) as f:
            assert json.load(f)["traceEvents"]


def test_multiprocess_cli_ab_initio(tmp_path):
    bam, _gtf, _ = make_dataset(str(tmp_path / "d"), seed=62, n_frags=3000,
                                n_chroms=2, chrom_len=400_000)
    want = _singles(tmp_path, [], bam)
    assert body(port_distributed(tmp_path, [[]] * 2, bam)) == want
    _assert_ranged_ingest(tmp_path, 2)


def _genome_fasta(tmp, n_chroms, chrom_len):
    fa = str(tmp / "genome.fa")
    write_genome_fasta(fa, {f"chr{i+1}": chrom_len for i in range(n_chroms)},
                       seed=7)
    with open(fa + ".fai", "w") as fh:
        for n, r in build_fai(fa).items():
            fh.write(f"{n}\t{r.seq_len}\t{r.fpos}\t{r.line_len}"
                     f"\t{r.line_blen}\n")
    return fa


def test_multiprocess_cli_bias_frag_context(tmp_path):
    """-b (bias features) and -f (fragment-context TSV) across two
    processes: rank 0's GTF and the rank-concatenated fragment rows equal
    the single-process runs'."""
    bam, gtf, _ = make_dataset(str(tmp_path / "d"), seed=63, n_frags=3000,
                               n_chroms=2, chrom_len=400_000)
    fa = _genome_fasta(tmp_path, 2, 400_000)
    args = ["-g", gtf, "-r", "-b", fa]
    frag = str(tmp_path / "port1_frag.tsv")
    want = _singles(tmp_path, args + ["-f", frag], bam)
    got = port_distributed(
        tmp_path, [args + ["-f", str(tmp_path / f"frag{k}.tsv")]
                   for k in range(2)], bam)
    assert body(got) == want
    with open(frag) as f:
        header, *single_rows = f.read().splitlines()
    rows = []
    for k in range(2):
        with open(tmp_path / f"frag{k}.tsv") as f:
            head, *part = f.read().splitlines()
        assert head == header
        rows += part
    assert "path_gc_content" in header
    assert single_rows and rows == single_rows


@pytest.fixture(scope="module")
def forked_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("forked")
    bam, gtf, _ = make_dataset(str(d), seed=52, n_frags=5000,
                               max_isoforms=3, n_chroms=4)
    return bam, gtf


@pytest.mark.parametrize("mode", ["g", "g_r"])
def test_forked_cli_matches_single_and_jax(tmp_path, forked_set, mode):
    """-p 4 against the single-process port run and the JAX package's -p 4
    run; the parent has no CUDA context at any fork, and forks 4 workers."""
    bam, gtf = forked_set
    args = ["-g", gtf] + (["-r"] if mode == "g_r" else [])
    outs = {k: str(tmp_path / f"{k}.gtf") for k in ("single", "mp", "jax")}
    port_cli([[*args, "-o", outs["single"], "-T",
               str(tmp_path / "single.log"), bam]])
    res = port_cli([[*args, "-p", "4", "-o", outs["mp"], "-T",
                     str(tmp_path / "mp.log"), bam]])
    jax_cli([*args, "-p", "4", "-o", outs["jax"], "-T",
             str(tmp_path / "jax.log"), bam])
    assert res["cuda_at_fork"] == [False] * 4
    assert body(outs["single"]).count("\ttranscript\t") > 0
    assert body(outs["mp"]) == body(outs["single"])
    assert body(outs["mp"]) == body(outs["jax"])


def test_forked_cli_frag_context_bias(tmp_path, forked_set):
    """-p 3 with -b and -f: GTF body and fragment TSV of the single-process
    port run and of the JAX package's -p 3 run."""
    bam, gtf = forked_set
    fa = _genome_fasta(tmp_path, 4, 300_000)
    runs = {}
    for tag, extra, run in (("single", [], port_cli), ("mp", ["-p", "3"],
                                                       port_cli),
                            ("jax", ["-p", "3"], jax_cli)):
        out, frag = str(tmp_path / f"{tag}.gtf"), \
            str(tmp_path / f"{tag}_frag.tsv")
        argv = ["-g", gtf, "-r", "-b", fa, "-f", frag, *extra, "-o", out,
                "-T", str(tmp_path / f"{tag}.log"), bam]
        run([argv] if run is port_cli else argv)
        with open(frag) as f:
            runs[tag] = (body(out), f.read())
    assert runs["mp"] == runs["single"]
    assert runs["mp"] == runs["jax"]
    header = runs["single"][1].splitlines()[0]
    assert "path_gc_content" in header
    assert len(runs["single"][1].splitlines()) > 1


def test_dryrun_multiprocess_twin(tmp_path):
    """The JAX package's two-process dry run (__graft_entry__.py), with the
    port's CLI: seed 61, 1,500 fragments, `-g`, two processes against one."""
    bam, gtf, _ = make_dataset(str(tmp_path / "d"), seed=61, n_frags=1500,
                               n_chroms=2, chrom_len=300_000)
    single = str(tmp_path / "single.gtf")
    port_cli([["-g", gtf, "-o", single, "-T", str(tmp_path / "s.log"), bam]])
    got = port_distributed(tmp_path, [["-g", gtf]] * 2, bam)
    assert body(single).count("\ttranscript\t") > 0
    assert body(got) == body(single)
