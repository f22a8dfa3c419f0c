"""The port's batched min-cost flow (strawberry_tpu_torch.assembly) against
the JAX package's: `batched_mcf` against the host solver
mincostflow.solve_dense (the cases of test_device_flow.py), the packing of
ragged problems, the plain PyTorch version of the ragged kernel and of one
padded bucket against the XLA program `_mcf_bucket` on the same padded
buckets, and STRAWB_DEVICE_MCF=1 runs of the port against the native
default and against the JAX CLI. The CUDA kernel itself runs only on a
GPU (test_torch_cuda.py)."""
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from chip_smoke import (infeasible_problem, pad_mcf_bucket,
                        random_cmpc_problem)
from strawberry_tpu.assembly.device import _mcf_bucket
from strawberry_tpu.assembly.mincostflow import solve_dense
from strawberry_tpu.config import Config as JaxConfig
from strawberry_tpu.sim import make_dataset
from strawberry_tpu_torch.assembly.cuda_mcf import (CLASSES, Flows,
                                                    mcf_bucket_reference,
                                                    mcf_ragged,
                                                    mcf_ragged_reference,
                                                    pack_problems,
                                                    unpack_flows)
from strawberry_tpu_torch.assembly.device import batched_mcf
from strawberry_tpu_torch.config import Config
from test_torch_pipeline import body, run_cli


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    return monkeypatch


def problems_40():
    rng = np.random.default_rng(1)
    return [random_cmpc_problem(rng, int(rng.integers(2, 24)))
            for _ in range(40)]


def mixed_problems():
    """Seeded CMPC problems of 2 to 256 nodes, every size class and the
    edges between them, with the infeasible problem among them, in a
    shuffled order."""
    rng = np.random.default_rng(21)
    sizes = [2, 3, 5, 8, 8, 13, 20, 31, 32, 33, 40, 64, 65, 100, 128, 129,
             200, 256]
    probs = [random_cmpc_problem(rng, m - 2, p_far=min(0.15, 4.0 / m))
             for m in sizes] + [infeasible_problem()]
    for cost, has, lower in probs:
        if cost.shape[0] > 32:
            # lower bounds out of the first 8 nodes only: a few
            # augmentations, which keeps the plain versions at 256 nodes
            # (every Bellman-Ford round over the padded bucket) fast
            lower[8:] = 0
    return [probs[i] for i in rng.permutation(len(probs))]


def assert_matches_solve_dense(problems, flows):
    for i, p in enumerate(problems):
        host = solve_dense(*[x.copy() for x in p])
        if host is None:
            assert flows[i] is None, i
        else:
            assert flows[i] is not None, i
            np.testing.assert_array_equal(flows[i], host, err_msg=f"prob {i}")


def test_batched_mcf_matches_solve_dense(cpu_platform):
    problems = problems_40()
    stats = {}
    flows = batched_mcf(problems, stats=stats)
    assert stats == {"device": 40, "host": 0, "host_over_max": 0,
                     "device_warp": 40, "device_block": 0,
                     "device_block_global": 0}
    assert_matches_solve_dense(problems, flows)


def test_batched_mcf_infeasible(cpu_platform):
    cost, has, lower = infeasible_problem()
    assert solve_dense(cost.copy(), has.copy(), lower.copy()) is None
    assert batched_mcf([(cost, has, lower)])[0] is None


def test_batched_mcf_routing(cpu_platform):
    """Problems over 256 nodes and below device_min_nodes solve on the
    host, the rest on the device by size class; STRAWB_FORCE_HOST sends
    every problem there."""
    problems = problems_40()[:6] + [random_cmpc_problem(
        np.random.default_rng(5), 256, p_far=0.01)]   # 258 nodes
    stats = {}
    flows = batched_mcf(problems, device_min_nodes=10, stats=stats)
    n_small = sum(p[0].shape[0] < 10 for p in problems)
    assert stats == {"device": 6 - n_small, "host": n_small + 1,
                     "host_over_max": 1, "device_warp": 6 - n_small,
                     "device_block": 0, "device_block_global": 0}
    assert_matches_solve_dense(problems, flows)
    cpu_platform.setenv("STRAWB_FORCE_HOST", "1")
    stats = {}
    assert_matches_solve_dense(problems, batched_mcf(problems, stats=stats))
    assert stats == {"device": 0, "host": 7, "host_over_max": 1}


def test_batched_mcf_counts_size_classes(cpu_platform):
    """Mixed sizes: each problem of at most 256 nodes on the device, in
    its size class (32 / 128 / 256 nodes at most), the 258-node one on the
    host, every flow equal to solve_dense's."""
    problems = mixed_problems() + [random_cmpc_problem(
        np.random.default_rng(5), 256, p_far=0.01)]
    stats = {}
    flows = batched_mcf(problems, stats=stats)
    sizes = [p[0].shape[0] for p in problems]
    assert stats == {"device": len(problems) - 1, "host": 1,
                     "host_over_max": 1,
                     "device_warp": sum(m <= 32 for m in sizes),
                     "device_block": sum(32 < m <= 128 for m in sizes),
                     "device_block_global": sum(128 < m <= 256
                                                for m in sizes)}
    assert_matches_solve_dense(problems, flows)


def test_pack_problems_round_trip():
    """Packed back to back and sorted by size (stable), every matrix at its
    offset; a copy keeps it; unpack_flows hands results back in the
    callers' order, None where flagged infeasible."""
    problems = mixed_problems()
    x = pack_problems(problems)
    sizes = [p[0].shape[0] for p in problems]
    assert list(x.sizes) == sorted(sizes)
    assert list(x.order) == sorted(range(len(sizes)), key=sizes.__getitem__)
    assert x.size.tolist() == sorted(sizes)
    assert x.cost.numel() == sum(m * m for m in sizes)
    assert x.classes == [(sum(m <= top for m in sizes) - sum(
        m <= lo for m in sizes), max([m for m in sizes if lo < m <= top],
                                     default=0))
        for lo, top in ((0, 32), (32, 128), (128, 256))]
    y = x.to("cpu")
    for b, i in enumerate(x.order):
        m, o = sizes[i], int(x.offset[b])
        for k, flat in enumerate((y.cost, y.has_arc, y.lower)):
            np.testing.assert_array_equal(
                flat[o:o + m * m].numpy().reshape(m, m), problems[i][k])
    buf = torch.zeros(8 * x.cost.numel() + len(sizes), dtype=torch.uint8)
    out = Flows(buf[:8 * x.cost.numel()].view(torch.int64),
                buf[8 * x.cost.numel():].view(torch.bool), buf)
    out.flow[:] = x.lower
    out.infeasible[::3] = True
    res = unpack_flows(x, out)
    for b, i in enumerate(x.order):
        if b % 3 == 0:
            assert res[i] is None
        else:
            np.testing.assert_array_equal(res[i], problems[i][2])
    assert pack_problems([]).classes == [(0, 0)] * 3
    with pytest.raises(ValueError, match="node counts"):
        pack_problems([random_cmpc_problem(np.random.default_rng(0), 255)])


@pytest.mark.parametrize("max_aug", [4096, 3])
def test_ragged_reference_matches_jax_and_solve_dense(max_aug):
    """The plain version of the ragged kernel on mixed sizes (2 to 256
    nodes, the infeasible problem among them) against `_mcf_bucket` on
    each size class zero-padded to its bucket (32, 128, 256 nodes), and,
    uncapped, against solve_dense; with max_aug=3 most problems stop at
    the cap, unmarked."""
    problems = mixed_problems()
    x = pack_problems(problems)
    res = unpack_flows(x, mcf_ragged_reference(x, max_aug=max_aug))
    for lo, (_name, top) in zip((0, 32, 128), CLASSES):
        idx = [i for i, p in enumerate(problems)
               if lo < p[0].shape[0] <= top]
        bucket = pad_mcf_bucket([problems[i] for i in idx], top)
        flow_j, inf_j = _mcf_bucket(*[jnp.asarray(a) for a in bucket],
                                    max_aug=max_aug)
        flow_j, inf_j = np.asarray(flow_j), np.asarray(inf_j)
        for q, i in enumerate(idx):
            m = problems[i][0].shape[0]
            assert (res[i] is None) == bool(inf_j[q]), i
            if res[i] is not None:
                np.testing.assert_array_equal(res[i], flow_j[q, :m, :m])
    assert sum(r is None for r in res) == 1
    if max_aug == 4096:
        assert_matches_solve_dense(problems, res)


def test_batched_mcf_cuda_without_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the device is found, nothing raises")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    monkeypatch.setenv("STRAWB_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batched_mcf(problems_40()[:2])


@pytest.mark.parametrize("max_aug", [4096, 3])
def test_reference_matches_jax_mcf_bucket(max_aug):
    """The plain bucket against `_mcf_bucket` on one padded bucket of 64
    nodes: the 40 problems, the infeasible one and two inactive loci; with
    max_aug=3 most loci stop at the cap, unmarked."""
    bucket = pad_mcf_bucket(problems_40() + [infeasible_problem()], 64,
                            n_inactive=2)
    flow_j, inf_j = _mcf_bucket(*[jnp.asarray(a) for a in bucket],
                                max_aug=max_aug)
    flow_t, inf_t = mcf_bucket_reference(
        *[torch.from_numpy(a) for a in bucket], max_aug=max_aug)
    np.testing.assert_array_equal(flow_t.numpy(), np.asarray(flow_j))
    np.testing.assert_array_equal(inf_t.numpy(), np.asarray(inf_j))
    assert inf_t[40] and not inf_t[-2:].any()
    np.testing.assert_array_equal(flow_t[-2:].numpy(), bucket[2][-2:])


def test_mcf_bucket_on_cpu_takes_plain_version():
    """On CPU tensors the dispatcher runs the plain version."""
    x = pack_problems(problems_40()[:4])
    flow, inf, _buf = mcf_ragged(x)
    ref_flow, ref_inf, _buf = mcf_ragged_reference(x)
    assert torch.equal(flow, ref_flow) and torch.equal(inf, ref_inf)


def test_device_mcf_matches_native_default_on_tie_free_set(tmp_path,
                                                           cpu_platform):
    """test_native_solve_paths.py's tie-free set: the port's
    STRAWB_DEVICE_MCF=1 run (every flow through the plain bucket) gives
    the JAX package's native default byte for byte."""
    from strawberry_tpu.pipeline import _NullLog as JaxNullLog
    from strawberry_tpu.pipeline import run_driver as jax_run_driver
    from strawberry_tpu_torch.pipeline import _NullLog, run_driver
    d = str(tmp_path / "ds")
    make_dataset(d, seed=11, n_frags=8000, n_chroms=2, max_isoforms=2)
    bam = f"{d}/sample_01.sorted.bam"
    gtf = f"{d}/annotation.gtf"

    def cfg(config):
        return config(ref_gtf_filename=gtf, utilize_ref_models=True)
    native = io.StringIO()
    jax_run_driver(bam, cfg(JaxConfig), native, JaxNullLog())
    cpu_platform.setenv("STRAWB_DEVICE_MCF", "1")
    device = io.StringIO()
    sample = run_driver(bam, cfg(Config), device, _NullLog())
    assert sample.flow_stats["device"] > 0, sample.flow_stats
    assert device.getvalue() == native.getvalue()


def test_port_cli_device_mcf_byte_identical_to_jax_cli(tmp_path):
    """Both CLIs with STRAWB_DEVICE_MCF=1 on a small set of the bench's
    realistic shape (up to 20 isoforms, 2-9 exons), the port with jax
    blocked: the port solves every flow in the plain bucket, the JAX
    package (whose device threshold is 128 nodes) on its host solver; the
    GTF bodies are the same."""
    bam, gtf, _ = make_dataset(
        str(tmp_path / "d"), seed=1, n_frags=6000, max_isoforms=20,
        exon_range=(2, 9), abundance="lognormal", chrom_len=600_000,
        indel_rate=0.02, clip_rate=0.03, protocol="fr")
    outs, stats = {}, {}
    for pkg in ("strawberry_tpu", "strawberry_tpu_torch"):
        outs[pkg] = str(tmp_path / f"{pkg}.gtf")
        res = run_cli(pkg, [["-g", gtf, "--fr", "-o", outs[pkg], "-T",
                             outs[pkg] + ".log", bam]],
                      block_jax=pkg == "strawberry_tpu_torch",
                      STRAWB_DEVICE_MCF="1")
        [[stats[pkg], _prep]] = res["stats"]
    port, ref = stats["strawberry_tpu_torch"], stats["strawberry_tpu"]
    assert port["device"] > 0 and port["host"] == 0, port
    assert port["device"] == ref["device"] + ref["host"]
    assert body(outs["strawberry_tpu"]).count("\ttranscript\t") > 0
    assert body(outs["strawberry_tpu_torch"]) == body(outs["strawberry_tpu"])
