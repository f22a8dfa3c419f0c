"""The port's batched min-cost flow (strawberry_tpu_torch.assembly) against
the JAX package's: `batched_mcf` against the host solver
mincostflow.solve_dense (the cases of test_device_flow.py), the plain
PyTorch bucket against the XLA program `_mcf_bucket` on the same padded
bucket, and STRAWB_DEVICE_MCF=1 runs of the port against the native
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
from strawberry_tpu_torch.assembly.cuda_mcf import (mcf_bucket,
                                                    mcf_bucket_reference)
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
    assert stats == {"device": 40, "host": 0}
    assert_matches_solve_dense(problems, flows)


def test_batched_mcf_infeasible(cpu_platform):
    cost, has, lower = infeasible_problem()
    assert solve_dense(cost.copy(), has.copy(), lower.copy()) is None
    assert batched_mcf([(cost, has, lower)])[0] is None


def test_batched_mcf_routing(cpu_platform):
    """Problems over 256 nodes and below device_min_nodes solve on the
    host; STRAWB_FORCE_HOST sends every problem there."""
    problems = problems_40()[:6] + [random_cmpc_problem(
        np.random.default_rng(5), 256, p_far=0.01)]   # 258 nodes
    stats = {}
    flows = batched_mcf(problems, device_min_nodes=10, stats=stats)
    n_small = sum(p[0].shape[0] < 10 for p in problems)
    assert stats == {"device": 6 - n_small, "host": n_small + 1}
    assert_matches_solve_dense(problems, flows)
    cpu_platform.setenv("STRAWB_FORCE_HOST", "1")
    stats = {}
    assert_matches_solve_dense(problems, batched_mcf(problems, stats=stats))
    assert stats == {"device": 0, "host": 7}


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
    bucket = [torch.from_numpy(a) for a in pad_mcf_bucket(
        problems_40()[:4], 64)]
    flow, inf = mcf_bucket(*bucket)
    ref_flow, ref_inf = mcf_bucket_reference(*bucket)
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
