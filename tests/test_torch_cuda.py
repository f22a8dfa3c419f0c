"""The hand-written CUDA kernels against their plain PyTorch versions: the
EM (csrc/em_bucket.cu) at the four tier shapes, quant prep
(csrc/quant_prep.cu) on seeded synthetic chunks, and the min-cost flow
(csrc/mcf_bucket.cu) at the three node buckets. Needs an NVIDIA GPU and
nvcc; skips elsewhere. This file imports no jax, so on a machine without jax it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (infeasible_problem, pad_mcf_bucket, prep_inputs,
                        random_bucket, random_cmpc_problem,
                        synthetic_prep_chunk)
from strawberry_tpu.assembly.mincostflow import solve_dense
from strawberry_tpu.quant.em import em_run
from strawberry_tpu_torch.assembly.cuda_mcf import (mcf_bucket_cuda,
                                                    mcf_bucket_reference)
from strawberry_tpu_torch.quant.cuda_em import (bucket_to_torch,
                                                em_bucket_cuda,
                                                em_bucket_reference)
from strawberry_tpu_torch.quant.cuda_prep import (quant_prep_cuda,
                                                  quant_prep_reference)
from strawberry_tpu_torch.quant.device import _TIERS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", range(len(_TIERS)))
def test_kernel_f64_matches_plain_and_oracle(tier, cuda_device):
    R, C, B = _TIERS[tier]
    F, u, theta0, valid, active = bucket = random_bucket(
        np.random.default_rng(tier), B, R, C)
    args = bucket_to_torch(*bucket, cuda_device, torch.float64)
    launches = em_bucket_cuda.launches
    th_k, failed_k = em_bucket_cuda(*args)
    th_k2, failed_k2 = em_bucket_cuda(*args)
    th_r, failed_r = em_bucket_reference(*args)
    torch.cuda.synchronize()
    assert em_bucket_cuda.launches == launches + 2
    torch.testing.assert_close(th_k, th_r, rtol=1e-9, atol=1e-9)
    assert torch.equal(failed_k, failed_r)
    assert torch.equal(th_k, th_k2) and torch.equal(failed_k, failed_k2)
    th = th_k.cpu().numpy()
    for b in np.flatnonzero(active):
        host = em_run(u[b, valid[b]], F[b, valid[b]], theta0[b])
        host = theta0[b] if host is None else host
        np.testing.assert_allclose(th[b], host, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(th[~active], theta0[~active])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", range(len(_TIERS)))
def test_kernel_f32_meets_pallas_bars(tier, cuda_device):
    R, C, B = _TIERS[tier]
    bucket = random_bucket(np.random.default_rng(tier), B, R, C)
    th32, _ = em_bucket_cuda(*bucket_to_torch(*bucket, cuda_device,
                                              torch.float32))
    th64, _ = em_bucket_reference(*bucket_to_torch(*bucket, cuda_device,
                                                   torch.float64))
    th32, th64 = th32.cpu().numpy(), th64.cpu().numpy()
    assert th32.dtype == np.float32
    rel = np.abs(th32 - th64) / np.maximum(1.0, np.abs(th64))
    # the bars of test_pallas_em.py (f32 convergence-boundary wobble)
    assert np.median(rel) < 1e-4
    assert (rel < 0.1).mean() > 0.95
    np.testing.assert_array_equal(th32[-2:],
                                  bucket[2][-2:].astype(np.float32))


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    bucket = random_bucket(np.random.default_rng(9), 4, 32, 4)
    F, u, theta0, valid, active = bucket_to_torch(*bucket, cuda_device,
                                                  torch.float64)
    with pytest.raises(ValueError, match="u: expected"):
        em_bucket_cuda(F, u.float(), theta0, valid, active)
    with pytest.raises(ValueError, match="contiguous"):
        em_bucket_cuda(F.transpose(1, 2).contiguous().transpose(1, 2),
                       u, theta0, valid, active)
    with pytest.raises(TypeError, match="float32 or float64"):
        em_bucket_cuda(F.half(), u, theta0, valid, active)
    with pytest.raises(ValueError, match="rows and columns"):
        em_bucket_cuda(F[:, :, :0].contiguous(), u, theta0[:, :0].contiguous(),
                       valid, active)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_prep_kernels_match_plain(seed, cuda_device):
    arrays, tables, P = synthetic_prep_chunk(seed)
    x = prep_inputs(arrays, tables, cuda_device)
    launches = quant_prep_cuda.launches
    compat, rows = quant_prep_cuda(x, P)
    compat_r, rows_r = quant_prep_reference(x, P)
    torch.cuda.synchronize()
    assert quant_prep_cuda.launches == launches + 1
    assert torch.equal(compat, compat_r) and torch.equal(rows, rows_r)
    assert 0 < int(compat.sum()) < P


@pytest.mark.cuda
def test_prep_kernels_reject_bad_inputs(cuda_device):
    arrays, tables, P = synthetic_prep_chunk(7)
    x = prep_inputs(arrays, tables, cuda_device)
    with pytest.raises(ValueError, match="gleft: expected"):
        quant_prep_cuda(x._replace(gleft=x.gleft.long()), P)
    with pytest.raises(ValueError, match="segl: expected"):
        quant_prep_cuda(x._replace(segl=x.segl[:, :64].contiguous()), P)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        quant_prep_cuda(prep_inputs(arrays, tables, "cpu"), P)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,lo", [(64, 16, 2), (128, 6, 63), (256, 3, 127)])
def test_mcf_kernel_matches_plain_and_solve_dense(M, B, lo, cuda_device):
    rng = np.random.default_rng(M)
    problems = [random_cmpc_problem(rng, int(rng.integers(lo, M - 1)),
                                    p_far=min(0.15, 4.0 / lo))
                for _ in range(B)] + [infeasible_problem()]
    bucket = pad_mcf_bucket(problems, M, n_inactive=1)
    args = [torch.from_numpy(a).to(cuda_device) for a in bucket]
    launches = mcf_bucket_cuda.launches
    flow, inf = mcf_bucket_cuda(*args)
    flow_r, inf_r = mcf_bucket_reference(*args)
    torch.cuda.synchronize()
    assert mcf_bucket_cuda.launches == launches + 1
    assert torch.equal(flow, flow_r) and torch.equal(inf, inf_r)
    flow, inf = flow.cpu().numpy(), inf.cpu().numpy()
    for b, p in enumerate(problems):
        host = solve_dense(*[x.copy() for x in p])
        assert (host is None) == bool(inf[b]), b
        m = p[0].shape[0]
        if host is not None:
            np.testing.assert_array_equal(flow[b, :m, :m], host)
    assert inf[B] and not inf[-1]


@pytest.mark.cuda
def test_mcf_kernel_stops_at_max_aug(cuda_device):
    rng = np.random.default_rng(3)
    problems = [random_cmpc_problem(rng, 40) for _ in range(4)]
    args = [torch.from_numpy(a).to(cuda_device)
            for a in pad_mcf_bucket(problems, 64)]
    for max_aug in (0, 1, 5):
        flow, inf = mcf_bucket_cuda(*args, max_aug=max_aug)
        flow_r, inf_r = mcf_bucket_reference(*args, max_aug=max_aug)
        assert torch.equal(flow, flow_r) and torch.equal(inf, inf_r)
