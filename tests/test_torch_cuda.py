"""The hand-written CUDA kernels against their plain PyTorch versions: the
EM (csrc/em_bucket.cu) at the four tier shapes and the specialization each
gets (one warp a locus at tiers 0-1, one CTA with F in registers at tier 2,
a thread block cluster at tier 3), on edge-case buckets and at odd shapes
on either side of each specialization's limits, with f64 bit-identical
across runs; quant prep
(csrc/quant_prep.cu) on seeded synthetic chunks, the min-cost flow
(csrc/mcf_bucket.cu) at the three node buckets, and the shard-row
reduction (csrc/shard_reduce.cu) with the sharded EM bucket over it. Needs an NVIDIA GPU and
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
                        random_bucket, random_cmpc_problem, special_bucket,
                        synthetic_prep_chunk)
from strawberry_tpu.assembly.mincostflow import solve_dense
from strawberry_tpu.quant.em import em_run
from strawberry_tpu_torch.assembly.cuda_mcf import (mcf_bucket_cuda,
                                                    mcf_bucket_reference)
from strawberry_tpu_torch.parallel.cuda_reduce import (
    shard_colsum, shard_colsum_cuda, shard_colsum_reference)
from strawberry_tpu_torch.parallel.mesh import make_mesh, sharded_em_bucket
from strawberry_tpu_torch.quant.cuda_em import (MAX_ITER, bucket_to_torch,
                                                em_bucket_cuda,
                                                em_bucket_plan,
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
    a32 = bucket_to_torch(*bucket, cuda_device, torch.float32)
    th32, _ = em_bucket_cuda(*a32)
    th64, _ = em_bucket_reference(*bucket_to_torch(*bucket, cuda_device,
                                                   torch.float64))
    th32, th64 = th32.cpu().numpy(), th64.cpu().numpy()
    assert th32.dtype == np.float32
    rel = np.abs(th32 - th64) / np.maximum(1.0, np.abs(th64))
    # the bars of test_pallas_em.py (f32 convergence-boundary wobble)
    assert np.median(rel) < 1e-4
    assert (rel < 0.1).mean() > 0.95
    assert_uncapped_close(th32, a32)
    np.testing.assert_array_equal(th32[-2:],
                                  bucket[2][-2:].astype(np.float32))


def assert_uncapped_close(th32, a32):
    """Every active locus that the f32 plain version stops before the
    iteration cap is within 5e-2 relative of it: the Pallas bars alone
    would pass a few wrong loci. (Such a locus may stop an iteration apart
    in another summation order; the f32 and f64 plain versions differ by
    up to 1.2e-2 relative there.)"""
    ref, _, iters = em_bucket_reference(*a32, iterations=True)
    ref = ref.cpu().numpy()
    uncapped = ((iters < MAX_ITER) & a32[4]).cpu().numpy()
    rel = np.abs(th32 - ref) / np.maximum(1.0, np.abs(ref))
    assert (rel[uncapped] < 5e-2).all(), rel[uncapped].max()


def assert_kernel_matches_plain(bucket, device):
    """f64: within 1e-9 of the plain version, the same failed flags, and
    two runs bit-identical; f32: the Pallas bars against the f64 plain
    version, loci under the cap close to the f32 plain version, inactive
    loci exactly theta0."""
    theta0, active = bucket[2], bucket[4]
    a64 = bucket_to_torch(*bucket, device, torch.float64)
    th, failed = em_bucket_cuda(*a64)
    th2, failed2 = em_bucket_cuda(*a64)
    th_r, failed_r = em_bucket_reference(*a64)
    torch.testing.assert_close(th, th_r, rtol=1e-9, atol=1e-9)
    assert torch.equal(failed, failed_r)
    assert torch.equal(th, th2) and torch.equal(failed, failed2)
    a32 = bucket_to_torch(*bucket, device, torch.float32)
    th32 = em_bucket_cuda(*a32)[0].cpu().numpy()
    ref = th_r.cpu().numpy()
    rel = np.abs(th32 - ref) / np.maximum(1.0, np.abs(ref))
    assert np.median(rel) < 1e-4 and (rel < 0.1).mean() > 0.95
    assert_uncapped_close(th32, a32)
    np.testing.assert_array_equal(th32[~active],
                                  theta0[~active].astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("tier,kernel", [(0, "warp"), (1, "warp"),
                                         (2, "rows"), (3, "strip")])
def test_kernel_specialization_per_tier(tier, kernel, cuda_device):
    """Each tier's launch plan, and the edge cases (iteration cap, a zero
    column with nonzero theta0, a non-prefix valid mask) through it."""
    R, C, B = _TIERS[tier]
    for dt in (torch.float32, torch.float64):
        plan = em_bucket_plan(B, R, C, dt)
        assert plan["kernel"] == kernel
        if kernel == "strip":  # a cluster of 16 CTAs a locus
            assert plan["ctas_per_locus"] == 16
            assert plan["ctas"] == B * 16
    assert_kernel_matches_plain(special_bucket(R, C), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 32, 4), (6, 128, 8), (3, 129, 8),
                                   (4, 128, 9), (5, 300, 20), (4, 512, 31),
                                   (4, 513, 32), (4, 700, 50),
                                   (3, 3000, 130)])
def test_kernel_odd_shapes(shape, cuda_device):
    """Shapes on either side of each specialization's limits."""
    assert_kernel_matches_plain(
        random_bucket(np.random.default_rng(sum(shape)), *shape),
        cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [4, 8, 12, 16, 24])
def test_kernel_narrow_column_extent(cols, cuda_device):
    """Tier 2's bucket with every locus cut to its first `cols` columns:
    the tier-2 kernel's M-step over 8, 16 or 32 columns, against the plain
    version and, where invalid rows carry no weight, em_run."""
    R, C, B = _TIERS[2]
    F, u, theta0, valid, active = random_bucket(
        np.random.default_rng(cols), B, R, C)
    F[:, :, cols:] = 0.0
    theta0[:, cols:] = 0.0
    valid = (F > 1e-5).any(axis=2)
    bucket = (F, u, theta0, valid, active)
    assert_kernel_matches_plain(bucket, cuda_device)
    th = em_bucket_cuda(*bucket_to_torch(*bucket, cuda_device,
                                         torch.float64))[0].cpu().numpy()
    for b in np.flatnonzero(active):
        if F[b][~valid[b]].any():
            continue
        host = em_run(u[b, valid[b]], F[b, valid[b]], theta0[b])
        host = theta0[b] if host is None else host
        np.testing.assert_allclose(th[b], host, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_kernel_refuses_strips_past_shared_memory(cuda_device):
    """4096 x 128 in f64 needs 256 rows a CTA even at 16 CTAs, more than
    one CTA's shared memory: the launch is refused, not run another way.
    The same shape fits in f32."""
    bucket = random_bucket(np.random.default_rng(5), 2, 4096, 128)
    with pytest.raises(RuntimeError):
        em_bucket_cuda(*bucket_to_torch(*bucket, cuda_device, torch.float64))
    assert em_bucket_plan(2, 4096, 128, torch.float32)["ctas_per_locus"] == 16


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 600), (2, 1201), (8, 4097), (8, 1),
                                   (1, 1), (3, 127), (5, 128), (7, 129),
                                   (0, 33), (4, 0)])
def test_reduction_kernel_matches_plain_and_torch_sum(shape, cuda_device):
    """Count rows up to 2^40 at the run's shapes and at odd ones (one row,
    one column, widths around the block size, no rows, no columns):
    bit-identical to the plain version and to torch.sum, and across runs."""
    rng = np.random.default_rng(sum(shape))
    rows = torch.from_numpy(rng.integers(0, 2**40, size=shape).astype(
        np.float64)).to(cuda_device)
    launches = shard_colsum_cuda.launches
    out, out2 = shard_colsum_cuda(rows), shard_colsum(rows)
    torch.cuda.synchronize()
    assert shard_colsum_cuda.launches == launches + 2 * (shape[1] > 0)
    assert out.dtype == torch.float64 and tuple(out.shape) == (shape[1],)
    assert torch.equal(out, out2)
    assert torch.equal(out, shard_colsum_reference(rows))
    assert torch.equal(out, torch.sum(rows, dim=0))
    assert torch.equal(out.cpu(), shard_colsum_reference(rows.cpu()))


@pytest.mark.cuda
def test_reduction_kernel_keeps_row_order(cuda_device):
    """Non-integer rows, where the order of the additions shows: the plain
    version's bits (row 0 first)."""
    rows = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 1000)) * 10.0 ** np.arange(8)[:, None]).to(cuda_device)
    assert torch.equal(shard_colsum_cuda(rows), shard_colsum_reference(rows))


@pytest.mark.cuda
def test_reduction_kernel_rejects_bad_inputs(cuda_device):
    good = torch.zeros((4, 64), dtype=torch.float64, device=cuda_device)
    launches = shard_colsum_cuda.launches
    for bad, exc in ((good.float(), TypeError), (good[:, ::2], ValueError),
                     (good.t(), ValueError), (good[0], ValueError),
                     (good.cpu(), ValueError), (good.cpu().numpy(),
                                                TypeError)):
        with pytest.raises(exc):
            shard_colsum_cuda(bad)
    assert shard_colsum_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("tier,n_devices,mdl", [(0, 4, 1), (1, 4, 1),
                                                (1, 8, None), (2, 8, None),
                                                (3, 8, None)])
def test_sharded_em_bucket_equals_whole_bucket(tier, n_devices, mdl,
                                               cuda_device):
    """The bucket cut over the mesh's slots (each on GPU slot modulo the
    GPU count, its own stream): one launch a slot, and the bits of one
    launch over the whole bucket, in f64 and f32."""
    R, C, B = _TIERS[tier]
    bucket = random_bucket(np.random.default_rng(1000 + tier), B, R, C)
    mesh = make_mesh(n_devices, mdl=mdl)
    run = sharded_em_bucket(mesh)
    for dtype in (torch.float64, torch.float32):
        args = bucket_to_torch(*bucket, cuda_device, dtype)
        before = sharded_em_bucket.launches
        theta, failed = run(*args)
        whole = em_bucket_cuda(*args)
        torch.cuda.synchronize()
        assert sharded_em_bucket.launches == before + mesh.shape["dp"]
        assert theta.dtype == dtype
        assert torch.equal(theta, whole[0]) and torch.equal(failed, whole[1])
    theta_np, failed_np = run(*bucket)  # numpy arrays go over as f64
    ref = em_bucket_reference(*bucket_to_torch(*bucket, cuda_device,
                                               torch.float64))
    torch.testing.assert_close(theta_np, ref[0], rtol=1e-9, atol=1e-9)
    assert torch.equal(failed_np, ref[1])
