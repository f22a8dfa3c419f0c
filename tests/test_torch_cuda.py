"""The hand-written CUDA kernels against their plain PyTorch versions: the
EM (csrc/em_bucket.cu) at the four tier shapes and the specialization each
gets (one warp a locus at tiers 0-1, one CTA with F in registers at tier 2,
a thread block cluster at tier 3), on edge-case buckets and at odd shapes
on either side of each specialization's limits, with f64 bit-identical
across runs; quant prep
(csrc/quant_prep.cu, one launch a chunk over locus tiles) on seeded
synthetic chunks and on chunks at the edges of its design, the min-cost flow
(csrc/mcf_bucket.cu) on ragged batches that take every size class, and
the shard-row reduction (csrc/shard_reduce.cu) with the sharded EM bucket
over it; the wrappers' entries bound once. Needs an NVIDIA GPU and
nvcc; skips elsewhere. This file imports no jax, so on a machine without jax it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (edge_prep_chunks, flow_problems, infeasible_problem,
                        prep_inputs, random_bucket, special_bucket,
                        synthetic_prep_chunk)
from strawberry_tpu.assembly.mincostflow import solve_dense
from strawberry_tpu.quant.em import em_run
from strawberry_tpu_torch.assembly.cuda_mcf import (
    CLASSES, mcf_ragged, mcf_ragged_cuda, mcf_ragged_reference,
    pack_problems, unpack_flows)
from strawberry_tpu_torch.parallel import cuda_reduce
from strawberry_tpu_torch.parallel.cuda_reduce import (
    shard_colsum, shard_colsum_cuda, shard_colsum_reference)
from strawberry_tpu_torch.parallel.mesh import make_mesh, sharded_em_bucket
from strawberry_tpu_torch.quant.cuda_em import (MAX_ITER, bucket_to_torch,
                                                em_bucket_cuda,
                                                em_bucket_plan,
                                                em_bucket_reference,
                                                kernel_function)
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
    assert kernel_function(R, C) == f"em_{kernel}_kernel"
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
    """Shapes on either side of each specialization's limits, each counted
    under the __global__ function the kernel's plan names."""
    B, R, C = shape
    fn = kernel_function(R, C)
    assert fn == f"em_{em_bucket_plan(B, R, C, torch.float32)['kernel']}"\
        "_kernel"
    before = em_bucket_cuda.function_launches[fn]
    assert_kernel_matches_plain(
        random_bucket(np.random.default_rng(sum(shape)), *shape),
        cuda_device)
    assert em_bucket_cuda.function_launches[fn] > before


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


def prep_chunk(name):
    """A synthetic chunk ("synthetic_<seed>") or one of edge_prep_chunks."""
    if name.startswith("synthetic_"):
        return synthetic_prep_chunk(int(name.split("_")[1]))
    return edge_prep_chunks()[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["synthetic_7", "synthetic_8", "synthetic_9",
                                  "long_locus", "200_isoforms",
                                  "loci_without_hits", "no_pairs"])
def test_prep_kernels_match_plain(name, cuda_device):
    """Array-equal to the plain version, identical across two runs, one
    launch of prep_tile_kernel a call."""
    arrays, tables, P = prep_chunk(name)
    x = prep_inputs(arrays, tables, cuda_device)
    launches = quant_prep_cuda.launches
    fn_launches = dict(quant_prep_cuda.function_launches)
    compat, rows = quant_prep_cuda(x, P)
    compat2, rows2 = quant_prep_cuda(x, P)
    compat_r, rows_r = quant_prep_reference(x, P)
    torch.cuda.synchronize()
    assert quant_prep_cuda.launches == launches + 2
    assert quant_prep_cuda.function_launches == {
        "prep_tile_kernel": fn_launches["prep_tile_kernel"] + 2}
    assert torch.equal(compat, compat_r) and torch.equal(rows, rows_r)
    assert torch.equal(compat, compat2) and torch.equal(rows, rows2)
    if name.startswith("synthetic_"):
        assert 0 < int(compat.sum()) < P


@pytest.mark.cuda
def test_prep_kernels_reject_bad_inputs(cuda_device):
    arrays, tables, P = synthetic_prep_chunk(7)
    x = prep_inputs(arrays, tables, cuda_device)
    launches = quant_prep_cuda.launches
    with pytest.raises(ValueError, match="gleft: expected"):
        quant_prep_cuda(x._replace(gleft=x.gleft.long()), P)
    with pytest.raises(ValueError, match="segl: expected"):
        quant_prep_cuda(x._replace(segl=x.segl[:, :64].contiguous()), P)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        quant_prep_cuda(prep_inputs(arrays, tables, "cpu"), P)
    with pytest.raises(ValueError, match="tiles: expected"):
        quant_prep_cuda(x._replace(tiles=x.tiles[:, :4].contiguous()), P)
    with pytest.raises(ValueError, match="tiles must be contiguous"):
        quant_prep_cuda(x._replace(tiles=x.tiles.t().contiguous().t()), P)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.empty(x.tiles.numel() + 1, dtype=torch.int32,
                              device=cuda_device)
        shifted[1:] = x.tiles.view(-1)
        quant_prep_cuda(x._replace(tiles=shifted[1:].view(x.tiles.shape)),
                        P)
    with pytest.raises(ValueError, match="nf is on cpu"):
        quant_prep_cuda(x._replace(nf=x.nf.cpu()), P)
    with pytest.raises(ValueError, match="NT=0 tiles"):
        quant_prep_cuda(x._replace(tiles=x.tiles[:0]), P)
    assert quant_prep_cuda.launches == launches


RAGGED_SIZES = (3, 8, 13, 31, 32, 33, 64, 65, 128, 200, 256)


def ragged_mix(seed=40):
    """Two seeded problems of each size in RAGGED_SIZES and the infeasible
    one, in a shuffled order: every size class, and the edges between
    them, in one call."""
    problems = flow_problems(seed, RAGGED_SIZES, per_size=2)
    problems.append(infeasible_problem())
    rng = np.random.default_rng(seed)
    return [problems[i] for i in rng.permutation(len(problems))]


def solve_packed(x, device, max_aug=None):
    """Kernel and plain version on packed problems x (on the host): the
    two results and the class launches the kernel made."""
    xd = x.to(device)
    before = dict(mcf_ragged_cuda.class_launches)
    args = () if max_aug is None else (max_aug,)
    out = mcf_ragged_cuda(xd, *args)
    ref = mcf_ragged_reference(xd, *args)
    torch.cuda.synchronize()
    launched = {k: mcf_ragged_cuda.class_launches[k] - before[k]
                for k in before}
    return out, ref, launched


@pytest.mark.cuda
def test_ragged_mcf_matches_plain_and_solve_dense(cuda_device):
    """Every size class in one call: array-equal to the plain version and
    to solve_dense, the infeasible problem flagged, one launch a class."""
    problems = ragged_mix()
    x = pack_problems(problems, pin=True)
    launches = mcf_ragged_cuda.launches
    out, ref, launched = solve_packed(x, cuda_device)
    assert mcf_ragged_cuda.launches == launches + len(CLASSES)
    assert launched == {"warp": 1, "block": 1, "block_global": 1}
    assert torch.equal(out.flow, ref.flow)
    assert torch.equal(out.infeasible, ref.infeasible)
    flows = unpack_flows(x, out.cpu())
    for i, p in enumerate(problems):
        host = solve_dense(*[a.copy() for a in p])
        assert (host is None) == (flows[i] is None), i
        if host is not None:
            np.testing.assert_array_equal(flows[i], host)
    assert sum(f is None for f in flows) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,classes", [
    ((3, 8, 13), {"warp": 1, "block": 0, "block_global": 0}),
    ((31, 32), {"warp": 1, "block": 0, "block_global": 0}),
    ((33, 64, 65, 128), {"warp": 0, "block": 1, "block_global": 0}),
    ((129, 256), {"warp": 0, "block": 0, "block_global": 1}),
    ((8, 200), {"warp": 1, "block": 0, "block_global": 1})])
def test_ragged_mcf_size_class_paths(sizes, classes, cuda_device):
    """Each path alone and in pairs: only the classes present launch, and
    each matches the plain version and solve_dense."""
    problems = flow_problems(sum(sizes), sizes, per_size=3)
    x = pack_problems(problems)
    out, ref, launched = solve_packed(x, cuda_device)
    assert launched == classes
    assert torch.equal(out.buf, ref.buf)
    for f, p in zip(unpack_flows(x, out.cpu()), problems):
        np.testing.assert_array_equal(f, solve_dense(*[a.copy() for a in p]))


@pytest.mark.cuda
@pytest.mark.parametrize("max_aug", [0, 1, 3, 7])
def test_ragged_mcf_stops_at_max_aug(max_aug, cuda_device):
    """The augmentation cap on every class: the plain version's flows, and
    the infeasible problem flagged only once an augmentation has run."""
    x = pack_problems(ragged_mix(41))
    out, ref, _launched = solve_packed(x, cuda_device, max_aug)
    assert torch.equal(out.flow, ref.flow)
    assert torch.equal(out.infeasible, ref.infeasible)
    assert int(out.infeasible.sum()) == (max_aug > 0)


@pytest.mark.cuda
def test_ragged_mcf_two_runs_identical(cuda_device):
    xd = pack_problems(ragged_mix(42)).to(cuda_device)
    a, b = mcf_ragged_cuda(xd), mcf_ragged(xd)
    torch.cuda.synchronize()
    assert torch.equal(a.buf, b.buf)


@pytest.mark.cuda
def test_ragged_mcf_rejects_bad_inputs(cuda_device):
    """Wrong types, shapes, devices, unsorted or out-of-range sizes: refused
    before any launch."""
    import dataclasses
    x = pack_problems(flow_problems(3, (5, 40, 140)))
    xd = x.to(cuda_device)
    launches = mcf_ragged_cuda.launches
    bad = [dataclasses.replace(xd, cost=xd.cost.int()),
           dataclasses.replace(xd, lower=xd.lower[:-1]),
           dataclasses.replace(xd, has_arc=xd.has_arc.bool()),
           dataclasses.replace(xd, size=xd.size.cpu()),
           dataclasses.replace(xd, offset=torch.stack([xd.offset] * 2,
                                                      1)[:, 0]),
           dataclasses.replace(xd, sizes=x.sizes[::-1].copy()),
           dataclasses.replace(xd, sizes=np.array([5, 40, 300], np.int32)),
           x]
    for y in bad[:-1]:
        with pytest.raises(ValueError):
            mcf_ragged_cuda(y)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mcf_ragged_cuda(x)
    assert mcf_ragged_cuda.launches == launches
    assert not any(mcf_ragged_cuda(pack_problems([]).to(cuda_device)).buf)


@pytest.mark.cuda
def test_wrappers_bind_their_entries_once(cuda_device):
    """The reduction's entry is bound at its first call and reused: the
    same ctypes function, the same bits as the plain loop and torch.sum,
    and a launch counted a call."""
    rows = torch.from_numpy(np.random.default_rng(11).integers(
        0, 2**40, size=(8, 4097)).astype(np.float64)).to(cuda_device)
    first = shard_colsum_cuda(rows)
    fn = cuda_reduce._launch._fn
    launches = shard_colsum_cuda.launches
    again = [shard_colsum_cuda(rows) for _ in range(3)]
    torch.cuda.synchronize()
    assert fn is not None and cuda_reduce._launch._fn is fn
    assert shard_colsum_cuda.launches == launches + 3
    for out in [first] + again:
        assert torch.equal(out, shard_colsum_reference(rows))
        assert torch.equal(out, torch.sum(rows, dim=0))


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


# Traces one call of every wrapper, launches that take every __global__
# function, in a fresh process (a trace a process, as the CLI traces a run:
# in an old process torch.profiler drops kernels launched right after a
# trace starts, see utils/profiling.py) and prints as JSON the launches the
# wrappers counted and the kernel events the trace holds.
_TRACE_RUNNER = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from chip_smoke import (flow_problems, function_counts, infeasible_problem,
                        launch_counters, prep_inputs, random_bucket,
                        read_trace, synthetic_prep_chunk)
from strawberry_tpu_torch.assembly.cuda_mcf import (mcf_ragged_cuda,
                                                    pack_problems)
from strawberry_tpu_torch.parallel.cuda_reduce import shard_colsum_cuda
from strawberry_tpu_torch.quant.cuda_em import bucket_to_torch, em_bucket_cuda
from strawberry_tpu_torch.quant.cuda_prep import quant_prep_cuda
from strawberry_tpu_torch.quant.device import _TIERS
from strawberry_tpu_torch.utils.profiling import Profiler
dev = torch.device("cuda")
buckets = [bucket_to_torch(*random_bucket(np.random.default_rng(t), B, R, C),
                           dev, torch.float32)
           for t, (R, C, B) in enumerate(_TIERS)]
x = prep_inputs(*synthetic_prep_chunk(7)[:2], dev)
P = synthetic_prep_chunk(7)[2]
problems = flow_problems(40, (3, 8, 32, 33, 64, 128, 200, 256), per_size=2)
flows = pack_problems(problems + [infeasible_problem()], pin=True).to(dev)
rows = torch.rand((4, 600), dtype=torch.float64, device=dev)
torch.cuda.synchronize()
counters = launch_counters()
before = function_counts(counters)
tracer = Profiler(enabled=False)
tracer.start_trace()
for b in buckets:
    em_bucket_cuda(*b)
quant_prep_cuda(x, P)
mcf_ragged_cuda(flows)
shard_colsum_cuda(rows)
path = tracer.stop_trace()
print(json.dumps({"launched": {fn: n - before[fn] for fn, n in
                               function_counts(counters).items()},
                  "events": read_trace(path)["counts"]}))
"""


@pytest.mark.cuda
def test_trace_holds_every_kernel_launch(cuda_device, tmp_path):
    """The STRAWB_TRACE_DIR trace (utils/profiling.Profiler) over calls of
    every wrapper that launch every __global__ function holds, for each,
    as many kernel events as the wrappers counted."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _TRACE_RUNNER], cwd=root,
        env=dict(os.environ, STRAWB_TRACE_DIR=str(tmp_path),
                 STRAWB_PLATFORM="cuda"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(res["launched"].values()), res["launched"]
    assert res["events"] == res["launched"]
