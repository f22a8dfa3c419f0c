"""The port's batched EM (strawberry_tpu_torch.quant) against the JAX
package's: the plain PyTorch version against `_em_bucket` (f64, 1e-9) and
the Pallas kernel in interpret mode (f32, the bars of test_pallas_em.py),
and the port's dispatcher against the host oracle (the cases of
test_device_em.py). Inputs are made with numpy from a seed and handed to
both. The CUDA kernel itself runs only on a GPU (test_torch_cuda.py)."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from chip_smoke import random_bucket, special_bucket
from strawberry_tpu.quant.device import _em_bucket
from strawberry_tpu.quant.em import em_init, em_run
from strawberry_tpu.quant.pallas_em import em_bucket_pallas
from strawberry_tpu_torch.quant.cuda_em import (bucket_to_torch, em_bucket,
                                                em_bucket_cuda,
                                                em_bucket_reference)
from strawberry_tpu_torch.quant.device import (EmDispatcher, LocusProblem,
                                               _TIERS, batched_em)


@pytest.mark.parametrize("shape", [(8, 32, 4), (6, 64, 8), (4, 128, 16)])
def test_reference_f64_matches_jax_em_bucket(shape):
    rng = np.random.default_rng(sum(shape))
    F, u, theta0, valid, active = random_bucket(rng, *shape)
    th_j, failed_j = _em_bucket(jnp.asarray(F), jnp.asarray(u),
                                jnp.asarray(theta0), jnp.asarray(valid),
                                jnp.asarray(active))
    th_t, failed_t = em_bucket_reference(*bucket_to_torch(
        F, u, theta0, valid, active, "cpu", torch.float64))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(failed_t.numpy(), np.asarray(failed_j))
    assert failed_t[0] and not failed_t[-2:].any()
    np.testing.assert_array_equal(th_t[0].numpy(), theta0[0])


def test_reference_f32_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    F, u, theta0, valid, active = random_bucket(rng, 16, 32, 8)
    th_p = np.asarray(em_bucket_pallas(F, u, theta0, valid, active,
                                       interpret=True))
    th_t, _failed = em_bucket_reference(*bucket_to_torch(
        F, u, theta0, valid, active, "cpu", torch.float32))
    th_t = th_t.numpy()
    assert th_t.dtype == np.float32
    rel = np.abs(th_t - th_p) / np.maximum(1.0, np.abs(th_p))
    # the bars of test_pallas_em.py (f32 convergence-boundary wobble)
    assert np.median(rel) < 1e-4
    assert (rel < 0.1).mean() > 0.95
    np.testing.assert_array_equal(th_t[-2:], theta0[-2:].astype(np.float32))


def random_problems(rng, n, max_rows=40, max_cols=6):
    problems = []
    for _ in range(n):
        r = rng.integers(1, max_rows)
        c = rng.integers(1, max_cols)
        W = rng.random((r, c)) * rng.random((r, c))
        # sprinkle zeros and tiny values (sub-1e-5 rows get dropped)
        W[rng.random((r, c)) < 0.4] = 0.0
        W[rng.random((r, c)) < 0.1] = 1e-6
        counts = rng.integers(0, 500, size=r).astype(np.float64)
        problems.append(LocusProblem(counts=counts, weights=W))
    return problems


def host_solve(p: LocusProblem):
    init = em_init(p.weights.shape[1], p.counts, p.weights)
    if init is None:
        return None
    theta = em_run(*init)
    if theta is None:
        theta = init[2]
    return theta


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    for var in ("STRAWB_FORCE_HOST", "STRAWB_DEVICE_EM",
                "STRAWB_FASTEM_AFTER"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("mode", ["host", "device_em", "force_host"])
def test_batched_em_matches_host_oracle(mode, cpu_platform):
    if mode == "device_em":
        cpu_platform.setenv("STRAWB_DEVICE_EM", "1")
    elif mode == "force_host":
        cpu_platform.setenv("STRAWB_FORCE_HOST", "1")
    rng = np.random.default_rng(0)
    problems = random_problems(rng, 60)
    dev = batched_em(problems)
    for i, p in enumerate(problems):
        host = host_solve(p)
        if host is None:
            assert dev[i] is None
        else:
            assert dev[i] is not None
            np.testing.assert_allclose(dev[i], host, rtol=1e-9, atol=1e-9,
                                       err_msg=f"problem {i}")


def test_batched_em_zero_denominator_failure(cpu_platform):
    cpu_platform.setenv("STRAWB_DEVICE_EM", "1")
    W = np.array([[0.5, 0.0], [0.0, 0.4]])
    counts = np.array([10.0, 0.0])
    p = LocusProblem(counts=counts, weights=W)
    host = host_solve(p)
    d = EmDispatcher()
    d.add(0, p)
    dev = d.finish()[0]
    assert d.n_device == 1
    np.testing.assert_allclose(dev, host, rtol=1e-9)
    np.testing.assert_array_equal(dev, [5.0, 5.0])  # reset to theta0


def test_batched_em_all_rows_dropped(cpu_platform):
    cpu_platform.setenv("STRAWB_DEVICE_EM", "1")
    p = LocusProblem(counts=np.array([3.0]), weights=np.array([[1e-6]]))
    assert host_solve(p) is None
    assert batched_em([p])[0] is None


def test_em_dispatcher_routing_counts(cpu_platform):
    rng = np.random.default_rng(1)
    problems = random_problems(rng, 40)
    n_fit = sum(1 for p in problems if p.filtered()[0].size > 0)

    # default golden mode: host carries the f64 EM
    d0 = EmDispatcher()
    for i, p in enumerate(problems):
        d0.add(i, p)
    r0 = d0.finish()
    assert d0.n_host == n_fit and d0.n_device == 0 and d0.device is None

    # forced device mode and --fast-em: everything that fits the menu
    # goes to the device tiers (--fast-em with STRAWB_FASTEM_AFTER=0: by
    # default it keeps every problem on the host, routing.FASTEM_AFTER)
    for env, fast in [("STRAWB_DEVICE_EM", False), (None, True)]:
        if env:
            cpu_platform.setenv(env, "1")
        else:
            cpu_platform.setenv("STRAWB_FASTEM_AFTER", "0")
        d = EmDispatcher(fast_em=fast)
        assert d.dtype == (torch.float32 if fast else torch.float64)
        for i, p in enumerate(problems):
            d.add(i, p)
        res = d.finish()
        assert d.n_device == n_fit and d.n_host == 0
        for a, b in zip(r0, res):
            assert (a is None) == (b is None)
            if a is not None:
                tol = 1e-4 if fast else 1e-9
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        if env:
            cpu_platform.delenv(env)
    # oversized problems fall back to the host solver
    cpu_platform.setenv("STRAWB_DEVICE_EM", "1")
    big_r = _TIERS[-1][0] + 1
    big = LocusProblem(counts=np.ones(big_r),
                       weights=np.full((big_r, 2), 0.5))
    d2 = EmDispatcher()
    d2.add(0, big)
    r2 = d2.finish()
    assert d2.n_host == 1 and d2.n_device == 0 and r2[0] is not None


def test_fastem_after_keeps_first_problems_on_host(cpu_platform):
    cpu_platform.setenv("STRAWB_FASTEM_AFTER", "5")
    problems = random_problems(np.random.default_rng(2), 20)
    n_fit = sum(1 for p in problems if p.filtered()[0].size > 0)
    d = EmDispatcher(fast_em=True)
    for i, p in enumerate(problems):
        d.add(i, p)
    d.finish()
    assert d.n_host == 5 and d.n_device == n_fit - 5


def test_em_bucket_on_cpu_takes_plain_version():
    rng = np.random.default_rng(7)
    args = bucket_to_torch(*random_bucket(rng, 5, 32, 4), "cpu",
                           torch.float64)
    before = em_bucket_cuda.launches
    th, failed = em_bucket(*args)
    th_r, failed_r = em_bucket_reference(*args)
    assert em_bucket_cuda.launches == before
    assert torch.equal(th, th_r) and torch.equal(failed, failed_r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        em_bucket_cuda(*args)


def test_bucket_to_torch_types():
    F, u, theta0, valid, active = random_bucket(
        np.random.default_rng(8), 4, 32, 4)
    t = bucket_to_torch(F, u, theta0, valid.astype(np.int32), active,
                        "cpu", torch.float32)
    assert [x.dtype for x in t] == [torch.float32] * 3 + [torch.bool] * 2
    assert all(x.is_contiguous() for x in t)
    np.testing.assert_array_equal(t[3].numpy(), valid)


def test_cuda_platform_without_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the device is found, nothing raises")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    # --fast-em on the device from the first problem (by default it keeps
    # every problem on the host and asks for no device)
    monkeypatch.setenv("STRAWB_FASTEM_AFTER", "0")
    monkeypatch.setenv("STRAWB_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmDispatcher(fast_em=True)
    monkeypatch.delenv("STRAWB_PLATFORM")  # cuda is the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmDispatcher(fast_em=True)
    monkeypatch.setenv("STRAWB_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="STRAWB_PLATFORM"):
        EmDispatcher(fast_em=True)


# ---- the rules the redesigned kernel relies on, held on the CPU through
# the JAX programs (`_em_bucket` in f64, the Pallas kernel in interpret
# mode in f32) and the port's plain version

def numpy_em(F, u, theta0, valid):
    """Plain-numpy EM of one locus, written out from the semantics: returns
    (theta, failed, E+M steps taken)."""
    colsum = F.sum(axis=0)
    Fn = np.where(colsum != 0, F / np.where(colsum == 0, 1.0, colsum), 0.0)
    theta = theta0.copy()
    for it in range(1000):
        Fi = F if it == 0 else Fn
        denom = Fi @ theta
        if (valid & (denom == 0)).any():
            return theta0.copy(), True, it + 1
        U = u[:, None] * Fi * theta[None, :] / np.where(
            denom == 0, 1.0, denom)[:, None]
        nxt = np.where(valid[:, None], U, 0.0).sum(axis=0)
        if np.sqrt(((nxt - theta) ** 2).sum()) < 1e-2:
            return theta, False, it + 1
        theta = nxt
    return theta, False, 1000


def jax_em(bucket, f32=False):
    if f32:
        return np.asarray(em_bucket_pallas(*bucket, interpret=True))
    th, _failed = _em_bucket(*[jnp.asarray(a) for a in bucket])
    return np.asarray(th)


def test_iteration_counts_match_numpy_count():
    bucket = special_bucket()
    F, u, theta0, valid, active = bucket
    th, failed, steps = em_bucket_reference(
        *bucket_to_torch(*bucket, "cpu", torch.float64), iterations=True)
    assert steps[0] == 1000 and steps[-1] == 0
    for b in np.flatnonzero(active):
        th_n, failed_n, steps_n = numpy_em(F[b], u[b], theta0[b], valid[b])
        assert int(steps[b]) == steps_n, b
        assert bool(failed[b]) == failed_n
        np.testing.assert_allclose(th[b].numpy(), th_n, rtol=1e-9, atol=1e-9)
    rng = np.random.default_rng(12)
    rb = random_bucket(rng, 12, 64, 8)
    _th, failed, steps = em_bucket_reference(
        *bucket_to_torch(*rb, "cpu", torch.float64), iterations=True)
    want = [numpy_em(rb[0][b], rb[1][b], rb[2][b], rb[3][b])[2]
            if rb[4][b] else 0 for b in range(12)]
    assert steps.tolist() == want and failed[0]


@pytest.mark.parametrize("f32", [False, True])
def test_special_loci_match_jax(f32):
    """The cap, the zero column with nonzero theta0 and the non-prefix
    valid mask through the JAX program and the plain version."""
    bucket = special_bucket()
    dt = torch.float32 if f32 else torch.float64
    th_t = em_bucket_reference(*bucket_to_torch(*bucket, "cpu", dt))[0]
    th_j = jax_em(bucket, f32)
    if f32:
        rel = np.abs(th_t.numpy() - th_j) / np.maximum(1.0, np.abs(th_j))
        assert np.median(rel) < 1e-4 and (rel < 0.1).mean() > 0.95
    else:
        np.testing.assert_allclose(th_t.numpy(), th_j, rtol=1e-9, atol=1e-9)
    th = th_t.numpy()
    # the columns with zero F but nonzero theta0 moved theta (to 0): a
    # kernel that cut them off with F's extent would keep theta0 there
    assert bucket[2][1, 1] != 0 and bucket[2][1, -1] != 0
    assert th[1, 1] == 0 and th[1, -1] == 0
    np.testing.assert_array_equal(th[-1], bucket[2][-1].astype(th.dtype))


@pytest.mark.parametrize("f32", [False, True])
def test_extent_rule_padding_changes_nothing(f32):
    """A padded bucket and the same loci cut to their extents (rows to the
    last valid or weighted row, columns to the last column where F or
    theta0 is nonzero) give the same theta, in the JAX programs and in the
    plain version."""
    F, u, theta0, valid, active = special_bucket()
    keep_r = (valid | (F != 0).any(axis=2)).any(axis=0)
    keep_c = ((F != 0).any(axis=1) | (theta0 != 0)).any(axis=0)
    R_ext = int(np.flatnonzero(keep_r).max()) + 1
    C_ext = int(np.flatnonzero(keep_c).max()) + 1
    assert (R_ext, C_ext) != F.shape[1:]
    cut = (F[:, :R_ext, :C_ext], u[:, :R_ext], theta0[:, :C_ext],
           valid[:, :R_ext], active)
    # pad beyond the tier too: more rows and columns of exact zeros
    pad = (np.pad(F, ((0, 0), (0, 64), (0, 8))), np.pad(u, ((0, 0), (0, 64))),
           np.pad(theta0, ((0, 0), (0, 8))), np.pad(valid, ((0, 0), (0, 64))),
           active)
    dt = torch.float32 if f32 else torch.float64
    ref_cut = em_bucket_reference(*bucket_to_torch(*cut, "cpu", dt))[0]
    ref_pad = em_bucket_reference(*bucket_to_torch(*pad, "cpu", dt))[0]
    np.testing.assert_allclose(ref_pad[:, :C_ext].numpy(), ref_cut.numpy(),
                               rtol=1e-6 if f32 else 1e-12, atol=0)
    assert not ref_pad[:, C_ext:].any()
    # the Pallas kernel sums over its padded tile in another order; over
    # the capped locus' 1,000 f32 iterations that moves theta by ~1e-4
    j_cut, j_pad = jax_em(cut, f32), jax_em(pad, f32)
    np.testing.assert_allclose(j_pad[:, :C_ext], j_cut,
                               rtol=2e-4 if f32 else 1e-12, atol=0)


@pytest.mark.parametrize("tier", range(len(_TIERS)))
def test_special_bucket_at_tier_shapes(tier):
    """The edge-case bucket at each tier's shape, where the kernel picks
    another specialization: the plain version's theta, failed flags and
    iteration counts against the plain-numpy EM, locus by locus."""
    R, C, _B = _TIERS[tier]
    bucket = special_bucket(R, C)
    F, u, theta0, valid, active = bucket
    th, failed, steps = em_bucket_reference(
        *bucket_to_torch(*bucket, "cpu", torch.float64), iterations=True)
    assert steps[0] == 1000 and steps[-1] == 0
    for b in np.flatnonzero(active):
        th_n, failed_n, steps_n = numpy_em(F[b], u[b], theta0[b], valid[b])
        assert (int(steps[b]), bool(failed[b])) == (steps_n, failed_n), b
        np.testing.assert_allclose(th[b].numpy(), th_n, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(th[-1].numpy(), theta0[-1])
