"""The port's device quant prep (strawberry_tpu_torch.quant.device_prep)
against the JAX package's: the plain PyTorch kernels against the XLA
program `_kernel_for(P)` on the same marshalled inputs (a seeded synthetic
chunk and the chunks of two pipeline runs, one with loci that route to
the host), the isoform tables both packages build from one annotation,
and end-to-end runs of the cases of test_device_prep.py, each
byte-identical to the JAX package's host run and with the JAX package's
own device/host split. The CUDA kernels themselves run only on a GPU
(test_torch_cuda.py)."""
import copy
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from chip_smoke import edge_prep_chunks, prep_inputs, synthetic_prep_chunk
from strawberry_tpu.config import Config as JaxConfig
from strawberry_tpu.pipeline import run_driver as jax_run_driver
from strawberry_tpu.quant import device_prep as jax_prep
from strawberry_tpu.sim import make_dataset
from strawberry_tpu_torch.config import Config
from strawberry_tpu_torch.pipeline import run_driver
from strawberry_tpu_torch.quant import device_prep
from strawberry_tpu_torch.quant.cuda_prep import (TILE_HITS, TILE_PAIRS,
                                                  prep_tiles, quant_prep,
                                                  quant_prep_reference)


class _Sink:
    def write(self, *_a):
        pass


def _cfg(gtf, device_prep_mode, config=Config, **cfg_kw):
    """A run's Config; each package gets its own Config class."""
    return config(ref_gtf_filename=gtf, utilize_ref_models=True,
                  device_prep=device_prep_mode, **cfg_kw)


def _jax_run(bam, gtf, device_prep_mode, **cfg_kw):
    out = io.StringIO()
    sample = jax_run_driver(bam, _cfg(gtf, device_prep_mode, JaxConfig,
                                      **cfg_kw), out, _Sink())
    return out.getvalue(), getattr(sample, "prep_stats", {})


@pytest.fixture
def port_run(monkeypatch):
    """Runs the port in this process on the CPU; returns (GTF text,
    prep_stats, the kernels' calls as (marshalled arrays, P), the
    PrepState's constructor arguments, the PrepState)."""
    monkeypatch.setenv("STRAWB_PLATFORM", "cpu")
    for var in ("STRAWB_FORCE_HOST", "STRAWB_DEVICE_EM", "STRAWB_DEVICE_MCF"):
        monkeypatch.delenv(var, raising=False)

    def run(bam, gtf, device_prep_mode, **cfg_kw):
        calls, states = [], []
        launch = device_prep.launch

        def recording_launch(state, arrays, P):
            calls.append((copy.deepcopy(arrays), P))
            return launch(state, arrays, P)

        class RecordingState(device_prep.PrepState):
            def __init__(self, *args):
                super().__init__(*args)
                self.args = args
                states.append(self)

        monkeypatch.setattr(device_prep, "launch", recording_launch)
        monkeypatch.setattr(device_prep, "PrepState", RecordingState)
        out = io.StringIO()
        sample = run_driver(bam, _cfg(gtf, device_prep_mode, **cfg_kw), out,
                            _Sink())
        assert len(states) <= 1
        return (out.getvalue(), getattr(sample, "prep_stats", {}), calls,
                states[0].args if states else None,
                states[0] if states else None)
    return run


def jax_kernel(arrays, tables, P):
    """The XLA program on the arrays padded as the JAX package's
    _dispatch_device pads them; returns (compat (P,), rows (H, 16))."""
    i32, big = np.int32, jax_prep._I32MAX
    H, NF = len(arrays["goff"]), len(arrays["gcode"])
    NL, NI = len(arrays["ni"]), len(arrays["iso_idx"])

    def pad(a, n, fill=0):
        out = np.full(n, fill, i32)
        out[:len(a)] = a
        return out

    Ht = jax_prep._tier(H, jax_prep._H_TIERS)
    NFt = jax_prep._tier(NF, jax_prep._NF_TIERS)
    Pt = jax_prep._tier(max(P, 1), jax_prep._P_TIERS)
    segl = np.full((jax_prep.L_MAX, jax_prep.S_MAX), big, i32)
    segr = np.full((jax_prep.L_MAX, jax_prep.S_MAX), -1, i32)
    segl[:NL], segr[:NL] = arrays["segl"], arrays["segr"]
    exl, exr, nex, inl, inn = tables
    args = [pad(arrays["gcode"], NFt), pad(arrays["gleft"], NFt, big),
            pad(arrays["glen"], NFt), pad(arrays["goff"], Ht),
            pad(arrays["nf"], Ht), exl, exr, nex, inl, inn,
            pad(arrays["pair_base"], jax_prep.L_MAX + 1, P),
            pad(arrays["hit_off"], jax_prep.L_MAX + 1, H),
            pad(arrays["iso_off"], jax_prep.L_MAX + 1, NI),
            pad(arrays["iso_idx"], max(NI, 8)),
            pad(arrays["ni"], jax_prep.L_MAX, 1), segl, segr]
    assert len(args) == 17   # `kern`'s own inputs: never the tile table
    compat, rows = jax_prep._kernel_for(Pt)(*[jnp.asarray(a) for a in args])
    return np.asarray(compat)[:P], np.asarray(rows)[:H]


def assert_plain_matches_jax(arrays, tables, P):
    compat, rows = quant_prep_reference(prep_inputs(arrays, tables, "cpu"),
                                        P)
    compat_j, rows_j = jax_kernel(arrays, tables, P)
    np.testing.assert_array_equal(compat.numpy(), compat_j)
    np.testing.assert_array_equal(rows.numpy(), rows_j)
    return compat.numpy()


@pytest.mark.parametrize("seed", [7, 8])
def test_plain_matches_jax_kernel_on_synthetic_chunk(seed):
    arrays, tables, P = synthetic_prep_chunk(seed)
    compat = assert_plain_matches_jax(arrays, tables, P)
    assert 0 < compat.sum() < P


def test_plain_chunks_small_and_whole_agree():
    arrays, tables, P = synthetic_prep_chunk(9)
    x = prep_inputs(arrays, tables, "cpu")
    c1, r1 = quant_prep_reference(x, P)
    c2, r2 = quant_prep_reference(x, P, chunk=37)
    assert torch.equal(c1, c2) and torch.equal(r1, r2)
    c3, r3 = quant_prep(x, P)   # CPU tensors: the plain version
    assert torch.equal(c1, c3) and torch.equal(r1, r3)


@pytest.mark.parametrize("name,kw,no_assembly", [
    ("realistic", dict(seed=3, n_frags=4000, max_isoforms=3), False),
    # -r on genes of 58-70 exons: the annotation's isoforms of more than
    # 64 exons route their loci to the host
    ("long_genes", dict(seed=4, n_frags=3000, max_isoforms=3,
                        exon_range=(58, 70), chrom_len=1_500_000), True),
])
def test_plain_matches_jax_kernel_on_pipeline_chunks(tmp_path, port_run,
                                                     name, kw, no_assembly):
    bam, gtf, _ = make_dataset(str(tmp_path), **kw)
    _out, stats, calls, _args, state = port_run(bam, gtf, True,
                                                no_assembly=no_assembly)
    assert calls and stats["device_loci"] > 0
    if name == "long_genes":
        assert stats["host_loci"] > 0, stats
        assert not state.iso_ok.all()
    tables = [state.tables[k].numpy() for k in device_prep._TABLES]
    for arrays, P in calls[:2]:
        assert_plain_matches_jax(arrays, tables, P)
    for arrays, P in calls:
        assert_tiles_right(arrays, P)


def kern_pair_decode(arrays, P):
    """`kern`'s decode of every pair, in numpy: (locus, hit, isoform slot
    within the locus), searchsorted over pair_base and clamped as there."""
    pair_base = arrays["pair_base"].astype(np.int64)
    hit_off = arrays["hit_off"].astype(np.int64)
    ni = arrays["ni"].astype(np.int64)
    p = np.arange(P)
    L = np.clip(np.searchsorted(pair_base, p, side="right") - 1, 0,
                len(ni) - 1)
    off = p - pair_base[L]
    nL = np.maximum(ni[L], 1)
    return L, np.clip(hit_off[L] + off // nL, 0, len(arrays["goff"]) - 1), \
        off % nL


def assert_tiles_right(arrays, P):
    """The chunk's tile table covers each locus's hits exactly once, in
    order, within the caps, none for a locus with no hits, and its pair
    runs are the pairs `kern` decodes to those hits, each pair once."""
    hit_off = arrays["hit_off"].astype(np.int64)
    ni = arrays["ni"].astype(np.int64)
    tiles = arrays["tiles"]
    assert tiles.dtype == np.int32 and tiles.shape[1] == 8
    np.testing.assert_array_equal(tiles, prep_tiles(
        hit_off, ni, arrays["pair_base"], arrays["iso_off"]))
    loc, h0, n, p0, t_ni, t_io = tiles[:, :6].T.astype(np.int64)
    nh = np.diff(hit_off)
    assert (tiles[:, 6:] == 0).all() and (n >= 1).all()
    assert (np.diff(loc) >= 0).all()
    assert set(loc) == set(np.nonzero(nh)[0])
    runs = [np.arange(a, a + b) for a, b in zip(h0, n)]
    np.testing.assert_array_equal(np.concatenate(runs + [[]]),
                                  np.arange(len(arrays["goff"])))
    assert (h0 >= hit_off[loc]).all() and (h0 + n <= hit_off[loc + 1]).all()
    assert (n <= TILE_HITS).all()
    assert ((n * ni[loc] <= TILE_PAIRS) | (n == 1)).all()
    np.testing.assert_array_equal(t_ni, ni[loc])
    np.testing.assert_array_equal(t_io, arrays["iso_off"][loc])
    np.testing.assert_array_equal(
        p0, arrays["pair_base"][loc] + (h0 - hit_off[loc]) * ni[loc])
    L, h, k = kern_pair_decode(arrays, P)
    seen = np.zeros(P, np.int64)
    for row in range(len(tiles)):
        j = np.arange(n[row] * t_ni[row])
        p = p0[row] + j
        seen[p] += 1
        np.testing.assert_array_equal(L[p], loc[row])
        np.testing.assert_array_equal(h[p], h0[row] + j // max(t_ni[row], 1))
        np.testing.assert_array_equal(k[p], j % max(t_ni[row], 1))
    assert (seen == 1).all()


def _chunk(name):
    if name.startswith("synthetic_"):
        return synthetic_prep_chunk(int(name.split("_")[1]))
    return edge_prep_chunks()[name]


EDGE_CHUNKS = ("long_locus", "200_isoforms", "loci_without_hits", "no_pairs")


@pytest.mark.parametrize("name", ("synthetic_7", "synthetic_8",
                                  "synthetic_9") + EDGE_CHUNKS)
def test_tiles_cover_hits_and_pairs(name):
    arrays, _tables, P = _chunk(name)
    assert_tiles_right(arrays, P)


def test_edge_chunks_are_at_the_edges():
    """What the edge chunks are for: a locus spanning many tiles, one with
    more isoforms than the kernel stages at once, loci with no hits, and
    hits with no pairs."""
    chunks = edge_prep_chunks()
    arrays, _t, P = chunks["long_locus"]
    nh, ni = np.diff(arrays["hit_off"]), arrays["ni"]
    assert (nh * ni).max() >= 30_000 and (arrays["tiles"][:, 0] == 0).sum() > 10
    arrays, (exl, exr, nex, inl, inn), P = chunks["200_isoforms"]
    big = int(np.argmax(arrays["ni"]))
    ids = arrays["iso_idx"][arrays["iso_off"][big]:arrays["iso_off"][big + 1]]
    assert len(ids) == 200 and (nex[ids] == 64).all() and P > 0
    arrays, _t, P = chunks["loci_without_hits"]
    nh = np.diff(arrays["hit_off"])
    assert nh[0] == 0 and nh[-1] == 0 and (nh == 0).sum() >= 3 and P > 0
    arrays, _t, P = chunks["no_pairs"]
    assert P == 0 and len(arrays["goff"]) > 0 and len(arrays["tiles"]) > 0


@pytest.mark.parametrize("name", EDGE_CHUNKS)
def test_plain_matches_jax_kernel_on_edge_chunks(name):
    arrays, tables, P = _chunk(name)
    assert_plain_matches_jax(arrays, tables, P)


def test_prep_tiles_refuses_a_bad_layout():
    with pytest.raises(ValueError, match="must not decrease"):
        prep_tiles([0, 5, 3], [1, 1], [0, 5, 3], [0, 1, 2])


def test_prep_state_tables_equal_jax(tmp_path, port_run):
    """Both packages build the same isoform tables from one annotation,
    and tables_to_torch carries the JAX PrepState's into the port's."""
    bam, gtf, _ = make_dataset(str(tmp_path), seed=4, n_frags=1500,
                               max_isoforms=3, exon_range=(58, 70),
                               chrom_len=1_500_000)
    _out, _stats, _calls, args, state = port_run(bam, gtf, True,
                                                 no_assembly=True)
    assert not state.iso_ok.all()
    js = jax_prep.PrepState(*args)
    jt = [np.asarray(getattr(js, "d_" + k)) for k in device_prep._TABLES]
    np.testing.assert_array_equal(state.iso_ok, js.iso_ok)
    carried = device_prep.tables_to_torch(*jt, "cpu")
    for k, a in zip(device_prep._TABLES, jt):
        assert state.tables[k].dtype == torch.int32
        np.testing.assert_array_equal(state.tables[k].numpy(), a)
        assert torch.equal(carried[k], state.tables[k])
    for a, b in zip(state.ref_flat, js.ref_flat):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed,kw", [
    (3, dict(n_frags=4000, max_isoforms=3)),
    (11, dict(n_frags=5000, max_isoforms=5, n_chroms=2)),
    (21, dict(n_frags=3000, paired=False, with_xs=False)),
])
def test_device_prep_matches_host(tmp_path, port_run, seed, kw):
    bam, gtf, _ = make_dataset(str(tmp_path), seed=seed, **kw)
    host_out, _ = _jax_run(bam, gtf, device_prep_mode=False)
    _jax_out, jax_stats = _jax_run(bam, gtf, device_prep_mode=True)
    out, stats, _calls, _args, _state = port_run(bam, gtf, True)
    assert out == host_out
    assert stats["device_loci"] > 0
    assert stats == jax_stats


def test_device_prep_budget_mode(tmp_path, port_run, monkeypatch):
    """Self-pacing budget mode: byte-identical, with a real device slice.
    Which loci it offloads depends on thread timing, so only the total
    matches the JAX package's run."""
    monkeypatch.setenv("STRAWB_DEVICE_PREP", "budget")
    monkeypatch.setenv("STRAWB_PREP_BUDGET", "512")
    bam, gtf, _ = make_dataset(str(tmp_path), seed=5, n_frags=4000,
                               max_isoforms=3)
    out, stats, _calls, _args, _state = port_run(bam, gtf, None)
    _jax_out, jax_stats = _jax_run(bam, gtf, device_prep_mode=None)
    monkeypatch.delenv("STRAWB_DEVICE_PREP")
    host_out, _ = _jax_run(bam, gtf, device_prep_mode=False)
    assert out == host_out
    assert stats["device_loci"] > 0 and stats["host_loci"] > 0, stats
    assert sum(stats.values()) == sum(jax_stats.values())


def test_device_prep_quant_only(tmp_path, port_run):
    bam, gtf, _ = make_dataset(str(tmp_path), seed=7, n_frags=4000,
                               max_isoforms=4)
    host_out, _ = _jax_run(bam, gtf, device_prep_mode=False,
                           no_assembly=True)
    _jax_out, jax_stats = _jax_run(bam, gtf, device_prep_mode=True,
                                   no_assembly=True)
    out, stats, _calls, _args, _state = port_run(bam, gtf, True,
                                                 no_assembly=True)
    assert out == host_out
    assert stats["device_loci"] > 0
    assert stats == jax_stats


def test_prep_state_cuda_without_gpu_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the device is found, nothing raises")
    monkeypatch.delenv("STRAWB_FORCE_HOST", raising=False)
    monkeypatch.setenv("STRAWB_PLATFORM", "cuda")
    bam, gtf, _ = make_dataset(str(tmp_path), seed=6, n_frags=800)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_driver(bam, _cfg(gtf, True), io.StringIO(), _Sink())
