"""Vectorized theoretical bin weights (bit-exact fast path).

Replaces the per-fragment-length Python loop of
LocusContext._set_theory_bin_weight (host oracle; ref: src/estimate.cpp:
201-234 + isoform.h:419-516) with numpy closed forms over the whole
fragment-length range, while preserving bit-identical float64 results:

  * the insert-size pdf is precomputed once into a dense table using
    math.exp (glibc libm — the same exp the reference's normal_pdf calls),
  * effective lengths are pure integer arithmetic (vectorized exactly),
  * per-(iso,bin) term sums run in strict left-to-right order through the
    native strawb_seqsum_batch helper (numpy's pairwise reduction would
    round differently).
"""
from __future__ import annotations

import ctypes as c
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.insert_size import InsertSize

_INV_SQRT_2PI = 0.3989422804014327


def pdf_table(dist: InsertSize, max_len: int) -> np.ndarray:
    """emp_dist_pdf(i) for i in [0, max_len] (read.cpp:274-297)."""
    tbl = np.zeros(max_len + 1, dtype=np.float64)
    mean, sd = dist.mean, dist.sd
    for i in range(max_len + 1):
        ret = 0.0
        if dist.use_emp and dist.start_offset <= i <= dist.end_offset:
            ret = dist.emp_dist[i - dist.start_offset] / dist.total_reads
        if ret == 0.0:
            a = (i - mean) / sd
            p = _INV_SQRT_2PI / sd * math.exp(-0.5 * a * a)
            ret = p if p > 0 else 0.0
        tbl[i] = ret
    return tbl


def _no_gap_ef_vec(l_left: int, l_right: int, l_int: int,
                   fl: np.ndarray) -> np.ndarray:
    mid = fl - l_int - 1
    v = np.minimum(l_left, mid) + np.minimum(l_right, mid) - mid
    bad = (fl < l_int + 2) | (fl > l_left + l_right + l_int)
    return np.where(bad, 0, v)


def _gap_ef_vec(l_left: int, l_right: int, l_int: int, rl: int,
                gap: np.ndarray) -> np.ndarray:
    start = np.maximum(rl, l_left + l_int - gap - 1)
    end = np.minimum(l_left, l_left + l_right + l_int - gap - rl)
    v = np.maximum(0, end - start)
    tot = 2 * rl + gap
    bad = (tot < l_int + 2) | (tot > l_left + l_right + l_int)
    return np.where(bad, 0, v)


def effective_len_vec(seg_lens: Sequence[int], implicit_idx: Sequence[int],
                      fl: np.ndarray, rl: int) -> np.ndarray:
    """Vectorized ExonBin::effective_len over a fragment-length vector."""
    n = len(seg_lens)
    gap = fl - 2 * rl
    if n == 1:
        return seg_lens[0] - fl + 1
    if n == 2:
        return _no_gap_ef_vec(seg_lens[0], seg_lens[1], 0, fl)
    if n == 3:
        if len(implicit_idx) == 1:
            return _gap_ef_vec(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap)
        return (_no_gap_ef_vec(seg_lens[0], seg_lens[2], seg_lens[1], fl)
                - _gap_ef_vec(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap))
    if n == 4:
        hit14 = _gap_ef_vec(seg_lens[0], seg_lens[3],
                            seg_lens[2] + seg_lens[1], rl, gap)
        hit24 = _gap_ef_vec(seg_lens[3], seg_lens[1], seg_lens[2], rl, gap)
        hit124 = _gap_ef_vec(seg_lens[0] + seg_lens[1], seg_lens[3],
                             seg_lens[2], rl, gap)
        hit13 = _gap_ef_vec(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap)
        hit134 = _gap_ef_vec(seg_lens[0], seg_lens[2] + seg_lens[3],
                             seg_lens[1], rl, gap)
        if len(implicit_idx) == 0:
            total = _no_gap_ef_vec(seg_lens[0], seg_lens[3],
                                   seg_lens[1] + seg_lens[2], fl)
            return total - (hit124 - hit14 - hit24) \
                - (hit134 - hit14 - hit13) - hit14
        if len(implicit_idx) == 2:
            return hit14
        if implicit_idx[0] == 1:
            return hit134 - hit14 - hit13
        return hit124 - hit14 - hit24

    # n >= 5: the scalar loop (isoform.h:476-514) covers a PREFIX of inner
    # segments from the left end (while first_rest > 0) and a SUFFIX from
    # the right end (while last_rest > 0); a left-end position i counts
    # when the uncovered middle equals exactly the implicit set. Both
    # coverage extents are step functions of i / bp_last, so count via
    # searchsorted over prefix/suffix sums (no inner-segment dimension;
    # the bp_last in [1, last_seg] window reflects the reference's
    # int/uint `continue` quirk at isoform.h:485).
    seg = np.asarray(seg_lens, dtype=np.int64)
    ni = n - 2
    inner_sum = int(seg[1:n - 1].sum())
    i = np.arange(1, seg_lens[0] + 1, dtype=np.int64)          # (I,)
    flv = np.asarray(fl, dtype=np.int64)[:, None]              # (F,1)
    bp_last = flv - i[None, :] - inner_sum                     # (F,I)
    valid = (bp_last >= 1) & (bp_last <= seg[-1])
    inner = np.arange(1, ni + 1)
    # prefix_j = sum seg[1..j-1] (ascending); left covers {1..l},
    # l = #{j: prefix_j < rl - i}
    prefix = np.array([seg[1:j].sum() for j in inner])
    # suffix_j = sum seg[j+1..ni] (descending); right covers {r..ni},
    # count_r = #{j: suffix_j < rl - bp}, r = ni - count_r + 1
    suffix = np.array([seg[j + 1:ni + 1].sum() for j in inner])
    l_of_i = np.searchsorted(prefix, rl - i, side="left")      # (I,)
    cr = np.searchsorted(suffix[::-1], rl - bp_last, side="left")  # (F,I)
    r_of = ni - cr + 1
    falses = sorted(implicit_idx)
    if falses:
        contiguous = all(falses[k] + 1 == falses[k + 1]
                         for k in range(len(falses) - 1))
        if not contiguous:
            return np.zeros(len(fl), np.int64)
        f1, f2 = falses[0], falses[-1]
        ok = valid & (l_of_i[None, :] == f1 - 1) & (r_of == f2 + 1)
    else:
        ok = valid & (l_of_i[None, :] + 1 >= r_of)
    return ok.sum(axis=1).astype(np.int64)


_seqsum_batch = None


def seqsum_batch(terms: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Strict sequential segment sums (native); Python fallback."""
    global _seqsum_batch
    if _seqsum_batch is None:
        try:
            from ..io.native import get_lib
            lib = get_lib()
            lib.strawb_seqsum_batch.restype = None
            lib.strawb_seqsum_batch.argtypes = [
                c.POINTER(c.c_double), c.POINTER(c.c_int64), c.c_int64,
                c.POINTER(c.c_double)]
            _seqsum_batch = lib.strawb_seqsum_batch
        except Exception:
            _seqsum_batch = False
    nseg = len(offsets) - 1
    out = np.zeros(nseg, dtype=np.float64)
    if _seqsum_batch:
        terms = np.ascontiguousarray(terms, dtype=np.float64)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        _seqsum_batch(terms.ctypes.data_as(c.POINTER(c.c_double)),
                      offsets.ctypes.data_as(c.POINTER(c.c_int64)),
                      nseg, out.ctypes.data_as(c.POINTER(c.c_double)))
    else:
        for k in range(nseg):
            s = 0.0
            for v in terms[offsets[k]:offsets[k + 1]]:
                s += v
            out[k] = s
    return out


# ---------------------------------------------------------------------------
# Whole-locus batched closed forms: every (iso,bin) pair's fragment-length
# range concatenates into one element array; each pair's effective length is
# a +/- combination of at most 6 primitive evaluations (no_gap_ef / gap_ef /
# linear), evaluated vectorized with per-element parameters. Pairs with >4
# segments fall back to effective_len_vec (rare).

def pair_primitives(seg_lens, implicit_idx):
    """Return [(coef, kind, a, b, c)] with kind 1=no_gap(a,b,c; fl),
    2=gap(a,b,c; rl, gap), 3=linear a-fl+1; or None for >4 segments."""
    n = len(seg_lens)
    s = seg_lens
    if n == 1:
        return [(1, 3, s[0], 0, 0)]
    if n == 2:
        return [(1, 1, s[0], s[1], 0)]
    if n == 3:
        if len(implicit_idx) == 1:
            return [(1, 2, s[0], s[2], s[1])]
        return [(1, 1, s[0], s[2], s[1]), (-1, 2, s[0], s[2], s[1])]
    if n == 4:
        h14 = (2, s[0], s[3], s[2] + s[1])
        h24 = (2, s[3], s[1], s[2])
        h124 = (2, s[0] + s[1], s[3], s[2])
        h13 = (2, s[0], s[2], s[1])
        h134 = (2, s[0], s[2] + s[3], s[1])
        if len(implicit_idx) == 0:
            # total - (h124-h14-h24) - (h134-h14-h13) - h14
            return [(1, 1, s[0], s[3], s[1] + s[2]),
                    (-1,) + h124, (1,) + h14, (1,) + h24,
                    (-1,) + h134, (1,) + h13]
        if len(implicit_idx) == 2:
            return [(1,) + h14]
        if implicit_idx[0] == 1:
            return [(1,) + h134, (-1,) + h14, (-1,) + h13]
        return [(1,) + h124, (-1,) + h14, (-1,) + h24]
    return None


def batched_effective_terms(pair_specs, rl, tbl):
    """pair_specs: list of (seg_lens, implicit_idx, lmin, lmax, iso_len).
    Returns (terms flat f64 array, offsets) where terms[i] =
    pdf(fl)*eff(fl)/(iso_len-fl+1) in fl order per pair."""
    offsets = [0]
    lmins = []
    lmaxs = []
    counts = []
    prim_rows = []   # per pair: list of primitives or None
    iso_lens = []
    for seg_lens, implicit_idx, lmin, lmax, iso_len in pair_specs:
        cnt = max(0, lmax - lmin + 1)
        counts.append(cnt)
        lmins.append(lmin)
        lmaxs.append(lmax)
        iso_lens.append(iso_len)
        prim_rows.append(pair_primitives(seg_lens, implicit_idx))
        offsets.append(offsets[-1] + cnt)
    total = offsets[-1]
    if total == 0:
        return np.zeros(0, np.float64), np.asarray(offsets, np.int64)
    counts_a = np.asarray(counts, np.int64)
    lmin_a = np.asarray(lmins, np.int64)
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.asarray(offsets[:-1], np.int64), counts_a)
    fl = np.repeat(lmin_a, counts_a) + pos
    eff = np.zeros(total, np.int64)
    # vectorize primitive slots (up to 6 per pair)
    max_slots = max((len(p) for p in prim_rows if p is not None), default=0)
    P = len(pair_specs)
    for slot in range(max_slots):
        coef = np.zeros(P, np.int64)
        kind = np.zeros(P, np.int64)
        pa = np.zeros(P, np.int64)
        pb = np.zeros(P, np.int64)
        pc = np.zeros(P, np.int64)
        for i, prims in enumerate(prim_rows):
            if prims is not None and slot < len(prims):
                coef[i], kind[i], pa[i], pb[i], pc[i] = prims[slot]
        ce = np.repeat(coef, counts_a)
        ke = np.repeat(kind, counts_a)
        ae = np.repeat(pa, counts_a)
        be = np.repeat(pb, counts_a)
        cce = np.repeat(pc, counts_a)
        gap = fl - 2 * rl
        v_nogap = _no_gap_ef_vec_params(ae, be, cce, fl)
        v_gap = _gap_ef_vec_params(ae, be, cce, rl, gap)
        v_lin = ae - fl + 1
        v = np.where(ke == 1, v_nogap,
                     np.where(ke == 2, v_gap,
                              np.where(ke == 3, v_lin, 0)))
        eff += ce * v
    # >4-segment pairs: scalar fallback per pair
    for i, prims in enumerate(prim_rows):
        if prims is None and counts[i]:
            seg_lens, implicit_idx, lmin, lmax, _L = pair_specs[i]
            flv = np.arange(lmin, lmax + 1, dtype=np.int64)
            eff[offsets[i]:offsets[i + 1]] = effective_len_vec(
                seg_lens, implicit_idx, flv, rl)
    iso_e = np.repeat(np.asarray(iso_lens, np.int64), counts_a)
    terms = tbl[fl] * eff / (iso_e - fl + 1)
    return terms, np.asarray(offsets, np.int64)


def _no_gap_ef_vec_params(l_left, l_right, l_int, fl):
    mid = fl - l_int - 1
    v = np.minimum(l_left, mid) + np.minimum(l_right, mid) - mid
    bad = (fl < l_int + 2) | (fl > l_left + l_right + l_int)
    return np.where(bad, 0, v)


def _gap_ef_vec_params(l_left, l_right, l_int, rl, gap):
    start = np.maximum(rl, l_left + l_int - gap - 1)
    end = np.minimum(l_left, l_left + l_right + l_int - gap - rl)
    v = np.maximum(0, end - start)
    tot = 2 * rl + gap
    bad = (tot < l_int + 2) | (tot > l_left + l_right + l_int)
    return np.where(bad, 0, v)
