"""Array-native locus quantification (no per-read Python objects).

Builds the exact LocusContext state (exon bins, counts, iso->bin map) from
the native clusterizer's flat RLE arrays using the C++ compat kernel plus
numpy grouping, then reuses LocusContext's weight/EM/finalize machinery.
Byte-identical to the oracle path (goldens cover it); used on the hot
quantification pass when the fragment-context export is off (that path
needs the per-fragment objects).
"""
from __future__ import annotations

import ctypes as C
from typing import List, Optional

import numpy as np

from ..config import Config
from ..core.features import Contig, is_compatible_feat, S_MATCH
from ..core.insert_size import InsertSize
from .bins import Coords, ExonBin, disjoint_exon_segs
from .locus import Isoform, LocusContext


def build_fast_locus(cfg: Config, read_len: int,
                     insert_dist: Optional[InsertSize],
                     hit_flat, hit_masses: np.ndarray,
                     transcripts: List[Contig],
                     long_read_sample: bool = False,
                     iso_flat=None) -> LocusContext:
    """LocusContext equivalent from flat hit arrays.

    hit_flat: (off, code, left, len) for the locus's valid uniq contigs,
    hit_masses: per-contig collapse masses aligned with hit_flat."""
    from ..core.fastcluster import native_compat

    est = LocusContext.__new__(LocusContext)
    est.cfg = cfg
    est.read_len = read_len
    est.insert_dist = insert_dist
    est._hit_flat = hit_flat

    exons = []
    for t in transcripts:
        for f in t.feats:
            if f[0] == S_MATCH:
                exons.append(f)
    exons = sorted(set(exons), key=lambda f: (f[1], f[2]))
    est.exon_segs = disjoint_exon_segs(exons)

    est.transcripts = []
    for t in transcripts:
        iso_segs = [s for s in est.exon_segs if is_compatible_feat(t, s)]
        iso = Isoform(contig=t, length=t.exonic_length(),
                      gene_str=t.parent_id, isoform_str=t.trans_id,
                      ref_gene_id=t.ref_gene_id,
                      ref_gene_name=t.ref_gene_name, exon_segs=iso_segs)
        iso.id = len(est.transcripts)
        est.transcripts.append(iso)

    est.exon_bins = []
    est._bin_index = {}
    est.iso_2_bins_map = {}

    nh = len(hit_flat[0]) - 1
    ni = len(est.transcripts)
    ns = len(est.exon_segs)
    if nh and ni and ns:
        compat, _fraglen, seghit, fragkey = native_compat(
            None, [t.contig for t in est.transcripts], est.exon_segs,
            hit_flat=hit_flat, iso_flat=iso_flat, want_fragkey=True)
        keep = compat.any(axis=1) & seghit.any(axis=1)
        idx = np.nonzero(keep)[0]
        if len(idx):
            sh = seghit[idx]
            # group identical seg-overlap rows into bins, first-encounter
            # order (the oracle creates bins in hit order); 1-D unique over
            # a void view is much faster than axis=0 row sorting
            shc = np.ascontiguousarray(sh)
            rowview = shc.view(np.dtype((np.void, shc.shape[1])))[:, 0]
            _vals, first_idx, inverse = np.unique(
                rowview, return_index=True, return_inverse=True)
            uniq_rows = shc[first_idx]
            order = np.argsort(first_idx, kind="stable")
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            bin_id = rank[inverse]                 # per kept hit
            nbins = len(order)
            seg_coords = [(f[1], f[1] + f[2] - 1) for f in est.exon_segs]
            # per-bin counts: fragment-set dedupe by (left,len)-seq key,
            # first occurrence's mass wins (ExonBin._frags std::set)
            keys = fragkey[idx]
            combo = bin_id.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) \
                + keys  # injective enough: 64-bit mix of (bin, fragkey)
            _u, ufirst = np.unique(combo, return_index=True)
            counts = np.zeros(nbins, np.float64)
            np.add.at(counts, bin_id[ufirst], hit_masses[idx][ufirst])
            # per-(bin,iso) presence
            M = np.zeros((nbins, ni), bool)
            hrow, icol = np.nonzero(compat[idx])
            M[bin_id[hrow], icol] = True

            for b in range(nbins):
                coords: Coords = tuple(
                    seg_coords[j]
                    for j in np.nonzero(uniq_rows[order[b]])[0])
                eb = ExonBin(coords, frag_masses={0: float(counts[b])})
                eb.id = b
                est.exon_bins.append(eb)
                est._bin_index[coords] = b
            for j in range(ni):
                bins = np.nonzero(M[:, j])[0]
                if len(bins):
                    est.iso_2_bins_map[j] = [int(x) for x in bins]

    if long_read_sample:
        est._set_bin_weight_without_frag_dist()
    else:
        est._set_theory_bin_weight()
    return est


# ---------------------------------------------------------------------------
# Whole-pass native quant prep: ONE C++ call computes every locus's EM
# inputs (bin counts + weight matrix) from concatenated flat RLE arrays —
# no per-locus Python work at all (quantprep.cc; bit-identical to
# build_fast_locus, which is bit-identical to the oracle).

_quant_bound = False


def _bind_quant(lib):
    global _quant_bound
    if _quant_bound:
        return
    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    PD = C.POINTER(C.c_double)
    lib.strawb_quant_batch.restype = C.c_void_p
    lib.strawb_quant_batch.argtypes = [
        C.c_int64, P64, P64,
        P64, P8, P64, P32, PD,
        P64, P8, P64, P32, P64,
        PD, C.c_int64, C.c_int64, C.c_int64, C.c_int32]
    for name, rt in [("nbins", P64), ("binoff", P64), ("counts", PD),
                     ("alphaoff", P64), ("alpha", PD)]:
        fn = getattr(lib, f"strawb_quant_{name}")
        fn.restype = rt
        fn.argtypes = [C.c_void_p]
    for name in ["total_bins", "total_alpha"]:
        fn = getattr(lib, f"strawb_quant_{name}")
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p]
    lib.strawb_quant_free.restype = None
    lib.strawb_quant_free.argtypes = [C.c_void_p]
    _quant_bound = True


def _concat_flats(flats):
    """Concatenate per-locus flat RLE tuples; returns (loc_off, off, code,
    left, len) with feature offsets rebased into the concatenation."""
    nloc = len(flats)
    loc_off = np.zeros(nloc + 1, np.int64)
    fbase = np.zeros(nloc + 1, np.int64)
    for i, f in enumerate(flats):
        loc_off[i + 1] = loc_off[i] + len(f[0]) - 1
        fbase[i + 1] = fbase[i] + int(f[0][-1])
    off = np.zeros(int(loc_off[-1]) + 1, np.int64)
    pos = 1
    for i, f in enumerate(flats):
        n = len(f[0]) - 1
        off[pos:pos + n] = f[0][1:] + fbase[i]
        pos += n
    code = np.concatenate([f[1] for f in flats]) if nloc else \
        np.zeros(0, np.int8)
    left = np.concatenate([f[2] for f in flats]) if nloc else \
        np.zeros(0, np.int64)
    ln = np.concatenate([f[3] for f in flats]) if nloc else \
        np.zeros(0, np.int32)
    return (loc_off, np.ascontiguousarray(off),
            np.ascontiguousarray(code, np.int8),
            np.ascontiguousarray(left, np.int64),
            np.ascontiguousarray(ln, np.int32))


def build_prebuilt_locus(cfg: Config, read_len: int,
                         insert_dist: Optional[InsertSize],
                         transcripts, exlens, counts, alpha) -> LocusContext:
    """LocusContext-lite over EM inputs already computed natively (the
    quant-fused clusterizer); mirrors build_batch_native's tail."""
    est = LocusContext.__new__(LocusContext)
    est.cfg = cfg
    est.read_len = read_len
    est.insert_dist = insert_dist
    est.exon_bins = []
    est.iso_2_bins_map = {}
    est.transcripts = []
    for t, L in zip(transcripts, exlens):
        iso = Isoform(contig=t, length=int(L), gene_str=t.parent_id,
                      isoform_str=t.trans_id, ref_gene_id=t.ref_gene_id,
                      ref_gene_name=t.ref_gene_name)
        iso.id = len(est.transcripts)
        est.transcripts.append(iso)
    ni = len(est.transcripts)
    nb = len(counts)
    # build_problem truncates counts to int (estimate.cpp:284-288).
    # COPY alpha: the incoming slice views the partition's native cluster
    # pool, and holding it until em_finish would pin every partition
    # handle in RAM for the whole pass (the --low-mem linear-growth bug)
    est._prebuilt = (np.trunc(counts),
                     np.array(alpha, np.float64).reshape(nb, ni))
    return est


def build_batch_native(cfg: Config, read_len: int,
                       insert_dist: Optional[InsertSize],
                       specs, long_read_sample: bool = False
                       ) -> List[LocusContext]:
    """specs: list of (hit_flat, hit_masses, transcripts, iso_flat) — one
    per locus. Returns LocusContext-lites holding prebuilt (n, alpha) EM
    problems (LocusContext.build_problem short-circuits on _prebuilt)."""
    from ..io.native import get_lib
    from .binweights import pdf_table

    lib = get_lib()
    _bind_quant(lib)

    hit_loc, h_off, h_code, h_left, h_len = _concat_flats(
        [s[0] for s in specs])
    iso_loc, t_off, t_code, t_left, t_len = _concat_flats(
        [s[3] for s in specs])
    h_mass = np.ascontiguousarray(
        np.concatenate([np.asarray(s[1], np.float64) for s in specs])
        if specs else np.zeros(0), np.float64)

    # exonic lengths per transcript, vectorized over the concatenated flat
    mlen = np.where(t_code == 0, t_len.astype(np.int64), 0)
    cs = np.concatenate([np.zeros(1, np.int64), np.cumsum(mlen)])
    t_exlen = np.ascontiguousarray(cs[t_off[1:]] - cs[t_off[:-1]], np.int64)

    if long_read_sample or insert_dist is None:
        tbl = np.zeros(1, np.float64)
        base_lmin = 0
    else:
        max_len = int(t_exlen.max()) if len(t_exlen) else 0
        tbl = getattr(insert_dist, "_pdf_table", None)
        if tbl is None or len(tbl) <= max_len:
            tbl = pdf_table(insert_dist, max(max_len, 4096))
            insert_dist._pdf_table = tbl
        base_lmin = insert_dist.start_offset if insert_dist.use_emp \
            else read_len

    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    PD = C.POINTER(C.c_double)
    q = lib.strawb_quant_batch(
        len(specs),
        hit_loc.ctypes.data_as(P64), iso_loc.ctypes.data_as(P64),
        h_off.ctypes.data_as(P64), h_code.ctypes.data_as(P8),
        h_left.ctypes.data_as(P64), h_len.ctypes.data_as(P32),
        h_mass.ctypes.data_as(PD),
        t_off.ctypes.data_as(P64), t_code.ctypes.data_as(P8),
        t_left.ctypes.data_as(P64), t_len.ctypes.data_as(P32),
        t_exlen.ctypes.data_as(P64),
        tbl.ctypes.data_as(PD), len(tbl), read_len, base_lmin,
        1 if long_read_sample else 0)
    try:
        nloc = len(specs)
        total_b = lib.strawb_quant_total_bins(q)
        total_a = lib.strawb_quant_total_alpha(q)

        def arr(ptr, n, dt):
            if n == 0:
                return np.zeros(0, dt)
            return np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(
                dt, copy=True)

        bin_off = arr(lib.strawb_quant_binoff(q), nloc + 1, np.int64)
        alpha_off = arr(lib.strawb_quant_alphaoff(q), nloc + 1, np.int64)
        counts = arr(lib.strawb_quant_counts(q), total_b, np.float64)
        alpha = arr(lib.strawb_quant_alpha(q), total_a, np.float64)
    finally:
        lib.strawb_quant_free(q)

    out = []
    for k, (_hf, _hm, transcripts, _if) in enumerate(specs):
        est = LocusContext.__new__(LocusContext)
        est.cfg = cfg
        est.read_len = read_len
        est.insert_dist = insert_dist
        est.exon_bins = []
        est.iso_2_bins_map = {}
        est.transcripts = []
        tb = int(iso_loc[k])
        for t in transcripts:
            iso = Isoform(contig=t, length=int(t_exlen[tb + len(
                est.transcripts)]), gene_str=t.parent_id,
                isoform_str=t.trans_id, ref_gene_id=t.ref_gene_id,
                ref_gene_name=t.ref_gene_name)
            iso.id = len(est.transcripts)
            est.transcripts.append(iso)
        ni = len(transcripts)
        b0, b1 = int(bin_off[k]), int(bin_off[k + 1])
        # build_problem truncates counts to int (estimate.cpp:284-288)
        n = np.trunc(counts[b0:b1])
        a = alpha[int(alpha_off[k]):int(alpha_off[k + 1])].reshape(
            b1 - b0, ni)
        est._prebuilt = (n, a)
        out.append(est)
    return out
