"""Native clusterizer binding + HitCluster-compatible views.

Runs the whole streaming cluster scan (pairing, collapse, contig building,
strand refinement) in C++ (native/cluster.cc) and exposes each locus as a
lightweight NativeCluster duck-typed like core.cluster.HitCluster for the
pipeline. Validated cluster-for-cluster against the Python oracle by
tests/test_native_cluster.py.
"""
from __future__ import annotations

import ctypes as C
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..io.bamreader import HitTable
from .cluster import Segment
from .features import Contig, FeatView

_bound = False


def _bind(lib):
    global _bound
    if _bound:
        return lib
    i64p = C.POINTER(C.c_int64)
    i32p = C.POINTER(C.c_int32)
    i8p = C.POINTER(C.c_int8)
    u16p = C.POINTER(C.c_uint16)
    u64p = C.POINTER(C.c_uint64)
    dp = C.POINTER(C.c_double)
    lib.strawb_cluster_run.restype = C.c_void_p
    run_args = (
        [C.c_int64] + [i32p, i64p, i64p, i8p, u16p, i32p, i64p, i32p,
                       u64p, u64p, i64p, i8p, i64p, i32p]
        + [C.c_int64, i32p, i64p, i64p, i32p, i8p]
        + [C.c_int64] * 3 + [C.c_int32] * 4)
    lib.strawb_cluster_run.argtypes = run_args
    lib.strawb_cluster_start.restype = C.c_void_p
    lib.strawb_cluster_start.argtypes = run_args + [C.c_int32]
    lib.strawb_cluster_job_parts.restype = C.c_int64
    lib.strawb_cluster_job_parts.argtypes = [C.c_void_p]
    lib.strawb_cluster_job_wait.restype = C.c_void_p
    lib.strawb_cluster_job_wait.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_cluster_job_free.restype = None
    lib.strawb_cluster_job_free.argtypes = [C.c_void_p]
    lib.strawb_cluster_start_fused.restype = C.c_void_p
    lib.strawb_cluster_start_fused.argtypes = run_args + [
        C.c_int32, C.c_int64, i64p, i8p, i64p, i32p, dp, dp, i64p]
    lib.strawb_cluster_start_qfused.restype = C.c_void_p
    lib.strawb_cluster_start_qfused.argtypes = run_args + [
        C.c_int32, C.c_int64, i64p, i8p, i64p, i32p, i64p, dp,
        C.c_int64, C.c_int64, C.c_int32]
    sbam_args = ([C.c_void_p]
                 + [C.c_int64, i32p, i64p, i64p, i32p, i8p]
                 + [C.c_int64] * 3 + [C.c_int32] * 6)  # incl. drop_consumed
    lib.strawb_cluster_start_sbam.restype = C.c_void_p
    lib.strawb_cluster_start_sbam.argtypes = sbam_args
    lib.strawb_cluster_start_sbam_fused.restype = C.c_void_p
    lib.strawb_cluster_start_sbam_fused.argtypes = sbam_args + [
        C.c_int64, i64p, i8p, i64p, i32p, dp, dp, i64p]
    lib.strawb_cluster_start_sbam_qfused.restype = C.c_void_p
    lib.strawb_cluster_start_sbam_qfused.argtypes = sbam_args + [
        C.c_int64, i64p, i8p, i64p, i32p, i64p, dp,
        C.c_int64, C.c_int64, C.c_int32]
    lib.strawb_cluster_job_wait_next.restype = C.c_void_p
    lib.strawb_cluster_job_wait_next.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_cluster_qfused.restype = C.c_int32
    lib.strawb_cluster_qfused.argtypes = [C.c_void_p]
    for name in ("qnbins", "qnalpha"):
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p]
    for name, pt in [("qbinoff", i64p), ("qalphaoff", i64p),
                     ("qcounts", dp), ("qalpha", dp)]:
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = pt
        fn.argtypes = [C.c_void_p]
    lib.strawb_cluster_fused.restype = C.c_int32
    lib.strawb_cluster_fused.argtypes = [C.c_void_p]
    lib.strawb_cluster_nunit.restype = C.c_int64
    lib.strawb_cluster_nunit.argtypes = [C.c_void_p]
    for name, pt in [("unitoff", i64p), ("unitjob", i64p),
                     ("unitkind", i8p), ("unitstrand", i8p),
                     ("unitl", i64p), ("unitr", i64p), ("admit", i8p),
                     ("goff", i64p), ("gcode", i8p), ("gleft", i64p),
                     ("glen", i32p), ("gmass", dp), ("vcum", i64p)]:
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = pt
        fn.argtypes = [C.c_void_p]
    for name in ("nvalid", "ngfeat"):
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p]
    for name, rt in [("n", C.c_int64), ("nct", C.c_int64),
                     ("nrefidx", C.c_int64), ("nseg", C.c_int64)]:
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = rt
        fn.argtypes = [C.c_void_p]
    for name, pt in [("left", i64p), ("right", i64p), ("refid", i32p),
                     ("wmass", dp), ("refoff", i64p), ("refidx", i32p),
                     ("uniqoff", i64p), ("segoff", i64p),
                     ("ctstrand", i8p), ("ctorit", i8p), ("ctmass", dp),
                     ("ctvalid", i8p),
                     ("segleft", i64p), ("segright", i64p),
                     ("seglidx", i64p), ("segridx", i64p),
                     ("segstrand", i8p)]:
        fn = getattr(lib, f"strawb_cluster_{name}")
        fn.restype = pt
        fn.argtypes = [C.c_void_p]
    lib.strawb_cluster_free.restype = None
    lib.strawb_cluster_free.argtypes = [C.c_void_p]
    _bound = True
    return lib


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(dtype,
                                                             copy=True)


class _ClusterPool:
    """Shared arrays backing every NativeCluster of one clustering run;
    per-cluster views are cut lazily on first attribute access."""

    __slots__ = ("ct_strand", "ct_orit", "ct_mass", "valid_all",
                 "gmass", "goff", "gcode", "gleft", "glen",
                 "uniq_off", "vcum", "vcum_full", "goff_l",
                 "seg_off", "seg_args")


class NativeCluster:
    """Duck-typed core.cluster.HitCluster view over native outputs.

    Per-read Python Contig objects — and the per-cluster array views
    themselves — are materialized LAZILY from the shared _ClusterPool; the
    many tiny clusters skipped by the assembly admission test never pay
    for their flat arrays."""

    __slots__ = ("leftmost", "rightmost", "ref_id", "weighted_mass",
                 "ref_mrnas", "id", "cfg", "ref_indices",
                 "_n_uniq", "_uniq_cache", "_pool", "_k",
                 "_flat", "_flat_mass", "_rawc", "_segs", "prep_units",
                 "quant_prebuilt")

    def __init__(self):
        self.id = -1
        self._uniq_cache = None
        self._pool = None
        self._flat = None
        self._flat_mass = None
        self._rawc = None
        self._segs = None
        self.prep_units = None  # (admitted, [(kind, strand, l, r, job)])
        self.quant_prebuilt = None  # (counts view, alpha view) when qfused

    # the pipeline treats uniq_hits entries as opaque tokens passed back
    # through pair_to_contig; natively they ARE the contigs (or None)
    def pair_to_contig(self, c):
        return c

    @property
    def _raw(self):
        if self._rawc is None:
            p = self._pool
            a0, a1 = p.uniq_off[self._k], p.uniq_off[self._k + 1]
            # per-contig feature runs live in the valid gather: contig ci's
            # features are g[goff[vcum[ci]] : goff[vcum[ci]+1]] (invalid
            # contigs get an empty run since vcum doesn't advance)
            featoff_k = p.goff[p.vcum_full[a0:a1 + 1]]
            f0, f1 = int(featoff_k[0]), int(featoff_k[-1])
            self._rawc = (p.ct_strand[a0:a1], p.ct_orit[a0:a1],
                          p.ct_mass[a0:a1], p.valid_all[a0:a1],
                          featoff_k - f0,
                          p.gcode[f0:f1], p.gleft[f0:f1],
                          p.glen[f0:f1])
        return self._rawc

    @property
    def flat(self):
        if self._flat is None:
            p = self._pool
            a0, a1 = p.uniq_off[self._k], p.uniq_off[self._k + 1]
            v0, v1 = p.vcum[a0], p.vcum[a1]
            s0, s1 = p.goff_l[v0], p.goff_l[v1]
            self._flat = (p.goff[v0:v1 + 1] - s0,
                          p.gcode[s0:s1], p.gleft[s0:s1], p.glen[s0:s1])
        return self._flat

    @property
    def flat_mass(self):
        if self._flat_mass is None:
            p = self._pool
            a0, a1 = p.uniq_off[self._k], p.uniq_off[self._k + 1]
            self._flat_mass = p.gmass[p.vcum[a0]:p.vcum[a1]]
        return self._flat_mass

    @property
    def segs(self):
        if self._segs is None:
            p = self._pool
            self._segs = [Segment(*p.seg_args[s])
                          for s in range(p.seg_off[self._k],
                                         p.seg_off[self._k + 1])]
        return self._segs

    @property
    def uniq_hits(self) -> List[Optional[Contig]]:
        if self._uniq_cache is None:
            (strand, orit, mass, valid, featoff, fcode, fleft, flen) =                 self._raw
            uniq: List[Optional[Contig]] = []
            for ci in range(len(strand)):
                if not valid[ci]:
                    uniq.append(None)
                    continue
                a, b = featoff[ci], featoff[ci + 1]
                feats = [(int(fcode[f]), int(fleft[f]), int(flen[f]))
                         for f in range(a, b)]
                uniq.append(Contig(ref_id=self.ref_id,
                                   strand=int(strand[ci]), feats=feats,
                                   mass=float(mass[ci]), contig_id=0,
                                   single_orit=int(orit[ci])))
            self._uniq_cache = uniq
        return self._uniq_cache

    def uniq_hit_contigs(self) -> List[Contig]:
        return [c for c in self.uniq_hits if c is not None]

    @property
    def valid_mask(self):
        return self._raw[3]

    @property
    def valid_strands(self):
        """strand per VALID contig, aligned with flat/flat_mass order."""
        return self._raw[0][self._raw[3]]

    @property
    def valid_positions(self):
        """uniq-hit index of each VALID contig."""
        return np.nonzero(self._raw[3])[0]

    def refine_cluster(self):
        pass  # segs precomputed natively

    def ref_strand(self) -> int:
        return self.ref_mrnas[0].strand

    def size(self) -> int:
        return self._n_uniq

    def num_uniq(self) -> int:
        return self._n_uniq


def _pack_refs(ref_mrnas: List[Contig], ref_flat=None):
    """Reference-transcript bounds + gene codes as flat arrays (the refs
    half of the clusterizer's inputs). With ref_flat (the refs' flat RLE,
    same order) the per-transcript bounds come from the arrays — no
    Python feature access (and no lazy FeatView materialization)."""
    n = len(ref_mrnas)
    gene_codes: Dict[str, int] = {}
    gl: List[int] = []
    for r in ref_mrnas:
        pid = r.parent_id
        if pid == "":
            gl.append(-1)
        else:
            code = gene_codes.get(pid)
            if code is None:
                code = len(gene_codes)
                gene_codes[pid] = code
            gl.append(code)
    rgene = np.asarray(gl, np.int32)
    rref = np.fromiter((r.ref_id for r in ref_mrnas), np.int32, n)
    if ref_flat is not None and len(ref_flat[0]) - 1 == n:
        off, _code, left, lens = ref_flat
        e = off[1:] - 1
        rleft = np.ascontiguousarray(left[off[:-1]])
        rright = np.ascontiguousarray(left[e] + lens[e] - 1)
    else:
        rleft = np.fromiter((r.feats[0][1] for r in ref_mrnas), np.int64, n)
        rright = np.fromiter(
            (f[1] + f[2] - 1 for f in (r.feats[-1] for r in ref_mrnas)),
            np.int64, n)
    rstrand = np.fromiter((r.strand for r in ref_mrnas), np.int8, n)
    return rref, rleft, rright, rgene, rstrand


def _pack_cluster_inputs(table: HitTable, cfg: Config,
                         ref_mrnas: List[Contig], mode: str,
                         ref_flat=None):
    """Marshal (hits, refs, cfg) into the flat ctypes argument list shared
    by strawb_cluster_run and strawb_cluster_start. Returns (args, keep)
    where `keep` holds the numpy arrays alive for the call's duration."""
    rref, rleft, rright, rgene, rstrand = _pack_refs(ref_mrnas, ref_flat)

    t = table

    def p(a, ct):
        a = np.ascontiguousarray(a)
        return a.ctypes.data_as(C.POINTER(ct)), a  # keep alive

    keep = []

    def q(a, ct):
        ptr, arr = p(a, ct)
        keep.append(arr)
        return ptr

    args = [
        len(t),
        q(t.ref_id, C.c_int32), q(t.left, C.c_int64), q(t.right, C.c_int64),
        q(t.strand, C.c_int8), q(t.flag, C.c_uint16),
        q(t.mate_ref, C.c_int32), q(t.mate_pos, C.c_int64),
        q(t.nh, C.c_int32), q(t.read_id, C.c_uint64),
        q(t.cigar_hash, C.c_uint64), q(t.feat_off, C.c_int64),
        q(t.feat_code, C.c_int8), q(t.feat_left, C.c_int64),
        q(t.feat_len, C.c_int32),
        len(ref_mrnas), q(rref, C.c_int32), q(rleft, C.c_int64),
        q(rright, C.c_int64), q(rgene, C.c_int32), q(rstrand, C.c_int8),
        cfg.max_olap_dist, cfg.max_intron_length, cfg.max_frag_span,
        1 if cfg.enforce_ref_models else 0,
        1 if cfg.utilize_ref_models else 0,
        cfg.min_read_for_assemb,
        1 if mode == "refdemand" else 0]
    return args, keep


def run_native_clustering(table: HitTable, cfg: Config,
                          ref_mrnas: List[Contig],
                          mode: str) -> List[NativeCluster]:
    """mode: 'refguide' (pass 1) or 'refdemand' (pass 2)."""
    from ..io.native import get_lib
    lib = _bind(get_lib())
    args, keep = _pack_cluster_inputs(table, cfg, ref_mrnas, mode)
    h = lib.strawb_cluster_run(*args)
    del keep
    return _decode_cluster_handle(lib, h, cfg, ref_mrnas)


def stream_native_clustering(table: HitTable, cfg: Config,
                             ref_mrnas: List[Contig], mode: str,
                             fuse_read_len: Optional[int] = None,
                             fuse_quant=None, ref_flat=None):
    """Streaming variant: yields NativeClusters per chromosome partition
    while the native workers are still clustering later partitions (the
    blocking wait releases the GIL).

    With fuse_read_len set (pass 1), the clustering workers additionally run
    the per-cluster assembly prep (admission + ref/seg units) and submit
    each unit to the native assembleprep pool; the yielded clusters carry
    `prep_units` for pipeline.prepare_cluster_assembly."""
    from ..io.native import get_lib
    lib = _bind(get_lib())
    from ..io.sbam import StreamingHitTable
    streaming = isinstance(table, StreamingHitTable)
    if streaming:
        # hits come straight from the decode stream's chromosome blocks;
        # only the refs + cfg are marshaled here
        rref, rleft, rright, rgene, rstrand = _pack_refs(ref_mrnas,
                                                         ref_flat)
        keep = [rref, rleft, rright, rgene, rstrand]
        args = [
            table.handle, len(ref_mrnas),
            rref.ctypes.data_as(C.POINTER(C.c_int32)),
            rleft.ctypes.data_as(C.POINTER(C.c_int64)),
            rright.ctypes.data_as(C.POINTER(C.c_int64)),
            rgene.ctypes.data_as(C.POINTER(C.c_int32)),
            rstrand.ctypes.data_as(C.POINTER(C.c_int8)),
            cfg.max_olap_dist, cfg.max_intron_length, cfg.max_frag_span,
            1 if cfg.enforce_ref_models else 0,
            1 if cfg.utilize_ref_models else 0,
            cfg.min_read_for_assemb,
            1 if mode == "refdemand" else 0]
        starters = (lib.strawb_cluster_start_sbam,
                    lib.strawb_cluster_start_sbam_fused,
                    lib.strawb_cluster_start_sbam_qfused)
        tail = [0, 1 if table.low_mem else 0]  # n_threads, drop_consumed
    else:
        args, keep = _pack_cluster_inputs(table, cfg, ref_mrnas, mode,
                                          ref_flat)
        starters = (lib.strawb_cluster_start, lib.strawb_cluster_start_fused,
                    lib.strawb_cluster_start_qfused)
        tail = [0]  # n_threads
    if fuse_read_len is not None:
        rf = ref_flat if ref_flat is not None else flatten_contigs(ref_mrnas)
        rf = tuple(np.ascontiguousarray(a) for a in rf)
        rmass = np.ascontiguousarray(
            np.array([r.mass for r in ref_mrnas], np.float64))
        dcfg = np.array([cfg.min_anchor, cfg.min_depth_4_locus,
                         cfg.min_isoform_frac, cfg.min_junc_support,
                         cfg.min_support_for_long_junc,
                         cfg.binomial_overhang_alpha,
                         cfg.intron_edge_weight,
                         cfg.min_depth_4_contig], np.float64)
        icfg = np.array([cfg.long_junc_length,
                         1 if cfg.enforce_ref_models else 0,
                         cfg.max_cover_gap1, cfg.max_cover_gap2,
                         cfg.min_dist_4_exon_edge, cfg.min_trans_len,
                         1 if native_solve_enabled() else 0], np.int64)
        keep += [rf, rmass, dcfg, icfg]
        job = starters[1](
            *args, *tail, fuse_read_len,
            rf[0].ctypes.data_as(C.POINTER(C.c_int64)),
            rf[1].ctypes.data_as(C.POINTER(C.c_int8)),
            rf[2].ctypes.data_as(C.POINTER(C.c_int64)),
            rf[3].ctypes.data_as(C.POINTER(C.c_int32)),
            rmass.ctypes.data_as(C.POINTER(C.c_double)),
            dcfg.ctypes.data_as(C.POINTER(C.c_double)),
            icfg.ctypes.data_as(C.POINTER(C.c_int64)))
    elif fuse_quant is not None:
        read_len, rf, rexlen, pdf, base_lmin, long_read = fuse_quant
        rf = tuple(np.ascontiguousarray(a) for a in rf)
        rexlen = np.ascontiguousarray(rexlen, np.int64)
        pdf = np.ascontiguousarray(pdf, np.float64)
        keep += [rf, rexlen, pdf]
        job = starters[2](
            *args, *tail, read_len,
            rf[0].ctypes.data_as(C.POINTER(C.c_int64)),
            rf[1].ctypes.data_as(C.POINTER(C.c_int8)),
            rf[2].ctypes.data_as(C.POINTER(C.c_int64)),
            rf[3].ctypes.data_as(C.POINTER(C.c_int32)),
            rexlen.ctypes.data_as(C.POINTER(C.c_int64)),
            pdf.ctypes.data_as(C.POINTER(C.c_double)),
            len(pdf), base_lmin, 1 if long_read else 0)
    else:
        job = starters[0](*args, *tail)
    try:
        if streaming:
            k = 0
            while True:
                h = lib.strawb_cluster_job_wait_next(job, k)
                if not h:
                    break
                yield from _decode_cluster_handle(lib, h, cfg, ref_mrnas)
                k += 1
            # surface a decode failure (wait_block raises on error)
            table.wait_block(k + (1 << 60))
        else:
            nparts = lib.strawb_cluster_job_parts(job)
            for k in range(nparts):
                h = lib.strawb_cluster_job_wait(job, k)
                yield from _decode_cluster_handle(lib, h, cfg, ref_mrnas)
    finally:
        lib.strawb_cluster_job_free(job)
        del keep


def _decode_cluster_handle(lib, h, cfg: Config, ref_mrnas: List[Contig]
                           ) -> List[NativeCluster]:
    """Wrap one StrawbClusters handle as a _ClusterPool + per-cluster
    NativeCluster views. The big per-contig arrays are zero-copy views
    whose owner frees the handle when the pool is collected."""
    from ..io.native import _Owner, _view
    owner = _Owner(lib.strawb_cluster_free, h)
    n = lib.strawb_cluster_n(h)
    nct = lib.strawb_cluster_nct(h)
    nrefidx = lib.strawb_cluster_nrefidx(h)
    nseg = lib.strawb_cluster_nseg(h)
    cl_left = _view(lib.strawb_cluster_left(h), n, np.int64, owner)
    cl_right = _view(lib.strawb_cluster_right(h), n, np.int64, owner)
    cl_refid = _view(lib.strawb_cluster_refid(h), n, np.int32, owner)
    cl_wmass = _view(lib.strawb_cluster_wmass(h), n, np.float64, owner)
    ref_off = _view(lib.strawb_cluster_refoff(h), n + 1, np.int64, owner)
    ref_idx = _view(lib.strawb_cluster_refidx(h), nrefidx, np.int32, owner)
    uniq_off = _view(lib.strawb_cluster_uniqoff(h), n + 1, np.int64, owner)
    seg_off = _view(lib.strawb_cluster_segoff(h), n + 1, np.int64, owner)
    ct_strand = _view(lib.strawb_cluster_ctstrand(h), nct, np.int8, owner)
    ct_orit = _view(lib.strawb_cluster_ctorit(h), nct, np.int8, owner)
    ct_mass = _view(lib.strawb_cluster_ctmass(h), nct, np.float64, owner)
    ct_valid = _view(lib.strawb_cluster_ctvalid(h), nct, np.int8, owner)
    sg_left = _view(lib.strawb_cluster_segleft(h), nseg, np.int64, owner)
    sg_right = _view(lib.strawb_cluster_segright(h), nseg, np.int64, owner)
    sg_lidx = _view(lib.strawb_cluster_seglidx(h), nseg, np.int64, owner)
    sg_ridx = _view(lib.strawb_cluster_segridx(h), nseg, np.int64, owner)
    sg_strand = _view(lib.strawb_cluster_segstrand(h), nseg, np.int8, owner)

    # the VALID-contig gather (flat RLE of valid contigs + masses + running
    # valid counts) is emitted natively alongside ct_*; wrap it zero-copy
    valid_all = ct_valid != 0
    nvalid = lib.strawb_cluster_nvalid(h)
    ngfeat = lib.strawb_cluster_ngfeat(h)
    goff = _view(lib.strawb_cluster_goff(h), nvalid + 1, np.int64, owner)
    gcode = _view(lib.strawb_cluster_gcode(h), ngfeat, np.int8, owner)
    gleft = _view(lib.strawb_cluster_gleft(h), ngfeat, np.int64, owner)
    glen = _view(lib.strawb_cluster_glen(h), ngfeat, np.int32, owner)
    gmass = _view(lib.strawb_cluster_gmass(h), nvalid, np.float64, owner)
    vcum = _view(lib.strawb_cluster_vcum(h), nct + 1, np.int64, owner)

    # Python-int prefetch: one C-level tolist per array instead of per-
    # element numpy scalar boxing in the cluster loop
    cl_left_l = cl_left.tolist()
    cl_right_l = cl_right.tolist()
    cl_refid_l = cl_refid.tolist()
    cl_wmass_l = cl_wmass.tolist()
    ref_off_l = ref_off.tolist()
    ref_idx_l = ref_idx.tolist()
    uniq_off_l = uniq_off.tolist()

    pool = _ClusterPool()
    pool.ct_strand = ct_strand
    pool.ct_orit = ct_orit
    pool.ct_mass = ct_mass
    pool.valid_all = valid_all
    pool.gmass = gmass
    pool.goff = goff
    pool.gcode = gcode
    pool.gleft = gleft
    pool.glen = glen
    pool.uniq_off = uniq_off_l
    # only per-cluster BOUNDARY values are ever looked up — gather those
    # (n+1 ints) instead of tolist()ing the full per-contig arrays
    vcum_at = vcum[uniq_off]
    pool.vcum = dict(zip(uniq_off_l, vcum_at.tolist()))
    pool.vcum_full = vcum
    pool.goff_l = dict(zip(vcum_at.tolist(), goff[vcum_at].tolist()))
    pool.seg_off = seg_off.tolist()
    pool.seg_args = list(zip(sg_left.tolist(), sg_right.tolist(),
                             sg_lidx.tolist(), sg_ridx.tolist(),
                             sg_strand.tolist()))

    qfused = bool(lib.strawb_cluster_qfused(h))
    if qfused:
        qnb = lib.strawb_cluster_qnbins(h)
        qna = lib.strawb_cluster_qnalpha(h)
        q_bin_off = _arr(lib.strawb_cluster_qbinoff(h), n + 1,
                         np.int64).tolist()
        q_alpha_off = _arr(lib.strawb_cluster_qalphaoff(h), n + 1,
                           np.int64).tolist()
        q_counts = _view(lib.strawb_cluster_qcounts(h), qnb, np.float64,
                         owner)
        q_alpha = _view(lib.strawb_cluster_qalpha(h), qna, np.float64,
                        owner)

    fused = bool(lib.strawb_cluster_fused(h))
    if fused:
        nunit = lib.strawb_cluster_nunit(h)
        unit_off = _arr(lib.strawb_cluster_unitoff(h), n + 1,
                        np.int64).tolist()
        unit_job = _arr(lib.strawb_cluster_unitjob(h), nunit,
                        np.int64).tolist()
        unit_kind = _arr(lib.strawb_cluster_unitkind(h), nunit,
                         np.int8).tolist()
        unit_strand = _arr(lib.strawb_cluster_unitstrand(h), nunit,
                           np.int8).tolist()
        unit_l = _arr(lib.strawb_cluster_unitl(h), nunit, np.int64).tolist()
        unit_r = _arr(lib.strawb_cluster_unitr(h), nunit, np.int64).tolist()
        admit = _arr(lib.strawb_cluster_admit(h), n, np.int8).tolist()

    clusters: List[NativeCluster] = []
    for k in range(int(n)):
        c = NativeCluster()
        c.cfg = cfg
        c._pool = pool
        c._k = k
        c.leftmost = cl_left_l[k]
        c.rightmost = cl_right_l[k]
        c.ref_id = cl_refid_l[k]
        c.weighted_mass = cl_wmass_l[k]
        c.ref_indices = ref_idx_l[ref_off_l[k]:ref_off_l[k + 1]]
        c.ref_mrnas = [ref_mrnas[i] for i in c.ref_indices]
        c._n_uniq = uniq_off_l[k + 1] - uniq_off_l[k]
        if fused:
            u0, u1 = unit_off[k], unit_off[k + 1]
            c.prep_units = (bool(admit[k]),
                            [(unit_kind[u], unit_strand[u], unit_l[u],
                              unit_r[u], unit_job[u])
                             for u in range(u0, u1)])
        if qfused:
            c.quant_prebuilt = (q_counts[q_bin_off[k]:q_bin_off[k + 1]],
                                q_alpha[q_alpha_off[k]:q_alpha_off[k + 1]])
        clusters.append(c)
    return clusters


def flatten_contigs(contigs):
    """Flat RLE arrays (off, code, left, len) for a contig list."""
    off = np.zeros(len(contigs) + 1, np.int64)
    codes, lefts, lens = [], [], []
    for i, c in enumerate(contigs):
        for (cd, l, ln) in c.feats:
            codes.append(cd)
            lefts.append(l)
            lens.append(ln)
        off[i + 1] = len(codes)
    return (off, np.asarray(codes, np.int8), np.asarray(lefts, np.int64),
            np.asarray(lens, np.int32))


_compat_bound = False


def native_compat(hits, isos, segs, hit_flat=None, iso_flat=None,
                  want_fragkey=False):
    """C++ is_compatible / fragment-length / seg-overlap matrices.

    hits, isos: lists of Contig (or pass hit_flat/iso_flat = preflattened
    (off, code, left, len) tuples). segs: list of (S_MATCH, left, len).
    Returns (compat uint8 (nh,ni), fraglen int32 (nh,ni),
    seghit uint8 (nh,ns))."""
    global _compat_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _compat_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        u8p = C.POINTER(C.c_uint8)
        u64p = C.POINTER(C.c_uint64)
        lib.strawb_compat.restype = None
        lib.strawb_compat.argtypes = [
            C.c_int64, i64p, i8p, i64p, i32p,
            C.c_int64, i64p, i8p, i64p, i32p,
            C.c_int64, i64p, i64p,
            u8p, i32p, u8p, u64p]
        _compat_bound = True
    nh = len(hits) if hit_flat is None else len(hit_flat[0]) - 1
    ni = len(isos) if iso_flat is None else len(iso_flat[0]) - 1
    ns = len(segs)
    h_off, h_code, h_left, h_len = hit_flat or flatten_contigs(hits)
    t_off, t_code, t_left, t_len = iso_flat or flatten_contigs(isos)
    s_left = np.asarray([f[1] for f in segs], np.int64)
    s_right = np.asarray([f[1] + f[2] - 1 for f in segs], np.int64)
    compat = np.zeros((nh, max(ni, 1)), np.uint8)
    fraglen = np.zeros((nh, max(ni, 1)), np.int32)
    seghit = np.zeros((nh, max(ns, 1)), np.uint8)
    fragkey = np.zeros(max(nh, 1), np.uint64) if want_fragkey else None

    def ptr(a, ct):
        a = np.ascontiguousarray(a)
        return a.ctypes.data_as(C.POINTER(ct))

    ka = [np.ascontiguousarray(x) for x in
          (h_off, h_code, h_left, h_len, t_off, t_code, t_left, t_len,
           s_left, s_right)]
    lib.strawb_compat(
        nh, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        ni, ka[4].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[5].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[6].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[7].ctypes.data_as(C.POINTER(C.c_int32)),
        ns, ka[8].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[9].ctypes.data_as(C.POINTER(C.c_int64)),
        compat.ctypes.data_as(C.POINTER(C.c_uint8)),
        fraglen.ctypes.data_as(C.POINTER(C.c_int32)),
        seghit.ctypes.data_as(C.POINTER(C.c_uint8)),
        fragkey.ctypes.data_as(C.POINTER(C.c_uint64)) if want_fragkey
        else None)
    if want_fragkey:
        return compat[:, :ni], fraglen[:, :ni], seghit[:, :ns], fragkey[:nh]
    return compat[:, :ni], fraglen[:, :ni], seghit[:, :ns]


_cstr_bound = False


def native_constraints(segs, hit_flat):
    """findConstraints fully native: unique sorted >2-exon index tuples."""
    global _cstr_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _cstr_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        lib.strawb_constraints.restype = C.c_void_p
        lib.strawb_constraints.argtypes = [
            C.c_int64, i64p, i8p, i64p, i32p, C.c_int64, i64p, i64p]
        lib.strawb_cstr_n.restype = C.c_int64
        lib.strawb_cstr_n.argtypes = [C.c_void_p]
        lib.strawb_cstr_off.restype = i64p
        lib.strawb_cstr_off.argtypes = [C.c_void_p]
        lib.strawb_cstr_idx.restype = i32p
        lib.strawb_cstr_idx.argtypes = [C.c_void_p]
        lib.strawb_cstr_free.restype = None
        lib.strawb_cstr_free.argtypes = [C.c_void_p]
        _cstr_bound = True
    h_off, h_code, h_left, h_len = hit_flat
    nh = len(h_off) - 1
    s_left = np.asarray([f[1] for f in segs], np.int64)
    s_right = np.asarray([f[1] + f[2] - 1 for f in segs], np.int64)
    ka = [np.ascontiguousarray(x) for x in
          (h_off, h_code, h_left, h_len, s_left, s_right)]
    r = lib.strawb_constraints(
        nh, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        len(segs), ka[4].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[5].ctypes.data_as(C.POINTER(C.c_int64)))
    try:
        ncs = lib.strawb_cstr_n(r)
        if ncs == 0:
            return []
        off = np.ctypeslib.as_array(lib.strawb_cstr_off(r),
                                    shape=(int(ncs) + 1,))
        total = int(off[-1])
        idx = np.ctypeslib.as_array(lib.strawb_cstr_idx(r),
                                    shape=(max(total, 1),))
        offl = off.tolist()
        idxl = idx[:total].tolist()
        return [idxl[offl[k]:offl[k + 1]] for k in range(int(ncs))]
    finally:
        lib.strawb_cstr_free(r)


_fld_bound = False


def native_fld(isos, hit_flat, iso_flat=None):
    """fragLenDist inner loop natively: exonic-overlap lengths of hits
    compatible with exactly one transcript, in hit order."""
    global _fld_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _fld_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        lib.strawb_fld.restype = C.c_int64
        lib.strawb_fld.argtypes = [
            C.c_int64, i64p, i8p, i64p, i32p,
            C.c_int64, i64p, i8p, i64p, i32p, i32p]
        _fld_bound = True
    h_off, h_code, h_left, h_len = hit_flat
    t_off, t_code, t_left, t_len = iso_flat or flatten_contigs(isos)
    nh = len(h_off) - 1
    ni = len(t_off) - 1
    out = np.zeros(max(nh, 1), np.int32)
    ka = [np.ascontiguousarray(x) for x in
          (h_off, h_code, h_left, h_len, t_off, t_code, t_left, t_len)]
    n = lib.strawb_fld(
        nh, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        ni, ka[4].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[5].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[6].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[7].ctypes.data_as(C.POINTER(C.c_int32)),
        out.ctypes.data_as(C.POINTER(C.c_int32)))
    return out[:n].tolist()


_fld_batch_bound = False


def native_fld_batch(specs):
    """Whole-pass fragLenDist: specs = ordered (transcripts, hit_flat) per
    locus; returns the concatenated fragment lengths (locus order, hit
    order within each locus — identical to per-locus native_fld calls)."""
    global _fld_batch_bound
    from ..io.native import get_lib
    from ..quant.fastlocus import _concat_flats
    lib = get_lib()
    if not _fld_batch_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        lib.strawb_fld_batch.restype = None
        lib.strawb_fld_batch.argtypes = [
            C.c_int64, i64p, i64p,
            i64p, i8p, i64p, i32p,
            i64p, i8p, i64p, i32p, i32p, i64p]
        _fld_batch_bound = True
    hit_loc, h_off, h_code, h_left, h_len = _concat_flats(
        [s[1] for s in specs])
    # s[0] is either a Contig list or an already-flat RLE tuple (native
    # solve path — the transcripts come back from C++ pre-flattened)
    iso_loc, t_off, t_code, t_left, t_len = _concat_flats(
        [s[0] if isinstance(s[0], tuple) else flatten_contigs(s[0])
         for s in specs])
    nh = int(hit_loc[-1])
    out = np.zeros(max(nh, 1), np.int32)
    cnt = np.zeros(len(specs), np.int64)
    P64 = C.POINTER(C.c_int64)
    P32 = C.POINTER(C.c_int32)
    P8 = C.POINTER(C.c_int8)
    lib.strawb_fld_batch(
        len(specs), hit_loc.ctypes.data_as(P64), iso_loc.ctypes.data_as(P64),
        h_off.ctypes.data_as(P64), h_code.ctypes.data_as(P8),
        h_left.ctypes.data_as(P64), h_len.ctypes.data_as(P32),
        t_off.ctypes.data_as(P64), t_code.ctypes.data_as(P8),
        t_left.ctypes.data_as(P64), t_len.ctypes.data_as(P32),
        out.ctypes.data_as(P32), cnt.ctypes.data_as(P64))
    if not len(specs):
        return []
    starts = hit_loc[:-1]
    pieces = [out[int(s):int(s) + int(c)] for s, c in zip(starts, cnt)]
    # int32 array, not a Python int list: pass-1 observes millions of
    # fragment lengths and boxed ints cost ~30x the memory
    return np.concatenate(pieces) if pieces else np.zeros(0, np.int32)


_asm_bound = False


def native_solve_enabled() -> bool:
    """Whether per-locus flow problems are solved natively on the prep
    workers (lemonns.cc NetworkSimplex + decompose/reconstruct) — the
    default golden path. Disabled by STRAWB_NATIVE_SOLVE=0 (Python-oracle
    solve, for parity testing) or STRAWB_DEVICE_MCF (the opt-in device DP
    needs the dense flow problem shipped back instead)."""
    import os
    if os.environ.get("STRAWB_DEVICE_MCF"):
        return False
    return os.environ.get("STRAWB_NATIVE_SOLVE", "1") not in ("0", "false")


def native_asmprep(cfg, l, r, read_len, hit_flat, cov_mass, weight_mass):
    """Whole per-locus assembly prep in one native call (assembleprep.cc):
    coverage + intron filters + splice graph + flow network. Returns None
    for an empty task, else (exons(l,r,doc), M, arcs(src,dst,cost,lower),
    path_cstrs)."""
    global _asm_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _asm_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        dp = C.POINTER(C.c_double)
        lib.strawb_asmprep.restype = C.c_void_p
        lib.strawb_asmprep.argtypes = [
            C.c_int64, C.c_int64, C.c_int64,
            C.c_int64, i64p, i8p, i64p, i32p, dp, dp,
            C.c_double, C.c_double, C.c_double, C.c_double, C.c_int64,
            C.c_double, C.c_int32, C.c_double, C.c_int64, C.c_int64,
            C.c_double, C.c_int64]
        for name, rt in [("status", C.c_int32), ("ne", C.c_int64),
                         ("narcs", C.c_int64), ("ncstr", C.c_int64),
                         ("m", C.c_int64)]:
            fn = getattr(lib, f"strawb_asm_{name}")
            fn.restype = rt
            fn.argtypes = [C.c_void_p]
        for name, rt in [("exl", i64p), ("exr", i64p), ("exdoc", dp),
                         ("src", i64p), ("dst", i64p), ("cost", i64p),
                         ("lower", i64p), ("cstroff", i64p),
                         ("cstrarcs", i64p)]:
            fn = getattr(lib, f"strawb_asm_{name}")
            fn.restype = rt
            fn.argtypes = [C.c_void_p]
        lib.strawb_asmprep_submit.restype = C.c_void_p
        lib.strawb_asmprep_submit.argtypes = (
            lib.strawb_asmprep.argtypes
            + [C.c_int32, C.c_int64, C.c_double])
        lib.strawb_asm_solved.restype = C.c_int32
        lib.strawb_asm_solved.argtypes = [C.c_void_p]
        lib.strawb_asm_ntx.restype = C.c_int64
        lib.strawb_asm_ntx.argtypes = [C.c_void_p]
        for name, rt in [("txoff", i64p), ("tcode", i8p),
                         ("tleft", i64p), ("tlen", i32p)]:
            fn = getattr(lib, f"strawb_asm_{name}")
            fn.restype = rt
            fn.argtypes = [C.c_void_p]
        lib.strawb_asm_wait.restype = C.c_void_p
        lib.strawb_asm_wait.argtypes = [C.c_void_p]
        lib.strawb_asm_free.restype = None
        lib.strawb_asm_free.argtypes = [C.c_void_p]
        _asm_bound = True
    h = lib.strawb_asmprep(*_asm_args(cfg, l, r, read_len, hit_flat,
                                      cov_mass, weight_mass)[0])
    return _asm_result(lib, h)


def _asm_args(cfg, l, r, read_len, hit_flat, cov_mass, weight_mass):
    """(ctypes arg tuple, keepalive arrays) for strawb_asmprep/submit."""
    h_off, h_code, h_left, h_len = hit_flat
    nh = len(h_off) - 1
    ka = [np.ascontiguousarray(x) for x in
          (h_off, h_code, h_left, h_len)]
    cm = np.ascontiguousarray(cov_mass, np.float64)
    wm = np.ascontiguousarray(weight_mass, np.float64)
    args = (
        l, r, read_len,
        nh, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        cm.ctypes.data_as(C.POINTER(C.c_double)),
        wm.ctypes.data_as(C.POINTER(C.c_double)),
        float(cfg.min_anchor), float(cfg.min_depth_4_locus),
        float(cfg.min_isoform_frac), float(cfg.min_junc_support),
        cfg.long_junc_length, float(cfg.min_support_for_long_junc),
        1 if cfg.enforce_ref_models else 0,
        float(cfg.binomial_overhang_alpha),
        cfg.max_cover_gap1, cfg.max_cover_gap2,
        float(cfg.intron_edge_weight), cfg.min_dist_4_exon_edge)
    return args, (ka, cm, wm)


def native_asmprep_submit(cfg, l, r, read_len, hit_flat, cov_mass,
                          weight_mass, solve=False):
    """Queue the per-locus prep on the native worker pool; returns an
    opaque (job, keepalive) pending token for native_asmprep_result. With
    solve=True the worker chains the lemonns NetworkSimplex + decompose/
    reconstruct and the result carries finished transcript chains."""
    global _asm_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _asm_bound:
        native_asmprep(cfg, 0, 0, read_len,
                       (np.zeros(1, np.int64), np.zeros(0, np.int8),
                        np.zeros(0, np.int64), np.zeros(0, np.int32)),
                       np.zeros(0), np.zeros(0))  # force binding
    args, keep = _asm_args(cfg, l, r, read_len, hit_flat, cov_mass,
                           weight_mass)
    job = lib.strawb_asmprep_submit(
        *args, 1 if solve else 0, cfg.min_trans_len,
        float(cfg.min_depth_4_contig))
    return (job, keep)


def native_asmprep_result(pending):
    """Block for a submitted job and decode its result (as native_asmprep
    would have returned)."""
    from ..io.native import get_lib
    lib = get_lib()
    if not _asm_bound:
        # jobs submitted natively (fused clusterizer) reach here before any
        # Python-side submit has installed the ctypes signatures
        native_asmprep(Config(), 0, 0, 0,
                       (np.zeros(1, np.int64), np.zeros(0, np.int8),
                        np.zeros(0, np.int64), np.zeros(0, np.int32)),
                       np.zeros(0), np.zeros(0))
    job, _keep = pending
    h = lib.strawb_asm_wait(C.c_void_p(job))
    return _asm_result(lib, h)


_asmb_bound = False


def native_asmprep_result_batch(pendings):
    """Wait for a whole chunk of submitted jobs in ONE native call and
    decode the packed results (list parallel to pendings; None entries for
    empty/below-depth tasks). Equivalent to
    [native_asmprep_result(p) for p in pendings] minus ~12 ctypes
    round-trips per job."""
    global _asmb_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _asmb_bound:
        u64p = C.POINTER(C.c_uint64)
        lib.strawb_asm_wait_pack.restype = C.c_void_p
        lib.strawb_asm_wait_pack.argtypes = [u64p, C.c_int64]
        for name, rt in [("status", C.POINTER(C.c_int32)),
                         ("mm", C.POINTER(C.c_int64)),
                         ("neoff", C.POINTER(C.c_int64)),
                         ("arcoff", C.POINTER(C.c_int64)),
                         ("ncoff", C.POINTER(C.c_int64)),
                         ("caoff", C.POINTER(C.c_int64)),
                         ("exl", C.POINTER(C.c_int64)),
                         ("exr", C.POINTER(C.c_int64)),
                         ("exdoc", C.POINTER(C.c_double)),
                         ("src", C.POINTER(C.c_int64)),
                         ("dst", C.POINTER(C.c_int64)),
                         ("cost", C.POINTER(C.c_int64)),
                         ("lower", C.POINTER(C.c_int64)),
                         ("cstrlen", C.POINTER(C.c_int64)),
                         ("cstrarcs", C.POINTER(C.c_int64)),
                         ("solved", C.POINTER(C.c_int32)),
                         ("txoff", C.POINTER(C.c_int64)),
                         ("txfoff", C.POINTER(C.c_int64)),
                         ("tcode", C.POINTER(C.c_int8)),
                         ("tleft", C.POINTER(C.c_int64)),
                         ("tlen", C.POINTER(C.c_int32))]:
            fn = getattr(lib, f"strawb_asmb_{name}")
            fn.restype = rt
            fn.argtypes = [C.c_void_p]
        lib.strawb_asmb_free.restype = None
        lib.strawb_asmb_free.argtypes = [C.c_void_p]
        _asmb_bound = True
    n = len(pendings)
    if n == 0:
        return []
    jobs = np.zeros(n, np.uint64)
    for i, p in enumerate(pendings):
        if p is not None:
            # a task that reached the batch must carry a live handle;
            # a null one would silently decode as an empty locus
            assert p[0], f"null assembly-prep job handle at slot {i}"
            jobs[i] = p[0]
    h = C.c_void_p(lib.strawb_asm_wait_pack(
        jobs.ctypes.data_as(C.POINTER(C.c_uint64)), n))
    try:
        def al(name, count):
            # element type comes from the strawb_asmb_<name> restype
            # bound above; .tolist() converts to Python scalars
            if count == 0:
                return []
            ptr = getattr(lib, f"strawb_asmb_{name}")(h)
            return np.ctypeslib.as_array(ptr, shape=(int(count),)).tolist()

        status = al("status", n)
        M = al("mm", n)
        ne_off = al("neoff", n + 1)
        arc_off = al("arcoff", n + 1)
        nc_off = al("ncoff", n + 1)
        ca_off = al("caoff", n + 1)
        exl = al("exl", ne_off[-1])
        exr = al("exr", ne_off[-1])
        exdoc = al("exdoc", ne_off[-1])
        src = al("src", arc_off[-1])
        dst = al("dst", arc_off[-1])
        cost = al("cost", arc_off[-1])
        lower = al("lower", arc_off[-1])
        clen = al("cstrlen", nc_off[-1])
        carcs = al("cstrarcs", ca_off[-1])
        solved = al("solved", n)
        tx_off = al("txoff", n + 1)
        txf_off = al("txfoff", tx_off[-1] + 1)

        def alnp(name, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            ptr = getattr(lib, f"strawb_asmb_{name}")(h)
            return np.ctypeslib.as_array(ptr, shape=(int(count),)).copy()

        # numpy copies: the per-unit RLE views feed the fragment-length
        # batch directly (no Python re-flattening of the transcripts)
        tcode_np = alnp("tcode", txf_off[-1], np.int8)
        tleft_np = alnp("tleft", txf_off[-1], np.int64)
        tlen_np = alnp("tlen", txf_off[-1], np.int32)
        txf_np = np.asarray(txf_off, np.int64)
    finally:
        lib.strawb_asmb_free(h)
    out = []
    for k in range(n):
        if not status[k]:
            out.append(None)
            continue
        if solved[k]:
            # lazy views: the Contig wrappers materialize tuples only if
            # something actually reads the features (GTF output etc.)
            txs = [FeatView(tcode_np, tleft_np, tlen_np,
                            txf_off[t], txf_off[t + 1])
                   for t in range(tx_off[k], tx_off[k + 1])]
            g0, g1 = txf_off[tx_off[k]], txf_off[tx_off[k + 1]]
            flat = (txf_np[tx_off[k]:tx_off[k + 1] + 1] - g0,
                    tcode_np[g0:g1], tleft_np[g0:g1], tlen_np[g0:g1])
            out.append(("solved", txs, flat))
            continue
        e0, e1 = ne_off[k], ne_off[k + 1]
        a0, a1 = arc_off[k], arc_off[k + 1]
        cstrs = []
        pos = ca_off[k]
        for c in range(nc_off[k], nc_off[k + 1]):
            cstrs.append(carcs[pos:pos + clen[c]])
            pos += clen[c]
        out.append((exl[e0:e1], exr[e0:e1], exdoc[e0:e1], M[k],
                    src[a0:a1], dst[a0:a1], cost[a0:a1], lower[a0:a1],
                    cstrs))
    return out


def _asm_result(lib, h):
    try:
        if not lib.strawb_asm_status(h):
            return None

        def al(ptr, n):
            if n == 0:
                return []
            return np.ctypeslib.as_array(ptr, shape=(int(n),)).tolist()

        if lib.strawb_asm_solved(h):
            # natively solved: final transcript feature chains only
            ntx = lib.strawb_asm_ntx(h)
            toff = al(lib.strawb_asm_txoff(h), ntx + 1)
            nf = toff[-1] if ntx else 0

            def alnp(ptr, count, dtype):
                if count == 0:
                    return np.zeros(0, dtype)
                return np.ctypeslib.as_array(ptr,
                                             shape=(int(count),)).copy()

            tcode_np = alnp(lib.strawb_asm_tcode(h), nf, np.int8)
            tleft_np = alnp(lib.strawb_asm_tleft(h), nf, np.int64)
            tlen_np = alnp(lib.strawb_asm_tlen(h), nf, np.int32)
            txs = [FeatView(tcode_np, tleft_np, tlen_np,
                            toff[k], toff[k + 1])
                   for k in range(int(ntx))]
            flat = (np.asarray(toff, np.int64), tcode_np, tleft_np,
                    tlen_np)
            return ("solved", txs, flat)
        ne = lib.strawb_asm_ne(h)
        na = lib.strawb_asm_narcs(h)
        nc = lib.strawb_asm_ncstr(h)
        M = lib.strawb_asm_m(h)
        exl = al(lib.strawb_asm_exl(h), ne)
        exr = al(lib.strawb_asm_exr(h), ne)
        exdoc = al(lib.strawb_asm_exdoc(h), ne)
        src = al(lib.strawb_asm_src(h), na)
        dst = al(lib.strawb_asm_dst(h), na)
        cost = al(lib.strawb_asm_cost(h), na)
        lower = al(lib.strawb_asm_lower(h), na)
        coff = al(lib.strawb_asm_cstroff(h), nc + 1)
        carcs = al(lib.strawb_asm_cstrarcs(h), coff[-1] if nc else 0)
        cstrs = [carcs[coff[k]:coff[k + 1]] for k in range(int(nc))]
        return (exl, exr, exdoc, int(M), src, dst, cost, lower, cstrs)
    finally:
        lib.strawb_asm_free(h)


_coverage_bound = False


def native_coverage(hits, locus_left, locus_right, small_overhang,
                    exon_doc, hit_flat=None, masses=None):
    """C++ compute_doc: fills exon_doc in place, returns the intron table
    as parallel arrays (left, right, total, small). Reference-model hits
    (is_ref) pass mass -1 and are skipped."""
    global _coverage_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _coverage_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        f32p = C.POINTER(C.c_float)
        dp = C.POINTER(C.c_double)
        lib.strawb_coverage.restype = C.c_int64
        lib.strawb_coverage.argtypes = [
            C.c_int64, i64p, i8p, i64p, i32p, dp,
            C.c_int64, C.c_int64, C.c_double,
            f32p, C.c_int64, i64p, i64p, dp, dp]
        _coverage_bound = True
    h_off, h_code, h_left, h_len = hit_flat or flatten_contigs(hits)
    if masses is None:
        masses = np.array([-1.0 if h.is_ref else h.mass for h in hits],
                          np.float64)
    nh = len(h_off) - 1
    max_introns = max(1, len(h_code))
    il = np.zeros(max_introns, np.int64)
    ir = np.zeros(max_introns, np.int64)
    tot = np.zeros(max_introns, np.float64)
    small = np.zeros(max_introns, np.float64)
    ka = [np.ascontiguousarray(x) for x in
          (h_off, h_code, h_left, h_len, masses)]
    assert exon_doc.dtype == np.float32 and exon_doc.flags.c_contiguous
    n = lib.strawb_coverage(
        nh, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        ka[4].ctypes.data_as(C.POINTER(C.c_double)),
        locus_left, locus_right, float(small_overhang),
        exon_doc.ctypes.data_as(C.POINTER(C.c_float)),
        max_introns,
        il.ctypes.data_as(C.POINTER(C.c_int64)),
        ir.ctypes.data_as(C.POINTER(C.c_int64)),
        tot.ctypes.data_as(C.POINTER(C.c_double)),
        small.ctypes.data_as(C.POINTER(C.c_double)))
    return il[:n], ir[:n], tot[:n], small[:n]


def gather_flat(flat, mask):
    """Subset a flat RLE tuple by a per-contig boolean mask (pure numpy)."""
    off, code, left, ln = flat
    starts = off[:-1][mask]
    lens = (off[1:] - off[:-1])[mask]
    total = int(lens.sum())
    new_off = np.zeros(len(starts) + 1, np.int64)
    np.cumsum(lens, out=new_off[1:])
    if total:
        pos = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1],
                                                           lens)
        src = np.repeat(starts, lens) + pos
        return (new_off, code[src], left[src], ln[src])
    return (new_off, np.zeros(0, np.int8), np.zeros(0, np.int64),
            np.zeros(0, np.int32))


def concat_flat(a, b):
    off = np.concatenate([a[0], a[0][-1] + b[0][1:]])
    return (off, np.concatenate([a[1], b[1]]),
            np.concatenate([a[2], b[2]]), np.concatenate([a[3], b[3]]))


_adj_bound = False


def native_adj_support(hit_flat, masses, arc_s, arc_e, min_dist):
    """C++ addWeight adjacency support (order-sensitive early exit)."""
    global _adj_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _adj_bound:
        i64p = C.POINTER(C.c_int64)
        i32p = C.POINTER(C.c_int32)
        i8p = C.POINTER(C.c_int8)
        dp = C.POINTER(C.c_double)
        lib.strawb_adj_support.restype = None
        lib.strawb_adj_support.argtypes = [
            C.c_int64, i64p, i8p, i64p, i32p, dp,
            C.c_int64, i64p, i64p, C.c_int64, dp]
        _adj_bound = True
    na = len(arc_s)
    out = np.zeros(na, np.float64)
    ka = [np.ascontiguousarray(x) for x in
          (hit_flat[0], hit_flat[1], hit_flat[2], hit_flat[3], masses,
           np.asarray(arc_s, np.int64), np.asarray(arc_e, np.int64))]
    lib.strawb_adj_support(
        len(ka[0]) - 1, ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int32)),
        ka[4].ctypes.data_as(C.POINTER(C.c_double)),
        na, ka[5].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[6].ctypes.data_as(C.POINTER(C.c_int64)),
        min_dist, out.ctypes.data_as(C.POINTER(C.c_double)))
    return out


_emit_bound = False


def native_gtf_emit_available() -> bool:
    try:
        from ..io.native import get_lib
        return hasattr(get_lib(), "strawb_gtf_emit")
    except OSError:
        return False


def native_gtf_emit(rows, flat, strand, chrom, chroms_blob, gene_blob,
                    tid_blob, rgid_blob, rgname_blob,
                    fpkm, frac, tpm) -> bytes:
    """Format GTF transcript+exon rows for `rows` (indices into the refs
    flat) natively; byte-twin of io/gtfwriter.print2gtf (gtfemit.cc)."""
    global _emit_bound
    from ..io.native import get_lib
    lib = get_lib()
    if not _emit_bound:
        i64p = C.POINTER(C.c_int64)
        lib.strawb_gtf_emit.restype = C.c_void_p
        lib.strawb_gtf_emit.argtypes = [
            C.c_int64, i64p,
            i64p, C.POINTER(C.c_int8), i64p, C.POINTER(C.c_int32),
            C.POINTER(C.c_int8), C.POINTER(C.c_int32),
            C.c_char_p, C.c_char_p, C.c_char_p, C.c_char_p, C.c_char_p,
            C.POINTER(C.c_double), C.POINTER(C.c_double),
            C.POINTER(C.c_double), i64p]
        lib.strawb_gtf_emit_free.restype = None
        lib.strawb_gtf_emit_free.argtypes = [C.c_void_p]
        _emit_bound = True
    off, code, left, lens = flat
    ka = [np.ascontiguousarray(rows, np.int64),
          np.ascontiguousarray(off, np.int64),
          np.ascontiguousarray(code, np.int8),
          np.ascontiguousarray(left, np.int64),
          np.ascontiguousarray(lens, np.int32),
          np.ascontiguousarray(strand, np.int8),
          np.ascontiguousarray(chrom, np.int32),
          np.ascontiguousarray(fpkm, np.float64),
          np.ascontiguousarray(frac, np.float64),
          np.ascontiguousarray(tpm, np.float64)]
    out_len = C.c_int64()
    p = lib.strawb_gtf_emit(
        len(ka[0]), ka[0].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[1].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[2].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[3].ctypes.data_as(C.POINTER(C.c_int64)),
        ka[4].ctypes.data_as(C.POINTER(C.c_int32)),
        ka[5].ctypes.data_as(C.POINTER(C.c_int8)),
        ka[6].ctypes.data_as(C.POINTER(C.c_int32)),
        chroms_blob.encode(), gene_blob.encode(), tid_blob.encode(),
        rgid_blob.encode(), rgname_blob.encode(),
        ka[7].ctypes.data_as(C.POINTER(C.c_double)),
        ka[8].ctypes.data_as(C.POINTER(C.c_double)),
        ka[9].ctypes.data_as(C.POINTER(C.c_double)),
        C.byref(out_len))
    try:
        return C.string_at(p, out_len.value)
    finally:
        lib.strawb_gtf_emit_free(C.c_void_p(p))


def sort_contigs_flat(contigs, flat):
    """features.sort_contigs (exact Contig::operator< order), driven by
    the contigs' flat RLE instead of their Python feature lists — no
    FeatView materialization. Returns (sorted contigs, matching flat)."""
    n = len(contigs)
    off, code, left, lens = flat
    if n < 2:
        return list(contigs), flat
    ref = np.fromiter((c.ref_id for c in contigs), np.int64, n)
    cols = [ref]
    last = np.maximum(off[1:] - 1, 0)
    for fi in range(4):
        valid = off[:-1] + fi < off[1:]
        idx = np.minimum(off[:-1] + fi, last)
        cols.append(np.where(valid, left[idx], -1))
        cols.append(np.where(valid, lens[idx], -1))
    order = np.lexsort(tuple(reversed(cols)))  # stable; first col primary
    keys = np.stack([c[order] for c in cols], axis=1)
    run_start = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    bounds = [0] + run_start.tolist() + [n]
    ordl = order.tolist()
    offl = off.tolist()
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 - b0 > 1:  # full lexicographic key only inside tied runs
            ordl[b0:b1] = sorted(
                ordl[b0:b1],
                key=lambda i: list(zip(left[offl[i]:offl[i + 1]].tolist(),
                                       lens[offl[i]:offl[i + 1]].tolist())))
    out = [contigs[i] for i in ordl]
    return out, take_flat(flat, ordl)


def concat_flat_parts(parts):
    """Concatenate flat RLE (off, code, left, len) tuples in order,
    rebasing the offset arrays by the running totals. A single part
    passes through as-is (keeps views)."""
    if len(parts) == 1:
        return parts[0]
    offs = [np.asarray(parts[0][0])]
    base = int(parts[0][0][-1])
    for p in parts[1:]:
        offs.append(np.asarray(p[0][1:]) + base)
        base += int(p[0][-1])
    return (np.concatenate(offs),
            np.concatenate([np.asarray(p[1]) for p in parts]),
            np.concatenate([np.asarray(p[2]) for p in parts]),
            np.concatenate([np.asarray(p[3]) for p in parts]))


def take_flat(flat, indices):
    """Subset a flat RLE tuple by contig indices (pure numpy)."""
    off, code, left, ln = flat
    idx = np.asarray(indices, np.int64)
    starts = off[:-1][idx]
    lens = (off[1:] - off[:-1])[idx]
    total = int(lens.sum())
    new_off = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=new_off[1:])
    if total:
        pos = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1],
                                                           lens)
        src = np.repeat(starts, lens) + pos
        return (new_off, code[src], left[src], ln[src])
    return (new_off, np.zeros(0, np.int8), np.zeros(0, np.int64),
            np.zeros(0, np.int32))
