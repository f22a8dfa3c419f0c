"""Locus clustering: streaming scan over sorted hits -> independent gene loci.

Host-side replacement for the reference's HitCluster + Sample cluster
iterators (ref: src/alignments.cpp:149-1348, include/alignments.h:37-175).
The two-pass streaming design over libbam with bgzf_seek rewinds becomes a
cursor over in-memory numpy hit tables (strawberry_tpu.io.bamreader.HitTable);
"rewind one hit" is a cursor decrement.

Each finished cluster is an independent unit of work — downstream these are
batched into padded tensors for the TPU kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..io.bamreader import HitTable
from .features import (Contig, Feature, S_GAP, S_INTRON, S_MATCH,
                       STRAND_MINUS, STRAND_PLUS, STRAND_UNKNOWN,
                       contig_from_pair, feat_right, feats_sorted)

UINT_MAX = 0xFFFFFFFF


def phi(x: float) -> float:
    """Abramowitz & Stegun 7.1.26 normal CDF approximation, exactly as the
    reference's phi/standard_normal_cdf (common.h:112-133). Must match
    bit-for-bit since it gates the 5-sigma span filter."""
    if math.isnan(x):
        return math.nan
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    sign = -1 if x < 0 else 1
    x = abs(x) / math.sqrt(2.0)
    t = 1.0 / (1.0 + p * x)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * math.exp(-x * x)
    return 0.5 * (1.0 + sign * y)


def one_d_binary_clustering(vec: List[int]) -> int:
    """Best purity split of a 0/1 sequence (include/clustering.h:12-46)."""
    total_c1 = vec.count(0)
    total_c2 = len(vec) - total_c1
    l_c1 = l_c2 = 0
    r_c1, r_c2 = total_c1, total_c2
    best_score = -(1 << 62)
    best_idx = -1
    for i, v in enumerate(vec):
        if v == 0:
            l_c1 += 1
            r_c1 -= 1
        else:
            l_c2 += 1
            r_c2 -= 1
        s = max(l_c1, l_c2) + max(r_c1, r_c2)
        if s >= best_score:
            best_idx = i
            best_score = s
    return best_idx


@dataclass
class PairedHit:
    """Indices into a HitTable; None = missing mate (read.hpp:285-327)."""
    left: Optional[int] = None
    right: Optional[int] = None
    collapse_mass: float = 0.0
    mass: float = 0.0  # weighted_mass, set by init_raw_mass

    def is_paired(self) -> bool:
        return self.left is not None and self.right is not None


@dataclass
class Segment:
    left: int
    right: int
    left_read_idx: int
    right_read_idx: int
    strand: int


class HitCluster:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.leftmost: int = UINT_MAX
        self.rightmost: int = 0
        self.id: int = -1
        self.gene_id: str = ""
        self.ref_id: int = -1
        self.raw_mass: float = 0.0
        self.weighted_mass: float = 0.0
        self.hits: List[PairedHit] = []
        self.uniq_hits: List[PairedHit] = []
        self.open_mates: Dict[int, List[PairedHit]] = {}
        self.read_ref_span: List[int] = []
        self.ref_mrnas: List[Contig] = []
        self.strand_intron: Dict[int, Dict[Feature, int]] = {}
        self.segs: List[Segment] = []
        self._table: Optional[HitTable] = None
        self.trace_only = False  # decode-trace simulation: bounds only

    # ---- table accessors --------------------------------------------------
    def _feats(self, i: int) -> List[Feature]:
        t = self._table
        a, b = t.feat_off[i], t.feat_off[i + 1]
        return [(int(t.feat_code[j]), int(t.feat_left[j]), int(t.feat_len[j]))
                for j in range(a, b)]

    def hit_left(self, i: int) -> int:
        return int(self._table.left[i])

    def hit_right(self, i: int) -> int:
        return int(self._table.right[i])

    def hit_mass(self, i: int) -> float:
        t = self._table
        singleton = (t.mate_pos[i] == 0 or t.mate_ref[i] == -1
                     or t.mate_ref[i] != t.ref_id[i])
        return (1.0 if singleton else 0.5) / float(t.nh[i])

    def pair_left_pos(self, ph: PairedHit) -> int:
        if ph.left is not None and ph.right is not None:
            return min(self.hit_left(ph.left), self.hit_left(ph.right))
        i = ph.left if ph.left is not None else ph.right
        return self.hit_left(i)

    def pair_right_pos(self, ph: PairedHit) -> int:
        if ph.left is not None and ph.right is not None:
            return max(self.hit_right(ph.left), self.hit_right(ph.right))
        i = ph.left if ph.left is not None else ph.right
        return self.hit_right(i)

    def pair_strand(self, ph: PairedHit) -> int:
        t = self._table
        if ph.left is not None and ph.right is not None:
            ls, rs = int(t.strand[ph.left]), int(t.strand[ph.right])
            return ls if ls != STRAND_UNKNOWN else rs
        i = ph.left if ph.left is not None else ph.right
        return int(t.strand[i])

    def pair_contains_splice(self, ph: PairedHit) -> bool:
        for i in (ph.left, ph.right):
            if i is not None:
                f = self._feats(i)
                if any(c == S_INTRON for c, _, _ in f):
                    return True
        return False

    def pair_eq(self, a: PairedHit, b: PairedHit) -> bool:
        """PairedHit::operator== (read.cpp:897-910): same mate presence and
        ReadHit equality (left coordinate + cigar) per side."""
        if (a.left is None) != (b.left is None):
            return False
        if (a.right is None) != (b.right is None):
            return False
        for ai, bi in ((a.left, b.left), (a.right, b.right)):
            if ai is not None:
                if not self._read_eq(ai, bi):
                    return False
        return True

    def _read_eq(self, i: int, j: int) -> bool:
        """ReadHit::operator== (read.cpp:196-207): left coord + raw cigar."""
        t = self._table
        return (t.left[i] == t.left[j]
                and t.cigar_hash[i] == t.cigar_hash[j])

    # ---- reference-model management ---------------------------------------
    def add_ref_contig(self, contig: Contig) -> None:
        if self.ref_id != -1:
            assert self.ref_id == contig.ref_id
        else:
            self.ref_id = contig.ref_id
        if self.gene_id != contig.parent_id:
            return
        self.leftmost = min(self.leftmost, contig.left)
        self.rightmost = max(self.rightmost, contig.right)
        self.ref_mrnas.append(contig)

    def ref_strand(self) -> int:
        assert self.ref_mrnas
        return self.ref_mrnas[0].strand

    # ---- hit accumulation --------------------------------------------------
    def add_hit(self, ph: PairedHit) -> bool:
        """HitCluster::addHit (alignments.cpp:423-461). The reference also
        counts per-strand introns here, but the only consumers
        (guessStrand via mergeClusters, see_both_strands) are dead code
        upstream — we skip the bookkeeping."""
        self.hits.append(ph)
        return True

    def add_open_hit(self, i: int, extend_by_hit: bool,
                     extend_by_partner: bool) -> bool:
        """HitCluster::addOpenHit (alignments.cpp:490-651)."""
        cfg = self.cfg
        t = self._table
        orig = (self.leftmost, self.rightmost, self.ref_id)
        hit_left = int(t.left[i])
        hit_right = int(t.right[i])
        hit_strand = int(t.strand[i])
        hit_ref = int(t.ref_id[i])
        hit_partner_pos = int(t.mate_pos[i])
        hit_id = int(t.read_id[i])
        rev = bool(t.flag[i] & 0x10)

        if extend_by_hit:
            self.leftmost = min(self.leftmost, hit_left)
            self.rightmost = max(self.rightmost, hit_right)
        if (extend_by_partner and hit_partner_pos != 0
                and int(t.mate_ref[i]) == self.ref_id):
            if hit_partner_pos - hit_left < cfg.max_intron_length:
                self.rightmost = max(self.rightmost, hit_right, hit_partner_pos)

        if abs(hit_right - hit_left) > cfg.max_frag_span:
            self.leftmost, self.rightmost, self.ref_id = orig
            if cfg.verbose:
                # alignments.cpp:520-523 cerr diagnostic (text verbatim,
                # including the stray "<< skipping")
                import sys
                sys.stderr.write(f"Hit start at {hit_left}  is longer "
                                 "than max gene length<< skipping\n")
            return False

        self.read_ref_span.append(hit_right - hit_left + 1)

        if self.ref_id == -1:
            if hit_ref != -1:
                self.ref_id = hit_ref
        else:
            assert self.ref_id == hit_ref

        if self.trace_only:
            # decode-trace simulation (pipeline._emit_read_diags): only
            # the cluster-bounds evolution drives the cursor/rewind
            # behavior; skip pairing/mass bookkeeping
            self.hits.append(None)
            return True

        singleton = (hit_partner_pos == 0 or int(t.mate_ref[i]) == -1
                     or int(t.mate_ref[i]) != hit_ref)
        if singleton or int(t.mate_ref[i]) != self.ref_id:
            if rev:
                self.add_hit(PairedHit(left=None, right=i))
            else:
                self.add_hit(PairedHit(left=i, right=None))
            return True

        chain = self.open_mates.get(hit_id)
        if chain is None:
            if hit_partner_pos > hit_left:
                if rev and cfg.verbose:
                    # alignments.cpp:552-557 cerr diagnostic
                    import sys
                    sys.stderr.write(
                        f"Possible wrong read orientation at chr: "
                        f"{hit_ref} for read start at {hit_left} and his "
                        f"partner at {hit_partner_pos}\n")
                self.open_mates[hit_id] = [PairedHit(left=i, right=None)]
            elif hit_partner_pos < hit_left:
                if not rev and cfg.verbose:
                    import sys
                    sys.stderr.write(
                        f"Possible wrong read orientation at chr: "
                        f"{hit_ref} for read start at {hit_left} and his "
                        f"partner at {hit_partner_pos}\n")
                self.open_mates[hit_id] = [PairedHit(left=None, right=i)]
            else:
                return False
        else:
            for k, op in enumerate(chain):
                strand_agree = (self.pair_strand(op) == hit_strand
                                or hit_strand == STRAND_UNKNOWN
                                or self.pair_strand(op) == STRAND_UNKNOWN)
                if op.right is not None:
                    expected_pos = int(t.mate_pos[op.right])
                else:
                    expected_pos = int(t.mate_pos[op.left])
                if (self.pair_left_pos(op) == hit_partner_pos
                        and (int(t.ref_id[op.left if op.left is not None
                                           else op.right]) == hit_ref)
                        and strand_agree and expected_pos == hit_left):
                    if op.left is None and op.right is not None:
                        op.left = i
                    elif op.right is None and op.left is not None:
                        op.right = i
                    else:
                        raise AssertionError
                    self.add_hit(op)
                    del chain[k]
                    if not chain:
                        del self.open_mates[hit_id]
                    return True
            if hit_partner_pos > hit_left:
                chain.append(PairedHit(left=i, right=None))
            elif hit_partner_pos < hit_left:
                chain.append(PairedHit(left=None, right=i))
            else:
                return False
        return True

    # ---- finalization ------------------------------------------------------
    def _sort_hits_like_reference(self):
        try:
            import ctypes as C
            from ..io.native import get_lib
            lib = get_lib()
            if not getattr(lib, "_sortpairs_bound", False):
                p64 = C.POINTER(C.c_int64)
                lib.strawb_sort_pairs.restype = None
                lib.strawb_sort_pairs.argtypes = [C.c_int64, p64, p64, p64]
                lib._sortpairs_bound = True
            n = len(self.hits)
            lefts = np.array([self.pair_left_pos(ph) for ph in self.hits],
                             np.int64)
            rights = np.array([self.pair_right_pos(ph) for ph in self.hits],
                              np.int64)
            idx = np.arange(n, dtype=np.int64)
            p64 = C.POINTER(C.c_int64)
            lib.strawb_sort_pairs(n, lefts.ctypes.data_as(p64),
                                  rights.ctypes.data_as(p64),
                                  idx.ctypes.data_as(p64))
            self.hits = [self.hits[i] for i in idx.tolist()]
        except OSError:
            self.hits.sort(key=lambda ph: (self.pair_left_pos(ph),
                                           self.pair_right_pos(ph)))

    def collapse_and_filter_hits(self) -> int:
        """Sort, 5-sigma span-outlier filter, duplicate collapse
        (alignments.cpp:658-703)."""
        assert self.hits
        assert not self.uniq_hits
        t = self._table
        # the reference sorts with UNSTABLE std::sort (alignments.cpp:662)
        # and tie order is observable downstream (collapse-mass runs +
        # the frag-set first-insert rule); reproduce libstdc++'s introsort
        # permutation via the native helper, stable-sort fallback
        self._sort_hits_like_reference()
        # getMeanAndSd (common.h:101-110) accumulates sequentially; keep
        # that exact float order (numpy's pairwise reduction differs in the
        # last bits and the 5-sigma phi test sits downstream)
        n_span = len(self.read_ref_span)
        if n_span:
            acc = 0.0
            for v in self.read_ref_span:
                acc += v
            mean = acc / n_span
            sq = 0.0
            for v in self.read_ref_span:
                d = v - mean
                sq += d * d
            sd = math.sqrt(sq / n_span)
        else:
            mean = 0.0
            sd = 0.0
        sd *= 5.0
        with np.errstate(divide="ignore", invalid="ignore"):
            for ph in self.hits:
                skip = False
                for idx in (ph.left, ph.right):
                    if idx is None:
                        continue
                    ln = float(t.right[idx] - t.left[idx] + 1)
                    x = float(np.float64(ln - mean) / np.float64(sd))
                    if phi(x) > 0.999:
                        skip = True
                        break
                if skip:
                    continue
                # init_raw_mass
                m = 0.0
                if ph.left is not None:
                    m += self.hit_mass(ph.left)
                if ph.right is not None:
                    m += self.hit_mass(ph.right)
                ph.mass = m
                self.weighted_mass += m
                if self.uniq_hits and self.pair_eq(self.uniq_hits[-1], ph):
                    self.uniq_hits[-1].collapse_mass += ph.mass
                else:
                    self.uniq_hits.append(ph)
                    self.uniq_hits[-1].collapse_mass += ph.mass
        return len(self.uniq_hits)

    def set_boundaries(self):
        if self.cfg.enforce_ref_models and self.ref_mrnas:
            self.leftmost = min(r.left for r in self.ref_mrnas)
            self.rightmost = max(r.right for r in self.ref_mrnas)

    def guess_strand(self) -> int:
        """Max single-intron vote (alignments.cpp:373-395)."""
        max_count = -(1 << 62)
        best = STRAND_UNKNOWN
        for strand in (STRAND_PLUS, STRAND_MINUS):
            for cnt in self.strand_intron.get(strand, {}).values():
                if cnt > max_count:
                    max_count = cnt
                    best = strand
        return best

    def refine_cluster(self):
        """Split a denovo cluster into strand segments via 1-D binary
        clustering of spliced-read strands (alignments.cpp:160-307)."""
        uh = self.uniq_hits
        bound = [self.pair_left_pos(uh[0]), self.pair_right_pos(uh[0])]
        start = 0
        end = 1
        plus_minus: List[int] = []
        intron_read_idx: List[int] = []

        def emit(bound, start, end, plus_minus, intron_read_idx):
            sep = one_d_binary_clustering(plus_minus)
            if sep != -1 and sep + 1 != len(plus_minus):
                first_class = plus_minus[sep]
                sl = intron_read_idx[sep]
                sr = intron_read_idx[sep + 1]
                f_l, f_r = UINT_MAX, 0
                s_l, s_r = UINT_MAX, 0
                for ii in range(start, sr):
                    f_l = min(self.pair_left_pos(uh[ii]), f_l)
                    f_r = max(self.pair_right_pos(uh[ii]), f_r)
                for ii in range(sl, end):
                    s_l = min(self.pair_left_pos(uh[ii]), s_l)
                    s_r = max(self.pair_right_pos(uh[ii]), s_r)
                if first_class == 0:
                    self.segs.append(Segment(f_l, f_r, start, sr, STRAND_PLUS))
                    self.segs.append(Segment(s_l, s_r, sl + 1, end + 1,
                                             STRAND_MINUS))
                else:
                    self.segs.append(Segment(f_l, f_r, start, sr, STRAND_MINUS))
                    self.segs.append(Segment(s_l, s_r, sl + 1, end + 1,
                                             STRAND_PLUS))
            else:
                first_class = plus_minus[-1] if plus_minus else -1
                if first_class == -1:
                    st = STRAND_UNKNOWN
                elif first_class == 0:
                    st = STRAND_PLUS
                else:
                    st = STRAND_MINUS
                self.segs.append(Segment(bound[0], bound[1], start, end + 1, st))

        for i in range(len(uh)):
            it = uh[i]
            lp = self.pair_left_pos(it)
            if bound[0] <= lp <= bound[1]:
                if self.pair_contains_splice(it):
                    s = self.pair_strand(it)
                    if s == STRAND_PLUS:
                        plus_minus.append(0)
                    elif s == STRAND_MINUS:
                        plus_minus.append(1)
                    intron_read_idx.append(i)
                end = i
                bound[0] = min(bound[0], lp)
                bound[1] = max(bound[1], self.pair_right_pos(it))
            else:
                emit(bound, start, end, plus_minus, intron_read_idx)
                start = i
                bound = [lp, self.pair_right_pos(it)]
                plus_minus = []
                intron_read_idx = []
                if self.pair_contains_splice(it):
                    s = self.pair_strand(it)
                    if s == STRAND_PLUS:
                        plus_minus.append(0)
                    elif s == STRAND_MINUS:
                        plus_minus.append(1)
                    intron_read_idx.append(i)
        emit(bound, start, end, plus_minus, intron_read_idx)

    # ---- conversion --------------------------------------------------------
    def pair_to_contig(self, ph: PairedHit) -> Optional[Contig]:
        """Contig(PairedHit) (contig.cpp:216-267). None = merge failure
        (maps to the reference's ref_id==-1 sentinel)."""
        t = self._table
        i = ph.left if ph.left is not None else ph.right
        ref_id = int(t.ref_id[i])
        read_id = int(t.read_id[i])
        strand = self.pair_strand(ph)
        if ph.is_paired():
            lf = self._feats(ph.left)
            rf = self._feats(ph.right)
            ct = contig_from_pair(ref_id, read_id, strand, lf, rf,
                                  int(t.right[ph.left]), int(t.left[ph.right]),
                                  ph.collapse_mass, 2)
        else:
            f = self._feats(i)
            orit = 0 if ph.left is not None else 1
            ct = Contig(ref_id=ref_id, strand=strand, feats=feats_sorted(f),
                        mass=ph.collapse_mass, contig_id=read_id,
                        single_orit=orit)
        return ct

    def uniq_hit_contigs(self) -> List[Contig]:
        """uniq hits as Contigs, dropping failed pair merges."""
        out = []
        for ph in self.uniq_hits:
            c = self.pair_to_contig(ph)
            if c is not None:
                out.append(c)
        return out

    def size(self) -> int:
        return len(self.hits)

    def num_uniq(self) -> int:
        return len(self.uniq_hits)

    def len(self) -> int:
        return self.rightmost - self.leftmost + 1


def hit_lt_cluster(table: HitTable, i: int, cluster: HitCluster,
                   olap_radius: int) -> bool:
    if int(table.ref_id[i]) != cluster.ref_id:
        return int(table.ref_id[i]) < cluster.ref_id
    return int(table.right[i]) + olap_radius < cluster.leftmost


def hit_gt_cluster(table: HitTable, i: int, cluster: HitCluster,
                   olap_radius: int) -> bool:
    if int(table.ref_id[i]) != cluster.ref_id:
        return int(table.ref_id[i]) > cluster.ref_id
    return int(table.left[i]) > cluster.rightmost + olap_radius


class ClusterFactory:
    """Sample's cluster iteration (alignments.cpp:1025-1286) over an
    in-memory HitTable."""

    def __init__(self, table: HitTable, cfg: Config,
                 ref_mrnas: Optional[List[Contig]] = None):
        self.table = table
        self.cfg = cfg
        self.ref_mrnas: List[Contig] = ref_mrnas or []
        self.ref_flat = None
        self.decode_counts = None  # per-row decode-trace accumulator (-v)
        self.refmrna_offset = 0
        self.has_load_all_refs = False
        self.cursor = 0

    def reset_cursor(self):
        self.cursor = 0

    def set_ref_mrnas(self, refs: List[Contig], flat=None):
        self.ref_mrnas = refs
        # cached flat RLE (off, code, left, len) matching refs order, when
        # the loader built one (saves re-flattening 100k+ transcripts)
        self.ref_flat = flat
        self.refmrna_offset = 0
        self.has_load_all_refs = False

    # -- reference loading ---------------------------------------------------
    def add_ref_to_cluster(self, cluster: HitCluster) -> int:
        refs = self.ref_mrnas
        if self.refmrna_offset >= len(refs):
            self.has_load_all_refs = True
            return 0
        cluster.gene_id = refs[self.refmrna_offset].parent_id
        cluster.add_ref_contig(refs[self.refmrna_offset])
        self.refmrna_offset += 1
        if self.refmrna_offset >= len(refs):
            self.has_load_all_refs = True
            return 1
        if cluster.gene_id != "":
            while (self.refmrna_offset < len(refs)
                   and refs[self.refmrna_offset].parent_id == cluster.gene_id):
                cluster.add_ref_contig(refs[self.refmrna_offset])
                self.refmrna_offset += 1
            if self.refmrna_offset == len(refs):
                self.has_load_all_refs = True
                return len(cluster.ref_mrnas)
            mark_next_gene = self.refmrna_offset
            # scan a bounded window ahead for interleaved same-gene entries
            # (alignments.cpp:1050-1059)
            over = 0
            while True:
                self.refmrna_offset += 1
                if not (self.refmrna_offset < len(refs) and over < 100):
                    break
                over += 1
                r = refs[self.refmrna_offset]
                if (r.parent_id == cluster.gene_id
                        and r.ref_id == cluster.ref_id):
                    cluster.add_ref_contig(r)
            self.refmrna_offset = mark_next_gene
        else:
            i = 0
            while i < len(cluster.ref_mrnas):
                ref = cluster.ref_mrnas[i]
                nxt = refs[self.refmrna_offset]
                if (ref.ref_id == nxt.ref_id and ref.strand == nxt.strand
                        and ref.left <= nxt.right and nxt.left <= ref.right):
                    cluster.add_ref_contig(nxt)
                    self.refmrna_offset += 1
                    if self.refmrna_offset >= len(refs):
                        self.has_load_all_refs = True
                        return len(cluster.ref_mrnas)
                    i = 0
                else:
                    i += 1
        return len(cluster.ref_mrnas)

    def rewind_reference(self, cluster: HitCluster, num_regress: int):
        cluster.leftmost = UINT_MAX
        cluster.rightmost = 0
        cluster.ref_id = -1
        cluster.ref_mrnas = []
        self.refmrna_offset -= num_regress
        assert self.refmrna_offset >= 0

    # -- cluster iterators ---------------------------------------------------
    def next_cluster_denovo(self, cluster: HitCluster,
                            next_ref_start_pos: int = 1 << 62,
                            next_ref_start_ref: int = 1 << 30) -> int:
        t = self.table
        cfg = self.cfg
        cluster._table = t
        if self.cursor >= len(t):
            return -1
        while True:
            if self.cursor >= len(t):
                return cluster.size()
            i = self.cursor
            self.cursor += 1
            if self.decode_counts is not None:
                self.decode_counts[i] += 1
            if (int(t.ref_id[i]) > next_ref_start_ref
                    or (int(t.ref_id[i]) == next_ref_start_ref
                        and int(t.right[i]) >= next_ref_start_pos)):
                self.cursor -= 1
                return cluster.size()
            if cluster.ref_id == -1:
                cluster.add_open_hit(i, True, True)
            else:
                if hit_lt_cluster(t, i, cluster, cfg.max_olap_dist):
                    continue  # BAM not sorted; reference warns and skips
                if hit_gt_cluster(t, i, cluster, cfg.max_olap_dist):
                    self.cursor -= 1
                    break
                cluster.add_open_hit(i, True, True)
        return cluster.size()

    def next_cluster_refguide(self, cluster: HitCluster) -> int:
        t = self.table
        cfg = self.cfg
        cluster._table = t
        if self.cursor >= len(t):
            return -1
        if not self.ref_mrnas:
            return self.next_cluster_denovo(cluster)
        num_added = self.add_ref_to_cluster(cluster)
        if num_added == 0:
            return self.next_cluster_denovo(cluster)
        while True:
            if self.cursor >= len(t):
                break
            i = self.cursor
            self.cursor += 1
            if self.decode_counts is not None:
                self.decode_counts[i] += 1
            if hit_lt_cluster(t, i, cluster, cfg.max_olap_dist):
                self.cursor -= 1
                if self.has_load_all_refs:
                    self.rewind_reference(cluster, num_added)
                    return self.next_cluster_denovo(cluster)
                nxt = self.ref_mrnas[self.refmrna_offset]
                self.rewind_reference(cluster, num_added)
                return self.next_cluster_denovo(cluster, nxt.left, nxt.ref_id)
            if hit_gt_cluster(t, i, cluster, cfg.max_olap_dist):
                self.cursor -= 1
                break
            cluster.add_open_hit(i, False, False)
        return cluster.size()

    def next_cluster_ref_demand(self, cluster: HitCluster) -> int:
        t = self.table
        cluster._table = t
        if not self.ref_mrnas:
            raise RuntimeError("--no-assembly requires -g annotation")
        if self.cursor >= len(t):
            return -1
        num_added = self.add_ref_to_cluster(cluster)
        if num_added == 0:
            return -1
        while True:
            if self.cursor >= len(t):
                break
            i = self.cursor
            self.cursor += 1
            if self.decode_counts is not None:
                self.decode_counts[i] += 1
            if hit_lt_cluster(t, i, cluster, 0):
                pass
            elif hit_gt_cluster(t, i, cluster, 0):
                self.cursor -= 1
                break
            elif (int(t.strand[i]) != STRAND_UNKNOWN
                  and int(t.strand[i]) != cluster.ref_strand()):
                pass
            else:
                cluster.add_open_hit(i, False, False)
        return cluster.size()


def finalize_cluster(cluster: HitCluster, clear_open_mates: bool = True):
    """Sample::finalizeCluster (alignments.cpp:1351-1361)."""
    if cluster.size() == 0:
        return
    if clear_open_mates:
        cluster.open_mates.clear()
    cluster.collapse_and_filter_hits()
    cluster.set_boundaries()
