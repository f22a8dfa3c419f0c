"""Genomic feature (RLE) algebra and the Contig data model.

Mirrors the reference's universal exon/intron/gap run-length encoding
(ref: include/contig.h, src/contig.cpp). A feature is a (code, left, len)
triple with code in {MATCH, INTRON, GAP}; a Contig is a sorted feature list
representing a read, a merged read pair, or a transcript.

This module is the host-side semantic oracle; the batched equivalents of
the hot predicates (compatibility, overlap length) live in
native/compat.cc and quant/device_prep.py.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

S_MATCH, S_INTRON, S_GAP = 0, 1, 2
STRAND_UNKNOWN, STRAND_PLUS, STRAND_MINUS, STRAND_BOTH = 0, 1, 2, 3

# A feature is (code, left, length); right = left + length - 1.
Feature = Tuple[int, int, int]


def feat_right(f: Feature) -> int:
    return f[1] + f[2] - 1


def feat_key(f: Feature):
    """Ordering of GenomicFeature::operator< (contig.cpp:186-193): by
    genomic offset then length; code is NOT compared."""
    return (f[1], f[2])


def feats_sorted(feats: Sequence[Feature]) -> List[Feature]:
    return sorted(feats, key=feat_key)


def merge_genomic_feats(feats: Sequence[Feature]) -> List[Feature]:
    """Pair-overlap merge (contig.h:111-138 merge_genomicFeats).

    Input must be sorted. Runs of same-code features are unioned; introns in
    a run must be identical, overlapping matches must actually overlap.
    Returns [] if the pair is inconsistent.
    """
    result: List[Feature] = []
    i = 0
    n = len(feats)
    while i < n:
        code, left, ln = feats[i]
        while i < n - 1 and code == feats[i + 1][0]:
            nxt = feats[i + 1]
            if code == S_INTRON:
                if (code, left, ln) != nxt:
                    return []
            else:
                if left + ln - 1 < nxt[1]:
                    return []
                right = max(left + ln - 1, feat_right(nxt))
                ln = right - left + 1
            i += 1
        result.append((code, left, ln))
        i += 1
    return result


def merge_features(feats: Sequence[Feature]) -> List[Feature]:
    """Glue exactly-adjacent same-code features (contig.cpp:196-213)."""
    result: List[Feature] = []
    i = 0
    n = len(feats)
    while i < n:
        code, left, ln = feats[i]
        while (i + 1 < n and left + ln == feats[i + 1][1]
               and code == feats[i + 1][0]):
            ln += feats[i + 1][2]
            i += 1
        result.append((code, left, ln))
        i += 1
    return result


class FeatView:
    """Lazy feature sequence over flat RLE arrays.

    Quacks like the List[Feature] a Contig normally carries, but holds
    only (array refs, o0, o1) until an element is actually read — the
    (code, left, len) tuple list is built on first access. Annotation and
    natively-assembled transcripts are created in bulk (10^5-10^6 feature
    tuples); most are only ever consulted for their span (answered from
    the arrays without materializing) or never consulted at all, so the
    tuple build is deferred to the minority that needs it."""

    __slots__ = ("_code", "_left", "_len", "_o0", "_o1", "_mat")

    def __init__(self, code, left, len_, o0: int, o1: int):
        self._code = code
        self._left = left
        self._len = len_
        self._o0 = o0
        self._o1 = o1
        self._mat = None

    def _m(self) -> List[Feature]:
        m = self._mat
        if m is None:
            o0, o1 = self._o0, self._o1
            m = self._mat = list(zip(self._code[o0:o1].tolist(),
                                     self._left[o0:o1].tolist(),
                                     self._len[o0:o1].tolist()))
        return m

    def __len__(self) -> int:
        return self._o1 - self._o0

    def __getitem__(self, i):
        return self._m()[i]

    def __iter__(self):
        return iter(self._m())

    def __eq__(self, other):
        if isinstance(other, FeatView):
            other = other._m()
        return self._m() == other

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"FeatView({self._m()!r})"

    def __reduce__(self):
        # pickle as a plain tuple list: shipping the (shared) backing
        # arrays would be wasteful across process boundaries
        return (list, (self._m(),))

    def first_left(self) -> int:
        return int(self._left[self._o0])

    def last_right(self) -> int:
        j = self._o1 - 1
        return int(self._left[j]) + int(self._len[j]) - 1


@dataclass(slots=True)
class Contig:
    """A read, merged fragment, or transcript (ref: contig.h:143-236)."""
    ref_id: int
    strand: int
    feats: List[Feature]
    mass: float = 0.0
    is_ref: bool = False
    contig_id: int = 0            # ReadID for fragments; 0 for refs
    # annotation / output strings
    trans_id: str = ""
    parent_id: str = ""
    ref_gene_id: str = ""
    ref_gene_name: str = ""
    # single-read orientation: 0 fwd, 1 rev, 2 not-single (contig.h:33-38)
    single_orit: int = 2
    avg_covs: Optional[List[float]] = None   # per-MATCH-feature avg coverage

    @property
    def left(self) -> int:
        f = self.feats
        if type(f) is FeatView and f._mat is None:
            return f.first_left()
        return f[0][1]

    @property
    def right(self) -> int:
        f = self.feats
        if type(f) is FeatView and f._mat is None:
            return f.last_right()
        return feat_right(f[-1])

    def exonic_length(self) -> int:
        return sum(f[2] for f in self.feats if f[0] == S_MATCH)

    def exons(self) -> List[Feature]:
        return [f for f in self.feats if f[0] == S_MATCH]

    def introns(self) -> List[Feature]:
        return [f for f in self.feats if f[0] == S_INTRON]

    def is_single_read(self) -> bool:
        if self.is_ref:
            return False
        return all(f[0] != S_GAP for f in self.feats)

    def sort_key(self):
        """Contig::operator< (contig.cpp:342-347): ref_id then lexicographic
        feature comparison with GenomicFeature ordering ((left, len), code
        not compared)."""
        return (self.ref_id, [(f[1], f[2]) for f in self.feats])

    def structure_key(self):
        """Equality key: Contig::operator== compares features incl. code."""
        return (tuple(self.feats))

    def avg_doc(self) -> float:
        assert self.avg_covs
        return sum(self.avg_covs) / len(self.avg_covs)


def sort_contigs(contigs: List["Contig"]) -> List["Contig"]:
    """Exact Contig::operator< ordering (== sorted(key=sort_key)), fast:
    numpy-lexsort on (ref_id, first/second feature (left, len)) — the full
    lexicographic Python comparison runs only inside still-tied runs.
    Shorter-prefix-first is preserved by the -1 sentinel (real coords and
    lengths are positive)."""
    n = len(contigs)
    if n < 64:
        return sorted(contigs, key=lambda c: c.sort_key())
    import numpy as np
    ref = np.fromiter((c.ref_id for c in contigs), np.int64, n)
    cols = [ref]
    for fi in range(4):  # isoforms often share the first exon+intron
        cols.append(np.fromiter(
            (c.feats[fi][1] if len(c.feats) > fi else -1 for c in contigs),
            np.int64, n))
        cols.append(np.fromiter(
            (c.feats[fi][2] if len(c.feats) > fi else -1 for c in contigs),
            np.int64, n))
    order = np.lexsort(tuple(reversed(cols)))  # stable; last key primary
    out: List[Contig] = [contigs[i] for i in order]
    # resolve runs still tied on the numeric prefix with the full key
    keys = np.stack([c[order] for c in cols], axis=1)
    run_start = np.flatnonzero(
        np.any(keys[1:] != keys[:-1], axis=1)) + 1
    bounds = [0] + run_start.tolist() + [n]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 - b0 > 1:
            out[b0:b1] = sorted(out[b0:b1], key=lambda c: c.sort_key())
    return out


def contig_sort_cmp(a: Contig, b: Contig) -> bool:
    """True if a < b under Contig::operator<."""
    if a.ref_id != b.ref_id:
        return a.ref_id < b.ref_id
    ka = [feat_key(f) for f in a.feats]
    kb = [feat_key(f) for f in b.feats]
    return ka < kb


def contig_from_pair(ref_id: int, read_id: int, strand: int,
                     left_feats: Optional[List[Feature]],
                     right_feats: Optional[List[Feature]],
                     left_right: int, right_left: int,
                     mass: float, single_orit: int) -> Optional[Contig]:
    """Contig(PairedHit) (contig.cpp:216-267).

    left_right: rightmost coord of left read; right_left: leftmost coord of
    right read (both 1-based) — used for gap insertion when both reads exist.
    Returns None when merge fails (incompatible overlapping mates).
    """
    if left_feats is not None and right_feats is not None:
        g = list(left_feats) + list(right_feats)
        gap_len = right_left - left_right - 1
        if gap_len > 0:
            g.append((S_GAP, left_right + 1, gap_len))
            g = feats_sorted(g)
        else:
            g = feats_sorted(g)
            g = merge_genomic_feats(g)
    else:
        g = list(right_feats) if right_feats is not None else list(left_feats)

    if not g:
        return None
    g = feats_sorted(g)
    return Contig(ref_id=ref_id, strand=strand, feats=g, mass=mass,
                  is_ref=False, contig_id=read_id, single_orit=single_orit)


def feature_contains(outer: Feature, inner: Feature, small_extent: int = 0) -> bool:
    return (outer[1] - small_extent <= inner[1]
            and feat_right(outer) + small_extent >= feat_right(inner))


def overlaps(a: Feature, b: Feature) -> bool:
    return a[1] <= feat_right(b) and b[1] <= feat_right(a)


def overlap_len_in_genome(f: Feature, left: int, right: int) -> int:
    if f[1] <= right and left <= feat_right(f):
        return min(feat_right(f), right) - max(f[1], left) + 1
    return 0


def is_compatible(read: Contig, isoform: Contig) -> bool:
    """Contig::is_compatible(read, isoform) (contig.cpp:547-599).

    Intron chain of the read must match the isoform's intron chain exactly at
    the corresponding positions; read exons must be contained in iso exons.
    """
    if read.is_ref:
        return False
    exons = isoform.exons()
    first = read.feats[0]
    # lower_bound on exons by right() < first.left
    lo, hi = 0, len(exons)
    fl = first[1]
    while lo < hi:
        mid = (lo + hi) // 2
        if feat_right(exons[mid]) < fl:
            lo = mid + 1
        else:
            hi = mid
    if lo == len(exons):
        return False
    it = lo
    if not feature_contains(exons[it], first):
        return False
    iso_feats = isoform.feats
    for i in range(1, len(read.feats)):
        rf = read.feats[i]
        if rf[0] == S_GAP:
            continue
        if rf[0] == S_INTRON:
            next_intron_offset = 2 * it + 1
            if next_intron_offset >= len(iso_feats):
                return False
            if rf != iso_feats[next_intron_offset]:
                return False
        else:
            while it < len(exons) and not feature_contains(exons[it], rf):
                it += 1
            if it == len(exons):
                return False
    return True


def is_compatible_feat(isoform: Contig, feat: Feature) -> bool:
    """Contig::is_compatible(isoform, feat) (contig.cpp:615-634)."""
    if feat[0] != S_MATCH:
        return False
    exons = isoform.exons()
    lo, hi = 0, len(exons)
    fl = feat[1]
    while lo < hi:
        mid = (lo + hi) // 2
        if feat_right(exons[mid]) < fl:
            lo = mid + 1
        else:
            hi = mid
    if lo == len(exons):
        return False
    return feature_contains(exons[lo], feat)


def is_contained_in(small: Contig, large: Contig) -> bool:
    """Exon-bin in transcript test (contig.cpp:448-490)."""
    if len(small.feats) == 1:
        for f in large.feats:
            if f[0] == S_MATCH and feature_contains(f, small.feats[0]):
                return True
        return False
    small_introns = small.introns()
    large_introns = large.introns()
    keys = sorted(feat_key(f) for f in large_introns)
    for si in small_introns:
        k = feat_key(si)
        idx = bisect_left(keys, k)
        if idx >= len(keys) or keys[idx] != k:
            return False
    return True


def exonic_overlaps_len(iso: Contig, left: int, right: int) -> int:
    """Fragment length on a transcript (contig.cpp:412-426)."""
    return sum(overlap_len_in_genome(f, left, right)
               for f in iso.feats if f[0] == S_MATCH)
