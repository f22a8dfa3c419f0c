"""Exon bins, effective lengths, and theoretical bin weights.

Host oracle for the LocusContext observation model (ref: include/isoform.h,
include/estimate.hpp:15-224, src/estimate.cpp:115-277). An ExonBin — the
latent-class-model observation unit — is the set of disjoint exon segments a
fragment touches; its per-isoform weight integrates the insert-size pdf over
the combinatorial effective length of the bin under that isoform.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.features import (Contig, Feature, S_MATCH, feat_right,
                             is_compatible, is_compatible_feat,
                             exonic_overlaps_len, overlaps)

Coords = Tuple[Tuple[int, int], ...]   # ordered exon-seg (left,right) pairs


def disjoint_exon_segs(exons: List[Feature]) -> List[Feature]:
    """IRanges(closed).disjoint() (include/interval.hpp:150-191): split the
    union of exon features at every boundary into non-overlapping segments
    covered by at least one input interval."""
    if not exons:
        return []
    # convert to half-open
    starts = [f[1] for f in exons]
    ends = [feat_right(f) + 1 for f in exons]
    left = min(starts)
    right = max(ends)
    cov = np.zeros(right - left, dtype=np.int32)
    for s, e in zip(starts, ends):
        cov[s - left:e - left] += 1
    bars = sorted(set(starts) | set(ends))
    result: List[Tuple[int, int]] = []
    pending_left: Optional[int] = None
    i = 0
    while i < len(bars):
        b = bars[i]
        if pending_left is None:
            pending_left = b
        else:
            if b == pending_left:
                pending_left = None  # pop_back equivalent (dead: bars unique)
            else:
                result.append((pending_left, b))
                # reference reads cov[b-left] even when b is one past the
                # end (UB read, interval.hpp:178) — the reopened interval is
                # always popped at the end, so out-of-range == don't reopen
                if b - left < len(cov) and cov[b - left] > 0:
                    i -= 1  # reuse this bar as next left
                pending_left = None
        i += 1
    # trailing unmatched left is dropped (reference pops it)
    return [(S_MATCH, l, r - l) for (l, r) in result]


def no_gap_ef(l_left: int, l_right: int, l_int: int, fl: int) -> int:
    """isoform.h:105-115."""
    if fl < l_int + 2:
        return 0
    if fl > l_left + l_right + l_int:
        return 0
    mid = fl - l_int - 1
    return min(l_left, mid) + min(l_right, mid) - mid


def gap_ef(l_left: int, l_right: int, l_int: int, rl: int, gap: int) -> int:
    """isoform.h:117-129."""
    if 2 * rl + gap < l_int + 2:
        return 0
    if 2 * rl + gap > l_left + l_right + l_int:
        return 0
    start = max(rl, l_left + l_int - gap - 1)
    end = min(l_left, l_left + l_right + l_int - gap - rl)
    return max(0, end - start)


def effective_len(seg_lens: Sequence[int], implicit_idx: Sequence[int],
                  fl: int, rl: int) -> int:
    """ExonBin::effective_len (isoform.h:419-516): number of fragment
    placements of length fl (read length rl each end) that touch exactly the
    non-implicit segments. Closed forms for <=4 segments, bitmask enumeration
    beyond."""
    gap = fl - 2 * rl
    n = len(seg_lens)
    if n == 1:
        return seg_lens[0] - fl + 1
    if n == 2:
        return no_gap_ef(seg_lens[0], seg_lens[1], 0, fl)
    if n == 3:
        if len(implicit_idx) == 1:
            return gap_ef(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap)
        if len(implicit_idx) == 0:
            return (no_gap_ef(seg_lens[0], seg_lens[2], seg_lens[1], fl)
                    - gap_ef(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap))
        raise AssertionError
    if n == 4:
        hit14 = gap_ef(seg_lens[0], seg_lens[3], seg_lens[2] + seg_lens[1], rl, gap)
        hit24 = gap_ef(seg_lens[3], seg_lens[1], seg_lens[2], rl, gap)
        hit124 = gap_ef(seg_lens[0] + seg_lens[1], seg_lens[3], seg_lens[2], rl, gap)
        hit13 = gap_ef(seg_lens[0], seg_lens[2], seg_lens[1], rl, gap)
        hit134 = gap_ef(seg_lens[0], seg_lens[2] + seg_lens[3], seg_lens[1], rl, gap)
        if len(implicit_idx) == 0:
            hit_all_124 = hit124 - hit14 - hit24
            hit_all_134 = hit134 - hit14 - hit13
            total = no_gap_ef(seg_lens[0], seg_lens[3],
                              seg_lens[1] + seg_lens[2], fl)
            return total - hit_all_124 - hit_all_134 - hit14
        if len(implicit_idx) == 2:
            return hit14
        if implicit_idx[0] == 1:
            return hit134 - hit14 - hit13
        return hit124 - hit14 - hit24
    # >4 segments: bitmask enumeration over left-end positions
    num_inners = n - 2
    num_pos = 0
    target = (1 << n) - 1
    for idx in implicit_idx:
        target &= ~(1 << idx)
    inner_sum = sum(seg_lens[1:n - 1])
    for i in range(1, seg_lens[0] + 1):
        hit = 1
        bp_last = fl - i - inner_sum
        # reference quirk (isoform.h:485): `bp_last > *seg_lens.rbegin()`
        # compares int against uint — a negative bp_last converts to a huge
        # unsigned value and takes the `continue`, so the assert(bp_last<0)
        # on the next line is unreachable
        if bp_last > seg_lens[-1] or bp_last < 0:
            continue
        if bp_last == 0:
            break
        hit |= 1 << (n - 1)
        last_rest = rl - bp_last
        j = num_inners
        while last_rest > 0 and j > 0:
            hit |= 1 << j
            last_rest -= seg_lens[j]
            j -= 1
        first_rest = rl - i
        j = 1
        while first_rest > 0 and j <= num_inners:
            hit |= 1 << j
            first_rest -= seg_lens[j]
            j += 1
        if hit == target:
            num_pos += 1
    return num_pos


@dataclass
class ExonBin:
    coords: Coords
    frag_keys: Set[tuple] = field(default_factory=set)
    frag_masses: Dict[tuple, float] = field(default_factory=dict)
    bin_weight_map: Dict[int, float] = field(default_factory=dict)
    iso_frag_lens: Dict[int, List[Tuple[int, float]]] = field(default_factory=dict)
    whole_read_mass: float = 0.0
    id: int = -1

    def add_frag(self, frag: Contig, key=None):
        """_frags is a std::set keyed by Contig::operator< — ref_id plus the
        (left,len) feature sequence, code NOT compared (contig.cpp:342-347).
        Callers in hot loops pass a precomputed key."""
        if key is None:
            key = (frag.ref_id, tuple((f[1], f[2]) for f in frag.feats))
        if key not in self.frag_keys:
            self.frag_keys.add(key)
            self.frag_masses[key] = frag.mass

    def add_frag_len(self, iso: int, frag_len: int, mass: float):
        self.whole_read_mass += mass
        self.iso_frag_lens.setdefault(iso, []).append((frag_len, mass))

    def read_count(self) -> float:
        return sum(self.frag_masses.values())

    def left(self) -> int:
        return self.coords[0][0]


def overlap_exons(exon_segs: List[Feature], read: Contig) -> Coords:
    """LocusContext::overlap_exons (estimate.cpp:115-131)."""
    out = set()
    for gf in exon_segs:
        if gf[0] != S_MATCH:
            continue
        for rf in read.feats:
            if rf[0] != S_MATCH:
                continue
            if overlaps(rf, gf):
                out.add((gf[1], feat_right(gf)))
    return tuple(sorted(out))


def bin_under_iso(bin_coords: Coords, iso_segs: List[Feature]
                  ) -> Tuple[List[int], List[Tuple[int, int]]]:
    """ExonBin::bin_under_iso (isoform.h:363-411): the isoform's exon segs
    spanning the bin, and the indices of implicit (gap-skipped) segments."""
    start_pos = [f[1] for f in iso_segs]
    low = bisect_left(start_pos, bin_coords[0][0])
    up = bisect_left(start_pos, bin_coords[-1][0])
    exon_coords = [(iso_segs[i][1], feat_right(iso_segs[i]))
                   for i in range(low, up + 1)]
    idx: List[int] = []
    ci = 1
    i = 1
    while i < len(exon_coords) - 1:
        if exon_coords[i][0] < bin_coords[ci][0]:
            idx.append(i)
            i += 1
        elif exon_coords[i][0] == bin_coords[ci][0]:
            i += 1
            ci += 1
        else:
            raise AssertionError("bin coord not found among isoform segs")
    return idx, exon_coords
