"""Splice-graph construction: coverage + introns -> disjoint exon segments.

Host oracle for FlowNetwork::splicingGraph and its filters
(ref: src/assembly.cpp:20-28,174-547). Exon segments come out annotated with
their average depth-of-coverage (compute_exon_doc), which downstream gates
assembled transcripts (kMinDepth4Contig).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..core.features import Feature, S_MATCH
from .coverage import IntronMap, _median


class ExonSeg:
    __slots__ = ("left", "right", "avg_doc")

    def __init__(self, left: int, right: int, avg_doc: float = 0.0):
        self.left = left
        self.right = right
        self.avg_doc = avg_doc

    @property
    def feature(self) -> Feature:
        return (S_MATCH, self.left, self.right - self.left + 1)

    def __repr__(self):
        return f"ExonSeg({self.left}-{self.right},{self.avg_doc:.2f})"


def compute_exon_doc(left: int, exon_doc: np.ndarray,
                     exons: List[ExonSeg]) -> None:
    """compute_exon_doc (assembly.cpp:20-28). NB the sum excludes the exon's
    last base (it_end is exclusive) while dividing by the full length."""
    for e in exons:
        a = e.left - left
        b = e.right - left   # exclusive end -> last base not summed
        cov = float(exon_doc[a:b].sum(dtype=np.float64))
        e.avg_doc = cov / (e.right - e.left + 1)


def remove_low_cov_exon(cfg: Config, cluster_left: int, exon_doc: np.ndarray,
                        intron_counter: IntronMap,
                        exon_boundaries: List[List[int]]) -> None:
    """remove_low_cov_exon (assembly.cpp:174-221)."""
    introns = sorted(intron_counter.items())
    exon_covs = []
    exon_covs_for_median = []
    for (l, r) in exon_boundaries:
        a = l - cluster_left
        b = r - cluster_left   # exclusive: reference's it_end
        cov = float(exon_doc[a:b].sum(dtype=np.float64)) / (r - l)
        exon_covs.append(cov)
        support = 0.0
        for (il, ir), ent in introns:
            if il <= r and l <= ir:
                support = max(ent.total_junc_reads, support)
        if cov > support:
            exon_covs_for_median.append(cov)
    median = _median(np.asarray(exon_covs_for_median, dtype=np.float64)) \
        if exon_covs_for_median else 0.0
    i = 0
    k = 0
    while i < len(exon_boundaries):
        l, r = exon_boundaries[i]
        support = 0.0
        for (il, ir), ent in introns:
            if il <= r and l <= ir:
                support = max(ent.total_junc_reads, support)
        if (exon_covs[k] < support * cfg.min_isoform_frac
                or exon_covs[k] < median * cfg.min_isoform_frac):
            del exon_boundaries[i]
        else:
            i += 1
        k += 1


def filter_exon_segs(paired_bars: List[Tuple[int, int]],
                     exon_boundaries: List[List[int]]) -> None:
    """filter_exon_segs (assembly.cpp:224-315): drop segments with no intron
    support on either side that are not coverage-contiguous with neighbors."""
    e_b = [tuple(x) for x in exon_boundaries]
    left_coords = sorted((pb[0], i) for i, pb in enumerate(paired_bars))
    right_coords = sorted((pb[1], i) for i, pb in enumerate(paired_bars))
    firsts = [x[0] for x in e_b]
    seconds = [x[1] for x in e_b]
    lc_firsts = [x[0] for x in left_coords]
    rc_firsts = [x[0] for x in right_coords]

    dropoff = []
    for ex in range(len(e_b)):
        no_right = False
        li = bisect_left(lc_firsts, e_b[ex][1] + 1)
        if li < len(left_coords) and left_coords[li][0] == e_b[ex][1] + 1:
            right = paired_bars[left_coords[li][1]][1]
            j = bisect_left(firsts, right + 1)
            if not (j < len(firsts) and firsts[j] == right + 1):
                no_right = True
        else:
            no_right = True

        no_left = False
        ri = bisect_left(rc_firsts, e_b[ex][0] - 1)
        if ri < len(right_coords) and right_coords[ri][0] == e_b[ex][0] - 1:
            left = paired_bars[right_coords[ri][1]][0]
            j = bisect_left(seconds, left - 1)
            if not (j < len(seconds) and seconds[j] == left - 1):
                no_left = True
        else:
            no_left = True

        if no_left and no_right and len(e_b) > 1:
            if ex == 0:
                if e_b[ex][1] + 1 != e_b[ex + 1][0]:
                    dropoff.append(ex)
            elif ex == len(e_b) - 1:
                if e_b[ex - 1][1] + 1 != e_b[ex][0]:
                    dropoff.append(ex)
            else:
                if (e_b[ex][1] + 1 != e_b[ex + 1][0]
                        or e_b[ex][0] - 1 != e_b[ex - 1][1]):
                    dropoff.append(ex)

    for d in reversed(dropoff):
        del exon_boundaries[d]


def filter_intron_by_exons(exons: List[ExonSeg],
                           intron_counter: IntronMap) -> None:
    """FlowNetwork::filter_intron (assembly.cpp:317-340): an intron survives
    only if some exon seg ends exactly at intron.left-1 and another starts at
    intron.right+1."""
    rights = [e.right for e in exons]
    lefts = [e.left for e in exons]
    for k in sorted(intron_counter.keys()):
        il, ir = k
        # lower_bound by right() < il-1, then by left() < ir+1
        e1 = bisect_left(rights, il - 1)
        e2 = bisect_left(lefts, ir + 1)
        if e1 == len(exons) or e2 == len(exons):
            del intron_counter[k]
            continue
        if exons[e1].right != il - 1 or exons[e2].left != ir + 1:
            del intron_counter[k]


def splicing_graph(cfg: Config, left: int, exon_doc: np.ndarray,
                   intron_counter: IntronMap) -> Optional[List[ExonSeg]]:
    """FlowNetwork::splicingGraph (assembly.cpp:342-547).

    Returns the disjoint exon segments (with avg depth), or None when the
    locus cannot be assembled (multi-segment but intron-free).
    Mutates intron_counter (exon-boundary matching filter).
    """
    paired_bars: List[Tuple[int, int]] = []
    single_bars: List[Tuple[int, bool]] = []
    for (il, ir) in intron_counter.keys():
        paired_bars.append((il, ir))
        single_bars.append((il, True))
        single_bars.append((ir, False))
    single_bars.sort(key=lambda x: x[0])
    # unique on (coord, side) pairs, preserving order
    sb: List[Tuple[int, bool]] = []
    for b in single_bars:
        if not sb or sb[-1] != b:
            sb.append(b)
    single_bars = sb
    paired_bars = sorted(set(paired_bars))

    # preliminary exon segments from nonzero coverage runs (vectorized run
    # finding; the reference's scalar loop is assembly.cpp:386-402 — NB a
    # run starting at relative position 0 can only open when left>0, the
    # `l == 0` sentinel, which always holds for 1-based coordinates)
    exon_boundaries: List[List[int]] = []
    n = len(exon_doc)
    nz = exon_doc > 0
    diffs = np.diff(nz.astype(np.int8))
    starts = np.nonzero(diffs == 1)[0] + 1
    ends = np.nonzero(diffs == -1)[0]
    if nz[0]:
        starts = np.concatenate(([0], starts))
    if nz[-1]:
        ends = np.concatenate((ends, [n - 1]))
    for s0, e0 in zip(starts, ends):
        exon_boundaries.append([int(s0) + left, int(e0) + left])

    # gap filling (assembly.cpp:411-443)
    i = 0
    while i + 1 < len(exon_boundaries):
        head = exon_boundaries[i][1]
        tail = exon_boundaries[i + 1][0]
        no_intron_overlap = True
        no_intron_support = True
        for (il, ir) in intron_counter.keys():
            if il <= tail and head <= ir:
                no_intron_overlap = False
            if il == head + 1 and tail - 1 == ir:
                no_intron_support = False
        if no_intron_overlap:
            if tail - head < cfg.max_cover_gap1:
                exon_boundaries[i + 1][0] = exon_boundaries[i][0]
                del exon_boundaries[i]
                continue
        else:
            if no_intron_support and tail - head < cfg.max_cover_gap2:
                exon_boundaries[i + 1][0] = exon_boundaries[i][0]
                del exon_boundaries[i]
                continue
        i += 1

    # single-exon short circuit (assembly.cpp:450-460)
    if not paired_bars:
        if len(exon_boundaries) > 1:
            return None
        l0 = exon_boundaries[0][0]
        r0 = exon_boundaries[-1][1]
        exons = [ExonSeg(l0, r0)]
        compute_exon_doc(left, exon_doc, exons)
        return exons

    # split segments at intron bars (assembly.cpp:475-499)
    e = 0
    s = 0
    while e < len(exon_boundaries) and s < len(single_bars):
        bar, is_left = single_bars[s]
        if bar < exon_boundaries[e][0]:
            s += 1
        elif exon_boundaries[e][0] <= bar <= exon_boundaries[e][1]:
            temp = exon_boundaries[e][1]
            if is_left:
                exon_boundaries[e][1] = bar - 1
                exon_boundaries.insert(e + 1, [bar, temp])
            else:
                exon_boundaries[e][1] = bar
                exon_boundaries.insert(e + 1, [bar + 1, temp])
            s += 1
        else:
            e += 1

    # drop degenerate (right <= left)
    exon_boundaries = [eb for eb in exon_boundaries if eb[1] > eb[0]]

    remove_low_cov_exon(cfg, left, exon_doc, intron_counter, exon_boundaries)
    filter_exon_segs(paired_bars, exon_boundaries)

    exons = [ExonSeg(l0, r0) for (l0, r0) in exon_boundaries if r0 - l0 + 1 > 0]
    exons.sort(key=lambda x: (x.left, x.right))
    compute_exon_doc(left, exon_doc, exons)
    filter_intron_by_exons(exons, intron_counter)
    return exons
