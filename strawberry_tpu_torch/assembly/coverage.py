"""Per-locus coverage and intron-table computation + intron filters.

Host oracle for compute_doc / filter_intron (ref: src/alignments.cpp:
1838-2036). The batched device version (scatter-add over padded locus rows)
lives in assembly/device.py; this module defines the exact semantics,
including the reference's off-by-one quirks which affect output:
  * intron-depth window sums exclude the final base (alignments.cpp:2009)
  * the exon-doc duplicate buffer carries one trailing zero (…:2011-2012)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from ..core.cluster import phi
from ..core.features import Contig, S_INTRON, S_MATCH


@dataclass
class IntronEntry:
    left: int
    right: int
    total_junc_reads: float = 0.0
    small_span_read: float = 0.0
    median_depth: float = 0.0


IntronMap = Dict[Tuple[int, int], IntronEntry]


def compute_doc(left: int, right: int, hits: List[Contig],
                exon_doc: np.ndarray, intron_counter: IntronMap,
                small_overhang: float, use_native: bool = False) -> float:
    """compute_doc (alignments.cpp:1838-1900): per-base exon depth plus
    junction-read table with small-overhang counts. Returns average depth
    over covered bases."""
    # NB native path available but off by default: re-flattening the hit
    # features per locus costs more than the numpy slice-adds it replaces
    # at typical short-read depth (profile before flipping).
    if use_native and hits:
        try:
            from ..core.fastcluster import native_coverage
            il, ir, tot, small = native_coverage(
                hits, left, right, small_overhang, exon_doc)
            for k in range(len(il)):
                ent = IntronEntry(int(il[k]), int(ir[k]),
                                  float(tot[k]), float(small[k]))
                intron_counter[(ent.left, ent.right)] = ent
            num_nt = int(np.count_nonzero(exon_doc > 0))
            if num_nt == 0:
                return 0.0
            return float(exon_doc.sum(dtype=np.float64)) / num_nt
        except OSError:
            pass
    for hit in hits:
        if hit.is_ref:
            continue
        g = hit.feats
        mass = hit.mass
        for j, gf in enumerate(g):
            code, gl, gln = gf
            gr = gl + gln - 1
            if code == S_MATCH:
                lo = max(left, gl)
                hi = min(gr, right)
                if hi >= lo:
                    exon_doc[lo - left:hi - left + 1] += mass
            elif code == S_INTRON:
                if gl < left or gr > right:
                    continue
                key = (gl, gr)
                ent = intron_counter.get(key)
                if ent is None:
                    ent = IntronEntry(gl, gr)
                    intron_counter[key] = ent
                ent.total_junc_reads += mass
                if (g[j - 1][2] < small_overhang
                        or g[j + 1][2] < small_overhang):
                    ent.small_span_read += mass
    num_nt = int(np.count_nonzero(exon_doc > 0))
    if num_nt == 0:
        return 0.0
    return float(exon_doc.sum(dtype=np.float64)) / num_nt


def filter_intron(cfg: Config, cluster_left: int, read_abs_len: int,
                  exon_doc: np.ndarray, intron_counter: IntronMap) -> None:
    """filter_intron (alignments.cpp:1902-2036): three sequential filters."""
    intron_doc = np.zeros(len(exon_doc), dtype=np.float32)

    # -- filter one: overlapping-intron relative depth ----------------------
    keys = sorted(intron_counter.keys())
    bad: List[Tuple[int, int]] = []
    for a in range(len(keys)):
        for b in range(a + 1, len(keys)):
            ei = intron_counter[keys[a]]
            ej = intron_counter[keys[b]]
            scale = -1
            if ei.left <= ej.right and ej.left <= ei.right:
                scale = 1
                contains = ((ei.left <= ej.left and ei.right >= ej.right)
                            or (ej.left <= ei.left and ej.right >= ei.right))
                if not contains:
                    scale = 10
            di = ei.total_junc_reads
            dj = ej.total_junc_reads
            if dj < di:
                min_junc, bad_key = dj, keys[b]
            else:
                min_junc, bad_key = di, keys[a]
            if min_junc / (di + dj) < cfg.min_isoform_frac * scale:
                bad.append(bad_key)
    for k in sorted(set(bad)):
        del intron_counter[k]

    # -- filter two: junction support + small-anchor binomial test ----------
    for k in sorted(intron_counter.keys()):
        ent = intron_counter[k]
        total_read = ent.total_junc_reads
        small_read = ent.small_span_read
        if total_read < cfg.min_junc_support and not cfg.enforce_ref_models:
            del intron_counter[k]
            continue
        if (k[1] - k[0] > cfg.long_junc_length
                and total_read < cfg.min_support_for_long_junc
                and not cfg.enforce_ref_models):
            del intron_counter[k]
            continue
        intron_doc[k[0] - cluster_left:k[1] - cluster_left + 1] += total_read
        if small_read == total_read:
            del intron_counter[k]
            continue
        if small_read < 1:
            continue
        success = 2.0 * cfg.min_anchor / read_abs_len
        normal_mean = total_read * success
        normal_sd = math.sqrt(total_read * success * (1 - success))
        with np.errstate(divide="ignore", invalid="ignore"):
            x = float(np.float64(small_read - 0.5 - normal_mean)
                      / np.float64(normal_sd))
        prob_not_lt_observed = 1.0 - phi(x)
        if prob_not_lt_observed < cfg.binomial_overhang_alpha:
            del intron_counter[k]
            continue

    # -- filter three: intron depth vs exonic depth on the intron body ------
    for k in sorted(intron_counter.keys()):
        ent = intron_counter[k]
        start = k[0] - cluster_left
        end = k[1] - cluster_left
        # reference sums [start, end) then divides by (end-start)+1
        avg_intron_doc = float(intron_doc[start:end].sum(dtype=np.float64))
        avg_intron_doc /= (end - start) + 1
        # duplicate buffer sized end-start+1 but only end-start copied:
        # one trailing zero participates in the median (alignments.cpp:2011)
        dup = np.zeros(end - start + 1, dtype=np.float32)
        dup[:end - start] = exon_doc[start:end]
        ent.median_depth = _median(dup)
        avg_intron_exonic = float(dup.sum(dtype=np.float64)) / (end - start)
        if avg_intron_exonic != 0:
            if avg_intron_doc / avg_intron_exonic < cfg.min_isoform_frac:
                del intron_counter[k]


def _median(vals: np.ndarray) -> float:
    """getMedian (common.h:188-199): sort, average middle pair if even."""
    dup = np.sort(vals)
    n = len(dup)
    if n == 0:
        return 0.0
    if n % 2 == 0:
        return (float(dup[n // 2]) + float(dup[n // 2 - 1])) / 2.0
    return float(dup[n // 2])
