"""The plain reference of quantification against an annotation, and the
comparison that decides `correct`.

Plain Python and NumPy, written from the semantics of the C++ original
(ruolin/strawberry: read.cpp's hit filters, alignments.cpp's reference-driven
clusters, pair collapse and span filter, contig.cpp's fragments and
compatibility, estimate.cpp's exon bins, bin weights and EM, isoform.h's
effective lengths). It imports nothing of the program and takes nothing the
program made: it rebuilds the seed's records with `portbench.gen` and works
out again, for every gene drawn by the seed, what each of its transcripts'
FPKM, Frac and TPM must be, then reads them in every output of the window;
and it holds every output's whole body to the first one's. A wrong answer
in a locus that is not drawn, the same in every sample, is not seen.

What it assumes of the traffic, and checks: reads of this set's model (no
multi-mapping, no unmapped mate), `-r` with an annotation, and `-i`, the
library's insert-size mean and sd (a normal insert-size pdf: with the
empirical one every locus's weights would hang on every other locus's
collapsed fragments, which only a whole second run of pass 1 could give).
The totals that couple the loci are checked as well: the mapped-fragment
count behind every FPKM is worked out over all genes; the FPKM sum behind
every TPM is the output's own (the sum of every printed FPKM), so the TPM is
compared as the program's FPKM share.

    python3 -m portbench.reference --config <file> --seed <n> --traffic <file> \
        --outputs <gtf> [<gtf> ...]

prints one JSON line: {"correct": bool, "numbers": {name: {"value", "limit"}}}.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench import gen

# the limits: see PERF.md ("correct") for the readings they were set from
LIMITS = {"missing": 0, "fpkm_gap": 4e-6, "frac_gap": 1e-6, "tpm_gap": 4e-6,
          "differ": 0}
CHECK_READS = 400_000  # genes drawn by the seed until their reads reach it,
MAX_LOCI = 800         # or this many,
N_DEEPEST = 3          # beside the deepest genes of two isoforms or more

MATCH, INTRON, GAP = 0, 1, 2
PLUS, MINUS = 1, 2
MIN_INTRON, MAX_INTRON = 20, 300_000      # -j, -J defaults
MAX_ITER, THETA_CHANGE_LIMIT = 1000, 1e-2
INV_SQRT_2PI = 0.3989422804014327
PRERUN_READS = 50_000                     # -n default: the read-length mode


# ---------------------------------------------------------------- decoding
def decode(cfg: dict, R: gen.Reads):
    """read.cpp's hit filters over every record: (kept, strand, span) with
    the span in reference bases (M, D, N)."""
    n = len(R)
    ln = (R.ops >> 4).astype(np.int64)
    op = (R.ops & 15).astype(np.int64)
    col = np.arange(gen.MAX_OPS)[None, :]
    live = col < R.n_ops[:, None]
    kept = np.ones(n, bool)
    # an insertion or deletion must be MATCH-sandwiched, not at index <= 1
    # nor last (read.cpp:592-599)
    for i in range(gen.MAX_OPS):
        indel = live[:, i] & ((op[:, i] == gen.OP_I) | (op[:, i] == gen.OP_D))
        if not indel.any():
            continue
        bad = (i - 1 <= 0) | (i + 1 >= R.n_ops)
        if i + 1 < gen.MAX_OPS:
            bad |= op[:, i + 1] != gen.OP_M
        bad |= op[:, i - 1] != gen.OP_M if i >= 1 else True
        kept &= ~(indel & bad)
    intron = live & (op == gen.OP_N)
    kept &= ~(intron & ((ln < MIN_INTRON) | (ln > MAX_INTRON))).any(axis=1)
    kept &= (np.where(live & (op == gen.OP_M), ln, 0).sum(axis=1) > 1)
    span = np.where(live & ((op == gen.OP_M) | (op == gen.OP_D)
                            | (op == gen.OP_N)), ln, 0).sum(axis=1)
    if cfg["with_xs"]:
        strand = np.where(R.xs == 1, PLUS, MINUS)
    else:
        rev = (R.flag & 0x10) != 0
        first = (R.flag & 0x40) != 0
        fwd = (rev if cfg["protocol"] == "rf" else ~rev)
        strand = np.where(first, np.where(fwd, PLUS, MINUS),
                          np.where(fwd, MINUS, PLUS))
    return kept, strand.astype(np.int8), span


def read_feats(R: gen.Reads, i: int) -> List[tuple]:
    """contig.cpp's genomic features of one read: a MATCH per M, a D
    lengthening the feature before it, an INTRON per N."""
    off = int(R.pos[i]) + 1
    out: List[list] = []
    for v in R.ops[i, :R.n_ops[i]].tolist():
        ln, op = v >> 4, v & 15
        if op == gen.OP_M:
            out.append([MATCH, off, ln])
            off += ln
        elif op == gen.OP_N:
            out.append([INTRON, off, ln])
            off += ln
        elif op == gen.OP_D:
            out[-1][2] += ln
            off += ln
    return [tuple(f) for f in out]


# ---------------------------------------------------------------- features
def fright(f) -> int:
    return f[1] + f[2] - 1


def sort_feats(feats):
    return sorted(feats, key=lambda f: (f[1], f[2]))


def merge_pair_feats(feats):
    """Overlapping mates' features merged (contig.h merge_genomicFeats):
    introns of a run must be equal, matches must overlap; [] otherwise."""
    out = []
    i, n = 0, len(feats)
    while i < n:
        code, left, ln = feats[i]
        while i < n - 1 and code == feats[i + 1][0]:
            nxt = feats[i + 1]
            if code == INTRON:
                if (code, left, ln) != nxt:
                    return []
            else:
                if left + ln - 1 < nxt[1]:
                    return []
                ln = max(left + ln - 1, fright(nxt)) - left + 1
            i += 1
        out.append((code, left, ln))
        i += 1
    return out


def contains(outer, inner) -> bool:
    return outer[1] <= inner[1] and fright(outer) >= fright(inner)


def lower_exon(exons, pos: int) -> int:
    lo, hi = 0, len(exons)
    while lo < hi:
        mid = (lo + hi) // 2
        if fright(exons[mid]) < pos:
            lo = mid + 1
        else:
            hi = mid
    return lo


def compatible(read, iso_feats, iso_exons) -> bool:
    """contig.cpp's is_compatible(read, isoform): each match inside an
    isoform exon, in order, each intron the isoform's next one."""
    it = lower_exon(iso_exons, read[0][1])
    if it == len(iso_exons) or not contains(iso_exons[it], read[0]):
        return False
    for f in read[1:]:
        if f[0] == GAP:
            continue
        if f[0] == INTRON:
            k = 2 * it + 1
            if k >= len(iso_feats) or f != iso_feats[k]:
                return False
        else:
            while it < len(iso_exons) and not contains(iso_exons[it], f):
                it += 1
            if it == len(iso_exons):
                return False
    return True


def disjoint(exons) -> List[tuple]:
    """interval.hpp's closed disjoint(): the union of the exons cut at every
    boundary, pieces covered by an exon."""
    starts = [f[1] for f in exons]
    ends = [fright(f) + 1 for f in exons]
    left, right = min(starts), max(ends)
    cov = np.zeros(right - left, np.int32)
    for s, e in zip(starts, ends):
        cov[s - left:e - left] += 1
    bars = sorted(set(starts) | set(ends))
    res, pend, i = [], None, 0
    while i < len(bars):
        b = bars[i]
        if pend is None:
            pend = b
        else:
            res.append((pend, b))
            if b - left < len(cov) and cov[b - left] > 0:
                i -= 1
            pend = None
        i += 1
    return [(MATCH, l, r - l) for l, r in res]


# ------------------------------------------------------ effective lengths
def no_gap_ef(ll: int, lr: int, li: int, fl: int) -> int:
    if fl < li + 2 or fl > ll + lr + li:
        return 0
    mid = fl - li - 1
    return min(ll, mid) + min(lr, mid) - mid


def gap_ef(ll: int, lr: int, li: int, rl: int, gap: int) -> int:
    if 2 * rl + gap < li + 2 or 2 * rl + gap > ll + lr + li:
        return 0
    start = max(rl, ll + li - gap - 1)
    end = min(ll, ll + lr + li - gap - rl)
    return max(0, end - start)


def effective_len(seg: Sequence[int], implicit: Sequence[int], fl: int,
                  rl: int) -> int:
    """isoform.h ExonBin::effective_len: the placements of a fragment of
    length fl, reads of rl bases at both ends, touching exactly the bin's
    segments."""
    gap = fl - 2 * rl
    n = len(seg)
    if n == 1:
        return seg[0] - fl + 1
    if n == 2:
        return no_gap_ef(seg[0], seg[1], 0, fl)
    if n == 3:
        if len(implicit) == 1:
            return gap_ef(seg[0], seg[2], seg[1], rl, gap)
        return (no_gap_ef(seg[0], seg[2], seg[1], fl)
                - gap_ef(seg[0], seg[2], seg[1], rl, gap))
    if n == 4:
        h14 = gap_ef(seg[0], seg[3], seg[2] + seg[1], rl, gap)
        h24 = gap_ef(seg[3], seg[1], seg[2], rl, gap)
        h124 = gap_ef(seg[0] + seg[1], seg[3], seg[2], rl, gap)
        h13 = gap_ef(seg[0], seg[2], seg[1], rl, gap)
        h134 = gap_ef(seg[0], seg[2] + seg[3], seg[1], rl, gap)
        if not implicit:
            total = no_gap_ef(seg[0], seg[3], seg[1] + seg[2], fl)
            return total - (h124 - h14 - h24) - (h134 - h14 - h13) - h14
        if len(implicit) == 2:
            return h14
        if implicit[0] == 1:
            return h134 - h14 - h13
        return h124 - h14 - h24
    target = (1 << n) - 1
    for k in implicit:
        target &= ~(1 << k)
    inner = sum(seg[1:n - 1])
    count = 0
    for i in range(1, seg[0] + 1):
        hit = 1
        last = fl - i - inner
        if last > seg[-1] or last < 0:
            continue
        if last == 0:
            break
        hit |= 1 << (n - 1)
        rest, j = rl - last, n - 2
        while rest > 0 and j > 0:
            hit |= 1 << j
            rest -= seg[j]
            j -= 1
        rest, j = rl - i, 1
        while rest > 0 and j <= n - 2:
            hit |= 1 << j
            rest -= seg[j]
            j += 1
        if hit == target:
            count += 1
    return count


def _no_gap(ll, lr, li, fl):
    mid = fl - li - 1
    v = np.minimum(ll, mid) + np.minimum(lr, mid) - mid
    return np.where((fl < li + 2) | (fl > ll + lr + li), 0, v)


def _gap(ll, lr, li, rl, gap):
    v = np.maximum(0, np.minimum(ll, ll + lr + li - gap - rl)
                   - np.maximum(rl, ll + li - gap - 1))
    return np.where((2 * rl + gap < li + 2) | (2 * rl + gap > ll + lr + li),
                    0, v)


def effective_lens(seg, implicit, fl: np.ndarray, rl: int) -> np.ndarray:
    """effective_len over an array of fragment lengths: its closed forms up
    to four segments element by element, the enumeration beyond."""
    n = len(seg)
    gap = fl - 2 * rl
    if n == 1:
        return seg[0] - fl + 1
    if n == 2:
        return _no_gap(seg[0], seg[1], 0, fl)
    if n == 3:
        if len(implicit) == 1:
            return _gap(seg[0], seg[2], seg[1], rl, gap)
        return (_no_gap(seg[0], seg[2], seg[1], fl)
                - _gap(seg[0], seg[2], seg[1], rl, gap))
    if n == 4:
        h14 = _gap(seg[0], seg[3], seg[2] + seg[1], rl, gap)
        h24 = _gap(seg[3], seg[1], seg[2], rl, gap)
        h124 = _gap(seg[0] + seg[1], seg[3], seg[2], rl, gap)
        h13 = _gap(seg[0], seg[2], seg[1], rl, gap)
        h134 = _gap(seg[0], seg[2] + seg[3], seg[1], rl, gap)
        if not implicit:
            total = _no_gap(seg[0], seg[3], seg[1] + seg[2], fl)
            return total - (h124 - h14 - h24) - (h134 - h14 - h13) - h14
        if len(implicit) == 2:
            return h14
        if implicit[0] == 1:
            return h134 - h14 - h13
        return h124 - h14 - h24
    # the enumeration over the left read's start i: the bin's segments are
    # the two ends and each inner one a read reaches into
    i = np.arange(1, seg[0] + 1)[None, :]
    last = fl[:, None] - i - sum(seg[1:n - 1])
    ok = (last >= 1) & (last <= seg[-1])
    for j in range(1, n - 1):
        reach = ((rl - i - sum(seg[1:j])) > 0) | \
            ((rl - last - sum(seg[j + 1:n - 1])) > 0)
        ok &= reach == (j not in implicit)
    return ok.sum(axis=1)


def normal_pdf(mean: float, sd: float, n: int) -> np.ndarray:
    """read.cpp's insert-size pdf of a user's mean and sd at 0..n-1, each
    value as the scalar formula gives it."""
    out = np.zeros(n)
    for x in range(n):
        a = (float(x) - mean) / sd
        p = INV_SQRT_2PI / sd * math.exp(-0.5 * a * a)
        out[x] = p if p > 0 else 0.0
    return out


def bin_under_iso(coords, iso_segs):
    """isoform.h ExonBin::bin_under_iso: the isoform's segments from the
    bin's first to its last, and which of them the bin skips."""
    starts = [f[1] for f in iso_segs]
    lo = bisect_left(starts, coords[0][0])
    up = bisect_left(starts, coords[-1][0])
    ex = [(iso_segs[i][1], fright(iso_segs[i])) for i in range(lo, up + 1)]
    idx, ci, i = [], 1, 1
    while i < len(ex) - 1:
        if ex[i][0] < coords[ci][0]:
            idx.append(i)
            i += 1
        elif ex[i][0] == coords[ci][0]:
            i += 1
            ci += 1
        else:
            raise AssertionError("a bin's segment is not the isoform's")
    return idx, [r - l + 1 for l, r in ex]


# ------------------------------------------------------------------ the EM
def em(count: np.ndarray, F: np.ndarray) -> Optional[np.ndarray]:
    """estimate.cpp's EmSolver: rows whose weights are all <= 1e-5 dropped,
    theta0 from the total of every row; F's columns renormalised after each
    M-step, a zero column keeping its last values; on convergence the
    previous theta returned."""
    niso = F.shape[1]
    keep = (F > 1e-5).any(axis=1)
    if not keep.any():
        return None
    theta0 = np.full(niso, float(count.sum()) / niso)
    u, F = count[keep], F[keep].copy()
    theta = theta0.copy()
    newF = np.zeros_like(F)
    for _ in range(MAX_ITER):
        denom = F @ theta
        if np.any(denom == 0.0):
            return theta0
        nxt = ((u[:, None] * F * theta[None, :]) / denom[:, None]).sum(axis=0)
        colsum = F.sum(axis=0)
        nz = colsum != 0.0
        newF[:, nz] = F[:, nz] / colsum[nz]
        F = newF.copy()
        d = nxt - theta
        if math.sqrt(float((d * d).sum())) < THETA_CHANGE_LIMIT:
            break
        theta = nxt
    return theta


# ------------------------------------------------------------ pair sorting
def libstdcxx_sort(a: list, less) -> None:
    """std::sort of libstdc++ (introsort, median of three, insertion sort
    below 16 elements), in place. The original collapses duplicate pairs
    after this unstable sort, so the order of equal keys is part of the
    result."""
    def iter_swap(i, j):
        a[i], a[j] = a[j], a[i]

    def median_to_first(res, x, y, z):
        if less(a[x], a[y]):
            if less(a[y], a[z]):
                iter_swap(res, y)
            elif less(a[x], a[z]):
                iter_swap(res, z)
            else:
                iter_swap(res, x)
        elif less(a[x], a[z]):
            iter_swap(res, x)
        elif less(a[y], a[z]):
            iter_swap(res, z)
        else:
            iter_swap(res, y)

    def partition(first, last, pivot):
        while True:
            while less(a[first], a[pivot]):
                first += 1
            last -= 1
            while less(a[pivot], a[last]):
                last -= 1
            if not first < last:
                return first
            iter_swap(first, last)
            first += 1

    def adjust_heap(first, hole, length, value):
        top = hole
        child = hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if less(a[first + child], a[first + child - 1]):
                child -= 1
            a[first + hole] = a[first + child]
            hole = child
        if (length & 1) == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            a[first + hole] = a[first + child - 1]
            hole = child - 1
        parent = (hole - 1) // 2
        while hole > top and less(a[first + parent], value):
            a[first + hole] = a[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = value

    def heap_sort(first, last):
        length = last - first
        if length >= 2:                       # make_heap
            parent = (length - 2) // 2
            while True:
                adjust_heap(first, parent, length, a[first + parent])
                if parent == 0:
                    break
                parent -= 1
        while last - first > 1:               # sort_heap
            last -= 1
            value = a[last]
            a[last] = a[first]
            adjust_heap(first, 0, last - first, value)

    def loop(first, last, depth):
        while last - first > 16:
            if depth == 0:
                heap_sort(first, last)
                return
            depth -= 1
            mid = first + (last - first) // 2
            median_to_first(first, first + 1, mid, last - 1)
            cut = partition(first + 1, last, first)
            loop(cut, last, depth)
            last = cut

    def linear_insert(last):
        val = a[last]
        nxt = last - 1
        while less(val, a[nxt]):
            a[last] = a[nxt]
            last = nxt
            nxt -= 1
        a[last] = val

    def insertion_sort(first, last):
        for i in range(first + 1, last):
            if less(a[i], a[first]):
                val = a[i]
                a[first + 1:i + 1] = a[first:i]
                a[first] = val
            else:
                linear_insert(i)

    n = len(a)
    if n < 2:
        return
    loop(0, n, 2 * (n.bit_length() - 1))
    if n > 16:
        insertion_sort(0, 16)
        for i in range(16, n):
            linear_insert(i)
    else:
        insertion_sort(0, n)


def phi(x: float) -> float:
    """common.h's normal cdf (Abramowitz and Stegun 7.1.26)."""
    if math.isnan(x):
        return math.nan
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    sign = -1 if x < 0 else 1
    x = abs(x) / math.sqrt(2.0)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * math.exp(-x * x)
    return 0.5 * (1.0 + sign * y)


def span_cut(spans: Sequence[int]) -> Tuple[float, float]:
    """getMeanAndSd over a cluster's read spans, in the order the reads
    came; the sd times five."""
    n = len(spans)
    if not n:
        return 0.0, 0.0
    acc = 0.0
    for v in spans:
        acc += v
    mean = acc / n
    sq = 0.0
    for v in spans:
        d = v - mean
        sq += d * d
    return mean, 5.0 * math.sqrt(sq / n)


def outlier(ln: float, mean: float, sd5: float) -> bool:
    with np.errstate(divide="ignore", invalid="ignore"):
        x = float(np.float64(ln - mean) / np.float64(sd5))
    return phi(x) > 0.999


# ------------------------------------------------------------------- genes
class Genes:
    """The annotation's genes: their span, strand and transcripts."""

    def __init__(self, ann: gen.Annotation):
        gid = ann.gene_ids
        first = [t for t in range(ann.n_tx) if t == 0 or gid[t] != gid[t - 1]]
        self.tx = [list(range(a, b)) for a, b in
                   zip(first, first[1:] + [ann.n_tx])]
        starts = ann.ex_start[ann.ex_off[:-1]]
        ends = ann.ex_end[ann.ex_off[1:] - 1]
        self.chrom = np.array([ann.tx_chrom[t[0]] for t in self.tx])
        self.strand = np.array([PLUS if ann.tx_strand[t[0]] > 0 else MINUS
                                for t in self.tx])
        self.left = np.array([starts[t].min() for t in self.tx])
        self.right = np.array([ends[t].max() for t in self.tx])

    def of_reads(self, chrom, left, right) -> np.ndarray:
        """Each read's gene; every read must lie inside one."""
        key_g = self.chrom.astype(np.int64) * (1 << 40) + self.left
        key_r = chrom.astype(np.int64) * (1 << 40) + left
        g = np.searchsorted(key_g, key_r, "right") - 1
        if np.any(g < 0) or np.any(self.chrom[g] != chrom) or \
                np.any(right > self.right[g]):
            raise AssertionError("a read lies outside every gene")
        return g


def iso_model(ann: gen.Annotation, t: int):
    a, b = ann.ex_off[t], ann.ex_off[t + 1]
    exons = [(MATCH, int(ann.ex_start[e]), int(ann.ex_end[e] - ann.ex_start[e]
                                               + 1)) for e in range(a, b)]
    feats = []
    for k, e in enumerate(exons):
        if k:
            prev = exons[k - 1]
            feats.append((INTRON, fright(prev) + 1, e[1] - fright(prev) - 1))
        feats.append(e)
    return feats, exons


# ------------------------------------------------------- one locus's answer
def quantify_locus(R, idx, kept, span, ann, txs, read_len, pdf):
    """The theta of each transcript of one gene (None where the original
    writes nothing for it), from the gene's reads `idx` in file order."""
    # alignments.cpp addOpenHit: pairs complete at their second mate
    spans, hits, open_ = [], [], {}
    for i in idx.tolist():
        if not kept[i]:
            continue
        left = int(R.pos[i]) + 1
        spans.append(int(span[i]))
        fid = int(R.frag[i])
        partner = int(R.next_pos[i]) + 1
        if fid in open_:
            j = open_.pop(fid)
            hits.append((j, i))
        elif partner > left:
            open_[fid] = i
        elif partner < left:
            open_[fid] = None          # a right mate whose left never came
    hits = [h for h in hits if h[0] is not None]
    if not hits:
        return None

    def lpos(h):
        return int(R.pos[h[0]]) + 1

    def rpos(h):
        return max(int(R.pos[k]) + int(span[k]) for k in h)

    keyed = [(lpos(h), rpos(h), h) for h in hits]
    libstdcxx_sort(keyed, lambda x, y: (x[0], x[1]) < (y[0], y[1]))
    mean, sd5 = span_cut(spans)
    uniq: List[list] = []
    for _, _, h in keyed:
        if any(outlier(float(span[k]), mean, sd5) for k in h):
            continue
        if uniq and all(R.pos[a] == R.pos[b] and R.n_ops[a] == R.n_ops[b]
                        and np.array_equal(R.ops[a], R.ops[b])
                        for a, b in zip(uniq[-1][0], h)):
            uniq[-1][1] += 1.0
        else:
            uniq.append([h, 1.0])

    # contig.cpp Contig(PairedHit): the fragment's features
    frags = []
    for (a, b), mass in uniq:
        g = read_feats(R, a) + read_feats(R, b)
        gap = int(R.pos[b]) + 1 - (int(R.pos[a]) + int(span[a])) - 1
        if gap > 0:
            g = sort_feats(g + [(GAP, int(R.pos[a]) + int(span[a]) + 1,
                                   gap)])
        else:
            g = merge_pair_feats(sort_feats(g))
        if g:
            frags.append((sort_feats(g), mass))

    # estimate.cpp LocusContext: segments, bins, weights
    models = [iso_model(ann, t) for t in txs]
    segs = disjoint(sort_feats({e for _, ex in models for e in ex}))
    iso_segs = []
    for feats, exons in models:
        mine = []
        for s in segs:
            it = lower_exon(exons, s[1])
            if it < len(exons) and contains(exons[it], s):
                mine.append(s)
        iso_segs.append(mine)
    seg_lr = [(s[1], fright(s)) for s in segs]
    bins: Dict[tuple, int] = {}
    bin_keys: List[dict] = []
    iso_bins: Dict[int, List[int]] = {}
    for feats, mass in frags:
        coords = None
        key = tuple((f[1], f[2]) for f in feats)
        left, right = feats[0][1], fright(feats[-1])
        for j, (ifeats, iexons) in enumerate(models):
            if not compatible(feats, ifeats, iexons):
                continue
            if coords is None:
                coords = tuple(sorted({
                    lr for s, lr in zip(segs, seg_lr)
                    if any(f[0] == MATCH and f[1] <= lr[1] and s[1] <= fright(f)
                           for f in feats)}))
            if not coords:
                break
            b = bins.setdefault(coords, len(bins))
            if b == len(bin_keys):
                bin_keys.append({})
            bin_keys[b].setdefault(key, mass)
            if b not in iso_bins.setdefault(j, []):
                iso_bins[j].append(b)
    if not bins:
        return None
    coords_of = {b: c for c, b in bins.items()}
    lens = [sum(f[2] for f in ex) for _, ex in models]
    F = np.zeros((len(bins), len(txs)))
    for j in sorted(iso_bins):
        for b in sorted(iso_bins[j]):
            implicit, seg = bin_under_iso(coords_of[b], iso_segs[j])
            lmax = sum(seg)
            lmin = read_len
            if len(seg) > 2:
                lmin = max(lmin, sum(seg[1:-1]))
            if lmax < lmin:
                continue
            # estimate.cpp set_theory_bin_weight: the sum over fragment
            # lengths, term by term in order (cumsum adds left to right)
            fl = np.arange(lmin, lmax + 1)
            terms = pdf[lmin:lmax + 1] * effective_lens(
                seg, implicit, fl, read_len) / (lens[j] - fl + 1)
            F[b, j] = float(np.cumsum(terms)[-1])
    count = np.array([float(int(sum(k.values()))) for k in bin_keys])
    theta = em(count, F)
    if theta is None:
        return None
    return theta, lens


# ------------------------------------------------------------- the outputs
def read_output(path: str):
    """transcript_id -> (FPKM, Frac, TPM) as printed, and the FPKM sum."""
    vals = {}
    total = 0.0
    with open(path) as f:
        for line in f:
            if "\ttranscript\t" not in line:
                continue
            attrs = line.rsplit("\t", 1)[-1]
            tid = attrs.split('transcript_id "', 1)[1].split('"', 1)[0]
            fpkm = attrs.split('FPKM "', 1)[1].split('"', 1)[0]
            frac = attrs.split('Frac "', 1)[1].split('"', 1)[0]
            tpm = attrs.split('TPM "', 1)[1].split('"', 1)[0]
            vals[tid] = (float(fpkm), float(frac), float(tpm))
            total += float(fpkm)
    return vals, total


def gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| over max(|ref|, floor); a NaN on one side only is
    infinitely far."""
    if math.isnan(prog) or math.isnan(ref):
        return 0.0 if math.isnan(prog) and math.isnan(ref) else math.inf
    return abs(prog - ref) / max(abs(ref), floor)


def expected(cfg: dict, traffic: dict, seed: int):
    """The drawn genes' answers: [(tx_ids, fpkm, frac)] and the loci."""
    if "-r" not in traffic["mode_flags"] or not traffic.get("insert_size_flag"):
        raise SystemExit("portbench.reference: the traffic is not -r with -i")
    ann = gen.make_annotation(cfg, seed)
    R = gen.sample_reads(cfg, seed, ann)
    kept, strand, span = decode(cfg, R)
    genes = Genes(ann)
    g_of = genes.of_reads(R.chrom, R.pos + 1, R.pos + span)
    if np.any(kept & (strand != genes.strand[g_of])):
        raise AssertionError("a read's strand is not its gene's")
    # the read-length mode of the first accepted reads (read.hpp:150-160)
    first = np.nonzero(kept)[0][:PRERUN_READS]
    vals, cnts = np.unique(R.qlen[first], return_counts=True)
    order = np.argsort(np.unique(R.qlen[first], return_index=True)[1])
    read_len = int(vals[order][np.argmax(cnts[order])])

    # every gene's weighted mass: its pairs outside the span cut
    total_mapped = 0
    bounds = np.searchsorted(g_of, np.arange(len(genes.tx) + 1))
    per_gene = []
    for g in range(len(genes.tx)):
        idx = np.arange(bounds[g], bounds[g + 1])
        k = idx[kept[idx]]
        per_gene.append(idx)
        if len(k) == 0:
            continue
        sp = span[k].astype(np.float64)
        mean, sd5 = span_cut(sp.tolist())
        with np.errstate(divide="ignore", invalid="ignore"):
            x = (sp - mean) / sd5
        far = np.zeros(len(k), bool)      # phi(3) < 0.999: only x > 3 can be
        for q in np.nonzero(~(x <= 3.0))[0].tolist():
            far[q] = phi(float(x[q])) > 0.999
        fr = R.frag[k]
        uf, c = np.unique(fr, return_counts=True)
        bad = np.unique(fr[far])
        total_mapped += int(np.sum(c == 2) - np.isin(uf[c == 2], bad).sum())
    n_frag = np.diff(bounds)
    rng = np.random.default_rng([int(seed), 99])
    multi = [g for g in range(len(genes.tx)) if len(genes.tx[g]) > 1]
    drawn = sorted(multi, key=lambda g: -n_frag[g])[:N_DEEPEST]
    budget = CHECK_READS
    for g in rng.permutation(len(genes.tx)).tolist():
        if budget <= 0 or len(drawn) >= MAX_LOCI + N_DEEPEST:
            break
        if g not in drawn[:N_DEEPEST]:
            drawn.append(g)
            budget -= n_frag[g]
    print(f"portbench.reference: {len(drawn)} of {len(genes.tx)} genes "
          f"drawn, {sum(len(genes.tx[g]) for g in drawn)} transcripts, "
          f"{int(sum(n_frag[g] for g in drawn))} of {len(g_of)} reads",
          file=sys.stderr)
    pdf = normal_pdf(float(cfg["frag_mean"]), float(cfg["frag_sd"]),
                     int(ann.tx_len().max()) + 1)
    loci = []
    for g in drawn:
        txs = genes.tx[g]
        got = quantify_locus(R, per_gene[g], kept, span, ann, txs, read_len,
                             pdf)
        ids = [ann.tx_ids[t] for t in txs]
        if got is None:
            loci.append((ids, None, None))
            continue
        theta, lens = got
        rpm = 1e6 / total_mapped
        fpkm = [theta[j] * rpm * (1e3 / lens[j]) for j in range(len(txs))]
        s = 0.0
        for v in fpkm:
            s += v
        frac = [v / s if s != 0 else math.nan for v in fpkm]
        loci.append((ids, fpkm, frac))
    return loci


def body(path: str) -> bytes:
    """An output's GTF lines, its '#' header (which names its own paths)
    left out."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"#"))


def judge(loci, outputs: List[str]) -> dict:
    """The drawn genes' answers read in every output; and every output's
    whole body against the first's (`differ`, the outputs that are not the
    same bytes): the window runs one sample again and again, so a fault in
    any locus that one run of it shows and another does not is caught."""
    worst = {k: 0.0 for k in LIMITS}
    first = body(outputs[0]) if outputs else None
    worst["differ"] = float(sum(body(p) != first for p in outputs[1:]))
    for path in outputs:
        vals, total = read_output(path)
        for ids, fpkm, frac in loci:
            for j, tid in enumerate(ids):
                have = vals.get(tid)
                if fpkm is None or have is None:
                    worst["missing"] += (fpkm is None) != (have is None)
                    continue
                worst["fpkm_gap"] = max(worst["fpkm_gap"],
                                        gap(have[0], fpkm[j], 1.0))
                worst["frac_gap"] = max(worst["frac_gap"],
                                        gap(have[1], frac[j], 1.0))
                worst["tpm_gap"] = max(worst["tpm_gap"], gap(
                    have[2], 1e6 * fpkm[j] / total, 1.0))
    if not outputs:
        worst["missing"] = math.inf
    numbers = {k: {"value": v, "limit": LIMITS[k]} for k, v in worst.items()}
    return {"correct": all(v <= LIMITS[k] for k, v in worst.items()),
            "numbers": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--outputs", nargs="*", default=[])
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    with open(args.traffic) as f:
        traffic = json.load(f)
    loci = expected(cfg, traffic, args.seed)
    print(json.dumps(judge(loci, args.outputs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
