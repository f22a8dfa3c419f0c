"""K-mer / GC sequence features (ref: include/kmer.h)."""
from __future__ import annotations

import math
from collections import Counter

_DNA = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}
_GC = {"C", "c", "G", "g"}


def sorted_kmers(seq: str, k: int):
    assert 0 < k < 32 and len(seq) > k
    kmers = []
    cur = 0
    for i, ch in enumerate(seq[:k]):
        cur = (cur << 2) | _DNA.get(ch, 0)
    kmers.append(cur)
    mask = (1 << (2 * k)) - 1
    for ch in seq[k:]:
        cur = ((cur << 2) | _DNA.get(ch, 0)) & mask
        kmers.append(cur)
    kmers.sort()
    return kmers


def entropy(seq: str, k: int) -> float:
    """K-mer Shannon entropy (kmer.h:46-64)."""
    km = sorted_kmers(seq, k)
    total = len(km)
    counts = Counter(km)
    return -sum((c / total) * math.log(c / total) for c in counts.values())


def gc_ratio(seq) -> float:
    assert len(seq)
    return sum(1 for c in seq if c in _GC) / len(seq)


def high_gc_stretch(seq: str, w: int, cutoff: float) -> bool:
    """Sliding-window high-GC detector (kmer.h:78-88)."""
    assert cutoff <= 1.0 and w < len(seq)
    for i in range(len(seq) - w + 1):
        if gc_ratio(seq[i:i + w]) > cutoff:
            return True
    return False
