"""Empirical insert-size (fragment-length) distribution.

Mirrors InsertSize (ref: include/read.hpp:176-192, src/read.cpp:228-297):
truncated empirical pdf over [min,max] observed fragment lengths with a
normal-pdf fallback wherever the empirical mass is zero.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

INV_SQRT_2PI = 0.3989422804014327


class NotEnoughReads(Exception):
    """InsertSize(vector<int>) with no observations: the reference prints
    "Not enough reads" and exit(0)s (read.cpp:241-245)."""


def normal_pdf(x: float, m: float, s: float) -> float:
    a = (x - m) / s
    return INV_SQRT_2PI / s * math.exp(-0.5 * a * a)


class InsertSize:
    def __init__(self, mean: float = 0.0, sd: float = 0.0,
                 frag_lens: Optional[Sequence[int]] = None,
                 verbose: bool = False):
        if frag_lens is not None:
            self.use_emp = True
            self.total_reads = len(frag_lens)
            if self.total_reads < 1:
                raise NotEnoughReads()
            # integer sums, vectorized — bit-identical to the scalar loops
            import numpy as np
            fl = np.asarray(frag_lens, dtype=np.int64)
            s = float(int(fl.sum()))
            self.mean = s / len(frag_lens)
            sq = float(int((fl * fl).sum()))
            self.sd = math.sqrt(sq / len(frag_lens) - self.mean * self.mean)
            self.start_offset = int(fl.min())
            self.end_offset = int(fl.max())
            if verbose:
                # read.cpp:248-253 cerr diagnostics (C++ default %.6g)
                import sys
                sys.stderr.write(
                    "Calculated averaged fragment length is: "
                    f"{self.mean:.6g}\n"
                    f"Calculated fragment length sd is: {self.sd:.6g}\n"
                    f"Min fragment length is: {self.start_offset}\n"
                    f"Max fragment length is: {self.end_offset}\n")
            counts = np.bincount(fl - self.start_offset,
                                 minlength=self.end_offset
                                 - self.start_offset + 1)
            self.emp_dist = [float(c) for c in counts.tolist()]
        else:
            self.use_emp = False
            self.total_reads = 0
            self.mean = mean
            self.sd = sd
            self.start_offset = 0
            self.end_offset = 0
            self.emp_dist: List[float] = []

    def emp_dist_pdf(self, insert_size: int) -> float:
        """read.cpp:274-297."""
        if self.use_emp:
            ret = 0.0
            if self.start_offset <= insert_size <= self.end_offset:
                ret = self.emp_dist[insert_size - self.start_offset] \
                    / self.total_reads
            if ret == 0.0:
                p = normal_pdf(float(insert_size), self.mean, self.sd)
                return p if p > 0 else 0.0
            return ret
        p = normal_pdf(float(insert_size), self.mean, self.sd)
        return p if p > 0 else 0.0
