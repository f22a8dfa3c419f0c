"""Per-locus quantification context: bins -> weights -> EM -> FPKM.

Host oracle for LocusContext + estimate_abundances (ref:
include/estimate.hpp:61-224, src/estimate.cpp:135-364).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..core.features import (Contig, Feature, S_MATCH, exonic_overlaps_len,
                             is_compatible, is_compatible_feat)
from ..core.insert_size import InsertSize
from .bins import (Coords, ExonBin, bin_under_iso, disjoint_exon_segs,
                   effective_len, overlap_exons)
from .em import em_init, em_run


@dataclass(slots=True)
class Isoform:
    contig: Contig
    length: int
    gene_str: str
    isoform_str: str
    ref_gene_id: str
    ref_gene_name: str
    exon_segs: List[Feature] = field(default_factory=list)
    frac: float = 0.0
    fpkm: float = 0.0
    tpm: float = 0.0
    frac_s: str = "nan"
    fpkm_s: str = "nan"
    tpm_s: str = "nan"
    id: int = -1


def c_str(x: float) -> str:
    """std::to_string(double): 6 fixed decimals."""
    return f"{x:.6f}"


class LocusContext:
    def __init__(self, cfg: Config, read_len: int,
                 insert_dist: Optional[InsertSize],
                 hits: List[Contig], transcripts: List[Contig],
                 long_read_sample: bool = False, hit_flat=None):
        assert transcripts
        self.cfg = cfg
        self.read_len = read_len
        self.insert_dist = insert_dist
        self._hit_flat = hit_flat

        # disjoint exon segments from all transcript exons
        exons: List[Feature] = []
        for t in transcripts:
            for f in t.feats:
                if f[0] == S_MATCH:
                    exons.append(f)
        exons = sorted(set(exons), key=lambda f: (f[1], f[2]))
        self.exon_segs: List[Feature] = disjoint_exon_segs(exons)

        self.transcripts: List[Isoform] = []
        for t in transcripts:
            iso_segs = [s for s in self.exon_segs
                        if is_compatible_feat(t, s)]
            iso = Isoform(contig=t, length=t.exonic_length(),
                          gene_str=t.parent_id, isoform_str=t.trans_id,
                          ref_gene_id=t.ref_gene_id,
                          ref_gene_name=t.ref_gene_name,
                          exon_segs=iso_segs)
            iso.id = len(self.transcripts)
            self.transcripts.append(iso)

        self.exon_bins: List[ExonBin] = []
        self._bin_index: Dict[Coords, int] = {}
        self.iso_2_bins_map: Dict[int, List[int]] = {}

        self._assign_exon_bin(hits)
        if long_read_sample:
            self._set_bin_weight_without_frag_dist()
        else:
            self._set_theory_bin_weight()

    # ------------------------------------------------------------------
    def _set_maps(self, iso_id: int, fg_len: int, mass: float,
                  read: Contig, coords: Coords, frag_key=None):
        if not coords:
            return
        ebid = self._bin_index.get(coords)
        if ebid is None:
            ebid = len(self.exon_bins)
            eb = ExonBin(coords)
            eb.id = ebid
            self.exon_bins.append(eb)
            self._bin_index[coords] = ebid
        eb = self.exon_bins[ebid]
        eb.add_frag(read, key=frag_key)
        eb.add_frag_len(iso_id, fg_len, mass)
        bins = self.iso_2_bins_map.setdefault(iso_id, [])
        if ebid not in bins:
            bins.append(ebid)

    def _assign_exon_bin(self, hits: List[Contig]):
        """assign_exon_bin (estimate.cpp:135-198)."""
        native = None
        if hits and getattr(self.cfg, "native_cluster", True):
            try:
                from ..core.fastcluster import native_compat
                native = native_compat(hits, [t.contig for t in
                                              self.transcripts],
                                       self.exon_segs,
                                       hit_flat=self._hit_flat)
            except OSError:
                native = None
        if native is not None:
            compat_m, fraglen_m, seghit = native
            seg_coords = [(f[1], f[1] + f[2] - 1) for f in self.exon_segs]
            any_row = compat_m.any(axis=1)
            for h_i in np.nonzero(any_row)[0]:
                mp = hits[h_i]
                coords = tuple(seg_coords[j]
                               for j in np.nonzero(seghit[h_i])[0])
                fkey = (mp.ref_id, tuple((f[1], f[2]) for f in mp.feats))
                row = compat_m[h_i]
                for iso_j in np.nonzero(row)[0]:
                    self._set_maps(int(iso_j), int(fraglen_m[h_i, iso_j]),
                                   mp.mass, mp, coords, frag_key=fkey)
            return
        for mp in hits:
            for iso in self.transcripts:
                if is_compatible(mp, iso.contig):
                    coords = overlap_exons(self.exon_segs, mp)
                    frag_len = exonic_overlaps_len(iso.contig, mp.left,
                                                   mp.right)
                    self._set_maps(iso.id, frag_len, mp.mass, mp, coords)

    # ------------------------------------------------------------------
    def _set_theory_bin_weight(self, vectorized: bool = True):
        """set_theory_bin_weight (estimate.cpp:201-234).

        The vectorized fast path computes identical float64 bits (integer
        effective lengths + libm pdf table + strict-order native sums); the
        scalar path is the literal oracle used by tests."""
        if vectorized:
            return self._set_theory_bin_weight_vec()
        dist = self.insert_dist
        for iso_id in sorted(self.iso_2_bins_map.keys()):
            iso = self.transcripts[iso_id]
            iso_seg_feats = iso.exon_segs
            for bin_idx in sorted(self.iso_2_bins_map[iso_id]):
                eb = self.exon_bins[bin_idx]
                implicit_idx, exon_coords = bin_under_iso(eb.coords,
                                                          iso_seg_feats)
                seg_lens = [c[1] - c[0] + 1 for c in exon_coords]
                lmax = sum(seg_lens)
                if dist.use_emp:
                    lmin = dist.start_offset
                else:
                    lmin = self.read_len
                if len(seg_lens) > 2:
                    lmin = max(lmin, sum(seg_lens[1:-1]))
                weight = 0.0
                for fl in range(lmin, lmax + 1):
                    le_eff = effective_len(seg_lens, implicit_idx, fl,
                                           self.read_len)
                    weight += (dist.emp_dist_pdf(fl) * le_eff
                               / (iso.length - fl + 1))
                eb.bin_weight_map[iso_id] = weight

    def _set_theory_bin_weight_vec(self):
        from .binweights import (batched_effective_terms, pdf_table,
                                 seqsum_batch)
        dist = self.insert_dist
        tbl = getattr(dist, "_pdf_table", None)
        max_len = max((iso.length for iso in self.transcripts), default=0)
        if tbl is None or len(tbl) <= max_len:
            tbl = pdf_table(dist, max(max_len, 4096))
            dist._pdf_table = tbl

        pairs = []
        specs = []
        base_lmin = dist.start_offset if dist.use_emp else self.read_len
        for iso_id in sorted(self.iso_2_bins_map.keys()):
            iso = self.transcripts[iso_id]
            for bin_idx in sorted(self.iso_2_bins_map[iso_id]):
                eb = self.exon_bins[bin_idx]
                implicit_idx, exon_coords = bin_under_iso(eb.coords,
                                                          iso.exon_segs)
                seg_lens = [c[1] - c[0] + 1 for c in exon_coords]
                lmax = sum(seg_lens)
                lmin = base_lmin
                if len(seg_lens) > 2:
                    lmin = max(lmin, sum(seg_lens[1:-1]))
                pairs.append((iso_id, bin_idx))
                specs.append((seg_lens, implicit_idx, lmin, lmax,
                              iso.length))
        if not pairs:
            return
        terms, offsets = batched_effective_terms(specs, self.read_len, tbl)
        sums = seqsum_batch(terms, offsets)
        for (iso_id, bin_idx), w in zip(pairs, sums):
            self.exon_bins[bin_idx].bin_weight_map[iso_id] = float(w)

    def _set_bin_weight_without_frag_dist(self):
        """Long-read path: weight = 1/L (estimate.cpp:236-247)."""
        for iso_id in sorted(self.iso_2_bins_map.keys()):
            for bin_idx in sorted(self.iso_2_bins_map[iso_id]):
                self.exon_bins[bin_idx].bin_weight_map[iso_id] = \
                    1.0 / self.transcripts[iso_id].length

    # ------------------------------------------------------------------
    def build_problem(self) -> Tuple[np.ndarray, np.ndarray]:
        """Extract the EM inputs: truncated bin counts (vector<int> n,
        estimate.cpp:284-288) and the raw weight matrix."""
        pre = getattr(self, "_prebuilt", None)
        if pre is not None:          # whole-pass native path (quantprep.cc)
            return pre
        nrow = len(self.exon_bins)
        niso = len(self.transcripts)
        n = np.array([int(eb.read_count()) for eb in self.exon_bins],
                     dtype=np.float64)
        alpha = np.zeros((nrow, niso), dtype=np.float64)
        for i, eb in enumerate(self.exon_bins):
            for j in range(niso):
                alpha[i, j] = eb.bin_weight_map.get(j, 0.0)
        return n, alpha

    def estimate_abundances(self, total_mapped_reads: int,
                            log=None) -> bool:
        """estimate_abundances (estimate.cpp:279-364)."""
        n, alpha = self.build_problem()
        init = em_init(len(self.transcripts), n, alpha)
        if init is None:
            return False
        theta = em_run(*init)
        if theta is None:
            # reference: run() returning false still counts as success for
            # output purposes only when init succeeded — em.run's false path
            # (zero denominator) leaves _theta at theta0; replicate
            theta = init[2]
        return self.finalize_abundances(theta, total_mapped_reads, log)

    def finalize_abundances(self, theta, total_mapped_reads: int,
                            log=None) -> bool:
        """FPKM / frac / low-expression filter given solved theta."""
        cfg = self.cfg
        niso = len(self.transcripts)
        if log is not None and not getattr(log, "is_null", False):
            for i in range(niso):
                log.write(f"isoform {i+1} has {theta[i]:f} raw read count.\n")
        sum_fpkm = 0.0
        for i, iso in enumerate(self.transcripts):
            if cfg.effective_len_norm:
                kb = iso.length - self.insert_dist.mean
                if kb < 0:
                    iso.fpkm_s = "NA"
                    continue
                kb = 1e3 / kb
            else:
                kb = 1e3 / iso.length
            rpm = 1e6 / total_mapped_reads
            fpkm = theta[i] * rpm * kb
            iso.fpkm = fpkm
            sum_fpkm += fpkm
            iso.fpkm_s = c_str(fpkm)
        for iso in self.transcripts:
            if iso.fpkm_s == "NA":
                iso.frac_s = "NA"
                continue
            frac = iso.fpkm / sum_fpkm if sum_fpkm != 0 else float("nan")
            iso.frac = frac
            iso.frac_s = c_str(frac)
        if cfg.filter_by_expression:
            self.transcripts = [
                iso for iso in self.transcripts
                if not (iso.frac < cfg.min_isoform_frac)
            ]
        return True
