"""Fragment-context TSV exporter (-f flag).

Mirrors Sample::printContext + LocusContext::get_frag_info
(ref: src/alignments.cpp:1549-1639,1746-1752, include/estimate.hpp:173-197).
Feeds downstream differential-expression tooling.
"""
from __future__ import annotations

from typing import Dict, List, TextIO, Tuple

from ..core.features import Contig, is_compatible
from .bins import Coords, overlap_exons
from .locus import LocusContext

FRAG_HEADER = [
    "sample", "sample_frag_count", "gene_id", "gene_frag_count",
    "transcripts", "FPKMs", "conditional_probabilities",
    "class_probabilities", "path_symbol", "path_count",
    "path_gc_content", "path_hexmer_entropy", "gc_stretch_0.8_20",
    "gc_stretch_0.9_20", "gc_stretch_0.8_40", "gc_stretch_0.9_40",
]


def _prec12(v: float) -> str:
    """to_string_with_precision(v, 12) (common.h:366-372)."""
    return f"{v:.12g}"


def get_frag_info(est: LocusContext, frag: Contig
                  ) -> Tuple[Coords, List[float]]:
    coords: Coords = ()
    info: List[float] = []
    for iso in est.transcripts:
        if is_compatible(frag, iso.contig):
            c = overlap_exons(est.exon_segs, frag)
            if not coords:
                coords = c
            search = est._bin_index.get(coords)
            assert search is not None
            info.append(est.exon_bins[search].bin_weight_map[iso.id])
        else:
            info.append(0.0)
    return coords, info


def print_context(sample, est: LocusContext, cluster, fragfile: TextIO,
                  fa_getter=None, bias_correction: bool = False):
    eb_count: Dict[Coords, int] = {}
    eb_prob: Dict[Coords, List[float]] = {}
    for ph in cluster.uniq_hits:
        hit = cluster.pair_to_contig(ph)
        if hit is None:
            continue
        coords, info = get_frag_info(est, hit)
        if coords:
            eb_count[coords] = eb_count.get(coords, 0) + 1
            eb_prob[coords] = info

    total = sum(eb_count.values())
    gene_name = est.transcripts[0].gene_str if est.transcripts else ""
    iso_names = ",".join(t.isoform_str for t in est.transcripts)
    fpkms = ",".join(t.fpkm_s for t in est.transcripts)
    class_prop = ",".join(t.frac_s for t in est.transcripts)

    for coords in sorted(eb_prob.keys()):
        info = [sample.sample_name, str(sample.total_mapped_reads),
                gene_name, str(total), iso_names, fpkms,
                ",".join(_prec12(p) for p in eb_prob[coords]),
                class_prop,
                "".join(f"[{l}-{r}]" for (l, r) in coords),
                str(eb_count[coords])]
        if bias_correction and fa_getter is not None:
            from ..utils.kmer import (entropy, gc_ratio, high_gc_stretch)
            seq = "".join(fa_getter.fetch(l, r - l + 1) for (l, r) in coords)
            info += [f"{gc_ratio(seq):.6f}", f"{entropy(seq, 6):.6f}",
                     str(int(high_gc_stretch(seq, 20, 0.8))),
                     str(int(high_gc_stretch(seq, 20, 0.9))),
                     str(int(high_gc_stretch(seq, 40, 0.8))),
                     str(int(high_gc_stretch(seq, 40, 0.9)))]
        fragfile.write("\t".join(info) + "\n")
