"""GTF output writer, matching Contig::print2gtf byte-for-byte
(ref: src/contig.cpp:636-721): transcript + exon rows, score 1000, frame '.',
FPKM/Frac/TPM attribute values truncated to 11 characters (the reference
copies them through a char[12] buffer).
"""
from __future__ import annotations

from typing import List, Optional, TextIO

from ..core.features import Contig, S_MATCH, STRAND_MINUS, STRAND_PLUS


def _strand_char(strand: int) -> str:
    if strand == STRAND_PLUS:
        return "+"
    if strand == STRAND_MINUS:
        return "-"
    return "."


def print2gtf(fh: TextIO, contig: Contig, ref_name: str, fpkm: str,
              frac: str, tpm: str, gene_id: str, tscp_id: str,
              ref_gene_id: str, ref_gene_name: str) -> None:
    attr = f'gene_id "{gene_id}";transcript_id "{tscp_id}";'
    if ref_gene_id:
        attr += f'ref_gene_id "{ref_gene_id}";'
    if ref_gene_name:
        attr += f'ref_gene_name "{ref_gene_name}";'
    if fpkm:
        attr += f'FPKM "{fpkm[:11]}";'
    if frac:
        attr += f'Frac "{frac[:11]}";'
    if tpm:
        attr += f'TPM "{tpm[:11]}";'
    strand = _strand_char(contig.strand)
    rows = [f"{ref_name}\tStrawberry\ttranscript\t{contig.left}\t"
            f"{contig.right}\t1000\t{strand}\t.\t{attr}\n"]
    exon_num = 0
    for f in contig.feats:
        if f[0] == S_MATCH:
            exon_num += 1
            rows.append(f"{ref_name}\tStrawberry\texon\t{f[1]}\t"
                        f"{f[1] + f[2] - 1}\t1000\t{strand}\t.\t{attr} "
                        f'exon_id "{exon_num}";\n')
    fh.write("".join(rows))
