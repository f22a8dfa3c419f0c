"""Synthetic RNA-seq data simulator.

Generates genomes, gene models (GTF), and position-sorted BAMs of simulated
paired/single-end reads. Used by the test-suite to produce inputs for both
this framework and the reference binary (the reference's toy BAM is not
shipped), and by bench.py to generate load at scale.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .io.bamwriter import BamRecord, BamWriter


@dataclass
class SimTranscript:
    chrom: str
    gene_id: str
    tx_id: str
    strand: str                      # '+', '-'
    exons: List[Tuple[int, int]]     # 1-based inclusive, ascending

    @property
    def length(self) -> int:
        return sum(r - l + 1 for l, r in self.exons)

    def tx2genome(self, tpos: int) -> int:
        """0-based transcript offset -> 1-based genome coordinate."""
        off = tpos
        for l, r in self.exons:
            ln = r - l + 1
            if off < ln:
                return l + off
            off -= ln
        raise ValueError("tpos out of range")

    def cigar_for(self, tstart: int, length: int) -> Tuple[int, List[Tuple[int, str]]]:
        """Map transcript interval [tstart, tstart+length) to genomic
        (pos0, cigar) with M/N ops. Returns 0-based genomic start."""
        out: List[Tuple[int, str]] = []
        pos0 = self.tx2genome(tstart) - 1
        remaining = length
        off = tstart
        prev_right = None
        for l, r in self.exons:
            ln = r - l + 1
            if off >= ln:
                off -= ln
                continue
            take = min(ln - off, remaining)
            g_l = l + off
            if prev_right is not None:
                gap = g_l - prev_right - 1
                if gap > 0:
                    out.append((gap, "N"))
            out.append((take, "M"))
            prev_right = g_l + take - 1
            remaining -= take
            off = 0
            if remaining == 0:
                break
        if remaining:
            raise ValueError("read extends past transcript end")
        # merge adjacent M (possible when intron length 0 — shouldn't happen)
        merged: List[Tuple[int, str]] = []
        for ln, op in out:
            if merged and merged[-1][1] == op:
                merged[-1] = (merged[-1][0] + ln, op)
            else:
                merged.append((ln, op))
        return pos0, merged


def mutate_cigar(rng: random.Random, cigar: List[Tuple[int, str]],
                 indel_rate: float, clip_rate: float
                 ) -> Tuple[int, List[Tuple[int, str]]]:
    """Optionally inject a MATCH-sandwiched indel inside an M run and/or
    terminal soft clips. Returns (pos0_shift, cigar).

    Indels keep the genomic footprint unchanged (a D shortens the query,
    an I lengthens it), so the read stays compatible with its source
    transcript. Note the reference rejects I/D at cigar index <= 1 even when
    MATCH-sandwiched (src/read.cpp:592-599) — reads mutated at the first M
    of a spliced cigar exercise that drop path in both pipelines."""
    cig = list(cigar)
    if indel_rate and rng.random() < indel_rate:
        idxs = [i for i, (ln, op) in enumerate(cig) if op == "M" and ln >= 16]
        if idxs:
            i = rng.choice(idxs)
            ln, _ = cig[i]
            k = rng.randint(1, 4)
            a = rng.randint(4, ln - k - 8)
            op2 = rng.choice("ID")
            b = ln - a if op2 == "I" else ln - a - k
            cig[i:i + 1] = [(a, "M"), (k, op2), (b, "M")]
    shift = 0
    if clip_rate and rng.random() < clip_rate:
        k = rng.randint(1, 8)
        if rng.random() < 0.5 and cig[0][1] == "M" and cig[0][0] > k + 4:
            cig[0] = (cig[0][0] - k, "M")
            cig.insert(0, (k, "S"))
            shift = k
        elif cig[-1][1] == "M" and cig[-1][0] > k + 4:
            cig[-1] = (cig[-1][0] - k, "M")
            cig.append((k, "S"))
    return shift, cig


def qlen_of(cigar: Sequence[Tuple[int, str]]) -> int:
    return sum(ln for ln, op in cigar if op in "MIS")


def _pair_orientation(protocol: Optional[str], strand: str) -> bool:
    """read1-reverse bit such that --fr/--rf protocol inference
    (read.cpp:639-653) recovers the transcript strand."""
    if protocol == "fr":
        return strand == "-"
    if protocol == "rf":
        return strand == "+"
    return False


def make_genes(rng: random.Random, chroms: Dict[str, int],
               n_genes: int, max_isoforms: int = 3,
               exon_range=(1, 6), exon_len=(80, 400),
               intron_len=(60, 2000), gene_gap=(5000, 20000)
               ) -> List[SimTranscript]:
    """Random non-overlapping genes, each with 1..max_isoforms transcripts
    sharing a splice-site pool (so isoforms overlap / share exons)."""
    txs: List[SimTranscript] = []
    chrom_names = sorted(chroms)
    gi = 0
    for chrom in chrom_names:
        pos = rng.randint(1000, 3000)
        limit = chroms[chrom] - 5000
        while pos < limit:
            gi += 1
            gene_id = f"gene_{gi:04d}"
            strand = rng.choice("+-")
            n_ex = rng.randint(*exon_range)
            exons: List[Tuple[int, int]] = []
            p = pos
            for _ in range(n_ex):
                ln = rng.randint(*exon_len)
                exons.append((p, p + ln - 1))
                p += ln + rng.randint(*intron_len)
            if exons[-1][1] >= limit:
                break
            n_iso = rng.randint(1, max_isoforms)
            made = set()
            for t in range(n_iso):
                if n_ex == 1 or t == 0:
                    sel = list(range(n_ex))
                else:
                    # skip a random subset of internal exons
                    sel = [0] + [i for i in range(1, n_ex - 1)
                                 if rng.random() > 0.4] + [n_ex - 1]
                key = tuple(sel)
                if key in made:
                    continue
                made.add(key)
                iso_exons = [exons[i] for i in sel]
                if sum(r - l + 1 for l, r in iso_exons) < 250:
                    continue
                txs.append(SimTranscript(
                    chrom=chrom, gene_id=gene_id,
                    tx_id=f"{gene_id}.t{t+1}", strand=strand,
                    exons=iso_exons))
            pos = exons[-1][1] + rng.randint(*gene_gap)
    return txs


def write_gtf(path: str, txs: Sequence[SimTranscript]):
    with open(path, "w") as fh:
        for t in txs:
            attr = (f'gene_id "{t.gene_id}"; transcript_id "{t.tx_id}";')
            fh.write(f"{t.chrom}\tsim\ttranscript\t{t.exons[0][0]}\t"
                     f"{t.exons[-1][1]}\t.\t{t.strand}\t.\t{attr}\n")
            for (l, r) in t.exons:
                fh.write(f"{t.chrom}\tsim\texon\t{l}\t{r}\t.\t{t.strand}"
                         f"\t.\t{attr}\n")


def write_genome_fasta(path: str, chroms: Dict[str, int], seed: int = 7):
    rng = random.Random(seed)
    with open(path, "w") as fh:
        for name in sorted(chroms):
            fh.write(f">{name}\n")
            n = chroms[name]
            line = []
            for i in range(n):
                line.append("ACGT"[rng.randrange(4)])
                if len(line) == 70:
                    fh.write("".join(line) + "\n")
                    line = []
            if line:
                fh.write("".join(line) + "\n")


def simulate_reads(rng: random.Random, txs: Sequence[SimTranscript],
                   abundances: Optional[Sequence[float]],
                   n_frags: int, read_len: int = 75,
                   frag_mean: float = 250.0, frag_sd: float = 40.0,
                   paired: bool = True, with_xs: bool = True,
                   read_len_range: Optional[Tuple[int, int]] = None,
                   protocol: Optional[str] = None,
                   multimap_frac: float = 0.0,
                   unmapped_mate_frac: float = 0.0,
                   indel_rate: float = 0.0,
                   clip_rate: float = 0.0,
                   mapq_range: Optional[Tuple[int, int]] = None
                   ) -> List[Tuple[str, BamRecord]]:
    """Sample fragments; returns (chrom, record) pairs, unsorted.

    read_len_range: per-read length drawn uniformly (long-read / PacBio CCS
    simulation; implies single-end semantics per record).
    protocol: 'fr'/'rf' orients read pairs so the reference's XS-less
    protocol strand inference recovers the transcript strand (use with
    with_xs=False plus the matching --fr/--rf flag).
    multimap_frac: fraction of fragments also aligned at a second
    transcript, all copies carrying NH=2 (secondary copy flagged 0x100) —
    dropped under the default unique-hits mode, mass 1/NH under
    --allow-multimapped-hits (read.cpp:49-53,679-684).
    indel_rate/clip_rate: per-read probability of a MATCH-sandwiched I/D
    and of a terminal soft clip (read.cpp:592-599 filter paths).
    mapq_range: per-record uniform mapq (default 50)."""
    if abundances is None:
        abundances = [1.0] * len(txs)
    weights = [a * t.length for a, t in zip(abundances, txs)]
    total_w = sum(weights)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w
        cum.append(acc / total_w)
    records: List[Tuple[str, BamRecord]] = []

    def mapq():
        return rng.randint(*mapq_range) if mapq_range else 50

    def tags_for(t: SimTranscript, nh: int):
        tg = [("NH", "i", nh)]
        if with_xs:
            tg.append(("XS", "A", t.strand))
        return tg

    def emit_single(t: SimTranscript, qname: str, rl: int, nh: int,
                    secondary: bool):
        s = rng.randrange(0, t.length - rl + 1)
        pos0, cig = t.cigar_for(s, rl)
        shift, cig = mutate_cigar(rng, cig, indel_rate, clip_rate)
        flag = 0x100 if secondary else 0
        if protocol and ((protocol == "fr") == (t.strand == "+")):
            flag |= 0x10  # XS-less single-end protocol inference
        rec = BamRecord(qname=qname, flag=flag, ref_id=-1, pos=pos0 + shift,
                        mapq=mapq(), cigar=cig, seq="A" * qlen_of(cig),
                        tags=tags_for(t, nh))
        records.append((t.chrom, rec))

    def emit_pair(t: SimTranscript, qname: str, fl: int, nh: int,
                  secondary: bool):
        s = rng.randrange(0, t.length - fl + 1)
        p1, c1 = t.cigar_for(s, read_len)
        p2, c2 = t.cigar_for(s + fl - read_len, read_len)
        if p1 == p2:
            return  # equal-start pairs are rejected by both pipelines
        sh1, c1 = mutate_cigar(rng, c1, indel_rate, clip_rate)
        sh2, c2 = mutate_cigar(rng, c2, indel_rate, clip_rate)
        p1 += sh1
        p2 += sh2
        span2 = sum(ln for ln, op in c2 if op in "MDN")
        r1_rev = _pair_orientation(protocol, t.strand)
        flag1 = 0x1 | 0x2 | 0x40 | (0x10 if r1_rev else 0x20)
        flag2 = 0x1 | 0x2 | 0x80 | (0x20 if r1_rev else 0x10)
        sec = 0x100 if secondary else 0
        r1 = BamRecord(qname=qname, flag=flag1 | sec, ref_id=-1, pos=p1,
                       mapq=mapq(), cigar=c1, next_ref_id=-2, next_pos=p2,
                       tlen=(p2 + span2) - p1, seq="A" * qlen_of(c1),
                       tags=tags_for(t, nh))
        r2 = BamRecord(qname=qname, flag=flag2 | sec, ref_id=-1, pos=p2,
                       mapq=mapq(), cigar=c2, next_ref_id=-2, next_pos=p1,
                       tlen=-((p2 + span2) - p1), seq="A" * qlen_of(c2),
                       tags=tags_for(t, nh))
        records.append((t.chrom, r1))
        records.append((t.chrom, r2))

    import bisect
    for fi in range(n_frags):
        u = rng.random()
        # first ti with u <= cum[ti] — identical to the linear scan the
        # earlier datasets used, but O(log n) (20k-gene annotations made
        # the linear walk ~3e11 iterations for 5M fragments)
        ti = min(bisect.bisect_left(cum, u), len(cum) - 1)
        t = txs[ti]
        qname = f"frag{fi:08d}"
        if read_len_range is not None:
            rl = min(t.length, rng.randint(*read_len_range))
            emit_single(t, qname, rl, 1, False)
            continue
        if paired and unmapped_mate_frac \
                and rng.random() < unmapped_mate_frac \
                and t.length >= read_len:
            # R1 mapped, mate unmapped: '*' RNEXT (mtid -1) + flag 0x8 —
            # the read.cpp:611-614 verbose diagnostic; still accepted as
            # a singleton hit
            s = rng.randrange(0, t.length - read_len + 1)
            pos0, cig = t.cigar_for(s, read_len)
            r1_rev = _pair_orientation(protocol, t.strand)
            rec = BamRecord(qname=qname,
                            flag=0x1 | 0x40 | 0x8 | (0x10 if r1_rev else 0),
                            ref_id=-1, pos=pos0, mapq=mapq(), cigar=cig,
                            seq="A" * qlen_of(cig), next_ref_id=-1,
                            next_pos=-1, tags=tags_for(t, 1))
            records.append((t.chrom, rec))
            continue
        if paired:
            fl = int(rng.gauss(frag_mean, frag_sd))
            fl = max(read_len + 10, min(fl, t.length))
        else:
            fl = read_len
        if t.length < fl:
            continue
        # an NH=2 multimapper: the same fragment aligned at a second
        # transcript, the copy marked secondary
        t2 = None
        if multimap_frac and rng.random() < multimap_frac and len(txs) > 1:
            for _ in range(8):
                cand = txs[rng.randrange(len(txs))]
                if cand is not t and cand.length >= fl:
                    t2 = cand
                    break
        nh = 2 if t2 is not None else 1
        if paired:
            emit_pair(t, qname, fl, nh, False)
            if t2 is not None:
                emit_pair(t2, qname, fl, nh, True)
        else:
            emit_single(t, qname, read_len, nh, False)
            if t2 is not None:
                emit_single(t2, qname, read_len, nh, True)
    return records


def write_bam(path: str, chroms: Dict[str, int],
              records: List[Tuple[str, BamRecord]]):
    names = sorted(chroms)
    name2id = {n: i for i, n in enumerate(names)}
    for chrom, rec in records:
        rec.ref_id = name2id[chrom]
        if rec.next_ref_id == -2:
            rec.next_ref_id = rec.ref_id
    records.sort(key=lambda cr: (cr[1].ref_id, cr[1].pos))
    with BamWriter(path, names, [chroms[n] for n in names]) as bw:
        for _, rec in records:
            bw.write(rec)


def write_gff3(path: str, txs: Sequence[SimTranscript]):
    """GFF3 annotation (ID=/Parent= attributes, gene->mRNA->exon)."""
    genes = {}
    for t in txs:
        genes.setdefault(t.gene_id, []).append(t)
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        for gid, gtxs in genes.items():
            gl = min(t.exons[0][0] for t in gtxs)
            gr = max(t.exons[-1][1] for t in gtxs)
            chrom, strand = gtxs[0].chrom, gtxs[0].strand
            # Ensembl-style ID prefixes: the reference reclassifies features
            # by substring of the ID ("transcript"/"gene", gff.cpp:196-197),
            # so bare IDs like "g1.t1" would be misparsed — by the reference
            # and (faithfully) by us.
            fh.write(f"{chrom}\tsim\tgene\t{gl}\t{gr}\t.\t{strand}\t.\t"
                     f"ID=gene:{gid};Name={gid}\n")
            for t in gtxs:
                fh.write(f"{chrom}\tsim\tmRNA\t{t.exons[0][0]}\t"
                         f"{t.exons[-1][1]}\t.\t{strand}\t.\t"
                         f"ID=transcript:{t.tx_id};Parent=gene:{gid}\n")
                for (l, r) in t.exons:
                    fh.write(f"{chrom}\tsim\texon\t{l}\t{r}\t.\t{strand}"
                             f"\t.\tParent=transcript:{t.tx_id}\n")


def make_dataset(outdir: str, seed: int = 42, n_genes_hint: int = 10,
                 chrom_len: int = 300_000, n_chroms: int = 1,
                 n_frags: int = 2000, read_len: int = 75,
                 paired: bool = True, max_isoforms: int = 3,
                 with_xs: bool = True, abundance_seed: Optional[int] = None,
                 read_len_range: Optional[Tuple[int, int]] = None,
                 annotation_format: str = "gtf",
                 protocol: Optional[str] = None, multimap_frac: float = 0.0,
                 unmapped_mate_frac: float = 0.0,
                 indel_rate: float = 0.0, clip_rate: float = 0.0,
                 mapq_range: Optional[Tuple[int, int]] = None,
                 exon_range: Optional[Tuple[int, int]] = None,
                 abundance: str = "uniform"):
    """Convenience: genome + GTF + BAM in outdir. Returns (bam, gtf, txs).

    exon_range widens the per-gene exon count (more isoform diversity at
    high max_isoforms); abundance="lognormal" draws skewed expression
    (sigma 1.5) for realistic uneven coverage."""
    import os
    os.makedirs(outdir, exist_ok=True)
    rng = random.Random(seed)
    chroms = {f"chr{i+1}": chrom_len for i in range(n_chroms)}
    exon_len = (80, 400) if read_len_range is None else (300, 900)
    txs = make_genes(rng, chroms, n_genes_hint, max_isoforms=max_isoforms,
                     exon_len=exon_len,
                     **({"exon_range": exon_range} if exon_range else {}))
    arng = random.Random(abundance_seed if abundance_seed is not None
                         else seed + 1)
    if abundance == "lognormal":
        abund = [arng.lognormvariate(0.0, 1.5) for _ in txs]
    else:
        abund = [arng.uniform(0.2, 5.0) for _ in txs]
    recs = simulate_reads(rng, txs, abund, n_frags, read_len=read_len,
                          paired=paired, with_xs=with_xs,
                          read_len_range=read_len_range, protocol=protocol,
                          multimap_frac=multimap_frac,
                          unmapped_mate_frac=unmapped_mate_frac,
                          indel_rate=indel_rate,
                          clip_rate=clip_rate, mapq_range=mapq_range)
    bam = os.path.join(outdir, "sample_01.sorted.bam")
    write_bam(bam, chroms, recs)
    if annotation_format == "gff3":
        gtf = os.path.join(outdir, "annotation.gff3")
        write_gff3(gtf, txs)
    else:
        gtf = os.path.join(outdir, "annotation.gtf")
        write_gtf(gtf, txs)
    return bam, gtf, txs
