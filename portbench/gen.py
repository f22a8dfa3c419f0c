"""Seeded RNA-seq sets: a genome's annotation (GTF) and a position-sorted BAM.

A NumPy rewrite, for speed, of the simulation model of the program's
`sim.py` (itself the model of the JAX repo's `bench.py` sets): genes of 2-9
exons, isoforms that skip internal exons, lognormal or uniform expression,
paired 75-base reads from fragments of N(250, 40) bases, a 2% chance of a
MATCH-sandwiched insertion or deletion and a 3% chance of a soft clip per
read, strand from the XS tag or from the library's `fr`/`rf` orientation.
The configuration file (`configs/<name>.json`) holds every number of the
model; nothing here depends on a cell.

The same seed gives the same bytes. `simulate` returns the records as arrays
(the plain reference reads them from there); `write_set` writes them, with
the BGZF blocks compressed on a pool of threads.

    python3 -m portbench.gen --config <file> --seed <n> --out <dir>

writes `annotation.gtf`, `sample.bam` (the cell's sample) and `warmup.bam`
(`warmup_frags` fragments of the same annotation) into <dir>, each synced
to disk so that no writeback of the set runs into a later window, then a
`done.json` with the counts of records.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np

# BAM cigar operation codes
OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4
MAX_OPS = 6          # M N M, an indel splitting one M in three, one clip
BGZF_PAYLOAD = 0xff00
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")
NAME_LEN = 13        # "frag%08d" and its NUL
HEADER_DT = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"),
                      ("pos", "<i4"), ("l_read_name", "u1"), ("mapq", "u1"),
                      ("bin", "<u2"), ("n_cigar_op", "<u2"), ("flag", "<u2"),
                      ("l_seq", "<i4"), ("next_ref_id", "<i4"),
                      ("next_pos", "<i4"), ("tlen", "<i4")])


@dataclass
class Annotation:
    """Transcripts in the GTF's order; exons 1-based inclusive, ascending."""
    chrom_names: List[str]      # sorted, as the BAM header lists them
    chrom_len: int
    tx_chrom: np.ndarray        # int32, index into chrom_names
    tx_strand: np.ndarray       # int8: +1 or -1
    gene_ids: List[str]
    tx_ids: List[str]
    ex_off: np.ndarray          # int64 (ntx + 1,)
    ex_start: np.ndarray        # int64
    ex_end: np.ndarray          # int64

    @property
    def n_tx(self) -> int:
        return len(self.tx_ids)

    def tx_len(self) -> np.ndarray:
        ln = self.ex_end - self.ex_start + 1
        return np.add.reduceat(ln, self.ex_off[:-1]).astype(np.int64)


@dataclass
class Reads:
    """The BAM's records in file order (chromosome, then position)."""
    chrom: np.ndarray   # int32
    pos: np.ndarray     # int64, 0-based leftmost
    flag: np.ndarray    # uint16
    next_pos: np.ndarray  # int64, 0-based
    tlen: np.ndarray    # int32
    n_ops: np.ndarray   # int8
    ops: np.ndarray     # uint32 (n, MAX_OPS): length << 4 | op
    qlen: np.ndarray    # int32
    frag: np.ndarray    # int64: the fragment's number, the read's name
    xs: np.ndarray      # int8: 0 no XS tag, 1 '+', 2 '-'

    def __len__(self) -> int:
        return len(self.pos)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def make_annotation(cfg: dict, seed: int) -> Annotation:
    """Non-overlapping genes along each chromosome, each with 1 to
    `max_isoforms` distinct isoforms over a shared pool of exons."""
    rng = random.Random(int(seed) * 7919 + 17)
    names = sorted(f"chr{i + 1}" for i in range(cfg["n_chroms"]))
    clen = cfg["chrom_len"]
    e_lo, e_hi = cfg["exon_range"]
    xl_lo, xl_hi = cfg["exon_len"]
    il_lo, il_hi = cfg["intron_len"]
    gg_lo, gg_hi = cfg["gene_gap"]
    tx_chrom, tx_strand, gene_ids, tx_ids = [], [], [], []
    ex_off, ex_start, ex_end = [0], [], []
    gi = 0
    for ci, _ in enumerate(names):
        pos = rng.randint(1000, 3000)
        limit = clen - 5000
        while pos < limit:
            gi += 1
            gene = f"gene_{gi:05d}"
            strand = 1 if rng.random() < 0.5 else -1
            n_ex = rng.randint(e_lo, e_hi)
            exons = []
            p = pos
            for _ in range(n_ex):
                ln = rng.randint(xl_lo, xl_hi)
                exons.append((p, p + ln - 1))
                p += ln + rng.randint(il_lo, il_hi)
            if exons[-1][1] >= limit:
                break
            made = set()
            for t in range(rng.randint(1, cfg["max_isoforms"])):
                if n_ex == 1 or t == 0:
                    sel = tuple(range(n_ex))
                else:
                    sel = (0,) + tuple(i for i in range(1, n_ex - 1)
                                       if rng.random() > 0.4) + (n_ex - 1,)
                if sel in made:
                    continue
                made.add(sel)
                iso = [exons[i] for i in sel]
                if sum(r - l + 1 for l, r in iso) < 250:
                    continue
                tx_chrom.append(ci)
                tx_strand.append(strand)
                gene_ids.append(gene)
                tx_ids.append(f"{gene}.t{t + 1}")
                ex_start.extend(l for l, _ in iso)
                ex_end.extend(r for _, r in iso)
                ex_off.append(len(ex_start))
            pos = exons[-1][1] + rng.randint(gg_lo, gg_hi)
    return Annotation(names, clen, np.asarray(tx_chrom, np.int32),
                      np.asarray(tx_strand, np.int8), gene_ids, tx_ids,
                      np.asarray(ex_off, np.int64),
                      np.asarray(ex_start, np.int64),
                      np.asarray(ex_end, np.int64))


def _mutate(cig, u, indel: bool, clip: bool):
    """One read's cigar after sim.py's `mutate_cigar`, its random choices
    taken from the six uniforms `u`: (pos shift, cigar)."""
    if indel:
        idxs = [i for i, (ln, op) in enumerate(cig) if op == OP_M and ln >= 16]
        if idxs:
            i = idxs[int(u[0] * len(idxs))]
            ln = cig[i][0]
            k = 1 + int(u[1] * 4)
            a = 4 + int(u[2] * (ln - k - 11))
            if u[3] < 0.5:
                cig[i:i + 1] = [(a, OP_M), (k, OP_I), (ln - a, OP_M)]
            else:
                cig[i:i + 1] = [(a, OP_M), (k, OP_D), (ln - a - k, OP_M)]
    shift = 0
    if clip:
        k = 1 + int(u[4] * 8)
        if u[5] < 0.5 and cig[0][1] == OP_M and cig[0][0] > k + 4:
            cig[0] = (cig[0][0] - k, OP_M)
            cig.insert(0, (k, OP_S))
            shift = k
        elif cig[-1][1] == OP_M and cig[-1][0] > k + 4:
            cig[-1] = (cig[-1][0] - k, OP_M)
            cig.append((k, OP_S))
    return shift, cig


def simulate(cfg: dict, ann: Annotation, seed: int, n_frags: int,
             stream: int) -> Reads:
    """`n_frags` paired fragments drawn over `ann`'s transcripts by their
    expression times length, as sorted BAM records."""
    rl = cfg["read_len"]
    g = _rng(seed, 1)                      # expression: one per annotation
    ntx = ann.n_tx
    if cfg["abundance"] == "lognormal":
        abund = g.lognormal(0.0, cfg["abundance_sigma"], ntx)
    else:
        abund = g.uniform(*cfg["abundance_range"], ntx)
    tx_len = ann.tx_len()
    cum = np.cumsum(abund * tx_len)
    cum /= cum[-1]

    r = _rng(seed, stream)
    ti = np.minimum(np.searchsorted(cum, r.random(n_frags), "left"), ntx - 1)
    L = tx_len[ti]
    fl = np.trunc(r.normal(cfg["frag_mean"], cfg["frag_sd"], n_frags))
    fl = np.maximum(rl + 10, np.minimum(fl.astype(np.int64), L))
    s = r.integers(0, L - fl + 1)

    # each read's place on its transcript, then on the genome
    # exons in transcript order make one axis of transcript bases: G is
    # each exon's first base on it, tx_base each transcript's
    ex_len = ann.ex_end - ann.ex_start + 1
    G = np.cumsum(ex_len) - ex_len
    tx_base = G[ann.ex_off[:-1]]
    n = 2 * n_frags
    tstart = np.empty(n, np.int64)
    tstart[0::2] = s
    tstart[1::2] = s + fl - rl
    tix = np.repeat(ti, 2)
    q = tx_base[tix] + tstart
    j = np.searchsorted(G, q, "right") - 1
    off = q - G[j]
    pos0 = ann.ex_start[j] + off - 1
    len1 = np.minimum(rl, ex_len[j] - off)
    spliced = len1 < rl
    jn = np.minimum(j + 1, len(G) - 1)
    intron = np.where(spliced, ann.ex_start[jn] - ann.ex_end[j] - 1, 0)
    if np.any(spliced & (rl - len1 > ex_len[jn])):
        raise AssertionError("a read spans three exons")
    ops = np.zeros((n, MAX_OPS), np.uint32)
    ops[:, 0] = (len1 << 4) | OP_M
    ops[:, 1] = np.where(spliced, (intron << 4) | OP_N, 0)
    ops[:, 2] = np.where(spliced, ((rl - len1) << 4) | OP_M, 0)
    n_ops = np.where(spliced, 3, 1).astype(np.int8)
    qlen = np.full(n, rl, np.int32)
    span = np.where(spliced, rl + intron, rl).astype(np.int64)

    indel = r.random(n) < cfg["indel_rate"]
    clip = r.random(n) < cfg["clip_rate"]
    mut = np.nonzero(indel | clip)[0]
    U = r.random((len(mut), 6))
    shift = np.zeros(n, np.int64)
    for k, i in enumerate(mut.tolist()):
        cig = [(int(v >> 4), int(v & 15)) for v in ops[i, :n_ops[i]]]
        sh, cig = _mutate(cig, U[k], bool(indel[i]), bool(clip[i]))
        shift[i] = sh
        n_ops[i] = len(cig)
        ops[i, :] = 0
        ops[i, :len(cig)] = [(ln << 4) | op for ln, op in cig]
        qlen[i] = sum(ln for ln, op in cig if op in (OP_M, OP_I, OP_S))
        span[i] = sum(ln for ln, op in cig if op in (OP_M, OP_D, OP_N))
    pos = pos0 + shift

    strand = ann.tx_strand[tix]
    prot = cfg["protocol"]
    r1_rev = (strand[0::2] < 0) if prot == "fr" else (strand[0::2] > 0)
    flag = np.empty(n, np.uint16)
    flag[0::2] = np.where(r1_rev, 0x1 | 0x2 | 0x40 | 0x10, 0x1 | 0x2 | 0x40 | 0x20)
    flag[1::2] = np.where(r1_rev, 0x1 | 0x2 | 0x80 | 0x20, 0x1 | 0x2 | 0x80 | 0x10)
    p1, p2 = pos[0::2], pos[1::2]
    t1 = (p2 + span[1::2]) - p1
    tlen = np.empty(n, np.int32)
    tlen[0::2] = t1
    tlen[1::2] = -t1
    next_pos = np.empty(n, np.int64)
    next_pos[0::2] = p2
    next_pos[1::2] = p1
    chrom = ann.tx_chrom[tix]
    xs = (np.where(strand > 0, 1, 2) if cfg["with_xs"]
          else np.zeros(n)).astype(np.int8)
    frag = np.repeat(np.arange(n_frags, dtype=np.int64), 2)

    order = np.lexsort((np.arange(n), pos, chrom))
    return Reads(chrom[order], pos[order], flag[order], next_pos[order],
                 tlen[order], n_ops[order], ops[order], qlen[order],
                 frag[order], xs[order])


def _encode(R: Reads, a: int, b: int) -> bytes:
    """Records a..b as BAM bytes: one row a record, padded, then the
    padding dropped row by row."""
    n = b - a
    n_ops = R.n_ops[a:b].astype(np.int64)
    qlen = R.qlen[a:b].astype(np.int64)
    xs = R.xs[a:b]
    has_xs = bool(xs.any())
    tags = 7 + (4 if has_xs else 0)
    size = 36 + NAME_LEN + 4 * n_ops + (qlen + 1) // 2 + qlen + tags
    W = int(size.max())
    buf = np.zeros((n, W), np.uint8)
    H = np.zeros(n, HEADER_DT)
    H["block_size"] = size - 4
    H["ref_id"] = R.chrom[a:b]
    H["pos"] = R.pos[a:b]
    H["l_read_name"] = NAME_LEN
    H["mapq"] = 50
    H["bin"] = 4680
    H["n_cigar_op"] = n_ops
    H["flag"] = R.flag[a:b]
    H["l_seq"] = qlen
    H["next_ref_id"] = R.chrom[a:b]
    H["next_pos"] = R.next_pos[a:b]
    H["tlen"] = R.tlen[a:b]
    buf[:, :36] = H.view(np.uint8).reshape(n, 36)
    buf[:, 36:40] = np.frombuffer(b"frag", np.uint8)
    fr = R.frag[a:b]
    for d in range(8):
        buf[:, 40 + d] = 48 + (fr // 10 ** (7 - d)) % 10
    ops = R.ops[a:b]
    xs_char = np.where(xs == 1, ord("+"), ord("-")).astype(np.uint8)
    keys = n_ops * 1024 + qlen
    for key in np.unique(keys).tolist():
        k, ql = key // 1024, key % 1024
        rows = np.nonzero(keys == key)[0]
        o = 36 + NAME_LEN
        buf[rows, o:o + 4 * k] = np.ascontiguousarray(
            ops[rows, :k]).view(np.uint8)
        o += 4 * k
        sl = (ql + 1) // 2
        buf[rows, o:o + sl] = 0x11            # 'A' 'A'
        if ql % 2:
            buf[rows, o + sl - 1] = 0x10
        o += sl
        buf[rows, o:o + ql] = 0xFF
        o += ql
        buf[rows, o:o + 7] = np.frombuffer(b"NHi\x01\x00\x00\x00", np.uint8)
        o += 7
        if has_xs:
            buf[rows, o:o + 3] = np.frombuffer(b"XSA", np.uint8)
            buf[rows, o + 3] = xs_char[rows]
    return buf[np.arange(W) < size[:, None]].tobytes()


def _bgzf_block(data: bytes, level: int) -> bytes:
    cdata = zlib.compress(data, level, wbits=-15)
    head = struct.pack("<BBBBIBBHBBHH", 0x1f, 0x8b, 0x08, 0x04, 0, 0, 0xff,
                       6, 0x42, 0x43, 2, len(cdata) + 25)
    return head + cdata + struct.pack("<II", zlib.crc32(data), len(data))


def _blocks(data: bytes, level: int) -> bytes:
    return b"".join(_bgzf_block(data[k:k + BGZF_PAYLOAD], level)
                    for k in range(0, len(data), BGZF_PAYLOAD))


def write_bam(path: str, ann: Annotation, R: Reads, level: int = 6,
              chunk: int = 50_000) -> None:
    """The BAM of `R`: each chunk of records encoded and cut into its own
    BGZF blocks on a pool of threads (numpy and zlib release the
    interpreter's lock), written in order."""
    names = ann.chrom_names
    text = "@HD\tVN:1.0\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ann.chrom_len}\n" for nm in names)
    hdr = bytearray(b"BAM\1" + struct.pack("<i", len(text)) + text.encode()
                    + struct.pack("<i", len(names)))
    for nm in names:
        hdr += struct.pack("<i", len(nm) + 1) + nm.encode() + b"\0"
        hdr += struct.pack("<i", ann.chrom_len)
    n = len(R)
    with open(path + ".tmp", "wb") as fh, ThreadPoolExecutor(
            max_workers=max(1, min(8, os.cpu_count() or 1))) as pool:
        fh.write(_blocks(bytes(hdr), level))
        for part in pool.map(
                lambda a: _blocks(_encode(R, a, min(n, a + chunk)), level),
                range(0, n, chunk)):
            fh.write(part)
        fh.write(BGZF_EOF)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(path + ".tmp", path)


def write_gtf(path: str, ann: Annotation) -> None:
    lines = []
    for t in range(ann.n_tx):
        chrom = ann.chrom_names[ann.tx_chrom[t]]
        st = "+" if ann.tx_strand[t] > 0 else "-"
        attr = f'gene_id "{ann.gene_ids[t]}"; transcript_id "{ann.tx_ids[t]}";'
        a, b = ann.ex_off[t], ann.ex_off[t + 1]
        lines.append(f"{chrom}\tsim\ttranscript\t{ann.ex_start[a]}\t"
                     f"{ann.ex_end[b - 1]}\t.\t{st}\t.\t{attr}\n")
        for e in range(a, b):
            lines.append(f"{chrom}\tsim\texon\t{ann.ex_start[e]}\t"
                         f"{ann.ex_end[e]}\t.\t{st}\t.\t{attr}\n")
    with open(path + ".tmp", "w") as fh:
        fh.writelines(lines)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(path + ".tmp", path)


SAMPLE_STREAM, WARMUP_STREAM = 2, 3


def sample_reads(cfg: dict, seed: int, ann: Annotation = None) -> Reads:
    """The cell's sample: what `sample.bam` holds."""
    ann = ann or make_annotation(cfg, seed)
    return simulate(cfg, ann, seed, cfg["n_frags"], SAMPLE_STREAM)


def write_set(cfg: dict, seed: int, out: str) -> dict:
    os.makedirs(out, exist_ok=True)
    ann = make_annotation(cfg, seed)
    write_gtf(os.path.join(out, "annotation.gtf"), ann)
    warm = simulate(cfg, ann, seed, cfg["warmup_frags"], WARMUP_STREAM)
    write_bam(os.path.join(out, "warmup.bam"), ann, warm)
    R = sample_reads(cfg, seed, ann)
    write_bam(os.path.join(out, "sample.bam"), ann, R)
    done = {"seed": int(seed), "config": cfg["name"], "reads": len(R),
            "warmup_reads": len(warm), "transcripts": ann.n_tx,
            "genes": len(set(ann.gene_ids))}
    with open(os.path.join(out, "done.json"), "w") as f:
        json.dump(done, f)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    print(json.dumps(write_set(cfg, args.seed, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
