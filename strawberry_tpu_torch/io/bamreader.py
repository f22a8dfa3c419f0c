"""BAM/BGZF reader producing flat numpy hit tables.

Host-side decode layer replacing the reference's libbam + BAMHitFactory
(ref: src/read.cpp:310-715, external/samtools-0.1.19). Instead of streaming
one bam1_t at a time, we decode the whole (or a coordinate range of a) BAM
into structure-of-arrays numpy tensors that feed the clustering and the
batched TPU kernels.

Filter semantics follow BAMHitFactory::getHitFromBuf exactly
(src/read.cpp:480-715):
  * unmapped (flag&4 or tid<0) -> dropped
  * zero-length CIGAR op -> dropped
  * intron (N) length > max_intron_length or < min_intron_length -> dropped
  * INS/DEL at cigar index <=1 or last, or not MATCH-sandwiched -> dropped
  * effective read len (sum of M) <= 1 -> dropped
  * multimapped (NH>1 or flag&0x100) dropped when use_only_unique_hits
Strand comes from the XS tag, else from --fr/--rf protocol inference
(src/read.cpp:623-653).

A faster native decoder (C++, see strawberry_tpu/native) implements the same
contract; this module is the portable reference and the validation oracle.
"""
from __future__ import annotations

import struct
import sys
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config

# strand encoding (matches Strand_t order, common.h:307)
STRAND_UNKNOWN, STRAND_PLUS, STRAND_MINUS, STRAND_BOTH = 0, 1, 2, 3
# feature codes (Match_t, contig.h:26)
S_MATCH, S_INTRON, S_GAP = 0, 1, 2

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 1099511628211
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1_hash(name: bytes) -> int:
    """FNV-1 (not 1a) of a read name; ReadTable::get_id (read.hpp:164-173)."""
    h = _FNV_OFFSET
    for b in name:
        h = (h * _FNV_PRIME) & _MASK64
        h ^= b
    return h


def bgzf_decompress(data: bytes) -> bytes:
    """Inflate all BGZF blocks of a .bam file into one bytes object."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # scan extra subfields for BC
        xpos = pos + 12
        bsize = None
        end = xpos + xlen
        while xpos < end:
            si1, si2, slen = struct.unpack_from("<BBH", data, xpos)
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
            xpos += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        cdata = data[pos + 12 + xlen: pos + bsize - 8]
        isize = struct.unpack_from("<I", data, pos + bsize - 4)[0]
        if isize:
            out.append(zlib.decompress(cdata, -15, isize))
        pos += bsize
    return b"".join(out)


@dataclass
class HitTable:
    """Structure-of-arrays for accepted alignments, in file (coordinate) order."""
    ref_id: np.ndarray        # i32
    left: np.ndarray          # i64, 1-based
    right: np.ndarray         # i64, 1-based inclusive (pos + ref_span - 1)
    strand: np.ndarray        # i8
    flag: np.ndarray          # u16
    mate_ref: np.ndarray      # i32 (-1 if '*')
    mate_pos: np.ndarray      # i64, 1-based (0 if none)
    nh: np.ndarray            # i32
    read_id: np.ndarray       # u64 (FNV-1 of qname)
    cigar_hash: np.ndarray    # u64 (FNV-1a over raw cigar words; dup collapse)
    # genomic features (readhit_2_genomicFeats semantics: one feature per M
    # op with D extending the previous feature — adjacent M features stay
    # split, matching contig.cpp:12-52 —
    # N runs; soft clips and I dropped) — flattened RLE
    feat_off: np.ndarray      # i64, shape (n+1,)
    feat_code: np.ndarray     # i8
    feat_left: np.ndarray     # i64
    feat_len: np.ndarray      # i32

    # dataset-level metadata
    ref_names: List[str] = field(default_factory=list)       # lowercased
    ref_real_names: List[str] = field(default_factory=list)
    ref_lens: List[int] = field(default_factory=list)
    read_len_hist: Dict[int, int] = field(default_factory=dict)
    paired_end: bool = False
    # -v per-read diagnostics in file order: (accepted-rows-before, kind,
    # read name) with kind 0 = "has unmapped pair" (read.cpp:611-614) and
    # 1 = "has multiple hits" (read.cpp:679-684); the driver replays them
    # per streaming pass like the reference's re-decoding cerr output
    diag_events: Optional[list] = None

    def __len__(self):
        return len(self.ref_id)

    @property
    def mass(self) -> np.ndarray:
        """Per-hit mass: 1/NH if singleton else 0.5/NH (read.cpp:49-53)."""
        singleton = (self.mate_pos == 0) | (self.mate_ref == -1) | \
                    (self.mate_ref != self.ref_id)
        return np.where(singleton, 1.0, 0.5) / self.nh

    @property
    def is_singleton(self) -> np.ndarray:
        return (self.mate_pos == 0) | (self.mate_ref == -1) | \
               (self.mate_ref != self.ref_id)

    @property
    def reverse_compl(self) -> np.ndarray:
        return (self.flag & 0x10) != 0

    def read_len_mode(self) -> int:
        """Mode of the prerun read-length histogram (read.hpp:150-160)."""
        best_count, mode = 0, 0
        for ln, c in self.read_len_hist.items():
            if c > best_count:
                best_count, mode = c, ln
        return mode

    def is_long_read_sample(self, long_read_len: int = 1000) -> bool:
        """>10 distinct read lengths above 1kb (Strawberry.cpp:294-303)."""
        count = 0
        for ln in self.read_len_hist:
            if ln > long_read_len:
                count += 1
            if count > 10:
                return True
        return False


def _parse_header(buf: bytes):
    if buf[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    text = buf[8:8 + l_text].split(b"\0")[0].decode(errors="replace")
    pos = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, pos)[0]
    pos += 4
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        names.append(buf[pos:pos + l_name - 1].decode())
        pos += l_name
        lens.append(struct.unpack_from("<i", buf, pos)[0])
        pos += 4
    return text, names, lens, pos


def load_bam(path: str, config: Optional[Config] = None) -> HitTable:
    cfg = config or Config()
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        buf = bgzf_decompress(raw)
        _text, real_names, ref_lens, pos = _parse_header(buf)
    except (struct.error, zlib.error, ValueError, IndexError) as e:
        raise IOError(f"{path}: truncated or corrupt BAM ({e})") from e

    ref_ids, lefts, rights, strands, flags = [], [], [], [], []
    mate_refs, mate_poss, nhs, read_ids, cigar_hashes = [], [], [], [], []
    feat_off = [0]
    feat_code: List[int] = []
    feat_left: List[int] = []
    feat_len: List[int] = []
    read_len_hist: Dict[int, int] = {}
    paired_end = False
    diag_events: List[tuple] = []
    n_hist = 0
    fr, rf = cfg.fr_strand, cfg.rf_strand

    nbuf = len(buf)
    name_cache: Dict[bytes, int] = {}
    while pos < nbuf:
        if pos + 36 > nbuf:
            raise IOError(f"{path}: truncated BAM record at offset {pos}")
        block_size = struct.unpack_from("<i", buf, pos)[0]
        rec_end = pos + 4 + block_size
        (tid, p0, l_read_name, _mapq, _bin, n_cigar, flag, l_seq,
         mtid, mpos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, pos + 4)
        base = pos + 36
        pos = rec_end
        qname = buf[base:base + l_read_name - 1]
        cig_base = base + l_read_name

        if (flag & 0x4) or tid < 0:
            continue

        # warning-only low-mapq check (src/read.cpp:525-527; no drop)
        if _mapq < cfg.min_map_qual:
            sys.stderr.write("Read %s has not reached min mapq: %d\n"
                             % (qname.decode(errors="replace"),
                                cfg.min_map_qual))

        # decode cigar -> both read-level accounting and genomic features
        ok = True
        spliced = False
        read_len = 0       # genomic span accumulator (M + D + N)
        seq_len = 0        # query length accumulator (M + S + I + H)
        eff_read_len = 0   # M only
        chash = 0xcbf29ce484222325
        ops: List[Tuple[int, int]] = []
        for ci in range(n_cigar):
            v = struct.unpack_from("<I", buf, cig_base + 4 * ci)[0]
            chash = (((chash ^ v) * 1099511628211) & _MASK64)
            op, ln = v & 0xF, v >> 4
            if ln <= 0:
                ok = False
                break
            if op == 0:        # M
                read_len += ln
                eff_read_len += ln
                seq_len += ln
                ops.append((0, ln))
            elif op == 1:      # I
                seq_len += ln
                ops.append((1, ln))
            elif op == 2:      # D
                read_len += ln
                ops.append((2, ln))
            elif op == 3:      # N
                spliced = True
                read_len += ln
                ops.append((3, ln))
                if ln > cfg.max_intron_length or ln < cfg.min_intron_length:
                    ok = False
                    break
            elif op == 4:      # S
                seq_len += ln
                ops.append((4, ln))
            elif op == 5:      # H
                seq_len += ln
            elif op == 6:      # P
                pass
            else:
                ok = False
                break
        if not ok:
            continue
        # INS/DEL must be MATCH-sandwiched and not at index <=1 or last
        # (src/read.cpp:592-599: `if(i-1 <= 0 || i+1 >= cigar.size())`)
        for i, (op, ln) in enumerate(ops):
            if op in (1, 2):
                if i - 1 <= 0 or i + 1 >= len(ops):
                    ok = False
                    break
                if ops[i - 1][0] != 0 or ops[i + 1][0] != 0:
                    ok = False
                    break
        if not ok or eff_read_len <= 1:
            continue

        if flag & 0x1:
            paired_end = True

        # aux tags
        aux_base = cig_base + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        strand = STRAND_UNKNOWN
        nh = 1
        a = aux_base
        while a < rec_end:
            tag = buf[a:a + 2]
            typ = buf[a + 2:a + 3]
            a += 3
            if typ == b"A":
                if tag == b"XS":
                    c = buf[a:a + 1]
                    if c == b"+":
                        strand = STRAND_PLUS
                    elif c == b"-":
                        strand = STRAND_MINUS
                a += 1
            elif typ in b"cC":
                if tag == b"NH":
                    nh = buf[a]
                a += 1
            elif typ in b"sS":
                if tag == b"NH":
                    nh = struct.unpack_from("<h" if typ == b"s" else "<H", buf, a)[0]
                a += 2
            elif typ in b"iI":
                if tag == b"NH":
                    nh = struct.unpack_from("<i" if typ == b"i" else "<I", buf, a)[0]
                a += 4
            elif typ == b"f":
                a += 4
            elif typ in b"ZH":
                while buf[a] != 0:
                    a += 1
                a += 1
            elif typ == b"B":
                sub = buf[a:a + 1]
                cnt = struct.unpack_from("<i", buf, a + 1)[0]
                size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2,
                        b"i": 4, b"I": 4, b"f": 4}[sub]
                a += 5 + cnt * size
            else:
                break  # unknown type: bail on aux parsing for this record

        if strand == STRAND_UNKNOWN and (fr or rf):
            rev = bool(flag & 0x10)
            if flag & 0x40:  # first in pair
                strand = STRAND_PLUS if ((rf and rev) or (fr and not rev)) \
                    else STRAND_MINUS
            else:
                strand = STRAND_MINUS if ((rf and rev) or (fr and not rev)) \
                    else STRAND_PLUS

        if (flag & 0x1) and mtid != tid and (flag & 0x8) and cfg.verbose:
            # read.cpp:611-614 cerr diagnostic; replayed per pass by the
            # driver (the reference decodes — and prints — per pass)
            diag_events.append((len(ref_ids), 0,
                                qname.decode(errors="replace")))
        if cfg.use_only_unique_hits and (nh > 1 or (flag & 0x100)):
            if cfg.verbose:
                # read.cpp:679-684 cerr diagnostic
                diag_events.append((len(ref_ids), 1,
                                    qname.decode(errors="replace")))
            continue

        # genomic features (readhit_2_genomicFeats, contig.cpp:12-52)
        off = p0 + 1
        for op, ln in ops:
            if op == 0:      # MATCH
                feat_code.append(S_MATCH)
                feat_left.append(off)
                feat_len.append(ln)
                off += ln
            elif op == 3:    # N -> intron
                feat_code.append(S_INTRON)
                feat_left.append(off)
                feat_len.append(ln)
                off += ln
            elif op == 2:    # D extends the previous MATCH feature
                feat_len[-1] += ln
                off += ln
            # I and S contribute nothing genomic. NOTE: the M after a D (or
            # an I) starts a NEW feature adjacent to the previous one — the
            # reference does not merge them (contig.cpp:12-52), and the
            # split/merged distinction is observable in exon-bin assignment.

        rid = name_cache.get(qname)
        if rid is None:
            rid = fnv1_hash(qname)
            if len(name_cache) < 1_000_000:
                name_cache[qname] = rid

        ref_ids.append(tid)
        lefts.append(p0 + 1)
        rights.append(p0 + read_len)
        strands.append(strand)
        flags.append(flag)
        mate_refs.append(mtid if mtid >= 0 else -1)
        mate_poss.append(mpos + 1)
        nhs.append(nh)
        read_ids.append(rid)
        cigar_hashes.append(chash)
        feat_off.append(len(feat_code))

        if n_hist < cfg.max_read_num_4_rl:
            read_len_hist[seq_len] = read_len_hist.get(seq_len, 0) + 1
            n_hist += 1

    return HitTable(
        ref_id=np.asarray(ref_ids, np.int32),
        left=np.asarray(lefts, np.int64),
        right=np.asarray(rights, np.int64),
        strand=np.asarray(strands, np.int8),
        flag=np.asarray(flags, np.uint16),
        mate_ref=np.asarray(mate_refs, np.int32),
        mate_pos=np.asarray(mate_poss, np.int64),
        nh=np.asarray(nhs, np.int32),
        read_id=np.asarray(read_ids, np.uint64),
        cigar_hash=np.asarray(cigar_hashes, np.uint64),
        feat_off=np.asarray(feat_off, np.int64),
        feat_code=np.asarray(feat_code, np.int8),
        feat_left=np.asarray(feat_left, np.int64),
        feat_len=np.asarray(feat_len, np.int32),
        ref_names=[n.lower() for n in real_names],
        ref_real_names=list(real_names),
        ref_lens=list(ref_lens),
        read_len_hist=read_len_hist,
        paired_end=paired_end,
        diag_events=diag_events or None,
    )
