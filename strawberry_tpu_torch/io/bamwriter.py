"""Minimal BAM/BGZF writer (pure Python).

Used by the simulator and the test-suite to synthesize position-sorted BAM
inputs (the reference's own toy BAM, examples/geuvadis_300, is not shipped).
Format per the SAM/BAM spec v1; compatible with samtools-0.1.19 which the
reference links against (ref: /root/reference/external/samtools-0.1.19).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

BAM_CIGAR_OPS = "MIDNSHP=X"
_OP2CODE = {c: i for i, c in enumerate(BAM_CIGAR_OPS)}
_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT2CODE = {c: i for i, c in enumerate(_SEQ_NT16)}

BGZF_EOF = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """Wrap one payload (<=64KB) in a single BGZF block."""
    assert len(data) <= 0xff00
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize_minus_1 = len(cdata) + 26 - 1  # total = header(18)+cdata+footer(8)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1f, 0x8b, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xff,              # mtime, xfl, os
        6,                       # xlen
        0x42, 0x43, 2,           # 'B','C', subfield len
        bsize_minus_1)           # BSIZE field stores total size - 1
    footer = struct.pack("<II", zlib.crc32(data) & 0xffffffff, len(data))
    return header + cdata + footer


def pack_cigar(cigar: Sequence[Tuple[int, str]]) -> bytes:
    out = b""
    for length, op in cigar:
        out += struct.pack("<I", (length << 4) | _OP2CODE[op])
    return out


def pack_seq(seq: str) -> bytes:
    out = bytearray()
    for i in range(0, len(seq), 2):
        hi = _NT2CODE.get(seq[i].upper(), 15)
        lo = _NT2CODE.get(seq[i + 1].upper(), 15) if i + 1 < len(seq) else 0
        out.append((hi << 4) | lo)
    return bytes(out)


@dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos: int                      # 0-based leftmost
    mapq: int = 50
    cigar: Sequence[Tuple[int, str]] = field(default_factory=list)
    next_ref_id: int = -1
    next_pos: int = -1            # 0-based
    tlen: int = 0
    seq: str = ""
    qual: Optional[bytes] = None
    tags: List[Tuple[str, str, object]] = field(default_factory=list)
    # tags: (name, type_char, value); supported types: A, i, f, Z

    def encode(self) -> bytes:
        name = self.qname.encode() + b"\0"
        cig = pack_cigar(self.cigar)
        seq = pack_seq(self.seq)
        qual = self.qual if self.qual is not None else b"\xff" * len(self.seq)
        if self.seq:
            assert len(qual) == len(self.seq)
        aux = b""
        for tag, typ, val in self.tags:
            aux += tag.encode()
            if typ == "A":
                aux += b"A" + str(val).encode()[:1]
            elif typ == "i":
                aux += b"i" + struct.pack("<i", int(val))
            elif typ == "f":
                aux += b"f" + struct.pack("<f", float(val))
            elif typ == "Z":
                aux += b"Z" + str(val).encode() + b"\0"
            elif typ == "B":
                sub, arr = val
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H",
                       "i": "i", "I": "I", "f": "f"}[sub]
                aux += b"B" + sub.encode() + struct.pack("<i", len(arr))
                for v in arr:
                    aux += struct.pack("<" + fmt, v)
            else:
                raise ValueError(f"unsupported tag type {typ}")
        body = struct.pack(
            "<iiBBHHHiiii",
            self.ref_id, self.pos,
            len(name), self.mapq, 4680,  # bin: unused by readers we care about
            len(self.cigar), self.flag,
            len(self.seq), self.next_ref_id, self.next_pos, self.tlen)
        body += name + cig + seq + qual + aux
        return struct.pack("<i", len(body)) + body


class BamWriter:
    def __init__(self, path: str, ref_names: Sequence[str],
                 ref_lens: Sequence[int], text: str = ""):
        self._fh = open(path, "wb")
        if not text:
            text = "@HD\tVN:1.0\tSO:coordinate\n"
            for n, l in zip(ref_names, ref_lens):
                text += f"@SQ\tSN:{n}\tLN:{l}\n"
        tb = text.encode()
        hdr = b"BAM\1" + struct.pack("<i", len(tb)) + tb
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\0"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self._buf = bytearray(hdr)
        self._flush_blocks(final=False)

    def _flush_blocks(self, final: bool):
        while len(self._buf) >= 0xff00 or (final and self._buf):
            chunk = bytes(self._buf[:0xff00])
            del self._buf[:0xff00]
            self._fh.write(bgzf_compress(chunk))

    def write(self, rec: BamRecord):
        self._buf += rec.encode()
        if len(self._buf) >= 0xff00:
            self._flush_blocks(final=False)

    def close(self):
        self._flush_blocks(final=True)
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
