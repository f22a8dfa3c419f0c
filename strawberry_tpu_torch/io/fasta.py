"""FASTA random access via .fai index (ref: src/fasta.cpp, include/fasta.h).

Loads one chromosome at a time (FaSeqGetter semantics). Unlike the
reference (which requires a pre-built .fai, fasta.cpp:87-90), we build the
index on the fly when missing.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class FaRecord:
    name: str
    seq_len: int
    fpos: int
    line_len: int
    line_blen: int


def read_fai(path: str) -> Dict[str, FaRecord]:
    out = {}
    with open(path) as fh:
        for line in fh:
            t = line.rstrip("\n").split("\t")
            if len(t) < 5:
                continue
            out[t[0]] = FaRecord(t[0], int(t[1]), int(t[2]), int(t[3]),
                                 int(t[4]))
    return out


def build_fai(fa_path: str) -> Dict[str, FaRecord]:
    out: Dict[str, FaRecord] = {}
    with open(fa_path, "rb") as fh:
        name = None
        seq_len = 0
        fpos = 0
        line_len = 0
        line_blen = 0
        while True:
            pos = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    out[name] = FaRecord(name, seq_len, fpos, line_len,
                                         line_blen)
                name = line[1:].split()[0].decode()
                seq_len = 0
                fpos = fh.tell()
                line_len = line_blen = 0
            else:
                l = len(line.rstrip(b"\r\n"))
                if line_len == 0:
                    line_len = l
                    line_blen = len(line)
                seq_len += l
        if name is not None:
            out[name] = FaRecord(name, seq_len, fpos, line_len, line_blen)
    return out


class FastaInterface:
    """FaInterface + FaSeqGetter: single file or directory of fastas."""

    def __init__(self, path: str):
        self.records: Dict[str, FaRecord] = {}
        self.file_for: Dict[str, str] = {}
        paths = []
        if os.path.isdir(path):
            for f in sorted(os.listdir(path)):
                if f.endswith((".fa", ".fasta", ".fna")):
                    paths.append(os.path.join(path, f))
        else:
            paths.append(path)
        for p in paths:
            fai = p + ".fai"
            recs = read_fai(fai) if os.path.exists(fai) else build_fai(p)
            for n, r in recs.items():
                self.records[n] = r
                self.file_for[n] = p
        self._loaded_name: Optional[str] = None
        self._seq: str = ""

    def load_chrom(self, name: str) -> bool:
        if name == self._loaded_name:
            return True
        rec = self.records.get(name)
        if rec is None:
            return False
        with open(self.file_for[name], "rb") as fh:
            fh.seek(rec.fpos)
            n_lines = (rec.seq_len + rec.line_len - 1) // rec.line_len \
                if rec.line_len else 0
            raw = fh.read(n_lines * rec.line_blen if rec.line_blen else
                          rec.seq_len)
        self._seq = raw.decode(errors="replace").replace("\r", "") \
            .replace("\n", "")[:rec.seq_len]
        self._loaded_name = name
        return True

    def fetch(self, start: int, length: int) -> str:
        """1-based start, as the reference's fetchSeq."""
        return self._seq[start - 1:start - 1 + length]
