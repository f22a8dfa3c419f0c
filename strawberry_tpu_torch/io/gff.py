"""GTF/GFF3 annotation reader.

Mirrors GffReader (ref: src/gff.cpp, include/gff.h) including its quirks:
  * chromosome names are lowercased (gff.cpp:118)
  * a line whose score column is numeric (not '.') is DROPPED — the early
    `return` at gff.cpp:143-148 fires for any non-'.' score, so such lines
    never get a feature type (deliberately reproduced)
  * feature type classified by substring on the lowercased type column
  * GTF exon lines auto-create their gene/transcript (gff.cpp:517-556)
  * per chromosome, transcripts are emitted forward-strand first, then
    reverse, then unstranded (alignments.cpp:902-912)
  * minus-strand transcripts with descending exon order are reversed
    (gff.cpp:572-582)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.features import (Contig, S_INTRON, S_MATCH, STRAND_MINUS,
                             sort_contigs,
                             STRAND_PLUS, STRAND_UNKNOWN)

FEAT_OTHERS, FEAT_UTR, FEAT_EXON, FEAT_STOP, FEAT_START, FEAT_CDS, \
    FEAT_MRNA, FEAT_GENE = range(8)


def _extract_attr(info: str, attr: str) -> Tuple[str, str]:
    """Reference GffLine::extractAttr (gff.cpp:13-79): find `attr` outside
    quotes at a word boundary, return (value, info_with_attr_removed)."""
    attrlen = len(attr)
    cend = attr[-1]
    n = len(info)
    # find-based scan, equivalent to the reference's char walk: candidates
    # are case-insensitive matches at word boundaries (prev char '', ' ' or
    # ';') outside double quotes (parity of '"' before the position); a
    # match failing the boundary-after check resumes the scan at its end
    attr_l = attr.lower()
    info_l = info.lower()
    pos = 0
    found = -1
    while True:
        cand = info_l.find(attr_l, pos)
        if cand < 0:
            break
        if info.count('"', 0, cand) & 1:   # inside quotes
            pos = cand + 1
            continue
        prevch = info[cand - 1] if cand > 0 else ""
        if prevch in ("", " ", ";"):
            epos = cand + attrlen
            if cend in ("=", " ") or epos >= n or info[epos] == " ":
                found = cand
                break
            pos = epos
            continue
        pos = cand + 1
    if found < 0:
        return "", info
    vp = found + attrlen
    while vp < n and info[vp] == " ":
        vp += 1
    dq = False
    if vp < n and info[vp] == '"':
        dq = True
        vp += 1
    vend = vp
    if dq:
        while vend < n and info[vend] not in ('"', ';'):
            vend += 1
    else:
        while vend < n and info[vend] != ';':
            vend += 1
    val = info[vp:vend]
    while vend < n and info[vend] in ('"', ';', ' '):
        vend += 1
    new_info = info[:found] + info[vend:]
    return val, new_info


@dataclass
class GffExonRec:
    left: int
    right: int
    strand: int


@dataclass
class GffTranscript:
    transcript_id: str
    gene_id: str
    strand: int
    exons: List[GffExonRec] = field(default_factory=list)
    gene_name: str = ""


@dataclass
class GffGene:
    gene_id: str
    gene_name: str = ""
    transcripts: List[str] = field(default_factory=list)


class GffChrom:
    def __init__(self, name: str):
        self.name = name
        self.genes: List[GffGene] = []
        self._gene_by_id: Dict[str, GffGene] = {}
        self.forward: List[GffTranscript] = []
        self.reverse: List[GffTranscript] = []
        self.unstranded: List[GffTranscript] = []
        self._rna_by_key: Dict[Tuple[str, int], GffTranscript] = {}

    def find_gene(self, gid: str) -> Optional[GffGene]:
        return self._gene_by_id.get(gid)

    def add_gene(self, g: GffGene):
        self.genes.append(g)
        self._gene_by_id[g.gene_id] = g

    def add_rna(self, t: GffTranscript):
        if t.strand == STRAND_PLUS:
            self.forward.append(t)
        elif t.strand == STRAND_MINUS:
            self.reverse.append(t)
        else:
            self.unstranded.append(t)
        self._rna_by_key[(t.transcript_id, t.strand)] = t

    def find_rna(self, tid: str, strand: int) -> Optional[GffTranscript]:
        return self._rna_by_key.get((tid, strand))


class GffReader:
    def __init__(self, path: str):
        self.path = path
        self.chroms: List[GffChrom] = []
        self._chrom_by_name: Dict[str, GffChrom] = {}

    def read_all(self):
        cur: Optional[GffChrom] = None
        prev_chrom = None
        with open(self.path) as fh:
            for raw in fh:
                line = raw.rstrip("\n\r")
                s = line.lstrip()
                if not s or s.startswith("#") or len(line) < 10:
                    continue
                parsed = self._parse_line(line)
                if parsed is None:
                    continue
                chrom, feat_type, start, end, strand, attrs = parsed
                if chrom != prev_chrom:
                    prev_chrom = chrom
                    # reference creates a NEW GffTree on every chrom change,
                    # even if seen before (gff.cpp:476-480); mirror that.
                    cur = GffChrom(chrom)
                    self.chroms.append(cur)
                if feat_type == FEAT_GENE:
                    g = GffGene(gene_id=attrs["ID"], gene_name=attrs["name"])
                    cur.add_gene(g)
                elif feat_type == FEAT_MRNA:
                    gene = cur.find_gene(attrs["parent"])
                    if gene is None:
                        continue
                    t = GffTranscript(transcript_id=attrs["ID"],
                                      gene_id=gene.gene_id,
                                      gene_name=gene.gene_name,
                                      strand=strand)
                    cur.add_rna(t)
                elif feat_type == FEAT_EXON:
                    parent = attrs["parent"] or attrs["transcript_id"]
                    if not parent:
                        continue
                    mrna = cur.find_rna(parent, strand)
                    if mrna is None:
                        gid = attrs["gene_id"]
                        gene = cur.find_gene(gid)
                        if gene is None:
                            # GffLoci(id) sets gene_name = id (gff.h:261)
                            gene = GffGene(gene_id=gid, gene_name=gid)
                            cur.add_gene(gene)
                        mrna = GffTranscript(transcript_id=parent,
                                             gene_id=gene.gene_id,
                                             gene_name=gene.gene_name,
                                             strand=strand)
                        cur.add_rna(mrna)
                    mrna.exons.append(GffExonRec(start, end, strand))
        self.sort_exons_in_minus_strand()

    def _parse_line(self, line: str):
        t = line.split("\t")
        if len(t) < 9:
            # reference requires 8 tab splits (9 fields); with exactly 8
            # fields t[8] would be garbage — treat as malformed and skip
            return None
        chrom = t[0].lower()
        start = int(t[3]) if t[3].lstrip("-").isdigit() else 0
        end = int(t[4]) if t[4].lstrip("-").isdigit() else 0
        if start == 0 or end == 0:
            return None
        if end < start:
            start, end = end, start
        # score-column quirk: any non-'.' score drops the line (gff.cpp:143-148)
        if not (t[5] == "."):
            return None
        strand = {"+": STRAND_PLUS, "-": STRAND_MINUS}.get(t[6], STRAND_UNKNOWN)
        ft = t[2].lower()
        if "utr" in ft:
            feat_type = FEAT_UTR
        elif "exon" in ft:
            feat_type = FEAT_EXON
        elif "stop" in ft and ("codon" in ft or "cds" in ft):
            feat_type = FEAT_STOP
        elif "start" in ft and ("codon" in ft or "cds" in ft):
            feat_type = FEAT_START
        elif ft == "cds":
            feat_type = FEAT_CDS
        elif "rna" in ft or "transcript" in ft:
            feat_type = FEAT_MRNA
        elif "gene" in ft:
            feat_type = FEAT_GENE
        else:
            return None  # OTHERS -> skipped

        info = t[8]
        ID, info = _extract_attr(info, "id=")
        parent, info = _extract_attr(info, "parent=")
        is_gff3 = bool(ID or parent)
        name = ""
        gene_id = gene_name = transcript_id = ""
        if is_gff3:
            if ID:
                if "transcript" in ID:
                    feat_type = FEAT_MRNA
                elif "gene" in ID:
                    feat_type = FEAT_GENE
                name, info = _extract_attr(info, "name=")
                if not name:
                    name, info = _extract_attr(info, "gene_name=")
                if not name:
                    name, info = _extract_attr(info, "genename=")
                if not name:
                    name, info = _extract_attr(info, "gene_sym=")
                if not name:
                    name, info = _extract_attr(info, "gene=")
            if parent:
                parent = parent.split(",")[0]
        else:
            gene_id, info = _extract_attr(info, "gene_id")
            gene_name, info = _extract_attr(info, "gene_name")
            transcript_id, info = _extract_attr(info, "transcript_id")
            if feat_type == FEAT_GENE:
                ID = gene_id
                name = gene_name
            else:
                ID = transcript_id
        attrs = dict(ID=ID, name=name, parent=parent, gene_id=gene_id,
                     gene_name=gene_name, transcript_id=transcript_id)
        return chrom, feat_type, start, end, strand, attrs

    def sort_exons_in_minus_strand(self):
        for c in self.chroms:
            for t in c.reverse:
                if len(t.exons) > 1:
                    e0, e1 = t.exons[0], t.exons[1]
                    if (e0.left, e0.right) > (e1.left, e1.right):
                        t.exons.reverse()


class NativeGff:
    """Flat transcript arrays from the native parser (gffparse.cc);
    structure-equal to GffReader (tests/test_native_gff.py)."""

    __slots__ = ("chroms", "tids", "gids", "gnames", "block_tx", "strand",
                 "exoff", "exl", "exr", "perm")

    def __init__(self):
        self.perm = None  # cached per-block Contig sort order (sidecar)


_gff_bound = False

_SIDECAR_VERSION = 1


def _sidecar_path(path: str) -> str:
    return path + ".sbidx"


def _feature_interleave(g: "NativeGff"):
    """Exon/intron RLE interleave in one numpy shot -> (foff, f_code,
    f_left, f_len, fcnt); foff is the per-transcript feature offset."""
    import numpy as np
    ntx = len(g.exoff) - 1
    exoff, exl, exr = g.exoff, g.exl, g.exr
    k = np.diff(exoff)
    fcnt = np.maximum(2 * k - 1, 0)
    foff = np.zeros(ntx + 1, np.int64)
    np.cumsum(fcnt, out=foff[1:])
    total = int(foff[-1])
    f_code = np.zeros(total, np.int64)
    f_left = np.zeros(total, np.int64)
    f_len = np.zeros(total, np.int64)
    if total:
        tx_of_e = np.repeat(np.arange(ntx), k)
        local = np.arange(len(exl)) - np.repeat(exoff[:-1], k)
        pos = foff[:-1][tx_of_e] + 2 * local
        f_left[pos] = exl
        f_len[pos] = exr - exl + 1
        inner = local < (k[tx_of_e] - 1)  # exon has a following intron
        ip = pos[inner] + 1
        e_idx = np.flatnonzero(inner)
        f_code[ip] = S_INTRON
        f_left[ip] = exr[e_idx] + 1
        f_len[ip] = exl[e_idx + 1] - 1 - exr[e_idx]
    return foff, f_code, f_left, f_len, fcnt


def _block_order(g: "NativeGff", foff, f_left, f_len, b0, b1,
                 cols=None):
    """Tie-resolved within-chromosome Contig::operator< order for the
    transcripts of one parse block: numeric lexsort on the (left, len)
    keys of the first 8 features, Python lexicographic fallback only on
    still-tied runs. Returns global tx indices."""
    import numpy as np
    if cols is None:
        cols = _sort_cols(g, foff, f_left, f_len)
    fo = foff
    bcols = [c[b0:b1] for c in cols]
    sub = np.lexsort(tuple(reversed(bcols))) + b0  # stable
    keys = np.stack(bcols, axis=1)[sub - b0]
    ties = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    bounds = [0] + ties.tolist() + [int(b1 - b0)]
    sub = sub.tolist()
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        if r1 - r0 > 1:
            sub[r0:r1] = sorted(
                sub[r0:r1],
                key=lambda t: list(zip(
                    f_left[fo[t]:fo[t + 1]].tolist(),
                    f_len[fo[t]:fo[t + 1]].tolist())))
    return sub


def _sort_cols(g: "NativeGff", foff, f_left, f_len):
    """Per-transcript numeric sort keys ((left, len) of the first 8
    features, -1 sentinel past the end)."""
    import numpy as np
    cols = []
    for j in range(8):
        validj = foff[:-1] + j < foff[1:]
        idx = np.minimum(foff[:-1] + j, np.maximum(foff[1:] - 1, 0))
        cols.append(np.where(validj, f_left[idx], -1))
        cols.append(np.where(validj, f_len[idx], -1))
    return cols


def _blob(strings: List[str]):
    import numpy as np
    b = ("\n".join(strings) + "\n" if strings else "").encode()
    return np.frombuffer(b, np.uint8)


def _unblob(arr) -> List[str]:
    s = arr.tobytes().decode()
    return s.split("\n")[:-1] if s else []


def _write_sidecar(path: str, g: "NativeGff") -> None:
    """Persist the parsed annotation + per-block Contig sort order next to
    the GTF (cf. samtools' .fai/.bai sidecars). Keyed on (mtime_ns, size);
    repeat runs skip both the text parse and the within-chromosome sort.
    Best-effort: read-only annotation directories simply stay uncached."""
    import os
    import tempfile

    import numpy as np
    st = os.stat(path)
    foff, f_code, f_left, f_len, _fcnt = _feature_interleave(g)
    cols = _sort_cols(g, foff, f_left, f_len)
    nb = len(g.block_tx) - 1
    perm = []
    for b in range(nb):
        b0, b1 = g.block_tx[b], g.block_tx[b + 1]
        if b1 > b0:
            perm.extend(_block_order(g, foff, f_left, f_len, b0, b1,
                                     cols=cols))
    meta = np.array([_SIDECAR_VERSION, st.st_mtime_ns, st.st_size], np.int64)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".sbidx.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, meta=meta, chroms=_blob(g.chroms),
                     tids=_blob(g.tids), gids=_blob(g.gids),
                     gnames=_blob(g.gnames),
                     block_tx=np.asarray(g.block_tx, np.int64),
                     strand=np.asarray(g.strand, np.int8),
                     exoff=g.exoff, exl=g.exl, exr=g.exr,
                     perm=np.asarray(perm, np.int64))
        os.replace(tmp, _sidecar_path(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_sidecar(path: str) -> Optional["NativeGff"]:
    import os

    import numpy as np
    sc = _sidecar_path(path)
    try:
        st = os.stat(path)
        with np.load(sc, allow_pickle=False) as z:
            meta = z["meta"]
            if (meta[0] != _SIDECAR_VERSION or meta[1] != st.st_mtime_ns
                    or meta[2] != st.st_size):
                return None
            g = NativeGff()
            g.chroms = _unblob(z["chroms"])
            g.tids = _unblob(z["tids"])
            g.gids = _unblob(z["gids"])
            g.gnames = _unblob(z["gnames"])
            g.block_tx = z["block_tx"].tolist()
            g.strand = z["strand"].tolist()
            g.exoff = z["exoff"]
            g.exl = z["exl"]
            g.exr = z["exr"]
            g.perm = z["perm"]
            return g
    except Exception:  # corrupt/truncated cache (BadZipFile, ...) -> reparse
        return None


def parse_native(path: str, cache: Optional[bool] = None) -> NativeGff:
    """Parse a GTF/GFF3 with the native parser (same quirks as GffReader).

    Unless STRAWB_GTF_CACHE=0, the parsed arrays and the per-chromosome
    Contig sort order are persisted to a `<path>.sbidx` sidecar (keyed on
    mtime+size, like samtools' .fai): repeat runs and -p shard workers
    load the flat arrays directly instead of re-parsing the text."""
    global _gff_bound
    import ctypes as C
    import os

    import numpy as np

    from .native import get_lib
    if cache is None:
        cache = os.environ.get("STRAWB_GTF_CACHE", "1") != "0"
    if cache:
        g = _load_sidecar(path)
        if g is not None:
            return g
    lib = get_lib()
    if not _gff_bound:
        lib.strawb_gff_parse.restype = C.c_void_p
        lib.strawb_gff_parse.argtypes = [C.c_char_p]
        for name, rt in [("ok", C.c_int32), ("nblocks", C.c_int64),
                         ("ntx", C.c_int64), ("nexons", C.c_int64)]:
            fn = getattr(lib, f"strawb_gff_{name}")
            fn.restype = rt
            fn.argtypes = [C.c_void_p]
        for name in ("chroms", "tids", "gids", "gnames"):
            fn = getattr(lib, f"strawb_gff_{name}")
            fn.restype = C.c_char_p
            fn.argtypes = [C.c_void_p]
        for name, pt in [("blocktx", C.POINTER(C.c_int64)),
                         ("strand", C.POINTER(C.c_int8)),
                         ("exoff", C.POINTER(C.c_int64)),
                         ("exl", C.POINTER(C.c_int64)),
                         ("exr", C.POINTER(C.c_int64))]:
            fn = getattr(lib, f"strawb_gff_{name}")
            fn.restype = pt
            fn.argtypes = [C.c_void_p]
        lib.strawb_gff_free.restype = None
        lib.strawb_gff_free.argtypes = [C.c_void_p]
        _gff_bound = True

    def arr(ptr, n, dt):
        if n == 0:
            return np.zeros(0, dt)
        return np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(dt)

    h = lib.strawb_gff_parse(path.encode())
    try:
        if not lib.strawb_gff_ok(h):
            raise IOError(f"cannot read annotation: {path}")
        g = NativeGff()
        nb = lib.strawb_gff_nblocks(h)
        ntx = lib.strawb_gff_ntx(h)
        nex = lib.strawb_gff_nexons(h)
        g.chroms = lib.strawb_gff_chroms(h).decode().split("\n")[:-1]
        g.tids = lib.strawb_gff_tids(h).decode().split("\n")[:-1]
        g.gids = lib.strawb_gff_gids(h).decode().split("\n")[:-1]
        g.gnames = lib.strawb_gff_gnames(h).decode().split("\n")[:-1]
        g.block_tx = arr(lib.strawb_gff_blocktx(h), nb + 1,
                         np.int64).tolist()
        g.strand = arr(lib.strawb_gff_strand(h), ntx, np.int8).tolist()
        g.exoff = arr(lib.strawb_gff_exoff(h), ntx + 1, np.int64)
        g.exl = arr(lib.strawb_gff_exl(h), nex, np.int64)
        g.exr = arr(lib.strawb_gff_exr(h), nex, np.int64)
        if cache:
            try:
                _write_sidecar(path, g)
            except OSError:
                pass  # read-only annotation dir: stay uncached
        return g
    finally:
        lib.strawb_gff_free(h)


def load_ref_mrnas_native(g: NativeGff, ref_name2id: Dict[str, int],
                          return_flat: bool = False, only_ids=None):
    """load_ref_mrnas over the native parse result. The exon/intron RLE
    interleave is built with numpy in one shot; Python only zips per-
    transcript slices into feature tuples."""
    import numpy as np
    nb = len(g.block_tx) - 1
    if ref_name2id and nb:
        missing = sum(1 for n in g.chroms if n not in ref_name2id)
        if missing == nb:
            raise RuntimeError(
                "gff/gtf and bam have entirely different chromosome naming")
    order = sorted(range(nb), key=lambda b: ref_name2id.get(g.chroms[b], -1))
    foff, f_code, f_left, f_len, fcnt = _feature_interleave(g)
    # feature tuples are NOT materialized here: each transcript gets a
    # lazy FeatView over the shared (code, left, len) arrays, and only
    # the minority of transcripts whose features are actually read (GTF
    # output, tie-breaks) ever build their tuple list
    from ..core.features import FeatView
    fo = foff.tolist()
    # within-chromosome Contig::operator< order: from the sidecar cache
    # when present, else numpy lexsort on the first-8-feature keys with a
    # lexicographic fallback on still-tied runs (_block_order)
    cols = None if g.perm is not None \
        else _sort_cols(g, foff, f_left, f_len)
    result: List[Contig] = []
    chosen: List[int] = []  # tx indices in result order (for the flat)
    for b in order:
        ref_id = ref_name2id.get(g.chroms[b], -1)
        if only_ids is not None and ref_id not in only_ids:
            continue  # shard worker: build only the owned chromosomes
        b0, b1 = g.block_tx[b], g.block_tx[b + 1]
        if b0 == b1:
            continue
        if g.perm is not None:
            sub = g.perm[b0:b1].tolist()
        else:
            sub = _block_order(g, foff, f_left, f_len, b0, b1, cols=cols)
        # hot loop: positional Contig/FeatView construction with locals
        # bound once per block (117k+ transcripts on a real annotation)
        strand, tids, gids, gnames = g.strand, g.tids, g.gids, g.gnames
        ch_app, res_app = chosen.append, result.append
        for t in sub:
            o0, o1 = fo[t], fo[t + 1]
            if o0 == o1:
                continue
            ch_app(t)
            gid = gids[t]
            res_app(Contig(ref_id, strand[t],
                           FeatView(f_code, f_left, f_len, o0, o1),
                           1.0, True, 0, tids[t], gid, gid, gnames[t]))
    if not return_flat:
        return result
    # flat RLE in result order (gathered from the parse-order interleave)
    ch = np.asarray(chosen, np.int64)
    L = fcnt[ch] if len(ch) else np.zeros(0, np.int64)
    off = np.zeros(len(ch) + 1, np.int64)
    np.cumsum(L, out=off[1:])
    starts = foff[:-1][ch] if len(ch) else np.zeros(0, np.int64)
    pos = np.arange(int(off[-1])) + np.repeat(starts - off[:-1], L)
    flat = (off, f_code[pos].astype(np.int8),
            np.ascontiguousarray(f_left[pos]),
            f_len[pos].astype(np.int32))
    return result, flat


def load_ref_mrnas(reader: GffReader, ref_name2id: Dict[str, int]) -> List[Contig]:
    """Sample::loadRefmRNAs (alignments.cpp:837-955): GffTrees -> sorted
    flat list of reference transcript Contigs, ordered by BAM ref id."""
    chroms = list(reader.chroms)
    if ref_name2id:
        missing = sum(1 for c in chroms if c.name not in ref_name2id)
        if missing == len(chroms) and chroms:
            raise RuntimeError(
                "gff/gtf and bam have entirely different chromosome naming")
        chroms.sort(key=lambda c: ref_name2id.get(c.name, -1))
    result: List[Contig] = []
    for c in chroms:
        ref_id = ref_name2id.get(c.name, -1)
        per_chrom: List[Contig] = []
        for t in c.forward + c.reverse + c.unstranded:
            if not t.exons:
                continue
            feats = []
            for e, ex in enumerate(t.exons):
                feats.append((S_MATCH, ex.left, ex.right - ex.left + 1))
                if e + 1 < len(t.exons):
                    nxt = t.exons[e + 1]
                    feats.append((S_INTRON, ex.right + 1,
                                  nxt.left - 1 - ex.right))
            ct = Contig(ref_id=ref_id, strand=t.strand, feats=feats,
                        mass=1.0, is_ref=True, contig_id=0,
                        trans_id=t.transcript_id, parent_id=t.gene_id,
                        ref_gene_id=t.gene_id, ref_gene_name=t.gene_name)
            per_chrom.append(ct)
        per_chrom = sort_contigs(per_chrom)
        result.extend(per_chrom)
    return result
