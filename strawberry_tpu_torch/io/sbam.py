"""Streaming BAM decode (sbam): ctypes binding over the native background
decoder plus a lazy HitTable-compatible facade.

The native side (native/bamdecode.cc, ABI in native/sbam.h) decodes the BAM
on a background pipeline and finalizes one SoA block per hit-bearing
chromosome in file order; every accessor here blocks (GIL released) only
until the data it needs is ready, so pass-1 clustering of chromosome k
overlaps the decode of chromosome k+1. Field semantics are identical to
io.bamreader.load_bam / io.native.load_bam_native (the test suite asserts
block-concat equality against both).

Replaces the reference's rewindable record stream (BAMHitFactory over
samread/bgzf_seek, src/read.cpp:428-478): instead of seeking backwards we
retain finalized chromosome blocks for pass 2 (or, in low-memory mode,
drop them as consumed and re-open the stream for the second pass).
"""
from __future__ import annotations

import ctypes as C
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from .bamreader import HitTable
from .native import get_lib, _Owner, _view, _arr

_bound = False


def _bind(lib):
    global _bound
    if _bound:
        return lib
    lib.strawb_sbam_open.restype = C.c_void_p
    lib.strawb_sbam_open.argtypes = [C.c_char_p] + [C.c_int32] * 8
    lib.strawb_sbam_free.restype = None
    lib.strawb_sbam_free.argtypes = [C.c_void_p]
    lib.strawb_sbam_error.restype = C.c_char_p
    lib.strawb_sbam_error.argtypes = [C.c_void_p]
    lib.strawb_sbam_ref_names.restype = C.c_char_p
    lib.strawb_sbam_ref_names.argtypes = [C.c_void_p]
    lib.strawb_sbam_diag_names.restype = C.c_char_p
    lib.strawb_sbam_diag_names.argtypes = [C.c_void_p]
    for name, ct in [("diag_kinds", C.c_int8), ("diag_rows", C.c_int64)]:
        fn = getattr(lib, f"strawb_sbam_{name}")
        fn.restype = C.POINTER(ct)
        fn.argtypes = [C.c_void_p]
    for name, restype in [
        ("num_refs", C.c_int32), ("hist_size", C.c_int32),
        ("paired", C.c_int32), ("num_hits", C.c_int64),
        ("num_blocks", C.c_int64), ("diag_n", C.c_int64),
    ]:
        fn = getattr(lib, f"strawb_sbam_{name}")
        fn.restype = restype
        fn.argtypes = [C.c_void_p]
    for name, ct in [("ref_lens", C.c_int32), ("hist_len", C.c_int32),
                     ("hist_count", C.c_int32)]:
        fn = getattr(lib, f"strawb_sbam_{name}")
        fn.restype = C.POINTER(ct)
        fn.argtypes = [C.c_void_p]
    for name, restype in [("wait_block", C.c_int32), ("block_chrom", C.c_int32),
                          ("block_n", C.c_int64), ("block_nfeat", C.c_int64)]:
        fn = getattr(lib, f"strawb_sbam_{name}")
        fn.restype = restype
        fn.argtypes = [C.c_void_p, C.c_int64]
    for name, ct in [
        ("block_ref_id", C.c_int32), ("block_left", C.c_int64),
        ("block_right", C.c_int64), ("block_strand", C.c_int8),
        ("block_flag", C.c_uint16), ("block_mate_ref", C.c_int32),
        ("block_mate_pos", C.c_int64), ("block_nh", C.c_int32),
        ("block_read_id", C.c_uint64), ("block_cigar_hash", C.c_uint64),
        ("block_feat_off", C.c_int64), ("block_feat_code", C.c_int8),
        ("block_feat_left", C.c_int64), ("block_feat_len", C.c_int32),
    ]:
        fn = getattr(lib, f"strawb_sbam_{name}")
        fn.restype = C.POINTER(ct)
        fn.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_sbam_drop_block.restype = None
    lib.strawb_sbam_drop_block.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_sbam_set_max_retained.restype = None
    lib.strawb_sbam_set_max_retained.argtypes = [C.c_void_p, C.c_int64]
    lib.strawb_sbam_start.restype = None
    lib.strawb_sbam_start.argtypes = [C.c_void_p]
    lib.strawb_sbam_set_split.restype = None
    lib.strawb_sbam_set_split.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, C.c_int64,
        C.POINTER(C.c_int32), C.POINTER(C.c_int64), C.POINTER(C.c_int64)]
    _bound = True
    return lib


class StreamingHitTable:
    """HitTable-compatible facade over a live sbam stream.

    Metadata accessors block until ready (header / read-length histogram /
    EOF respectively); the hit arrays are reachable per finalized
    chromosome block via block_table(k), not as whole-file arrays.
    """

    def __init__(self, path: str, cfg: Optional[Config] = None,
                 n_threads: int = 0, low_mem: bool = False,
                 split_barriers=None, defer_start: bool = False):
        import os
        cfg = cfg or Config()
        lib = _bind(get_lib())
        if n_threads <= 0:
            # one extra thread over the core count: the decode stages leave
            # short serial gaps that the scheduler fills with cluster work
            n_threads = min(8, (os.cpu_count() or 1) + 1)
        h = lib.strawb_sbam_open(
            path.encode(), cfg.max_intron_length, cfg.min_intron_length,
            1 if cfg.use_only_unique_hits else 0,
            1 if cfg.fr_strand else 0, 1 if cfg.rf_strand else 0,
            cfg.max_read_num_4_rl, cfg.min_map_qual, n_threads)
        if not h:
            raise IOError(f"cannot open BAM: {path}")
        self._lib = lib
        self._owner = _Owner(lib.strawb_sbam_free, h)
        self.handle = h
        self.path = path
        self.low_mem = low_mem
        self._cfg = cfg
        self._n_threads = n_threads
        if low_mem:
            # decode backpressure: stall ahead-of-consumer block production
            # past the retained-SoA cap (2 live blocks always admitted);
            # STRAWB_STREAM_CAP_MB overrides for experiments
            cap_mb = int(os.environ.get("STRAWB_STREAM_CAP_MB", "128"))
            lib.strawb_sbam_set_max_retained(h, cap_mb << 20)
        err = lib.strawb_sbam_error(h)  # header is pre-parsed in open
        if err:
            raise IOError(f"{path}: {err.decode()}")
        self._split_barriers = split_barriers
        self._started = False
        names = lib.strawb_sbam_ref_names(h).decode().split("\n")[:-1]
        self.ref_real_names: List[str] = names
        self.ref_names: List[str] = [x.lower() for x in names]
        self.ref_lens: List[int] = _arr(
            lib.strawb_sbam_ref_lens(h), lib.strawb_sbam_num_refs(h),
            np.int32).tolist()
        self._hist: Optional[Dict[int, int]] = None
        if not defer_start:
            self.start(split_barriers)

    def start(self, split_barriers=None) -> None:
        """Begin record decoding. In low-mem mode this first configures
        sub-chromosome block splitting (barriers = padded merged
        annotation-gene intervals as (chrom i32, left i64, right i64)
        arrays; None = no annotation), so deep single-chromosome inputs
        stay O(window) instead of O(reads/chromosome)."""
        if self._started:
            return
        self._started = True
        if split_barriers is not None:
            self._split_barriers = split_barriers
        if self.low_mem:
            import os
            tgt_mb = int(os.environ.get("STRAWB_SPLIT_MB", "32"))
            if tgt_mb > 0:
                b = self._split_barriers
                if b is None:
                    bc = np.zeros(0, np.int32)
                    bl = np.zeros(0, np.int64)
                    br = np.zeros(0, np.int64)
                else:
                    bc = np.ascontiguousarray(b[0], np.int32)
                    bl = np.ascontiguousarray(b[1], np.int64)
                    br = np.ascontiguousarray(b[2], np.int64)
                self._lib.strawb_sbam_set_split(
                    self.handle, tgt_mb << 20, self._cfg.max_olap_dist,
                    len(bc), bc.ctypes.data_as(C.POINTER(C.c_int32)),
                    bl.ctypes.data_as(C.POINTER(C.c_int64)),
                    br.ctypes.data_as(C.POINTER(C.c_int64)))
        self._lib.strawb_sbam_start(self.handle)

    # -- stream-point accessors ------------------------------------------
    @property
    def read_len_hist(self) -> Dict[int, int]:
        """Blocks until the prerun histogram is final (50k accepted hits
        or EOF)."""
        if self._hist is None:
            lib, h = self._lib, self.handle
            n = lib.strawb_sbam_hist_size(h)
            self._hist = dict(zip(
                _arr(lib.strawb_sbam_hist_len(h), n, np.int32).tolist(),
                _arr(lib.strawb_sbam_hist_count(h), n, np.int32).tolist()))
        return self._hist

    def read_len_mode(self) -> int:
        best_count, mode = 0, 0
        for ln, c in self.read_len_hist.items():
            if c > best_count:
                best_count, mode = c, ln
        return mode

    def is_long_read_sample(self, long_read_len: int = 1000) -> bool:
        count = 0
        for ln in self.read_len_hist:
            if ln > long_read_len:
                count += 1
            if count > 10:
                return True
        return False

    @property
    def paired_end(self) -> bool:
        """Blocks until EOF (only consulted after pass 1 has drained)."""
        return bool(self._lib.strawb_sbam_paired(self.handle))

    def __len__(self):
        """Total accepted hits; blocks until EOF."""
        return int(self._lib.strawb_sbam_num_hits(self.handle))

    @property
    def diag_events(self):
        """-v per-read diagnostics [(row, kind, name), ...] in file order
        (native capture, STRAWB_VERBOSE=1). Call after the stream drained
        — __len__ blocks until EOF first."""
        lib, h = self._lib, self.handle
        len(self)  # barrier: events are complete at EOF
        from .native import _fetch_diag
        return _fetch_diag(lib.strawb_sbam_diag_n(h),
                           lib.strawb_sbam_diag_kinds(h),
                           lib.strawb_sbam_diag_rows(h),
                           lib.strawb_sbam_diag_names(h))

    # -- blocks ------------------------------------------------------------
    def num_blocks(self) -> int:
        """Blocks until EOF."""
        return int(self._lib.strawb_sbam_num_blocks(self.handle))

    def wait_block(self, k: int) -> bool:
        """Block (GIL released) until chromosome block k is finalized.
        False = stream ended before k. Raises on decode error."""
        rc = self._lib.strawb_sbam_wait_block(self.handle, k)
        if rc < 0:
            err = self._lib.strawb_sbam_error(self.handle)
            raise IOError(f"{self.path}: {err.decode() if err else 'decode error'}")
        return rc == 1

    def block_table(self, k: int) -> HitTable:
        """Zero-copy HitTable over finalized block k (one chromosome)."""
        if not self.wait_block(k):
            raise IndexError(k)
        lib, h = self._lib, self.handle
        n = lib.strawb_sbam_block_n(h, k)
        nf = lib.strawb_sbam_block_nfeat(h, k)
        o = self._owner
        return HitTable(
            ref_id=_view(lib.strawb_sbam_block_ref_id(h, k), n, np.int32, o),
            left=_view(lib.strawb_sbam_block_left(h, k), n, np.int64, o),
            right=_view(lib.strawb_sbam_block_right(h, k), n, np.int64, o),
            strand=_view(lib.strawb_sbam_block_strand(h, k), n, np.int8, o),
            flag=_view(lib.strawb_sbam_block_flag(h, k), n, np.uint16, o),
            mate_ref=_view(lib.strawb_sbam_block_mate_ref(h, k), n,
                           np.int32, o),
            mate_pos=_view(lib.strawb_sbam_block_mate_pos(h, k), n,
                           np.int64, o),
            nh=_view(lib.strawb_sbam_block_nh(h, k), n, np.int32, o),
            read_id=_view(lib.strawb_sbam_block_read_id(h, k), n,
                          np.uint64, o),
            cigar_hash=_view(lib.strawb_sbam_block_cigar_hash(h, k), n,
                             np.uint64, o),
            feat_off=_view(lib.strawb_sbam_block_feat_off(h, k), n + 1,
                           np.int64, o),
            feat_code=_view(lib.strawb_sbam_block_feat_code(h, k), nf,
                            np.int8, o),
            feat_left=_view(lib.strawb_sbam_block_feat_left(h, k), nf,
                            np.int64, o),
            feat_len=_view(lib.strawb_sbam_block_feat_len(h, k), nf,
                           np.int32, o),
            ref_names=self.ref_names,
            ref_real_names=self.ref_real_names,
            ref_lens=self.ref_lens,
            read_len_hist=self.read_len_hist,
            paired_end=False,  # per-block view; use the stream's property
        )

    def drop_block(self, k: int):
        """Low-memory mode: release block k's buffers (invalidates any
        block_table(k) views)."""
        self._lib.strawb_sbam_drop_block(self.handle, k)

    def reopen(self) -> "StreamingHitTable":
        """Low-memory pass 2: re-decode the file as a fresh stream (the
        reference's bgzf_seek rewind, src/read.cpp:428-478, re-reads the
        file the same way). Carries the split barriers so pass-2 blocks
        cut at the same cluster-safe boundaries."""
        return StreamingHitTable(self.path, self._cfg, self._n_threads,
                                 self.low_mem,
                                 split_barriers=self._split_barriers)


def open_bam_stream(path: str, config: Optional[Config] = None,
                    n_threads: int = 0, low_mem: bool = False,
                    defer_start: bool = False) -> StreamingHitTable:
    return StreamingHitTable(path, config, n_threads, low_mem,
                             defer_start=defer_start)
