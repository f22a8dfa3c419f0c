"""Device pass-2 quant prep on the GPU: the counterpart of
strawberry_tpu/quant/device_prep.py.

The LocusContext observation model splits into an integer half (read vs
isoform compatibility, exon-segment overlap rows) and a float64 half (bin
grouping, counts, fragment-length weights). The integer half runs on the
card in the hand-written kernel of quant/cuda_prep.py
(csrc/quant_prep.cu); the float64 half stays in the host library
(strawb_quant_finish_batch), so the EM inputs are bit-identical to the
all-host path's.

The host half is copied from the JAX module, whose import runs
utils/jaxsetup: the native binding (`_bind`, `_native_segs`), the
eligibility rules (F_MAX, E_MAX, S_MAX, L_MAX and the tier-fit split, kept
so that the device/host split of the loci equals the JAX package's), the
marshalling and the native finish. What differs:

- The kernel runs on the exact pair, hit and feature counts; nothing is
  padded to the JAX package's static tiers. It takes a tile table too,
  built here with the other per-call inputs (cuda_prep.prep_tiles).
- The isoform tables live on the card for the run (`PrepState.tables`).
- `PrepState` owns a CUDA stream. `build_batch_device` runs on side
  threads (the `pool` and `dev-prep` executors of the pipeline), and the
  EM dispatcher launches on the main thread's default stream; on their
  own stream the prep copies and kernels never wait for queued EM buckets.
- Each thread reuses its pinned staging buffers across calls: the inputs
  go to the card in one copy, the outputs come back in two.
"""
from __future__ import annotations

import ctypes as C
import threading
from typing import List, Optional

import numpy as np
import torch

from .cuda_prep import (E_MAX, F_MAX, I32MAX, ROW_BYTES, S_MAX, PrepInputs,
                        prep_tiles, quant_prep)

L_MAX = 512   # loci per chunk (bigger chunks split)

# The JAX package's padded tiers. Nothing here is padded to them; a chunk
# that exceeds the last tier still splits (or routes to the host) exactly
# as it does there, so both packages send the same loci to the device.
_H_TIERS = (4096, 16384, 65536, 262144)
_NF_TIERS = (16384, 65536, 262144, 1048576)
_P_TIERS = (8192, 65536, 262144, 1048576, 4194304)

_I32MAX = np.int32(I32MAX)

# the kernel's inputs that are marshalled per call (the rest are the
# isoform tables, which live on the device for the run); the tile table
# first, where the one input buffer is 16-byte aligned, as the kernel
# reads it
_PER_CALL = ("tiles", "gcode", "gleft", "glen", "goff", "nf", "pair_base",
             "hit_off", "iso_off", "iso_idx", "ni", "segl", "segr")
_TABLES = ("exl", "exr", "nex", "inl", "inn")


def _tier(x: int, tiers) -> Optional[int]:
    for t in tiers:
        if x <= t:
            return t
    return None


# ---------------------------------------------------------------------------
_bound = False


def _bind(lib):
    global _bound
    if _bound:
        return lib
    from .fastlocus import _bind_quant
    _bind_quant(lib)  # strawb_quant_{binoff,counts,...} accessors
    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    PD = C.POINTER(C.c_double)
    PU8 = C.POINTER(C.c_uint8)
    lib.strawb_quant_segs_batch.restype = C.c_void_p
    lib.strawb_quant_segs_batch.argtypes = [
        C.c_int64, P64, P64, P64, P8, P64, P32]
    for name, rt in [("n", C.c_int64), ("off", P64), ("l", P64), ("r", P64)]:
        fn = getattr(lib, f"strawb_segs_{name}")
        fn.restype = rt
        fn.argtypes = [C.c_void_p]
    lib.strawb_segs_free.restype = None
    lib.strawb_segs_free.argtypes = [C.c_void_p]
    lib.strawb_quant_finish_batch.restype = C.c_void_p
    lib.strawb_quant_finish_batch.argtypes = [
        C.c_int64, P64, P64, P64,
        P64, P8, P64, P32, PD,
        P64, P8, P64, P32, P64,
        PU8, PU8, C.c_int64,
        PD, C.c_int64, C.c_int64, C.c_int64, C.c_int32]
    _bound = True
    return lib


def isoform_tables(ref_flat):
    """The packed isoform tables of the global annotation: (iso_ok (T,)
    bool, exl, exr, nex, inl, inn), numpy int32, the (T, 64) ones padded
    (exr with INT32_MAX, so padded exons never count). iso_ok is False for
    a transcript that does not alternate exon/intron or has more than 64
    exons; its loci route to the host."""
    off, code, left, lens = ref_flat
    T = len(off) - 1
    nfeat = (off[1:] - off[:-1]).astype(np.int64)
    nex = ((nfeat + 1) // 2).astype(np.int32)
    ok = (nfeat > 0) & (nfeat % 2 == 1) & (nex <= E_MAX)
    # verify alternation cheaply: exon features sit at even offsets
    pos = np.arange(len(code), dtype=np.int64)
    start = np.repeat(off[:-1], nfeat)
    is_even = ((pos - start) % 2) == 0
    bad = np.zeros(T, bool)
    mism = (code == 0) != is_even
    if mism.any():
        tid = np.repeat(np.arange(T), nfeat)
        np.logical_or.at(bad, tid[mism], True)
    ok &= ~bad

    exl = np.zeros((T, E_MAX), np.int32)
    exr = np.full((T, E_MAX), _I32MAX, np.int32)
    inl = np.zeros((T, E_MAX), np.int32)
    inn = np.zeros((T, E_MAX), np.int32)
    eidx = np.arange(E_MAX, dtype=np.int64)
    fo = off[:-1, None] + 2 * eidx[None, :]
    emask = eidx[None, :] < nex[:, None]
    focl = np.clip(fo, 0, max(len(code) - 1, 0))
    exl[emask] = left[focl[emask]].astype(np.int32)
    exr[emask] = (left[focl[emask]] + lens[focl[emask]] - 1).astype(np.int32)
    imask = eidx[None, :] < (nex[:, None] - 1)
    ficl = np.clip(fo + 1, 0, max(len(code) - 1, 0))
    inl[imask] = left[ficl[imask]].astype(np.int32)
    inn[imask] = lens[ficl[imask]].astype(np.int32)
    return ok, exl, exr, nex, inl, inn


def tables_to_torch(exl, exr, nex, inl, inn, device) -> dict:
    """The isoform tables (numpy, as `isoform_tables` gives them) as
    contiguous int32 tensors on `device`, keyed as the kernels' inputs."""
    return {k: torch.from_numpy(np.array(a, np.int32)).to(device)
            for k, a in zip(_TABLES, (exl, exr, nex, inl, inn))}


class _Staging:
    """One thread's pinned host buffers, grown on demand and reused across
    calls (a thread waits for its previous call's copies before it makes
    the next one)."""

    def __init__(self):
        self.inputs = torch.empty(0, dtype=torch.int32)
        self.outputs = torch.empty(0, dtype=torch.uint8)

    @staticmethod
    def _grow(buf: torch.Tensor, n: int) -> torch.Tensor:
        if buf.numel() >= n:
            return buf
        return torch.empty(max(n, 2 * buf.numel()), dtype=buf.dtype,
                           pin_memory=True)

    def take(self, n_in: int, n_out: int):
        self.inputs = self._grow(self.inputs, n_in)
        self.outputs = self._grow(self.outputs, n_out)
        return self.inputs[:n_in], self.outputs[:n_out]


class PrepState:
    """Per-run device-prep state: the global isoform tables on the device,
    the global reference flat arrays for the host finish calls, and the
    device's stream."""

    def __init__(self, ref_flat, rexlen: np.ndarray, pdf: np.ndarray,
                 base_lmin: int, read_len: int, long_read: bool):
        from ..utils.torchsetup import device
        self.device = device()  # raises when CUDA is asked for and absent
        off, code, left, lens = ref_flat
        self.ref_flat = (np.ascontiguousarray(off, np.int64),
                         np.ascontiguousarray(code, np.int8),
                         np.ascontiguousarray(left, np.int64),
                         np.ascontiguousarray(lens, np.int32))
        self.rexlen = np.ascontiguousarray(rexlen, np.int64)
        self.pdf = np.ascontiguousarray(pdf, np.float64)
        self.base_lmin = int(base_lmin)
        self.read_len = int(read_len)
        self.long_read = bool(long_read)

        self.iso_ok, *tables = isoform_tables(ref_flat)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self.stream):
                self.tables = tables_to_torch(*tables, self.device)
            self.stream.synchronize()
        else:
            self.tables = tables_to_torch(*tables, self.device)
        self._local = threading.local()
        self.stats = {"device_loci": 0, "host_loci": 0}
        # None = offload every eligible locus ("all" mode); an int makes
        # the pipeline self-pace: one granule of this many (hit x isoform)
        # pairs is in flight on the device at a time (pipeline._flush)
        self.budget_pairs = None

    def staging(self) -> _Staging:
        st = getattr(self._local, "staging", None)
        if st is None:
            st = self._local.staging = _Staging()
        return st


def _native_segs(lib, iso_loc_off: np.ndarray, iso_idx: np.ndarray,
                 ref_flat):
    off, code, left, lens = ref_flat
    P64 = C.POINTER(C.c_int64)
    P8 = C.POINTER(C.c_int8)
    P32 = C.POINTER(C.c_int32)
    h = lib.strawb_quant_segs_batch(
        len(iso_loc_off) - 1,
        iso_loc_off.ctypes.data_as(P64), iso_idx.ctypes.data_as(P64),
        off.ctypes.data_as(P64), code.ctypes.data_as(P8),
        left.ctypes.data_as(P64), lens.ctypes.data_as(P32))
    try:
        nseg = lib.strawb_segs_n(h)
        nloc = len(iso_loc_off) - 1

        def arr(ptr, n):
            if n == 0:
                return np.zeros(0, np.int64)
            return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()

        seg_off = arr(lib.strawb_segs_off(h), nloc + 1)
        seg_l = arr(lib.strawb_segs_l(h), nseg)
        seg_r = arr(lib.strawb_segs_r(h), nseg)
    finally:
        lib.strawb_segs_free(h)
    return seg_off, seg_l, seg_r


def build_batch_device(cfg, read_len, insert_dist, specs, state: PrepState,
                       long_read_sample: bool = False):
    """Device-kernel equivalent of fastlocus.build_batch_native.

    specs: list of (hit_flat, hit_masses, transcripts, iso_flat, ref_ids)
    per locus (ref_ids = GLOBAL annotation indices). Loci that exceed the
    caps route to the host batch, which runs while the device kernels do;
    everything else runs the integer kernels on the device and the f64
    finish on the host. Bit-identical to the all-host path."""
    from ..io.native import get_lib
    from .fastlocus import build_batch_native
    lib = _bind(get_lib())

    nloc = len(specs)
    if nloc > L_MAX:
        out = []
        for i in range(0, nloc, L_MAX):
            out.extend(build_batch_device(cfg, read_len, insert_dist,
                                          specs[i:i + L_MAX], state,
                                          long_read_sample))
        return out

    iso_loc_off = np.zeros(nloc + 1, np.int64)
    for i, s in enumerate(specs):
        iso_loc_off[i + 1] = iso_loc_off[i] + (
            len(s[4]) if s[4] is not None else 0)
    iso_idx = np.ascontiguousarray(np.concatenate(
        [np.asarray(s[4], np.int64) for s in specs if s[4] is not None]
        + [np.zeros(0, np.int64)]), np.int64)
    seg_off, seg_l, seg_r = _native_segs(lib, iso_loc_off, iso_idx,
                                         state.ref_flat)

    nh = np.array([len(s[0][0]) - 1 for s in specs], np.int64)
    ni = iso_loc_off[1:] - iso_loc_off[:-1]
    ns = seg_off[1:] - seg_off[:-1]
    maxf = np.array([int(np.max(s[0][0][1:] - s[0][0][:-1]))
                     if len(s[0][0]) > 1 else 0 for s in specs], np.int64)
    iso_elig = np.array([s[4] is not None and len(s[4]) > 0
                         and bool(state.iso_ok[s[4]].all())
                         for s in specs], bool)
    elig = iso_elig & (ns <= S_MAX) & (maxf <= F_MAX)

    nfeat_per = np.array([int(s[0][0][-1]) for s in specs], np.int64)
    H_total = int(nh[elig].sum())
    P_total = int((nh[elig] * ni[elig]).sum())
    NF_total = int(nfeat_per[elig].sum())
    if (_tier(max(H_total, 1), _H_TIERS) is None
            or _tier(max(P_total, 1), _P_TIERS) is None
            or _tier(max(NF_total, 1), _NF_TIERS) is None):
        if nloc > 1:  # split until tiers fit
            mid = nloc // 2
            return (build_batch_device(cfg, read_len, insert_dist,
                                       specs[:mid], state, long_read_sample)
                    + build_batch_device(cfg, read_len, insert_dist,
                                         specs[mid:], state,
                                         long_read_sample))
        elig[:] = False

    dev_ids = np.nonzero(elig)[0]
    host_ids = np.nonzero(~elig)[0]
    results: List = [None] * nloc
    state.stats["device_loci"] += len(dev_ids)
    state.stats["host_loci"] += len(host_ids)

    fetch = _dispatch_device(cfg, read_len, insert_dist, specs, dev_ids,
                             seg_off, seg_l, seg_r, state, lib,
                             long_read_sample) if len(dev_ids) else None

    if len(host_ids):
        host_out = build_batch_native(
            cfg, read_len, insert_dist,
            [specs[i][:4] for i in host_ids],
            long_read_sample=long_read_sample)
        for i, est in zip(host_ids, host_out):
            results[i] = est

    if fetch is not None:
        for i, est in fetch():
            results[i] = est
    return results


def marshal(hit_loc, h_off, h_code, h_left, h_len, d_iso_off, d_iso_idx,
            pair_base, seg_off, seg_l, seg_r, dev_ids) -> dict:
    """The per-call kernel inputs of the device loci as exact-size numpy
    int32 arrays, keyed as PrepInputs' fields (the isoform tables aside):
    `kern`'s and the tile table (cuda_prep.prep_tiles). The feature
    arrays hold at least one entry (a padded one when the hits have no
    features), as the kernel's index clamps need."""
    nl = len(dev_ids)
    segl = np.full((nl, S_MAX), _I32MAX, np.int32)
    segr = np.full((nl, S_MAX), -1, np.int32)
    for row, i in enumerate(dev_ids):
        a, b = int(seg_off[i]), int(seg_off[i + 1])
        segl[row, :b - a] = seg_l[a:b]
        segr[row, :b - a] = seg_r[a:b]
    gcode, gleft, glen = h_code, h_left, h_len
    if len(h_code) == 0:
        gcode, gleft, glen = [0], [I32MAX], [0]
    i32 = np.int32
    ni = d_iso_off[1:] - d_iso_off[:-1]
    return {"gcode": np.asarray(gcode).astype(i32),
            "gleft": np.asarray(gleft).astype(i32),
            "glen": np.asarray(glen).astype(i32),
            "goff": h_off[:-1].astype(i32),
            "nf": (h_off[1:] - h_off[:-1]).astype(i32),
            "pair_base": pair_base.astype(i32),
            "hit_off": hit_loc.astype(i32),
            "iso_off": d_iso_off.astype(i32),
            "iso_idx": d_iso_idx.astype(i32),
            "ni": ni.astype(i32),
            "segl": segl, "segr": segr,
            "tiles": prep_tiles(hit_loc, ni, pair_base, d_iso_off)}


def launch(state: PrepState, arrays: dict, P: int):
    """Run the kernel on the marshalled arrays; returns a function that
    waits for the results and gives (compat (P,), rows (H, 16)) as numpy
    uint8. On the GPU everything is queued on the state's stream: one copy
    of all inputs from pinned memory, the kernel, and the copies of both
    outputs back into pinned memory."""
    H = len(arrays["goff"])
    if state.device.type == "cpu":
        x = PrepInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                       **state.tables)
        compat, rows = quant_prep(x, P)
        return lambda: (compat.numpy(), rows.numpy())

    sizes = [arrays[k].size for k in _PER_CALL]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    h_in, h_out = state.staging().take(int(offs[-1]), P + H * ROW_BYTES)
    hv = h_in.numpy()
    for k, a, b in zip(_PER_CALL, offs[:-1], offs[1:]):
        hv[a:b] = arrays[k].ravel()
    with torch.cuda.stream(state.stream):
        d_in = torch.empty(h_in.shape, dtype=torch.int32, device=state.device)
        d_in.copy_(h_in, non_blocking=True)
        x = PrepInputs(**{k: d_in[a:b].view(arrays[k].shape)
                          for k, a, b in zip(_PER_CALL, offs[:-1], offs[1:])},
                       **state.tables)
        compat, rows = quant_prep(x, P)
        h_out[:P].copy_(compat, non_blocking=True)
        h_out[P:].copy_(rows.view(-1), non_blocking=True)
        done = torch.cuda.Event()
        done.record(state.stream)

    def wait():
        done.synchronize()
        out = h_out.numpy()
        return out[:P], out[P:].reshape(H, ROW_BYTES)
    return wait


def _dispatch_device(cfg, read_len, insert_dist, specs, dev_ids,
                     seg_off, seg_l, seg_r, state, lib, long_read_sample):
    """Marshal + launch the device kernels for the chosen loci; returns a
    closure that waits for the results and runs the host f64 finish.
    The caller runs the host batch between dispatch and fetch so the
    device and the host cores work concurrently."""
    from .fastlocus import _concat_flats
    dspecs = [specs[i] for i in dev_ids]
    hit_loc, h_off, h_code, h_left, h_len = _concat_flats(
        [s[0] for s in dspecs])
    h_mass = np.ascontiguousarray(
        np.concatenate([np.asarray(s[1], np.float64) for s in dspecs])
        if dspecs else np.zeros(0), np.float64)
    d_iso_off = np.zeros(len(dspecs) + 1, np.int64)
    for i, s in enumerate(dspecs):
        d_iso_off[i + 1] = d_iso_off[i] + len(s[4])
    d_iso_idx = np.ascontiguousarray(np.concatenate(
        [np.asarray(s[4], np.int64) for s in dspecs]), np.int64)

    d_ni = (d_iso_off[1:] - d_iso_off[:-1]).astype(np.int64)
    pair_base = np.zeros(len(dspecs) + 1, np.int64)
    np.cumsum((hit_loc[1:] - hit_loc[:-1]) * d_ni, out=pair_base[1:])
    Pn = int(pair_base[-1])

    wait = launch(state, marshal(hit_loc, h_off, h_code, h_left, h_len,
                                 d_iso_off, d_iso_idx, pair_base, seg_off,
                                 seg_l, seg_r, dev_ids), Pn)

    def fetch():
        compat, rows = wait()
        P64 = C.POINTER(C.c_int64)
        P8 = C.POINTER(C.c_int8)
        P32 = C.POINTER(C.c_int32)
        PD = C.POINTER(C.c_double)
        PU8 = C.POINTER(C.c_uint8)
        off, code, left, lens = state.ref_flat
        q = lib.strawb_quant_finish_batch(
            len(dspecs),
            hit_loc.ctypes.data_as(P64), d_iso_off.ctypes.data_as(P64),
            d_iso_idx.ctypes.data_as(P64),
            h_off.ctypes.data_as(P64), h_code.ctypes.data_as(P8),
            h_left.ctypes.data_as(P64), h_len.ctypes.data_as(P32),
            h_mass.ctypes.data_as(PD),
            off.ctypes.data_as(P64), code.ctypes.data_as(P8),
            left.ctypes.data_as(P64), lens.ctypes.data_as(P32),
            state.rexlen.ctypes.data_as(P64),
            compat.ctypes.data_as(PU8), rows.ctypes.data_as(PU8), ROW_BYTES,
            state.pdf.ctypes.data_as(PD), len(state.pdf),
            state.read_len, state.base_lmin,
            1 if (long_read_sample or state.long_read) else 0)
        try:
            from .fastlocus import build_prebuilt_locus
            total_b = lib.strawb_quant_total_bins(q)
            total_a = lib.strawb_quant_total_alpha(q)

            def arr(ptr, n):
                if n == 0:
                    return np.zeros(0, np.float64)
                return np.ctypeslib.as_array(
                    ptr, shape=(int(n),)).astype(np.float64, copy=True)

            def arr64(ptr, n):
                return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()

            bin_off = arr64(lib.strawb_quant_binoff(q), len(dspecs) + 1)
            alpha_off = arr64(lib.strawb_quant_alphaoff(q), len(dspecs) + 1)
            counts = arr(lib.strawb_quant_counts(q), total_b)
            alpha = arr(lib.strawb_quant_alpha(q), total_a)
        finally:
            lib.strawb_quant_free(q)

        out = []
        for k, i in enumerate(dev_ids):
            s = specs[i]
            exlens = [int(state.rexlen[g]) for g in s[4]]
            b0, b1 = int(bin_off[k]), int(bin_off[k + 1])
            out.append((i, build_prebuilt_locus(
                cfg, read_len, insert_dist, s[2], exlens,
                counts[b0:b1],
                alpha[int(alpha_off[k]):int(alpha_off[k + 1])])))
        return out

    return fetch
