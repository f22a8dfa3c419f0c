"""Device quant prep's integer kernel: the hand-written CUDA kernel
(csrc/quant_prep.cu) and its plain PyTorch version.

The counterpart of strawberry_tpu/quant/device_prep.py::_make_kernel (the
jitted `kern` behind STRAWB_DEVICE_PREP). The inputs are the same int32
arrays in the same order, but on their exact sizes: the JAX package pads
them to fixed tiers for XLA's static shapes, which changes no output
below the real pair and hit counts. The kernel also takes a tile table
(`prep_tiles`), built on the host beside the other inputs.

- `prep_tiles`: the tile table, a block of the kernel a row: up to
  TILE_HITS consecutive hits of one locus, about TILE_PAIRS pairs.
- `quant_prep_cuda`: the kernel's wrapper (CUDA tensors only).
- `quant_prep_reference`: the plain PyTorch version, a line-for-line
  transcription of `kern` (searchsorted, gather, cummax), run over chunks
  of pairs and hits to bound its (pairs, 16, 64) intermediate. It ignores
  the tile table. The CPU tests run it, and the chip smoke holds the
  kernel against it.
- `quant_prep`: the plain version for CPU tensors, the kernel for CUDA
  tensors. It never falls back from one to the other.

Each returns (compat uint8 (P,), rows uint8 (H, 16)).
"""
from __future__ import annotations

import ctypes as C
from typing import NamedTuple

import numpy as np
import torch

from ..utils.kernels import Entry, stream_handle

F_MAX = 16    # features per hit
E_MAX = 64    # exons per isoform
S_MAX = 128   # disjoint segments per locus
ROW_BYTES = S_MAX // 8
I32MAX = 2**31 - 1
TILE_PAIRS = 128  # pairs a tile, unless one hit's isoforms are more
TILE_HITS = 16    # hits a tile, at most (kTileHits in csrc/quant_prep.cu)
TILE_INTS = 8     # locus, first hit, hits, first pair, ni, iso_off, 0, 0


class PrepInputs(NamedTuple):
    """The kernel's int32 inputs: `kern`'s, in its argument order, then
    the tile table."""
    gcode: torch.Tensor      # (NF,) feature codes (0 MATCH, 1 INTRON)
    gleft: torch.Tensor      # (NF,)
    glen: torch.Tensor       # (NF,)
    goff: torch.Tensor       # (H,) first feature of each hit
    nf: torch.Tensor         # (H,) features of each hit
    exl: torch.Tensor        # (T, 64) isoform exon lefts
    exr: torch.Tensor        # (T, 64) exon rights, padded with INT32_MAX
    nex: torch.Tensor        # (T,) exons per isoform
    inl: torch.Tensor        # (T, 64) intron lefts
    inn: torch.Tensor        # (T, 64) intron lengths
    pair_base: torch.Tensor  # (NL+1,) first pair of each locus
    hit_off: torch.Tensor    # (NL+1,) first hit of each locus
    iso_off: torch.Tensor    # (NL+1,) first iso_idx entry of each locus
    iso_idx: torch.Tensor    # (NI,) global isoform ids
    ni: torch.Tensor         # (NL,) isoforms per locus
    segl: torch.Tensor       # (NL, 128) segment lefts, padded INT32_MAX
    segr: torch.Tensor       # (NL, 128) segment rights, padded -1
    tiles: torch.Tensor      # (NT, 8) prep_tiles' table


def prep_tiles(hit_off, ni, pair_base, iso_off) -> np.ndarray:
    """The kernel's tile table, (NT, TILE_INTS) int32: each locus's hits
    cut, in order, into runs of min(TILE_HITS, TILE_PAIRS // ni) hits (at
    least one). Row: locus l, first hit h0, hit count n, first pair
    pair_base[l] + (h0 - hit_off[l]) * ni[l], then ni[l] and iso_off[l];
    the tile's pairs are the next n * ni[l]. A locus with no hits has no
    tile. The arrays are a chunk's, as device_prep.marshal lays it out."""
    hit_off, ni, pair_base, iso_off = (np.asarray(a, np.int64) for a in (
        hit_off, ni, pair_base, iso_off))
    nh = hit_off[1:] - hit_off[:-1]
    if (nh < 0).any() or (ni < 0).any():
        raise ValueError("hit_off must not decrease, ni must not be < 0")
    per = np.clip(TILE_PAIRS // np.maximum(ni, 1), 1, TILE_HITS)
    nt = -(-nh // per)
    loc = np.repeat(np.arange(len(ni)), nt)
    j = np.arange(len(loc)) - np.repeat(np.cumsum(nt) - nt, nt)
    h0 = hit_off[loc] + j * per[loc]
    tiles = np.zeros((len(loc), TILE_INTS), np.int32)
    tiles[:, 0] = loc
    tiles[:, 1] = h0
    tiles[:, 2] = np.minimum(per[loc], hit_off[loc + 1] - h0)
    tiles[:, 3] = pair_base[loc] + (h0 - hit_off[loc]) * ni[loc]
    tiles[:, 4] = ni[loc]
    tiles[:, 5] = iso_off[loc]
    return tiles


def _hit_features(x: PrepInputs):
    """Per-hit (code, left, len, right) over F_MAX feature slots; slots past
    a hit's features are (-1, INT32_MAX, 0, INT32_MAX - 1)."""
    NF = x.gcode.shape[0]
    ar = torch.arange(F_MAX, dtype=torch.int32, device=x.goff.device)
    fidx = x.goff[:, None] + ar[None, :]
    fmask = ar[None, :] < x.nf[:, None]
    fcl = fidx.clamp(0, NF - 1).long()
    hc = torch.where(fmask, x.gcode[fcl], -1)                   # [H,F]
    hl = torch.where(fmask, x.gleft[fcl], I32MAX)
    hn = torch.where(fmask, x.glen[fcl], 0)
    return hc, hl, hn, hl + hn - 1


def quant_prep_reference(x: PrepInputs, P: int, chunk: int = 1 << 15):
    """Plain PyTorch transcription of `kern` on exact sizes."""
    dev = x.goff.device
    H = x.goff.shape[0]
    NL = x.ni.shape[0]
    NI = x.iso_idx.shape[0]
    hc, hl, hn, hr = _hit_features(x)

    compat = torch.empty(P, dtype=torch.uint8, device=dev)
    for p0 in range(0, P, chunk):
        p = torch.arange(p0, min(P, p0 + chunk), dtype=torch.int32,
                         device=dev)
        # ---- pair decode ------------------------------------------------
        L = (torch.searchsorted(x.pair_base, p, right=True).int() - 1
             ).clamp(0, NL - 1).long()
        off = p - x.pair_base[L]
        nL = x.ni[L].clamp(min=1)
        ph = (x.hit_off[L] + torch.div(off, nL, rounding_mode="floor")
              ).clamp(0, H - 1).long()                            # [P]
        pt = x.iso_idx[(x.iso_off[L] + off % nL).clamp(0, NI - 1).long()
                       ].long()                                   # [P]

        code = hc[ph]                                             # [P,F]
        left = hl[ph]
        right = hr[ph]
        length = hn[ph]
        Exl = x.exl[pt]                                           # [P,E]
        Exr = x.exr[pt]
        Inl = x.inl[pt]
        Inn = x.inn[pt]
        nEx = x.nex[pt]                                           # [P]

        # candidate exon per feature: first exon with right >= feature left
        eidx = (Exr[:, None, :] < left[:, :, None]).sum(
            dim=2, dtype=torch.int32)                             # [P,F]
        ecl = eidx.clamp(0, E_MAX - 1).long()
        exl_g = Exl.gather(1, ecl)
        exr_g = Exr.gather(1, ecl)
        contained = (eidx < nEx[:, None]) & (exl_g <= left) & (exr_g >= right)

        # walk cursor before each feature: exon of the last preceding MATCH
        # (seeded with the first feature's candidate)
        is_match = code == 0
        seeded = torch.where(is_match, eidx, -1)
        seeded[:, 0] = eidx[:, 0]
        mm = torch.cummax(seeded, dim=1).values
        m_before = torch.cat([eidx[:, :1], mm[:, :-1]], dim=1)
        mcl = m_before.clamp(0, E_MAX - 1).long()
        inl_g = Inl.gather(1, mcl)
        inn_g = Inn.gather(1, mcl)
        ok_intron = (m_before < nEx[:, None] - 1) & (inl_g == left) \
            & (inn_g == length)

        okf = torch.where(code == 1, ok_intron,
                          torch.where(is_match, contained, True))
        okf[:, 0] = contained[:, 0]
        compat[p0:p0 + len(p)] = okf.all(dim=1).to(torch.uint8)

    # ---- seg-overlap rows ----------------------------------------------
    rows = torch.empty((H, ROW_BYTES), dtype=torch.uint8, device=dev)
    powers = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    hchunk = max(chunk // 8, 1)
    for h0 in range(0, H, hchunk):
        h1 = min(H, h0 + hchunk)
        hh = torch.arange(h0, h1, dtype=torch.int32, device=dev)
        hloc = (torch.searchsorted(x.hit_off, hh, right=True).int() - 1
                ).clamp(0, NL - 1).long()
        Sl = x.segl[hloc]                                         # [h,S]
        Sr = x.segr[hloc]
        m = hc[h0:h1] == 0
        a, b = hl[h0:h1], hr[h0:h1]
        ov = (m[:, :, None] & (a[:, :, None] <= Sr[:, None, :])
              & (Sl[:, None, :] <= b[:, :, None])).any(dim=1)     # [h,S]
        rows[h0:h1] = (ov.view(h1 - h0, ROW_BYTES, 8).int()
                       * powers).sum(dim=2).to(torch.uint8)
    return compat, rows


def _shapes(x: PrepInputs):
    H, NF, T = x.goff.shape[0], x.gcode.shape[0], x.nex.shape[0]
    NL, NI = x.ni.shape[0], x.iso_idx.shape[0]
    return ((NF,), (NF,), (NF,), (H,), (H,), (T, E_MAX), (T, E_MAX), (T,),
            (T, E_MAX), (T, E_MAX), (NL + 1,), (NL + 1,), (NL + 1,), (NI,),
            (NL,), (NL, S_MAX), (NL, S_MAX), (x.tiles.shape[0], TILE_INTS))


def _check(x: PrepInputs, P: int):
    """Raise ValueError on inputs the kernel does not take: one pass over
    the tensors' shapes, types, devices and contiguity, and the naming of
    the first fault only when there is one."""
    want = _shapes(x)
    i32, dev = torch.int32, x.goff.get_device()
    if not all(t.shape == shape and t.dtype == i32 and t.get_device() == dev
               and t.is_contiguous() for t, shape in zip(x, want)):
        for name, t, shape in zip(PrepInputs._fields, x, want):
            if tuple(t.shape) != shape or t.dtype != i32:
                raise ValueError(f"{name}: expected {shape} int32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.get_device() != dev:
                raise ValueError(f"{name} is on {t.device}, goff on "
                                 f"{x.goff.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    H, NF, NL, NI, NT = (want[3][0], want[0][0], want[14][0], want[13][0],
                         want[-1][0])
    if P < 0 or (P > 0 and min(H, NF, NL, NI, NT) == 0) or \
            (H > 0 and min(NF, NL, NT) == 0):
        raise ValueError(f"P={P} pairs over H={H} hits, NF={NF} features, "
                         f"NL={NL} loci, NI={NI} isoform ids, NT={NT} tiles")
    if max(P, H * ROW_BYTES) >= 2**31:
        raise ValueError(f"P={P}, H={H}: the kernel indexes with int32")
    if any(t.data_ptr() % 16 for t in (x.exl, x.exr, x.inl, x.inn,
                                        x.tiles)):
        raise ValueError("exl, exr, inl, inn and tiles must be 16-byte "
                         "aligned")


def quant_prep_cuda(x: PrepInputs, P: int):
    """Launch csrc/quant_prep.cu (prep_tile_kernel, a block a tile) on
    PyTorch's current stream of the inputs' device; returns (compat,
    rows) without synchronizing. Counts its launches in
    `quant_prep_cuda.launches` and, by `__global__` function, in
    `quant_prep_cuda.function_launches`: one a call with any tile. The C
    side switches device only when the inputs' is not the current one, so
    no device guard is entered, and the stream is the raw handle
    (`utils.kernels.stream_handle`)."""
    if not x.goff.is_cuda:
        raise ValueError(f"quant_prep_cuda needs CUDA tensors, got "
                         f"{x.goff.device}")
    _check(x, P)
    dev = x.goff.device
    H, NT = x.goff.shape[0], x.tiles.shape[0]
    # one allocation: compat, then the rows from the next 16-byte boundary
    rows_at = -(-P // 16) * 16
    out = torch.empty(rows_at + H * ROW_BYTES, dtype=torch.uint8,
                      device=dev)
    compat, rows = out[:P], out[rows_at:].view(H, ROW_BYTES)
    if NT == 0:
        return compat, rows
    _launch(x.gcode.data_ptr(), x.gleft.data_ptr(), x.glen.data_ptr(),
            x.goff.data_ptr(), x.nf.data_ptr(), x.exl.data_ptr(),
            x.exr.data_ptr(), x.nex.data_ptr(), x.inl.data_ptr(),
            x.inn.data_ptr(), x.iso_idx.data_ptr(), x.segl.data_ptr(),
            x.segr.data_ptr(), x.tiles.data_ptr(), P, x.gcode.shape[0],
            x.iso_idx.shape[0], NT, compat.data_ptr(), rows.data_ptr(),
            dev.index, stream_handle(dev.index))
    quant_prep_cuda.launches += 1
    quant_prep_cuda.function_launches["prep_tile_kernel"] += 1
    return compat, rows


quant_prep_cuda.launches = 0
quant_prep_cuda.function_launches = {"prep_tile_kernel": 0}
_launch = Entry("quant_prep", "strawb_quant_prep",
                [C.c_void_p] * 14 + [C.c_int] * 4 + [C.c_void_p] * 2
                + [C.c_int, C.c_void_p])


def quant_prep(x: PrepInputs, P: int):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.goff.device.type == "cpu":
        return quant_prep_reference(x, P)
    return quant_prep_cuda(x, P)
