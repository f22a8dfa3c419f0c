"""Device quant prep's integer kernels: the hand-written CUDA kernels
(csrc/quant_prep.cu) and their plain PyTorch version.

The counterpart of strawberry_tpu/quant/device_prep.py::_make_kernel (the
jitted `kern` behind STRAWB_DEVICE_PREP). The inputs are the same int32
arrays in the same order, but on their exact sizes: the JAX package pads
them to fixed tiers for XLA's static shapes, which changes no output
below the real pair and hit counts.

- `quant_prep_cuda`: the kernels' wrapper (CUDA tensors only).
- `quant_prep_reference`: the plain PyTorch version, a line-for-line
  transcription of `kern` (searchsorted, gather, cummax), run over chunks
  of pairs and hits to bound its (pairs, 16, 64) intermediate. The CPU
  tests run it, and the chip smoke holds the kernels against it.
- `quant_prep`: the plain version for CPU tensors, the kernels for CUDA
  tensors. It never falls back from one to the other.

Each returns (compat uint8 (P,), rows uint8 (H, 16)).
"""
from __future__ import annotations

import ctypes as C
from typing import NamedTuple

import torch

from ..utils.kernels import Entry

F_MAX = 16    # features per hit
E_MAX = 64    # exons per isoform
S_MAX = 128   # disjoint segments per locus
ROW_BYTES = S_MAX // 8
I32MAX = 2**31 - 1


class PrepInputs(NamedTuple):
    """The kernels' int32 inputs, in `kern`'s argument order."""
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


def _check(x: PrepInputs, P: int):
    H = x.goff.shape[0]
    NF = x.gcode.shape[0]
    T = x.nex.shape[0]
    NL = x.ni.shape[0]
    NI = x.iso_idx.shape[0]
    want = {"gcode": (NF,), "gleft": (NF,), "glen": (NF,), "goff": (H,),
            "nf": (H,), "exl": (T, E_MAX), "exr": (T, E_MAX), "nex": (T,),
            "inl": (T, E_MAX), "inn": (T, E_MAX), "pair_base": (NL + 1,),
            "hit_off": (NL + 1,), "iso_off": (NL + 1,), "iso_idx": (NI,),
            "ni": (NL,), "segl": (NL, S_MAX), "segr": (NL, S_MAX)}
    for name, shape in want.items():
        t = getattr(x, name)
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name}: expected {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.goff.device:
            raise ValueError(f"{name} is on {t.device}, goff on "
                             f"{x.goff.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P < 0 or (P > 0 and min(H, NF, NL, NI) == 0) or \
            (H > 0 and min(NF, NL) == 0):
        raise ValueError(f"P={P} pairs over H={H} hits, NF={NF} features, "
                         f"NL={NL} loci, NI={NI} isoform ids")
    if max(P, H * ROW_BYTES) >= 2**31:
        raise ValueError(f"P={P}, H={H}: the kernels index with int32")


def quant_prep_cuda(x: PrepInputs, P: int):
    """Launch csrc/quant_prep.cu (the compat and rows kernels) on
    PyTorch's current stream; returns (compat, rows) without
    synchronizing. Counts its launches in `quant_prep_cuda.launches`, and
    those of each `__global__` function in
    `quant_prep_cuda.function_launches`: compat_kernel where P > 0,
    rows_kernel where H > 0."""
    if not x.goff.is_cuda:
        raise ValueError(f"quant_prep_cuda needs CUDA tensors, got "
                         f"{x.goff.device}")
    _check(x, P)
    H = x.goff.shape[0]
    compat = torch.empty(P, dtype=torch.uint8, device=x.goff.device)
    rows = torch.empty((H, ROW_BYTES), dtype=torch.uint8,
                       device=x.goff.device)
    if P == 0 and H == 0:
        return compat, rows
    with torch.cuda.device(x.goff.device):
        _launch(*[t.data_ptr() for t in x], P, H, x.gcode.shape[0],
                x.ni.shape[0], x.iso_idx.shape[0], compat.data_ptr(),
                rows.data_ptr(), torch.cuda.current_stream().cuda_stream)
    quant_prep_cuda.launches += 1
    quant_prep_cuda.function_launches["compat_kernel"] += P > 0
    quant_prep_cuda.function_launches["rows_kernel"] += H > 0
    return compat, rows


quant_prep_cuda.launches = 0
quant_prep_cuda.function_launches = dict.fromkeys(
    ("compat_kernel", "rows_kernel"), 0)
_launch = Entry("quant_prep", "strawb_quant_prep",
                [C.c_void_p] * 17 + [C.c_int] * 5 + [C.c_void_p] * 3)


def quant_prep(x: PrepInputs, P: int):
    """The plain version for CPU tensors, the kernels for CUDA tensors."""
    if x.goff.device.type == "cpu":
        return quant_prep_reference(x, P)
    return quant_prep_cuda(x, P)
