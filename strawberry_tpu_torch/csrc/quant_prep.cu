// Device quant prep, the integer half of the pass-2 observation model, on
// Hopper: read-vs-isoform compatibility and exon-segment overlap rows, in
// one launch a chunk over locus tiles.
//
// Replaces the XLA program strawberry_tpu/quant/device_prep.py::
// _make_kernel.kern (behind STRAWB_DEVICE_PREP=all|budget) and computes
// what it computes, array-equal, on the exact (unpadded) sizes:
//
//   * pair p of locus l is (hit h, isoform iso_idx[iso_off[l] + k]), laid
//     out hit-major: p = pair_base[l] + (h - hit_off[l]) * ni[l] + k;
//   * for each of the hit's features (at most F_MAX = 16; feature 0 is
//     judged even when the hit has none), the candidate exon is the count
//     of the isoform's exon right ends below the feature's left;
//   * a MATCH (code 0) feature, and feature 0 whatever its code, must lie
//     inside its candidate exon, which must exist;
//   * an INTRON (code 1) feature must equal the isoform intron after the
//     exon of the last preceding MATCH (the running maximum of the MATCH
//     candidates, seeded with feature 0's), which must not be the last
//     exon; other codes (gaps) pass;
//   * compat[p] = 1 iff every feature passes;
//   * bit j of rows[h][k] is set iff some MATCH feature of hit h overlaps
//     segment 8k + j of its locus (128 segments, padded with
//     [INT32_MAX, -1], which never overlap).
// Feature ends are left + len - 1 in int32 that wraps, and every index
// is clamped as `kern` clamps it (feature, isoform id, candidate exon,
// cursor). Exon tables pad with INT32_MAX past an isoform's exons
// (device_prep.isoform_tables), so counting over its nex exons is the
// same as counting over all 64, as `kern` does. A candidate exon is only
// needed for feature 0 and MATCH features: an INTRON is judged at the
// cursor and a gap passes, so only those count.
//
// What bounds it on this card: not bytes (the 1M-fragment run's
// main-path chunk, 68,222 pairs and 6,385 hits, moves its inputs and
// outputs in 0.45 us at 3.35 TB/s) nor operations, but latency: a launch
// lasts as long as the launch itself (about 2 us for an empty kernel of
// the same grid, queued back to back) plus its slowest block's chain of
// dependent loads and its longest pair walk. The design:
//   * One launch a chunk, one __global__ function (prep_tile_kernel),
//     writing both outputs.
//   * A block a tile: up to kTileHits consecutive hits of one locus, at
//     most TILE_PAIRS = 128 pairs unless one hit's isoforms are more
//     (quant/cuda_prep.py::prep_tiles builds the table on the host from
//     pair_base, hit_off, ni and iso_off). A tile's pairs are one
//     contiguous run and its hits' rows another, so no thread searches
//     pair_base or hit_off, a locus of 30,000 pairs spreads over many
//     blocks, and a locus with no hits makes no tile. The tile row
//     carries the locus's ni and iso_off, so the longest chain of global
//     loads is three: the tile, iso_idx, the isoform rows.
//   * Each block stages, once, in shared memory: its hits' features (16
//     slots a hit), the locus's 128 segments, and its isoforms' first
//     kStageE entries of exl/exr/inl/inn (16-byte loads; the tables are
//     the annotation's, read again by every tile and chunk, so they stay
//     in L2). Isoforms are staged kIsoRound at a time, e-major with a
//     stride of kIsoRound + 1 words, so the lanes of a warp (consecutive
//     isoforms) read distinct banks; a locus with more isoforms runs in
//     rounds in the same block, whatever its isoform count, and an
//     isoform of more than kStageE exons reads the rest from L1/L2.
//     18.5 KB of shared memory and at most 40 registers a thread let six
//     blocks share an SM.
//   * Threads 0-127 take a pair each: count its candidate exons from
//     shared memory and walk its features as `kern` does. Threads
//     128-255 take a hit's row, 8 lanes a hit, 16 segments a lane, each
//     storing its 2 bytes; both halves run at once, so a block's time is
//     its staging and its longest pair walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFMax = 16;
constexpr int kFStride = kFMax + 1;  // a hit's slots in shared memory: hits
                                     // a warp reads start in other banks
constexpr int kEMax = 64;
constexpr int kSegs = 128;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;   // blocks an SM: at most 40 registers
constexpr int kLanes = 8;       // lanes a hit's row
constexpr int kSpan = kSegs / kLanes;  // segments a lane
constexpr int kStageE = 16;     // exon entries staged an isoform
constexpr int kTileHits = 16;   // hits a tile, at most (prep_tiles' cap);
                                // with 128 pairs (TILE_PAIRS), the pairs
                                // take threads 0-127, the rows 128-255
constexpr int kTileInts = 8;    // locus, first hit, hits, first pair, ni,
                                // iso_off, 0, 0
constexpr int kIsoRound = 32;   // isoforms staged at once
constexpr int kIsoStride = kIsoRound + 1;
constexpr int kI32Max = 0x7fffffff;

struct __align__(16) Feature {
  int code, left, len, right;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 arithmetic that wraps as the reference's does
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned int)a + (unsigned int)b);
}

// The isoform rows of one round in shared memory: entries e < kStageE of
// exl/exr/inl/inn, e-major (entry e of isoform kk at e * kIsoStride + kk),
// and each isoform's global id and exon count; entries past kStageE are
// read from global memory (L1/L2), which only isoforms of more than
// kStageE exons reach.
struct Isoforms {
  int exl[kStageE * kIsoStride], exr[kStageE * kIsoStride],
      inl[kStageE * kIsoStride], inn[kStageE * kIsoStride];
  int id[kIsoRound], nex[kIsoRound];
};

__device__ __forceinline__ int entry(const int* s, const int* __restrict__ g,
                                     int e, int kk, int t) {
  return e < kStageE ? s[e * kIsoStride + kk]
                     : __ldg(g + (size_t)t * kEMax + e);
}

// Stage isoforms k0..k0+kIsoRound-1 of the tile's locus (those below nI)
// as 16-byte loads.
__device__ __forceinline__ void stage_isoforms(
    int k0, int nI, int io, int NI, const int* __restrict__ iso_idx,
    const int* __restrict__ exl, const int* __restrict__ exr,
    const int* __restrict__ nex, const int* __restrict__ inl,
    const int* __restrict__ inn, Isoforms& S) {
  constexpr int kQuads = kStageE / 4;
  const int nk = min(kIsoRound, nI - k0);
  for (int q = threadIdx.x; q < nk * kQuads; q += kThreads) {
    const int kk = q / kQuads, e = (q % kQuads) * 4;
    const int t = iso_idx[clampi(add_wrap(io, k0 + kk), 0, NI - 1)];
    const size_t row = (size_t)t * kEMax + e;
    const int4 v[4] = {*reinterpret_cast<const int4*>(exl + row),
                       *reinterpret_cast<const int4*>(exr + row),
                       *reinterpret_cast<const int4*>(inl + row),
                       *reinterpret_cast<const int4*>(inn + row)};
    if (e == 0) {
      S.id[kk] = t;
      S.nex[kk] = nex[t];
    }
    int* const dst[4] = {S.exl, S.exr, S.inl, S.inn};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      int* const d = dst[a] + e * kIsoStride + kk;
      d[0] = v[a].x;
      d[kIsoStride] = v[a].y;
      d[2 * kIsoStride] = v[a].z;
      d[3 * kIsoStride] = v[a].w;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
prep_tile_kernel(const int* __restrict__ gcode, const int* __restrict__ gleft,
                 const int* __restrict__ glen, const int* __restrict__ goff,
                 const int* __restrict__ nf, const int* __restrict__ exl,
                 const int* __restrict__ exr, const int* __restrict__ nex,
                 const int* __restrict__ inl, const int* __restrict__ inn,
                 const int* __restrict__ iso_idx,
                 const int* __restrict__ segl, const int* __restrict__ segr,
                 const int4* __restrict__ tiles, int NF, int NI,
                 uint8_t* __restrict__ compat, uint8_t* __restrict__ rows) {
  __shared__ Feature sF[kTileHits * kFStride];
  __shared__ int sNf[kTileHits];
  // segment c * kSpan + s at slot s * kLanes + c: the lanes of a hit read
  // adjacent words
  __shared__ int2 sSeg[kSegs];
  __shared__ Isoforms S;

  const int4 ta = tiles[blockIdx.x * (kTileInts / 4)];
  const int4 tb = tiles[blockIdx.x * (kTileInts / 4) + 1];
  const int l = ta.x, h0 = ta.y, n = ta.z, p0 = ta.w;
  const int nI = tb.x, io = tb.y;
  const int tid = threadIdx.x;

  for (int g = tid; g < kSegs; g += kThreads)
    sSeg[(g % kSpan) * kLanes + g / kSpan] = make_int2(
        segl[(size_t)l * kSegs + g], segr[(size_t)l * kSegs + g]);

  // the hits' features; slot 0 of a hit with none is the padding that
  // `kern` judges: (-1, INT32_MAX, 0, INT32_MAX - 1)
  for (int q = tid; q < n * kFMax; q += kThreads) {
    const int i = q / kFMax, f = q % kFMax;
    const int h = h0 + i;
    const int nfh = nf[h];
    if (f == 0) sNf[i] = nfh;
    if (f >= max(min(nfh, kFMax), 1)) continue;
    Feature ft;
    if (f < nfh) {
      const int fi = clampi(add_wrap(goff[h], f), 0, NF - 1);
      ft.code = gcode[fi];
      ft.left = gleft[fi];
      ft.len = glen[fi];
    } else {
      ft.code = -1;
      ft.left = kI32Max;
      ft.len = 0;
    }
    ft.right = add_wrap(add_wrap(ft.left, ft.len), -1);
    sF[i * kFStride + f] = ft;
  }

  stage_isoforms(0, nI, io, NI, iso_idx, exl, exr, nex, inl, inn, S);
  __syncthreads();

  // kLanes lanes a hit, from the block's last thread down (the pairs
  // start at its first): lane c sets bit s of its kSpan / 8 bytes for
  // segment c * kSpan + s (bit j of row byte k is segment 8k + j)
  for (int q = kThreads - 1 - tid; q < n * kLanes; q += kThreads) {
    const int i = q / kLanes, c = q % kLanes;
    const Feature* F = sF + i * kFStride;
    const int nfh = min(sNf[i], kFMax);
    unsigned int bits = 0;
    for (int f = 0; f < nfh; ++f) {
      const Feature ft = F[f];
      if (ft.code != 0) continue;
#pragma unroll
      for (int s = 0; s < kSpan; ++s) {
        const int2 g = sSeg[s * kLanes + c];
        if (ft.left <= g.y && g.x <= ft.right) bits |= 1u << s;
      }
    }
    uint8_t* const out = rows + (size_t)(h0 + i) * (kSegs / 8) +
                         c * (kSpan / 8);
    if constexpr (kSpan == 32)
      *reinterpret_cast<unsigned int*>(out) = bits;
    else if constexpr (kSpan == 16)
      *reinterpret_cast<unsigned short*>(out) = (unsigned short)bits;
    else
      *out = (uint8_t)bits;
  }

  for (int k0 = 0; k0 < nI; k0 += kIsoRound) {
    if (k0 > 0) {  // the next round of isoforms
      __syncthreads();
      stage_isoforms(k0, nI, io, NI, iso_idx, exl, exr, nex, inl, inn, S);
      __syncthreads();
    }
    const int nk = min(kIsoRound, nI - k0);
    // the pairs (hit i, isoform k0 + kk)
    for (int j = tid; j < n * nk; j += kThreads) {
      const int i = j / nk, kk = j - i * nk;
      const Feature* F = sF + i * kFStride;
      const int nfh = sNf[i];
      const int ne = S.nex[kk], t = S.id[kk];
      const int nscan = min(ne, kEMax);
      bool ok = true;
      // the running maximum of the MATCH candidates so far, seeded with
      // feature 0's: the cursor an INTRON is judged at
      int run = 0;
      const int nfeat = min(max(nfh, 1), kFMax);
      for (int f = 0; f < nfeat && ok; ++f) {
        const Feature ft = F[f];
        if (f == 0 || ft.code == 0) {
          int eidx = 0;  // the candidate exon
#pragma unroll 4
          for (int e = 0; e < min(nscan, kStageE); ++e)
            eidx += S.exr[e * kIsoStride + kk] < ft.left;
          for (int e = kStageE; e < nscan; ++e)
            eidx += __ldg(exr + (size_t)t * kEMax + e) < ft.left;
          run = f == 0 ? eidx : max(run, eidx);
          const int ec = clampi(eidx, 0, kEMax - 1);
          ok = eidx < ne && entry(S.exl, exl, ec, kk, t) <= ft.left &&
               entry(S.exr, exr, ec, kk, t) >= ft.right;
        } else if (ft.code == 1) {
          const int mc = clampi(run, 0, kEMax - 1);
          ok = run < add_wrap(ne, -1) && entry(S.inl, inl, mc, kk, t) ==
               ft.left && entry(S.inn, inn, mc, kk, t) == ft.len;
        }
      }
      compat[(size_t)p0 + (size_t)i * nI + k0 + kk] = ok ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Inputs are int32 device arrays, in the order of the XLA program's
// arguments, less the four that the tile table replaces (pair_base,
// hit_off, iso_off, ni): gcode/gleft/glen (NF), goff/nf (H),
// exl/exr/inl/inn (T, 64), nex (T), iso_idx (NI), segl/segr (NL, 128),
// and tiles (NT, 8) built by quant/cuda_prep.py::prep_tiles. tiles and the
// four (T, 64) tables must be 16-byte aligned. Outputs: compat uint8 (P),
// rows uint8 (H, 16), 4-byte aligned. Launches on `stream` of `device`,
// switching to it only when it is not the current device.
int strawb_quant_prep(const void* gcode, const void* gleft, const void* glen,
                      const void* goff, const void* nf, const void* exl,
                      const void* exr, const void* nex, const void* inl,
                      const void* inn, const void* iso_idx, const void* segl,
                      const void* segr, const void* tiles, int P, int NF,
                      int NI, int NT, void* compat, void* rows, int device,
                      void* stream) {
  if (P < 0 || NT < 0 || (NT > 0 && NF <= 0) ||
      (P > 0 && (NT <= 0 || NI <= 0)))
    return cudaErrorInvalidValue;
  if (NT == 0) return cudaSuccess;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  prep_tile_kernel<<<NT, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)gcode, (const int*)gleft, (const int*)glen,
      (const int*)goff, (const int*)nf, (const int*)exl, (const int*)exr,
      (const int*)nex, (const int*)inl, (const int*)inn,
      (const int*)iso_idx, (const int*)segl, (const int*)segr,
      (const int4*)tiles, NF, NI, (uint8_t*)compat, (uint8_t*)rows);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

const char* strawb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
