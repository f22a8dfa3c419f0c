// Device quant prep, the integer half of the pass-2 observation model, on
// Hopper: read-vs-isoform compatibility and exon-segment overlap rows.
//
// Replaces the XLA program strawberry_tpu/quant/device_prep.py::
// _make_kernel.kern (behind STRAWB_DEVICE_PREP=all|budget) and computes
// what it computes, array-equal, on the exact (unpadded) sizes:
//
//   compat_kernel, one thread per (hit, isoform) pair p:
//     * the pair's locus is the last l with pair_base[l] <= p; within it,
//       hit = hit_off[l] + off / ni[l], isoform = iso_idx[iso_off[l] +
//       off % ni[l]];
//     * for each of the hit's features (at most F_MAX = 16; feature 0 is
//       judged even when the hit has none), the candidate exon is the
//       count of the isoform's exon right ends below the feature's left;
//     * a MATCH (code 0) feature, and feature 0 whatever its code, must lie
//       inside its candidate exon, which must exist;
//     * an INTRON (code 1) feature must equal the isoform intron after the
//       exon of the last preceding MATCH (the running maximum of the MATCH
//       candidates, seeded with feature 0's), which must not be the last
//       exon; other codes (gaps) pass;
//     * compat[p] = 1 iff every feature passes.
//   rows_kernel, one thread per (hit, output byte): bit j of rows[h][k] is
//     set iff some MATCH feature of hit h overlaps segment 8k + j of its
//     locus (128 segments, padded with [INT32_MAX, -1], which never
//     overlap).
//
// The XLA program materializes a (pairs, 16, 64) comparison tensor, which
// at its top pair tier is 4.3 GB; here each thread counts its candidate
// exons in registers. What bounds it on this card: the gathers, not
// arithmetic. A pair reads its hit's features (at most 16 x 3 int32) and
// up to 4 rows of 64 int32 of its isoform's tables, which repeat across
// the pairs of a locus and stay in L1/L2; the loop over features stops at
// the first failure. Exon tables pad with INT32_MAX, so counting over the
// isoform's exons only is the same as counting over all 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFMax = 16;
constexpr int kEMax = 64;
constexpr int kSegs = 128;
constexpr int kRowBytes = kSegs / 8;
constexpr int kThreads = 256;
constexpr int kI32Max = 0x7fffffff;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The last l in [0, n) with base[l] <= x (base has n + 1 sorted entries),
// clamped to [0, n - 1]: searchsorted(base, x, side="right") - 1.
__device__ __forceinline__ int locus_of(const int* __restrict__ base, int n,
                                        int x) {
  int lo = 0, hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (base[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return clampi(lo - 1, 0, n - 1);
}

// int32 arithmetic that wraps as the reference's does
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned int)a + (unsigned int)b);
}

__global__ void __launch_bounds__(kThreads)
compat_kernel(const int* __restrict__ gcode, const int* __restrict__ gleft,
              const int* __restrict__ glen, const int* __restrict__ goff,
              const int* __restrict__ nf, const int* __restrict__ exl,
              const int* __restrict__ exr, const int* __restrict__ nex,
              const int* __restrict__ inl, const int* __restrict__ inn,
              const int* __restrict__ pair_base,
              const int* __restrict__ hit_off,
              const int* __restrict__ iso_off,
              const int* __restrict__ iso_idx, const int* __restrict__ ni,
              int P, int H, int NF, int NL, int NI,
              uint8_t* __restrict__ compat) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int l = locus_of(pair_base, NL, p);
  const int off = p - pair_base[l];
  const int nL = max(ni[l], 1);
  const int h = clampi(hit_off[l] + off / nL, 0, H - 1);
  const int t = iso_idx[clampi(iso_off[l] + off % nL, 0, NI - 1)];

  const int n = nf[h];
  const int g0 = goff[h];
  const int ne = nex[t];
  const int nscan = min(ne, kEMax);
  const int* El = exl + (size_t)t * kEMax;
  const int* Er = exr + (size_t)t * kEMax;
  const int* Il = inl + (size_t)t * kEMax;
  const int* In = inn + (size_t)t * kEMax;

  bool ok = true;
  int run = 0;  // running maximum of the MATCH candidates so far
  const int nfeat = min(max(n, 1), kFMax);
  for (int f = 0; f < nfeat && ok; ++f) {
    const bool real = f < n;
    const int fi = clampi(g0 + f, 0, NF - 1);
    const int code = real ? gcode[fi] : -1;
    const int left = real ? gleft[fi] : kI32Max;
    const int len = real ? glen[fi] : 0;
    const int right = add_wrap(add_wrap(left, len), -1);

    int eidx = 0;
    for (int e = 0; e < nscan; ++e) eidx += Er[e] < left;

    const int m_before = f == 0 ? eidx : run;
    if (f == 0)
      run = eidx;
    else if (code == 0)
      run = max(run, eidx);

    if (f == 0 || code == 0) {
      const int ec = clampi(eidx, 0, kEMax - 1);
      ok = eidx < ne && El[ec] <= left && Er[ec] >= right;
    } else if (code == 1) {
      const int mc = clampi(m_before, 0, kEMax - 1);
      ok = m_before < ne - 1 && Il[mc] == left && In[mc] == len;
    }
  }
  compat[p] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ gcode, const int* __restrict__ gleft,
            const int* __restrict__ glen, const int* __restrict__ goff,
            const int* __restrict__ nf, const int* __restrict__ hit_off,
            const int* __restrict__ segl, const int* __restrict__ segr,
            int H, int NF, int NL, uint8_t* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * kRowBytes) return;
  const int h = i / kRowBytes;
  const int k = i % kRowBytes;
  const int l = locus_of(hit_off, NL, h);
  const int* Sl = segl + (size_t)l * kSegs + 8 * k;
  const int* Sr = segr + (size_t)l * kSegs + 8 * k;
  int sl[8], sr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sl[j] = Sl[j];
    sr[j] = Sr[j];
  }
  const int n = min(nf[h], kFMax);
  const int g0 = goff[h];
  unsigned int bits = 0;
  for (int f = 0; f < n; ++f) {
    const int fi = clampi(g0 + f, 0, NF - 1);
    if (gcode[fi] != 0) continue;
    const int left = gleft[fi];
    const int right = add_wrap(add_wrap(left, glen[fi]), -1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (left <= sr[j] && sl[j] <= right) bits |= 1u << j;
  }
  rows[i] = (uint8_t)bits;
}

}  // namespace

extern "C" {

// Inputs are int32 device arrays, in the order of the XLA program's
// arguments: gcode/gleft/glen (NF), goff/nf (H), exl/exr/inl/inn (T, 64),
// nex (T), pair_base/hit_off/iso_off (NL + 1), iso_idx (NI), ni (NL),
// segl/segr (NL, 128). Outputs: compat uint8 (P), rows uint8 (H, 16).
int strawb_quant_prep(const void* gcode, const void* gleft, const void* glen,
                      const void* goff, const void* nf, const void* exl,
                      const void* exr, const void* nex, const void* inl,
                      const void* inn, const void* pair_base,
                      const void* hit_off, const void* iso_off,
                      const void* iso_idx, const void* ni, const void* segl,
                      const void* segr, int P, int H, int NF, int NL, int NI,
                      void* compat, void* rows, void* stream) {
  if (P < 0 || H < 0) return cudaErrorInvalidValue;
  if (P > 0 && (H <= 0 || NF <= 0 || NL <= 0 || NI <= 0))
    return cudaErrorInvalidValue;
  if (H > 0 && (NF <= 0 || NL <= 0)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P > 0)
    compat_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int*)gcode, (const int*)gleft, (const int*)glen,
        (const int*)goff, (const int*)nf, (const int*)exl, (const int*)exr,
        (const int*)nex, (const int*)inl, (const int*)inn,
        (const int*)pair_base, (const int*)hit_off, (const int*)iso_off,
        (const int*)iso_idx, (const int*)ni, P, H, NF, NL, NI,
        (uint8_t*)compat);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (H > 0) {
    const int n = H * kRowBytes;
    rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int*)gcode, (const int*)gleft, (const int*)glen,
        (const int*)goff, (const int*)nf, (const int*)hit_off,
        (const int*)segl, (const int*)segr, H, NF, NL, (uint8_t*)rows);
  }
  return cudaGetLastError();
}

const char* strawb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
