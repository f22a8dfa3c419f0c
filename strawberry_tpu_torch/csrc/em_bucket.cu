// Batched latent-class EM for one padded tier bucket of loci, on Hopper.
//
// Replaces the f32 Pallas kernel strawberry_tpu/quant/pallas_em.py::_em_kernel
// (behind --fast-em) and the f64 XLA loop strawberry_tpu/quant/device.py::
// _em_bucket (behind STRAWB_DEVICE_EM=1): one source, templated on float and
// double, computes what both compute.
//
// Per locus b (inputs F (B,R,C), u (B,R), theta0 (B,C), valid (B,R),
// active (B)):
//   * F's columns are normalized once; all-zero columns stay zero.
//   * Iteration 1 runs on the raw F, later iterations on the normalized F.
//   * E-step: denom_r = sum_c F_rc theta_c; M-step:
//     theta'_c = sum_r valid_r u_r F_rc theta_c / denom_r.
//   * A zero denominator on a valid row fails the locus: theta = theta0.
//   * sqrt(sum_c (theta'_c - theta_c)^2) < 1e-2 stops with the PREVIOUS
//     theta; otherwise theta = theta' and at most max_iter advances run.
//   * Inactive (padding) loci return theta0, not failed.
// Column normalization is folded into theta (F_norm theta = F (theta /
// colsum)), so F is never rewritten.
//
// What bounds it on this card. Per iteration a locus does about 4 R C
// operations (two multiply-adds per element of F: the denominators and the
// column sums) and moves nothing new: F, u and theta0 are read once per
// locus. At the tier shapes that is 512 operations an iteration (tier 0,
// 32 x 4), 4 K (tier 1, 128 x 8), 64 K (tier 2, 512 x 32) and 1 M (tier 3,
// 2048 x 128), and up to 1,000 iterations run one after another. A whole
// tier-2 bucket of 16 loci capped at 1,000 iterations is 1 G operations,
// 16 us at 67 TFLOP/s (f32), against 1 MB of f32 F read once, 0.3 us at
// 3.35 TB/s; tier 3 (8 loci) is 8 G operations, 125 us. So no tier is
// bound by bytes, and none comes near the operation bound either: an
// iteration is a chain of dependent steps (denominators, a division, the
// column sums across threads, the convergence test) on the few SMs that
// hold a locus, so what bounds every tier is the latency of one iteration
// times the iterations of the bucket's slowest locus.
//
// What the design does about it, per tier:
//   * Every tier works on the locus' own extent: rows up to the last row
//     that is valid or holds a nonzero weight, columns up to the last column
//     where F or theta0 is nonzero (a column with zero F still moves theta).
//     Both are found while F is staged; padding adds exact zeros, so the
//     answer is unchanged.
//   * Tiers 0-1 (R <= 128, C <= 8), em_warp_kernel: one warp per locus and
//     four loci per CTA, no barrier and no shared memory. A lane holds rows
//     lane, lane + 32, ... of F in registers, staged once with 16-byte
//     loads; a row's denominator is a dot product in the lane; the column
//     sums are a transposed sum over the lanes (halving xor levels, then
//     butterflies), so lane l keeps column l % C and every lane of a column
//     holds the same bits; theta' and the distance need no broadcast.
//   * Tier 2 (R <= 512, C <= 32), em_rows_kernel: one CTA of 512 threads
//     per locus, thread r holding row r of F in registers. The E-step is a
//     dot product in the thread against the warp's copy of the scaled theta;
//     the M-step's column partials are a transposed sum over the warp's
//     lanes (lane c gets column c; 31 shuffles, or 16 or 9 when the column
//     extent is at most 16 or 8); every warp sums the 16 warps' partials
//     in a fixed tree itself. One CTA barrier an iteration, with the
//     zero-denominator flag OR-ed into it (__syncthreads_or).
//   * Tier 3 (larger), em_strip_kernel: a thread block cluster of S CTAs per
//     locus (cudaLaunchKernelEx), each holding a strip of rows of F in
//     shared memory, staged once with coalesced 16-byte loads, at a row
//     stride of C + 1 elements so that a warp reading 32 rows at one column,
//     or one row at 32 columns, touches 32 distinct banks. S leaves each CTA
//     at most 16 K elements of F: 16 at 2048 x 128 (a non-portable cluster
//     size), 72 KB a CTA in f32, 144 KB in f64. A bucket whose strips do not
//     fit in shared memory even at 16 CTAs is refused with an error (the
//     dispatcher's largest tier fits). The E-step gives each thread
//     one row; the column partials go to row groups of threads, one column
//     each, combined in group order. Each CTA publishes its partials and its
//     zero-denominator flag in a double-buffered exchange array; after one
//     cluster.sync() an iteration every CTA reads all strips' partials
//     through distributed shared memory (map_shared_rank) and sums them in
//     rank order, so every CTA computes the same theta' and takes the same
//     convergence decision with no broadcast. A final cluster.sync() keeps
//     every CTA alive while another may still read its shared memory.
//   * Every reduction runs in a fixed order and uses no atomics, so the f64
//     kernel repeats bit for bit. The host never synchronizes inside the
//     loop. Each locus stops on its own; the Pallas kernel steps a whole
//     tile until its slowest locus is done, and freezes the finished ones,
//     so the answers are the same.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpLoci = 4;         // loci (one warp each) per CTA, tiers 0-1
constexpr int kStripThreads = 512;   // threads per CTA, tiers 2-3
constexpr int kStripWarps = kStripThreads / 32;
constexpr int kMaxGroups = 32;       // row groups of a column sum, at most
constexpr int kRowsMax = 512;        // rows of a locus, tier 2
constexpr size_t kStripElems = 16384;  // elements of F a CTA, tier 3

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // x_i + x_(i^m) and x_(i^m) + x_i are the same IEEE sum, so every lane
  // ends with the same bits
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// sum_c row[c] x[c] over c < n, with four running sums
template <typename T>
__device__ __forceinline__ T row_dot(const T* row, const T* x, int n) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int c = 0;
#pragma unroll 2
  for (; c + 4 <= n; c += 4) {
    a0 += row[c] * x[c];
    a1 += row[c + 1] * x[c + 1];
    a2 += row[c + 2] * x[c + 2];
    a3 += row[c + 3] * x[c + 3];
  }
  for (; c < n; ++c) a0 += row[c] * x[c];
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ void ld16(const float* p, float* d) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void ld16(const double* p, double* d) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  d[0] = v.x;
  d[1] = v.y;
}

// the same from shared memory
__device__ __forceinline__ void lds16(const float* p, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void lds16(const double* p, double* d) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  d[0] = v.x;
  d[1] = v.y;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ inline size_t carve(size_t* at, size_t bytes) {
  const size_t here = *at;
  *at = (here + bytes + 15) & ~size_t(15);
  return here;
}

// One halving level of a transposed warp sum: a lane keeps the half of p
// whose index has bit M equal to its lane's and adds its xor-M partner's.
template <int M, typename T>
__device__ __forceinline__ void fold_level(T* p, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T send = up ? p[i] : p[i + M];
    const T keep = up ? p[i + M] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, M);
  }
}

// Sum over the warp's lanes of 32 values a lane (column c's from val(c)),
// transposed: lane c ends with column c's sum. Five halving levels of xor
// shuffles, 31 in all, each in a fixed order; the first level asks val for
// its values, so no array of 32 products is ever live.
template <typename T, typename Val>
__device__ __forceinline__ T transpose_sum(Val val, int lane) {
  T p[16];
  const bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const T lo = val(i), hi = val(i + 16);
    p[i] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, 16);
  }
  fold_level<8>(p, lane);
  fold_level<4>(p, lane);
  fold_level<2>(p, lane);
  fold_level<1>(p, lane);
  return p[0];
}

// The same over CM <= 32 values a lane: lane l gets column l % CM. Halving
// levels over the low lane bits, then butterflies over the others, which
// leave the same bits in every lane of a column.
template <typename T, int CM, typename Val>
__device__ __forceinline__ T column_sums(Val val, int lane) {
  T p[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) p[c] = val(c);
  if constexpr (CM >= 16) fold_level<8>(p, lane);
  if constexpr (CM >= 8) fold_level<4>(p, lane);
  if constexpr (CM >= 4) fold_level<2>(p, lane);
  if constexpr (CM >= 2) fold_level<1>(p, lane);
  T sum = p[0];
#pragma unroll
  for (int m = CM; m < 32; m <<= 1) sum += __shfl_xor_sync(kFull, sum, m);
  return sum;
}

// x[0][lane] + ... + x[N - 1][lane] as a balanced tree: a fixed order,
// log2 N additions deep.
template <int N, typename T>
__device__ __forceinline__ T tree_sum(const T (*x)[32], int lane) {
  if constexpr (N == 1)
    return x[0][lane];
  else
    return tree_sum<N / 2>(x, lane) + tree_sum<N / 2>(x + N / 2, lane);
}

// ------------------------------------------------------------ tiers 0-1
// One warp per locus: lane l holds rows l + 32 k (k < RPL) of F, CM >= C
// columns, in registers.
template <typename T, int CM, int RPL>
__global__ void __launch_bounds__(32 * kWarpLoci)
em_warp_kernel(const T* __restrict__ F, const T* __restrict__ u,
               const T* __restrict__ theta0, const bool* __restrict__ valid,
               const bool* __restrict__ active, T* __restrict__ theta_out,
               bool* __restrict__ failed_out, int B, int R, int C,
               int max_iter) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpLoci + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const T* t0 = theta0 + (size_t)b * C;
  T* out = theta_out + (size_t)b * C;
  if (!active[b]) {
    for (int c = lane; c < C; c += 32) out[c] = t0[c];
    if (lane == 0) failed_out[b] = false;
    return;
  }

  // stage this lane's rows; find the locus' extents
  const T* Fb = F + (size_t)b * R * C;
  const bool vec = C == CM && aligned16(Fb);
  T f[RPL][CM];
  T uu[RPL];
  bool vv[RPL];
  int last_row = -1;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane + 32 * k;
    const bool in = r < R;
    const T* row = Fb + (size_t)r * C;
    if (in && vec) {
#pragma unroll
      for (int j = 0; j < CM; j += V) ld16(row + j, &f[k][j]);
    } else {
#pragma unroll
      for (int c = 0; c < CM; ++c) f[k][c] = in && c < C ? row[c] : T(0);
    }
    uu[k] = in ? u[(size_t)b * R + r] : T(0);
    vv[k] = in && valid[(size_t)b * R + r];
    bool keep = vv[k];
#pragma unroll
    for (int c = 0; c < CM; ++c) keep |= f[k][c] != T(0);
    if (keep) last_row = r;
  }
  const int nk = (__reduce_max_sync(kFull, last_row) + 32) / 32;  // row slabs

  // lane l keeps column l % CM: theta and the column sum of the raw F
  const int cl = lane & (CM - 1);
  const T th0 = cl < C ? t0[cl] : T(0);
  const T cs = column_sums<T, CM>([&](int c) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      if (k < nk) s += f[k][c];
    return s;
  }, lane);

  T th = th0;
  bool failed = false;
  for (int it = 0;;) {
    // theta scaled for this iteration (the raw F's first: theta itself),
    // each lane its column's, then every lane all CM of them
    const T q = it == 0 ? th : (cs != T(0) ? th / cs : T(0));
    T thn[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c) thn[c] = __shfl_sync(kFull, q, c);

    bool zero = false;
    T rs[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      rs[k] = T(0);
      if (k < nk) {
        T d = T(0);
#pragma unroll
        for (int c = 0; c < CM; ++c) d += f[k][c] * thn[c];
        zero |= vv[k] && d == T(0);
        rs[k] = (vv[k] && d != T(0)) ? uu[k] / d : T(0);
      }
    }
    if (__any_sync(kFull, zero)) {  // a valid row lost all its mass
      th = th0;
      failed = true;
      break;
    }

    const T nx = q * column_sums<T, CM>([&](int c) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        if (k < nk) s += rs[k] * f[k][c];
      return s;
    }, lane);
    // the distance over the CM columns of a lane group: the same bits in
    // every lane
    const T dc = nx - th;
    T d2 = dc * dc;
#pragma unroll
    for (int m = 1; m < CM; m <<= 1) d2 += __shfl_xor_sync(kFull, d2, m);
    if (sqrt(d2) < T(1e-2)) break;  // keep the previous theta
    th = nx;
    if (++it >= max_iter) break;
  }
  if (lane < C) out[lane] = th;  // lane c < CM keeps column c
  if (lane == 0) failed_out[b] = failed;
}

// ------------------------------------------------------------ tier 2
// One CTA of kRowsMax threads per locus, C <= 32 and R <= kRowsMax: thread
// r holds row r of F in registers. The E-step is a dot product in the
// thread; the M-step's column partials are a transposed sum over the warp's
// lanes (lane c gets column c), then the warps' partials in a fixed tree,
// which every warp reads itself, so theta' and the convergence decision
// need no broadcast and an iteration has one CTA barrier. A warp none of
// whose rows is valid or weighted (past the row extent) skips both steps;
// the E-step stops at the column extent.
template <typename T>
__global__ void __launch_bounds__(kRowsMax)
em_rows_kernel(const T* __restrict__ F, const T* __restrict__ u,
               const T* __restrict__ theta0, const bool* __restrict__ valid,
               const bool* __restrict__ active, T* __restrict__ theta_out,
               bool* __restrict__ failed_out, int R, int C, int max_iter) {
  constexpr int NW = kRowsMax / 32;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) T part[2][NW][32];  // double-buffered partials
  __shared__ __align__(16) T thn_s[NW][32];    // each warp its own copy
  __shared__ int wcol[NW];
  const int b = blockIdx.x, r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const T* t0 = theta0 + (size_t)b * C;
  T* out = theta_out + (size_t)b * C;
  if (!active[b]) {
    if (r < C) out[r] = t0[r];
    if (r == 0) failed_out[b] = false;
    return;
  }

  // stage this thread's row; find the locus' extents
  const bool in = r < R;
  const T* row = F + ((size_t)b * R + r) * C;
  T f[32];
  if (in && C == 32 && aligned16(F + (size_t)b * R * C)) {
#pragma unroll
    for (int j = 0; j < 32; j += V) ld16(row + j, &f[j]);
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) f[c] = in && c < C ? row[c] : T(0);
  }
  const T ur = in ? u[(size_t)b * R + r] : T(0);
  const bool vr = in && valid[(size_t)b * R + r];
  bool live = vr;
  int last_col = -1;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (f[c] != T(0)) {
      live = true;
      last_col = c;
    }
  }
  const T th0 = lane < C ? t0[lane] : T(0);
  if (th0 != T(0)) last_col = max(last_col, lane);
  live = __any_sync(kFull, live);
  last_col = __reduce_max_sync(kFull, last_col);

  // column sums of the raw F (lane c: column c), and the column extent
  part[0][warp][lane] =
      live ? transpose_sum<T>([&](int c) { return f[c]; }, lane) : T(0);
  if (lane == 0) wcol[warp] = last_col;
  __syncthreads();
  const T cs = tree_sum<NW>(part[0], lane);
  int ce = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) ce = max(ce, wcol[w] + 1);

  // iterate: lane c keeps theta_c and the scaled theta_c (the raw F's
  // first: theta itself); iteration i writes partials to buffer (i + 1) & 1
  T th = th0, tn = th0;
  T* tw = thn_s[warp];
  bool failed = false;
  for (int it = 0;;) {
    tw[lane] = tn;
    __syncwarp();
    int zero = 0;
    T acc = T(0);
    if (live) {
      T a[4] = {T(0), T(0), T(0), T(0)};  // E-step: this thread's row
#pragma unroll
      for (int c = 0; c < 32; c += V) {
        if (c < ce) {
          T tv[V];
          lds16(tw + c, tv);
#pragma unroll
          for (int j = 0; j < V; ++j) a[(c + j) & 3] += f[c + j] * tv[j];
        }
      }
      const T d = (a[0] + a[1]) + (a[2] + a[3]);
      zero = vr && d == T(0);
      const T rs = (vr && d != T(0)) ? ur / d : T(0);
      // M-step: the warp's column partials, over the fewest of 8, 16 or
      // 32 columns that cover the extent (lane c gets column c)
      // (every lane takes part in the shuffles; lanes past them keep 0)
      const auto val = [&](int c) { return rs * f[c]; };
      if (ce <= 8) {
        acc = column_sums<T, 8>(val, lane);
        if (lane >= 8) acc = T(0);
      } else if (ce <= 16) {
        acc = column_sums<T, 16>(val, lane);
        if (lane >= 16) acc = T(0);
      } else {
        acc = transpose_sum<T>(val, lane);
      }
    }
    T(*p)[32] = part[(it + 1) & 1];
    p[warp][lane] = acc;
    if (__syncthreads_or(zero)) {  // a valid row lost all its mass
      th = th0;
      failed = true;
      break;
    }
    const T nx = tree_sum<NW>(p, lane) * tn;
    const T dc = nx - th;
    if (sqrt(warp_sum(dc * dc)) < T(1e-2)) break;  // keep the previous theta
    th = nx;
    tn = cs != T(0) ? th / cs : T(0);
    if (++it >= max_iter) break;
  }
  if (warp == 0) {
    if (lane < C) out[lane] = th;
    if (lane == 0) failed_out[b] = failed;
  }
}

// ------------------------------------------------------------ tier 3
// Stage a row-major (nr, C) tile of F into Fs at stride C + 1 (16-byte
// loads where aligned), u and valid of every row into us and vs. Returns
// the tile's row extent (1 + the last row that is valid or weighted) and
// column extent (1 + the last column that is weighted, or nonzero in
// theta0) to every thread; theta0's C values are copied into theta. Ends
// with a barrier.
template <typename T>
__device__ void stage_tile(const T* Fg, const T* ug, const bool* vg,
                           const T* t0, int nr, int C, T* Fs, T* us,
                           bool* vs, T* theta, int* wrow, int* wcol, int* re,
                           int* ce) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = C + 1;
  int last_row = -1, last_col = -1;
  constexpr int V = 16 / sizeof(T);
  const size_t n = (size_t)nr * C;
  if (C % V == 0 && aligned16(Fg)) {
    for (size_t i = tid; i < n / V; i += blockDim.x) {
      T x[V];
      ld16(Fg + i * V, x);
      const int r = (int)(i * V / C), c0 = (int)(i * V % C);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        Fs[(size_t)r * stride + c0 + j] = x[j];
        if (x[j] != T(0)) {
          last_row = max(last_row, r);
          last_col = max(last_col, c0 + j);
        }
      }
    }
  } else {
    for (size_t i = tid; i < n; i += blockDim.x) {
      const int r = (int)(i / C), c = (int)(i % C);
      const T x = Fg[i];
      Fs[(size_t)r * stride + c] = x;
      if (x != T(0)) {
        last_row = max(last_row, r);
        last_col = max(last_col, c);
      }
    }
  }
  for (int r = tid; r < nr; r += blockDim.x) {
    us[r] = ug[r];
    vs[r] = vg[r];
    if (vs[r]) last_row = max(last_row, r);
  }
  for (int c = tid; c < C; c += blockDim.x) {
    theta[c] = t0[c];
    if (t0[c] != T(0)) last_col = max(last_col, c);
  }
  last_row = __reduce_max_sync(kFull, last_row);
  last_col = __reduce_max_sync(kFull, last_col);
  if (lane == 0) {
    wrow[warp] = last_row;
    wcol[warp] = last_col;
  }
  __syncthreads();
  int rmax = -1, cmax = -1;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    rmax = max(rmax, wrow[w]);
    cmax = max(cmax, wcol[w]);
  }
  *re = rmax + 1;
  *ce = cmax + 1;
}

// Byte offsets of the strip kernel's shared arrays, each 16-byte aligned.
struct StripLayout {
  size_t fs, us, rs, vec, part, xch, wsum, ints, vs, total;
};

// rows: rows per CTA
template <typename T>
__host__ __device__ StripLayout strip_layout(int C, int rows) {
  StripLayout L;
  size_t at = 0;
  L.fs = carve(&at, sizeof(T) * (size_t)rows * (C + 1));
  L.us = carve(&at, sizeof(T) * (size_t)rows);     // u of each row
  L.rs = carve(&at, sizeof(T) * (size_t)rows);     // u_r / denom_r
  L.vec = carve(&at, sizeof(T) * 4 * (size_t)C);   // theta thn colsum nxt
  L.part = carve(&at, sizeof(T) * (size_t)(C > kStripThreads
                                              ? C : kStripThreads));
  L.xch = carve(&at, sizeof(T) * 2 * (size_t)C);   // double-buffered
  L.wsum = carve(&at, sizeof(T) * kStripWarps);
  L.ints = carve(&at, sizeof(int) * (4 + 2 * kStripWarps));
  L.vs = carve(&at, (size_t)rows);                  // valid of each row
  L.total = at;
  return L;
}

// out[c], c < ncols: the sum over the strip's rows r < re of w_r F_rc (w_r
// = 1 unweighted), 0 for c >= ce. Each column in a fixed order: G row
// groups (every G-th row, four running sums each), then the groups in
// order. The strip's rows are in shared memory at stride C + 1. Ends with
// the partials read; the caller synchronizes.
template <typename T, bool kWeighted>
__device__ void strip_column_sums(const T* Fs, int C, int re, int ce,
                                  int ncols, const T* w, T* part, T* out) {
  const int tid = threadIdx.x;
  int G = ncols < kStripThreads ? kStripThreads / ncols : 1;
  G = G < kMaxGroups ? G : kMaxGroups;
  const int step = G * (C + 1);
  for (int k = tid; k < G * ncols; k += kStripThreads) {
    const int c = k % ncols, g = k / ncols;
    T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
    if (c < ce) {
      int r = g;
      const T* f = Fs + r * (C + 1) + c;
      for (; r + 3 * G < re; r += 4 * G, f += 4 * step) {
        if constexpr (kWeighted) {
          a0 += w[r] * f[0];
          a1 += w[r + G] * f[step];
          a2 += w[r + 2 * G] * f[2 * step];
          a3 += w[r + 3 * G] * f[3 * step];
        } else {
          a0 += f[0];
          a1 += f[step];
          a2 += f[2 * step];
          a3 += f[3 * step];
        }
      }
      for (; r < re; r += G, f += step)
        a0 += kWeighted ? w[r] * f[0] : f[0];
    }
    part[k] = (a0 + a1) + (a2 + a3);
  }
  __syncthreads();
  for (int c = tid; c < ncols; c += kStripThreads) {
    T acc = T(0);
    int g = 0;
    for (; g + 4 <= G; g += 4) {  // four loads in flight, added in order
      const T x0 = part[g * ncols + c], x1 = part[(g + 1) * ncols + c];
      const T x2 = part[(g + 2) * ncols + c], x3 = part[(g + 3) * ncols + c];
      acc = (((acc + x0) + x1) + x2) + x3;
    }
    for (; g < G; ++g) acc += part[g * ncols + c];
    out[c] = acc;
  }
}

// The sum over the cluster's CTAs, in rank order, of p[c] in each CTA's
// shared memory (four remote loads in flight).
template <typename T>
__device__ __forceinline__ T rank_sum(const cg::cluster_group& cluster,
                                      int S, T* p, int c) {
  if (S == 1) return T(0) + p[c];
  T acc = T(0);
  int k = 0;
  for (; k + 4 <= S; k += 4) {
    const T x0 = cluster.map_shared_rank(p, k)[c];
    const T x1 = cluster.map_shared_rank(p, k + 1)[c];
    const T x2 = cluster.map_shared_rank(p, k + 2)[c];
    const T x3 = cluster.map_shared_rank(p, k + 3)[c];
    acc = (((acc + x0) + x1) + x2) + x3;
  }
  for (; k < S; ++k) acc += cluster.map_shared_rank(p, k)[c];
  return acc;
}

// A barrier over the cluster; a CTA barrier when the cluster is one CTA.
__device__ __forceinline__ void cluster_barrier(
    const cg::cluster_group& cluster, int S) {
  if (S > 1)
    cluster.sync();
  else
    __syncthreads();
}

// One cluster of S CTAs per locus; CTA `rank` holds rows
// [rank * rows, rank * rows + rows) of F in shared memory.
template <typename T>
__global__ void __launch_bounds__(kStripThreads)
em_strip_kernel(const T* __restrict__ F, const T* __restrict__ u,
                const T* __restrict__ theta0, const bool* __restrict__ valid,
                const bool* __restrict__ active, T* __restrict__ theta_out,
                bool* __restrict__ failed_out, int R, int C, int max_iter,
                int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* t0 = theta0 + (size_t)b * C;
  if (!active[b]) {  // the whole cluster returns before any cluster barrier
    if (rank == 0) {
      for (int c = tid; c < C; c += kStripThreads)
        theta_out[(size_t)b * C + c] = t0[c];
      if (tid == 0) failed_out[b] = false;
    }
    return;
  }

  const StripLayout L = strip_layout<T>(C, rows);
  T* Fs = reinterpret_cast<T*>(smem + L.fs);
  T* us = reinterpret_cast<T*>(smem + L.us);
  T* rs = reinterpret_cast<T*>(smem + L.rs);
  T* theta = reinterpret_cast<T*>(smem + L.vec);
  T* thn = theta + C;
  T* colsum = thn + C;
  T* nxt = colsum + C;
  T* part = reinterpret_cast<T*>(smem + L.part);
  T* xch = reinterpret_cast<T*>(smem + L.xch);
  T* wsum = reinterpret_cast<T*>(smem + L.wsum);
  int* ints = reinterpret_cast<int*>(smem + L.ints);  // flag[2], ce, spare
  int* wrow = ints + 4;
  int* wcol = wrow + kStripWarps;
  bool* vs = reinterpret_cast<bool*>(smem + L.vs);

  const int r0 = rank * rows;
  const int nr = max(0, min(rows, R - r0));  // this strip's rows
  const int stride = C + 1;
  const T* Fg = F + ((size_t)b * R + r0) * C;

  // 1. stage F, u and valid; find the strip's extents
  int re, ce;
  stage_tile<T>(Fg, u + (size_t)b * R + r0, valid + (size_t)b * R + r0, t0,
                nr, C, Fs, us, vs, theta, wrow, wcol, &re, &ce);

  // 2. column sums of the raw F: this strip's partials, then every strip's
  // in rank order; the locus' column extent is the largest strip's
  strip_column_sums<T, false>(Fs, C, re, ce, C, nullptr, part, xch);
  if (tid == 0) ints[2] = ce;
  cluster_barrier(cluster, S);
  int cg_ext = ce;
  for (int k = 0; k < S && S > 1; ++k)
    cg_ext = max(cg_ext, *cluster.map_shared_rank(ints + 2, k));
  for (int c = tid; c < cg_ext; c += kStripThreads)
    colsum[c] = rank_sum(cluster, S, xch, c);

  // 3. iterate; iteration i exchanges through buffer (i + 1) & 1, so one
  // cluster barrier an iteration keeps a buffer from being rewritten while
  // another CTA still reads it
  bool failed = false;
  int it = 0;
  for (int buf = 1;; buf ^= 1) {
    for (int c = tid; c < cg_ext; c += kStripThreads)
      thn[c] = it == 0 ? theta[c]
                       : (colsum[c] != T(0) ? theta[c] / colsum[c] : T(0));
    __syncthreads();

    int zero = 0;  // E-step: one thread per row
    for (int r = tid; r < re; r += kStripThreads) {
      const T d = row_dot(Fs + r * stride, thn, ce);
      const bool v = vs[r];
      zero |= v && d == T(0);
      rs[r] = (v && d != T(0)) ? us[r] / d : T(0);
    }
    zero = __syncthreads_or(zero);

    T* mine = xch + buf * C;
    strip_column_sums<T, true>(Fs, C, re, ce, cg_ext, rs, part, mine);
    if (tid == 0) ints[buf] = zero;
    cluster_barrier(cluster, S);

    T sq = T(0);
    for (int c = tid; c < cg_ext; c += kStripThreads) {
      nxt[c] = rank_sum(cluster, S, mine, c) * thn[c];
      const T dc = nxt[c] - theta[c];
      sq += dc * dc;
    }
    sq = warp_sum(sq);
    if (lane == 0) wsum[warp] = sq;
    const int fail = __syncthreads_or(
        S == 1 ? zero : tid < S ? *cluster.map_shared_rank(ints + buf, tid)
                                : 0);
    T d2 = T(0);
    for (int w = 0; w < kStripWarps; ++w) d2 += wsum[w];
    if (fail) {  // a valid row lost all its mass
      for (int c = tid; c < cg_ext; c += kStripThreads) theta[c] = t0[c];
      failed = true;
      break;
    }
    if (sqrt(d2) < T(1e-2)) break;  // keep the previous theta
    for (int c = tid; c < cg_ext; c += kStripThreads) theta[c] = nxt[c];
    if (++it >= max_iter) break;
  }
  if (S > 1) cluster.sync();  // no CTA leaves while another may read its
                              // shared memory
  if (rank == 0) {
    for (int c = tid; c < C; c += kStripThreads)
      theta_out[(size_t)b * C + c] = c < cg_ext ? theta[c] : t0[c];
    if (tid == 0) failed_out[b] = failed;
  }
}

// ------------------------------------------------------------ launches
bool use_warp_kernel(int R, int C) { return R <= 128 && C <= 8; }
bool use_rows_kernel(int R, int C) { return R <= kRowsMax && C <= 32; }

template <typename T>
int launch_warp(const T* F, const T* u, const T* theta0, const bool* valid,
                const bool* active, T* theta_out, bool* failed_out, int B,
                int R, int C, int max_iter, cudaStream_t stream) {
  const dim3 grid((B + kWarpLoci - 1) / kWarpLoci), block(32 * kWarpLoci);
  if (C <= 4 && R <= 32)
    em_warp_kernel<T, 4, 1><<<grid, block, 0, stream>>>(
        F, u, theta0, valid, active, theta_out, failed_out, B, R, C, max_iter);
  else if (C <= 4)
    em_warp_kernel<T, 4, 4><<<grid, block, 0, stream>>>(
        F, u, theta0, valid, active, theta_out, failed_out, B, R, C, max_iter);
  else if (R <= 32)
    em_warp_kernel<T, 8, 1><<<grid, block, 0, stream>>>(
        F, u, theta0, valid, active, theta_out, failed_out, B, R, C, max_iter);
  else
    em_warp_kernel<T, 8, 4><<<grid, block, 0, stream>>>(
        F, u, theta0, valid, active, theta_out, failed_out, B, R, C, max_iter);
  return cudaGetLastError();
}

struct StripPlan {
  int strips, rows, max_clusters;
  size_t smem;
};

template <typename T>
cudaError_t strip_attributes(int strips, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      em_strip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && strips > 8)
    e = cudaFuncSetAttribute(em_strip_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

template <typename T>
cudaLaunchConfig_t strip_config(int B, const StripPlan& p,
                                cudaLaunchAttribute* attr,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.strips);
  cfg.blockDim = dim3(kStripThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.strips;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of this plan the card holds at once (0 if none).
template <typename T>
int max_active_clusters(int B, const StripPlan& p) {
  if (strip_attributes<T>(p.strips, p.smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = strip_config<T>(B, p, attr, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, em_strip_kernel<T>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The cluster size S: the fewest CTAs (a power of two, at most 16) that
// leave each at most kStripElems elements of F and whose strips fit in
// shared memory; a bucket whose strips do not fit at 16 is refused. At
// 2048 x 128 this picks 16 in both types (a non-portable cluster size),
// although the card holds fewer clusters of 16 at once than of 8: 16 was
// the faster on the card (PERF.md). `report` also asks how many clusters
// fit at once.
template <typename T>
cudaError_t strip_plan(int B, int R, int C, bool report, StripPlan* p) {
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  auto with_rows = [&](int strips) {
    StripPlan q;
    q.strips = strips;
    q.rows = (R + strips - 1) / strips;
    q.smem = strip_layout<T>(C, q.rows).total;
    q.max_clusters = 0;
    return q;
  };
  int s = 1;
  while (s < 16 && (size_t)((R + s - 1) / s) * C > kStripElems) s *= 2;
  StripPlan q = with_rows(s);
  while (s < 16 && q.smem > (size_t)cap) q = with_rows(s *= 2);
  if (q.smem > (size_t)cap) return cudaErrorInvalidValue;
  if (report) q.max_clusters = max_active_clusters<T>(B, q);
  *p = q;
  return cudaSuccess;
}

template <typename T>
int launch(const void* F, const void* u, const void* theta0,
           const void* valid, const void* active, void* theta_out,
           void* failed_out, int B, int R, int C, int max_iter,
           void* stream) {
  if (B <= 0) return cudaSuccess;
  if (R <= 0 || C <= 0 || max_iter <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (use_warp_kernel(R, C))
    return launch_warp<T>((const T*)F, (const T*)u, (const T*)theta0,
                          (const bool*)valid, (const bool*)active,
                          (T*)theta_out, (bool*)failed_out, B, R, C,
                          max_iter, s);
  if (use_rows_kernel(R, C)) {
    em_rows_kernel<T><<<B, kRowsMax, 0, s>>>(
        (const T*)F, (const T*)u, (const T*)theta0, (const bool*)valid,
        (const bool*)active, (T*)theta_out, (bool*)failed_out, R, C,
        max_iter);
    return cudaGetLastError();
  }
  StripPlan p;
  cudaError_t e = strip_plan<T>(B, R, C, false, &p);
  if (e == cudaSuccess) e = strip_attributes<T>(p.strips, p.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = strip_config<T>(B, p, attr, s);
  e = cudaLaunchKernelEx(&cfg, em_strip_kernel<T>, (const T*)F, (const T*)u,
                         (const T*)theta0, (const bool*)valid,
                         (const bool*)active, (T*)theta_out,
                         (bool*)failed_out, R, C, max_iter, p.rows);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
int plan(int B, int R, int C, int* out) {
  if (use_warp_kernel(R, C)) {
    out[0] = 0;                                  // em_warp_kernel
    out[1] = (B + kWarpLoci - 1) / kWarpLoci;    // CTAs
    out[2] = 32 * kWarpLoci;                     // threads a CTA
    out[3] = 1;                                  // CTAs a locus (none: warps)
    out[4] = R;                                  // rows a locus' warp holds
    out[5] = 0;                                  // dynamic shared memory
    out[6] = 0;                                  // clusters held at once
    return cudaSuccess;
  }
  if (use_rows_kernel(R, C)) {
    out[0] = 1;  // em_rows_kernel
    out[1] = B;
    out[2] = kRowsMax;
    out[3] = 1;
    out[4] = R;  // F lives in registers
    out[5] = 0;
    out[6] = 0;
    return cudaSuccess;
  }
  StripPlan p;
  const cudaError_t e = strip_plan<T>(B, R, C, true, &p);
  if (e != cudaSuccess) return e;
  out[0] = 2;  // em_strip_kernel
  out[1] = B * p.strips;
  out[2] = kStripThreads;
  out[3] = p.strips;
  out[4] = p.rows;
  out[5] = (int)p.smem;
  out[6] = p.max_clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int strawb_em_bucket_f32(const void* F, const void* u, const void* theta0,
                         const void* valid, const void* active,
                         void* theta_out, void* failed_out, int B, int R,
                         int C, int max_iter, void* stream) {
  return launch<float>(F, u, theta0, valid, active, theta_out, failed_out, B,
                       R, C, max_iter, stream);
}

int strawb_em_bucket_f64(const void* F, const void* u, const void* theta0,
                         const void* valid, const void* active,
                         void* theta_out, void* failed_out, int B, int R,
                         int C, int max_iter, void* stream) {
  return launch<double>(F, u, theta0, valid, active, theta_out, failed_out,
                        B, R, C, max_iter, stream);
}

// The launch a bucket gets, as 7 ints: kernel (0 warp, 1 rows, 2 strip), CTAs,
// threads a CTA, CTAs a locus, rows a CTA, dynamic shared memory bytes,
// clusters the card holds at once.
int strawb_em_bucket_plan(int dtype_bytes, int B, int R, int C, int* out) {
  if (B <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  return dtype_bytes == 8 ? plan<double>(B, R, C, out)
                          : plan<float>(B, R, C, out);
}

const char* strawb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
