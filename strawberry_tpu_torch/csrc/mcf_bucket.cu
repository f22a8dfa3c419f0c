// Min-cost circulation with lower bounds on a ragged batch of flow problems
// (one per locus), on Hopper.
//
// Replaces the XLA program strawberry_tpu/assembly/device.py::_mcf_bucket
// (behind STRAWB_DEVICE_MCF=1), and the port's first design of it, which
// zero-padded every problem to a node bucket of 64, 128 or 256 and ran one
// 256-thread CTA a locus. It computes what they compute: the integer
// successive-shortest-path algorithm of assembly/mincostflow.py::solve_dense,
// on each problem at its own m nodes, so the flows are array-equal to the
// host solver's and to the XLA program's on the padded bucket.
//
// Per problem b (m = size[b] nodes; cost, lower int64 and has_arc uint8,
// m x m row-major at offset[b] of the flat inputs; flow written likewise):
//   * flow starts at lower; excess = in - out per node.
//   * While some node has positive excess (at most max_aug augmentations):
//     - residual cost of u->v: the cheaper of the forward arc (cost) and the
//       backward residual of arc v->u (-cost, where flow > lower); ties go
//       forward. INF = 2^50 marks "no residual arc".
//     - synchronous (Jacobi) Bellman-Ford from every excess node, at most m
//       rounds: cand = dist[u] + rc[u][v] (INF where rc >= INF, no
//       saturation), the first u of the minimum wins, and dist/pred change
//       only on a strict improvement; a round that changes nothing ends it,
//       since a fixed point stays fixed;
//     - t = the first deficit node of least distance; if its distance is
//       >= INF the problem is infeasible and stops;
//     - walk pred back from t (at most m steps) to a node with no
//       predecessor (the source), marking each edge once and taking the
//       bottleneck of the backward residuals on the path, and push
//       min(bottleneck, excess[source], -excess[t]) along it.
//   * A problem that hits max_aug returns its flow unmarked.
//
// What bounds it: nothing the card is short of. On the realistic 2M-read
// set the problems have 2 to 15 nodes (median 8), up to 101 of them a
// call, so a call moves about 140 KB each way in all; the work is a chain
// of dependent steps (an augmentation's Bellman-Ford rounds, then the path
// walk, then the next augmentation), so a problem takes as long as its
// chain, and the launch as long as its slowest problem; the rounds take
// most of it. The first design paid for padding on top: 66x the bytes of
// these problems in copies and in sweep work, residual costs rebuilt from
// global memory after every push, two block barriers a round and a serial
// scan in thread 0.
//
// The design, for the chain's latency:
//   * Ragged input, no padding: the host packs the problems back to back,
//     sorted by m, and each problem is read at its own m.
//   * m <= 32, one warp a problem (mcf_warp_kernel), 4 warps a CTA: the
//     problem's costs, residual capacities (flow - lower) and residual costs
//     live in the warp's shared memory, sized by the launch's largest m.
//     Lane v owns node v, its dist, pred and excess in registers. A round is
//     2m shared-memory reads (rc[u][v] and last round's dist[u]), scanned
//     as four independent chains with no branch, ended by __any_sync: no
//     block barrier anywhere. The target is a shuffle argmin on (dist, index). The walk
//     is a chain of shuffles of pred that every lane follows; each node on
//     the path then pushes on its own in-edge, in parallel, and rewrites
//     the one residual cost the push changed (a change to F[x][y] moves
//     only rc[y][x]); the bottleneck is a shuffle min.
//   * 33 <= m <= 256, one 256-thread CTA a problem (mcf_block_kernel): k =
//     256 / m threads split the u range of node v in each round and the
//     partial minima combine in u order (first-index ties). Residual costs
//     live in shared memory up to m = 128 (128 KB) and in a global
//     workspace above that, with the same incremental update; the target
//     is a block argmin.
//   * One launch per size class the call has, on the caller's stream.
//
// Built by utils/kernels.py with nvcc for sm_90a; plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kInf = 1LL << 50;
constexpr long long kNone = 0x7fffffffffffffffLL;  // above any candidate
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxNodes = 32;
constexpr int kWarpsPerCta = 4;
constexpr int kBlockThreads = 256;
constexpr int kSharedRcMaxNodes = 128;
constexpr int kMaxNodes = 256;

// Shared memory of one warp of mcf_warp_kernel for problems of at most M
// nodes: cost, residual capacity and residual cost (M x M int64 each), dist
// double-buffered (2 x 32 int64) and the has_arc rows (32 words).
__host__ __device__ constexpr size_t warp_smem_bytes(int M) {
  return (size_t)3 * M * M * sizeof(long long) +
         2 * kWarpMaxNodes * sizeof(long long) +
         kWarpMaxNodes * sizeof(unsigned);
}

// Residual cost of u->v in the warp kernel's shared state; *use_bwd tells
// whether the backward residual of arc v->u was the cheaper (strictly).
__device__ __forceinline__ long long warp_rc(const long long* C,
                                             const long long* CAP,
                                             const unsigned* HAS, int m,
                                             int u, int v, bool* use_bwd) {
  const long long fwd = (HAS[u] >> v) & 1u ? C[u * m + v] : kInf;
  const long long bwd =
      ((HAS[v] >> u) & 1u) && CAP[v * m + u] > 0 ? -C[v * m + u] : kInf;
  if (use_bwd) *use_bwd = bwd < fwd;
  return bwd < fwd ? bwd : fwd;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
mcf_warp_kernel(const long long* __restrict__ cost,
                const unsigned char* __restrict__ has_arc,
                const long long* __restrict__ lower,
                const long long* __restrict__ offset,
                const int* __restrict__ size, long long* __restrict__ flow,
                unsigned char* __restrict__ infeasible_out, int first,
                int count, int max_m, int max_aug) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerCta + warp;
  if (p >= count) return;  // a whole warp: the kernel has no block barrier
  const int b = first + p;
  const int m = size[b];
  const long long off = offset[b];
  const int mm = m * m;
  const bool node = lane < m;

  long long* Cs =
      reinterpret_cast<long long*>(smem + warp * warp_smem_bytes(max_m));
  long long* CAP = Cs + max_m * max_m;  // flow - lower
  long long* RC = CAP + max_m * max_m;  // residual costs
  long long* DIST = RC + max_m * max_m;  // two rounds' dist, 32 each
  unsigned* HAS = reinterpret_cast<unsigned*>(DIST + 2 * kWarpMaxNodes);
  unsigned char* has_bytes = reinterpret_cast<unsigned char*>(CAP);

  // the loads of a lane are independent: several are in flight at once
#pragma unroll 4
  for (int e = lane; e < mm; e += 32) {
    Cs[e] = cost[off + e];
    RC[e] = lower[off + e];  // for the excess, below
    has_bytes[e] = has_arc[off + e];
  }
  __syncwarp();
  for (int u = 0; u < m; ++u) {  // bit v of HAS[u]: arc u->v
    const unsigned row = __ballot_sync(kFull, node && has_bytes[u * m + lane]);
    if (lane == 0) HAS[u] = row;
  }
  long long ex = 0;  // in - out of node `lane` under flow = lower
  if (node)
    for (int u = 0; u < m; ++u) ex += RC[u * m + lane] - RC[lane * m + u];
  __syncwarp();
  for (int e = lane; e < mm; e += 32) CAP[e] = 0;
  __syncwarp();
  for (int e = lane; e < mm; e += 32)
    RC[e] = warp_rc(Cs, CAP, HAS, m, e / m, e % m, nullptr);
  __syncwarp();

  bool infeasible = false;
  for (int it = 0; it < max_aug; ++it) {
    if (!__any_sync(kFull, node && ex > 0)) break;  // no excess left: done

    long long dist = node && ex > 0 ? 0 : kInf;
    int pred = -1;
    int cur = 0;
    DIST[lane] = dist;
    __syncwarp();
    for (int round = 0; round < m; ++round) {
      // Four chains over u = 4q + r, each keeping the first u of its
      // minimum, then joined by (value, index), which keeps the first u
      // of the whole. No branch and no shuffle inside: a lane past m scans
      // column 0 and drops the result, and u past m reads entry 0 and
      // never wins.
      const long long* D = DIST + cur * kWarpMaxNodes;  // last round's
      const int col = node ? lane : 0;
      long long best[4] = {kNone, kNone, kNone, kNone};
      int bu[4] = {0, 0, 0, 0};
      for (int u0 = 0; u0 < m; u0 += 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = u0 + r;
          const int uc = u < m ? u : 0;
          const long long rc = RC[uc * m + col];
          long long cand = rc >= kInf ? kInf : D[uc] + rc;
          cand = u < m ? cand : kNone;
          const bool take = cand < best[r];
          best[r] = take ? cand : best[r];
          bu[r] = take ? u : bu[r];
        }
      }
      long long bst = best[0];
      int arg = bu[0];
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        if (best[r] < bst || (best[r] == bst && bu[r] < arg)) {
          bst = best[r];
          arg = bu[r];
        }
      }
      const bool improved = node && bst < dist;
      if (improved) {
        dist = bst;
        pred = arg;
      }
      cur ^= 1;
      DIST[cur * kWarpMaxNodes + lane] = dist;
      __syncwarp();  // this round's dist before the next round reads it
      if (!__any_sync(kFull, improved)) break;  // a fixed point stays fixed
    }

    // t: the first deficit node of least distance (every lane gets it)
    long long td = node ? (ex < 0 ? dist : kInf) : kNone;
    int t = lane;
    for (int o = 16; o > 0; o >>= 1) {
      const long long td2 = __shfl_xor_sync(kFull, td, o);
      const int t2 = __shfl_xor_sync(kFull, t, o);
      if (td2 < td || (td2 == td && t2 < t)) {
        td = td2;
        t = t2;
      }
    }
    if (td >= kInf) {  // no deficit node is reachable
      infeasible = true;
      break;
    }

    // Each node's edge from its predecessor, under the flow before the
    // push: backward or forward, and its backward capacity.
    bool bwd = false;
    long long cap = kInf;
    if (node && pred >= 0) {
      warp_rc(Cs, CAP, HAS, m, pred, lane, &bwd);
      if (bwd) cap = CAP[lane * m + pred];
    }
    // Every lane follows the walk from t (pred by shuffle, at most m steps,
    // as the reference's walk). The path's edges are (pred[v], v) for its
    // heads v, each taken once however often the walk meets it (the
    // reference marks a set of edges); `tails` counts this node's edges.
    unsigned heads = 0;
    int tails = 0;
    int v = t, src = t;
    for (int s = 0; s < m; ++s) {
      const int u = __shfl_sync(kFull, pred, v);
      if (u < 0) {
        src = v;
        break;
      }
      if (!((heads >> v) & 1u)) {
        heads |= 1u << v;
        tails += lane == u;
      }
      v = u;
    }
    const bool on_path = (heads >> lane) & 1u;
    long long amt = on_path && bwd ? cap : kInf;  // the bottleneck
    for (int o = 16; o > 0; o >>= 1) {
      const long long a2 = __shfl_xor_sync(kFull, amt, o);
      amt = a2 < amt ? a2 : amt;
    }
    const long long ex_src = __shfl_sync(kFull, ex, src);
    const long long ex_t = __shfl_sync(kFull, ex, t);
    if (ex_src < amt) amt = ex_src;
    if (-ex_t < amt) amt = -ex_t;

    // Each head pushes on its own edge, in parallel. F[x][y] enters only
    // rc[y][x], and the pred graph is a forest, so no two lanes touch one
    // entry, and each lane reads back only what it wrote.
    __syncwarp();  // every lane has read the flow before the push
    if (on_path) {
      if (bwd) {
        CAP[lane * m + pred] -= amt;  // cancel on arc lane->pred
        RC[pred * m + lane] = warp_rc(Cs, CAP, HAS, m, pred, lane, nullptr);
      } else {
        CAP[pred * m + lane] += amt;
        RC[lane * m + pred] = warp_rc(Cs, CAP, HAS, m, lane, pred, nullptr);
      }
    }
    ex += (on_path ? amt : 0) - tails * amt;
    __syncwarp();
  }

  for (int e = lane; e < mm; e += 32)
    flow[off + e] = lower[off + e] + CAP[e];
  if (lane == 0) infeasible_out[b] = infeasible;
}

// Residual cost of u->v under the current flow (the block kernel's state
// in global memory); *use_bwd as in warp_rc.
__device__ long long block_rc(const long long* __restrict__ cost,
                              const unsigned char* __restrict__ has_arc,
                              const long long* __restrict__ lower,
                              const long long* flow, int M, int u, int v,
                              bool* use_bwd) {
  const size_t uv = (size_t)u * M + v;
  const size_t vu = (size_t)v * M + u;
  const long long fwd = has_arc[uv] ? cost[uv] : kInf;
  const long long bwd =
      (has_arc[vu] && flow[vu] - lower[vu] > 0) ? -cost[vu] : kInf;
  if (use_bwd) *use_bwd = bwd < fwd;
  return bwd < fwd ? bwd : fwd;
}

// flow and a global rc workspace are written inside the kernel and read by
// other threads after a barrier, so they are not read through the
// non-coherent path.
template <bool kSharedRc>
__global__ void __launch_bounds__(kBlockThreads)
mcf_block_kernel(const long long* __restrict__ cost,
                 const unsigned char* __restrict__ has_arc,
                 const long long* __restrict__ lower,
                 const long long* __restrict__ offset,
                 const int* __restrict__ size, long long* flow,
                 unsigned char* __restrict__ infeasible_out,
                 long long* rc_ws, int first, int max_aug) {
  extern __shared__ __align__(16) unsigned char smem[];  // rc, if it fits
  __shared__ long long excess[kMaxNodes];
  __shared__ long long dist[2][kMaxNodes];
  __shared__ int pred[2][kMaxNodes];
  __shared__ long long part_best[kBlockThreads];
  __shared__ int part_arg[kBlockThreads];
  __shared__ unsigned int onpath[kMaxNodes * kMaxNodes / 32];
  __shared__ unsigned int path[kMaxNodes];
  __shared__ long long warp_td[kBlockThreads / 32];
  __shared__ int warp_t[kBlockThreads / 32];
  __shared__ int infeasible_flag;

  const int b = first + blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int M = size[b];
  const long long off = offset[b];
  const int MM = M * M;
  const long long* C = cost + off;
  const unsigned char* H = has_arc + off;
  const long long* L = lower + off;
  long long* F = flow + off;
  long long* RC =
      kSharedRc ? reinterpret_cast<long long*>(smem) : rc_ws + off;

  for (int e = tid; e < MM; e += nt) F[e] = L[e];
  for (int w = tid; w < (MM + 31) / 32; w += nt) onpath[w] = 0;
  if (tid == 0) infeasible_flag = 0;
  __syncthreads();
  for (int v = tid; v < M; v += nt) {
    long long in = 0, out = 0;
    for (int u = 0; u < M; ++u) {
      in += F[u * M + v];
      out += F[v * M + u];
    }
    excess[v] = in - out;
  }
  for (int e = tid; e < MM; e += nt)
    RC[e] = block_rc(C, H, L, F, M, e / M, e % M, nullptr);
  __syncthreads();

  // Bellman-Ford layout: thread (j, v) = (tid / M, tid % M) scans the
  // chunk j of u for node v; k chunks per node.
  const int k = nt / M;
  const int j = tid / M;
  const int bv = tid % M;
  const int chunk = (M + k - 1) / k;

  for (int it = 0; it < max_aug; ++it) {
    if (!__syncthreads_or(tid < M && excess[tid] > 0)) break;  // done
    if (tid < M) {
      dist[0][tid] = excess[tid] > 0 ? 0 : kInf;
      pred[0][tid] = -1;
    }
    __syncthreads();

    int cur = 0;
    for (int round = 0; round < M; ++round) {
      if (j < k) {
        const int u0 = j * chunk;
        const int u1 = min(M, u0 + chunk);
        long long best = kNone;
        int bu = u0;
        for (int u = u0; u < u1; ++u) {
          const long long r = RC[u * M + bv];
          const long long cand = r >= kInf ? kInf : dist[cur][u] + r;
          if (cand < best) {
            best = cand;
            bu = u;
          }
        }
        part_best[tid] = best;
        part_arg[tid] = bu;
      }
      __syncthreads();
      int changed = 0;
      if (j == 0) {
        long long best = part_best[bv];
        int bu = part_arg[bv];
        for (int q = 1; q < k; ++q) {
          if (part_best[q * M + bv] < best) {
            best = part_best[q * M + bv];
            bu = part_arg[q * M + bv];
          }
        }
        const long long d = dist[cur][bv];
        if (best < d) {
          dist[cur ^ 1][bv] = best;
          pred[cur ^ 1][bv] = bu;
          changed = 1;
        } else {
          dist[cur ^ 1][bv] = d;
          pred[cur ^ 1][bv] = pred[cur][bv];
        }
      }
      cur ^= 1;
      if (!__syncthreads_or(changed)) break;  // a fixed point stays fixed
    }

    // t: the first deficit node of least distance, a block argmin
    long long td =
        tid < M ? (excess[tid] < 0 ? dist[cur][tid] : kInf) : kNone;
    int t = tid;
    for (int o = 16; o > 0; o >>= 1) {
      const long long td2 = __shfl_xor_sync(kFull, td, o);
      const int t2 = __shfl_xor_sync(kFull, t, o);
      if (td2 < td || (td2 == td && t2 < t)) {
        td = td2;
        t = t2;
      }
    }
    if ((tid & 31) == 0) {
      warp_td[tid >> 5] = td;
      warp_t[tid >> 5] = t;
    }
    __syncthreads();

    if (tid == 0) {
      td = warp_td[0];
      t = warp_t[0];
      for (int w = 1; w < nt / 32; ++w) {
        if (warp_td[w] < td) {  // warps in index order: first index wins
          td = warp_td[w];
          t = warp_t[w];
        }
      }
      if (td >= kInf) {
        infeasible_flag = 1;  // no deficit node is reachable
      } else {
        // at most M steps, as the reference's walk; an edge seen twice
        // is pushed once (the reference marks a set of edges)
        int v = t, src = t, n = 0;
        long long bott = kInf;
        for (int s = 0; s < M; ++s) {
          const int u = pred[cur][v];
          if (u < 0) {
            src = v;
            break;
          }
          const int bit = u * M + v;
          if (!(onpath[bit >> 5] & (1u << (bit & 31)))) {
            onpath[bit >> 5] |= 1u << (bit & 31);
            bool bwd;
            block_rc(C, H, L, F, M, u, v, &bwd);
            if (bwd) {
              const long long cap = F[v * M + u] - L[v * M + u];
              bott = cap < bott ? cap : bott;
            }
            path[n++] =
                (unsigned)u | (unsigned)v << 10 | (unsigned)bwd << 20;
          }
          v = u;
        }
        long long amt = bott;
        if (excess[src] < amt) amt = excess[src];
        if (-excess[t] < amt) amt = -excess[t];
        for (int q = 0; q < n; ++q) {
          const int u = path[q] & 0x3ff, w = (path[q] >> 10) & 0x3ff;
          if (path[q] >> 20)
            F[w * M + u] -= amt;  // cancel on arc w->u
          else
            F[u * M + w] += amt;
          excess[u] -= amt;
          excess[w] += amt;
          const int bit = u * M + w;
          onpath[bit >> 5] &= ~(1u << (bit & 31));
        }
        // F[x][y] enters only rc[y][x]
        for (int q = 0; q < n; ++q) {
          const int u = path[q] & 0x3ff, w = (path[q] >> 10) & 0x3ff;
          const int x = path[q] >> 20 ? w : u, y = path[q] >> 20 ? u : w;
          RC[y * M + x] = block_rc(C, H, L, F, M, y, x, nullptr);
        }
      }
    }
    __syncthreads();
    if (infeasible_flag) break;
  }
  if (tid == 0) infeasible_out[b] = infeasible_flag != 0;
}

// A kernel's dynamic shared memory beside its static part may pass the
// default 48 KB only once the kernel has opted in.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// The problems lie in size-class order: n_warp of at most 32 nodes (the
// largest warp_max_m), then n_block of 33..128 (the largest block_max_m),
// then n_global of 129..256, which need `workspace` (int64, as many entries
// as cost). Each class present is one launch on `stream`, a stream of
// device `device`; the entry switches to that device only when it is not
// the current one, and switches back.
int strawb_mcf_ragged(const void* cost, const void* has_arc,
                      const void* lower, const void* offset, const void* size,
                      void* flow, void* infeasible, void* workspace,
                      int n_warp, int warp_max_m, int n_block,
                      int block_max_m, int n_global, int max_aug, int device,
                      void* stream) {
  if (n_warp < 0 || n_block < 0 || n_global < 0 || max_aug < 0 ||
      (n_warp > 0 && (warp_max_m < 1 || warp_max_m > kWarpMaxNodes)) ||
      (n_block > 0 &&
       (block_max_m <= kWarpMaxNodes || block_max_m > kSharedRcMaxNodes)) ||
      (n_global > 0 && workspace == nullptr))
    return cudaErrorInvalidValue;
  if (n_warp + n_block + n_global == 0) return cudaSuccess;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* c = (const long long*)cost;
  const unsigned char* h = (const unsigned char*)has_arc;
  const long long* l = (const long long*)lower;
  const long long* o = (const long long*)offset;
  const int* z = (const int*)size;
  long long* f = (long long*)flow;
  unsigned char* inf = (unsigned char*)infeasible;
  if (n_warp > 0) {
    const size_t bytes = kWarpsPerCta * warp_smem_bytes(warp_max_m);
    err = set_smem((const void*)mcf_warp_kernel, bytes);
    if (err == cudaSuccess) {
      mcf_warp_kernel<<<(n_warp + kWarpsPerCta - 1) / kWarpsPerCta,
                        kWarpsPerCta * 32, bytes, s>>>(
          c, h, l, o, z, f, inf, 0, n_warp, warp_max_m, max_aug);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess && n_block > 0) {
    const size_t bytes =
        (size_t)block_max_m * block_max_m * sizeof(long long);
    err = set_smem((const void*)mcf_block_kernel<true>, bytes);
    if (err == cudaSuccess) {
      mcf_block_kernel<true><<<n_block, kBlockThreads, bytes, s>>>(
          c, h, l, o, z, f, inf, nullptr, n_warp, max_aug);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess && n_global > 0) {
    mcf_block_kernel<false><<<n_global, kBlockThreads, 0, s>>>(
        c, h, l, o, z, f, inf, (long long*)workspace, n_warp + n_block,
        max_aug);
    err = cudaGetLastError();
  }
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
