// Batched min-cost circulation with lower bounds, one padded node bucket of
// loci, on Hopper.
//
// Replaces the XLA program strawberry_tpu/assembly/device.py::_mcf_bucket
// (behind STRAWB_DEVICE_MCF=1) and computes what it computes: the
// successive-shortest-path algorithm of assembly/mincostflow.py::solve_dense,
// so the flows are array-equal to the host solver's.
//
// Per locus b (inputs cost (B,M,M) int64, has_arc (B,M,M) bool, lower
// (B,M,M) int64, active (B) bool):
//   * flow starts at lower; excess = in - out per node.
//   * While some node has positive excess (at most max_aug augmentations):
//     - residual cost of u->v: the cheaper of the forward arc (cost) and the
//       backward residual of arc v->u (-cost, where flow > lower); ties go
//       forward. INF = 2^50 marks "no residual arc".
//     - synchronous (Jacobi) Bellman-Ford from every excess node, M rounds:
//       cand = dist[u] + rc[u][v] (INF where rc >= INF, no saturation),
//       the first u of the minimum wins, and dist/pred change only on a
//       strict improvement;
//     - t = the first deficit node of least distance; if its distance is
//       >= INF the locus is infeasible and stops;
//     - walk pred back from t to a node with no predecessor (the source),
//       taking the bottleneck of the backward residuals on the path, and
//       push min(bottleneck, excess[source], -excess[t]) along it.
//   * A locus that hits max_aug returns its flow unmarked; inactive
//     (padding) loci return lower.
//
// What bounds it on this card: each augmentation runs up to M rounds of an
// M x M min-plus sweep, so the work is rounds * M^2 int64 loads of the
// residual-cost matrix, which at M = 256 is 512 KB a locus and lives in L2
// (shared memory holds at most 227 KB). The design: one CTA of 256 threads
// per locus, so the host never synchronizes inside the loop. The residual
// costs are computed once per augmentation into a per-locus workspace in
// global memory; in each round, k = 256/M threads split the u range of a
// node v and read rc[u][v] with neighbouring threads on neighbouring v
// (coalesced), then the partial minima are combined in u order, which
// keeps the first-index tie rule. dist/pred are double-buffered in shared
// memory, so every node reads the previous round's dist (an in-place update
// would change pred on ties). The rounds stop once one changes nothing,
// since a fixed point stays fixed. The path walk and the push are serial
// and short; thread 0 runs them. The flow is updated in place in the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNodes = 256;
constexpr long long kInf = 1LL << 50;
constexpr long long kNone = 0x7fffffffffffffffLL;  // above any candidate

// Residual cost of u->v under the current flow; *use_bwd tells whether the
// backward residual of arc v->u was the cheaper (strictly).
__device__ long long residual_cost(const long long* __restrict__ cost,
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

// flow and rc_ws are written inside the kernel and read by other threads
// after a barrier, so they are not read through the non-coherent path.
__global__ void __launch_bounds__(kThreads)
mcf_bucket_kernel(const long long* __restrict__ cost,
                  const unsigned char* __restrict__ has_arc,
                  const long long* __restrict__ lower,
                  const unsigned char* __restrict__ active, long long* flow,
                  unsigned char* __restrict__ infeasible_out, long long* rc_ws,
                  int M, int max_aug) {
  __shared__ long long excess[kMaxNodes];
  __shared__ long long dist[2][kMaxNodes];
  __shared__ int pred[2][kMaxNodes];
  __shared__ long long part_best[kThreads];
  __shared__ int part_arg[kThreads];
  __shared__ unsigned int onpath[kMaxNodes * kMaxNodes / 32];
  __shared__ int path_u[kMaxNodes];
  __shared__ int path_v[kMaxNodes];
  __shared__ unsigned char path_bwd[kMaxNodes];
  __shared__ int infeasible_flag;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t MM = (size_t)M * M;
  const long long* C = cost + b * MM;
  const unsigned char* H = has_arc + b * MM;
  const long long* L = lower + b * MM;
  long long* F = flow + b * MM;
  long long* RC = rc_ws + b * MM;

  for (size_t e = tid; e < MM; e += nt) F[e] = L[e];
  for (int w = tid; w < (int)((MM + 31) / 32); w += nt) onpath[w] = 0;
  if (tid == 0) infeasible_flag = 0;
  __syncthreads();
  for (int v = tid; v < M; v += nt) {
    long long in = 0, out = 0;
    for (int u = 0; u < M; ++u) {
      in += F[(size_t)u * M + v];
      out += F[(size_t)v * M + u];
    }
    excess[v] = in - out;
  }
  __syncthreads();

  // Bellman-Ford layout: thread (j, v) = (tid / M, tid % M) scans the
  // chunk j of u for node v; k chunks per node.
  const int k = nt / M;
  const int j = tid / M;
  const int bv = tid % M;
  const int chunk = (M + k - 1) / k;

  if (active[b]) {  // uniform across the block
    for (int it = 0; it < max_aug; ++it) {
      int pos = 0;
      for (int v = tid; v < M; v += nt) pos |= excess[v] > 0;
      if (!__syncthreads_or(pos)) break;  // no excess left: done

      for (size_t e = tid; e < MM; e += nt)
        RC[e] = residual_cost(C, H, L, F, M, (int)(e / M), (int)(e % M),
                              nullptr);
      for (int v = tid; v < M; v += nt) {
        dist[0][v] = excess[v] > 0 ? 0 : kInf;
        pred[0][v] = -1;
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
            const long long r = RC[(size_t)u * M + bv];
            const long long cand = r >= kInf ? kInf : dist[cur][u] + r;
            if (u == u0 || cand < best) {
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

      if (tid == 0) {
        int t = 0;
        long long td = kNone;
        for (int v = 0; v < M; ++v) {
          const long long x = excess[v] < 0 ? dist[cur][v] : kInf;
          if (v == 0 || x < td) {
            td = x;
            t = v;
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
            const size_t bit = (size_t)u * M + v;
            const unsigned int mask = 1u << (bit & 31);
            if (!(onpath[bit >> 5] & mask)) {
              onpath[bit >> 5] |= mask;
              bool bwd;
              residual_cost(C, H, L, F, M, u, v, &bwd);
              if (bwd) {
                const long long cap =
                    F[(size_t)v * M + u] - L[(size_t)v * M + u];
                bott = cap < bott ? cap : bott;
              }
              path_u[n] = u;
              path_v[n] = v;
              path_bwd[n] = bwd;
              ++n;
            }
            v = u;
          }
          long long amt = bott;
          if (excess[src] < amt) amt = excess[src];
          if (-excess[t] < amt) amt = -excess[t];
          for (int q = 0; q < n; ++q) {
            const int u = path_u[q], w = path_v[q];
            if (path_bwd[q])
              F[(size_t)w * M + u] -= amt;  // cancel on arc w->u
            else
              F[(size_t)u * M + w] += amt;
            excess[u] -= amt;
            excess[w] += amt;
            const size_t bit = (size_t)u * M + w;
            onpath[bit >> 5] &= ~(1u << (bit & 31));
          }
        }
      }
      __syncthreads();
      if (infeasible_flag) break;
    }
  }
  if (tid == 0) infeasible_out[b] = infeasible_flag != 0;
}

}  // namespace

extern "C" {

int strawb_mcf_bucket(const void* cost, const void* has_arc,
                      const void* lower, const void* active, void* flow_out,
                      void* infeasible_out, void* workspace, int B, int M,
                      int max_aug, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (M <= 0 || M > kMaxNodes || max_aug < 0) return cudaErrorInvalidValue;
  mcf_bucket_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)cost, (const unsigned char*)has_arc,
      (const long long*)lower, (const unsigned char*)active,
      (long long*)flow_out, (unsigned char*)infeasible_out,
      (long long*)workspace, M, max_aug);
  return cudaGetLastError();
}

const char* strawb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
