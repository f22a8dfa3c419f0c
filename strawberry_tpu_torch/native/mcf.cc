// Dense min-cost circulation with lower bounds — C++ fast path for the
// shared deterministic spec in assembly/mincostflow.py (lower-bound
// transformation + successive shortest paths with synchronous Bellman-Ford,
// lowest-index argmin ties, strict-improvement predecessors). All integer
// arithmetic, so results are identical to the numpy spec (and to the
// batched device kernel validated against it). Host-routed per-locus flow
// problems (ref: lemon NetworkSimplex at src/assembly.cpp:896-904) are tiny
// (M ~ 10), so a scalar loop beats numpy's per-call overhead ~20x.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {
typedef int64_t i64;
const i64 INF = (i64)1 << 50;
}

extern "C" {

// Returns 1 = solved (flow_out filled), 0 = infeasible, -1 = internal
// inconsistency (caller falls back to the numpy spec, which asserts).
int32_t strawb_mcf_dense(i64 M, const i64* cost, const uint8_t* has_arc,
                         const i64* lower, i64* flow) {
  std::vector<i64> excess(M, 0);
  for (i64 u = 0; u < M; ++u)
    for (i64 v = 0; v < M; ++v) {
      i64 f = lower[u * M + v];
      flow[u * M + v] = f;
      excess[v] += f;
      excess[u] -= f;
    }

  std::vector<i64> rc(M * M), dist(M), ndist(M), pred(M);
  std::vector<uint8_t> use_bwd(M * M);
  std::vector<i64> bwd_cap(M * M);

  for (;;) {
    bool any_pos = false;
    for (i64 v = 0; v < M; ++v)
      if (excess[v] > 0) { any_pos = true; break; }
    if (!any_pos) break;

    // residual: forward (has_arc, +c, cap inf); backward (arc v->u with
    // flow above lower, -c, cap flow-lower); cheaper wins, tie -> forward
    for (i64 u = 0; u < M; ++u)
      for (i64 v = 0; v < M; ++v) {
        i64 cap = flow[v * M + u] - lower[v * M + u];
        bwd_cap[u * M + v] = cap;
        i64 rf = has_arc[u * M + v] ? cost[u * M + v] : INF;
        i64 rb = (has_arc[v * M + u] && cap > 0) ? -cost[v * M + u] : INF;
        if (rb < rf) {
          rc[u * M + v] = rb;
          use_bwd[u * M + v] = 1;
        } else {
          rc[u * M + v] = rf;
          use_bwd[u * M + v] = 0;
        }
      }

    for (i64 v = 0; v < M; ++v) {
      dist[v] = excess[v] > 0 ? 0 : INF;
      pred[v] = -1;
    }
    for (i64 it = 0; it < M; ++it) {
      bool changed = false;
      for (i64 v = 0; v < M; ++v) {
        i64 best = INF + 1;  // any real cand (incl. INF) replaces this
        i64 bu = 0;
        for (i64 u = 0; u < M; ++u) {
          i64 r = rc[u * M + v];
          i64 cand = r >= INF ? INF : dist[u] + r;
          if (cand < best) {
            best = cand;
            bu = u;
          }
        }
        if (best < dist[v]) {
          ndist[v] = best;
          pred[v] = bu;
          changed = true;
        } else {
          ndist[v] = dist[v];
        }
      }
      dist.swap(ndist);
      if (!changed) break;  // fixed point: further rounds are no-ops
    }

    bool any_neg = false;
    for (i64 v = 0; v < M; ++v)
      if (excess[v] < 0) { any_neg = true; break; }
    if (!any_neg) break;
    i64 t = -1, tbest = INF;
    for (i64 v = 0; v < M; ++v)
      if (excess[v] < 0 && dist[v] < tbest) {
        tbest = dist[v];
        t = v;
      }
    if (t < 0) return 0;  // all deficits unreachable: infeasible

    // walk predecessors to a surplus source, bottleneck, apply
    std::vector<i64> path_u, path_v;
    i64 v = t;
    while (pred[v] != -1) {
      i64 u = pred[v];
      path_u.push_back(u);
      path_v.push_back(v);
      v = u;
    }
    i64 s = v;
    i64 b = excess[s] < -excess[t] ? excess[s] : -excess[t];
    for (size_t k = 0; k < path_u.size(); ++k)
      if (use_bwd[path_u[k] * M + path_v[k]]) {
        i64 cap = bwd_cap[path_u[k] * M + path_v[k]];
        if (cap < b) b = cap;
      }
    if (b < 1) return -1;  // spec asserts here; fall back to numpy
    for (size_t k = 0; k < path_u.size(); ++k) {
      i64 u = path_u[k], w = path_v[k];
      if (use_bwd[u * M + w]) flow[w * M + u] -= b;
      else flow[u * M + w] += b;
    }
    excess[s] -= b;
    excess[t] += b;
  }
  return 1;
}

}  // extern "C"
