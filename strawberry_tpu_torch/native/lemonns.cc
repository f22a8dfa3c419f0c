// lemon-exact NetworkSimplex for the CMPC flow solve — C++ twin of the
// Python oracle assembly/lemonns.py (which documents the algorithm and the
// reference anchors: src/assembly.cpp:897-904 invoking the vendored
// include/lemon/network_simplex.h with int Value/Cost, BLOCK_SEARCH
// pivoting, mixed internal arc order and the initial-pivot heuristic).
//
// DISCLOSURE: this is a deliberate, faithful reimplementation of lemon
// 1.3's NetworkSimplex (third-party library code the reference vendors,
// not the reference author's work). The golden byte-parity contract
// requires landing on lemon's exact optimum on DEGENERATE flow problems,
// which pins every pivoting/tie-breaking choice — an original solver
// provably diverges on ~0.1% of realistic loci (the r2 SSP did). See
// COMPONENTS.md row 16 and assembly/lemonns.py for the full adjudication.
// Every tie-breaking rule matters: on degenerate optima the assembled
// transcript structures read the particular optimal flow this pivoting
// lands on. Arithmetic is int64 like the Python oracle's unbounded ints
// (the reference's int32 does not overflow on these graphs; int64 is a
// strict superset of both), with INF == MAX == INT32_MAX kept exactly.
// Validated flow-for-flow against the oracle (tests/test_native_ns.py)
// and by the golden suites.

#include "lemonns.h"

#include <cmath>
#include <cstdint>

namespace {
typedef int64_t i64;

const i64 INT32MAX = 2147483647LL;
const i64 MAX = INT32MAX;
const i64 INF = INT32MAX;  // int has no infinity (network_simplex.h:653)
const i64 ART_COST = INT32MAX / 2 + 1;

const int STATE_UPPER = -1;
const int STATE_TREE = 0;
const int STATE_LOWER = 1;
const int DIR_DOWN = -1;
const int DIR_UP = 1;

struct NS {
  i64 n, m;
  // internal arrays (internal ids)
  std::vector<i64> src, dst, cost, lower, cap, flow, supply, pi;
  std::vector<int> state, pred_dir;
  std::vector<i64> parent, pred, thread, rev_thread, succ_num, last_succ;
  i64 root, search_arc_num, all_arc_num;
  // pivot state
  i64 in_arc = -1, join = -1, u_in = -1, v_in = -1, u_out = -1, delta = 0;
  // graph-side adjacency (graph ids; out/in lists in arc-creation order)
  std::vector<std::vector<i64>> g_out, g_in;
  std::vector<i64> pos;  // graph arc id -> internal id

  void find_join() {
    i64 u = src[in_arc], v = dst[in_arc];
    while (u != v) {
      if (succ_num[u] < succ_num[v])
        u = parent[u];
      else
        v = parent[v];
    }
    join = u;
  }

  bool find_leaving() {
    i64 first, second;
    if (state[in_arc] == STATE_LOWER) {
      first = src[in_arc];
      second = dst[in_arc];
    } else {
      first = dst[in_arc];
      second = src[in_arc];
    }
    delta = cap[in_arc];
    int result = 0;
    i64 uo = -1;
    for (i64 u = first; u != join; u = parent[u]) {
      i64 e = pred[u];
      i64 d = flow[e];
      if (pred_dir[u] == DIR_DOWN) {
        i64 c = cap[e];
        d = c >= MAX ? INF : c - d;
      }
      if (d < delta) {
        delta = d;
        uo = u;
        result = 1;
      }
    }
    for (i64 u = second; u != join; u = parent[u]) {
      i64 e = pred[u];
      i64 d = flow[e];
      if (pred_dir[u] == DIR_UP) {
        i64 c = cap[e];
        d = c >= MAX ? INF : c - d;
      }
      if (d <= delta) {
        delta = d;
        uo = u;
        result = 2;
      }
    }
    if (result == 1) {
      u_in = first;
      v_in = second;
    } else {
      u_in = second;
      v_in = first;
    }
    u_out = uo;
    return result != 0;
  }

  void change_flow(bool change) {
    if (delta > 0) {
      i64 val = (i64)state[in_arc] * delta;
      flow[in_arc] += val;
      for (i64 u = src[in_arc]; u != join; u = parent[u])
        flow[pred[u]] -= (i64)pred_dir[u] * val;
      for (i64 u = dst[in_arc]; u != join; u = parent[u])
        flow[pred[u]] += (i64)pred_dir[u] * val;
    }
    if (change) {
      state[in_arc] = STATE_TREE;
      state[pred[u_out]] =
          flow[pred[u_out]] == 0 ? STATE_LOWER : STATE_UPPER;
    } else {
      state[in_arc] = -state[in_arc];
    }
  }

  void update_tree() {
    i64 old_rev_thread = rev_thread[u_out];
    i64 old_succ_num = succ_num[u_out];
    i64 old_last_succ = last_succ[u_out];
    i64 v_out = parent[u_out];

    if (u_in == u_out) {
      parent[u_in] = v_in;
      pred[u_in] = in_arc;
      pred_dir[u_in] = u_in == src[in_arc] ? DIR_UP : DIR_DOWN;
      if (thread[v_in] != u_out) {
        i64 after = thread[old_last_succ];
        thread[old_rev_thread] = after;
        rev_thread[after] = old_rev_thread;
        after = thread[v_in];
        thread[v_in] = u_out;
        rev_thread[u_out] = v_in;
        thread[old_last_succ] = after;
        rev_thread[after] = old_last_succ;
      }
    } else {
      i64 thread_continue =
          old_rev_thread == v_in ? thread[old_last_succ] : thread[v_in];
      i64 stem = u_in;
      i64 par_stem = v_in;
      i64 last = last_succ[u_in];
      i64 after = thread[last];
      thread[v_in] = u_in;
      std::vector<i64> dirty_revs{v_in};
      while (stem != u_out) {
        i64 next_stem = parent[stem];
        thread[last] = next_stem;
        dirty_revs.push_back(last);
        i64 before = rev_thread[stem];
        thread[before] = after;
        rev_thread[after] = before;
        parent[stem] = par_stem;
        par_stem = stem;
        stem = next_stem;
        last = last_succ[stem] == last_succ[par_stem]
                   ? rev_thread[par_stem]
                   : last_succ[stem];
        after = thread[last];
      }
      parent[u_out] = par_stem;
      thread[last] = thread_continue;
      rev_thread[thread_continue] = last;
      last_succ[u_out] = last;
      if (old_rev_thread != v_in) {
        thread[old_rev_thread] = after;
        rev_thread[after] = old_rev_thread;
      }
      for (i64 u : dirty_revs) rev_thread[thread[u]] = u;
      i64 tmp_sc = 0;
      i64 tmp_ls = last_succ[u_out];
      i64 u = u_out;
      i64 p = parent[u];
      while (u != u_in) {
        pred[u] = pred[p];
        pred_dir[u] = -pred_dir[p];
        tmp_sc += succ_num[u] - succ_num[p];
        succ_num[u] = tmp_sc;
        last_succ[p] = tmp_ls;
        u = p;
        p = parent[u];
      }
      pred[u_in] = in_arc;
      pred_dir[u_in] = u_in == src[in_arc] ? DIR_UP : DIR_DOWN;
      succ_num[u_in] = old_succ_num;
    }

    i64 up_limit_out = last_succ[join] == v_in ? join : -1;
    i64 last_succ_out = last_succ[u_out];
    for (i64 u = v_in; u != -1 && last_succ[u] == v_in; u = parent[u])
      last_succ[u] = last_succ_out;
    if (join != old_rev_thread && v_in != old_rev_thread) {
      for (i64 u = v_out;
           u != up_limit_out && last_succ[u] == old_last_succ;
           u = parent[u])
        last_succ[u] = old_rev_thread;
    } else if (last_succ_out != old_last_succ) {
      for (i64 u = v_out;
           u != up_limit_out && last_succ[u] == old_last_succ;
           u = parent[u])
        last_succ[u] = last_succ_out;
    }
    for (i64 u = v_in; u != join; u = parent[u]) succ_num[u] += old_succ_num;
    for (i64 u = v_out; u != join; u = parent[u]) succ_num[u] -= old_succ_num;
  }

  void update_potential() {
    i64 sigma = pi[v_in] - pi[u_in] - (i64)pred_dir[u_in] * cost[in_arc];
    i64 end = thread[last_succ[u_in]];
    for (i64 u = u_in; u != end; u = thread[u]) pi[u] += sigma;
  }
};

}  // namespace

bool ns_solve(int64_t n, const std::vector<int64_t>& g_src,
              const std::vector<int64_t>& g_dst,
              const std::vector<int64_t>& g_cost,
              const std::vector<int64_t>& g_lower,
              std::vector<int64_t>& flow_out) {
  i64 m = (i64)g_src.size();
  if (n == 0) return false;

  NS ns;
  ns.n = n;
  ns.m = m;
  // ---- internal ids (ListDigraph iteration order) -----------------------
  // node internal id: NodeIt iterates newest-first -> nid[u] = n-1-u
  // ArcIt order: nodes newest-first, each node's out-arcs newest-first
  ns.g_out.assign(n, {});
  ns.g_in.assign(n, {});
  for (i64 a = 0; a < m; ++a) {
    ns.g_out[g_src[a]].push_back(a);
    ns.g_in[g_dst[a]].push_back(a);
  }
  ns.pos.assign(m, 0);
  {
    std::vector<i64> arcit;
    arcit.reserve(m);
    for (i64 u = n; u-- > 0;) {
      const auto& o = ns.g_out[u];
      for (size_t k = o.size(); k-- > 0;) arcit.push_back(o[k]);
    }
    // arc mixing (network_simplex.h:938-948)
    if (m > 0 && n > 1) {
      i64 skip = m / n > 3 ? m / n : 3;
      i64 i = 0, j = 0;
      for (i64 a : arcit) {
        ns.pos[a] = i;
        i += skip;
        if (i >= m) i = ++j;
      }
    } else {
      for (i64 k = 0; k < m; ++k) ns.pos[arcit[k]] = k;
    }
  }

  i64 root = n;
  i64 all_nodes = n + 1;
  i64 max_arcs = m + 2 * n;
  ns.src.assign(max_arcs, 0);
  ns.dst.assign(max_arcs, 0);
  ns.cost.assign(max_arcs, 0);
  ns.lower.assign(m, 0);
  ns.cap.assign(max_arcs, 0);
  ns.flow.assign(max_arcs, 0);
  ns.state.assign(max_arcs, 0);
  ns.supply.assign(all_nodes, 0);
  ns.pi.assign(all_nodes, 0);
  ns.parent.assign(all_nodes, 0);
  ns.pred.assign(all_nodes, 0);
  ns.pred_dir.assign(all_nodes, 0);
  ns.thread.assign(all_nodes, 0);
  ns.rev_thread.assign(all_nodes, 0);
  ns.succ_num.assign(all_nodes, 0);
  ns.last_succ.assign(all_nodes, 0);

  auto nid = [&](i64 u) { return n - 1 - u; };
  for (i64 a = 0; a < m; ++a) {
    i64 i = ns.pos[a];
    ns.src[i] = nid(g_src[a]);
    ns.dst[i] = nid(g_dst[a]);
    ns.cost[i] = g_cost[a];
    ns.lower[i] = g_lower[a];
  }

  // ---- init(): lower bounds shift supplies (circulation: all zero pre-
  // shift); upper == INF == MAX so cap stays INF
  for (i64 i = 0; i < m; ++i) {
    i64 c = ns.lower[i];
    ns.cap[i] = INF;
    ns.supply[ns.src[i]] -= c;
    ns.supply[ns.dst[i]] += c;
    ns.flow[i] = 0;
    ns.state[i] = STATE_LOWER;
  }

  ns.parent[root] = -1;
  ns.pred[root] = -1;
  ns.thread[root] = 0;
  ns.rev_thread[0] = root;
  ns.succ_num[root] = n + 1;
  ns.last_succ[root] = root - 1;
  ns.supply[root] = 0;
  ns.pi[root] = 0;

  // EQ supply branch: one artificial arc per node
  ns.search_arc_num = m;
  ns.all_arc_num = m + n;
  for (i64 u = 0; u < n; ++u) {
    i64 e = m + u;
    ns.parent[u] = root;
    ns.pred[u] = e;
    ns.thread[u] = u + 1;
    ns.rev_thread[u + 1] = u;
    ns.succ_num[u] = 1;
    ns.last_succ[u] = u;
    ns.cap[e] = INF;
    ns.state[e] = STATE_TREE;
    if (ns.supply[u] >= 0) {
      ns.pred_dir[u] = DIR_UP;
      ns.pi[u] = 0;
      ns.src[e] = u;
      ns.dst[e] = root;
      ns.flow[e] = ns.supply[u];
      ns.cost[e] = 0;
    } else {
      ns.pred_dir[u] = DIR_DOWN;
      ns.pi[u] = ART_COST;
      ns.src[e] = root;
      ns.dst[e] = u;
      ns.flow[e] = -ns.supply[u];
      ns.cost[e] = ART_COST;
    }
  }

  // ---- initialPivots() (network_simplex.h:1478-1538) --------------------
  {
    i64 total = 0;
    std::vector<i64> supply_nodes, demand_nodes;  // GRAPH ids, NodeIt order
    for (i64 node = n; node-- > 0;) {
      i64 curr = ns.supply[nid(node)];
      if (curr > 0) {
        total += curr;
        supply_nodes.push_back(node);
      } else if (curr < 0) {
        demand_nodes.push_back(node);
      }
    }
    std::vector<i64> arc_vector;  // internal ids
    if (total > 0) {
      if (supply_nodes.size() == 1 && demand_nodes.size() == 1) {
        // reverse DFS (stack) from the demand node over in-arcs
        std::vector<char> reached(n, 0);
        i64 s = supply_nodes[0], t = demand_nodes[0];
        std::vector<i64> stack{t};
        reached[t] = 1;
        while (!stack.empty()) {
          i64 v = stack.back();
          stack.pop_back();
          if (v == s) break;
          const auto& in = ns.g_in[v];
          for (size_t k = in.size(); k-- > 0;) {
            i64 a = in[k];
            i64 u = g_src[a];
            if (reached[u]) continue;
            i64 j = ns.pos[a];
            if (ns.cap[j] >= total) {
              arc_vector.push_back(j);
              reached[u] = 1;
              stack.push_back(u);
            }
          }
        }
      } else {
        for (i64 v : demand_nodes) {
          i64 min_cost = INT32MAX;
          i64 min_arc = -1;
          const auto& in = ns.g_in[v];
          for (size_t k = in.size(); k-- > 0;) {
            i64 a = in[k];
            i64 c = ns.cost[ns.pos[a]];
            if (c < min_cost) {
              min_cost = c;
              min_arc = a;
            }
          }
          if (min_arc >= 0) arc_vector.push_back(ns.pos[min_arc]);
        }
      }
      for (i64 e : arc_vector) {
        ns.in_arc = e;
        if ((i64)ns.state[e] *
                (ns.cost[e] + ns.pi[ns.src[e]] - ns.pi[ns.dst[e]]) >= 0)
          continue;
        ns.find_join();
        bool change = ns.find_leaving();
        if (ns.delta >= MAX) return false;  // UNBOUNDED
        ns.change_flow(change);
        if (change) {
          ns.update_tree();
          ns.update_potential();
        }
      }
    }
  }

  // ---- main loop: BlockSearchPivotRule ----------------------------------
  i64 block_size = (i64)std::sqrt((double)ns.search_arc_num);
  if (block_size < 10) block_size = 10;
  i64 next_arc = 0;

  auto find_entering = [&]() -> bool {
    // BlockSearchPivotRule::findEnteringArc (network_simplex.h:377-409):
    // two wrapped scans from _next_arc; a block boundary with a negative
    // minimum jumps straight to search_end (e keeps its value)
    i64 minimum = 0;
    i64 cnt = block_size;
    bool goto_end = false;
    i64 e = next_arc;
    while (e != ns.search_arc_num) {
      i64 c = (i64)ns.state[e] *
              (ns.cost[e] + ns.pi[ns.src[e]] - ns.pi[ns.dst[e]]);
      if (c < minimum) {
        minimum = c;
        ns.in_arc = e;
      }
      if (--cnt == 0) {
        if (minimum < 0) {
          goto_end = true;
          break;
        }
        cnt = block_size;
      }
      ++e;
    }
    if (!goto_end) {
      e = 0;
      while (e != next_arc) {
        i64 c = (i64)ns.state[e] *
                (ns.cost[e] + ns.pi[ns.src[e]] - ns.pi[ns.dst[e]]);
        if (c < minimum) {
          minimum = c;
          ns.in_arc = e;
        }
        if (--cnt == 0) {
          if (minimum < 0) {
            goto_end = true;
            break;
          }
          cnt = block_size;
        }
        ++e;
      }
      if (!goto_end && minimum >= 0) return false;
    }
    next_arc = e;
    return true;
  };

  while (find_entering()) {
    ns.find_join();
    bool change = ns.find_leaving();
    if (ns.delta >= MAX) return false;  // UNBOUNDED
    ns.change_flow(change);
    if (change) {
      ns.update_tree();
      ns.update_potential();
    }
  }

  // feasibility: artificial arcs must be empty
  for (i64 e = ns.search_arc_num; e < ns.all_arc_num; ++e)
    if (ns.flow[e] != 0) return false;  // INFEASIBLE

  // transform back (add the lower bounds)
  for (i64 i = 0; i < m; ++i)
    if (ns.lower[i] != 0) ns.flow[i] += ns.lower[i];

  flow_out.resize(m);
  for (i64 a = 0; a < m; ++a) flow_out[a] = ns.flow[ns.pos[a]];
  return true;
}

// ---- ctypes test surface: solve one problem from flat arrays ------------
extern "C" {

// Returns 1 on success (out_flow filled, length m), 0 on
// INFEASIBLE/UNBOUNDED (oracle returns None).
int32_t strawb_ns_solve(int64_t n_nodes, int64_t m, const int64_t* src,
                        const int64_t* dst, const int64_t* cost,
                        const int64_t* lower, int64_t* out_flow) {
  std::vector<int64_t> vsrc(src, src + m), vdst(dst, dst + m),
      vcost(cost, cost + m), vlower(lower, lower + m), flow;
  if (!ns_solve(n_nodes, vsrc, vdst, vcost, vlower, flow)) return 0;
  for (int64_t a = 0; a < m; ++a) out_flow[a] = flow[a];
  return 1;
}

}  // extern "C"
