// Shared interface to the native lemon-exact NetworkSimplex (lemonns.cc).
#pragma once

#include <cstdint>
#include <vector>

// Solve the min-cost circulation (lower bounds, upper = INF) on a
// flow.Graph-shaped problem: n_nodes nodes (creation order 0..n-1; node
// M-2 = source, M-1 = sink by convention of add_sink_source), arcs given
// in creation order by (src, dst) with per-arc cost/lower (0 default).
// Fills flow (per graph-arc, creation order) and returns true, or returns
// false when the problem is INFEASIBLE/UNBOUNDED (matching the Python
// oracle assembly/lemonns.py returning None).
bool ns_solve(int64_t n_nodes,
              const std::vector<int64_t>& src,
              const std::vector<int64_t>& dst,
              const std::vector<int64_t>& cost,
              const std::vector<int64_t>& lower,
              std::vector<int64_t>& flow_out);
