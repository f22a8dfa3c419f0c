// Per-locus assembly prep — the complete host half of assembleContig in one
// native call: coverage + intron table (alignments.cpp:1838-1900), the three
// intron filters (:1902-2036), splicingGraph with its exon filters
// (assembly.cpp:20-28,174-547), and createNetwork/addWeight/findConstraints
// + add_sink_source (assembly.cpp:549-811,91-112). Ports the Python oracles
// (assembly/coverage.py, assembly/splice_graph.py, assembly/flow.py)
// exactly, including:
//   * intron bookkeeping in FIRST-ENCOUNTER order (single_bars stable-sort
//     ties follow dict insertion order in the oracle)
//   * numpy pairwise f64-of-f32 sums for every coverage reduction
//   * the remove_low_cov_exon index-skew quirk (cov index keeps advancing
//     after a deletion) and the exclusive-end exon sums
//   * lemon ListDigraph iteration orders (nodes/out-arcs newest-first) for
//     addWeight, find_arc, BFS constraint expansion, and add_sink_source
// Output: exon segs (+avg doc), the arc list in creation order with
// cost/lower maps, path constraints, and the total node count — enough for
// the Python side to rebuild the Graph, the dense flow problem, and run
// flowDecompose/reconstruct unchanged.

#include "lemonns.h"
#include "perfcnt.h"
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <pthread.h>
#include <set>
#include <thread>
#include <utility>
#include <vector>

using std::size_t;

namespace {
typedef int64_t i64;
typedef int32_t i32;
typedef int8_t i8;

// numpy pairwise sum with f64 accumulator over f32 input (np.sum(a, dtype=
// np.float64) semantics: convert each element, 8-accumulator unrolled
// blocks, recursive split above 128)
static double np_sum_f32(const float* a, i64 n) {
  if (n < 8) {
    double res = 0.0;
    for (i64 i = 0; i < n; ++i) res += (double)a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int k = 0; k < 8; ++k) r[k] = (double)a[k];
    i64 i = 8;
    for (; i + 8 <= n; i += 8)
      for (int k = 0; k < 8; ++k) r[k] += (double)a[i + k];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += (double)a[i];
    return res;
  }
  i64 n2 = n / 2;
  n2 -= n2 % 8;
  return np_sum_f32(a, n2) + np_sum_f32(a + n2, n - n2);
}

// A&S 7.1.26 normal CDF, exactly as common.h:112-133 / core/cluster.phi
static double phi(double x) {
  if (std::isnan(x)) return x;
  const double a1 = 0.254829592, a2 = -0.284496736, a3 = 1.421413741,
               a4 = -1.453152027, a5 = 1.061405429, p = 0.3275911;
  double sign = x < 0 ? -1.0 : 1.0;
  x = std::fabs(x) / std::sqrt(2.0);
  double t = 1.0 / (1.0 + p * x);
  double y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t *
                       std::exp(-x * x);
  return 0.5 * (1.0 + sign * y);
}

// getMedian (common.h:188-199) over f32 values
static double median_f32(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  if (n == 0) return 0.0;
  if (n % 2 == 0) return ((double)v[n / 2] + (double)v[n / 2 - 1]) / 2.0;
  return (double)v[n / 2];
}

static double median_f64(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  if (n == 0) return 0.0;
  if (n % 2 == 0) return (v[n / 2] + v[n / 2 - 1]) / 2.0;
  return v[n / 2];
}

struct Intron {
  i64 l, r;
  double tot = 0.0, small = 0.0;
  bool alive = true;
};

// lemon ListDigraph clone (assembly/flow.Graph): prepend iteration orders
struct Graph {
  std::vector<i64> src, dst;
  std::vector<std::vector<i64>> out, in;
  i64 add_node() {
    out.push_back({});
    in.push_back({});
    return (i64)out.size() - 1;
  }
  i64 add_arc(i64 u, i64 v) {
    i64 a = (i64)src.size();
    src.push_back(u);
    dst.push_back(v);
    out[u].push_back(a);
    in[v].push_back(a);
    return a;
  }
  i64 find_arc(i64 u, i64 v) const {  // OutArcIt: newest first
    const auto& o = out[u];
    for (size_t k = o.size(); k-- > 0;)
      if (dst[o[k]] == v) return o[k];
    return -1;
  }
  // lemon Bfs: FIFO, neighbors in OutArcIt (newest-first) order
  bool bfs_path(i64 s, i64 t, std::vector<i64>& path) const {
    std::vector<i64> pred(out.size(), -2);
    pred[s] = -1;
    std::vector<i64> q{s};
    size_t qi = 0;
    while (qi < q.size()) {
      i64 u = q[qi++];
      const auto& o = out[u];
      for (size_t k = o.size(); k-- > 0;) {
        i64 w = dst[o[k]];
        if (pred[w] == -2) {
          pred[w] = u;
          q.push_back(w);
        }
      }
    }
    if (pred[t] == -2) return false;
    path.clear();
    for (i64 v = t; v != -1; v = pred[v]) path.push_back(v);
    std::reverse(path.begin(), path.end());
    return true;
  }
};

}  // namespace

extern "C" {

struct StrawbAsm {
  i32 status = 0;  // 0 = empty task, 1 = network built
  std::vector<i64> ex_l, ex_r;
  std::vector<double> ex_doc;
  std::vector<i64> arc_src, arc_dst, arc_cost, arc_lower;
  std::vector<i64> cstr_off;
  std::vector<i64> cstr_arcs;
  i64 M = 0;       // total nodes incl. source/sink
  i64 ne = 0;
  // full-solve results (solved == 1): final transcript feature chains
  // after NetworkSimplex + flowDecompose + reconstruct + assemble_2_contigs
  // (filtered, merged, sorted, deduped — the Python side only wraps them
  // as Contigs and names them)
  i32 solved = 0;
  std::vector<i64> tx_off;  // per-transcript feature offsets (ntx+1)
  std::vector<i8> t_code;
  std::vector<i64> t_left;
  std::vector<i32> t_len;
};

// solveNetwork tail + assemble_2_contigs, exactly as the Python oracles
// (assembly/flow.py reconstruct/flow_decompose/assemble_2_contigs; ref:
// src/assembly.cpp:882-998, include/assembly.h:106-124). Runs on the prep
// worker right after strawb_asmprep so the whole per-locus assembly —
// coverage to final transcripts — is one native job.
static void asm_solve_finish(StrawbAsm* R, i64 min_trans_len,
                             double min_depth_4_contig) {
  strawb_perf::Scope _ps(strawb_perf::kFlowNS);
  R->solved = 1;
  R->tx_off.push_back(0);
  const i64 M = R->M;
  const i64 m = (i64)R->arc_src.size();
  const i64 ne = R->ne;
  const i64 source = M - 2, sink = M - 1;
  const i64 kIntMax = 2147483647LL;

  std::vector<i64> flow;
  if (!ns_solve(M, R->arc_src, R->arc_dst, R->arc_cost, R->arc_lower, flow))
    return;  // INFEASIBLE/UNBOUNDED: oracle returns None -> no transcripts

  // out-arc lists in creation order (iterated newest-first below)
  std::vector<std::vector<i64>> out(M);
  for (i64 a = 0; a < m; ++a) out[R->arc_src[a]].push_back(a);

  struct Feat {
    i8 code;
    i64 left, len;
  };
  std::vector<std::vector<Feat>> transcripts;
  if (ne == 1)
    transcripts.push_back(
        {{0, R->ex_l[0], R->ex_r[0] - R->ex_l[0] + 1}});

  // ---- flow_decompose (assembly.cpp:116-172): greedy cheapest-arc walk;
  // source out-arcs inherit the min cost of their target's out-arcs
  std::vector<std::vector<i64>> paths;
  {
    std::vector<i64> copy_flow = flow;
    std::vector<i64> edge_cost = R->arc_cost;
    for (i64 oa : out[source]) {
      i64 opt = kIntMax;
      i64 cur = R->arc_dst[oa];
      for (i64 o2 : out[cur]) opt = std::min(opt, R->arc_cost[o2]);
      edge_cost[oa] = opt;
    }
    bool dead_end = false;
    for (;;) {
      bool has_flow = false;
      for (i64 oa : out[source])
        if (copy_flow[oa] > 0) {
          has_flow = true;
          break;
        }
      if (!has_flow || dead_end) break;
      std::vector<i64> path;
      i64 cur = source;
      while (cur != sink) {
        i64 opt_arc = -1;
        i64 opt_cost = kIntMax;
        const auto& o = out[cur];
        for (size_t k = o.size(); k-- > 0;) {  // OutArcIt: newest first
          i64 oa = o[k];
          if (copy_flow[oa] > 0 && edge_cost[oa] < opt_cost) {
            opt_cost = edge_cost[oa];
            opt_arc = oa;
          }
        }
        if (opt_arc == -1) {
          // dead end: mirrors reference UB-free assumption; stop decompose
          dead_end = true;
          path.clear();
          break;
        }
        cur = R->arc_dst[opt_arc];
        path.push_back(opt_arc);
      }
      if (dead_end) break;
      for (i64 a : path) copy_flow[a] -= 1;
      paths.push_back(std::move(path));
    }
  }

  // ---- reconstruct (assembly.cpp:925-980): expand constraint shortcut
  // arcs, insert gap introns between non-adjacent exon features
  const i64 ncstr = (i64)R->cstr_off.size() - 1;
  auto exon_feat = [&](i64 node) -> Feat {
    return {0, R->ex_l[node], R->ex_r[node] - R->ex_l[node] + 1};
  };
  auto push_gap = [&](std::vector<Feat>& t, const Feat& f1, const Feat& f2) {
    i64 f1r = f1.left + f1.len - 1;
    if (f2.left - f1r > 1) t.push_back({1, f1r + 1, f2.left - 1 - f1r});
  };
  for (const auto& p : paths) {
    std::vector<Feat> tscp;
    for (size_t i = 1; i < p.size(); ++i) {
      i64 e = p[i];
      i64 arc_s = R->arc_src[e];
      i64 arc_t = R->arc_dst[e];
      bool is_edge = true;
      for (i64 c = 0; c < ncstr; ++c) {
        i64 c0 = R->cstr_off[c], c1 = R->cstr_off[c + 1];
        i64 ps = R->arc_src[R->cstr_arcs[c0]];
        i64 pt = R->arc_dst[R->cstr_arcs[c1 - 1]];
        if (arc_s == ps && arc_t == pt) {
          is_edge = false;
          for (i64 idx = c0; idx + 1 < c1; ++idx) {
            Feat f1 = exon_feat(R->arc_src[R->cstr_arcs[idx]]);
            Feat f2 = exon_feat(R->arc_src[R->cstr_arcs[idx + 1]]);
            tscp.push_back(f1);
            push_gap(tscp, f1, f2);
          }
          Feat f1 = exon_feat(R->arc_src[R->cstr_arcs[c1 - 1]]);
          Feat f2 = exon_feat(R->arc_dst[R->cstr_arcs[c1 - 1]]);
          tscp.push_back(f1);
          push_gap(tscp, f1, f2);
          break;
        }
      }
      if (is_edge) {
        Feat f1 = exon_feat(arc_s);
        tscp.push_back(f1);
        if (i + 1 < p.size()) push_gap(tscp, f1, exon_feat(arc_t));
      }
    }
    transcripts.push_back(std::move(tscp));
  }

  // filter_short_transcripts (assembly.cpp:982-998)
  {
    std::vector<std::vector<Feat>> kept;
    for (auto& t : transcripts) {
      i64 match_len = 0;
      for (const auto& f : t)
        if (f.code == 0) match_len += f.len;
      if (match_len >= min_trans_len) kept.push_back(std::move(t));
    }
    transcripts.swap(kept);
    if (transcripts.empty()) return;  // oracle returns None
  }

  // ---- assemble_2_contigs (include/assembly.h:106-124): merge adjacent
  // same-code features, depth-filter on exon-seg avg doc, sort, dedupe
  std::vector<std::vector<Feat>> results;
  for (const auto& feats : transcripts) {
    std::vector<Feat> merged;
    size_t i = 0, nf = feats.size();
    while (i < nf) {
      Feat f = feats[i];
      while (i + 1 < nf && f.left + f.len == feats[i + 1].left &&
             f.code == feats[i + 1].code) {
        f.len += feats[i + 1].len;
        ++i;
      }
      merged.push_back(f);
      ++i;
    }
    // avg of the exon-seg docs looked up by feature LEFT (merged features
    // whose left is no exon-seg left read 0.0 — doc_by_left.get default)
    double cov_sum = 0.0;
    i64 cov_n = 0;
    for (const auto& f : merged) {
      if (f.code != 0) continue;
      double d = 0.0;
      // exon lefts are sorted unique
      auto it = std::lower_bound(R->ex_l.begin(), R->ex_l.end(), f.left);
      if (it != R->ex_l.end() && *it == f.left)
        d = R->ex_doc[it - R->ex_l.begin()];
      cov_sum += d;
      cov_n += 1;
    }
    if (cov_n == 0 || cov_sum / (double)cov_n < min_depth_4_contig)
      continue;
    results.push_back(std::move(merged));
  }
  // Contig::operator< — lexicographic (left, len); code NOT compared
  // (stable, like Python list.sort)
  std::stable_sort(results.begin(), results.end(),
                   [](const std::vector<Feat>& a, const std::vector<Feat>& b) {
                     size_t n = std::min(a.size(), b.size());
                     for (size_t k = 0; k < n; ++k) {
                       if (a[k].left != b[k].left)
                         return a[k].left < b[k].left;
                       if (a[k].len != b[k].len) return a[k].len < b[k].len;
                     }
                     return a.size() < b.size();
                   });
  auto feats_equal = [](const std::vector<Feat>& a,
                        const std::vector<Feat>& b) {
    if (a.size() != b.size()) return false;
    for (size_t k = 0; k < a.size(); ++k)
      if (a[k].code != b[k].code || a[k].left != b[k].left ||
          a[k].len != b[k].len)
        return false;
    return true;
  };
  const std::vector<Feat>* prev = nullptr;
  for (const auto& t : results) {
    if (prev && feats_equal(*prev, t)) continue;
    prev = &t;
    for (const auto& f : t) {
      R->t_code.push_back(f.code);
      R->t_left.push_back(f.left);
      R->t_len.push_back((i32)f.len);
    }
    R->tx_off.push_back((i64)R->t_code.size());
  }
}

StrawbAsm* strawb_asmprep(
    i64 l, i64 r, i64 read_len,
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len, const double* cov_mass, const double* weight_mass,
    double small_overhang /* kMinAnchor */, double min_depth_4_locus,
    double min_isoform_frac, double min_junc_support, i64 long_junc_length,
    double min_support_for_long_junc, i32 enforce_ref_models,
    double binomial_overhang_alpha, i64 max_cover_gap1, i64 max_cover_gap2,
    double intron_edge_weight, i64 min_dist_4_exon_edge) {
  strawb_perf::Scope _ps(strawb_perf::kAsmPrep);
  auto* R = new StrawbAsm();
  R->cstr_off.push_back(0);

  // ---- coverage + intron table, first-encounter order ------------------
  i64 L = r - l + 1;
  std::vector<float> exon_doc(L, 0.0f);
  std::vector<Intron> introns;  // encounter order
  // open-addressing index over (l, r) — first-encounter order preserved
  // by the vector; the linear probe replaces an O(#introns) scan per
  // spliced feature
  struct ISlot {
    i64 l, r, idx;
  };
  size_t icap = 64;
  std::vector<ISlot> itab(icap, {0, 0, -1});
  auto find_intron = [&](i64 il, i64 ir) -> i64 {
    if ((introns.size() + 1) * 4 >= icap * 3) {
      size_t nc = icap * 2;
      std::vector<ISlot> nt(nc, {0, 0, -1});
      for (const ISlot& s : itab)
        if (s.idx >= 0) {
          uint64_t hh = (uint64_t)s.l * 0x9E3779B97F4A7C15ull ^
                        (uint64_t)s.r;
          size_t i2 = (size_t)(hh ^ (hh >> 31)) & (nc - 1);
          while (nt[i2].idx >= 0) i2 = (i2 + 1) & (nc - 1);
          nt[i2] = s;
        }
      itab.swap(nt);
      icap = nc;
    }
    uint64_t hh = (uint64_t)il * 0x9E3779B97F4A7C15ull ^ (uint64_t)ir;
    size_t i2 = (size_t)(hh ^ (hh >> 31)) & (icap - 1);
    for (;;) {
      ISlot& s = itab[i2];
      if (s.idx < 0) {
        s.l = il;
        s.r = ir;
        s.idx = (i64)introns.size();
        introns.push_back({il, ir});
        return s.idx;
      }
      if (s.l == il && s.r == ir) return s.idx;
      i2 = (i2 + 1) & (icap - 1);
    }
  };
  for (i64 h = 0; h < nh; ++h) {
    double mass = cov_mass[h];
    if (mass < 0) continue;  // reference model sentinel
    for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
      i64 gl = h_left[f], gr = gl + h_len[f] - 1;
      if (h_code[f] == 0) {
        i64 lo = gl > l ? gl : l;
        i64 hi = gr < r ? gr : r;
        for (i64 p = lo; p <= hi; ++p) exon_doc[p - l] += (float)mass;
      } else if (h_code[f] == 1) {
        if (gl < l || gr > r) continue;
        i64 k = find_intron(gl, gr);
        introns[k].tot += mass;
        if ((double)h_len[f - 1] < small_overhang ||
            (double)h_len[f + 1] < small_overhang)
          introns[k].small += mass;
      }
    }
  }
  i64 num_nt = 0;
  for (i64 p = 0; p < L; ++p)
    if (exon_doc[p] > 0) num_nt++;
  double avg_dep =
      num_nt ? np_sum_f32(exon_doc.data(), L) / (double)num_nt : 0.0;
  if (avg_dep < min_depth_4_locus) return R;

  // sorted-key index over alive introns. (l, r) keys are unique (the
  // encounter table dedupes), so sorting ALL introns once and filtering
  // the survivors preserves exactly the order a fresh sort of the alive
  // subset would produce — no re-sort per filter pass.
  std::vector<i64> intron_order;
  auto sorted_alive = [&]() {
    if (intron_order.size() != introns.size()) {
      intron_order.resize(introns.size());
      for (i64 k = 0; k < (i64)introns.size(); ++k) intron_order[k] = k;
      std::sort(intron_order.begin(), intron_order.end(),
                [&](i64 a, i64 b) {
                  if (introns[a].l != introns[b].l)
                    return introns[a].l < introns[b].l;
                  return introns[a].r < introns[b].r;
                });
    }
    std::vector<i64> idx;
    idx.reserve(introns.size());
    for (i64 k : intron_order)
      if (introns[k].alive) idx.push_back(k);
    return idx;
  };

  // ---- filter one: overlapping-intron relative depth -------------------
  {
    auto keys = sorted_alive();
    std::vector<i64> bad;
    for (size_t a = 0; a < keys.size(); ++a)
      for (size_t b = a + 1; b < keys.size(); ++b) {
        const Intron& ei = introns[keys[a]];
        const Intron& ej = introns[keys[b]];
        double scale = -1;
        if (ei.l <= ej.r && ej.l <= ei.r) {
          scale = 1;
          bool contains = (ei.l <= ej.l && ei.r >= ej.r) ||
                          (ej.l <= ei.l && ej.r >= ei.r);
          if (!contains) scale = 10;
        }
        double di = ei.tot, dj = ej.tot;
        double min_junc;
        i64 bad_key;
        if (dj < di) {
          min_junc = dj;
          bad_key = keys[b];
        } else {
          min_junc = di;
          bad_key = keys[a];
        }
        if (min_junc / (di + dj) < min_isoform_frac * scale)
          bad.push_back(bad_key);
      }
    for (i64 k : bad) introns[k].alive = false;
  }

  // ---- filter two: junction support + small-anchor binomial test -------
  std::vector<float> intron_doc(L, 0.0f);
  {
    auto keys = sorted_alive();
    for (i64 k : keys) {
      Intron& ent = introns[k];
      double total_read = ent.tot, small_read = ent.small;
      if (total_read < min_junc_support && !enforce_ref_models) {
        ent.alive = false;
        continue;
      }
      if (ent.r - ent.l > long_junc_length &&
          total_read < min_support_for_long_junc && !enforce_ref_models) {
        ent.alive = false;
        continue;
      }
      for (i64 p = ent.l - l; p <= ent.r - l; ++p)
        intron_doc[p] += (float)total_read;
      if (small_read == total_read) {
        ent.alive = false;
        continue;
      }
      if (small_read < 1) continue;
      double success = 2.0 * small_overhang / (double)read_len;
      double normal_mean = total_read * success;
      double normal_sd = std::sqrt(total_read * success * (1 - success));
      double x = (small_read - 0.5 - normal_mean) / normal_sd;
      double prob_not_lt_observed = 1.0 - phi(x);
      if (prob_not_lt_observed < binomial_overhang_alpha) {
        ent.alive = false;
        continue;
      }
    }
  }

  // ---- filter three: intron depth vs exonic depth ----------------------
  {
    auto keys = sorted_alive();
    for (i64 k : keys) {
      Intron& ent = introns[k];
      i64 start = ent.l - l, end = ent.r - l;
      // reference sums [start, end) then divides by (end-start)+1
      double avg_intron_doc = np_sum_f32(intron_doc.data() + start,
                                         end - start);
      avg_intron_doc /= (double)((end - start) + 1);
      // duplicate buffer carries one trailing zero (alignments.cpp:2011)
      std::vector<float> dup(end - start + 1, 0.0f);
      for (i64 p = 0; p < end - start; ++p) dup[p] = exon_doc[start + p];
      double avg_intron_exonic =
          np_sum_f32(dup.data(), (i64)dup.size()) / (double)(end - start);
      if (avg_intron_exonic != 0) {
        if (avg_intron_doc / avg_intron_exonic < min_isoform_frac)
          ent.alive = false;
      }
    }
  }

  // ---- splicingGraph ---------------------------------------------------
  // paired bars: sorted unique alive keys; single bars: encounter order,
  // stable-sorted by coord (tie order == dict insertion order)
  std::vector<std::pair<i64, i64>> paired_bars;
  std::vector<std::pair<i64, bool>> single_bars;
  for (const auto& e : introns) {
    if (!e.alive) continue;
    paired_bars.push_back({e.l, e.r});
    single_bars.push_back({e.l, true});
    single_bars.push_back({e.r, false});
  }
  std::stable_sort(single_bars.begin(), single_bars.end(),
                   [](const std::pair<i64, bool>& a,
                      const std::pair<i64, bool>& b) {
                     return a.first < b.first;
                   });
  {  // unique adjacent (coord, side) pairs, preserving order
    std::vector<std::pair<i64, bool>> sb;
    for (const auto& b : single_bars)
      if (sb.empty() || sb.back() != b) sb.push_back(b);
    single_bars.swap(sb);
  }
  std::sort(paired_bars.begin(), paired_bars.end());
  paired_bars.erase(std::unique(paired_bars.begin(), paired_bars.end()),
                    paired_bars.end());

  // preliminary segments from nonzero coverage runs
  std::vector<std::pair<i64, i64>> eb;  // absolute [left,right]
  {
    bool in_run = false;
    i64 run_start = 0;
    for (i64 p = 0; p < L; ++p) {
      bool nz = exon_doc[p] > 0;
      if (nz && !in_run) {
        in_run = true;
        run_start = p;
      } else if (!nz && in_run) {
        in_run = false;
        eb.push_back({run_start + l, p - 1 + l});
      }
    }
    if (in_run) eb.push_back({run_start + l, L - 1 + l});
  }

  // gap filling (assembly.cpp:411-443)
  {
    size_t i = 0;
    while (i + 1 < eb.size()) {
      i64 head = eb[i].second, tail = eb[i + 1].first;
      bool no_overlap = true, no_support = true;
      for (const auto& e : introns) {
        if (!e.alive) continue;
        if (e.l <= tail && head <= e.r) no_overlap = false;
        if (e.l == head + 1 && tail - 1 == e.r) no_support = false;
      }
      if (no_overlap) {
        if (tail - head < max_cover_gap1) {
          eb[i + 1].first = eb[i].first;
          eb.erase(eb.begin() + i);
          continue;
        }
      } else {
        if (no_support && tail - head < max_cover_gap2) {
          eb[i + 1].first = eb[i].first;
          eb.erase(eb.begin() + i);
          continue;
        }
      }
      i++;
    }
  }

  // single-exon short circuit
  auto exon_avg = [&](i64 el, i64 er) {
    // compute_exon_doc: exclusive end, divide by full length
    double cov = np_sum_f32(exon_doc.data() + (el - l), er - el);
    return cov / (double)(er - el + 1);
  };
  if (paired_bars.empty()) {
    if (eb.size() > 1) return R;  // unassemblable: exons None
    R->ex_l.push_back(eb[0].first);
    R->ex_r.push_back(eb.back().second);
    R->ex_doc.push_back(exon_avg(eb[0].first, eb.back().second));
    R->ne = 1;
    // createNetwork returns immediately for 1 exon; add_sink_source then
    // creates source(0)/sink(1) + circulation arc sink->source
    R->arc_src.push_back(1);
    R->arc_dst.push_back(0);
    R->arc_cost.push_back(0);
    R->arc_lower.push_back(0);
    R->M = 2;
    R->status = 1;
    return R;
  }

  // split segments at intron bars (assembly.cpp:475-499)
  {
    size_t e = 0, s = 0;
    while (e < eb.size() && s < single_bars.size()) {
      i64 bar = single_bars[s].first;
      bool is_left = single_bars[s].second;
      if (bar < eb[e].first) {
        s++;
      } else if (eb[e].first <= bar && bar <= eb[e].second) {
        i64 temp = eb[e].second;
        if (is_left) {
          eb[e].second = bar - 1;
          eb.insert(eb.begin() + e + 1, {bar, temp});
        } else {
          eb[e].second = bar;
          eb.insert(eb.begin() + e + 1, {bar + 1, temp});
        }
        s++;
      } else {
        e++;
      }
    }
  }
  {  // drop degenerate (right <= left)
    std::vector<std::pair<i64, i64>> kept;
    for (auto& x : eb)
      if (x.second > x.first) kept.push_back(x);
    eb.swap(kept);
  }

  // remove_low_cov_exon (assembly.cpp:174-221) — incl. the cov-index skew
  {
    auto keys = sorted_alive();
    auto max_support = [&](i64 el, i64 er) {
      double sup = 0.0;
      for (i64 k : keys) {
        if (introns[k].l <= er && el <= introns[k].r)
          sup = std::max(introns[k].tot, sup);
      }
      return sup;
    };
    std::vector<double> covs;
    std::vector<double> covs_for_median;
    for (auto& x : eb) {
      double cov = np_sum_f32(exon_doc.data() + (x.first - l),
                              x.second - x.first) /
                   (double)(x.second - x.first);
      covs.push_back(cov);
      double sup = max_support(x.first, x.second);
      if (cov > sup) covs_for_median.push_back(cov);
    }
    double med = median_f64(covs_for_median);
    size_t i = 0, k = 0;
    while (i < eb.size()) {
      double sup = max_support(eb[i].first, eb[i].second);
      if (covs[k] < sup * min_isoform_frac ||
          covs[k] < med * min_isoform_frac) {
        eb.erase(eb.begin() + i);
      } else {
        i++;
      }
      k++;
    }
  }

  // filter_exon_segs (assembly.cpp:224-315)
  {
    std::vector<std::pair<i64, i64>> lc, rc;  // (coord, pb index)
    for (size_t i = 0; i < paired_bars.size(); ++i) {
      lc.push_back({paired_bars[i].first, (i64)i});
      rc.push_back({paired_bars[i].second, (i64)i});
    }
    std::sort(lc.begin(), lc.end());
    std::sort(rc.begin(), rc.end());
    std::vector<i64> firsts, seconds, lcf, rcf;
    for (auto& x : eb) {
      firsts.push_back(x.first);
      seconds.push_back(x.second);
    }
    for (auto& x : lc) lcf.push_back(x.first);
    for (auto& x : rc) rcf.push_back(x.first);
    auto lb = [](const std::vector<i64>& v, i64 x) {
      return (size_t)(std::lower_bound(v.begin(), v.end(), x) - v.begin());
    };
    std::vector<size_t> dropoff;
    for (size_t ex = 0; ex < eb.size(); ++ex) {
      bool no_right = false;
      size_t li = lb(lcf, eb[ex].second + 1);
      if (li < lc.size() && lc[li].first == eb[ex].second + 1) {
        i64 right = paired_bars[lc[li].second].second;
        size_t j = lb(firsts, right + 1);
        if (!(j < firsts.size() && firsts[j] == right + 1)) no_right = true;
      } else {
        no_right = true;
      }
      bool no_left = false;
      size_t ri = lb(rcf, eb[ex].first - 1);
      if (ri < rc.size() && rc[ri].first == eb[ex].first - 1) {
        i64 left = paired_bars[rc[ri].second].first;
        size_t j = lb(seconds, left - 1);
        if (!(j < seconds.size() && seconds[j] == left - 1)) no_left = true;
      } else {
        no_left = true;
      }
      if (no_left && no_right && eb.size() > 1) {
        if (ex == 0) {
          if (eb[ex].second + 1 != eb[ex + 1].first) dropoff.push_back(ex);
        } else if (ex == eb.size() - 1) {
          if (eb[ex - 1].second + 1 != eb[ex].first) dropoff.push_back(ex);
        } else {
          if (eb[ex].second + 1 != eb[ex + 1].first ||
              eb[ex].first - 1 != eb[ex - 1].second)
            dropoff.push_back(ex);
        }
      }
    }
    for (size_t d = dropoff.size(); d-- > 0;)
      eb.erase(eb.begin() + dropoff[d]);
  }

  // final exon list (sorted) + avg doc
  {
    std::vector<std::pair<i64, i64>> ex;
    for (auto& x : eb)
      if (x.second - x.first + 1 > 0) ex.push_back(x);
    std::sort(ex.begin(), ex.end());
    for (auto& x : ex) {
      R->ex_l.push_back(x.first);
      R->ex_r.push_back(x.second);
      R->ex_doc.push_back(exon_avg(x.first, x.second));
    }
  }
  i64 ne = (i64)R->ex_l.size();
  R->ne = ne;

  // filter_intron_by_exons (assembly.cpp:317-340): exact boundary match
  {
    auto keys = sorted_alive();
    auto lb64 = [](const std::vector<i64>& v, i64 x) {
      return (size_t)(std::lower_bound(v.begin(), v.end(), x) - v.begin());
    };
    for (i64 k : keys) {
      i64 il = introns[k].l, ir = introns[k].r;
      size_t e1 = lb64(R->ex_r, il - 1);
      size_t e2 = lb64(R->ex_l, ir + 1);
      if (e1 == (size_t)ne || e2 == (size_t)ne) {
        introns[k].alive = false;
        continue;
      }
      if (R->ex_r[e1] != il - 1 || R->ex_l[e2] != ir + 1)
        introns[k].alive = false;
    }
  }

  // ---- createNetwork (assembly.cpp:549-765) ----------------------------
  if (ne == 1) {
    // returns True before adding any nodes; sink_source adds 2 + circ arc
    R->arc_src.push_back(1);
    R->arc_dst.push_back(0);
    R->arc_cost.push_back(0);
    R->arc_lower.push_back(0);
    R->M = 2;
    R->status = 1;
    return R;
  }
  auto alive_sorted = sorted_alive();
  Graph g;
  for (i64 i = 0; i < ne; ++i) g.add_node();  // node i == exon i
  if (ne == 0 || alive_sorted.empty()) return R;  // status 0

  std::vector<i64> arcs;  // intron + adjacency arcs, creation order
  {
    auto lb64 = [](const std::vector<i64>& v, i64 x) {
      return (size_t)(std::lower_bound(v.begin(), v.end(), x) - v.begin());
    };
    for (i64 k : alive_sorted) {
      i64 il = introns[k].l, ir = introns[k].r;
      size_t e1 = lb64(R->ex_r, il - 1);
      size_t e2 = lb64(R->ex_l, ir + 1);
      if (e1 == (size_t)ne || e2 == (size_t)ne) continue;
      arcs.push_back(g.add_arc((i64)e1, (i64)e2));
    }
    for (i64 i = 0; i + 1 < ne; ++i)
      if (R->ex_l[i + 1] == R->ex_r[i] + 1)
        arcs.push_back(g.add_arc(i, i + 1));
  }

  // addWeight (assembly.cpp:767-811): ArcIt order = nodes newest-first,
  // out-arcs newest-first; costs after all supports are known
  std::vector<double> supports(g.src.size(), 0.0);  // dense per arc
  double max_weight = 0.0;
  std::vector<i64> adj_arcs, adj_s, adj_e;
  for (i64 u = (i64)g.out.size(); u-- > 0;) {
    const auto& o = g.out[u];
    for (size_t kk = o.size(); kk-- > 0;) {
      i64 arc = o[kk];
      i64 arc_s = R->ex_r[g.src[arc]];
      i64 arc_e = R->ex_l[g.dst[arc]];
      double support = 0.0;
      if (arc_e - arc_s == 1) {
        adj_arcs.push_back(arc);
        adj_s.push_back(arc_s);
        adj_e.push_back(arc_e);
        supports[arc] = 0.0;
        continue;
      }
      i64 il = arc_s + 1, ir = arc_e - 1;
      for (i64 k : alive_sorted)
        if (introns[k].l == il && introns[k].r == ir) {
          support = introns[k].tot * intron_edge_weight;
          break;
        }
      max_weight = std::max(max_weight, support);
      supports[arc] = support;
    }
  }
  // adjacency supports: hit-major with a binary-searched boundary range
  // per MATCH feature — each arc still accumulates masses in HIT order
  // (bit-identical to the per-arc ordered scan it replaces; adjacency
  // boundaries are sorted because exons are, and one hit's disjoint
  // features can't both contain the same boundary)
  if (!adj_arcs.empty()) {
    std::vector<double> asup(adj_arcs.size(), 0.0);
    const i64 d = min_dist_4_exon_edge;
    for (i64 h = 0; h < nh; ++h) {
      for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
        if (h_code[f] != 0) continue;
        i64 fl = h_left[f], fr = fl + h_len[f] - 1;
        // arcs with adj_s >= fl + d and adj_s + 1 <= fr - d; adj_s is
        // strictly DESCENDING (ArcIt walks nodes newest-first)
        i64 lo_b = fl + d, hi_b = fr - d - 1;
        if (lo_b > hi_b) continue;
        size_t i1 = (size_t)(std::lower_bound(adj_s.begin(), adj_s.end(),
                                              hi_b, std::greater<i64>()) -
                             adj_s.begin());
        size_t i2 = (size_t)(std::upper_bound(adj_s.begin(), adj_s.end(),
                                              lo_b, std::greater<i64>()) -
                             adj_s.begin());
        for (size_t a = i1; a < i2; ++a) asup[a] += weight_mass[h];
      }
    }
    for (size_t a = 0; a < adj_arcs.size(); ++a) {
      supports[adj_arcs[a]] = asup[a];
      max_weight = std::max(max_weight, asup[a]);
    }
  }
  // dense per-arc cost/lower (grow as shortcut arcs are appended)
  std::vector<i64> cost_v(g.src.size(), 0), lower_v(g.src.size(), 0);
  for (size_t a = 0; a < supports.size(); ++a)
    cost_v[a] = (i64)(max_weight - (double)(i64)supports[a]);

  // findConstraints (assembly.cpp:856-879): unique sorted >2-exon rows.
  // The original scans every (seg, feat) pair; exon segs are sorted and
  // disjoint, so each MATCH feature overlaps a contiguous index range —
  // merge the (non-decreasing) per-feature ranges into the same sorted
  // unique row the seg-major scan produced.
  std::vector<std::vector<i64>> constraints;
  {
    std::vector<std::vector<i64>> rows;
    std::vector<i64> row;
    for (i64 h = 0; h < nh; ++h) {
      row.clear();
      for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
        if (h_code[f] != 0) continue;
        i64 fl = h_left[f], fr = fl + h_len[f] - 1;
        // segs with ex_r >= fl and ex_l <= fr
        size_t s1 = (size_t)(std::lower_bound(R->ex_r.begin(),
                                              R->ex_r.end(), fl) -
                             R->ex_r.begin());
        size_t s2 = (size_t)(std::upper_bound(R->ex_l.begin(),
                                              R->ex_l.end(), fr) -
                             R->ex_l.begin());
        size_t start = s1;
        if (!row.empty() && (i64)s1 <= row.back())
          start = (size_t)(row.back() + 1);  // ranges are non-decreasing
        for (size_t s = start; s < s2; ++s) row.push_back((i64)s);
      }
      if (row.size() > 2) rows.push_back(std::move(row));
    }
    std::sort(rows.begin(), rows.end());
    rows.erase(std::unique(rows.begin(), rows.end()), rows.end());
    constraints.swap(rows);
  }

  // subpath constraints -> path_cstrs (assembly.cpp:616-699)
  std::vector<std::vector<i64>> path_cstrs;
  for (const auto& c : constraints) {
    std::vector<i64> path_cstr;
    i64 s = c.front(), t = c.back();
    bool is_valid = false;
    for (size_t idx = 1; idx + 1 < c.size(); ++idx) {
      i64 n = c[idx];
      if (g.in[n].size() > 1 && g.out[n].size() > 1) is_valid = true;
    }
    if (g.find_arc(s, t) == -1 && is_valid) {
      for (size_t i = 0; i + 1 < c.size(); ++i) {
        i64 pre = c[i], sec = c[i + 1];
        i64 arc_found = g.find_arc(pre, sec);
        if (arc_found == -1) {
          std::vector<i64> path;
          if (g.bfs_path(pre, sec, path)) {
            for (size_t jj = 0; jj + 1 < path.size(); ++jj) {
              i64 a = g.find_arc(path[jj], path[jj + 1]);
              if (a != -1) path_cstr.push_back(a);
            }
          }
        } else {
          path_cstr.push_back(arc_found);
        }
      }
      if (!path_cstr.empty()) path_cstrs.push_back(path_cstr);
    }
  }

  if (path_cstrs.empty()) {
    for (i64 a : arcs) lower_v[a] = 1;
  } else {
    std::vector<char> one_d(g.src.size(), 0);
    for (const auto& p : path_cstrs)
      for (i64 a : p) one_d[a] = 1;
    for (i64 a : arcs)
      if (!one_d[a]) path_cstrs.push_back({a});
    for (const auto& p : path_cstrs) {
      if (p.size() > 1) {
        i64 cost = 0;
        for (i64 a : p) cost += cost_v[a];
        i64 s = g.src[p[0]], t = g.dst[p.back()];
        if (g.find_arc(s, t) == -1) {
          i64 a = g.add_arc(s, t);
          (void)a;  // appended consecutively: a == cost_v.size()
          cost_v.push_back(cost);
          lower_v.push_back(1);
        }
      } else {
        lower_v[p[0]] = 1;
      }
    }
  }

  // add_sink_source (assembly.cpp:91-112): NodeIt newest-first
  i64 source = g.add_node();
  i64 sink = g.add_node();
  for (i64 n = (i64)g.out.size(); n-- > 0;) {
    if (n == source || n == sink) continue;
    if (g.in[n].empty()) g.add_arc(source, n);
    if (g.out[n].empty()) g.add_arc(n, sink);
  }
  g.add_arc(sink, source);

  R->M = (i64)g.out.size();
  R->arc_src = g.src;
  R->arc_dst = g.dst;
  R->arc_cost.assign(g.src.size(), 0);
  R->arc_lower.assign(g.src.size(), 0);
  std::copy(cost_v.begin(), cost_v.end(), R->arc_cost.begin());
  std::copy(lower_v.begin(), lower_v.end(), R->arc_lower.begin());
  for (const auto& p : path_cstrs) {
    R->cstr_arcs.insert(R->cstr_arcs.end(), p.begin(), p.end());
    R->cstr_off.push_back((i64)R->cstr_arcs.size());
  }
  R->status = 1;
  return R;
}

// ---- async submission: a small worker pool overlaps per-locus prep with
// the Python-side orchestration loop (caller keeps input arrays alive
// until strawb_asm_wait returns the result handle) ---------------------
struct AsmJob;
namespace {
struct AsmPool {
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;  // broadcast on every job completion
  std::deque<AsmJob*> q;
  std::vector<std::thread> workers;
  bool started = false;
};
}  // namespace

struct AsmJob {
  // captured arguments
  i64 l, r, read_len, nh;
  const i64* h_off;
  const i8* h_code;
  const i64* h_left;
  const i32* h_len;
  const double* cov_mass;
  const double* weight_mass;
  double small_overhang, min_depth_4_locus, min_isoform_frac,
      min_junc_support;
  i64 long_junc_length;
  double min_support_for_long_junc;
  i32 enforce_ref_models;
  double binomial_overhang_alpha;
  i64 max_cover_gap1, max_cover_gap2;
  double intron_edge_weight;
  i64 min_dist_4_exon_edge;
  // full-solve chaining (solve != 0: run NetworkSimplex + decompose +
  // reconstruct on the worker right after the prep)
  i32 solve = 0;
  i64 min_trans_len = 0;
  double min_depth_4_contig = 0.0;
  // owned input storage (fused clusterizer submissions; empty when the
  // caller keeps the arrays alive itself)
  std::vector<i64> own_off, own_left;
  std::vector<i8> own_code;
  std::vector<i32> own_len;
  std::vector<double> own_cov, own_wt;
  // result
  StrawbAsm* result = nullptr;
  std::atomic<int> done{0};
};

static AsmPool& pool() {
  // intentionally leaked: destroying the mutex/cv at exit while detached
  // workers wait on them hangs process teardown
  static AsmPool* p = new AsmPool();
  return *p;
}

// forked children (-p workers) inherit started=true but no worker
// threads; reinitialize the pool state in the child
static void pool_child_reset() {
  AsmPool& p = pool();
  new (&p.mu) std::mutex();
  new (&p.cv) std::condition_variable();
  new (&p.done_cv) std::condition_variable();
  p.q.clear();
  p.workers.clear();
  p.started = false;
}

static void pool_worker() {
  AsmPool& p = pool();
  for (;;) {
    AsmJob* j;
    {
      std::unique_lock<std::mutex> lk(p.mu);
      p.cv.wait(lk, [&] { return !p.q.empty(); });
      j = p.q.front();
      p.q.pop_front();
    }
    j->result = strawb_asmprep(
        j->l, j->r, j->read_len, j->nh, j->h_off, j->h_code, j->h_left,
        j->h_len, j->cov_mass, j->weight_mass, j->small_overhang,
        j->min_depth_4_locus, j->min_isoform_frac, j->min_junc_support,
        j->long_junc_length, j->min_support_for_long_junc,
        j->enforce_ref_models, j->binomial_overhang_alpha,
        j->max_cover_gap1, j->max_cover_gap2, j->intron_edge_weight,
        j->min_dist_4_exon_edge);
    if (j->solve && j->result->status)
      asm_solve_finish(j->result, j->min_trans_len, j->min_depth_4_contig);
    j->done.store(1, std::memory_order_release);
    { std::lock_guard<std::mutex> lk(p.mu); }
    p.done_cv.notify_all();
  }
}

static void pool_enqueue(AsmJob* j) {
  AsmPool& p = pool();
  {
    std::lock_guard<std::mutex> lk(p.mu);
    if (!p.started) {
      p.started = true;
      pthread_atfork(nullptr, nullptr, pool_child_reset);
      unsigned hw = std::thread::hardware_concurrency();
      unsigned nth = hw > 1 ? hw : 1;
      if (nth > 4) nth = 4;
      for (unsigned t = 0; t < nth; ++t) {
        p.workers.emplace_back(pool_worker);
        p.workers.back().detach();
      }
    }
    p.q.push_back(j);
  }
  p.cv.notify_one();
}

AsmJob* strawb_asmprep_submit(
    i64 l, i64 r, i64 read_len,
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len, const double* cov_mass, const double* weight_mass,
    double small_overhang, double min_depth_4_locus,
    double min_isoform_frac, double min_junc_support, i64 long_junc_length,
    double min_support_for_long_junc, i32 enforce_ref_models,
    double binomial_overhang_alpha, i64 max_cover_gap1, i64 max_cover_gap2,
    double intron_edge_weight, i64 min_dist_4_exon_edge,
    i32 solve, i64 min_trans_len, double min_depth_4_contig) {
  auto* j = new AsmJob{l, r, read_len, nh, h_off, h_code, h_left, h_len,
                       cov_mass, weight_mass, small_overhang,
                       min_depth_4_locus, min_isoform_frac,
                       min_junc_support, long_junc_length,
                       min_support_for_long_junc, enforce_ref_models,
                       binomial_overhang_alpha, max_cover_gap1,
                       max_cover_gap2, intron_edge_weight,
                       min_dist_4_exon_edge};
  j->solve = solve;
  j->min_trans_len = min_trans_len;
  j->min_depth_4_contig = min_depth_4_contig;
  pool_enqueue(j);
  return j;
}

// blocks until the job finishes; returns the result handle (caller frees
// it with strawb_asm_free) and deletes the job
StrawbAsm* strawb_asm_wait(AsmJob* j) {
  if (!j->done.load(std::memory_order_acquire)) {
    // sleep on the pool's completion condvar (spinning here would burn a
    // core the workers need on small hosts)
    AsmPool& p = pool();
    std::unique_lock<std::mutex> lk(p.mu);
    p.done_cv.wait(lk, [&] { return j->done.load(std::memory_order_acquire); });
  }
  StrawbAsm* r = j->result;
  delete j;
  return r;
}

// Wait for a whole chunk of jobs and pack every result into one handle of
// contiguous arrays (one ctypes decode per CHUNK on the Python side instead
// of ~12 per job). Job slots with value 0 are skipped (status stays 0).
struct StrawbAsmBatch {
  std::vector<i32> status;           // n
  std::vector<i64> M;                // n
  std::vector<i64> ne_off;           // n+1 — exon rows
  std::vector<i64> arc_off;          // n+1 — arc rows
  std::vector<i64> nc_off;           // n+1 — constraint rows
  std::vector<i64> ca_off;           // n+1 — constraint-arc rows
  std::vector<i64> ex_l, ex_r;
  std::vector<double> ex_doc;
  std::vector<i64> arc_src, arc_dst, arc_cost, arc_lower;
  std::vector<i64> cstr_len;         // per constraint row: arc count
  std::vector<i64> cstr_arcs;        // concatenated constraint arc ids
  // native-solve results (per unit, when the submit requested solve)
  std::vector<i32> solved;           // n
  std::vector<i64> tx_off;           // n+1 — cumulative transcript counts
  std::vector<i64> txf_off;          // ntx+1 — cumulative feature offsets
  std::vector<i8> t_code;
  std::vector<i64> t_left;
  std::vector<i32> t_len;
};

StrawbAsmBatch* strawb_asm_wait_pack(const uint64_t* jobs, i64 n) {
  auto* b = new StrawbAsmBatch();
  b->status.assign(n, 0);
  b->M.assign(n, 0);
  b->ne_off.assign(n + 1, 0);
  b->arc_off.assign(n + 1, 0);
  b->nc_off.assign(n + 1, 0);
  b->ca_off.assign(n + 1, 0);
  b->solved.assign(n, 0);
  b->tx_off.assign(n + 1, 0);
  b->txf_off.push_back(0);
  std::vector<StrawbAsm*> res(n, nullptr);
  for (i64 k = 0; k < n; ++k) {
    AsmJob* j = (AsmJob*)(uintptr_t)jobs[k];
    if (j) res[k] = strawb_asm_wait(j);
  }
  for (i64 k = 0; k < n; ++k) {
    StrawbAsm* r = res[k];
    i64 ne = 0, na = 0, nc = 0, ca = 0, ntx = 0;
    if (r && r->status && r->solved) {
      // natively solved: ship only the final transcript chains (the
      // network arrays are spent — Python never rebuilds the graph)
      b->status[k] = 1;
      b->solved[k] = 1;
      ntx = (i64)r->tx_off.size() - 1;
      for (i64 t = 0; t < ntx; ++t)
        b->txf_off.push_back(b->txf_off.back() +
                             (r->tx_off[t + 1] - r->tx_off[t]));
      b->t_code.insert(b->t_code.end(), r->t_code.begin(), r->t_code.end());
      b->t_left.insert(b->t_left.end(), r->t_left.begin(), r->t_left.end());
      b->t_len.insert(b->t_len.end(), r->t_len.begin(), r->t_len.end());
    } else if (r && r->status) {
      b->status[k] = 1;
      b->M[k] = r->M;
      ne = r->ne;
      na = (i64)r->arc_src.size();
      nc = (i64)r->cstr_off.size() - 1;
      ca = nc > 0 ? r->cstr_off.back() : 0;
      b->ex_l.insert(b->ex_l.end(), r->ex_l.begin(), r->ex_l.end());
      b->ex_r.insert(b->ex_r.end(), r->ex_r.begin(), r->ex_r.end());
      b->ex_doc.insert(b->ex_doc.end(), r->ex_doc.begin(), r->ex_doc.end());
      b->arc_src.insert(b->arc_src.end(), r->arc_src.begin(),
                        r->arc_src.end());
      b->arc_dst.insert(b->arc_dst.end(), r->arc_dst.begin(),
                        r->arc_dst.end());
      b->arc_cost.insert(b->arc_cost.end(), r->arc_cost.begin(),
                         r->arc_cost.end());
      b->arc_lower.insert(b->arc_lower.end(), r->arc_lower.begin(),
                          r->arc_lower.end());
      for (i64 c = 0; c < nc; ++c)
        b->cstr_len.push_back(r->cstr_off[c + 1] - r->cstr_off[c]);
      b->cstr_arcs.insert(b->cstr_arcs.end(), r->cstr_arcs.begin(),
                          r->cstr_arcs.begin() + ca);
    }
    b->ne_off[k + 1] = b->ne_off[k] + ne;
    b->arc_off[k + 1] = b->arc_off[k] + na;
    b->nc_off[k + 1] = b->nc_off[k] + nc;
    b->ca_off[k + 1] = b->ca_off[k] + ca;
    b->tx_off[k + 1] = b->tx_off[k] + ntx;
    delete r;
  }
  return b;
}

const i32* strawb_asmb_status(StrawbAsmBatch* b) { return b->status.data(); }
const i64* strawb_asmb_mm(StrawbAsmBatch* b) { return b->M.data(); }
const i64* strawb_asmb_neoff(StrawbAsmBatch* b) { return b->ne_off.data(); }
const i64* strawb_asmb_arcoff(StrawbAsmBatch* b) { return b->arc_off.data(); }
const i64* strawb_asmb_ncoff(StrawbAsmBatch* b) { return b->nc_off.data(); }
const i64* strawb_asmb_caoff(StrawbAsmBatch* b) { return b->ca_off.data(); }
const i64* strawb_asmb_exl(StrawbAsmBatch* b) { return b->ex_l.data(); }
const i64* strawb_asmb_exr(StrawbAsmBatch* b) { return b->ex_r.data(); }
const double* strawb_asmb_exdoc(StrawbAsmBatch* b) { return b->ex_doc.data(); }
const i64* strawb_asmb_src(StrawbAsmBatch* b) { return b->arc_src.data(); }
const i64* strawb_asmb_dst(StrawbAsmBatch* b) { return b->arc_dst.data(); }
const i64* strawb_asmb_cost(StrawbAsmBatch* b) { return b->arc_cost.data(); }
const i64* strawb_asmb_lower(StrawbAsmBatch* b) { return b->arc_lower.data(); }
const i64* strawb_asmb_cstrlen(StrawbAsmBatch* b) { return b->cstr_len.data(); }
const i64* strawb_asmb_cstrarcs(StrawbAsmBatch* b) {
  return b->cstr_arcs.data();
}
const i32* strawb_asmb_solved(StrawbAsmBatch* b) { return b->solved.data(); }
const i64* strawb_asmb_txoff(StrawbAsmBatch* b) { return b->tx_off.data(); }
const i64* strawb_asmb_txfoff(StrawbAsmBatch* b) { return b->txf_off.data(); }
const i8* strawb_asmb_tcode(StrawbAsmBatch* b) { return b->t_code.data(); }
const i64* strawb_asmb_tleft(StrawbAsmBatch* b) { return b->t_left.data(); }
const i32* strawb_asmb_tlen(StrawbAsmBatch* b) { return b->t_len.data(); }
void strawb_asmb_free(StrawbAsmBatch* b) { delete b; }

// cumulative native thread-CPU seconds: [asmprep, quantprep, fld,
// cluster_scan, cluster_collapse, cluster_emit]; reset=1 zeroes after
// reading (Python caller: utils/profiling.py native_counters)
void strawb_perf_read(double* out, i32 reset) {
  for (int k = 0; k < strawb_perf::kNumCounters; ++k) {
    out[k] = 1e-9 * (double)strawb_perf::slot(k).load();
    if (reset) strawb_perf::slot(k).store(0);
  }
}

i32 strawb_asm_status(StrawbAsm* r) { return r->status; }
i32 strawb_asm_solved(StrawbAsm* r) { return r->solved; }
i64 strawb_asm_ntx(StrawbAsm* r) { return (i64)r->tx_off.size() - 1; }
const i64* strawb_asm_txoff(StrawbAsm* r) { return r->tx_off.data(); }
const i8* strawb_asm_tcode(StrawbAsm* r) { return r->t_code.data(); }
const i64* strawb_asm_tleft(StrawbAsm* r) { return r->t_left.data(); }
const i32* strawb_asm_tlen(StrawbAsm* r) { return r->t_len.data(); }
i64 strawb_asm_ne(StrawbAsm* r) { return r->ne; }
i64 strawb_asm_narcs(StrawbAsm* r) { return (i64)r->arc_src.size(); }
i64 strawb_asm_ncstr(StrawbAsm* r) { return (i64)r->cstr_off.size() - 1; }
i64 strawb_asm_m(StrawbAsm* r) { return r->M; }
const i64* strawb_asm_exl(StrawbAsm* r) { return r->ex_l.data(); }
const i64* strawb_asm_exr(StrawbAsm* r) { return r->ex_r.data(); }
const double* strawb_asm_exdoc(StrawbAsm* r) { return r->ex_doc.data(); }
const i64* strawb_asm_src(StrawbAsm* r) { return r->arc_src.data(); }
const i64* strawb_asm_dst(StrawbAsm* r) { return r->arc_dst.data(); }
const i64* strawb_asm_cost(StrawbAsm* r) { return r->arc_cost.data(); }
const i64* strawb_asm_lower(StrawbAsm* r) { return r->arc_lower.data(); }
const i64* strawb_asm_cstroff(StrawbAsm* r) { return r->cstr_off.data(); }
const i64* strawb_asm_cstrarcs(StrawbAsm* r) { return r->cstr_arcs.data(); }
void strawb_asm_free(StrawbAsm* r) { delete r; }

}  // extern "C"

// ---- fused-clusterizer submission (C++ linkage; see asmprep.h) -----------
#include "asmprep.h"

AsmJob* strawb_asm_submit_owned(
    int64_t l, int64_t r, int64_t read_len,
    std::vector<int64_t>&& h_off, std::vector<int8_t>&& h_code,
    std::vector<int64_t>&& h_left, std::vector<int32_t>&& h_len,
    std::vector<double>&& cov_mass, std::vector<double>&& weight_mass,
    const AsmPrepCfg& cfg) {
  auto* j = new AsmJob{};
  j->l = l;
  j->r = r;
  j->read_len = read_len;
  j->own_off = std::move(h_off);
  j->own_code = std::move(h_code);
  j->own_left = std::move(h_left);
  j->own_len = std::move(h_len);
  j->own_cov = std::move(cov_mass);
  j->own_wt = std::move(weight_mass);
  j->nh = (i64)j->own_off.size() - 1;
  j->h_off = j->own_off.data();
  j->h_code = j->own_code.data();
  j->h_left = j->own_left.data();
  j->h_len = j->own_len.data();
  j->cov_mass = j->own_cov.data();
  j->weight_mass = j->own_wt.data();
  j->small_overhang = cfg.small_overhang;
  j->min_depth_4_locus = cfg.min_depth_4_locus;
  j->min_isoform_frac = cfg.min_isoform_frac;
  j->min_junc_support = cfg.min_junc_support;
  j->long_junc_length = cfg.long_junc_length;
  j->min_support_for_long_junc = cfg.min_support_for_long_junc;
  j->enforce_ref_models = cfg.enforce_ref_models;
  j->binomial_overhang_alpha = cfg.binomial_overhang_alpha;
  j->max_cover_gap1 = cfg.max_cover_gap1;
  j->max_cover_gap2 = cfg.max_cover_gap2;
  j->intron_edge_weight = cfg.intron_edge_weight;
  j->min_dist_4_exon_edge = cfg.min_dist_4_exon_edge;
  j->solve = cfg.solve;
  j->min_trans_len = cfg.min_trans_len;
  j->min_depth_4_contig = cfg.min_depth_4_contig;
  pool_enqueue(j);
  return j;
}
