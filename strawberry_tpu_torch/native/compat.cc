// Read-vs-isoform compatibility, fragment lengths, and exon-seg overlap —
// the quantification inner loops (ref: Contig::is_compatible
// src/contig.cpp:547-599, exonic_overlaps_len :412-426,
// LocusContext::overlap_exons src/estimate.cpp:115-131).
// Semantics mirror strawberry_tpu/core/features.py (the oracle).

#include "perfcnt.h"
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

using std::size_t;

namespace {
typedef int64_t i64;
typedef int32_t i32;
typedef int8_t i8;

struct Feats {
  const i64* off;
  const i8* code;
  const i64* left;
  const i32* len;
};

static inline i64 fright(const Feats& F, i64 f) {
  return F.left[f] + F.len[f] - 1;
}

// is_compatible(read h, isoform t)
static bool compat(const Feats& H, i64 h, const Feats& T, i64 t,
                   const std::vector<i64>& iso_exons /* feat indices */) {
  i64 hb = H.off[h], he = H.off[h + 1];
  if (hb == he) return false;
  i64 first = hb;  // first read feature
  // lower_bound over iso exons by right() < first.left
  size_t lo = 0, hi = iso_exons.size();
  i64 fl = H.left[first];
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (fright(T, iso_exons[mid]) < fl) lo = mid + 1;
    else hi = mid;
  }
  if (lo == iso_exons.size()) return false;
  size_t it = lo;
  // contains
  {
    i64 e = iso_exons[it];
    if (!(T.left[e] <= H.left[first] && fright(T, e) >= fright(H, first)))
      return false;
  }
  i64 tb = T.off[t], te = T.off[t + 1];
  for (i64 f = hb + 1; f < he; ++f) {
    i8 c = H.code[f];
    if (c == 2) continue;  // GAP
    if (c == 1) {          // INTRON: positional match against iso feats
      i64 next_intron_offset = 2 * (i64)it + 1;
      if (tb + next_intron_offset >= te) return false;
      i64 g = tb + next_intron_offset;
      if (!(T.code[g] == 1 && T.left[g] == H.left[f] &&
            T.len[g] == H.len[f]))
        return false;
    } else {               // MATCH: advance to containing exon
      while (it < iso_exons.size()) {
        i64 e = iso_exons[it];
        if (T.left[e] <= H.left[f] && fright(T, e) >= fright(H, f)) break;
        ++it;
      }
      if (it == iso_exons.size()) return false;
    }
  }
  return true;
}

static i32 exonic_overlap_len(const Feats& T, i64 t, i64 l, i64 r) {
  i64 total = 0;
  for (i64 f = T.off[t]; f < T.off[t + 1]; ++f) {
    if (T.code[f] != 0) continue;
    i64 fl = T.left[f], fr = fright(T, f);
    if (fl <= r && l <= fr) {
      i64 a = fl > l ? fl : l;
      i64 b = fr < r ? fr : r;
      total += b - a + 1;
    }
  }
  return (i32)total;
}

}  // namespace

extern "C" {

// compat:   (nh*ni) u8, row-major by hit
// fraglen:  (nh*ni) i32 (exonic overlap where compatible, else 0)
// seg_hit:  (nh*ns) u8 (read MATCH feature overlaps disjoint seg)
void strawb_compat(
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len,
    i64 ni, const i64* t_off, const i8* t_code, const i64* t_left,
    const i32* t_len,
    i64 ns, const i64* s_left, const i64* s_right,
    uint8_t* out_compat, i32* out_fraglen, uint8_t* out_seg_hit,
    uint64_t* out_fragkey /* may be null: FNV over (left,len) pairs —
                             the Contig::operator< dedupe key */) {
  Feats H{h_off, h_code, h_left, h_len};
  Feats T{t_off, t_code, t_left, t_len};
  // pre-extract iso exon feature indices
  std::vector<std::vector<i64>> exons(ni);
  for (i64 t = 0; t < ni; ++t)
    for (i64 f = t_off[t]; f < t_off[t + 1]; ++f)
      if (t_code[f] == 0) exons[t].push_back(f);

  for (i64 h = 0; h < nh; ++h) {
    i64 hl = h_left[h_off[h]];
    i64 hr = fright(H, h_off[h + 1] - 1);
    for (i64 t = 0; t < ni; ++t) {
      bool c = compat(H, h, T, t, exons[t]);
      out_compat[h * ni + t] = c ? 1 : 0;
      out_fraglen[h * ni + t] = c ? exonic_overlap_len(T, t, hl, hr) : 0;
    }
    if (out_fragkey) {
      uint64_t k = 0xcbf29ce484222325ull;
      for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
        k = (k ^ (uint64_t)h_left[f]) * 1099511628211ull;
        k = (k ^ (uint64_t)(uint32_t)h_len[f]) * 1099511628211ull;
      }
      out_fragkey[h] = k;
    }
    if (ns > 0) {
      for (i64 s = 0; s < ns; ++s) {
        uint8_t hit = 0;
        for (i64 f = h_off[h]; f < h_off[h + 1] && !hit; ++f) {
          if (h_code[f] != 0) continue;
          if (h_left[f] <= s_right[s] && s_left[s] <= fright(H, f)) hit = 1;
        }
        out_seg_hit[h * ns + s] = hit;
      }
    }
  }
}

}  // extern "C"

#include <set>

extern "C" {

// findConstraints (assembly.cpp:856-879) done entirely natively: per-hit
// overlapped exon-seg index sets of size > 2, deduped and sorted
// lexicographically (the oracle's sorted(set(tuples))). Returns a handle.
struct StrawbCstr {
  std::vector<i64> off;   // n_cstr+1
  std::vector<i32> idx;   // flat exon indices
};

StrawbCstr* strawb_constraints(
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len,
    i64 ns, const i64* s_left, const i64* s_right) {
  Feats H{h_off, h_code, h_left, h_len};
  std::set<std::vector<i32>> uniq;
  std::vector<i32> row;
  for (i64 h = 0; h < nh; ++h) {
    row.clear();
    for (i64 s = 0; s < ns; ++s) {
      for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
        if (h_code[f] != 0) continue;
        if (h_left[f] <= s_right[s] && s_left[s] <= fright(H, f)) {
          row.push_back((i32)s);
          break;
        }
      }
    }
    if (row.size() > 2) uniq.insert(row);
  }
  auto* r = new StrawbCstr();
  r->off.push_back(0);
  for (const auto& c : uniq) {
    r->idx.insert(r->idx.end(), c.begin(), c.end());
    r->off.push_back((i64)r->idx.size());
  }
  return r;
}

i64 strawb_cstr_n(StrawbCstr* r) { return (i64)r->off.size() - 1; }
const i64* strawb_cstr_off(StrawbCstr* r) { return r->off.data(); }
const i32* strawb_cstr_idx(StrawbCstr* r) { return r->idx.data(); }
void strawb_cstr_free(StrawbCstr* r) { delete r; }

// fragLenDist inner loop (alignments.cpp:1363-1427): for each hit
// compatible with EXACTLY one transcript, emit its exonic overlap length
// with that transcript, in hit order. Returns count written to out_fl.
i64 strawb_fld(
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len,
    i64 ni, const i64* t_off, const i8* t_code, const i64* t_left,
    const i32* t_len,
    i32* out_fl) {
  strawb_perf::Scope _ps(strawb_perf::kFld);
  Feats H{h_off, h_code, h_left, h_len};
  Feats T{t_off, t_code, t_left, t_len};
  std::vector<std::vector<i64>> exons(ni);
  for (i64 t = 0; t < ni; ++t)
    for (i64 f = t_off[t]; f < t_off[t + 1]; ++f)
      if (t_code[f] == 0) exons[t].push_back(f);
  i64 nout = 0;
  for (i64 h = 0; h < nh; ++h) {
    int counter = 0;
    i64 mark = 0;
    for (i64 t = 0; t < ni && counter < 2; ++t)
      if (compat(H, h, T, t, exons[t])) {
        counter++;
        mark = t;
      }
    if (counter == 1) {
      i64 hl = h_left[h_off[h]];
      i64 hr = fright(H, h_off[h + 1] - 1);
      out_fl[nout++] = exonic_overlap_len(T, mark, hl, hr);
    }
  }
  return nout;
}

// Batched fragLenDist over a whole pass: loci are independent; a small
// thread pool walks contiguous locus ranges (split by hit count). Each
// locus L writes its lengths at out_fl[hit_loc_off[L]..] and its count to
// out_cnt[L]; offsets into the global flat arrays stay absolute, so the
// per-locus entry above is reused with shifted off pointers.
void strawb_fld_batch(
    i64 n_loci, const i64* hit_loc_off, const i64* iso_loc_off,
    const i64* h_off, const i8* h_code, const i64* h_left, const i32* h_len,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len,
    i32* out_fl, i64* out_cnt) {
  auto run_range = [&](i64 L0, i64 L1) {
    for (i64 L = L0; L < L1; ++L) {
      i64 hb = hit_loc_off[L], he = hit_loc_off[L + 1];
      i64 tb = iso_loc_off[L], te = iso_loc_off[L + 1];
      out_cnt[L] = strawb_fld(he - hb, h_off + hb, h_code, h_left, h_len,
                              te - tb, t_off + tb, t_code, t_left, t_len,
                              out_fl + hb);
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  size_t TN = hw > 1 ? (hw < 8 ? hw : 8) : 1;
  if (n_loci < 64 || TN <= 1) {
    run_range(0, n_loci);
    return;
  }
  i64 total_h = hit_loc_off[n_loci];
  std::vector<i64> cut(TN + 1, n_loci);
  cut[0] = 0;
  {
    i64 L = 0;
    for (size_t t = 1; t < TN; ++t) {
      i64 want = total_h * (i64)t / (i64)TN;
      while (L < n_loci && hit_loc_off[L] < want) ++L;
      cut[t] = L;
    }
  }
  std::vector<std::thread> pool;
  for (size_t t = 0; t < TN; ++t)
    pool.emplace_back([&, t]() { run_range(cut[t], cut[t + 1]); });
  for (auto& th : pool) th.join();
}

// Per-locus coverage + intron table (compute_doc, alignments.cpp:1838-1900).
// Hits with mass < 0 are reference models (skipped). Returns the number of
// intron entries written (capped at max_introns).
i64 strawb_coverage(
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len, const double* h_mass,
    i64 locus_left, i64 locus_right, double small_overhang,
    float* exon_doc /* size locus_right-locus_left+1, zeroed by caller */,
    i64 max_introns, i64* out_il, i64* out_ir, double* out_tot,
    double* out_small) {
  struct IK { i64 l, r; };
  std::vector<i64> keys_l, keys_r;
  std::vector<double> tot, small;
  auto find_or_add = [&](i64 l, i64 r) -> i64 {
    for (i64 k = 0; k < (i64)keys_l.size(); ++k)
      if (keys_l[k] == l && keys_r[k] == r) return k;
    keys_l.push_back(l);
    keys_r.push_back(r);
    tot.push_back(0.0);
    small.push_back(0.0);
    return (i64)keys_l.size() - 1;
  };
  for (i64 h = 0; h < nh; ++h) {
    double mass = h_mass[h];
    if (mass < 0) continue;  // reference model
    for (i64 f = h_off[h]; f < h_off[h + 1]; ++f) {
      i64 gl = h_left[f];
      i64 gr = gl + h_len[f] - 1;
      if (h_code[f] == 0) {
        i64 lo = gl > locus_left ? gl : locus_left;
        i64 hi = gr < locus_right ? gr : locus_right;
        for (i64 p = lo; p <= hi; ++p)
          exon_doc[p - locus_left] += (float)mass;
      } else if (h_code[f] == 1) {
        if (gl < locus_left || gr > locus_right) continue;
        i64 k = find_or_add(gl, gr);
        tot[k] += mass;
        if ((double)h_len[f - 1] < small_overhang ||
            (double)h_len[f + 1] < small_overhang)
          small[k] += mass;
      }
    }
  }
  i64 n = (i64)keys_l.size();
  if (n > max_introns) n = max_introns;
  for (i64 k = 0; k < n; ++k) {
    out_il[k] = keys_l[k];
    out_ir[k] = keys_r[k];
    out_tot[k] = tot[k];
    out_small[k] = small[k];
  }
  return n;
}

}  // extern "C"

extern "C" {

// addWeight's adjacency-arc support (assembly.cpp:779-792): for each arc
// with target.left - source.right == 1, scan hits IN ORDER, breaking at the
// first hit with left > arc_e (the reference's early exit — order matters
// because ref models are prepended unsorted), accumulating mass of hits
// with a MATCH feature spanning [arc_s - min_dist, arc_e + min_dist].
void strawb_adj_support(
    i64 nh, const i64* h_off, const i8* h_code, const i64* h_left,
    const i32* h_len, const double* h_mass,
    i64 na, const i64* arc_s, const i64* arc_e, i64 min_dist,
    double* out_support) {
  for (i64 a = 0; a < na; ++a) {
    double sup = 0.0;
    i64 as = arc_s[a], ae = arc_e[a];
    for (i64 h = 0; h < nh; ++h) {
      i64 b = h_off[h], e = h_off[h + 1];
      if (b == e) continue;
      i64 mp_left = h_left[b];
      i64 mp_right = h_left[e - 1] + h_len[e - 1] - 1;
      if (mp_left > ae) break;
      if (mp_right < as) continue;
      for (i64 f = b; f < e; ++f) {
        if (h_code[f] != 0) continue;
        i64 fl = h_left[f], fr = fl + h_len[f] - 1;
        if (fl <= as - min_dist && fr >= ae + min_dist) sup += h_mass[h];
      }
    }
    out_support[a] = sup;
  }
}

}  // extern "C"
