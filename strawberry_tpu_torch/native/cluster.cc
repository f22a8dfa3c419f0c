// Native clusterizer: the per-locus streaming scan, mate pairing,
// duplicate collapse, and fragment-to-contig conversion, in C++.
//
// Replaces the hot host half of HitCluster + Sample's cluster iterators
// (ref: src/alignments.cpp:149-1348) — semantics mirror the Python oracle
// in strawberry_tpu/core/cluster.py exactly (which in turn mirrors the
// reference; validated by tests/test_native_cluster.py):
//   * denovo / ref-guided (pass 1) and ref-demand (pass 2) iteration,
//     including addRef2Cluster's gene grouping + bounded look-ahead and
//     rewindReference
//   * addOpenHit pairing via the open-mates multimap, bound extension,
//     kMaxFragSpan rejection
//   * collapseAndFilterHits: stable (left,right) sort, sequential
//     mean/sd + 5-sigma A&S-phi span filter, adjacent duplicate collapse
//     by (left, raw-cigar) equality
//   * refine_cluster strand segmentation (1-D binary clustering)
//   * Contig(PairedHit): pair merge with gap insertion or overlap union
//
// Outputs are flat arrays consumed by strawberry_tpu/core/fastcluster.py.

#include "perfcnt.h"
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <thread>
#include <atomic>
#include <mutex>
#include <condition_variable>
#include <vector>

#include "asmprep.h"
#include "quantprep.h"
#include "sbam.h"

namespace {

typedef int64_t i64;
typedef int32_t i32;
typedef uint32_t u32;

const i64 UINT_MAX64 = 0xFFFFFFFFll;

struct Cfg {
  i64 max_olap_dist;
  i64 max_intron_length;
  i64 max_frag_span;
  i32 enforce_ref_models;
  i32 utilize_ref_models;
  i32 min_read_for_assemb;
  i32 mode;  // 0 = refguide/denovo (pass 1), 1 = ref-demand (pass 2)
};

struct HitsIn {
  i64 n;
  const i32* ref_id;
  const i64* left;
  const i64* right;
  const int8_t* strand;
  const uint16_t* flag;
  const i32* mate_ref;
  const i64* mate_pos;
  const i32* nh;
  const uint64_t* read_id;
  const uint64_t* cigar_hash;
  const i64* feat_off;
  const int8_t* feat_code;
  const i64* feat_left;
  const i32* feat_len;
};

struct RefsIn {
  i64 n;
  const i32* ref_id;
  const i64* left;
  const i64* right;
  const i32* gene;    // interned parent_id codes; -1 = empty string
  const int8_t* strand;
};

struct PH {
  i32 a = -1, b = -1;  // left/right hit row, -1 = none
  double mass = 0.0;
  double collapse = 0.0;
};

struct Seg {
  i64 left, right;
  i64 lidx, ridx;
  int8_t strand;
};

struct Out {
  // clusters
  std::vector<i64> cl_left, cl_right;
  std::vector<i32> cl_ref_id;
  std::vector<double> cl_wmass;
  std::vector<i64> cl_ref_off;     // size nclusters+1 -> flat_ref_idx
  std::vector<i32> flat_ref_idx;
  std::vector<i64> cl_uniq_off;    // size nclusters+1 -> contigs
  std::vector<i64> cl_seg_off;     // size nclusters+1 -> segs
  // uniq contigs (one per uniq PairedHit, in collapse order)
  std::vector<int8_t> ct_strand;
  std::vector<int8_t> ct_orit;     // 0 fwd single, 1 rev single, 2 paired
  std::vector<double> ct_mass;     // collapse mass
  std::vector<int8_t> ct_valid;    // 0 = pair merge failed (ref_id -1)
  // NB: per-contig feature runs are NOT duplicated here — invalid contigs
  // have no features, so the valid gather g_* below carries every feature;
  // contig ci's run is g_off[vcum[ci]] .. g_off[vcum[ci]+1] (empty when
  // invalid since vcum doesn't advance)
  // refine segments
  std::vector<i64> sg_left, sg_right, sg_lidx, sg_ridx;
  std::vector<int8_t> sg_strand;
  // VALID-contig gather, emitted alongside ct_* so the Python pool gets
  // its flat RLE views without a numpy repeat/arange pass:
  //   g_* = features of valid contigs only (in contig order), g_off their
  //   per-valid-contig offsets, g_mass their masses, vcum the running
  //   valid count per contig (size ncontigs+1)
  std::vector<i64> g_off{0};
  std::vector<int8_t> g_code;
  std::vector<i64> g_left;
  std::vector<i32> g_len;
  std::vector<double> g_mass;
  std::vector<i64> vcum{0};
  // fused pass-1 assembly-prep units (strawb_cluster_start_fused): one
  // entry per ref/seg unit, AsmJob* as intptr (0 = empty unit)
  bool fused = false;
  std::vector<i64> unit_off;  // size nclusters+1
  std::vector<i64> unit_job;
  std::vector<int8_t> unit_kind;  // 0 ref, 1 seg
  std::vector<int8_t> unit_strand;
  std::vector<i64> unit_l, unit_r;
  std::vector<int8_t> cl_admit;  // per cluster: >= min_read_for_assemb
  // fused pass-2 quant prep (strawb_cluster_start_qfused): per-cluster EM
  // inputs computed right after the cluster is built
  bool qfused = false;
  std::vector<i64> q_bin_off;  // size nclusters+1 -> q_counts
  std::vector<double> q_counts;
  std::vector<i64> q_alpha_off;  // size nclusters+1 -> q_alpha
  std::vector<double> q_alpha;
  std::string error;
};

// open-mate chain: inline first element (the overwhelmingly common case —
// one open pair per read id) avoids a heap allocation per read
struct Chain {
  PH first;
  std::vector<PH> rest;
};

// Flat open-addressing map for the open-mate table. Pairing only ever
// LOOKS UP the incoming read's own id (iteration order is never observed),
// so replacing unordered_map cannot change any output — it just drops the
// per-pairing node malloc/free and the O(buckets) clear.
struct OpenMap {
  struct Slot {
    uint64_t key = 0;
    uint8_t st = 0;  // 0 empty, 1 used, 2 tombstone
    Chain val;
  };
  std::vector<Slot> slots;
  size_t used = 0, tombs = 0;

  OpenMap() { slots.resize(64); }

  static size_t hsh(uint64_t k) {  // splitmix64 finalizer
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return (size_t)k;
  }

  Slot* find(uint64_t k) {
    size_t m = slots.size() - 1, i = hsh(k) & m;
    for (;;) {
      Slot& s = slots[i];
      if (s.st == 0) return nullptr;
      if (s.st == 1 && s.key == k) return &s;
      i = (i + 1) & m;
    }
  }

  void rehash(size_t cap) {
    std::vector<Slot> old;
    old.swap(slots);
    slots.resize(cap);
    tombs = 0;
    size_t m = cap - 1;
    for (Slot& s : old) {
      if (s.st != 1) continue;
      size_t i = hsh(s.key) & m;
      while (slots[i].st == 1) i = (i + 1) & m;
      slots[i].key = s.key;
      slots[i].st = 1;
      slots[i].val = std::move(s.val);
    }
  }

  Slot* insert(uint64_t k, Chain&& v) {
    if ((used + tombs + 1) * 4 >= slots.size() * 3)
      rehash(used * 4 >= slots.size() ? slots.size() * 2 : slots.size());
    size_t m = slots.size() - 1, i = hsh(k) & m;
    while (slots[i].st == 1) i = (i + 1) & m;
    if (slots[i].st == 2) tombs--;
    slots[i].key = k;
    slots[i].st = 1;
    slots[i].val = std::move(v);
    used++;
    return &slots[i];
  }

  void erase(Slot* s) {
    s->st = 2;
    s->val = Chain{};
    used--;
    tombs++;
  }

  void clear() {
    if (used + tombs == 0) return;
    if (slots.size() > 256) {  // shrink: big clusters shouldn't tax small
      std::vector<Slot>().swap(slots);
      slots.resize(64);
    } else {
      for (Slot& s : slots) {
        if (s.st == 1) s.val = Chain{};
        s.st = 0;
      }
    }
    used = tombs = 0;
  }
};

struct Cluster {
  i64 leftmost = UINT_MAX64;
  i64 rightmost = 0;
  i32 ref_id = -1;
  i32 gene = -2;  // -2 unset; mirrors cluster.gene_id string ("" == -1)
  bool gene_assigned = false;
  std::vector<PH> hits;
  std::vector<PH> uniq;
  OpenMap open;
  std::vector<i64> spans;
  std::vector<i32> refs;
  double wmass = 0.0;

  int size() const { return (int)hits.size(); }

  void reset() {  // reuse capacity across clusters
    leftmost = UINT_MAX64;
    rightmost = 0;
    ref_id = -1;
    gene = -2;
    gene_assigned = false;
    hits.clear();
    uniq.clear();
    open.clear();
    spans.clear();
    refs.clear();
    wmass = 0.0;
  }
};

// ---- global mate pairing -------------------------------------------------
// The reference pairs mates per cluster through an open-mates multimap
// (addOpenHit, alignments.cpp:490-651).  Pairing is closed under read_id
// (chains are per-id) and every match condition is row-local
// (left[i]==mate_pos[j] && mate_pos[i]==left[j] && id/ref equal && strand
// agree), so the per-cluster outcome is derivable from a single whole-
// partition pairing: for "simple" ids — every row has at most one matching
// candidate and candidates are mutual — the exact chain algorithm pairs row
// j with its unique candidate iff that candidate was added to the same
// cluster (and nothing else, since no other row can consume either mate).
// Ids where any row has >=2 same-key candidates (duplicate alignments of
// one read name, or FNV-1 name collisions) keep FIFO chain semantics and
// are demoted id-wide to the exact slow path.  This turns the O(n) hash
// multimap work of BOTH passes into one cache-friendly scan per partition.
struct GlobalPairs {
  std::vector<i32> partner;       // local row -> local partner row, -1 none
  std::vector<uint8_t> demoted;   // row of a complex id -> exact slow path
  bool any_demoted = false;
};

static void compute_global_pairs(const HitsIn& h, i64 h0, i64 h1,
                                 i64 max_frag_span, GlobalPairs& gp) {
  i64 n = h1 - h0;
  gp.partner.assign(n, -1);
  gp.demoted.assign(n, 0);
  gp.any_demoted = false;
  if (n == 0) return;
  std::vector<uint8_t> openable(n, 0);
  std::vector<uint8_t> cand_cnt(n, 0);
  for (i64 k = 0; k < n; ++k) {
    i64 i = h0 + k;
    if (h.mate_pos[i] == 0 || h.mate_ref[i] == -1 ||
        h.mate_ref[i] != h.ref_id[i])
      continue;  // singleton: never enters a chain
    if (h.mate_pos[i] == h.left[i]) continue;  // can neither open nor match
    if (std::llabs(h.right[i] - h.left[i]) > max_frag_span)
      continue;  // kMaxFragSpan reject: row never added anywhere
    openable[k] = 1;
  }
  // per chromosome run (rows are (ref, left)-sorted; merged multi-chrom
  // partitions restart left at each ref boundary). Openable rows are
  // gathered into compact records, radix-sorted by mate position, and
  // merged once against the left-sorted rows — O(n) SEQUENTIAL passes
  // (sorting bare indices instead would make the merge read three hit
  // arrays through a random permutation, which dominated the profile).
  struct OpenRec {
    u32 want;     // mate_pos (candidates have left == want)
    u32 j;        // local row
    u32 jleft;    // own left (candidate's mate_pos must equal it)
    int8_t js;    // own strand
    uint64_t jid;
  };
  std::vector<OpenRec> recs, scratch;
  std::vector<u32> cnt0(65536), cnt1(65536);
  i64 k0 = 0;
  while (k0 < n) {
    i64 k1 = k0;
    i32 ref = h.ref_id[h0 + k0];
    while (k1 < n && h.ref_id[h0 + k1] == ref) ++k1;
    recs.clear();
    for (i64 j = k0; j < k1; ++j)
      if (openable[j])
        recs.push_back({(u32)h.mate_pos[h0 + j], (u32)j,
                        (u32)h.left[h0 + j], h.strand[h0 + j],
                        h.read_id[h0 + j]});
    size_t m = recs.size();
    if (m) {
      // LSB radix by want (BAM positions fit u32): two 16-bit passes
      scratch.resize(m);
      std::fill(cnt0.begin(), cnt0.end(), 0);
      std::fill(cnt1.begin(), cnt1.end(), 0);
      for (const OpenRec& r : recs) {
        cnt0[r.want & 0xffff]++;
        cnt1[r.want >> 16]++;
      }
      u32 s0 = 0, s1 = 0;
      for (int b = 0; b < 65536; ++b) {
        u32 c = cnt0[b]; cnt0[b] = s0; s0 += c;
        c = cnt1[b]; cnt1[b] = s1; s1 += c;
      }
      for (const OpenRec& r : recs) scratch[cnt0[r.want & 0xffff]++] = r;
      for (const OpenRec& r : scratch) recs[cnt1[r.want >> 16]++] = r;
      // merge: advance p over rows (left-sorted) to the first row with
      // left >= want for each record in want order
      i64 p = k0;
      for (const OpenRec& r : recs) {
        i64 want = (i64)r.want;
        while (p < k1 && h.left[h0 + p] < want) ++p;
        for (i64 i = p; i < k1 && h.left[h0 + i] == want; ++i) {
          if (i == (i64)r.j || !openable[i]) continue;
          if (h.read_id[h0 + i] != r.jid) continue;
          if (h.mate_pos[h0 + i] != (i64)r.jleft) continue;
          int8_t is = h.strand[h0 + i];
          if (!(is == r.js || is == 0 || r.js == 0)) continue;
          if (cand_cnt[r.j] < 2) ++cand_cnt[r.j];
          gp.partner[r.j] = (i32)i;
        }
      }
    }
    k0 = k1;
  }
  // mutual unique candidates pair; anything ambiguous demotes the whole id
  std::unordered_set<uint64_t> bad_ids;
  for (i64 k = 0; k < n; ++k) {
    if (!cand_cnt[k]) { gp.partner[k] = -1; continue; }
    bool simple = cand_cnt[k] == 1;
    i32 p = gp.partner[k];
    if (simple && !(cand_cnt[p] == 1 && gp.partner[p] == (i32)k))
      simple = false;
    if (!simple) bad_ids.insert(h.read_id[h0 + k]);
  }
  if (!bad_ids.empty()) {
    gp.any_demoted = true;
    for (i64 k = 0; k < n; ++k)
      if (bad_ids.count(h.read_id[h0 + k])) {
        gp.demoted[k] = 1;
        gp.partner[k] = -1;
      }
  }
}

static double phi_as(double x) {
  if (std::isnan(x)) return std::numeric_limits<double>::quiet_NaN();
  const double a1 = 0.254829592, a2 = -0.284496736, a3 = 1.421413741,
               a4 = -1.453152027, a5 = 1.061405429, p = 0.3275911;
  int sign = (x < 0) ? -1 : 1;
  x = std::fabs(x) / std::sqrt(2.0);
  double t = 1.0 / (1.0 + p * x);
  double y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t *
                        std::exp(-x * x);
  return 0.5 * (1.0 + sign * y);
}

class Runner {
 public:
  Runner(const Cfg& cfg, const HitsIn& h, const RefsIn& r)
      : cfg_(cfg), h_(h), r_(r) {
    h_end_ = h.n;
    r_end_ = r.n;
  }

  // pairing reuse: point at a precomputed GlobalPairs (the sbam block
  // cache) instead of recomputing; call before run_range
  void use_external_pairs(const GlobalPairs* gp) { gp_ext_ = gp; }
  GlobalPairs take_pairs() { return std::move(gp_); }

  // run one (hits, refs) partition — index bounds into the GLOBAL arrays
  void run_range(Out& o, i64 h0, i64 h1, i64 r0, i64 r1) {
    cursor_ = h0;
    h_end_ = h1;
    ref_off_ = r0;
    r_end_ = r1;
    has_load_all_refs_ = false;
    if (gp_ext_ == nullptr) {
      strawb_perf::Scope _pg(cfg_.mode == 1 ? strawb_perf::kScan2
                                            : strawb_perf::kClusterScan);
      compute_global_pairs(h_, h0, h1, cfg_.max_frag_span, gp_);
      gp_view_ = &gp_;
    } else {
      gp_view_ = gp_ext_;
    }
    gp_base_ = h0;
    open_serial_.assign((size_t)(h1 - h0), -1);
    cur_serial_ = 0;
    // capacity guesses (paired data: ~0.55 contigs/hit, ~1.6 feats/contig)
    // avoid repeated geometric-growth memcpys in the emit loop
    i64 nh = h1 - h0;
    size_t nct = (size_t)(nh * 6 / 10 + 16);
    size_t nft = nct * 2;
    o.ct_strand.reserve(nct);
    o.ct_orit.reserve(nct);
    o.ct_mass.reserve(nct);
    o.ct_valid.reserve(nct);
    o.vcum.reserve(nct + 1);
    o.g_mass.reserve(nct);
    o.g_off.reserve(nct + 1);
    o.g_code.reserve(nft);
    o.g_left.reserve(nft);
    o.g_len.reserve(nft);
    run(o);
  }

  // ---- per-hit helpers --------------------------------------------------
  bool is_singleton(i32 i) const {
    return h_.mate_pos[i] == 0 || h_.mate_ref[i] == -1 ||
           h_.mate_ref[i] != h_.ref_id[i];
  }
  double hit_mass(i32 i) const {
    return (is_singleton(i) ? 1.0 : 0.5) / (double)h_.nh[i];
  }
  i64 pair_left(const PH& p) const {
    if (p.a >= 0 && p.b >= 0) return std::min(h_.left[p.a], h_.left[p.b]);
    return h_.left[p.a >= 0 ? p.a : p.b];
  }
  i64 pair_right(const PH& p) const {
    if (p.a >= 0 && p.b >= 0) return std::max(h_.right[p.a], h_.right[p.b]);
    return h_.right[p.a >= 0 ? p.a : p.b];
  }
  int8_t pair_strand(const PH& p) const {
    if (p.a >= 0 && p.b >= 0) {
      int8_t ls = h_.strand[p.a];
      return ls != 0 ? ls : h_.strand[p.b];
    }
    return h_.strand[p.a >= 0 ? p.a : p.b];
  }
  bool pair_splice(const PH& p) const {
    for (i32 i : {p.a, p.b}) {
      if (i < 0) continue;
      for (i64 f = h_.feat_off[i]; f < h_.feat_off[i + 1]; ++f)
        if (h_.feat_code[f] == 1) return true;
    }
    return false;
  }
  bool read_eq(i32 i, i32 j) const {
    return h_.left[i] == h_.left[j] && h_.cigar_hash[i] == h_.cigar_hash[j];
  }
  bool pair_eq(const PH& x, const PH& y) const {
    if ((x.a < 0) != (y.a < 0)) return false;
    if ((x.b < 0) != (y.b < 0)) return false;
    if (x.a >= 0 && !read_eq(x.a, y.a)) return false;
    if (x.b >= 0 && !read_eq(x.b, y.b)) return false;
    return true;
  }

  // ---- addOpenHit (alignments.cpp:490-651) ------------------------------
  bool add_open_hit(Cluster& c, i32 i, bool extend_by_hit,
                    bool extend_by_partner) {
    i64 orig_l = c.leftmost, orig_r = c.rightmost;
    i32 orig_ref = c.ref_id;
    i64 hl = h_.left[i], hr = h_.right[i];
    int8_t hs = h_.strand[i];
    i32 href = h_.ref_id[i];
    i64 hpp = h_.mate_pos[i];
    uint64_t hid = h_.read_id[i];
    bool rev = (h_.flag[i] & 0x10) != 0;

    if (extend_by_hit) {
      c.leftmost = std::min(c.leftmost, hl);
      c.rightmost = std::max(c.rightmost, hr);
    }
    if (extend_by_partner && hpp != 0 && h_.mate_ref[i] == c.ref_id) {
      if (hpp - hl < cfg_.max_intron_length)
        c.rightmost = std::max(std::max(c.rightmost, hr), hpp);
    }
    if (std::llabs(hr - hl) > cfg_.max_frag_span) {
      c.leftmost = orig_l;
      c.rightmost = orig_r;
      c.ref_id = orig_ref;
      return false;
    }
    c.spans.push_back(hr - hl + 1);
    if (c.ref_id == -1) {
      if (href != -1) c.ref_id = href;
    }
    if (is_singleton(i) || h_.mate_ref[i] != c.ref_id) {
      PH p;
      if (rev) p.b = i; else p.a = i;
      c.hits.push_back(p);
      return true;
    }
    i64 k = i - gp_base_;
    const GlobalPairs& gpv = *gp_view_;
    if (!gpv.any_demoted || !gpv.demoted[k]) {
      // fast path: the global pairing proved this id is simple — either a
      // mutual unique mate (pairs iff both rows land in this cluster) or
      // provably never pairs (no matching candidate exists anywhere, so the
      // exact chain would leave it open and finalize drops it)
      i32 p = gpv.partner[k];
      if (p < 0) return hpp != hl;  // mimic the hpp==hl `return false`
      if (p < (i32)k) {
        if (open_serial_[p] == (i32)cur_serial_) {
          PH ph;
          i32 pi = (i32)(p + gp_base_);
          if (h_.mate_pos[pi] > h_.left[pi]) { ph.a = pi; ph.b = i; }
          else { ph.a = i; ph.b = pi; }
          c.hits.push_back(ph);
          open_serial_[p] = -1;
        }
        return true;
      }
      open_serial_[k] = (i32)cur_serial_;
      return true;
    }
    OpenMap::Slot* it = c.open.find(hid);
    if (it == nullptr) {
      PH p;
      if (hpp > hl) p.a = i;
      else if (hpp < hl) p.b = i;
      else return false;
      c.open.insert(hid, Chain{p, {}});
      return true;
    }
    Chain& chain = it->val;
    size_t chain_len = 1 + chain.rest.size();
    for (size_t k = 0; k < chain_len; ++k) {
      PH& op = k == 0 ? chain.first : chain.rest[k - 1];
      int8_t os = pair_strand(op);
      bool strand_agree = os == hs || hs == 0 || os == 0;
      i64 expected = (op.b >= 0) ? h_.mate_pos[op.b] : h_.mate_pos[op.a];
      i32 oref = h_.ref_id[op.a >= 0 ? op.a : op.b];
      if (pair_left(op) == hpp && oref == href && strand_agree &&
          expected == hl) {
        if (op.a < 0 && op.b >= 0) op.a = i;
        else if (op.b < 0 && op.a >= 0) op.b = i;
        c.hits.push_back(op);
        if (k == 0) {
          if (chain.rest.empty()) {
            c.open.erase(it);
          } else {
            chain.first = chain.rest.front();
            chain.rest.erase(chain.rest.begin());
          }
        } else {
          chain.rest.erase(chain.rest.begin() + (k - 1));
        }
        return true;
      }
    }
    PH p;
    if (hpp > hl) p.a = i;
    else if (hpp < hl) p.b = i;
    else return false;
    chain.rest.push_back(p);
    return true;
  }

  // ---- collapse (alignments.cpp:658-703) --------------------------------
  struct KeyedPH {
    i64 l, r;
    PH p;
  };
  struct Key64 {
    uint64_t k;  // (left << 32) | right — lex-equal to (l, r) compares
    u32 idx;
  };
  std::vector<KeyedPH> collapse_keys_;   // reused scratch (wide fallback)
  std::vector<Key64> collapse_keys64_;   // reused scratch (packed path)
  std::vector<PH> collapse_hits_;        // reused scratch (permute source)

  void collapse(Cluster& c) {
    if (c.hits.empty()) return;
    // the reference uses UNSTABLE std::sort (alignments.cpp:662) with
    // PairedHit::operator< == (left_pos, right_pos); ties permute per
    // libstdc++'s introsort, which downstream collapse-mass runs and the
    // frag-set first-insert rule observe — so we must sort the same way.
    // Sorting cached keys gives the identical comparison sequence (and so
    // the identical tie permutation) without pair_left/right re-derivation.
    // Fast path: genomic coordinates fit in u32 (true for every real
    // genome), so (l, r) packs into one u64 whose < is the same relation —
    // identical comparator outcomes => identical introsort permutation.
    size_t nhits = c.hits.size();
    bool packed = true;
    {
      std::vector<Key64>& keyed = collapse_keys64_;
      keyed.clear();
      keyed.reserve(nhits);
      for (size_t i = 0; i < nhits; ++i) {
        i64 l = pair_left(c.hits[i]), r = pair_right(c.hits[i]);
        if ((uint64_t)l > 0xffffffffull || (uint64_t)r > 0xffffffffull) {
          packed = false;
          break;
        }
        keyed.push_back({((uint64_t)l << 32) | (uint64_t)r, (u32)i});
      }
      if (packed) {
        std::sort(keyed.begin(), keyed.end(),
                  [](const Key64& x, const Key64& y) { return x.k < y.k; });
        collapse_hits_.assign(c.hits.begin(), c.hits.end());
        for (size_t i = 0; i < nhits; ++i)
          c.hits[i] = collapse_hits_[keyed[i].idx];
      }
    }
    if (!packed) {
      std::vector<KeyedPH>& keyed = collapse_keys_;
      keyed.clear();
      keyed.reserve(nhits);
      for (const PH& p : c.hits)
        keyed.push_back({pair_left(p), pair_right(p), p});
      std::sort(keyed.begin(), keyed.end(),
                [](const KeyedPH& x, const KeyedPH& y) {
                  if (x.l != y.l) return x.l < y.l;
                  return x.r < y.r;
                });
      for (size_t i = 0; i < keyed.size(); ++i) c.hits[i] = keyed[i].p;
    }
    size_t n = c.spans.size();
    double mean = 0.0, sd = 0.0;
    if (n) {
      double acc = 0.0;
      for (i64 v : c.spans) acc += (double)v;
      mean = acc / (double)n;
      double sq = 0.0;
      for (i64 v : c.spans) {
        double d = (double)v - mean;
        sq += d * d;
      }
      sd = std::sqrt(sq / (double)n);
    }
    sd *= 5.0;
    for (PH& p : c.hits) {
      bool skip = false;
      for (i32 i : {p.a, p.b}) {
        if (i < 0) continue;
        double ln = (double)(h_.right[i] - h_.left[i] + 1);
        double x = (ln - mean) / sd;  // may be inf/nan, like the reference
        // phi_as(x) > 0.999 needs x in the far right tail: A&S 7.1.26's
        // max error is 1.5e-7, so for x <= 3.0 phi_as(x) <= 0.99866 and
        // the test cannot fire — skip the exp() for the common case.
        // NaN passes !(x <= 3.0) and reaches the exact evaluation, where
        // NaN > 0.999 is false (hit kept), same as the reference.
        if (!(x <= 3.0) && phi_as(x) > 0.999) {
          skip = true;
          break;
        }
      }
      if (skip) continue;
      double m = 0.0;
      if (p.a >= 0) m += hit_mass(p.a);
      if (p.b >= 0) m += hit_mass(p.b);
      p.mass = m;
      c.wmass += m;
      if (!c.uniq.empty() && pair_eq(c.uniq.back(), p)) {
        c.uniq.back().collapse += m;
      } else {
        c.uniq.push_back(p);
        c.uniq.back().collapse += m;
      }
    }
  }

  // ---- refine_cluster (alignments.cpp:160-307) --------------------------
  static int one_d_binary(const std::vector<int>& v) {
    int tc1 = 0, tc2 = 0;
    for (int x : v) (x == 0 ? tc1 : tc2)++;
    int l1 = 0, l2 = 0, r1 = tc1, r2 = tc2;
    long best = std::numeric_limits<long>::min();
    int best_idx = -1;
    for (size_t i = 0; i < v.size(); ++i) {
      if (v[i] == 0) { l1++; r1--; } else { l2++; r2--; }
      long s = std::max(l1, l2) + std::max(r1, r2);
      if (s >= best) { best_idx = (int)i; best = s; }
    }
    return best_idx;
  }

  void refine(Cluster& c, std::vector<Seg>& segs) {
    auto& uh = c.uniq;
    if (uh.empty()) return;
    i64 b0 = pair_left(uh[0]), b1 = pair_right(uh[0]);
    size_t start = 0, end = 1;
    std::vector<int> pm;
    std::vector<size_t> iri;

    auto emit = [&](i64 bl, i64 br, size_t st, size_t en) {
      int sep = one_d_binary(pm);
      if (sep != -1 && (size_t)(sep + 1) != pm.size()) {
        int first_class = pm[sep];
        size_t sl = iri[sep], sr = iri[sep + 1];
        i64 fl = UINT_MAX64, fr = 0, s2l = UINT_MAX64, s2r = 0;
        for (size_t ii = st; ii < sr; ++ii) {
          fl = std::min(pair_left(uh[ii]), fl);
          fr = std::max(pair_right(uh[ii]), fr);
        }
        for (size_t ii = sl; ii < en; ++ii) {
          s2l = std::min(pair_left(uh[ii]), s2l);
          s2r = std::max(pair_right(uh[ii]), s2r);
        }
        int8_t st1 = first_class == 0 ? 1 : 2;
        int8_t st2 = first_class == 0 ? 2 : 1;
        segs.push_back({fl, fr, (i64)st, (i64)sr, st1});
        segs.push_back({s2l, s2r, (i64)(sl + 1), (i64)(en + 1), st2});
      } else {
        int fc = pm.empty() ? -1 : pm.back();
        int8_t sgn = fc == -1 ? 0 : (fc == 0 ? 1 : 2);
        segs.push_back({bl, br, (i64)st, (i64)(en + 1), sgn});
      }
    };

    for (size_t i = 0; i < uh.size(); ++i) {
      i64 lp = pair_left(uh[i]);
      if (b0 <= lp && lp <= b1) {
        if (pair_splice(uh[i])) {
          int8_t s = pair_strand(uh[i]);
          if (s == 1) pm.push_back(0);
          else if (s == 2) pm.push_back(1);
          iri.push_back(i);
        }
        end = i;
        b0 = std::min(b0, lp);
        b1 = std::max(b1, pair_right(uh[i]));
      } else {
        emit(b0, b1, start, end);
        start = i;
        b0 = lp;
        b1 = pair_right(uh[i]);
        pm.clear();
        iri.clear();
        if (pair_splice(uh[i])) {
          int8_t s = pair_strand(uh[i]);
          if (s == 1) pm.push_back(0);
          else if (s == 2) pm.push_back(1);
          iri.push_back(i);
        }
      }
    }
    emit(b0, b1, start, end);
  }

  // ---- Contig(PairedHit) (contig.cpp:216-267) ---------------------------
  // Cursor-based bulk emit: the caller pre-sizes the Out arrays to an
  // upper bound for the whole cluster, and each contig writes through raw
  // pointers (per-element vector push_backs dominated the emit profile).
  struct EmitCur {
    int8_t* gc;
    i64* gl;
    i32* gn;
    i64 g;          // feature cursor (absolute index into g_*)
    i64* goff;      // g_off data (goff[v+1] written per valid contig)
    double* gms;
    i64 v;          // valid-contig cursor
    int8_t* cst;
    int8_t* cor;
    double* cms;
    int8_t* cval;
    i64* vcum;      // vcum data (vcum[c+1] written per contig)
    i64 c;          // contig cursor
  };

  void pair_to_contig(const PH& p, EmitCur& e) {
    i64 gbase = e.g;
    auto append_read = [&](i32 i) {
      i64 f0 = h_.feat_off[i], f1 = h_.feat_off[i + 1];
      size_t nf = (size_t)(f1 - f0);
      memcpy(e.gc + e.g, h_.feat_code + f0, nf);
      memcpy(e.gl + e.g, h_.feat_left + f0, nf * 8);
      memcpy(e.gn + e.g, h_.feat_len + f0, nf * 4);
      e.g += (i64)nf;
    };
    // one read's features are strictly increasing in `left` (sequential
    // CIGAR runs), so the reference's stable_sort by (left, len) reduces
    // to appends / a stable two-way merge with left-mate priority —
    // byte-identical outcome, no sort
    bool paired = p.a >= 0 && p.b >= 0;
    if (paired) {
      i64 gap = h_.left[p.b] - h_.right[p.a] - 1;
      if (gap > 0) {
        // a's runs < gap run < b's runs: already in sorted order
        append_read(p.a);
        e.gc[e.g] = 2;
        e.gl[e.g] = h_.right[p.a] + 1;
        e.gn[e.g] = (i32)gap;
        ++e.g;
        append_read(p.b);
      } else {
        // stable merge of the two sorted runs (ties keep a before b),
        // coalescing same-code neighbours on the fly
        // (merge_genomicFeats, contig.h:111-138); failure rolls the
        // cursor back so the contig comes out featureless (invalid)
        i64 a0 = h_.feat_off[p.a], a1 = h_.feat_off[p.a + 1];
        i64 b0 = h_.feat_off[p.b], b1 = h_.feat_off[p.b + 1];
        i64 ia = a0, ib = b0;
        int8_t fc = 0;
        i64 fl = 0;
        i32 fn = 0;
        bool have = false, ok = true;
        while (ia < a1 || ib < b1) {
          bool take_b;
          if (ia >= a1) take_b = true;
          else if (ib >= b1) take_b = false;
          else {
            i64 al = h_.feat_left[ia], bl = h_.feat_left[ib];
            take_b = bl < al ||
                     (bl == al && h_.feat_len[ib] < h_.feat_len[ia]);
          }
          i64 f = take_b ? ib++ : ia++;
          int8_t nc = h_.feat_code[f];
          i64 nl = h_.feat_left[f];
          i32 nn = h_.feat_len[f];
          if (!have) {
            fc = nc; fl = nl; fn = nn; have = true;
          } else if (nc == fc) {
            if (fc == 1) {
              if (!(fl == nl && fn == nn)) { ok = false; break; }
            } else {
              if (fl + fn - 1 < nl) { ok = false; break; }
              i64 right = std::max(fl + (i64)fn - 1, nl + (i64)nn - 1);
              fn = (i32)(right - fl + 1);
            }
          } else {
            e.gc[e.g] = fc; e.gl[e.g] = fl; e.gn[e.g] = fn; ++e.g;
            fc = nc; fl = nl; fn = nn;
          }
        }
        if (ok && have) {
          e.gc[e.g] = fc; e.gl[e.g] = fl; e.gn[e.g] = fn; ++e.g;
        }
        if (!ok) e.g = gbase;  // rollback: invalid contig
      }
    } else {
      append_read(p.a >= 0 ? p.a : p.b);
    }
    e.cst[e.c] = pair_strand(p);
    e.cor[e.c] = paired ? 2 : (p.a >= 0 ? 0 : 1);
    e.cms[e.c] = p.collapse;
    bool valid = e.g > gbase;
    e.cval[e.c] = valid ? 1 : 0;
    if (valid) {
      e.gms[e.v] = p.collapse;
      ++e.v;
      e.goff[e.v] = e.g;
    }
    e.vcum[e.c + 1] = e.vcum[e.c] + (valid ? 1 : 0);
    ++e.c;
  }

  // ---- reference loading (addRef2Cluster, alignments.cpp:1025-1079) -----
  int add_ref_to_cluster(Cluster& c) {
    if (ref_off_ >= r_end_) {
      has_load_all_refs_ = true;
      return 0;
    }
    c.gene = r_.gene[ref_off_];
    c.gene_assigned = true;
    add_ref_contig(c, (i32)ref_off_);
    ref_off_++;
    if (ref_off_ >= r_end_) {
      has_load_all_refs_ = true;
      return 1;
    }
    if (c.gene != -1) {  // non-empty gene id
      while (ref_off_ < r_end_ && r_.gene[ref_off_] == c.gene) {
        add_ref_contig(c, (i32)ref_off_);
        ref_off_++;
      }
      if (ref_off_ == r_end_) {
        has_load_all_refs_ = true;
        return (int)c.refs.size();
      }
      i64 mark = ref_off_;
      int over = 0;
      while (true) {
        ref_off_++;
        if (!(ref_off_ < r_.n && over < 100)) break;
        over++;
        if (r_.gene[ref_off_] == c.gene && r_.ref_id[ref_off_] == c.ref_id)
          add_ref_contig(c, (i32)ref_off_);
      }
      ref_off_ = mark;
    } else {
      size_t i = 0;
      while (i < c.refs.size()) {
        i32 ri = c.refs[i];
        i32 nx = (i32)ref_off_;
        bool dir_olap = r_.ref_id[ri] == r_.ref_id[nx] &&
                        r_.strand[ri] == r_.strand[nx] &&
                        r_.left[ri] <= r_.right[nx] &&
                        r_.left[nx] <= r_.right[ri];
        if (dir_olap) {
          add_ref_contig(c, nx);
          ref_off_++;
          if (ref_off_ >= r_end_) {
            has_load_all_refs_ = true;
            return (int)c.refs.size();
          }
          i = 0;
        } else {
          ++i;
        }
      }
    }
    return (int)c.refs.size();
  }

  void add_ref_contig(Cluster& c, i32 ri) {
    if (c.ref_id == -1) c.ref_id = r_.ref_id[ri];
    if (c.gene != r_.gene[ri]) return;
    c.leftmost = std::min(c.leftmost, r_.left[ri]);
    c.rightmost = std::max(c.rightmost, r_.right[ri]);
    c.refs.push_back(ri);
  }

  void rewind_reference(Cluster& c, int num_regress) {
    c.leftmost = UINT_MAX64;
    c.rightmost = 0;
    c.ref_id = -1;
    c.refs.clear();
    ref_off_ -= num_regress;
  }

  // ---- iteration --------------------------------------------------------
  bool hit_lt_cluster(i32 i, const Cluster& c, i64 olap) const {
    if (h_.ref_id[i] != c.ref_id) return h_.ref_id[i] < c.ref_id;
    return h_.right[i] + olap < c.leftmost;
  }
  bool hit_gt_cluster(i32 i, const Cluster& c, i64 olap) const {
    if (h_.ref_id[i] != c.ref_id) return h_.ref_id[i] > c.ref_id;
    return h_.left[i] > c.rightmost + olap;
  }

  int next_cluster_denovo(Cluster& c, i64 next_pos = std::numeric_limits<i64>::max(),
                          i64 next_ref = std::numeric_limits<i32>::max()) {
    if (cursor_ >= h_end_) return -1;
    while (true) {
      if (cursor_ >= h_end_) return c.size();
      i32 i = (i32)cursor_++;
      if (h_.ref_id[i] > next_ref ||
          (h_.ref_id[i] == next_ref && h_.right[i] >= next_pos)) {
        cursor_--;
        return c.size();
      }
      if (c.ref_id == -1) {
        add_open_hit(c, i, true, true);
      } else {
        if (hit_lt_cluster(i, c, cfg_.max_olap_dist)) continue;
        if (hit_gt_cluster(i, c, cfg_.max_olap_dist)) {
          cursor_--;
          break;
        }
        add_open_hit(c, i, true, true);
      }
    }
    return c.size();
  }

  int next_cluster_refguide(Cluster& c) {
    if (cursor_ >= h_end_) return -1;
    if (r_.n == 0) return next_cluster_denovo(c);
    int num_added = add_ref_to_cluster(c);
    if (num_added == 0) return next_cluster_denovo(c);
    while (true) {
      if (cursor_ >= h_end_) break;
      i32 i = (i32)cursor_++;
      if (hit_lt_cluster(i, c, cfg_.max_olap_dist)) {
        cursor_--;
        if (has_load_all_refs_) {
          rewind_reference(c, num_added);
          return next_cluster_denovo(c);
        }
        i64 np = r_.left[ref_off_];
        i64 nr = r_.ref_id[ref_off_];
        rewind_reference(c, num_added);
        return next_cluster_denovo(c, np, nr);
      }
      if (hit_gt_cluster(i, c, cfg_.max_olap_dist)) {
        cursor_--;
        break;
      }
      add_open_hit(c, i, false, false);
    }
    return c.size();
  }

  int next_cluster_ref_demand(Cluster& c) {
    if (cursor_ >= h_end_) return -1;
    int num_added = add_ref_to_cluster(c);
    if (num_added == 0) return -1;
    int8_t ref_strand = c.refs.empty() ? 0 : r_.strand[c.refs[0]];
    while (true) {
      if (cursor_ >= h_end_) break;
      i32 i = (i32)cursor_++;
      if (hit_lt_cluster(i, c, 0)) {
      } else if (hit_gt_cluster(i, c, 0)) {
        cursor_--;
        break;
      } else if (h_.strand[i] != 0 && h_.strand[i] != ref_strand) {
      } else {
        add_open_hit(c, i, false, false);
      }
    }
    return c.size();
  }

  void run(Out& o) {
    const bool p2 = cfg_.mode == 1;
    strawb_perf::Scope _ps(p2 ? strawb_perf::kScan2
                              : strawb_perf::kClusterScan);
    o.cl_ref_off.push_back(0);
    o.cl_uniq_off.push_back(0);
    o.cl_seg_off.push_back(0);
    Cluster c;
    while (true) {
      c.reset();
      ++cur_serial_;  // invalidates open_serial_ fast-path entries
      int rc = cfg_.mode == 1 ? next_cluster_ref_demand(c)
                              : next_cluster_refguide(c);
      if (rc == -1) break;
      if (c.ref_id == -1) continue;
      // finalize (open mates dropped), collapse + boundaries
      if (c.size() > 0) {
        {
          strawb_perf::Scope _pc(p2 ? strawb_perf::kCollapse2
                                    : strawb_perf::kClusterCollapse);
          collapse(c);
        }
        if (cfg_.enforce_ref_models && !c.refs.empty()) {
          c.leftmost = UINT_MAX64;
          c.rightmost = 0;
          for (i32 ri : c.refs) {
            c.leftmost = std::min(c.leftmost, r_.left[ri]);
            c.rightmost = std::max(c.rightmost, r_.right[ri]);
          }
        }
      }
      // refine segments for the pass-1 denovo path
      std::vector<Seg> segs;
      if (cfg_.mode == 0 &&
          !(cfg_.utilize_ref_models && !c.refs.empty()) &&
          (int)c.uniq.size() >= cfg_.min_read_for_assemb) {
        refine(c, segs);
      }
      // emit
      {
        strawb_perf::Scope _pe(p2 ? strawb_perf::kEmit2
                                  : strawb_perf::kClusterEmit);
        o.cl_left.push_back(c.leftmost);
        o.cl_right.push_back(c.rightmost);
        o.cl_ref_id.push_back(c.ref_id);
        o.cl_wmass.push_back(c.wmass);
        for (i32 ri : c.refs) o.flat_ref_idx.push_back(ri);
        o.cl_ref_off.push_back((i64)o.flat_ref_idx.size());
        {
          // pre-size to the cluster's upper bound, then emit through raw
          // cursors (see pair_to_contig)
          i64 fbound = 0;
          for (const PH& p : c.uniq) {
            if (p.a >= 0) fbound += h_.feat_off[p.a + 1] - h_.feat_off[p.a];
            if (p.b >= 0) fbound += h_.feat_off[p.b + 1] - h_.feat_off[p.b];
            ++fbound;  // potential pair-gap feature
          }
          size_t nct = c.uniq.size();
          size_t g0 = o.g_code.size();
          size_t c0 = o.ct_strand.size();
          size_t v0 = o.g_mass.size();
          o.g_code.resize(g0 + (size_t)fbound);
          o.g_left.resize(g0 + (size_t)fbound);
          o.g_len.resize(g0 + (size_t)fbound);
          o.ct_strand.resize(c0 + nct);
          o.ct_orit.resize(c0 + nct);
          o.ct_mass.resize(c0 + nct);
          o.ct_valid.resize(c0 + nct);
          o.g_mass.resize(v0 + nct);
          o.g_off.resize(v0 + 1 + nct);
          o.vcum.resize(c0 + 1 + nct);
          EmitCur e;
          e.gc = o.g_code.data();
          e.gl = o.g_left.data();
          e.gn = o.g_len.data();
          e.g = (i64)g0;
          e.goff = o.g_off.data();
          e.gms = o.g_mass.data();
          e.v = (i64)v0;
          e.cst = o.ct_strand.data();
          e.cor = o.ct_orit.data();
          e.cms = o.ct_mass.data();
          e.cval = o.ct_valid.data();
          e.vcum = o.vcum.data();
          e.c = (i64)c0;
          for (const PH& p : c.uniq) pair_to_contig(p, e);
          o.g_code.resize((size_t)e.g);
          o.g_left.resize((size_t)e.g);
          o.g_len.resize((size_t)e.g);
          o.g_mass.resize((size_t)e.v);
          o.g_off.resize((size_t)e.v + 1);
          // ct_*/vcum counts are exact (one entry per uniq pair)
        }
        o.cl_uniq_off.push_back((i64)o.ct_strand.size());
        for (const Seg& s : segs) {
          o.sg_left.push_back(s.left);
          o.sg_right.push_back(s.right);
          o.sg_lidx.push_back(s.lidx);
          o.sg_ridx.push_back(s.ridx);
          o.sg_strand.push_back(s.strand);
        }
        o.cl_seg_off.push_back((i64)o.sg_left.size());
      }
    }
  }

 private:
  Cfg cfg_;
  HitsIn h_;
  RefsIn r_;
  i64 cursor_ = 0;
  i64 ref_off_ = 0;
  i64 h_end_ = 0;
  i64 r_end_ = 0;
  bool has_load_all_refs_ = false;
  GlobalPairs gp_;
  const GlobalPairs* gp_ext_ = nullptr;
  const GlobalPairs* gp_view_ = &gp_;
  i64 gp_base_ = 0;
  std::vector<i32> open_serial_;  // row -> serial of the cluster it opened in
  i64 cur_serial_ = 0;
};

// One (hits, refs) chromosome partition. Clusters never span ref_ids, so
// each hit-bearing chromosome (plus any preceding ref-only chromosomes'
// refs) runs independently; partitions whose boundary refs share a gene
// code are merged (addRef2Cluster's same-gene loop has no ref_id check, so
// the sequential run could group such refs together).
struct Part {
  i64 h0, h1, r0, r1;
};

// Inputs of the fused pass-1 prep: reference-transcript RLE features +
// per-ref masses, plus the assembleprep knobs.
struct FusedIn {
  bool enabled = false;  // pass-1 assembly-prep fusion
  i64 read_len = 0;
  const i64* rf_off = nullptr;
  const int8_t* rf_code = nullptr;
  const i64* rf_left = nullptr;
  const i32* rf_len = nullptr;
  const double* rmass = nullptr;
  AsmPrepCfg acfg{};
  // pass-2 quant fusion
  bool quant = false;
  const i64* rexlen = nullptr;  // per-global-ref exonic length
  const double* pdf = nullptr;
  i64 pdf_len = 0;
  i64 base_lmin = 0;
  i32 long_read = 0;
};

// Per-cluster quant prep (LocusContext bins + weights) chained onto the
// clustering worker: hits = the cluster's valid contigs (the g_* gather),
// isoforms = the cluster's refs. Mirrors _quantify_batched's native specs.
static void fuse_quant(const FusedIn& fu, Out& o) {
  size_t ncl = o.cl_left.size();
  o.qfused = true;
  o.q_bin_off.push_back(0);
  o.q_alpha_off.push_back(0);
  std::vector<i64> ids;
  QuantLocusOut out;
  for (size_t k = 0; k < ncl; ++k) {
    i64 a0 = o.cl_uniq_off[k], a1 = o.cl_uniq_off[k + 1];
    i64 v0 = o.vcum[a0], v1 = o.vcum[a1];
    i64 r0 = o.cl_ref_off[k], r1 = o.cl_ref_off[k + 1];
    ids.clear();
    for (i64 q = r0; q < r1; ++q) ids.push_back(o.flat_ref_idx[q]);
    out.counts.clear();
    out.alpha.clear();
    strawb_quant_locus(o.g_off.data(), o.g_code.data(), o.g_left.data(),
                       o.g_len.data(), o.g_mass.data(), v0, v1,
                       fu.rf_off, fu.rf_code, fu.rf_left, fu.rf_len,
                       ids.data(), (i64)ids.size(), fu.rexlen,
                       fu.pdf, fu.pdf_len, fu.read_len, fu.base_lmin,
                       fu.long_read, out);
    o.q_counts.insert(o.q_counts.end(), out.counts.begin(),
                      out.counts.end());
    o.q_alpha.insert(o.q_alpha.end(), out.alpha.begin(), out.alpha.end());
    o.q_bin_off.push_back((i64)o.q_counts.size());
    o.q_alpha_off.push_back((i64)o.q_alpha.size());
  }
}

// Replicates pipeline.Sample.prepare_cluster_assembly for the clusters of
// one partition Out: the admission test, the utilize-ref unit (refs + valid
// strand-matching contigs, cov mass -1 for refs) or the per-refine-segment
// units, each submitted to the assembleprep worker pool with OWNED input
// copies (jobs outlive this Out's buffers on the Python side).
static void fuse_prep(const Cfg& cfg, const RefsIn& r, const FusedIn& fu,
                      Out& o) {
  size_t ncl = o.cl_left.size();
  o.fused = true;
  o.unit_off.push_back(0);
  std::vector<i64> off, left;
  std::vector<int8_t> code;
  std::vector<i32> len;
  std::vector<double> cov, wt;
  auto gather_contig = [&](i64 ci) {
    // valid contigs only (both callers check ct_valid): features live in
    // the valid gather at g_off[vcum[ci]] .. g_off[vcum[ci]+1]
    i64 v = o.vcum[ci];
    for (i64 f = o.g_off[v]; f < o.g_off[v + 1]; ++f) {
      code.push_back(o.g_code[f]);
      left.push_back(o.g_left[f]);
      len.push_back(o.g_len[f]);
    }
    off.push_back((i64)code.size());
    cov.push_back(o.ct_mass[ci]);
    wt.push_back(o.ct_mass[ci]);
  };
  auto submit = [&](i64 ul, i64 ur, int8_t kind, int8_t strand) {
    AsmJob* j = nullptr;
    if (off.size() > 1)
      j = strawb_asm_submit_owned(ul, ur, fu.read_len, std::move(off),
                                  std::move(code), std::move(left),
                                  std::move(len), std::move(cov),
                                  std::move(wt), fu.acfg);
    off = {0};
    code.clear();
    left.clear();
    len.clear();
    cov.clear();
    wt.clear();
    o.unit_job.push_back((i64)(intptr_t)j);
    o.unit_kind.push_back(kind);
    o.unit_strand.push_back(strand);
    o.unit_l.push_back(ul);
    o.unit_r.push_back(ur);
  };
  off.push_back(0);
  for (size_t k = 0; k < ncl; ++k) {
    i64 a0 = o.cl_uniq_off[k], a1 = o.cl_uniq_off[k + 1];
    i64 nct = a1 - a0;
    bool admit = nct >= cfg.min_read_for_assemb;
    o.cl_admit.push_back(admit ? 1 : 0);
    if (admit) {
      i64 r0 = o.cl_ref_off[k], r1 = o.cl_ref_off[k + 1];
      if (r1 > r0 && cfg.utilize_ref_models) {
        i64 cl = INT64_MAX, cr = 0;
        for (i64 q = r0; q < r1; ++q) {
          i32 ri = o.flat_ref_idx[q];
          cl = std::min(cl, r.left[ri]);
          cr = std::max(cr, r.right[ri]);
        }
        int8_t rstrand = r.strand[o.flat_ref_idx[r0]];
        for (i64 q = r0; q < r1; ++q) {
          i32 ri = o.flat_ref_idx[q];
          for (i64 f = fu.rf_off[ri]; f < fu.rf_off[ri + 1]; ++f) {
            code.push_back(fu.rf_code[f]);
            left.push_back(fu.rf_left[f]);
            len.push_back(fu.rf_len[f]);
          }
          off.push_back((i64)code.size());
          cov.push_back(-1.0);
          wt.push_back(fu.rmass[ri]);
        }
        for (i64 ci = a0; ci < a1; ++ci) {
          if (!o.ct_valid[ci]) continue;
          int8_t st = o.ct_strand[ci];
          if (st != 0 && st != rstrand) continue;
          gather_contig(ci);
        }
        submit(cl, cr, 0, rstrand);
      } else {
        for (i64 s = o.cl_seg_off[k]; s < o.cl_seg_off[k + 1]; ++s) {
          i64 lo = o.sg_lidx[s];
          i64 hi = o.sg_ridx[s] < nct ? o.sg_ridx[s] : nct;
          for (i64 c2 = lo; c2 < hi; ++c2) {
            i64 ci = a0 + c2;
            if (!o.ct_valid[ci]) continue;
            int8_t st = o.ct_strand[ci];
            if (st != 0 && st != o.sg_strand[s]) continue;
            gather_contig(ci);
          }
          submit(o.sg_left[s], o.sg_right[s], 1, o.sg_strand[s]);
        }
      }
    }
    o.unit_off.push_back((i64)o.unit_job.size());
  }
}

static std::vector<Part> compute_parts(const HitsIn& h, const RefsIn& r) {
  std::vector<Part> parts;
  i64 rcur = 0;
  i64 i = 0;
  while (i < h.n) {
    i64 j = i;
    while (j < h.n && h.ref_id[j] == h.ref_id[i]) j++;
    i64 re = rcur;
    while (re < r.n && r.ref_id[re] <= h.ref_id[i]) re++;
    parts.push_back({i, j, rcur, re});
    rcur = re;
    i = j;
  }
  // merge partitions linked by a shared boundary gene code
  std::vector<Part> merged;
  for (const Part& p : parts) {
    if (!merged.empty()) {
      Part& q = merged.back();
      bool link = q.r1 > q.r0 && p.r1 > p.r0 && r.gene[q.r1 - 1] != -1 &&
                  r.gene[q.r1 - 1] == r.gene[p.r0];
      if (link) {
        q.h1 = p.h1;
        q.r1 = p.r1;
        continue;
      }
    }
    merged.push_back(p);
  }
  return merged;
}

}  // namespace

extern "C" {

struct StrawbClusters {
  Out o;
};

// Streaming clusterizer: workers chew chromosome partitions in order while
// the caller consumes finished partitions (strawb_cluster_job_wait blocks
// with the GIL released on the Python side, so cluster decode + downstream
// prep overlap the clustering of later chromosomes).
// Copy-concat of 2+ sbam blocks for the rare merged partition (adjacent
// chromosomes' boundary refs sharing a gene code).
struct OwnedHits {
  std::vector<i32> ref_id;
  std::vector<i64> left, right;
  std::vector<int8_t> strand;
  std::vector<uint16_t> flag;
  std::vector<i32> mate_ref;
  std::vector<i64> mate_pos;
  std::vector<i32> nh;
  std::vector<uint64_t> read_id, cigar_hash;
  std::vector<i64> feat_off;
  std::vector<int8_t> feat_code;
  std::vector<i64> feat_left;
  std::vector<i32> feat_len;

  HitsIn view() const {
    return HitsIn{(i64)ref_id.size(), ref_id.data(), left.data(),
                  right.data(), strand.data(), flag.data(), mate_ref.data(),
                  mate_pos.data(), nh.data(), read_id.data(),
                  cigar_hash.data(), feat_off.data(), feat_code.data(),
                  feat_left.data(), feat_len.data()};
  }
};

// One unit of streaming work: a partition's hits (block-backed or owned
// copy) plus its global refs range.
struct PartWork {
  HitsIn h;
  i64 r0, r1;
  i64 blk0 = -1, blk1 = -1;  // sbam block range [blk0, blk1] of this part
};

struct StrawbClusterJob {
  Cfg cfg;
  HitsIn h;
  RefsIn r;
  FusedIn fu;
  std::vector<Part> parts;
  std::vector<StrawbClusters*> outs;
  std::vector<char> done;
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<size_t> next{0};

  // sbam streaming mode: a dispatcher thread turns finalized decode blocks
  // into PartWork items; `works`/`outs`/`done` grow under `mu`
  StrawbSbam* sbam = nullptr;
  i32 drop_consumed = 0;  // low-mem: drop each part's blocks after use
  std::vector<PartWork> works;
  std::vector<std::unique_ptr<OwnedHits>> owned;
  bool stream_done = false;
  bool aborted = false;    // set on free: release backpressure waits
  i64 consumed = 0;        // partitions the consumer has collected
  std::thread dispatcher;

  ~StrawbClusterJob() {
    {
      std::lock_guard<std::mutex> g(mu);
      aborted = true;
    }
    cv.notify_all();
    if (dispatcher.joinable()) dispatcher.join();
    for (auto& t : threads)
      if (t.joinable()) t.join();
    for (auto* p : outs) delete p;
  }
};

static HitsIn sbam_block_view(StrawbSbam* S, i64 k) {
  return HitsIn{strawb_sbam_block_n(S, k),
                strawb_sbam_block_ref_id(S, k),
                strawb_sbam_block_left(S, k),
                strawb_sbam_block_right(S, k),
                strawb_sbam_block_strand(S, k),
                strawb_sbam_block_flag(S, k),
                strawb_sbam_block_mate_ref(S, k),
                strawb_sbam_block_mate_pos(S, k),
                strawb_sbam_block_nh(S, k),
                strawb_sbam_block_read_id(S, k),
                strawb_sbam_block_cigar_hash(S, k),
                strawb_sbam_block_feat_off(S, k),
                strawb_sbam_block_feat_code(S, k),
                strawb_sbam_block_feat_left(S, k),
                strawb_sbam_block_feat_len(S, k)};
}

// Sequentially assign refs to finalized decode blocks exactly as
// compute_parts does over the whole table (including the linked-gene
// partition merge, which needs one block of lookahead), and enqueue
// PartWork items for the clustering workers.
static void sbam_dispatch(StrawbClusterJob* job) {
  StrawbSbam* S = job->sbam;
  const RefsIn& r = job->r;
  i64 rcur = 0, kblk = 0;
  const bool sub_chrom = strawb_sbam_split_enabled(S) != 0;
  const i64 spad = strawb_sbam_split_pad(S);
  while (strawb_sbam_wait_block(S, kblk) == 1) {
    std::vector<i64> blks{kblk};
    i32 chrom = strawb_sbam_block_chrom(S, kblk);
    i64 r0 = rcur, re = rcur;
    if (!sub_chrom) {
      while (re < r.n && r.ref_id[re] <= chrom) re++;
    } else {
      // sub-chromosome blocks (low-mem splitting): refs of this
      // chromosome distribute across its blocks by the recorded cut
      // positions — a ref belongs here unless the NEXT block continues
      // the chromosome and the ref's padded span reaches its cut (the
      // decoder places cuts so no gene's cluster straddles one)
      while (re < r.n && r.ref_id[re] < chrom) re++;
      i64 next_cut = -1;
      if (strawb_sbam_wait_block(S, kblk + 1) == 1 &&
          strawb_sbam_block_chrom(S, kblk + 1) == chrom)
        next_cut = strawb_sbam_block_cut(S, kblk + 1);
      while (re < r.n && r.ref_id[re] == chrom &&
             (next_cut < 0 || r.right[re] + spad < next_cut))
        re++;
    }
    // chain-merge linked-gene partitions (compute_parts' merge loop)
    while (re > r0 && re < r.n && r.gene[re - 1] != -1 &&
           r.gene[re - 1] == r.gene[re]) {
      if (strawb_sbam_wait_block(S, kblk + 1) != 1) break;
      i32 c2 = strawb_sbam_block_chrom(S, kblk + 1);
      if (r.ref_id[re] > c2) break;  // next part would carry no refs
      kblk++;
      blks.push_back(kblk);
      chrom = c2;
      if (!sub_chrom) {
        while (re < r.n && r.ref_id[re] <= chrom) re++;
      } else {
        while (re < r.n && r.ref_id[re] < chrom) re++;
        i64 nc = -1;
        if (strawb_sbam_wait_block(S, kblk + 1) == 1 &&
            strawb_sbam_block_chrom(S, kblk + 1) == chrom)
          nc = strawb_sbam_block_cut(S, kblk + 1);
        while (re < r.n && r.ref_id[re] == chrom &&
               (nc < 0 || r.right[re] + spad < nc))
          re++;
      }
    }
    rcur = re;
    PartWork w;
    w.r0 = r0;
    w.r1 = re;
    w.blk0 = blks.front();
    w.blk1 = blks.back();
    if (blks.size() == 1) {
      w.h = sbam_block_view(S, blks[0]);
    } else {
      auto own = std::make_unique<OwnedHits>();
      own->feat_off.push_back(0);
      for (i64 b : blks) {
        HitsIn v = sbam_block_view(S, b);
        i64 nf = strawb_sbam_block_nfeat(S, b);
        own->ref_id.insert(own->ref_id.end(), v.ref_id, v.ref_id + v.n);
        own->left.insert(own->left.end(), v.left, v.left + v.n);
        own->right.insert(own->right.end(), v.right, v.right + v.n);
        own->strand.insert(own->strand.end(), v.strand, v.strand + v.n);
        own->flag.insert(own->flag.end(), v.flag, v.flag + v.n);
        own->mate_ref.insert(own->mate_ref.end(), v.mate_ref,
                             v.mate_ref + v.n);
        own->mate_pos.insert(own->mate_pos.end(), v.mate_pos,
                             v.mate_pos + v.n);
        own->nh.insert(own->nh.end(), v.nh, v.nh + v.n);
        own->read_id.insert(own->read_id.end(), v.read_id, v.read_id + v.n);
        own->cigar_hash.insert(own->cigar_hash.end(), v.cigar_hash,
                               v.cigar_hash + v.n);
        i64 base = own->feat_off.back();
        for (i64 i = 1; i <= v.n; ++i)
          own->feat_off.push_back(base + v.feat_off[i]);
        own->feat_code.insert(own->feat_code.end(), v.feat_code,
                              v.feat_code + nf);
        own->feat_left.insert(own->feat_left.end(), v.feat_left,
                              v.feat_left + nf);
        own->feat_len.insert(own->feat_len.end(), v.feat_len,
                             v.feat_len + nf);
      }
      w.h = own->view();
      std::lock_guard<std::mutex> g(job->mu);
      job->owned.push_back(std::move(own));
    }
    {
      std::lock_guard<std::mutex> g(job->mu);
      job->works.push_back(w);
      job->outs.push_back(nullptr);
      job->done.push_back(0);
    }
    job->cv.notify_all();
    kblk++;
  }
  std::lock_guard<std::mutex> g(job->mu);
  job->stream_done = true;
  job->cv.notify_all();
}

// launch the dispatcher + workers for a streaming (sbam-fed) job
static void job_spawn_sbam(StrawbClusterJob* job, i32 n_threads) {
  job->dispatcher = std::thread([job]() { sbam_dispatch(job); });
  unsigned hw = std::thread::hardware_concurrency();
  size_t T = n_threads > 0 ? (size_t)n_threads : (hw > 1 ? 2 : 1);
  for (size_t t = 0; t < T; ++t) {
    job->threads.emplace_back([job]() {
      for (;;) {
        size_t k = job->next.fetch_add(1);
        PartWork w;
        {
          std::unique_lock<std::mutex> g(job->mu);
          job->cv.wait(g, [&] {
            return job->works.size() > k || job->stream_done ||
                   job->aborted;
          });
          if (job->aborted || k >= job->works.size()) break;
          w = job->works[k];
          if (job->drop_consumed) {
            // low-mem backpressure: don't cluster more than ~2 partitions
            // ahead of the consumer — finished-but-unconsumed Outs (each
            // holding a chromosome's cluster-owned copies) are what made
            // peak RSS grow with read depth
            job->cv.wait(g, [&] {
              return job->consumed + 2 >= (i64)k || job->aborted;
            });
            if (job->aborted) break;
          }
        }
        strawb_perf::PartTag _tag((int64_t)k);
        auto* out = new StrawbClusters();
        Runner runner(job->cfg, w.h, job->r);
        // single-block partitions cache their GlobalPairs on the stream
        // so pass 2 reuses pass 1's mate pairing (dropped blocks — low
        // mem — recompute; the pairing depends only on the hit arrays)
        bool can_cache = !job->drop_consumed && w.blk0 == w.blk1;
        const GlobalPairs* cached = can_cache
            ? (const GlobalPairs*)strawb_sbam_block_aux(job->sbam, w.blk0)
            : nullptr;
        if (cached) runner.use_external_pairs(cached);
        runner.run_range(out->o, 0, w.h.n, w.r0, w.r1);
        if (can_cache && cached == nullptr) {
          auto* save = new GlobalPairs(runner.take_pairs());
          strawb_sbam_block_set_aux(
              job->sbam, w.blk0, save,
              [](void* p) { delete (GlobalPairs*)p; });
        }
        if (job->fu.enabled) fuse_prep(job->cfg, job->r, job->fu, out->o);
        if (job->fu.quant) fuse_quant(job->fu, out->o);
        if (job->drop_consumed)  // low-mem: outputs are cluster-owned copies
          for (i64 b = w.blk0; b <= w.blk1; ++b)
            strawb_sbam_drop_block(job->sbam, b);
        {
          std::lock_guard<std::mutex> g(job->mu);
          job->outs[k] = out;
          job->done[k] = 1;
        }
        job->cv.notify_all();
      }
    });
  }
}

// compute partitions and launch the worker threads (shared by the plain,
// asm-fused and quant-fused entry points)
static void job_spawn(StrawbClusterJob* job, i32 n_threads) {
  job->parts = compute_parts(job->h, job->r);
  size_t np = job->parts.size();
  job->outs.assign(np, nullptr);
  job->done.assign(np, 0);
  if (np == 0) return;
  unsigned hw = std::thread::hardware_concurrency();
  size_t T = n_threads > 0 ? (size_t)n_threads : (hw > 1 ? 2 : 1);
  if (T > np) T = np;
  for (size_t t = 0; t < T; ++t) {
    job->threads.emplace_back([job]() {
      for (;;) {
        size_t k = job->next.fetch_add(1);
        if (k >= job->parts.size()) break;
        strawb_perf::PartTag _tag((int64_t)k);
        auto* out = new StrawbClusters();
        Runner runner(job->cfg, job->h, job->r);
        const Part& p = job->parts[k];
        runner.run_range(out->o, p.h0, p.h1, p.r0, p.r1);
        if (job->fu.enabled) fuse_prep(job->cfg, job->r, job->fu, out->o);
        if (job->fu.quant) fuse_quant(job->fu, out->o);
        {
          std::lock_guard<std::mutex> g(job->mu);
          job->outs[k] = out;
          job->done[k] = 1;
        }
        job->cv.notify_all();
      }
    });
  }
}

StrawbClusterJob* strawb_cluster_start(
    // hits
    i64 n, const i32* ref_id, const i64* left, const i64* right,
    const int8_t* strand, const uint16_t* flag, const i32* mate_ref,
    const i64* mate_pos, const i32* nh, const uint64_t* read_id,
    const uint64_t* cigar_hash, const i64* feat_off, const int8_t* feat_code,
    const i64* feat_left, const i32* feat_len,
    // refs
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    // cfg
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads) {
  auto* job = new StrawbClusterJob();
  job->h = HitsIn{n, ref_id, left, right, strand, flag, mate_ref, mate_pos,
                  nh, read_id, cigar_hash, feat_off, feat_code, feat_left,
                  feat_len};
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job_spawn(job, n_threads);
  return job;
}

// Quant-fused variant (pass 2): additionally computes each cluster's EM
// inputs (bins + weights) on the clustering workers. rf_* = flat RLE of the
// full reference list, rexlen = per-ref exonic lengths, pdf = dense
// fragment-length table, base_lmin = start_offset/read_len.
StrawbClusterJob* strawb_cluster_start_qfused(
    i64 n, const i32* ref_id, const i64* left, const i64* right,
    const int8_t* strand, const uint16_t* flag, const i32* mate_ref,
    const i64* mate_pos, const i32* nh, const uint64_t* read_id,
    const uint64_t* cigar_hash, const i64* feat_off, const int8_t* feat_code,
    const i64* feat_left, const i32* feat_len,
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads,
    i64 read_len, const i64* rf_off, const int8_t* rf_code,
    const i64* rf_left, const i32* rf_len, const i64* rexlen,
    const double* pdf, i64 pdf_len, i64 base_lmin, i32 long_read) {
  auto* job = new StrawbClusterJob();
  job->h = HitsIn{n, ref_id, left, right, strand, flag, mate_ref, mate_pos,
                  nh, read_id, cigar_hash, feat_off, feat_code, feat_left,
                  feat_len};
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job->fu.quant = true;
  job->fu.read_len = read_len;
  job->fu.rf_off = rf_off;
  job->fu.rf_code = rf_code;
  job->fu.rf_left = rf_left;
  job->fu.rf_len = rf_len;
  job->fu.rexlen = rexlen;
  job->fu.pdf = pdf;
  job->fu.pdf_len = pdf_len;
  job->fu.base_lmin = base_lmin;
  job->fu.long_read = long_read;
  job_spawn(job, n_threads);
  return job;
}

// Fused variant: additionally runs the per-cluster assembly prep (admission
// test + ref/seg unit construction + assembleprep submission) on the
// clustering workers. rf_* are the flat RLE features of the FULL reference
// list (indexed by global ref index), rmass the per-ref masses. dcfg =
// [min_anchor, min_depth_4_locus, min_isoform_frac, min_junc_support,
//  min_support_for_long_junc, binomial_overhang_alpha, intron_edge_weight,
//  min_depth_4_contig];
// icfg = [long_junc_length, enforce_ref_models_asm, max_cover_gap1,
//  max_cover_gap2, min_dist_4_exon_edge, min_trans_len, solve_flow].
StrawbClusterJob* strawb_cluster_start_fused(
    i64 n, const i32* ref_id, const i64* left, const i64* right,
    const int8_t* strand, const uint16_t* flag, const i32* mate_ref,
    const i64* mate_pos, const i32* nh, const uint64_t* read_id,
    const uint64_t* cigar_hash, const i64* feat_off, const int8_t* feat_code,
    const i64* feat_left, const i32* feat_len,
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads,
    i64 read_len, const i64* rf_off, const int8_t* rf_code,
    const i64* rf_left, const i32* rf_len, const double* rmass,
    const double* dcfg, const i64* icfg) {
  // build the job paused (n_threads not yet started) so we can attach the
  // fused inputs before any worker runs: create with 0 parts trick is
  // messier, so duplicate the small setup here
  auto* job = new StrawbClusterJob();
  job->h = HitsIn{n, ref_id, left, right, strand, flag, mate_ref, mate_pos,
                  nh, read_id, cigar_hash, feat_off, feat_code, feat_left,
                  feat_len};
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job->fu.enabled = true;
  job->fu.read_len = read_len;
  job->fu.rf_off = rf_off;
  job->fu.rf_code = rf_code;
  job->fu.rf_left = rf_left;
  job->fu.rf_len = rf_len;
  job->fu.rmass = rmass;
  job->fu.acfg = AsmPrepCfg{dcfg[0], dcfg[1], dcfg[2], dcfg[3], icfg[0],
                            dcfg[4], (i32)icfg[1], dcfg[5], icfg[2], icfg[3],
                            dcfg[6], icfg[4], (i32)icfg[6], icfg[5], dcfg[7]};
  job_spawn(job, n_threads);
  return job;
}

// Streaming (sbam-fed) variants of the three job starters: the hit arrays
// come from the decode stream's finalized chromosome blocks instead of a
// pre-decoded whole-file table, so clustering starts as soon as the first
// chromosome is parsed. Part count is unknown up front — consume with
// strawb_cluster_job_wait_next until it returns NULL.
StrawbClusterJob* strawb_cluster_start_sbam(
    void* sbam,
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads, i32 drop_consumed) {
  auto* job = new StrawbClusterJob();
  job->sbam = (StrawbSbam*)sbam;
  job->drop_consumed = drop_consumed;
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job_spawn_sbam(job, n_threads);
  return job;
}

StrawbClusterJob* strawb_cluster_start_sbam_fused(
    void* sbam,
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads, i32 drop_consumed,
    i64 read_len, const i64* rf_off, const int8_t* rf_code,
    const i64* rf_left, const i32* rf_len, const double* rmass,
    const double* dcfg, const i64* icfg) {
  auto* job = new StrawbClusterJob();
  job->sbam = (StrawbSbam*)sbam;
  job->drop_consumed = drop_consumed;
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job->fu.enabled = true;
  job->fu.read_len = read_len;
  job->fu.rf_off = rf_off;
  job->fu.rf_code = rf_code;
  job->fu.rf_left = rf_left;
  job->fu.rf_len = rf_len;
  job->fu.rmass = rmass;
  job->fu.acfg = AsmPrepCfg{dcfg[0], dcfg[1], dcfg[2], dcfg[3], icfg[0],
                            dcfg[4], (i32)icfg[1], dcfg[5], icfg[2], icfg[3],
                            dcfg[6], icfg[4], (i32)icfg[6], icfg[5], dcfg[7]};
  job_spawn_sbam(job, n_threads);
  return job;
}

StrawbClusterJob* strawb_cluster_start_sbam_qfused(
    void* sbam,
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode, i32 n_threads, i32 drop_consumed,
    i64 read_len, const i64* rf_off, const int8_t* rf_code,
    const i64* rf_left, const i32* rf_len, const i64* rexlen,
    const double* pdf, i64 pdf_len, i64 base_lmin, i32 long_read) {
  auto* job = new StrawbClusterJob();
  job->sbam = (StrawbSbam*)sbam;
  job->drop_consumed = drop_consumed;
  job->r = RefsIn{nref, rref_id, rleft, rright, rgene, rstrand};
  job->cfg = Cfg{max_olap_dist, max_intron_length, max_frag_span,
                 enforce_ref_models, utilize_ref_models, min_read_for_assemb,
                 mode};
  job->fu.quant = true;
  job->fu.read_len = read_len;
  job->fu.rf_off = rf_off;
  job->fu.rf_code = rf_code;
  job->fu.rf_left = rf_left;
  job->fu.rf_len = rf_len;
  job->fu.rexlen = rexlen;
  job->fu.pdf = pdf;
  job->fu.pdf_len = pdf_len;
  job->fu.base_lmin = base_lmin;
  job->fu.long_read = long_read;
  job_spawn_sbam(job, n_threads);
  return job;
}

// Streaming consumption, first half: blocks until the decoder has handed
// part k's block to the job (1) or the stream ended before part k (0). The
// caller then collects the part with strawb_cluster_job_wait_next; the two
// waits tell the decoder's time from the clustering workers'.
i32 strawb_cluster_job_wait_work(StrawbClusterJob* job, i64 k) {
  std::unique_lock<std::mutex> g(job->mu);
  job->cv.wait(g, [&] {
    return (i64)job->works.size() > k || job->stream_done;
  });
  return (i64)job->works.size() > k ? 1 : 0;
}

// Streaming consumption: blocks until part k is clustered (or the stream is
// exhausted). Returns the part's handle (caller frees with
// strawb_cluster_free) or NULL when the stream ended before part k.
StrawbClusters* strawb_cluster_job_wait_next(StrawbClusterJob* job, i64 k) {
  std::unique_lock<std::mutex> g(job->mu);
  job->cv.wait(g, [&] {
    return ((i64)job->done.size() > k && job->done[k]) ||
           (job->stream_done && (i64)job->works.size() <= k);
  });
  if (k + 1 > job->consumed) job->consumed = k + 1;
  g.unlock();
  job->cv.notify_all();  // release low-mem backpressure waits
  g.lock();
  if ((i64)job->done.size() <= k || !job->done[k]) return nullptr;
  StrawbClusters* out = job->outs[k];
  job->outs[k] = nullptr;
  return out;
}

i64 strawb_cluster_job_parts(StrawbClusterJob* job) {
  return (i64)job->parts.size();
}

// Blocks until partition k is clustered; transfers ownership of its
// StrawbClusters handle to the caller (free with strawb_cluster_free).
StrawbClusters* strawb_cluster_job_wait(StrawbClusterJob* job, i64 k) {
  std::unique_lock<std::mutex> g(job->mu);
  job->cv.wait(g, [&] { return job->done[k] != 0; });
  StrawbClusters* out = job->outs[k];
  job->outs[k] = nullptr;
  return out;
}

void strawb_cluster_job_free(StrawbClusterJob* job) { delete job; }

StrawbClusters* strawb_cluster_run(
    // hits
    i64 n, const i32* ref_id, const i64* left, const i64* right,
    const int8_t* strand, const uint16_t* flag, const i32* mate_ref,
    const i64* mate_pos, const i32* nh, const uint64_t* read_id,
    const uint64_t* cigar_hash, const i64* feat_off, const int8_t* feat_code,
    const i64* feat_left, const i32* feat_len,
    // refs
    i64 nref, const i32* rref_id, const i64* rleft, const i64* rright,
    const i32* rgene, const int8_t* rstrand,
    // cfg
    i64 max_olap_dist, i64 max_intron_length, i64 max_frag_span,
    i32 enforce_ref_models, i32 utilize_ref_models, i32 min_read_for_assemb,
    i32 mode) {
  HitsIn h{n, ref_id, left, right, strand, flag, mate_ref, mate_pos,
           nh, read_id, cigar_hash, feat_off, feat_code, feat_left, feat_len};
  RefsIn r{nref, rref_id, rleft, rright, rgene, rstrand};
  Cfg cfg{max_olap_dist, max_intron_length, max_frag_span,
          enforce_ref_models, utilize_ref_models, min_read_for_assemb, mode};
  auto* out = new StrawbClusters();

  std::vector<Part> parts = compute_parts(h, r);

  unsigned hw = std::thread::hardware_concurrency();
  i64 n_threads = hw > 1 ? 2 : 1;
  if (parts.size() <= 1 || n_threads <= 1) {
    Runner runner(cfg, h, r);
    runner.run_range(out->o, 0, h.n, 0, r.n);
    return out;
  }

  std::vector<Out> pouts(parts.size());
  std::atomic<size_t> next{0};
  auto work = [&]() {
    for (;;) {
      size_t k = next.fetch_add(1);
      if (k >= parts.size()) break;
      Runner runner(cfg, h, r);
      runner.run_range(pouts[k], parts[k].h0, parts[k].h1, parts[k].r0,
                       parts[k].r1);
    }
  };
  std::vector<std::thread> ts;
  for (i64 t = 0; t < n_threads; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();

  // ordered concatenation (offset vectors rebase on the running totals)
  Out& o = out->o;
  o.cl_ref_off.push_back(0);
  o.cl_uniq_off.push_back(0);
  o.cl_seg_off.push_back(0);
  for (const Out& p : pouts) {
    {
      i64 gb = o.g_off.back();
      for (size_t k = 1; k < p.g_off.size(); ++k)
        o.g_off.push_back(p.g_off[k] + gb);
      i64 vb = o.vcum.back();
      for (size_t k = 1; k < p.vcum.size(); ++k)
        o.vcum.push_back(p.vcum[k] + vb);
      o.g_code.insert(o.g_code.end(), p.g_code.begin(), p.g_code.end());
      o.g_left.insert(o.g_left.end(), p.g_left.begin(), p.g_left.end());
      o.g_len.insert(o.g_len.end(), p.g_len.begin(), p.g_len.end());
      o.g_mass.insert(o.g_mass.end(), p.g_mass.begin(), p.g_mass.end());
    }
    auto app = [](auto& d, const auto& s) {
      d.insert(d.end(), s.begin(), s.end());
    };
    app(o.cl_left, p.cl_left);
    app(o.cl_right, p.cl_right);
    app(o.cl_ref_id, p.cl_ref_id);
    app(o.cl_wmass, p.cl_wmass);
    app(o.flat_ref_idx, p.flat_ref_idx);
    app(o.ct_strand, p.ct_strand);
    app(o.ct_orit, p.ct_orit);
    app(o.ct_mass, p.ct_mass);
    app(o.ct_valid, p.ct_valid);
    app(o.sg_left, p.sg_left);
    app(o.sg_right, p.sg_right);
    app(o.sg_lidx, p.sg_lidx);
    app(o.sg_ridx, p.sg_ridx);
    app(o.sg_strand, p.sg_strand);
    i64 rb = o.cl_ref_off.back();
    for (size_t k = 1; k < p.cl_ref_off.size(); ++k)
      o.cl_ref_off.push_back(p.cl_ref_off[k] + rb);
    i64 ub = o.cl_uniq_off.back();
    for (size_t k = 1; k < p.cl_uniq_off.size(); ++k)
      o.cl_uniq_off.push_back(p.cl_uniq_off[k] + ub);
    i64 sb = o.cl_seg_off.back();
    for (size_t k = 1; k < p.cl_seg_off.size(); ++k)
      o.cl_seg_off.push_back(p.cl_seg_off[k] + sb);
  }
  return out;
}

// std::sort permutation oracle: sorts idx (pre-filled 0..n-1) by
// (left[i], right[i]) with the SAME libstdc++ introsort the reference's
// collapseAndFilterHits uses, so the Python oracle can reproduce the
// unstable tie order exactly.
void strawb_sort_pairs(i64 n, const i64* left, const i64* right, i64* idx) {
  std::sort(idx, idx + n, [&](i64 a, i64 b) {
    if (left[a] != left[b]) return left[a] < left[b];
    return right[a] < right[b];
  });
}

i64 strawb_cluster_n(StrawbClusters* s) { return (i64)s->o.cl_left.size(); }
i64 strawb_cluster_nct(StrawbClusters* s) { return (i64)s->o.ct_strand.size(); }
i64 strawb_cluster_nrefidx(StrawbClusters* s) { return (i64)s->o.flat_ref_idx.size(); }
i64 strawb_cluster_nseg(StrawbClusters* s) { return (i64)s->o.sg_left.size(); }

const i64* strawb_cluster_left(StrawbClusters* s) { return s->o.cl_left.data(); }
const i64* strawb_cluster_right(StrawbClusters* s) { return s->o.cl_right.data(); }
const i32* strawb_cluster_refid(StrawbClusters* s) { return s->o.cl_ref_id.data(); }
const double* strawb_cluster_wmass(StrawbClusters* s) { return s->o.cl_wmass.data(); }
const i64* strawb_cluster_refoff(StrawbClusters* s) { return s->o.cl_ref_off.data(); }
const i32* strawb_cluster_refidx(StrawbClusters* s) { return s->o.flat_ref_idx.data(); }
const i64* strawb_cluster_uniqoff(StrawbClusters* s) { return s->o.cl_uniq_off.data(); }
const i64* strawb_cluster_segoff(StrawbClusters* s) { return s->o.cl_seg_off.data(); }
const int8_t* strawb_cluster_ctstrand(StrawbClusters* s) { return s->o.ct_strand.data(); }
const int8_t* strawb_cluster_ctorit(StrawbClusters* s) { return s->o.ct_orit.data(); }
const double* strawb_cluster_ctmass(StrawbClusters* s) { return s->o.ct_mass.data(); }
const int8_t* strawb_cluster_ctvalid(StrawbClusters* s) { return s->o.ct_valid.data(); }
const i64* strawb_cluster_segleft(StrawbClusters* s) { return s->o.sg_left.data(); }
const i64* strawb_cluster_segright(StrawbClusters* s) { return s->o.sg_right.data(); }
const i64* strawb_cluster_seglidx(StrawbClusters* s) { return s->o.sg_lidx.data(); }
const i64* strawb_cluster_segridx(StrawbClusters* s) { return s->o.sg_ridx.data(); }
const int8_t* strawb_cluster_segstrand(StrawbClusters* s) { return s->o.sg_strand.data(); }

i64 strawb_cluster_nvalid(StrawbClusters* s) { return (i64)s->o.g_mass.size(); }
i64 strawb_cluster_ngfeat(StrawbClusters* s) { return (i64)s->o.g_code.size(); }
const i64* strawb_cluster_goff(StrawbClusters* s) { return s->o.g_off.data(); }
const int8_t* strawb_cluster_gcode(StrawbClusters* s) { return s->o.g_code.data(); }
const i64* strawb_cluster_gleft(StrawbClusters* s) { return s->o.g_left.data(); }
const i32* strawb_cluster_glen(StrawbClusters* s) { return s->o.g_len.data(); }
const double* strawb_cluster_gmass(StrawbClusters* s) { return s->o.g_mass.data(); }
const i64* strawb_cluster_vcum(StrawbClusters* s) { return s->o.vcum.data(); }

i32 strawb_cluster_qfused(StrawbClusters* s) { return s->o.qfused ? 1 : 0; }
i64 strawb_cluster_qnbins(StrawbClusters* s) { return (i64)s->o.q_counts.size(); }
i64 strawb_cluster_qnalpha(StrawbClusters* s) { return (i64)s->o.q_alpha.size(); }
const i64* strawb_cluster_qbinoff(StrawbClusters* s) { return s->o.q_bin_off.data(); }
const i64* strawb_cluster_qalphaoff(StrawbClusters* s) { return s->o.q_alpha_off.data(); }
const double* strawb_cluster_qcounts(StrawbClusters* s) { return s->o.q_counts.data(); }
const double* strawb_cluster_qalpha(StrawbClusters* s) { return s->o.q_alpha.data(); }

i32 strawb_cluster_fused(StrawbClusters* s) { return s->o.fused ? 1 : 0; }
i64 strawb_cluster_nunit(StrawbClusters* s) { return (i64)s->o.unit_job.size(); }
const i64* strawb_cluster_unitoff(StrawbClusters* s) { return s->o.unit_off.data(); }
const i64* strawb_cluster_unitjob(StrawbClusters* s) { return s->o.unit_job.data(); }
const int8_t* strawb_cluster_unitkind(StrawbClusters* s) { return s->o.unit_kind.data(); }
const int8_t* strawb_cluster_unitstrand(StrawbClusters* s) { return s->o.unit_strand.data(); }
const i64* strawb_cluster_unitl(StrawbClusters* s) { return s->o.unit_l.data(); }
const i64* strawb_cluster_unitr(StrawbClusters* s) { return s->o.unit_r.data(); }
const int8_t* strawb_cluster_admit(StrawbClusters* s) { return s->o.cl_admit.data(); }

void strawb_cluster_free(StrawbClusters* s) { delete s; }

}  // extern "C"
