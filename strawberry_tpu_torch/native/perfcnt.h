// Thread-CPU accumulators for the native hot paths (debug/bench only;
// enabled unconditionally — each scope costs two clock_gettime calls).
#pragma once
#include <atomic>
#include <ctime>

namespace strawb_perf {

enum Counter {
  kAsmPrep = 0,
  kQuantPrep,
  kFld,
  kClusterScan,
  kClusterCollapse,
  kClusterEmit,
  kQuantWeights,   // the fl-sum weight loop inside quant prep
  kScan2,          // pass-2 (refdemand) variants of the cluster phases
  kCollapse2,
  kEmit2,
  kFlowNS,         // NetworkSimplex + decompose/reconstruct (lemonns)
  kInflate,        // BGZF block inflate (decode stage-1 workers)
  kBamParse,       // BAM record parse into SoA (decode stage-2 workers)
  kBamMerge,       // per-chromosome accumulation/merge (decode stage 2)
  kNumCounters
};

inline std::atomic<long long>& slot(int k) {
  static std::atomic<long long> c[kNumCounters] = {};
  return c[k];
}

inline double thread_cpu() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

struct Scope {
  int k;
  double t0;
  explicit Scope(int k_) : k(k_), t0(thread_cpu()) {}
  ~Scope() {
    slot(k).fetch_add((long long)((thread_cpu() - t0) * 1e9),
                      std::memory_order_relaxed);
  }
};

}  // namespace strawb_perf
