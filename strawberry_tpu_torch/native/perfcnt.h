// Thread-CPU accumulators for the native hot paths, and the same scopes as
// spans on a trace's timeline while one runs. Each scope adds its thread
// CPU to its slot (two clock_gettime calls). While a trace records
// (strawb_perf_trace_start .. _stop, utils/profiling.py), each scope also
// appends (slot, thread id, partition, start, end) to one per-process
// buffer, the times in CLOCK_REALTIME nanoseconds, the clock of
// torch.profiler's trace files; off, a scope pays one relaxed atomic load
// and a branch, and no buffer exists.
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <ctime>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>

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

inline int64_t wall_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// One recorded scope. `part` is the clustering partition the thread was
// working on (PartTag), -1 elsewhere.
struct Span {
  int32_t slot, tid;
  int64_t part, t0, t1;
};

// The recording. `buf`, `cap`, `t_start` and `pid` are written only while
// `on` is false and no writer is inside span_end, and published by the
// store that sets `on`.
struct Recording {
  std::atomic<bool> on{false};
  std::atomic<int> writers{0};
  std::atomic<int64_t> next{0};       // spans claimed, dropped ones too
  std::atomic<int64_t> recorded{0};   // spans claimed in this process's life
  Span* buf = nullptr;
  int64_t cap = 0;
  int64_t t_start = 0;
  pid_t pid = 0;
};

inline Recording& recording() {
  static Recording r;
  return r;
}

inline int64_t& part_tag() {
  static thread_local int64_t p = -1;
  return p;
}

// Marks the spans of this thread with partition k while it lives.
struct PartTag {
  int64_t prev;
  explicit PartTag(int64_t k) : prev(part_tag()) { part_tag() = k; }
  ~PartTag() { part_tag() = prev; }
};

// The span's start, or -1 where nothing records (a forked child inherits
// the flag but not the recording).
inline int64_t span_begin() {
  Recording& r = recording();
  if (!r.on.load(std::memory_order_relaxed)) return -1;
  if (getpid() != r.pid) return -1;
  return wall_ns();
}

inline void span_end(int k, int64_t t0) {
  static thread_local int32_t tid = (int32_t)syscall(SYS_gettid);
  Recording& r = recording();
  r.writers.fetch_add(1);
  // a span begun before this recording started is not kept
  if (r.on.load() && t0 >= r.t_start) {
    int64_t i = r.next.fetch_add(1, std::memory_order_relaxed);
    r.recorded.fetch_add(1, std::memory_order_relaxed);
    if (i < r.cap) r.buf[i] = Span{k, tid, part_tag(), t0, wall_ns()};
  }
  r.writers.fetch_sub(1);
}

// Starts a recording of up to `cap` spans; false if one runs or the buffer
// cannot be had. Its pages are touched only as spans fill them.
inline bool trace_start(int64_t cap) {
  Recording& r = recording();
  if (r.on.load() || r.buf != nullptr || cap <= 0) return false;
  r.buf = static_cast<Span*>(std::malloc((size_t)cap * sizeof(Span)));
  if (r.buf == nullptr) return false;
  r.cap = cap;
  r.next.store(0);
  r.pid = getpid();
  r.t_start = wall_ns();
  r.on.store(true);
  return true;
}

// Stops the recording and waits out the writers inside span_end; returns
// the spans held and sets *dropped to those the full buffer refused.
inline int64_t trace_stop(int64_t* dropped) {
  Recording& r = recording();
  r.on.store(false);
  while (r.writers.load() != 0) std::this_thread::yield();
  int64_t n = r.next.load();
  int64_t held = n < r.cap ? n : r.cap;
  if (dropped) *dropped = n - held;
  return held;
}

struct Scope {
  int k;
  double t0;
  int64_t w0;
  explicit Scope(int k_) : k(k_), t0(thread_cpu()), w0(span_begin()) {}
  ~Scope() {
    if (w0 >= 0) span_end(k, w0);
    slot(k).fetch_add((long long)((thread_cpu() - t0) * 1e9),
                      std::memory_order_relaxed);
  }
};

}  // namespace strawb_perf
