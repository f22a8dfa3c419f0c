// Native BAM/BGZF decoder: multithreaded block inflate + record parse into
// structure-of-arrays buffers consumed zero-copy by numpy (ctypes binding in
// strawberry_tpu/io/native.py).
//
// Replaces the reference's vendored samtools-0.1.19 libbam + the per-record
// BAMHitFactory::getHitFromBuf loop (ref: src/read.cpp:459-715,
// external/samtools-0.1.19) with a batch decoder feeding the tensorization
// pipeline. Filter semantics are identical to the reference (and to the
// Python oracle in strawberry_tpu/io/bamreader.py, which validates this
// module):
//   - unmapped (flag&4 || tid<0) dropped
//   - zero-length CIGAR op drops the record
//   - intron (N) length outside [min_intron, max_intron] drops the record
//   - INS/DEL at cigar index <= 1 or last, or not MATCH-sandwiched, drops
//   - effective read length (sum of M) <= 1 drops
//   - NH>1 or secondary flag drops when use_only_unique_hits
//   - strand from XS tag, else --fr/--rf protocol inference
//
// Build: tools/build_native.sh -> strawberry_tpu/native/libstrawberry_host.so

#include <algorithm>
#include <deque>
#include <memory>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <atomic>
#include <condition_variable>
#include <memory>
#include <mutex>

#include "sbam.h"
#include "perfcnt.h"

#include <zlib.h>
#if defined(__has_include)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define STRAWB_HAVE_LIBDEFLATE 1
#endif
#endif

namespace {

struct BlockRef {
  size_t comp_off;   // offset of deflate payload within file buffer
  uint32_t comp_len;
  uint32_t isize;    // uncompressed size
  size_t out_off;    // offset within the inflated stream
};

// ---------------------------------------------------------------- BGZF ----
// Scan BGZF headers to index all blocks, then inflate in parallel.
static bool bgzf_index(const uint8_t* data, size_t n,
                       std::vector<BlockRef>& blocks, size_t& total_out) {
  size_t pos = 0;
  total_out = 0;
  while (pos + 18 <= n) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, data + pos + 10, 2);
    size_t xpos = pos + 12, xend = xpos + xlen;
    uint32_t bsize = 0;
    while (xpos + 4 <= xend) {
      uint8_t si1 = data[xpos], si2 = data[xpos + 1];
      uint16_t slen;
      memcpy(&slen, data + xpos + 2, 2);
      if (si1 == 0x42 && si2 == 0x43 && slen >= 2) {
        uint16_t v;
        memcpy(&v, data + xpos + 4, 2);
        bsize = (uint32_t)v + 1;
      }
      xpos += 4 + slen;
    }
    if (bsize == 0 || pos + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, data + pos + bsize - 4, 4);
    if (isize > 0) {
      BlockRef b;
      b.comp_off = pos + 12 + xlen;
      b.comp_len = bsize - 12 - xlen - 8;
      b.isize = isize;
      b.out_off = total_out;
      blocks.push_back(b);
      total_out += isize;
    }
    pos += bsize;
  }
  return true;
}

static bool inflate_block(const uint8_t* src, uint32_t src_len, uint8_t* dst,
                          uint32_t dst_len) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = src_len;
  zs.next_out = dst;
  zs.avail_out = dst_len;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END && zs.total_out == dst_len;
}

static bool bgzf_inflate_all(const uint8_t* data, size_t n,
                             std::vector<uint8_t>& out, int n_threads) {
  std::vector<BlockRef> blocks;
  size_t total = 0;
  if (!bgzf_index(data, n, blocks, total)) return false;
  out.resize(total);
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::vector<int> ok(n_threads, 1);
  size_t nb = blocks.size();
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
#ifdef STRAWB_HAVE_LIBDEFLATE
      libdeflate_decompressor* d = libdeflate_alloc_decompressor();
#endif
      for (size_t i = t; i < nb; i += n_threads) {
        const BlockRef& b = blocks[i];
#ifdef STRAWB_HAVE_LIBDEFLATE
        size_t actual = 0;
        if (libdeflate_deflate_decompress(d, data + b.comp_off, b.comp_len,
                                          out.data() + b.out_off, b.isize,
                                          &actual) != LIBDEFLATE_SUCCESS ||
            actual != b.isize)
          ok[t] = 0;
#else
        if (!inflate_block(data + b.comp_off, b.comp_len,
                           out.data() + b.out_off, b.isize))
          ok[t] = 0;
#endif
      }
#ifdef STRAWB_HAVE_LIBDEFLATE
      libdeflate_free_decompressor(d);
#endif
    });
  }
  for (auto& th : pool) th.join();
  for (int t = 0; t < n_threads; ++t)
    if (!ok[t]) return false;
  return true;
}

// ---------------------------------------------------------------- FNV ----
static inline uint64_t fnv1(const char* s) {
  uint64_t h = 0xcbf29ce484222325ull;
  for (; *s; ++s) {
    h *= 1099511628211ull;
    h ^= (uint8_t)*s;
  }
  return h;
}

// ------------------------------------------------------------- decode ----
struct Config {
  int32_t max_intron_length = 300000;
  int32_t min_intron_length = 20;
  int32_t use_only_unique_hits = 1;
  int32_t fr_strand = 0;
  int32_t rf_strand = 0;
  int32_t max_read_num_4_rl = 50000;
  int32_t min_map_qual = 0;  // -q: warning-only (src/read.cpp:525-527)
  // -v: capture the per-read cerr diagnostics (read.cpp:611-614,679-684)
  // as ordered events; set from STRAWB_VERBOSE by the open entry points
  int32_t verbose = 0;
};

static int32_t env_verbose() {
  return getenv("STRAWB_VERBOSE") != nullptr ? 1 : 0;
}

struct Result {
  // per accepted hit
  std::vector<int32_t> ref_id;
  std::vector<int64_t> left, right;
  std::vector<int8_t> strand;
  std::vector<uint16_t> flag;
  std::vector<int32_t> mate_ref;
  std::vector<int64_t> mate_pos;
  std::vector<int32_t> nh;
  std::vector<uint64_t> read_id, cigar_hash;
  std::vector<int64_t> feat_off;
  std::vector<int8_t> feat_code;
  std::vector<int64_t> feat_left;
  std::vector<int32_t> feat_len;
  // header
  std::string names_blob;  // '\n'-joined reference names
  std::vector<int32_t> ref_len;
  // read-length histogram over first max_read_num_4_rl accepted hits
  std::vector<int32_t> hist_len, hist_count;
  // -v per-read diagnostics (kind, accepted-rows-before, names blob)
  std::vector<int8_t> diag_kind;
  std::vector<int64_t> diag_row;
  std::string diag_names;
  int32_t paired_end = 0;
  std::string error;
};

static int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
static uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// Per-chunk output of the parallel record decode. Records are fully
// independent (the only cross-record state in the reference's loop is the
// read-length histogram over the first kMaxReadNum4RL ACCEPTED hits, which
// the merge step reconstructs from per-chunk accepted seq-lens in order).
struct Partial {
  std::vector<int32_t> ref_id;
  std::vector<int64_t> left, right;
  std::vector<int8_t> strand;
  std::vector<uint16_t> flag;
  std::vector<int32_t> mate_ref;
  std::vector<int64_t> mate_pos;
  std::vector<int32_t> nh;
  std::vector<uint64_t> read_id, cigar_hash;
  std::vector<int64_t> nfeat;  // per accepted hit
  std::vector<int8_t> feat_code;
  std::vector<int64_t> feat_left;
  std::vector<int32_t> feat_len;
  std::vector<int32_t> seqlens;  // accepted-hit seq lens (capped at max_hist)
  // -v per-read diagnostic events in record order: kind (0 = unmapped
  // pair, 1 = multi-hit reject), accepted rows in THIS partial before the
  // event, '\n'-joined read names
  std::vector<int8_t> ev_kind;
  std::vector<int64_t> ev_row;
  std::string ev_names;
  int32_t paired_end = 0;

  void clear() {  // keep capacity (streaming windows reuse the buffers)
    ref_id.clear(); left.clear(); right.clear(); strand.clear();
    flag.clear(); mate_ref.clear(); mate_pos.clear(); nh.clear();
    read_id.clear(); cigar_hash.clear(); nfeat.clear(); feat_code.clear();
    feat_left.clear(); feat_len.clear(); seqlens.clear();
    ev_kind.clear(); ev_row.clear(); ev_names.clear();
    paired_end = 0;
  }
};

static void decode_range(const uint8_t* buf, const size_t* offs,
                         size_t lo, size_t hi, const Config& cfg, Partial& R) {
  size_t cnt = hi - lo;
  R.ref_id.reserve(cnt);
  R.left.reserve(cnt);
  R.right.reserve(cnt);
  R.strand.reserve(cnt);
  R.flag.reserve(cnt);
  R.mate_ref.reserve(cnt);
  R.mate_pos.reserve(cnt);
  R.nh.reserve(cnt);
  R.read_id.reserve(cnt);
  R.cigar_hash.reserve(cnt);
  R.nfeat.reserve(cnt);
  R.feat_code.reserve(cnt * 2);
  R.feat_left.reserve(cnt * 2);
  R.feat_len.reserve(cnt * 2);
  for (size_t ri = lo; ri < hi; ++ri) {
    size_t rec = offs[ri] + 4;
    size_t rec_end = rec + (size_t)rd_i32(buf + offs[ri]);

    int32_t tid = rd_i32(buf + rec);
    int32_t p0 = rd_i32(buf + rec + 4);
    uint8_t l_read_name = buf[rec + 8];
    uint16_t n_cigar = rd_u16(buf + rec + 12);
    uint16_t flag = rd_u16(buf + rec + 14);
    int32_t l_seq = rd_i32(buf + rec + 16);
    int32_t mtid = rd_i32(buf + rec + 20);
    int32_t mpos = rd_i32(buf + rec + 24);
    const char* qname = (const char*)(buf + rec + 32);
    size_t cig = rec + 32 + l_read_name;

    if ((flag & 0x4) || tid < 0) continue;

    // warning-only low-mapq check, before the CIGAR filters
    // (src/read.cpp:525-527; the read is NOT dropped)
    if ((int32_t)buf[rec + 9] < cfg.min_map_qual)
      fprintf(stderr, "Read %s has not reached min mapq: %d\n", qname,
              cfg.min_map_qual);

    // Single pass over the CIGAR: emit genomic features directly
    // (rolled back below if any filter fires) while replicating the
    // reference's op checks against the CIGAR-op sequence with H and P
    // removed (the reference's _cigar vector, read.cpp:542-599):
    //   * zero-length op or unknown op -> drop
    //   * intron (N) length outside [min,max] -> drop
    //   * I/D must sit at kept-op index >= 2 (read.cpp's `i-1 <= 0` quirk:
    //     an indel as the SECOND op is rejected even after a leading M),
    //     be preceded AND followed by an M, and not be the last kept op
    bool okr = true;
    int64_t read_len = 0;  // genomic span: M + D + N
    int64_t seq_len = 0;   // query length: M + S + I + H
    int64_t eff = 0;       // M only
    uint64_t chash = 0xcbf29ce484222325ull;
    size_t nf0 = R.feat_code.size();
    int64_t goff = (int64_t)p0 + 1;
    size_t kept = 0;        // index within the H/P-stripped op sequence
    int prev_kept = -1;     // code of previous kept op
    bool need_m_next = false;  // pending I/D sandwich: next kept must be M
    for (uint32_t ci = 0; ci < n_cigar; ++ci) {
      uint32_t v = rd_u32(buf + cig + 4 * ci);
      chash = (chash ^ (uint64_t)v) * 1099511628211ull;
      uint32_t op = v & 0xF, ln = v >> 4;
      if (ln == 0) {
        okr = false;
        break;
      }
      if (op == 5) {  // H: not a kept op
        seq_len += ln;
        continue;
      }
      if (op == 6) continue;  // P: not a kept op
      if (op > 6) {
        okr = false;
        break;
      }
      if (need_m_next && op != 0) {
        okr = false;
        break;
      }
      need_m_next = false;
      switch (op) {
        case 0:  // M: its own feature (runs after D/I stay split)
          read_len += ln;
          eff += ln;
          seq_len += ln;
          R.feat_code.push_back(0);
          R.feat_left.push_back(goff);
          R.feat_len.push_back(ln);
          goff += ln;
          break;
        case 1:  // I
          seq_len += ln;
          if (kept <= 1 || prev_kept != 0) okr = false;
          need_m_next = true;
          break;
        case 2:  // D: extends the previous (M) feature
          read_len += ln;
          if (kept <= 1 || prev_kept != 0) okr = false;
          else {
            R.feat_len.back() += ln;
            goff += ln;
          }
          need_m_next = true;
          break;
        case 3:  // N
          read_len += ln;
          if ((int64_t)ln > cfg.max_intron_length ||
              (int64_t)ln < cfg.min_intron_length)
            okr = false;
          R.feat_code.push_back(1);
          R.feat_left.push_back(goff);
          R.feat_len.push_back(ln);
          goff += ln;
          break;
        case 4:  // S
          seq_len += ln;
          break;
      }
      if (!okr) break;
      prev_kept = (int)op;
      ++kept;
    }
    if (need_m_next) okr = false;  // I/D was the last kept op
    if (!okr || eff <= 1) {
      R.feat_code.resize(nf0);
      R.feat_left.resize(nf0);
      R.feat_len.resize(nf0);
      continue;
    }

    if (flag & 0x1) R.paired_end = 1;

    // aux tags: XS (strand), NH
    int8_t strand = 0;
    int32_t nh = 1;
    size_t a = cig + 4 * (size_t)n_cigar + (l_seq + 1) / 2 + l_seq;
    while (a + 3 <= rec_end) {
      uint8_t t0 = buf[a], t1 = buf[a + 1], typ = buf[a + 2];
      a += 3;
      bool isXS = (t0 == 'X' && t1 == 'S');
      bool isNH = (t0 == 'N' && t1 == 'H');
      if (typ == 'A') {
        if (isXS) {
          if (buf[a] == '+') strand = 1;
          else if (buf[a] == '-') strand = 2;
        }
        a += 1;
      } else if (typ == 'c' || typ == 'C') {
        if (isNH) nh = (typ == 'c') ? (int8_t)buf[a] : buf[a];
        a += 1;
      } else if (typ == 's' || typ == 'S') {
        uint16_t v = rd_u16(buf + a);
        if (isNH) nh = (typ == 's') ? (int16_t)v : v;
        a += 2;
      } else if (typ == 'i' || typ == 'I') {
        uint32_t v = rd_u32(buf + a);
        if (isNH) nh = (int32_t)v;
        a += 4;
      } else if (typ == 'f') {
        a += 4;
      } else if (typ == 'Z' || typ == 'H') {
        while (a < rec_end && buf[a] != 0) ++a;
        ++a;
      } else if (typ == 'B') {
        uint8_t sub = buf[a];
        int32_t cnt = rd_i32(buf + a + 1);
        int sz = (sub == 'c' || sub == 'C') ? 1
                 : (sub == 's' || sub == 'S') ? 2 : 4;
        a += 5 + (size_t)cnt * sz;
      } else {
        break;
      }
    }

    if (strand == 0 && (cfg.fr_strand || cfg.rf_strand)) {
      bool rev = flag & 0x10;
      bool key = (cfg.rf_strand && rev) || (cfg.fr_strand && !rev);
      if (flag & 0x40) strand = key ? 1 : 2;
      else strand = key ? 2 : 1;
    }

    if (cfg.verbose && (flag & 0x1) && mtid != tid && (flag & 0x8)) {
      // read.cpp:611-614: paired, mate on another target, mate unmapped
      R.ev_kind.push_back(0);
      R.ev_row.push_back((int64_t)R.ref_id.size());
      R.ev_names.append(qname);
      R.ev_names.push_back('\n');
    }
    if (cfg.use_only_unique_hits && (nh > 1 || (flag & 0x100))) {
      if (cfg.verbose) {  // read.cpp:679-684
        R.ev_kind.push_back(1);
        R.ev_row.push_back((int64_t)R.ref_id.size());
        R.ev_names.append(qname);
        R.ev_names.push_back('\n');
      }
      R.feat_code.resize(nf0);  // roll back the directly-emitted features
      R.feat_left.resize(nf0);
      R.feat_len.resize(nf0);
      continue;
    }

    // genomic features (readhit_2_genomicFeats, contig.cpp:12-52) were
    // emitted directly in the CIGAR pass above: every M op is its own
    // feature, D extends the previous feature, and the M after a D or I
    // starts a NEW feature adjacent to the previous one — the reference
    // does not merge such runs, and the split/merged distinction is
    // observable downstream (exon-bin assignment).
    R.ref_id.push_back(tid);
    R.left.push_back((int64_t)p0 + 1);
    R.right.push_back((int64_t)p0 + read_len);
    R.strand.push_back(strand);
    R.flag.push_back(flag);
    R.mate_ref.push_back(mtid >= 0 ? mtid : -1);
    R.mate_pos.push_back((int64_t)mpos + 1);
    R.nh.push_back(nh);
    R.read_id.push_back(fnv1(qname));
    R.cigar_hash.push_back(chash);
    R.nfeat.push_back((int64_t)(R.feat_code.size() - nf0));

    if ((int64_t)R.seqlens.size() < cfg.max_read_num_4_rl)
      R.seqlens.push_back((int32_t)seq_len);
  }
}

template <class T>
static void concat(std::vector<T>& dst, std::vector<Partial>& parts,
                   std::vector<T> Partial::*m) {
  size_t total = 0;
  for (auto& p : parts) total += (p.*m).size();
  dst.reserve(total);
  for (auto& p : parts) {
    dst.insert(dst.end(), (p.*m).begin(), (p.*m).end());
    std::vector<T>().swap(p.*m);  // free as we go
  }
}

static bool decode_records(const uint8_t* buf, size_t n, const Config& cfg,
                           Result& R, int n_threads) {
  if (n < 12 || memcmp(buf, "BAM\1", 4) != 0) {
    R.error = "not a BAM file";
    return false;
  }
  size_t pos = 4;
  int32_t l_text = rd_i32(buf + pos);
  pos += 4 + l_text;
  int32_t n_ref = rd_i32(buf + pos);
  pos += 4;
  for (int32_t i = 0; i < n_ref; ++i) {
    int32_t l_name = rd_i32(buf + pos);
    pos += 4;
    R.names_blob.append((const char*)(buf + pos), l_name - 1);
    R.names_blob.push_back('\n');
    pos += l_name;
    R.ref_len.push_back(rd_i32(buf + pos));
    pos += 4;
  }

  // boundary scan: record start offsets (cheap block_size hopping)
  std::vector<size_t> offs;
  offs.reserve(n / 96);
  while (pos + 4 <= n) {
    int32_t block_size = rd_i32(buf + pos);
    if (pos + 4 + (size_t)block_size > n) break;
    offs.push_back(pos);
    pos += 4 + (size_t)block_size;
  }

  if (n_threads < 1) n_threads = 1;
  size_t nrec = offs.size();
  size_t T = (size_t)n_threads;
  if (nrec < 4096) T = 1;
  std::vector<Partial> parts(T);
  if (T == 1) {
    decode_range(buf, offs.data(), 0, nrec, cfg, parts[0]);
  } else {
    std::vector<std::thread> pool;
    for (size_t t = 0; t < T; ++t) {
      size_t lo = nrec * t / T, hi = nrec * (t + 1) / T;
      pool.emplace_back([&, lo, hi, t]() {
        decode_range(buf, offs.data(), lo, hi, cfg, parts[t]);
      });
    }
    for (auto& th : pool) th.join();
  }

  // merge (chunk order == file order)
  for (auto& p : parts) R.paired_end |= p.paired_end;
  {
    int64_t row_base = 0;
    for (auto& p : parts) {
      for (size_t e = 0; e < p.ev_kind.size(); ++e) {
        R.diag_kind.push_back(p.ev_kind[e]);
        R.diag_row.push_back(row_base + p.ev_row[e]);
      }
      R.diag_names += p.ev_names;
      row_base += (int64_t)p.ref_id.size();
    }
  }
  std::vector<int32_t> hist;
  int n_hist = 0;
  for (auto& p : parts) {
    for (int32_t sl : p.seqlens) {
      if (n_hist >= cfg.max_read_num_4_rl) break;
      if ((size_t)sl >= hist.size()) hist.resize(sl + 1, 0);
      hist[sl]++;
      n_hist++;
    }
  }
  for (size_t l = 0; l < hist.size(); ++l) {
    if (hist[l]) {
      R.hist_len.push_back((int32_t)l);
      R.hist_count.push_back(hist[l]);
    }
  }
  {
    size_t total = 0;
    for (auto& p : parts) total += p.nfeat.size();
    R.feat_off.reserve(total + 1);
    R.feat_off.push_back(0);
    int64_t acc = 0;
    for (auto& p : parts)
      for (int64_t k : p.nfeat) {
        acc += k;
        R.feat_off.push_back(acc);
      }
  }
  concat(R.ref_id, parts, &Partial::ref_id);
  concat(R.left, parts, &Partial::left);
  concat(R.right, parts, &Partial::right);
  concat(R.strand, parts, &Partial::strand);
  concat(R.flag, parts, &Partial::flag);
  concat(R.mate_ref, parts, &Partial::mate_ref);
  concat(R.mate_pos, parts, &Partial::mate_pos);
  concat(R.nh, parts, &Partial::nh);
  concat(R.read_id, parts, &Partial::read_id);
  concat(R.cigar_hash, parts, &Partial::cigar_hash);
  concat(R.feat_code, parts, &Partial::feat_code);
  concat(R.feat_left, parts, &Partial::feat_left);
  concat(R.feat_len, parts, &Partial::feat_len);
  return true;
}

// ----------------------------------------------------------- streaming ----
// Prefix variant of bgzf_index: indexes only the complete BGZF blocks at the
// front of `data`, reporting how many input bytes they cover (`consumed`) so
// the caller can carry the trailing partial block into the next read chunk.
// Returns false on malformed data (bad gzip magic / missing BC subfield).
static bool bgzf_index_prefix(const uint8_t* data, size_t n,
                              std::vector<BlockRef>& blocks, size_t& consumed,
                              size_t& total_out) {
  size_t pos = 0;
  total_out = 0;
  while (pos + 18 <= n) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, data + pos + 10, 2);
    if (pos + 12 + (size_t)xlen > n) break;  // partial extra field
    size_t xpos = pos + 12, xend = xpos + xlen;
    uint32_t bsize = 0;
    while (xpos + 4 <= xend) {
      uint8_t si1 = data[xpos], si2 = data[xpos + 1];
      uint16_t slen;
      memcpy(&slen, data + xpos + 2, 2);
      if (si1 == 0x42 && si2 == 0x43 && slen >= 2) {
        uint16_t v;
        memcpy(&v, data + xpos + 4, 2);
        bsize = (uint32_t)v + 1;
      }
      xpos += 4 + slen;
    }
    if (bsize == 0) return false;
    if (pos + bsize > n) break;  // partial block payload
    uint32_t isize;
    memcpy(&isize, data + pos + bsize - 4, 4);
    if (isize > 0) {
      BlockRef b;
      b.comp_off = pos + 12 + xlen;
      b.comp_len = bsize - 12 - xlen - 8;
      b.isize = isize;
      b.out_off = total_out;
      blocks.push_back(b);
      total_out += isize;
    }
    pos += bsize;
  }
  consumed = pos;
  return true;
}

// One finalized per-chromosome SoA block of the stream.
struct SbamBlock {
  int32_t chrom = -1;
  // sub-chromosome splitting: the genomic position where this block's
  // range begins (0 = start of chromosome). Refs with padded right end
  // before the NEXT block's cut belong to this block.
  int64_t cut = 0;
  std::vector<int32_t> ref_id;
  std::vector<int64_t> left, right;
  std::vector<int8_t> strand;
  std::vector<uint16_t> flag;
  std::vector<int32_t> mate_ref;
  std::vector<int64_t> mate_pos;
  std::vector<int32_t> nh;
  std::vector<uint64_t> read_id, cigar_hash;
  std::vector<int64_t> feat_off;  // n+1
  std::vector<int8_t> feat_code;
  std::vector<int64_t> feat_left;
  std::vector<int32_t> feat_len;
};

// Recycler for SbamBlock storage. Block vectors are ~GB-scale per run and
// are allocated on the decode consumer thread but freed from the Python
// consumer thread; with per-thread glibc arenas every run cycles the same
// buffers through fresh 64MB heap mmaps (the kernel zero-fills each page on
// first touch — measured ~2s of extra sys time inside the merge on repeat
// runs). Dropped blocks park their vectors here (clear() keeps capacity)
// and the accumulator re-adopts a shell instead of growing from empty, so
// steady state does no large allocation at all. Low-mem runs bypass the
// pool: their contract is to actually return memory.
struct BlockPool {
  std::mutex mu;
  std::vector<SbamBlock> shells;
  int64_t bytes = 0;
  int64_t cap_bytes;
  BlockPool() {
    const char* e = getenv("STRAWB_BLOCK_POOL_MB");
    cap_bytes = (e ? atoll(e) : 4096) * (int64_t)(1 << 20);
  }
  static int64_t cap_of(const SbamBlock& b) {
    return (int64_t)(b.ref_id.capacity() * 63 + b.feat_off.capacity() * 8 +
                     b.feat_code.capacity() * 13);
  }
  void put(SbamBlock&& b) {
    int64_t sz = cap_of(b);
    b.chrom = -1;
    b.cut = 0;
    b.ref_id.clear();
    b.left.clear();
    b.right.clear();
    b.strand.clear();
    b.flag.clear();
    b.mate_ref.clear();
    b.mate_pos.clear();
    b.nh.clear();
    b.read_id.clear();
    b.cigar_hash.clear();
    b.feat_off.clear();
    b.feat_code.clear();
    b.feat_left.clear();
    b.feat_len.clear();
    std::lock_guard<std::mutex> g(mu);
    if (bytes + sz > cap_bytes) return;  // over cap: let it free
    bytes += sz;
    shells.push_back(std::move(b));
  }
  // Adopt the largest pooled shell into `out` (largest-first keeps the
  // biggest capacities in circulation so reserve() stays a no-op).
  bool get(SbamBlock& out) {
    std::lock_guard<std::mutex> g(mu);
    if (shells.empty()) return false;
    size_t best = 0;
    for (size_t i = 1; i < shells.size(); ++i)
      if (shells[i].ref_id.capacity() > shells[best].ref_id.capacity())
        best = i;
    bytes -= cap_of(shells[best]);
    out = std::move(shells[best]);
    shells.erase(shells.begin() + best);
    return true;
  }
};

BlockPool& block_pool() {
  static BlockPool p;
  return p;
}

}  // namespace

extern "C" {

struct StrawbSbam {
  Config cfg;
  std::string path;
  int n_threads = 1;

  std::mutex mu;
  std::condition_variable cv;
  // header
  std::string names_blob;
  std::vector<int32_t> ref_len;
  bool header_ready = false;
  // read-length histogram over the first max_read_num_4_rl accepted hits
  std::vector<int32_t> hist_len, hist_count;
  bool hist_ready = false;
  // blocks
  std::vector<std::unique_ptr<SbamBlock>> blocks;
  // opaque per-block caches (cluster.cc stores each block's GlobalPairs
  // so pass 2 reuses pass 1's mate pairing); freed with the block
  std::vector<std::pair<void*, void (*)(void*)>> block_aux;
  // low-memory mode: bytes retained in undropped blocks; the driver stalls
  // before finalizing a new block while over the cap (consumers drop
  // consumed blocks, releasing it). 0 = unbounded (default).
  int64_t max_retained = 0;
  // sub-chromosome block splitting (low-mem): finalize the accumulating
  // block once it holds >= split_target bytes AND the incoming record
  // starts a provably new cluster: left > (chromosome running max of
  // right/mate_pos) + split_pad, outside every padded annotation-gene
  // barrier. 0 = whole-chromosome blocks (default). This is the
  // O(locus)-bounded working set of the reference's seek/rewind
  // streaming (src/read.cpp:428-478, alignments.cpp:1736-1743) recast
  // for block-tensor decode: the retained window holds a bounded run of
  // cluster-safe blocks instead of one open cluster.
  int64_t split_target = 0;
  int64_t split_pad = 0;
  std::vector<std::vector<std::pair<int64_t, int64_t>>> split_barriers;
  int64_t retained = 0;
  int64_t n_live = 0;
  bool ended = false;
  int32_t paired = 0;
  int64_t total_hits = 0;
  // -v per-read diagnostic events, file order (read after EOF)
  std::vector<int8_t> diag_kind;
  std::vector<int64_t> diag_row;
  std::string diag_names;
  std::string error;

  std::thread driver;

  ~StrawbSbam() {
    if (driver.joinable()) driver.join();
    for (auto& a : block_aux)
      if (a.first && a.second) a.second(a.first);
    if (max_retained <= 0)  // park undropped block storage for the next run
      for (auto& b : blocks)
        if (b && !b->ref_id.empty()) block_pool().put(std::move(*b));
  }

  void drop_aux_locked(int64_t k) {  // caller holds mu
    if (k < (int64_t)block_aux.size() && block_aux[k].first) {
      block_aux[k].second(block_aux[k].first);
      block_aux[k] = {nullptr, nullptr};
    }
  }

  void fail(const std::string& msg) {
    std::lock_guard<std::mutex> g(mu);
    // first error wins: the consumer's end-of-stream truncation check must
    // not overwrite a more specific inflate/stream failure from stage 1
    if (error.empty()) error = msg;
    header_ready = hist_ready = ended = true;
    cv.notify_all();
  }

  void run();
};

namespace {

// Incremental driver state for the per-chromosome accumulation.
struct SbamAccum {
  StrawbSbam* S;
  // current chromosome under accumulation
  SbamBlock cur;
  std::vector<int32_t> hist;  // dense seqlen histogram (first 50k accepted)
  int64_t n_hist = 0;
  int64_t rows_total = 0;  // accepted rows accumulated (event row base)
  // sub-chromosome split state: running max of right / applicable mate
  // end over the current chromosome (cluster bounds can't extend past it)
  int64_t chrom_P = 0;
  bool hist_done = false;

  // A split between the previous activity (ending <= P) and the record
  // at `pos` needs a CUT position that cleanly separates the annotation:
  //   * a padded gene interval spanning the whole gap (start <= P AND
  //     end >= pos) could collect hits on BOTH sides -> veto (-1);
  //   * a fresh interval containing pos (start in (P, pos]) has all its
  //     hits at/after pos -> cut at its padded start, so the whole gene
  //     (and its gene-mates in the merged interval) assign to the next
  //     block;
  //   * otherwise cut exactly at pos.
  // Intervals are merged+sorted, so only the first with end >= pos
  // matters (earlier ones end inside the gap; they and their genes stay
  // in the finishing block).
  int64_t split_cut(int32_t c, int64_t P, int64_t pos) const {
    if ((size_t)c >= S->split_barriers.size()) return pos;
    const auto& v = S->split_barriers[c];
    auto it = std::lower_bound(
        v.begin(), v.end(), pos,
        [](const std::pair<int64_t, int64_t>& iv, int64_t p) {
          return iv.second < p;
        });
    if (it == v.end() || it->first > pos) return pos;
    // veto when the interval spans the gap OR starts within pad of the
    // previous activity: the dispatcher assigns refs by
    // `right + pad < cut`, so a cut at <= P + pad would push refs whose
    // hits ended at P into the NEXT block
    if (it->first <= P + S->split_pad) return -1;
    return it->first;
  }

  explicit SbamAccum(StrawbSbam* s) : S(s) {}

  void finalize_hist() {
    if (hist_done) return;
    hist_done = true;
    std::lock_guard<std::mutex> g(S->mu);
    for (size_t l = 0; l < hist.size(); ++l) {
      if (hist[l]) {
        S->hist_len.push_back((int32_t)l);
        S->hist_count.push_back(hist[l]);
      }
    }
    S->hist_ready = true;
    S->cv.notify_all();
  }

  static int64_t bytes_of(const SbamBlock& b) {
    return (int64_t)(b.ref_id.size() * 63 + b.feat_off.size() * 8 +
                     b.feat_code.size() * 13);
  }

  void finalize_block() {
    if (cur.ref_id.empty()) return;
    auto blk = std::make_unique<SbamBlock>();
    std::swap(*blk, cur);
    int64_t sz = bytes_of(*blk);
    std::unique_lock<std::mutex> g(S->mu);
    // low-mem backpressure: wait for consumers to drop earlier blocks.
    // Always admit 4 live blocks: the sub-chromosome dispatcher needs one
    // block of lookahead (ref assignment + linked-gene merge) before it
    // hands block k to a consumer, so a 2-block minimum could deadlock
    // (consumer waits on k+1, decoder waits on k's drop).
    if (S->max_retained > 0)
      S->cv.wait(g, [&] {
        return S->n_live < 4 || S->retained + sz <= S->max_retained;
      });
    S->retained += sz;
    S->n_live++;
    S->total_hits += (int64_t)blk->ref_id.size();
    S->blocks.push_back(std::move(blk));
    S->cv.notify_all();
  }

  // Append one window's decoded Partials in record (= file) order, splitting
  // at chromosome changes. BAM is position-sorted, so ref_id is
  // non-decreasing across the whole stream.
  void append(std::vector<Partial>& parts) {
    for (auto& p : parts) {
      S->paired |= p.paired_end;
      if (!p.ev_kind.empty()) {
        std::lock_guard<std::mutex> g(S->mu);
        for (size_t e = 0; e < p.ev_kind.size(); ++e) {
          S->diag_kind.push_back(p.ev_kind[e]);
          S->diag_row.push_back(rows_total + p.ev_row[e]);
        }
        S->diag_names += p.ev_names;
      }
      rows_total += (int64_t)p.ref_id.size();
      size_t n = p.ref_id.size();
      size_t i = 0, fcur = 0;
      while (i < n) {
        int32_t c = p.ref_id[i];
        size_t j = i;
        int64_t nf = 0;
        while (j < n && p.ref_id[j] == c) nf += p.nfeat[j], ++j;
        if (cur.chrom != c) {
          size_t ln = cur.ref_id.size(), lf = cur.feat_code.size();
          finalize_block();
          chrom_P = 0;
          if (S->max_retained <= 0) block_pool().get(cur);
          cur.chrom = c;
          cur.feat_off.assign(1, 0);
          if (ln) {  // expect the next chrom to be of similar size: one
            cur.ref_id.reserve(ln);       // up-front allocation instead of
            cur.left.reserve(ln);         // log2(n) doubling re-copies of
            cur.right.reserve(ln);        // the whole accumulation
            cur.strand.reserve(ln);
            cur.flag.reserve(ln);
            cur.mate_ref.reserve(ln);
            cur.mate_pos.reserve(ln);
            cur.nh.reserve(ln);
            cur.read_id.reserve(ln);
            cur.cigar_hash.reserve(ln);
            cur.feat_off.reserve(ln + 1);
            cur.feat_code.reserve(lf);
            cur.feat_left.reserve(lf);
            cur.feat_len.reserve(lf);
          }
        }
        auto app = [](auto& dst, const auto& src, size_t lo, size_t hi) {
          dst.insert(dst.end(), src.begin() + lo, src.begin() + hi);
        };
        auto append_slice = [&](size_t lo, size_t hi, size_t f0,
                                int64_t nfs) {
          app(cur.ref_id, p.ref_id, lo, hi);
          app(cur.left, p.left, lo, hi);
          app(cur.right, p.right, lo, hi);
          app(cur.strand, p.strand, lo, hi);
          app(cur.flag, p.flag, lo, hi);
          app(cur.mate_ref, p.mate_ref, lo, hi);
          app(cur.mate_pos, p.mate_pos, lo, hi);
          app(cur.nh, p.nh, lo, hi);
          app(cur.read_id, p.read_id, lo, hi);
          app(cur.cigar_hash, p.cigar_hash, lo, hi);
          int64_t base = cur.feat_off.back();
          for (size_t k = lo; k < hi; ++k) {
            base += p.nfeat[k];
            cur.feat_off.push_back(base);
          }
          app(cur.feat_code, p.feat_code, f0, f0 + (size_t)nfs);
          app(cur.feat_left, p.feat_left, f0, f0 + (size_t)nfs);
          app(cur.feat_len, p.feat_len, f0, f0 + (size_t)nfs);
        };
        if (S->split_target > 0) {
          // low-mem sub-chromosome splitting: cut on provably
          // cluster-safe boundaries once the block is big enough. A hit
          // at left > chrom_P + pad starts a new cluster in every mode
          // (hit_gt_cluster; denovo partner extension bounded by
          // chrom_P's mate term), and the padded annotation-gene
          // barriers keep reference clusters whole.
          size_t lo = i;
          size_t f0 = fcur;
          int64_t nfs = 0;
          int64_t bytes0 = (int64_t)cur.ref_id.size() * 63 +
                           (int64_t)cur.feat_code.size() * 13;
          for (size_t k = i; k < j; ++k) {
            int64_t cutv;
            if (bytes0 + (int64_t)(k - lo) * 63 + nfs * 13 >=
                    S->split_target &&
                (bytes0 > 0 || k > lo) &&  // never cut an empty block
                p.left[k] > chrom_P + S->split_pad &&
                (cutv = split_cut(c, chrom_P, p.left[k])) >= 0) {
              append_slice(lo, k, f0, nfs);
              f0 += (size_t)nfs;
              nfs = 0;
              lo = k;
              finalize_block();
              cur.chrom = c;
              cur.cut = cutv;
              cur.feat_off.assign(1, 0);
              bytes0 = 0;
            }
            int64_t r = p.right[k];
            if (p.mate_ref[k] == c &&
                p.mate_pos[k] - p.left[k] <
                    (int64_t)S->cfg.max_intron_length &&
                p.mate_pos[k] > r)
              r = p.mate_pos[k];  // denovo partner extension bound
            if (r > chrom_P) chrom_P = r;
            nfs += p.nfeat[k];
          }
          append_slice(lo, j, f0, nfs);
        } else {
          append_slice(i, j, fcur, nf);
        }
        fcur += (size_t)nf;
        i = j;
      }
      if (!hist_done) {
        for (int32_t sl : p.seqlens) {
          if (n_hist >= S->cfg.max_read_num_4_rl) break;
          if ((size_t)sl >= hist.size()) hist.resize(sl + 1, 0);
          hist[sl]++;
          n_hist++;
        }
        if (n_hist >= S->cfg.max_read_num_4_rl) finalize_hist();
      }
    }
  }
};

// Parse the BAM header from `buf[0:n)`. Returns 1 and sets `pos` past the
// header on success, 0 if more bytes are needed, -1 on bad magic.
static int try_parse_header(const uint8_t* buf, size_t n, size_t& pos,
                            std::string& names_blob,
                            std::vector<int32_t>& ref_len) {
  if (n < 4) return 0;
  if (memcmp(buf, "BAM\1", 4) != 0) return -1;
  size_t p = 4;
  if (p + 4 > n) return 0;
  int32_t l_text = rd_i32(buf + p);
  p += 4 + (size_t)l_text;
  if (p + 4 > n) return 0;
  int32_t n_ref = rd_i32(buf + p);
  p += 4;
  std::string names;
  std::vector<int32_t> lens;
  for (int32_t i = 0; i < n_ref; ++i) {
    if (p + 4 > n) return 0;
    int32_t l_name = rd_i32(buf + p);
    p += 4;
    if (p + (size_t)l_name + 4 > n) return 0;
    names.append((const char*)(buf + p), l_name - 1);
    names.push_back('\n');
    p += l_name;
    lens.push_back(rd_i32(buf + p));
    p += 4;
  }
  pos = p;
  names_blob = std::move(names);
  ref_len = std::move(lens);
  return 1;
}

}  // namespace

// Background decode pipeline: read compressed chunks -> index complete BGZF
// blocks -> inflate them in parallel -> boundary-scan records -> parse in
// parallel -> append per-chromosome (finalizing blocks as chromosomes
// complete). Peak memory is O(window + retained blocks); the windowed read
// replaces strawb_bam_load's whole-file slurp (ref streams one record at a
// time via samread, src/read.cpp:459).
void StrawbSbam::run() {
  // Two-stage decode pipeline (this thread = stage 1, one consumer thread
  // = stage 2), replacing the reference's single samread loop
  // (src/read.cpp:459) with window-granular overlap:
  //   stage 1: fread -> BGZF block index -> parallel inflate -> queue
  //   stage 2: record boundary scan -> parallel record parse -> per-
  //            chromosome accumulation (SbamAccum)
  // so window k's record work runs while window k+1 inflates. The bounded
  // queue (2 windows) caps memory; low-mem backpressure inside
  // finalize_block stalls stage 2, which fills the queue and stalls
  // stage 1.
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    fail("cannot open BAM");
    return;
  }

  struct Win {
    std::unique_ptr<uint8_t[]> buf;
    size_t n = 0;
  };
  std::mutex qmu;
  std::condition_variable qcv;
  std::deque<Win> q;
  bool q_done = false;
  std::atomic<int> q_fail{0};  // stage-2 failure: stage 1 stops reading
  const size_t QDEPTH = 2;

  std::thread consumer([&]() {
    SbamAccum acc(this);
    std::vector<uint8_t> carry;  // partial trailing record bytes
    std::vector<uint8_t> hdr;    // header accumulation until parsed
    bool header_done = false;
    bool failed = false;
    std::vector<size_t> offs;
    size_t T = n_threads < 1 ? 1 : (size_t)n_threads;
    std::vector<Partial> parts;
    std::vector<Partial> carry_part(1);

    // scan+parse+merge one contiguous chunk of record bytes; the record
    // spanning the previous chunk's tail is completed from `carry` and
    // parsed first so the accumulation (and the first-50k read-length
    // histogram) stays in exact file order
    auto process = [&](const uint8_t* buf, size_t n) {
      size_t pos = 0;
      if (!carry.empty()) {
        while (carry.size() < 4 && pos < n) carry.push_back(buf[pos++]);
        if (carry.size() < 4) return;
        size_t need = 4 + (size_t)rd_i32(carry.data());
        size_t take = need > carry.size() ? need - carry.size() : 0;
        if (take > n - pos) take = n - pos;
        carry.insert(carry.end(), buf + pos, buf + pos + take);
        pos += take;
        if (carry.size() < need) return;  // consumed the whole chunk
        size_t off0 = 0;
        carry_part[0].clear();
        decode_range(carry.data(), &off0, 0, 1, cfg, carry_part[0]);
        acc.append(carry_part);
        carry.clear();
      }
      offs.clear();
      size_t p = pos;
      while (p + 4 <= n) {
        int32_t bs = rd_i32(buf + p);
        if (p + 4 + (size_t)bs > n) break;
        offs.push_back(p);
        p += 4 + (size_t)bs;
      }
      size_t nrec = offs.size();
      if (nrec) {
        size_t TT = nrec < 4096 ? 1 : T;
        if (parts.size() < TT) parts.resize(TT);
        // clear every partial, not only the TT this window decodes into:
        // append() takes them all, and a short window after a threaded one
        // would otherwise append the earlier window's parts[1..) again
        for (auto& pt : parts) pt.clear();
        if (TT == 1) {
          strawb_perf::Scope _pp(strawb_perf::kBamParse);
          decode_range(buf, offs.data(), 0, nrec, cfg, parts[0]);
        } else {
          std::vector<std::thread> pool;
          for (size_t t = 1; t < TT; ++t) {
            size_t lo = nrec * t / TT, hi = nrec * (t + 1) / TT;
            pool.emplace_back([&, lo, hi, t]() {
              strawb_perf::Scope _pp(strawb_perf::kBamParse);
              decode_range(buf, offs.data(), lo, hi, cfg, parts[t]);
            });
          }
          {
            strawb_perf::Scope _pp(strawb_perf::kBamParse);
            decode_range(buf, offs.data(), 0, nrec / TT, cfg, parts[0]);
          }
          for (auto& th : pool) th.join();
        }
        {
          strawb_perf::Scope _pm(strawb_perf::kBamMerge);
          acc.append(parts);
        }
      }
      carry.assign(buf + p, buf + n);
    };

    while (true) {
      Win w;
      {
        std::unique_lock<std::mutex> g(qmu);
        qcv.wait(g, [&] { return !q.empty() || q_done; });
        if (q.empty()) break;
        w = std::move(q.front());
        q.pop_front();
        qcv.notify_all();
      }
      if (failed) continue;  // drain remaining windows
      const uint8_t* rbuf = w.buf.get();
      size_t rn = w.n;
      if (!header_done) {
        hdr.insert(hdr.end(), rbuf, rbuf + rn);
        size_t hpos = 0;
        int rc = try_parse_header(hdr.data(), hdr.size(), hpos, names_blob,
                                  ref_len);
        if (rc < 0) {
          fail("not a BAM file");
          q_fail = 1;
          failed = true;
          continue;
        }
        if (rc == 0) continue;  // need more bytes
        header_done = true;
        {
          std::lock_guard<std::mutex> g(mu);
          header_ready = true;
          cv.notify_all();
        }
        process(hdr.data() + hpos, hdr.size() - hpos);
        std::vector<uint8_t>().swap(hdr);
        continue;
      }
      process(rbuf, rn);
    }
    if (failed) return;
    if (!header_done) {
      fail(hdr.empty() && carry.empty() ? "empty BAM"
                                        : "truncated BAM header");
      return;
    }
    if (!carry.empty()) {
      fail("truncated BAM record");
      return;
    }
    acc.finalize_block();
    acc.finalize_hist();
    std::lock_guard<std::mutex> g(mu);
    ended = true;
    cv.notify_all();
  });

  // ---- stage 1: read -> index -> inflate -> queue -----------------------
  // compressed bytes per read: the first chunk is small so the header (and
  // with it strawb_sbam_error/ref_names, which the Python open blocks on)
  // is ready after a few ms instead of after a full 4MB window's inflate
  size_t CHUNK = 256u << 10;
  const size_t CHUNK_STEADY = 4u << 20;
  std::vector<uint8_t> comp;  // unconsumed compressed carry + new bytes
  bool eof = false;
  bool s1_failed = false;
  while (!q_fail.load(std::memory_order_relaxed)) {
    if (!eof) {
      size_t old = comp.size();
      comp.resize(old + CHUNK);
      size_t got = fread(comp.data() + old, 1, CHUNK, f);
      comp.resize(old + got);
      if (got < CHUNK) eof = true;
      CHUNK = CHUNK_STEADY;
    }
    if (comp.empty()) break;

    std::vector<BlockRef> blocks;
    size_t consumed = 0, total_out = 0;
    bool idx_ok = bgzf_index_prefix(comp.data(), comp.size(), blocks,
                                    consumed, total_out);
    if (!idx_ok) {
      fail("malformed BGZF stream");
      s1_failed = true;
      break;
    }
    if (blocks.empty()) {
      if (eof) {
        if (consumed < comp.size() && comp.size() - consumed > 28) {
          fail("truncated BGZF stream");
          s1_failed = true;
        }
        break;
      }
      continue;  // need more bytes for even one block
    }

    Win w;
    w.n = total_out;
    w.buf.reset(new uint8_t[total_out]);
    {
      std::atomic<int> ok{1};
      size_t nb = blocks.size();
      size_t T = n_threads < 1 ? 1 : (size_t)n_threads;
      size_t TT = T < nb ? T : nb;
      auto infl = [&](size_t t0) {
        strawb_perf::Scope _pi(strawb_perf::kInflate);
#ifdef STRAWB_HAVE_LIBDEFLATE
        libdeflate_decompressor* d = libdeflate_alloc_decompressor();
#endif
        for (size_t i = t0; i < nb; i += TT) {
          const BlockRef& b = blocks[i];
#ifdef STRAWB_HAVE_LIBDEFLATE
          size_t actual = 0;
          if (libdeflate_deflate_decompress(
                  d, comp.data() + b.comp_off, b.comp_len,
                  w.buf.get() + b.out_off, b.isize,
                  &actual) != LIBDEFLATE_SUCCESS ||
              actual != b.isize)
            ok = 0;
#else
          if (!inflate_block(comp.data() + b.comp_off, b.comp_len,
                             w.buf.get() + b.out_off, b.isize))
            ok = 0;
#endif
        }
#ifdef STRAWB_HAVE_LIBDEFLATE
        libdeflate_free_decompressor(d);
#endif
      };
      std::vector<std::thread> pool;
      for (size_t t = 1; t < TT; ++t) pool.emplace_back(infl, t);
      infl(0);
      for (auto& th : pool) th.join();
      if (!ok) {
        fail("BGZF inflate failed");
        s1_failed = true;
      }
    }
    if (s1_failed) break;
    comp.erase(comp.begin(), comp.begin() + consumed);

    {
      std::unique_lock<std::mutex> g(qmu);
      qcv.wait(g, [&] {
        return q.size() < QDEPTH || q_fail.load(std::memory_order_relaxed);
      });
      q.push_back(std::move(w));
      qcv.notify_all();
    }
    if (eof && comp.empty()) break;
  }
  fclose(f);
  {
    std::lock_guard<std::mutex> g(qmu);
    q_done = true;
    qcv.notify_all();
  }
  consumer.join();
}

StrawbSbam* strawb_sbam_open(const char* path, int32_t max_intron,
                             int32_t min_intron, int32_t unique_only,
                             int32_t fr, int32_t rf, int32_t max_hist,
                             int32_t min_mapq, int32_t n_threads) {
  auto* S = new StrawbSbam();
  S->path = path;
  S->cfg.max_intron_length = max_intron;
  S->cfg.min_intron_length = min_intron;
  S->cfg.use_only_unique_hits = unique_only;
  S->cfg.fr_strand = fr;
  S->cfg.rf_strand = rf;
  S->cfg.max_read_num_4_rl = max_hist;
  S->cfg.min_map_qual = min_mapq;
  S->cfg.verbose = env_verbose();
  S->n_threads = n_threads;
  // synchronous header pre-parse: callers can consult the reference
  // table (and configure sub-chromosome splitting from annotation spans)
  // BEFORE any record decoding starts (strawb_sbam_start)
  {
    FILE* f = fopen(path, "rb");
    if (!f) {
      S->fail("cannot open BAM");
      return S;
    }
    std::vector<uint8_t> comp, hb;
    size_t comp_done = 0;  // compressed bytes already indexed+inflated
    bool eof = false;
    while (true) {
      size_t old = comp.size();
      comp.resize(old + (256u << 10));
      size_t got = fread(comp.data() + old, 1, 256u << 10, f);
      comp.resize(old + got);
      if (got < (256u << 10)) eof = true;
      // incremental: index+inflate only the not-yet-consumed tail (a
      // multi-MB header — e.g. 100k @SQ contigs — stays one pass)
      std::vector<BlockRef> blocks;
      size_t consumed = 0, total_out = 0;
      if (!bgzf_index_prefix(comp.data() + comp_done,
                             comp.size() - comp_done, blocks, consumed,
                             total_out)) {
        S->fail("malformed BGZF stream");
        break;
      }
      size_t hb0 = hb.size();
      hb.resize(hb0 + total_out);
      bool iok = true;
      for (const BlockRef& b : blocks)
        if (!inflate_block(comp.data() + comp_done + b.comp_off,
                           b.comp_len, hb.data() + hb0 + b.out_off,
                           b.isize))
          iok = false;
      if (!iok) {
        S->fail("BGZF inflate failed");
        break;
      }
      comp_done += consumed;
      size_t hpos = 0;
      int rc = try_parse_header(hb.data(), hb.size(), hpos, S->names_blob,
                                S->ref_len);
      if (rc < 0) {
        S->fail("not a BAM file");
        break;
      }
      if (rc == 1) {
        std::lock_guard<std::mutex> g(S->mu);
        S->header_ready = true;
        break;
      }
      if (eof) {
        S->fail(hb.empty() ? "empty BAM" : "truncated BAM header");
        break;
      }
    }
    fclose(f);
  }
  return S;
}

// start the background decode (separate from open so split barriers can
// be configured in between)
void strawb_sbam_start(StrawbSbam* S) {
  if (!S->driver.joinable() && S->error.empty())
    S->driver = std::thread([S]() { S->run(); });
}

// low-memory sub-chromosome splitting: finalize blocks at >= target bytes
// on provably cluster-safe boundaries. pad = kMaxOlapDist; the barriers
// are padded merged annotation-gene intervals per chromosome (a split
// inside one could attach an annotation cluster's hits to two blocks).
void strawb_sbam_set_split(StrawbSbam* S, int64_t target_bytes, int64_t pad,
                           int64_t n, const int32_t* bchrom,
                           const int64_t* bleft, const int64_t* bright) {
  S->split_target = target_bytes;
  S->split_pad = pad;
  S->split_barriers.assign(S->ref_len.size(), {});
  for (int64_t i = 0; i < n; ++i)
    if (bchrom[i] >= 0 && (size_t)bchrom[i] < S->split_barriers.size())
      S->split_barriers[bchrom[i]].emplace_back(bleft[i], bright[i]);
}

int32_t strawb_sbam_split_enabled(StrawbSbam* S) {
  return S->split_target > 0 ? 1 : 0;
}

int64_t strawb_sbam_split_pad(StrawbSbam* S) { return S->split_pad; }

// ---- -v per-read diagnostics (valid after the stream ends) ----
int64_t strawb_sbam_diag_n(StrawbSbam* S) {
  std::lock_guard<std::mutex> g(S->mu);
  return (int64_t)S->diag_kind.size();
}
const int8_t* strawb_sbam_diag_kinds(StrawbSbam* S) {
  return S->diag_kind.data();
}
const int64_t* strawb_sbam_diag_rows(StrawbSbam* S) {
  return S->diag_row.data();
}
const char* strawb_sbam_diag_names(StrawbSbam* S) {
  return S->diag_names.c_str();
}

void strawb_sbam_free(StrawbSbam* S) { delete S; }

// opaque per-block cache slots (used by cluster.cc to persist each
// block's GlobalPairs from pass 1 to pass 2)
void* strawb_sbam_block_aux(StrawbSbam* S, int64_t k) {
  std::lock_guard<std::mutex> g(S->mu);
  if (k >= (int64_t)S->block_aux.size()) return nullptr;
  return S->block_aux[k].first;
}

void strawb_sbam_block_set_aux(StrawbSbam* S, int64_t k, void* p,
                               void (*free_fn)(void*)) {
  std::lock_guard<std::mutex> g(S->mu);
  if (k >= (int64_t)S->block_aux.size())
    S->block_aux.resize(k + 1, {nullptr, nullptr});
  S->drop_aux_locked(k);
  S->block_aux[k] = {p, free_fn};
}

const char* strawb_sbam_error(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->header_ready || S->ended; });
  return S->error.empty() ? nullptr : S->error.c_str();
}

int32_t strawb_sbam_num_refs(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->header_ready || S->ended; });
  return (int32_t)S->ref_len.size();
}
const char* strawb_sbam_ref_names(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->header_ready || S->ended; });
  return S->names_blob.c_str();
}
const int32_t* strawb_sbam_ref_lens(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->header_ready || S->ended; });
  return S->ref_len.data();
}

int32_t strawb_sbam_hist_size(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->hist_ready || S->ended; });
  return (int32_t)S->hist_len.size();
}
const int32_t* strawb_sbam_hist_len(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->hist_ready || S->ended; });
  return S->hist_len.data();
}
const int32_t* strawb_sbam_hist_count(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->hist_ready || S->ended; });
  return S->hist_count.data();
}

int64_t strawb_sbam_num_hits(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->ended; });
  return S->total_hits;
}
int32_t strawb_sbam_paired(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->ended; });
  return S->paired;
}
int64_t strawb_sbam_num_blocks(StrawbSbam* S) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return S->ended; });
  return (int64_t)S->blocks.size();
}

int32_t strawb_sbam_wait_block(StrawbSbam* S, int64_t k) {
  std::unique_lock<std::mutex> g(S->mu);
  S->cv.wait(g, [&] { return (int64_t)S->blocks.size() > k || S->ended; });
  if (!S->error.empty()) return -1;
  return (int64_t)S->blocks.size() > k ? 1 : 0;
}

static SbamBlock* sblk(StrawbSbam* S, int64_t k) {
  std::lock_guard<std::mutex> g(S->mu);
  return S->blocks[k].get();
}

int64_t strawb_sbam_block_cut(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->cut;
}

int32_t strawb_sbam_block_chrom(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->chrom;
}
int64_t strawb_sbam_block_n(StrawbSbam* S, int64_t k) {
  return (int64_t)sblk(S, k)->ref_id.size();
}
int64_t strawb_sbam_block_nfeat(StrawbSbam* S, int64_t k) {
  return (int64_t)sblk(S, k)->feat_code.size();
}
const int32_t* strawb_sbam_block_ref_id(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->ref_id.data();
}
const int64_t* strawb_sbam_block_left(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->left.data();
}
const int64_t* strawb_sbam_block_right(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->right.data();
}
const int8_t* strawb_sbam_block_strand(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->strand.data();
}
const uint16_t* strawb_sbam_block_flag(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->flag.data();
}
const int32_t* strawb_sbam_block_mate_ref(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->mate_ref.data();
}
const int64_t* strawb_sbam_block_mate_pos(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->mate_pos.data();
}
const int32_t* strawb_sbam_block_nh(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->nh.data();
}
const uint64_t* strawb_sbam_block_read_id(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->read_id.data();
}
const uint64_t* strawb_sbam_block_cigar_hash(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->cigar_hash.data();
}
const int64_t* strawb_sbam_block_feat_off(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->feat_off.data();
}
const int8_t* strawb_sbam_block_feat_code(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->feat_code.data();
}
const int64_t* strawb_sbam_block_feat_left(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->feat_left.data();
}
const int32_t* strawb_sbam_block_feat_len(StrawbSbam* S, int64_t k) {
  return sblk(S, k)->feat_len.data();
}

void strawb_sbam_drop_block(StrawbSbam* S, int64_t k) {
  std::lock_guard<std::mutex> g(S->mu);
  S->drop_aux_locked(k);
  if (k < (int64_t)S->blocks.size() && S->blocks[k] &&
      !S->blocks[k]->ref_id.empty()) {
    S->retained -= SbamAccum::bytes_of(*S->blocks[k]);
    S->n_live--;
    if (S->max_retained <= 0)
      block_pool().put(std::move(*S->blocks[k]));  // recycle the storage
    *S->blocks[k] = SbamBlock();
    S->cv.notify_all();
  }
}

void strawb_sbam_set_max_retained(StrawbSbam* S, int64_t bytes) {
  std::lock_guard<std::mutex> g(S->mu);
  S->max_retained = bytes;
  S->cv.notify_all();
}

struct StrawbBam {
  Result r;
};

// Decode a whole BAM file. Returns handle (nullptr on error).
StrawbBam* strawb_bam_load(const char* path, int32_t max_intron,
                           int32_t min_intron, int32_t unique_only,
                           int32_t fr, int32_t rf, int32_t max_hist,
                           int32_t min_mapq, int32_t n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(sz);
  if (fread(raw.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* h = new StrawbBam();
  std::vector<uint8_t> buf;
  if (!bgzf_inflate_all(raw.data(), raw.size(), buf, n_threads)) {
    h->r.error = "BGZF inflate failed";
    return h;
  }
  Config cfg;
  cfg.max_intron_length = max_intron;
  cfg.min_intron_length = min_intron;
  cfg.use_only_unique_hits = unique_only;
  cfg.fr_strand = fr;
  cfg.rf_strand = rf;
  cfg.max_read_num_4_rl = max_hist;
  cfg.min_map_qual = min_mapq;
  cfg.verbose = env_verbose();
  decode_records(buf.data(), buf.size(), cfg, h->r, n_threads);
  return h;
}

const char* strawb_bam_error(StrawbBam* h) {
  return h->r.error.empty() ? nullptr : h->r.error.c_str();
}

int64_t strawb_bam_num_hits(StrawbBam* h) { return (int64_t)h->r.ref_id.size(); }
int64_t strawb_bam_num_feats(StrawbBam* h) { return (int64_t)h->r.feat_code.size(); }
int32_t strawb_bam_paired(StrawbBam* h) { return h->r.paired_end; }
int64_t strawb_bam_diag_n(StrawbBam* h) {
  return (int64_t)h->r.diag_kind.size();
}
const int8_t* strawb_bam_diag_kinds(StrawbBam* h) {
  return h->r.diag_kind.data();
}
const int64_t* strawb_bam_diag_rows(StrawbBam* h) {
  return h->r.diag_row.data();
}
const char* strawb_bam_diag_names(StrawbBam* h) {
  return h->r.diag_names.c_str();
}
int32_t strawb_bam_num_refs(StrawbBam* h) { return (int32_t)h->r.ref_len.size(); }
const char* strawb_bam_ref_names(StrawbBam* h) { return h->r.names_blob.c_str(); }
const int32_t* strawb_bam_ref_lens(StrawbBam* h) { return h->r.ref_len.data(); }
int32_t strawb_bam_hist_size(StrawbBam* h) { return (int32_t)h->r.hist_len.size(); }
const int32_t* strawb_bam_hist_len(StrawbBam* h) { return h->r.hist_len.data(); }
const int32_t* strawb_bam_hist_count(StrawbBam* h) { return h->r.hist_count.data(); }

const int32_t* strawb_bam_ref_id(StrawbBam* h) { return h->r.ref_id.data(); }
const int64_t* strawb_bam_left(StrawbBam* h) { return h->r.left.data(); }
const int64_t* strawb_bam_right(StrawbBam* h) { return h->r.right.data(); }
const int8_t* strawb_bam_strand(StrawbBam* h) { return h->r.strand.data(); }
const uint16_t* strawb_bam_flag(StrawbBam* h) { return h->r.flag.data(); }
const int32_t* strawb_bam_mate_ref(StrawbBam* h) { return h->r.mate_ref.data(); }
const int64_t* strawb_bam_mate_pos(StrawbBam* h) { return h->r.mate_pos.data(); }
const int32_t* strawb_bam_nh(StrawbBam* h) { return h->r.nh.data(); }
const uint64_t* strawb_bam_read_id(StrawbBam* h) { return h->r.read_id.data(); }
const uint64_t* strawb_bam_cigar_hash(StrawbBam* h) { return h->r.cigar_hash.data(); }
const int64_t* strawb_bam_feat_off(StrawbBam* h) { return h->r.feat_off.data(); }
const int8_t* strawb_bam_feat_code(StrawbBam* h) { return h->r.feat_code.data(); }
const int64_t* strawb_bam_feat_left(StrawbBam* h) { return h->r.feat_left.data(); }
const int32_t* strawb_bam_feat_len(StrawbBam* h) { return h->r.feat_len.data(); }

void strawb_bam_free(StrawbBam* h) { delete h; }

// ------------------------------------------------------ ranged ingest ----
// Distributed per-process BAM span decode (SURVEY §2 "per-host BAM range
// reading"; ref design: bgzf_seek virtual offsets, src/read.cpp:428-478).
// Each process indexes the BGZF blocks (compressed-byte scan, no inflate),
// inflates ONLY its ~1/N compressed-byte span (plus the tiny header prefix
// and an on-demand overlap for the record straddling its end), and parses
// records whose start offset falls inside its span. Record boundaries are
// not self-synchronizing in BAM, so the exact start offset of span p+1 is
// produced by span p's cheap record-length skip-scan and relayed through
// one collective round per process (parallel/distributed.py).
struct StrawbSpan {
  Config cfg;
  std::string path;
  std::vector<uint8_t> raw;        // whole compressed file (index + slices)
  std::vector<BlockRef> blocks;    // all blocks, comp_off into raw
  std::vector<uint64_t> ucum;      // nb+1 global uncompressed offsets
  size_t b0 = 0, b1 = 0;           // owned block range [b0, b1)
  size_t binf1 = 0;                // inflated through block binf1 (>= b1)
  std::vector<uint8_t> buf;        // inflated bytes of [b0, binf1)
  uint64_t base = 0;               // ucum[b0]
  int64_t comp_bytes = 0;          // compressed bytes this process inflated
  std::string names_blob;
  std::vector<int32_t> ref_len;
  uint64_t header_end = 0;         // global offset of the first record
  uint64_t end_off = 0;            // result of strawb_span_end
  std::vector<size_t> scan_offs;   // record starts found by span_end
  uint64_t scan_start = ~0ull;     // the start that scan_offs covers
  Result R;
  std::vector<int32_t> seq_lens;   // ordered accepted seq lens (capped)
  std::string error;
  int n_threads = 2;

  bool extend_to(size_t bnew) {    // inflate further blocks on demand
    if (bnew > blocks.size()) bnew = blocks.size();
    if (bnew <= binf1) return true;
    size_t old = buf.size();
    buf.resize(old + (size_t)(ucum[bnew] - ucum[binf1]));
    for (size_t i = binf1; i < bnew; ++i) {
      const BlockRef& b = blocks[i];
      uint8_t* dst = buf.data() + (size_t)(ucum[i] - base);
#ifdef STRAWB_HAVE_LIBDEFLATE
      libdeflate_decompressor* d = libdeflate_alloc_decompressor();
      size_t actual = 0;
      bool ok = libdeflate_deflate_decompress(
                    d, raw.data() + b.comp_off, b.comp_len, dst, b.isize,
                    &actual) == LIBDEFLATE_SUCCESS && actual == b.isize;
      libdeflate_free_decompressor(d);
#else
      bool ok = inflate_block(raw.data() + b.comp_off, b.comp_len, dst,
                              b.isize);
#endif
      if (!ok) {
        error = "BGZF inflate failed";
        return false;
      }
      comp_bytes += (int64_t)b.comp_len;
    }
    binf1 = bnew;
    return true;
  }
};

StrawbSpan* strawb_span_open(const char* path, int32_t pid, int32_t nproc,
                             int32_t max_intron, int32_t min_intron,
                             int32_t unique_only, int32_t fr, int32_t rf,
                             int32_t max_hist, int32_t min_mapq,
                             int32_t n_threads) {
  auto* S = new StrawbSpan();
  S->path = path;
  S->cfg.max_intron_length = max_intron;
  S->cfg.min_intron_length = min_intron;
  S->cfg.use_only_unique_hits = unique_only;
  S->cfg.fr_strand = fr;
  S->cfg.rf_strand = rf;
  S->cfg.max_read_num_4_rl = max_hist;
  S->cfg.min_map_qual = min_mapq;
  S->n_threads = n_threads < 1 ? 1 : n_threads;
  FILE* f = fopen(path, "rb");
  if (!f) {
    S->error = "cannot open BAM";
    return S;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  S->raw.resize(sz);
  if (fread(S->raw.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    S->error = "short read";
    return S;
  }
  fclose(f);
  size_t consumed = 0, total_out = 0;
  if (!bgzf_index_prefix(S->raw.data(), S->raw.size(), S->blocks, consumed,
                         total_out) ||
      (S->raw.size() - consumed > 28)) {
    S->error = "malformed BGZF stream";
    return S;
  }
  size_t nb = S->blocks.size();
  S->ucum.resize(nb + 1);
  for (size_t i = 0; i < nb; ++i) S->ucum[i] = S->blocks[i].out_off;
  S->ucum[nb] = total_out;

  // header: inflate leading blocks until the header parses (tiny; not
  // counted toward the span's ~1/N share)
  {
    std::vector<uint8_t> hb;
    size_t k = 0;
    size_t need = 12;
    while (true) {
      while (k < nb && hb.size() < need) {
        const BlockRef& b = S->blocks[k];
        size_t old = hb.size();
        hb.resize(old + b.isize);
#ifdef STRAWB_HAVE_LIBDEFLATE
        libdeflate_decompressor* d = libdeflate_alloc_decompressor();
        size_t actual = 0;
        bool ok = libdeflate_deflate_decompress(
                      d, S->raw.data() + b.comp_off, b.comp_len,
                      hb.data() + old, b.isize,
                      &actual) == LIBDEFLATE_SUCCESS && actual == b.isize;
        libdeflate_free_decompressor(d);
#else
        bool ok = inflate_block(S->raw.data() + b.comp_off, b.comp_len,
                                hb.data() + old, b.isize);
#endif
        if (!ok) {
          S->error = "BGZF inflate failed";
          return S;
        }
        ++k;
      }
      if (hb.size() < need) {
        S->error = "truncated BAM header";
        return S;
      }
      if (memcmp(hb.data(), "BAM\1", 4) != 0) {
        S->error = "not a BAM file";
        return S;
      }
      size_t pos = 4;
      int32_t l_text = rd_i32(hb.data() + pos);
      if (hb.size() < 8 + (size_t)l_text + 4) {
        need = 8 + (size_t)l_text + 4;
        continue;
      }
      pos += 4 + l_text;
      int32_t n_ref = rd_i32(hb.data() + pos);
      pos += 4;
      bool complete = true;
      S->names_blob.clear();
      S->ref_len.clear();
      for (int32_t i = 0; i < n_ref; ++i) {
        if (pos + 4 > hb.size()) { complete = false; break; }
        int32_t l_name = rd_i32(hb.data() + pos);
        pos += 4;
        if (pos + (size_t)l_name + 4 > hb.size()) { complete = false; break; }
        S->names_blob.append((const char*)(hb.data() + pos), l_name - 1);
        S->names_blob.push_back('\n');
        pos += l_name;
        S->ref_len.push_back(rd_i32(hb.data() + pos));
        pos += 4;
      }
      if (!complete) {
        need = hb.size() + (64u << 10);
        continue;
      }
      S->header_end = (uint64_t)pos;
      break;
    }
  }

  // span split: balance by compressed bytes, identical on every process
  std::vector<uint64_t> ccum(nb + 1, 0);
  for (size_t i = 0; i < nb; ++i)
    ccum[i + 1] = ccum[i] + (S->blocks[i].comp_len + 30);
  uint64_t total_c = ccum[nb];
  auto cut = [&](int32_t p) -> size_t {
    uint64_t want = total_c * (uint64_t)p / (uint64_t)nproc;
    return (size_t)(std::lower_bound(ccum.begin(), ccum.end(), want)
                    - ccum.begin());
  };
  S->b0 = pid <= 0 ? 0 : cut(pid);
  S->b1 = pid >= nproc - 1 ? nb : cut(pid + 1);
  if (S->b1 < S->b0) S->b1 = S->b0;
  S->base = S->ucum[S->b0];
  S->binf1 = S->b0;

  // inflate the owned span in parallel
  {
    S->buf.resize((size_t)(S->ucum[S->b1] - S->base));
    std::atomic<int> ok{1};
    size_t T = (size_t)S->n_threads;
    size_t span_nb = S->b1 - S->b0;
    if (T > span_nb) T = span_nb ? span_nb : 1;
    auto infl = [&](size_t t0) {
#ifdef STRAWB_HAVE_LIBDEFLATE
      libdeflate_decompressor* d = libdeflate_alloc_decompressor();
#endif
      for (size_t i = S->b0 + t0; i < S->b1; i += T) {
        const BlockRef& b = S->blocks[i];
        uint8_t* dst = S->buf.data() + (size_t)(S->ucum[i] - S->base);
#ifdef STRAWB_HAVE_LIBDEFLATE
        size_t actual = 0;
        if (libdeflate_deflate_decompress(
                d, S->raw.data() + b.comp_off, b.comp_len, dst, b.isize,
                &actual) != LIBDEFLATE_SUCCESS || actual != b.isize)
          ok = 0;
#else
        if (!inflate_block(S->raw.data() + b.comp_off, b.comp_len, dst,
                           b.isize))
          ok = 0;
#endif
      }
#ifdef STRAWB_HAVE_LIBDEFLATE
      libdeflate_free_decompressor(d);
#endif
    };
    std::vector<std::thread> pool;
    for (size_t t = 1; t < T; ++t) pool.emplace_back(infl, t);
    if (span_nb) infl(0);
    for (auto& th : pool) th.join();
    if (!ok) {
      S->error = "BGZF inflate failed";
      return S;
    }
    S->binf1 = S->b1;
    S->comp_bytes += (int64_t)(ccum[S->b1] - ccum[S->b0]);
  }
  return S;
}

// Skip complete records from `start` (global uncompressed offset, from the
// previous span's relay; process 0 passes its header_end) and return the
// global offset of the first record starting at or beyond this span's
// owned end — the next span's start. Extends the inflated overlap on
// demand for records straddling the boundary.
int64_t strawb_span_end(StrawbSpan* S, int64_t start) {
  uint64_t owned_end = S->ucum[S->b1];
  uint64_t total = S->ucum.back();
  uint64_t pos = (uint64_t)start;
  // the scan doubles as span_parse's record index (the offsets are
  // exactly the records this span parses), so parse skips its own pass
  S->scan_offs.clear();
  if (owned_end > pos)
    S->scan_offs.reserve((size_t)((owned_end - pos) / 64));
  S->scan_start = pos;
  while (pos < owned_end) {
    if (pos + 4 > total) {
      S->error = "truncated BAM record";
      return -1;
    }
    while (pos + 4 > S->base + S->buf.size())
      if (!S->extend_to(S->binf1 + 4)) return -1;
    int32_t bs = rd_i32(S->buf.data() + (size_t)(pos - S->base));
    if (bs < 32) {
      S->error = "malformed BAM record";
      return -1;
    }
    S->scan_offs.push_back((size_t)(pos - S->base));
    pos += 4 + (uint64_t)bs;
  }
  S->end_off = pos;
  return (int64_t)pos;
}

// Parse records in [start, end) — all records starting in this span.
// The final record may extend past the owned end; the overlap covers it.
int32_t strawb_span_parse(StrawbSpan* S, int64_t start, int64_t end) {
  // ensure the tail record (starting just before `end`) is fully inflated
  std::vector<size_t> offs;
  if (S->scan_start == (uint64_t)start && S->end_off == (uint64_t)end &&
      !S->scan_offs.empty()) {
    // reuse strawb_span_end's scan; just inflate the tail record's body
    offs.swap(S->scan_offs);
    size_t lp = offs.back();
    while (lp + 4 > S->buf.size())
      if (!S->extend_to(S->binf1 + 4)) return 0;
    uint64_t rec_end =
        S->base + lp + 4 + (uint64_t)rd_i32(S->buf.data() + lp);
    while (rec_end > S->base + S->buf.size()) {
      if (S->binf1 >= S->blocks.size()) {
        S->error = "truncated BAM record";
        return 0;
      }
      if (!S->extend_to(S->binf1 + 4)) return 0;
    }
  } else if (S->scan_start == (uint64_t)start && S->scan_offs.empty() &&
             S->end_off == (uint64_t)end) {
    // empty span scanned by span_end: nothing to parse
  } else {
  uint64_t pos = (uint64_t)start;
  while (pos < (uint64_t)end) {
    while (pos + 4 > S->base + S->buf.size()) {
      if (!S->extend_to(S->binf1 + 4)) return 0;
    }
    int32_t bs = rd_i32(S->buf.data() + (size_t)(pos - S->base));
    uint64_t rec_end = pos + 4 + (uint64_t)bs;
    while (rec_end > S->base + S->buf.size()) {
      if (S->binf1 >= S->blocks.size()) {
        S->error = "truncated BAM record";
        return 0;
      }
      if (!S->extend_to(S->binf1 + 4)) return 0;
    }
    offs.push_back((size_t)(pos - S->base));
    pos = rec_end;
  }
  }
  size_t nrec = offs.size();
  size_t T = (size_t)S->n_threads;
  if (nrec < 4096) T = 1;
  std::vector<Partial> parts(T);
  if (T <= 1) {
    decode_range(S->buf.data(), offs.data(), 0, nrec, S->cfg, parts[0]);
  } else {
    std::vector<std::thread> pool;
    for (size_t t = 0; t < T; ++t) {
      size_t lo = nrec * t / T, hi = nrec * (t + 1) / T;
      pool.emplace_back([&, lo, hi, t]() {
        decode_range(S->buf.data(), offs.data(), lo, hi, S->cfg, parts[t]);
      });
    }
    for (auto& th : pool) th.join();
  }
  Result& R = S->R;
  for (auto& p : parts) R.paired_end |= p.paired_end;
  // ordered seq lens (first max_read_num_4_rl accepted in span order) so
  // the Python side can reconstruct the FILE-order read-length histogram
  for (auto& p : parts) {
    for (int32_t sl : p.seqlens) {
      if ((int64_t)S->seq_lens.size() >= S->cfg.max_read_num_4_rl) break;
      S->seq_lens.push_back(sl);
    }
  }
  {
    size_t total = 0;
    for (auto& p : parts) total += p.nfeat.size();
    R.feat_off.reserve(total + 1);
    R.feat_off.push_back(0);
    int64_t acc = 0;
    for (auto& p : parts)
      for (int64_t k : p.nfeat) {
        acc += k;
        R.feat_off.push_back(acc);
      }
  }
  concat(R.ref_id, parts, &Partial::ref_id);
  concat(R.left, parts, &Partial::left);
  concat(R.right, parts, &Partial::right);
  concat(R.strand, parts, &Partial::strand);
  concat(R.flag, parts, &Partial::flag);
  concat(R.mate_ref, parts, &Partial::mate_ref);
  concat(R.mate_pos, parts, &Partial::mate_pos);
  concat(R.nh, parts, &Partial::nh);
  concat(R.read_id, parts, &Partial::read_id);
  concat(R.cigar_hash, parts, &Partial::cigar_hash);
  concat(R.feat_code, parts, &Partial::feat_code);
  concat(R.feat_left, parts, &Partial::feat_left);
  concat(R.feat_len, parts, &Partial::feat_len);
  // the compressed file copy and inflate buffer are no longer needed
  std::vector<uint8_t>().swap(S->raw);
  std::vector<uint8_t>().swap(S->buf);
  return 1;
}

const char* strawb_span_error(StrawbSpan* S) {
  return S->error.empty() ? nullptr : S->error.c_str();
}
int64_t strawb_span_header_end(StrawbSpan* S) { return (int64_t)S->header_end; }
int64_t strawb_span_owned_end_ucomp(StrawbSpan* S) {
  return (int64_t)S->ucum[S->b1];
}
int64_t strawb_span_total_ucomp(StrawbSpan* S) {
  return (int64_t)S->ucum.back();
}
int64_t strawb_span_comp_bytes(StrawbSpan* S) { return S->comp_bytes; }
int32_t strawb_span_num_refs(StrawbSpan* S) {
  return (int32_t)S->ref_len.size();
}
const char* strawb_span_ref_names(StrawbSpan* S) {
  return S->names_blob.c_str();
}
const int32_t* strawb_span_ref_lens(StrawbSpan* S) { return S->ref_len.data(); }
int64_t strawb_span_num_hits(StrawbSpan* S) {
  return (int64_t)S->R.ref_id.size();
}
int64_t strawb_span_num_feats(StrawbSpan* S) {
  return (int64_t)S->R.feat_code.size();
}
int32_t strawb_span_paired(StrawbSpan* S) { return S->R.paired_end; }
int32_t strawb_span_num_seqlens(StrawbSpan* S) {
  return (int32_t)S->seq_lens.size();
}
const int32_t* strawb_span_seqlens(StrawbSpan* S) { return S->seq_lens.data(); }
const int32_t* strawb_span_ref_id(StrawbSpan* S) { return S->R.ref_id.data(); }
const int64_t* strawb_span_left(StrawbSpan* S) { return S->R.left.data(); }
const int64_t* strawb_span_right(StrawbSpan* S) { return S->R.right.data(); }
const int8_t* strawb_span_strand(StrawbSpan* S) { return S->R.strand.data(); }
const uint16_t* strawb_span_flag(StrawbSpan* S) { return S->R.flag.data(); }
const int32_t* strawb_span_mate_ref(StrawbSpan* S) {
  return S->R.mate_ref.data();
}
const int64_t* strawb_span_mate_pos(StrawbSpan* S) {
  return S->R.mate_pos.data();
}
const int32_t* strawb_span_nh(StrawbSpan* S) { return S->R.nh.data(); }
const uint64_t* strawb_span_read_id(StrawbSpan* S) {
  return S->R.read_id.data();
}
const uint64_t* strawb_span_cigar_hash(StrawbSpan* S) {
  return S->R.cigar_hash.data();
}
const int64_t* strawb_span_feat_off(StrawbSpan* S) {
  return S->R.feat_off.data();
}
const int8_t* strawb_span_feat_code(StrawbSpan* S) {
  return S->R.feat_code.data();
}
const int64_t* strawb_span_feat_left(StrawbSpan* S) {
  return S->R.feat_left.data();
}
const int32_t* strawb_span_feat_len(StrawbSpan* S) {
  return S->R.feat_len.data();
}
void strawb_span_free(StrawbSpan* S) { delete S; }

// Strictly sequential float64 summation (matches the reference's
// `weight += tmp` accumulation order bit-for-bit, which numpy's pairwise
// reduction would not).
double strawb_seqsum(const double* v, int64_t n) {
  double s = 0.0;
  for (int64_t i = 0; i < n; ++i) s += v[i];
  return s;
}

// Batched sequential summation over ragged segments: for each k,
// out[k] = sum(v[off[k] .. off[k+1]-1]) left-to-right.
void strawb_seqsum_batch(const double* v, const int64_t* off, int64_t nseg,
                         double* out) {
  for (int64_t k = 0; k < nseg; ++k) {
    double s = 0.0;
    for (int64_t i = off[k]; i < off[k + 1]; ++i) s += v[i];
    out[k] = s;
  }
}

}  // extern "C"
