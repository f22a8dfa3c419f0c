// Native GTF output formatter for the vectorized pass-2 finalize.
//
// Byte-for-byte twin of io/gtfwriter.py print2gtf (itself matching the
// reference Contig::print2gtf, src/contig.cpp:636-721): one transcript
// row + one row per MATCH feature, score 1000, frame '.', FPKM/Frac/TPM
// attributes from "%.6f" strings truncated to 11 characters (the
// reference copies them through a char[12] buffer). Validated against
// the Python writer by tests/test_core_units.py::test_native_gtf_emit
// and end-to-end by the golden CLI byte-parity runs.
//
// Inputs are the pass-2 factory state as flat arrays: the refs' flat RLE
// (off/code/left/len), per-ref strand + chromosome id, '\n'-joined string
// blobs (chrom real names, gene ids, transcript ids, ref gene ids/names),
// and per-emitted-isoform (row index, fpkm, frac, tpm). Output is one
// malloc'd byte buffer the caller frees with strawb_gtf_emit_free.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace {
typedef int64_t i64;

// split a '\n'-joined blob into row views ("" rows allowed)
static void split_blob(const char* blob, std::vector<std::string_view>& out) {
  out.clear();
  if (!blob) return;
  const char* p = blob;
  const char* end = blob + strlen(blob);
  while (p <= end) {
    const char* q = (const char*)memchr(p, '\n', end - p);
    if (!q) {
      out.emplace_back(p, end - p);
      break;
    }
    out.emplace_back(p, q - p);
    p = q + 1;
  }
}

// c_str (quant/locus.py:40): f"{x:.6f}", then print2gtf truncates to 11
// chars. Python formats nan (any sign) as "nan" and inf as "inf".
static size_t fmt_val(double x, char* buf, size_t cap) {
  int n;
  if (std::isnan(x))
    n = snprintf(buf, cap, "nan");
  else if (std::isinf(x))
    n = snprintf(buf, cap, x < 0 ? "-inf" : "inf");
  else
    n = snprintf(buf, cap, "%.6f", x);
  size_t ln = n < 0 ? 0 : (size_t)n;
  if (ln > 11) ln = 11;  // char[12] truncation quirk
  return ln;
}

static void app(std::string& o, std::string_view s) {
  o.append(s.data(), s.size());
}

}  // namespace

extern "C" {

char* strawb_gtf_emit(
    i64 n_iso, const i64* row,
    const i64* f_off, const int8_t* f_code, const i64* f_left,
    const int32_t* f_len,
    const int8_t* strand, const int32_t* chrom_id,
    const char* chroms_blob, const char* gene_blob, const char* tid_blob,
    const char* rgid_blob, const char* rgname_blob,
    const double* fpkm, const double* frac, const double* tpm,
    i64* out_len) {
  std::vector<std::string_view> chroms, genes, tids, rgids, rgnames;
  split_blob(chroms_blob, chroms);
  split_blob(gene_blob, genes);
  split_blob(tid_blob, tids);
  split_blob(rgid_blob, rgids);
  split_blob(rgname_blob, rgnames);

  std::string o;
  o.reserve((size_t)n_iso * 1024);
  char num[512];
  std::string attr;
  for (i64 k = 0; k < n_iso; ++k) {
    i64 r = row[k];
    int32_t cid = chrom_id[r];
    std::string_view ref_name =
        (cid >= 0 && (size_t)cid < chroms.size()) ? chroms[cid]
                                                  : std::string_view("?");
    char sc = strand[r] == 1 ? '+' : strand[r] == 2 ? '-' : '.';
    i64 o0 = f_off[r], o1 = f_off[r + 1];
    i64 left = f_left[o0];
    i64 right = f_left[o1 - 1] + (i64)f_len[o1 - 1] - 1;

    attr.clear();
    attr += "gene_id \"";
    app(attr, genes[r]);
    attr += "\";transcript_id \"";
    app(attr, tids[r]);
    attr += "\";";
    if (!rgids[r].empty()) {
      attr += "ref_gene_id \"";
      app(attr, rgids[r]);
      attr += "\";";
    }
    if (!rgnames[r].empty()) {
      attr += "ref_gene_name \"";
      app(attr, rgnames[r]);
      attr += "\";";
    }
    attr += "FPKM \"";
    attr.append(num, fmt_val(fpkm[k], num, sizeof num));
    attr += "\";Frac \"";
    attr.append(num, fmt_val(frac[k], num, sizeof num));
    attr += "\";TPM \"";
    attr.append(num, fmt_val(tpm[k], num, sizeof num));
    attr += "\";";

    app(o, ref_name);
    int n = snprintf(num, sizeof num, "\tStrawberry\ttranscript\t%lld\t%lld"
                     "\t1000\t%c\t.\t",
                     (long long)left, (long long)right, sc);
    o.append(num, n);
    o += attr;
    o += '\n';
    int exon_num = 0;
    for (i64 f = o0; f < o1; ++f) {
      if (f_code[f] != 0) continue;  // MATCH rows only
      exon_num++;
      app(o, ref_name);
      n = snprintf(num, sizeof num, "\tStrawberry\texon\t%lld\t%lld"
                   "\t1000\t%c\t.\t",
                   (long long)f_left[f],
                   (long long)(f_left[f] + (i64)f_len[f] - 1), sc);
      o.append(num, n);
      o += attr;
      n = snprintf(num, sizeof num, " exon_id \"%d\";\n", exon_num);
      o.append(num, n);
    }
  }
  *out_len = (i64)o.size();
  char* buf = (char*)malloc(o.size() ? o.size() : 1);
  memcpy(buf, o.data(), o.size());
  return buf;
}

void strawb_gtf_emit_free(char* p) { free(p); }

}  // extern "C"
