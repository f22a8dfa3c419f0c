// Shared interface between quantprep.cc (whole-pass batched quant prep)
// and cluster.cc (fused pass-2 prep on the clustering workers).
#pragma once

#include <cstdint>
#include <vector>

// One locus' EM inputs: bin counts + (nbins x niso) weight matrix.
struct QuantLocusOut {
  std::vector<double> counts;
  std::vector<double> alpha;
};

// Compute one locus' exon bins and theoretical bin weights.
//   h_*: flat RLE over hit contigs, rows [hbeg, hend) with masses h_mass
//   t_*: flat RLE over ALL transcripts; iso_ids[t] = global index of the
//        locus' t-th isoform; t_exlen indexed by global id
//   pdf: dense fragment-length pdf table; base_lmin: start_offset or
//        read_len; long_read: 1/L weights instead of the pdf integral
void strawb_quant_locus(
    const int64_t* h_off, const int8_t* h_code, const int64_t* h_left,
    const int32_t* h_len, const double* h_mass, int64_t hbeg, int64_t hend,
    const int64_t* t_off, const int8_t* t_code, const int64_t* t_left,
    const int32_t* t_len, const int64_t* iso_ids, int64_t ni,
    const int64_t* t_exlen, const double* pdf, int64_t pdf_len,
    int64_t read_len, int64_t base_lmin, int32_t long_read,
    QuantLocusOut& out);

// As above but consuming precomputed compatibility (hit-major 0/1 bytes)
// and packed per-hit seg-overlap bit rows (the TPU-computed integer
// halves); nullptrs recompute both on host.
void strawb_quant_locus_pre(
    const int64_t* h_off, const int8_t* h_code, const int64_t* h_left,
    const int32_t* h_len, const double* h_mass, int64_t hbeg, int64_t hend,
    const int64_t* t_off, const int8_t* t_code, const int64_t* t_left,
    const int32_t* t_len, const int64_t* iso_ids, int64_t ni,
    const int64_t* t_exlen, const double* pdf, int64_t pdf_len,
    int64_t read_len, int64_t base_lmin, int32_t long_read,
    const uint8_t* compat_pre, const uint8_t* rows_pre, int64_t row_bytes,
    QuantLocusOut& out);
