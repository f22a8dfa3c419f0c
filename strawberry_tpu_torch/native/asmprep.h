// Shared interface between cluster.cc (fused pass-1 prep submission) and
// assembleprep.cc (per-locus coverage -> splice graph -> flow network).
#pragma once

#include <cstdint>
#include <vector>

struct AsmJob;  // opaque; wait with strawb_asm_wait (assembleprep.cc)

// Scalar knobs of the per-locus assembly prep (mirrors the tail arguments
// of strawb_asmprep / strawb_asmprep_submit).
struct AsmPrepCfg {
  double small_overhang;
  double min_depth_4_locus;
  double min_isoform_frac;
  double min_junc_support;
  int64_t long_junc_length;
  double min_support_for_long_junc;
  int32_t enforce_ref_models;
  double binomial_overhang_alpha;
  int64_t max_cover_gap1, max_cover_gap2;
  double intron_edge_weight;
  int64_t min_dist_4_exon_edge;
  // full-solve chaining: run NetworkSimplex + flowDecompose + reconstruct
  // on the prep worker so the unit arrives as finished transcript chains
  int32_t solve = 0;
  int64_t min_trans_len = 0;
  double min_depth_4_contig = 0.0;
};

// Submit a prep job that OWNS its input arrays (used by the fused
// clusterizer, which gathers per-unit inputs on its own worker threads).
AsmJob* strawb_asm_submit_owned(
    int64_t l, int64_t r, int64_t read_len,
    std::vector<int64_t>&& h_off, std::vector<int8_t>&& h_code,
    std::vector<int64_t>&& h_left, std::vector<int32_t>&& h_len,
    std::vector<double>&& cov_mass, std::vector<double>&& weight_mass,
    const AsmPrepCfg& cfg);
