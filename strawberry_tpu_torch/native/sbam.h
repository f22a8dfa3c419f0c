// Streaming BAM decoder (sbam): cross-TU C ABI shared by bamdecode.cc
// (implementation), cluster.cc (the streaming fused pipeline consumes
// chromosome blocks as they finish decoding) and the Python ctypes binding.
//
// Replaces the all-at-once strawb_bam_load for the pipeline's fast path:
// decode (read -> BGZF inflate -> record parse) runs on a background
// pipeline and finalizes one block per hit-bearing chromosome, in file
// order, so clustering of chromosome k overlaps the decode of chromosome
// k+1 and peak memory for the decode stage is O(window), not O(file)
// (the reference streams records one at a time through samread,
// src/read.cpp:459; we stream chromosome-sized tensor blocks instead).
#pragma once
#include <cstdint>

extern "C" {

struct StrawbSbam;

StrawbSbam* strawb_sbam_open(const char* path, int32_t max_intron,
                             int32_t min_intron, int32_t unique_only,
                             int32_t fr, int32_t rf, int32_t max_hist,
                             int32_t min_mapq, int32_t n_threads);
// open parses the header synchronously but does NOT start record
// decoding; configure splitting (below) in between, then call start.
void strawb_sbam_start(StrawbSbam*);
// low-mem sub-chromosome block splitting: finalize blocks >= target
// bytes at cluster-safe boundaries (record left > chromosome running
// max(right, applicable mate end) + pad, outside the padded merged
// annotation-gene barrier intervals). 0 = whole-chromosome blocks.
void strawb_sbam_set_split(StrawbSbam*, int64_t target_bytes, int64_t pad,
                           int64_t n, const int32_t* bchrom,
                           const int64_t* bleft, const int64_t* bright);
int32_t strawb_sbam_split_enabled(StrawbSbam*);
int64_t strawb_sbam_split_pad(StrawbSbam*);
// position where block k's range begins (0 = chromosome start); refs
// whose padded right end lies before the NEXT block's cut belong to k
int64_t strawb_sbam_block_cut(StrawbSbam*, int64_t k);
// -v per-read diagnostics captured during decode (valid after EOF)
int64_t strawb_sbam_diag_n(StrawbSbam*);
const int8_t* strawb_sbam_diag_kinds(StrawbSbam*);
const int64_t* strawb_sbam_diag_rows(StrawbSbam*);
const char* strawb_sbam_diag_names(StrawbSbam*);
void strawb_sbam_free(StrawbSbam*);
// blocks until the header is parsed or the pipeline fails; NULL = no error
const char* strawb_sbam_error(StrawbSbam*);

// ---- header (block until parsed) ----
int32_t strawb_sbam_num_refs(StrawbSbam*);
const char* strawb_sbam_ref_names(StrawbSbam*);  // '\n'-joined
const int32_t* strawb_sbam_ref_lens(StrawbSbam*);

// ---- read-length histogram (block until final: 50k accepted or EOF) ----
int32_t strawb_sbam_hist_size(StrawbSbam*);
const int32_t* strawb_sbam_hist_len(StrawbSbam*);
const int32_t* strawb_sbam_hist_count(StrawbSbam*);

// ---- stream totals (block until EOF) ----
int64_t strawb_sbam_num_hits(StrawbSbam*);
int32_t strawb_sbam_paired(StrawbSbam*);
int64_t strawb_sbam_num_blocks(StrawbSbam*);

// ---- chromosome blocks (one per hit-bearing chromosome, file order) ----
// waits until block k is finalized; 1 = ready, 0 = stream ended before k,
// -1 = decode error
int32_t strawb_sbam_wait_block(StrawbSbam*, int64_t k);
int32_t strawb_sbam_block_chrom(StrawbSbam*, int64_t k);
int64_t strawb_sbam_block_n(StrawbSbam*, int64_t k);
int64_t strawb_sbam_block_nfeat(StrawbSbam*, int64_t k);
const int32_t* strawb_sbam_block_ref_id(StrawbSbam*, int64_t k);
const int64_t* strawb_sbam_block_left(StrawbSbam*, int64_t k);
const int64_t* strawb_sbam_block_right(StrawbSbam*, int64_t k);
const int8_t* strawb_sbam_block_strand(StrawbSbam*, int64_t k);
const uint16_t* strawb_sbam_block_flag(StrawbSbam*, int64_t k);
const int32_t* strawb_sbam_block_mate_ref(StrawbSbam*, int64_t k);
const int64_t* strawb_sbam_block_mate_pos(StrawbSbam*, int64_t k);
const int32_t* strawb_sbam_block_nh(StrawbSbam*, int64_t k);
const uint64_t* strawb_sbam_block_read_id(StrawbSbam*, int64_t k);
const uint64_t* strawb_sbam_block_cigar_hash(StrawbSbam*, int64_t k);
const int64_t* strawb_sbam_block_feat_off(StrawbSbam*, int64_t k);  // n+1
const int8_t* strawb_sbam_block_feat_code(StrawbSbam*, int64_t k);
const int64_t* strawb_sbam_block_feat_left(StrawbSbam*, int64_t k);
const int32_t* strawb_sbam_block_feat_len(StrawbSbam*, int64_t k);

// low-memory mode: release block k's buffers once every consumer of the
// current pass is done with them (pass 2 then re-opens the stream)
void strawb_sbam_drop_block(StrawbSbam*, int64_t k);

// opaque per-block cache (pass-1 -> pass-2 GlobalPairs reuse; freed with
// the block / the stream)
void* strawb_sbam_block_aux(StrawbSbam*, int64_t k);
void strawb_sbam_block_set_aux(StrawbSbam*, int64_t k, void* p,
                               void (*free_fn)(void*));
// low-memory mode: stall the decoder before finalizing a new block while
// more than `bytes` are retained in undropped blocks (min 2 live blocks
// always admitted so consumers can make progress). 0 = unbounded.
void strawb_sbam_set_max_retained(StrawbSbam*, int64_t bytes);

}  // extern "C"
