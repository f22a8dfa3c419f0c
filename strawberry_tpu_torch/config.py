"""Typed configuration for strawberry_tpu.

Replaces the reference's ~50 process-global flags (ref: src/common.cpp:14-73,
include/common.h:25-88) with one dataclass. Field names keep the reference's
semantics and defaults; CLI flag spellings match src/Strawberry.cpp:32-69.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    # --- general -----------------------------------------------------------
    output_gtf: str = "./strawberry_assembled.gtf"          # -o
    logfile: str = "/tmp/strawberry.log"                    # -T
    verbose: bool = False                                   # -v
    num_threads: int = 1                                    # -p (host worker threads)
    min_map_qual: int = 0                                   # -q (warning-only in reference)

    # --- read filters (ref: common.cpp:16-42) ------------------------------
    max_gene_length: int = 2_500_000        # kMaxGeneLength
    max_frag_span: int = 1_000_000          # kMaxFragSpan
    max_intron_length: int = 300_000        # -J kMaxIntronLength
    min_intron_length: int = 20             # -j kMinIntronLength
    use_only_unique_hits: bool = True       # --allow-multimapped-hits flips to False
    max_read_num_4_rl: int = 50_000         # -n kMaxReadNum4RL (read-length prerun)
    long_read_len: int = 1000               # common.h:86

    # --- strandness --------------------------------------------------------
    fr_strand: bool = False                 # --fr
    rf_strand: bool = False                 # --rf

    # --- clustering --------------------------------------------------------
    max_olap_dist: int = 50                 # -d kMaxOlapDist (cluster merge radius)

    # --- assembly (ref: common.cpp:22-41) ----------------------------------
    min_read_for_assemb: int = 5            # kMinReadForAssemb
    min_trans_len: int = 200                # -t kMinTransLen
    min_anchor: float = 10.0                # -s kMinAnchor (small overhang)
    binomial_overhang_alpha: float = 0.0    # -a kBinomialOverHangAlpha
    min_junc_support: int = 2               # --min-support-4-intron kMinJuncSupport
    long_junc_length: int = 30_000          # LongJuncLength
    min_support_for_long_junc: int = 5      # kMinSupportForLongJunc
    min_dist_4_exon_edge: int = 5           # kMinDist4ExonEdge
    intron_edge_weight: float = 1.0         # kIntronEdgeWeight
    min_depth_4_locus: float = 1.0          # kMinDepth4Locus
    min_depth_4_contig: float = 1.0         # --min-depth-4-transcript kMinDepth4Contig
    min_exon_doc: float = 1.0               # --min-exon-cov kMinExonDoc (unused in main path)
    max_cover_gap1: int = 30                # kMaxCoverGap1
    max_cover_gap2: int = 10                # kMaxCoverGap2
    combine_short_transfrag: bool = False   # -c (vestigial in reference)

    # --- quantification ----------------------------------------------------
    min_isoform_frac: float = 0.01          # -m/-e kMinIsoformFrac
    insert_size_mean: float = 0.0           # -i mean/sd
    insert_size_sd: float = 0.0
    infer_the_other_end: bool = False       # gated off in reference (common.cpp:51)
    effective_len_norm: bool = False        # common.cpp:66
    filter_by_expression: bool = True       # common.cpp:72
    bias_correction: bool = False           # -b
    ref_fasta_file: str = ""                # -b value
    print_frag_context: bool = False        # -f
    frag_context_out: str = "./frag_context.csv"

    # --- modes -------------------------------------------------------------
    ref_gtf_filename: str = ""              # -g
    utilize_ref_models: bool = False        # set by -g
    enforce_ref_models: bool = False        # set by -r
    no_assembly: bool = False               # -r
    no_quant: bool = False                  # --no-quant
    long_read_sample: bool = False          # auto-detected

    # --- runtime / TPU -----------------------------------------------------
    device_batch: bool = True               # run batched kernels on the JAX device
    native_cluster: bool = True             # C++ clusterizer (validated vs oracle)
    stream_decode: bool = True              # streaming BAM decode overlapping pass 1
    low_mem: bool = False                   # --low-mem: drop decoded blocks as consumed;
                                            # pass 2 re-decodes (O(window) peak RSS)
    fast_em: bool = False                   # f32 Pallas EM (throughput mode;
                                            # trades golden bit-parity for speed)
    device_prep: bool = None                # TPU integer compat/row kernels for
                                            # pass-2 quant prep (byte-exact).
                                            # None = auto: on when the JAX
                                            # backend is a real accelerator;
                                            # STRAWB_DEVICE_PREP=0/1 overrides
    mesh_shape: tuple = ()                  # () = single device; e.g. (8,) data-parallel

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def single_end_default_insert(self):
        return 200.0, 80.0

    def apply_no_assembly(self) -> "Config":
        """-r implies enforce_ref_models and kMinIsoformFrac=0 (Strawberry.cpp:158-162)."""
        return self.replace(no_assembly=True, enforce_ref_models=True,
                            min_isoform_frac=0.0)


DEFAULT = Config()
