"""Two-pass pipeline driver: assembly pass + quantification pass, with the
device work on the GPU.

The counterpart of strawberry_tpu/pipeline.py, copied from it (Sample::
{assembleSample,preProcess,procSample} and driver(), ref:
src/alignments.cpp:1189-1835, src/Strawberry.cpp:237-371). Pass 1 clusters
reads, assembles transcripts per locus, and learns the fragment-length
distribution; pass 2 re-clusters against the assembled (or annotated)
models and runs the LCM EM. What differs from the original:

- `_assemble_batched` solves the flow problems with the host
  NetworkSimplex, or, under STRAWB_DEVICE_MCF, with the batched min-cost
  flow on the GPU (assembly/device.py).
- `_quantify_batched` takes its EM dispatcher from quant/device.py (the
  per-locus EM as a CUDA kernel under --fast-em or STRAWB_DEVICE_EM=1)
  and, under STRAWB_DEVICE_PREP=all|budget, its device quant prep from
  quant/device_prep.py.
- `run_driver` reaches its `-p` branch (parallel/multiproc.py, forked
  shard workers that keep their work on the host) before anything touches
  the GPU: a CUDA context does not survive a fork. The STRAWB_TRACE_DIR
  trace is torch.profiler's (utils/profiling.py), started and stopped
  where the JAX package's run_driver starts and stops jax.profiler's,
  and also stopped on the --no-quant and "Not enough reads" returns, so
  those runs write theirs too. Under -p it records the parent's host
  side only and leaves CUDA untouched.

Both methods are kept close to the originals so the two can be diffed.
"""
from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, TextIO, Tuple

import numpy as np

from .config import Config
from .core import fastcluster as _fcl
from .core.cluster import (ClusterFactory, HitCluster, Segment,
                           finalize_cluster)
from .core.features import (Contig, S_MATCH, STRAND_UNKNOWN, is_compatible,
                            exonic_overlaps_len, sort_contigs)
from .core.insert_size import InsertSize
from .io.bamreader import HitTable, load_bam
from .io.gff import GffReader, load_ref_mrnas
from .io.gtfwriter import print2gtf
from .quant.locus import Isoform, LocusContext, c_str
from .assembly.coverage import IntronMap, compute_doc, filter_intron
from .assembly.flow import FlowNetwork, assemble_2_contigs
from .assembly.splice_graph import splicing_graph
from .utils.profiling import GLOBAL as PROF


class _NullLog:
    is_null = True  # hot paths skip f-string building for null logs

    def write(self, *_a, **_k):
        pass


def _g(x) -> str:
    """C++ `cerr << double` default formatting (6 significant digits)."""
    if isinstance(x, int):
        return str(x)
    return f"{x:.6g}"


@dataclass
class AsmTask:
    """One per-segment assembly unit awaiting its flow solve."""
    strand: int = 0
    ref_id: int = -1
    fn: object = None
    exons: object = None
    node2exon: dict = field(default_factory=dict)
    cost_map: dict = field(default_factory=dict)
    min_flow_map: dict = field(default_factory=dict)
    path_cstrs: list = field(default_factory=list)
    dense: tuple = None
    pending: object = None  # in-flight native_asmprep job (resolve first)
    # finished transcript feature chains from the native full solve
    # (lemonns.cc NetworkSimplex + decompose + reconstruct); None = the
    # flow problem is solved Python-side / on device instead
    native_txs: object = None
    native_flat: object = None  # same transcripts as RLE numpy arrays


class Sample:
    def __init__(self, table: HitTable, cfg: Config, bam_path: str = "sample"):
        self.table = table
        self.cfg = cfg
        self.bam_path = bam_path
        self.factory = ClusterFactory(table, cfg)
        self.assembly: List[Contig] = []
        self.frag_dist: List[int] = []
        self.total_mapped_reads = 0
        self.num_cluster = 0
        self.num_cluster_base = 0  # sharded runs thread ids across shards
        self.insert_dist: Optional[InsertSize] = None
        self.long_read_sample = False
        self.read_len = table.read_len_mode()
        self.fasta = None  # FastaInterface when -b is given
        self.flow_stats = {}  # batched_mcf host/device routing counts
        self._fld_specs = []  # deferred fragLenDist inputs (cluster order)
        self._fld_futures = []  # in-flight chunks (cluster order)
        self._fld_pool = None
        # per-cluster flat RLE of the assembled transcripts, in assembly
        # order — lets pass 2 sort + flatten the assembly from arrays
        # (valid only while the parts cover len(self.assembly))
        self._af_parts: List = []
        # (rows, fpkm, frac) kept-isoform arrays when pass 2 finalized
        # fully vectorized and the caller wants bytes, not Isoforms
        self._vec_emit = None
        # decode-captured -v per-read events for the pass-2 replay
        self._read_diags = None

    def _flush_fld_async(self):
        """Ship the accumulated fragLenDist specs to a side thread (the
        native batch call releases the GIL), so the compat scan overlaps
        the rest of pass 1 instead of being a pass-end barrier."""
        if not self._fld_specs:
            return
        from .core.fastcluster import native_fld_batch
        if self._fld_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._fld_pool = ThreadPoolExecutor(max_workers=1)
        specs, self._fld_specs = self._fld_specs, []
        self._fld_futures.append(self._fld_pool.submit(native_fld_batch,
                                                       specs))

    def _drain_fld(self):
        """Resolve deferred fragment-length work (threaded native calls
        over every locus of the pass, in cluster order). frag_dist becomes
        one int32 array (boxed Python ints would cost ~30x the RSS on a
        10M-read pass)."""
        if self._fld_futures or self._fld_specs:
            with PROF.phase("frag_len_dist", items=len(self._fld_specs)):
                chunks = [np.asarray(fut.result(), np.int32)
                          for fut in self._fld_futures]
                self._fld_futures = []
                if self._fld_specs:
                    from .core.fastcluster import native_fld_batch
                    specs, self._fld_specs = self._fld_specs, []
                    chunks.append(np.asarray(native_fld_batch(specs),
                                             np.int32))
                if chunks:
                    base = np.asarray(self.frag_dist, np.int32) \
                        if len(self.frag_dist) else np.zeros(0, np.int32)
                    self.frag_dist = np.concatenate([base] + chunks)
        if self._fld_pool is not None:
            self._fld_pool.shutdown(wait=False)
            self._fld_pool = None

    # ------------------------------------------------------------------
    def _use_device_prep(self) -> str:
        """Resolve the device-prep routing: "all" (every eligible locus on
        the GPU), "budget" (a bounded slice of the reads x isoforms pairs
        offloaded concurrently) or "off". cfg.device_prep=True/False
        forces all/off; STRAWB_DEVICE_PREP=all|budget|1|0 overrides the
        default, which routing.py holds (PERF.md, "H100 crossovers")."""
        from .routing import prep_mode
        return prep_mode(self.cfg.device_prep)

    @functools.cached_property
    def sample_name(self) -> str:
        return os.path.basename(self.bam_path).split(".")[0]

    def load_ref_gtf(self, gtf_path: str, reader=None):
        name2id = {n: i for i, n in enumerate(self.table.ref_names)}
        if reader is None:
            try:
                from .io.gff import parse_native
                reader = parse_native(gtf_path)
            except OSError:
                reader = GffReader(gtf_path)
                reader.read_all()
        if isinstance(reader, GffReader):
            self.factory.set_ref_mrnas(load_ref_mrnas(reader, name2id))
        else:
            from .io.gff import load_ref_mrnas_native
            refs, flat = load_ref_mrnas_native(reader, name2id,
                                               return_flat=True)
            self.factory.set_ref_mrnas(refs, flat=flat)

    # ------------------------------------------------------------------
    def iter_clusters(self, mode: str, fuse_quant=None):
        """Yield finalized clusters in genome order. mode: 'refguide'
        (pass 1) or 'refdemand' (pass 2). Uses the native C++ clusterizer
        when available (validated against the Python oracle), else the
        oracle itself."""
        use_native = getattr(self.cfg, "native_cluster", True)
        if use_native:
            try:
                from .core.fastcluster import stream_native_clustering
                # streaming: cluster decode + downstream per-locus prep run
                # while the native workers cluster later chromosomes; in
                # pass 1 the workers also chain the per-cluster assembly
                # prep (fuse_read_len), in pass 2 the quant prep
                # (fuse_quant), so clusters arrive with their flow problems
                # queued / EM inputs computed
                fuse = self.read_len if (
                    mode == "refguide" and not self.cfg.no_assembly) else None
                with PROF.phase("native_cluster"):
                    yield from stream_native_clustering(
                        self.table, self.cfg, self.factory.ref_mrnas, mode,
                        fuse_read_len=fuse, fuse_quant=fuse_quant,
                        ref_flat=self.factory.ref_flat)
                return
            except OSError:
                pass  # native lib unavailable; fall through
        while True:
            cluster = HitCluster(self.cfg)
            rc = (self.factory.next_cluster_refguide(cluster)
                  if mode == "refguide"
                  else self.factory.next_cluster_ref_demand(cluster))
            if rc == -1:
                break
            if cluster.ref_id == -1:
                continue
            finalize_cluster(cluster, True)
            yield cluster

    # ------------------------------------------------------------------
    def frag_len_dist(self, transcripts: List[Contig], cluster: HitCluster,
                      log: TextIO, iso_flat=None):
        """Sample::fragLenDist (alignments.cpp:1363-1427). iso_flat: the
        transcripts already flattened (native solve path) — skips the
        Python re-flattening inside the whole-pass fld batch."""
        if not transcripts:
            return
        self.total_mapped_reads += int(cluster.weighted_mass)
        done = False
        flat = getattr(cluster, "flat", None)
        if getattr(self.cfg, "native_cluster", True):
            try:
                if flat is not None:
                    # defer to one threaded whole-pass native call (drained
                    # by _drain_fld before anything reads frag_dist); flat
                    # only exists when the native lib produced it
                    if len(flat[0]) > 1:
                        self._fld_specs.append(
                            (iso_flat if iso_flat is not None
                             else transcripts, flat))
                    done = True
                else:
                    from .io.native import get_lib
                    get_lib()  # probe availability (OSError -> oracle)
                    hits = cluster.uniq_hit_contigs()
                    if hits:
                        self._fld_specs.append(
                            (transcripts, _fcl.flatten_contigs(hits)))
                    done = True
            except OSError:
                done = False
        if not done:
            for h in cluster.uniq_hit_contigs():
                counter = 0
                mark = 0
                for t_i, t in enumerate(transcripts):
                    if is_compatible(h, t):
                        counter += 1
                        mark = t_i
                if counter == 1:
                    fl = exonic_overlaps_len(transcripts[mark], h.left,
                                             h.right)
                    self.frag_dist.append(fl)
        if not getattr(log, "is_null", False):
            ref_name = self.table.ref_real_names[cluster.ref_id] \
                if cluster.ref_id >= 0 else "?"
            log.write(f"Finish inspecting locus: {ref_name}:"
                      f"{cluster.leftmost}-{cluster.rightmost}\n")
            log.write(f"Found {len(cluster.ref_mrnas)} of ref mRNAs "
                      f"from the reference gtf file.\n")
            log.write(f"Number of total unique hits: "
                      f"{cluster.num_uniq()}\n\n")

    # ------------------------------------------------------------------
    def prepare_contig_task(self, l: int, r: int, strand: int,
                            hits: Optional[List[Contig]] = None,
                            flat_bundle=None, ref_id: int = -1):
        """First (host) half of Sample::assembleContig (alignments.cpp:
        64-117): coverage, intron filters, splice graph, flow network
        construction. Returns an AsmTask whose dense flow problem (if any)
        can be solved on host or batched on the TPU.

        flat_bundle = (hit_flat, cov_mass, weight_mass) runs everything on
        flat RLE arrays without per-read Python objects (cov_mass carries
        -1 sentinels for reference models)."""
        cfg = self.cfg
        task = AsmTask(strand=strand)
        hit_flat = cov_mass = weight_mass = None
        if flat_bundle is not None:
            hit_flat, cov_mass, weight_mass = flat_bundle
            if len(hit_flat[0]) <= 1:
                return task
        else:
            if not hits:
                return task
            ref_id = hits[0].ref_id
            if getattr(cfg, "native_cluster", True):
                try:
                    from .core.fastcluster import flatten_contigs
                    hit_flat = flatten_contigs(hits)
                    cov_mass = np.array(
                        [-1.0 if h.is_ref else h.mass for h in hits],
                        np.float64)
                    weight_mass = np.array(
                        [h.mass for h in hits], np.float64)
                except Exception:
                    hit_flat = None
        if hit_flat is not None:
            try:
                from .core.fastcluster import (native_asmprep_submit,
                                               native_solve_enabled)
                # queue on the native worker pool; the result is decoded
                # lazily via _resolve_task so C++ prep overlaps the
                # Python-side cluster orchestration. By default the worker
                # also solves + reconstructs (lemonns.cc); the Python NS
                # oracle / device DP paths disable that via env
                task.pending = native_asmprep_submit(
                    cfg, l, r, self.read_len, hit_flat, cov_mass,
                    weight_mass, solve=native_solve_enabled())
                task.ref_id = ref_id
                return task
            except OSError:
                pass  # lib unavailable: fall through to oracle path
        exon_doc = np.zeros(r - l + 1, dtype=np.float32)
        intron_counter: IntronMap = {}
        if hit_flat is not None:
            from .core.fastcluster import native_coverage
            from .assembly.coverage import IntronEntry
            il, ir, tot, small = native_coverage(
                None, l, r, cfg.min_anchor, exon_doc, hit_flat=hit_flat,
                masses=cov_mass)
            for k in range(len(il)):
                intron_counter[(int(il[k]), int(ir[k]))] = IntronEntry(
                    int(il[k]), int(ir[k]), float(tot[k]), float(small[k]))
            num_nt = int(np.count_nonzero(exon_doc > 0))
            avg_dep = (float(exon_doc.sum(dtype=np.float64)) / num_nt
                       if num_nt else 0.0)
        else:
            avg_dep = compute_doc(l, r, hits, exon_doc, intron_counter,
                                  cfg.min_anchor)
        if avg_dep < cfg.min_depth_4_locus:
            return task
        filter_intron(cfg, l, self.read_len, exon_doc, intron_counter)

        exons = splicing_graph(cfg, l, exon_doc, intron_counter)
        if exons is None:
            return task
        fn = FlowNetwork(self.cfg)
        node2exon = {}
        cost_map = {}
        min_flow_map = {}
        path_cstrs: List[List[int]] = []
        ok = fn.create_network(hits or [], exons, intron_counter, node2exon,
                               cost_map, min_flow_map, path_cstrs,
                               hit_flat=hit_flat, weight_mass=weight_mass)
        if not ok:
            return task
        task.ref_id = ref_id
        task.fn = fn
        task.exons = exons
        task.node2exon = node2exon
        task.cost_map = cost_map
        task.min_flow_map = min_flow_map
        task.path_cstrs = path_cstrs
        # add_sink_source mutates the graph; do it now so the dense problem
        # includes source/sink/circulation arcs (solveNetwork order kept)
        fn.add_sink_source()
        task.dense = fn.dense_problem(cost_map, min_flow_map)
        return task

    def _resolve_task(self, task):
        """Materialize a pending native assembly-prep job (no-op if the
        task was built synchronously)."""
        if task is None or task.pending is None:
            return task
        from .core.fastcluster import native_asmprep_result
        pending, task.pending = task.pending, None
        res = native_asmprep_result(pending)
        if res is None:
            task.ref_id = -1
            return task  # empty task (below-depth / unassemblable)
        return self._task_from_native(task, res, task.ref_id)

    def _resolve_units(self, units):
        if units:
            for (_k, t) in units:
                self._resolve_task(t)
        return units

    def _resolve_units_batch(self, collected):
        """Resolve every pending native prep job across a chunk of
        clusters in ONE packed native call (waits + decodes together)."""
        tasks = []
        for _cluster, units in collected:
            for (_k, t) in units or []:
                if t is not None and t.pending is not None:
                    tasks.append(t)
        if not tasks:
            return
        from .core.fastcluster import native_asmprep_result_batch
        results = native_asmprep_result_batch([t.pending for t in tasks])
        for t, res in zip(tasks, results):
            t.pending = None
            if res is None:
                t.ref_id = -1
            else:
                self._task_from_native(t, res, t.ref_id)

    def _task_from_native(self, task, res, ref_id: int):
        """Materialize an AsmTask from the native assembleprep result:
        finished transcripts when the worker also solved the flow
        (lemonns.cc), else rebuild the (tiny) Graph + maps and scatter the
        dense problem for the host/device solver."""
        from .assembly.flow import FlowNetwork
        from .assembly.splice_graph import ExonSeg
        if res[0] == "solved":
            task.ref_id = ref_id
            task.native_txs = res[1]
            task.native_flat = res[2]
            return task
        exl, exr, exdoc, M, src, dst, cost, lower, cstrs = res
        fn = FlowNetwork(self.cfg)
        g = fn.g
        g.n_nodes = M
        g._out = [[] for _ in range(M)]
        g._in = [[] for _ in range(M)]
        g.arc_src = src
        g.arc_dst = dst
        for a in range(len(src)):
            g._out[src[a]].append(a)
            g._in[dst[a]].append(a)
        fn.source = M - 2
        fn.sink = M - 1
        ne = len(exl)
        task.ref_id = ref_id
        task.fn = fn
        task.exons = [ExonSeg(exl[i], exr[i], exdoc[i]) for i in range(ne)]
        task.node2exon = {i: i for i in range(ne)} if ne > 1 else {}
        task.cost_map = {a: c for a, c in enumerate(cost) if c}
        task.min_flow_map = {a: c for a, c in enumerate(lower) if c}
        task.path_cstrs = cstrs
        na = len(src)
        cm = np.zeros((M, M), np.int64)
        ha = np.zeros((M, M), bool)
        lo = np.zeros((M, M), np.int64)
        if na:
            sa = np.asarray(src, np.int64)
            da = np.asarray(dst, np.int64)
            ha[sa, da] = True
            cm[sa, da] = np.asarray(cost, np.int64)
            lo[sa, da] = np.asarray(lower, np.int64)
        task.dense = (cm, ha, lo)
        return task

    def finish_contig_task(self, task, flow_matrix) -> List[Contig]:
        """Second half: flow decomposition + transcript reconstruction +
        assemble_2_contigs, given the solved flow (per-arc list from the
        lemon-exact solver, or a dense matrix from the device DP). When the
        native worker already solved + reconstructed (task.native_txs), just
        wrap the finished feature chains as Contigs."""
        if task.native_txs is not None:
            return [Contig(ref_id=task.ref_id, strand=task.strand,
                           feats=feats, mass=1.0, is_ref=True, contig_id=0)
                    for feats in task.native_txs]
        if task.fn is None:
            return []
        fn = task.fn
        if flow_matrix is None:
            return []
        g = fn.g
        if isinstance(flow_matrix, (list, tuple)):
            flow = {a: int(flow_matrix[a]) for a in range(g.n_arcs())}
        else:
            flow = {a: int(flow_matrix[g.arc_src[a], g.arc_dst[a]])
                    for a in range(g.n_arcs())}
        transcripts = fn.reconstruct(task.node2exon, task.exons,
                                     task.path_cstrs, task.cost_map, flow)
        if transcripts is None:
            return []
        return assemble_2_contigs(transcripts, task.exons, task.ref_id,
                                  task.strand, self.cfg)

    def assemble_contig(self, l: int, r: int, strand: int,
                        hits: List[Contig]) -> List[Contig]:
        """Sample::assembleContig (alignments.cpp:64-117), host solve."""
        from .assembly.lemonns import network_simplex
        task = self._resolve_task(self.prepare_contig_task(l, r, strand,
                                                            hits))
        if task.native_txs is not None:
            return self.finish_contig_task(task, None)
        if task.fn is None:
            return []
        fm = network_simplex(task.fn.g, task.cost_map, task.min_flow_map)
        return self.finish_contig_task(task, fm)

    # ------------------------------------------------------------------
    def prepare_cluster_assembly(self, cluster: HitCluster):
        """First half of Sample::assembleCluster (alignments.cpp:1429-1507):
        build per-segment flow problems. Returns None when the cluster is
        skipped entirely (too few reads), else a list of ("ref"|"seg",
        AsmTask) units."""
        cfg = self.cfg
        pu = getattr(cluster, "prep_units", None)
        if pu is not None:
            # fused native path: the clustering workers already ran the
            # admission test, built each unit's inputs, and queued the prep
            # jobs — just wrap the pending handles as AsmTasks
            admitted, unit_specs = pu
            if not admitted:
                return None
            units = []
            for (kind, strand, l, r, job) in unit_specs:
                task = AsmTask(strand=strand)
                if job:
                    task.pending = (job, None)
                    task.ref_id = cluster.ref_id
                units.append(("ref" if kind == 0 else "seg", task))
            return units
        if cluster.num_uniq() < cfg.min_read_for_assemb:
            return None
        units = []
        flat = getattr(cluster, "flat", None)
        if cluster.ref_mrnas and cfg.utilize_ref_models:
            cluster_left = min(r.left for r in cluster.ref_mrnas)
            cluster_right = max(r.right for r in cluster.ref_mrnas)
            ref_strand = cluster.ref_strand()
            if flat is not None:
                concat_flat = _fcl.concat_flat
                flatten_contigs = _fcl.flatten_contigs
                gather_flat = _fcl.gather_flat
                strands = cluster.valid_strands
                mask = (strands == STRAND_UNKNOWN) | (strands == ref_strand)
                sub = gather_flat(flat, mask)
                sub_mass = cluster.flat_mass[mask]
                refs_flat = flatten_contigs(cluster.ref_mrnas)
                full = concat_flat(refs_flat, sub)
                nref = len(cluster.ref_mrnas)
                cov_mass = np.concatenate([np.full(nref, -1.0), sub_mass])
                weight_mass = np.concatenate(
                    [np.array([r.mass for r in cluster.ref_mrnas],
                              np.float64), sub_mass])
                units.append(("ref", self.prepare_contig_task(
                    cluster_left, cluster_right, ref_strand,
                    flat_bundle=(full, cov_mass, weight_mass),
                    ref_id=cluster.ref_id)))
                return units
            hits: List[Contig] = []
            for r in cluster.ref_mrnas:
                rc = Contig(ref_id=r.ref_id, strand=r.strand, feats=r.feats,
                            mass=r.mass, is_ref=True, contig_id=0,
                            trans_id=r.trans_id, parent_id=r.parent_id,
                            ref_gene_id=r.ref_gene_id,
                            ref_gene_name=r.ref_gene_name)
                hits.append(rc)
            for h in cluster.uniq_hit_contigs():
                if (h.strand == STRAND_UNKNOWN or h.strand == ref_strand):
                    hits.append(h)
            units.append(("ref", self.prepare_contig_task(
                cluster_left, cluster_right, ref_strand, hits)))
            return units

        cluster.refine_cluster()
        if flat is not None:
            gather_flat = _fcl.gather_flat
            strands = cluster.valid_strands
            vpos = cluster.valid_positions
            n = cluster.size()
            for seg in cluster.segs:
                mask = ((vpos >= seg.left_read_idx)
                        & (vpos < min(seg.right_read_idx, n))
                        & ((strands == STRAND_UNKNOWN)
                           | (strands == seg.strand)))
                sub = gather_flat(flat, mask)
                sub_mass = cluster.flat_mass[mask]
                units.append(("seg", self.prepare_contig_task(
                    seg.left, seg.right, seg.strand,
                    flat_bundle=(sub, sub_mass, sub_mass),
                    ref_id=cluster.ref_id)))
            return units
        uniq_contigs = [cluster.pair_to_contig(ph) for ph in cluster.uniq_hits]
        for seg in cluster.segs:
            hits = []
            for r in range(seg.left_read_idx,
                           min(seg.right_read_idx, len(cluster.uniq_hits))):
                h = uniq_contigs[r]
                if h is None:
                    continue
                if h.strand == STRAND_UNKNOWN or h.strand == seg.strand:
                    hits.append(h)
            units.append(("seg", self.prepare_contig_task(
                seg.left, seg.right, seg.strand, hits)))
        return units

    def finish_cluster_assembly(self, cluster: HitCluster, units,
                                flows, log: TextIO) -> List[Contig]:
        """Second half: decompose solved flows, name transcripts, learn
        fragment lengths."""
        if units is None:
            return []
        result: List[Contig] = []
        if units and units[0][0] == "ref":
            assembled = self.finish_contig_task(units[0][1], flows[0])
            self.num_cluster += 1
            cluster.id = self.num_cluster
            for tid, asmb in enumerate(assembled, start=1):
                asmb.parent_id = f"{self.sample_name}.{cluster.id}"
                asmb.ref_gene_id = cluster.ref_mrnas[0].ref_gene_id
                asmb.ref_gene_name = cluster.ref_mrnas[0].ref_gene_name
                asmb.trans_id = f"{asmb.parent_id}.{tid}"
            nf = units[0][1].native_flat
            if assembled:
                self._af_parts.append(
                    nf if nf is not None
                    else _fcl.flatten_contigs(assembled))
            self.frag_len_dist(assembled, cluster, log, iso_flat=nf)
            return assembled
        flats = []
        for (_kind, task), fm in zip(units, flows):
            assembled = self.finish_contig_task(task, fm)
            self.num_cluster += 1
            cluster.id = self.num_cluster
            for tid, asmb in enumerate(assembled, start=1):
                asmb.parent_id = f"{self.sample_name}.{cluster.id}"
                asmb.trans_id = f"{asmb.parent_id}.{tid}"
            if assembled:
                flats.append(task.native_flat)  # None disables the fast path
            result.extend(assembled)
        iso_flat = None
        if result and all(f is not None for f in flats):
            iso_flat = _fcl.concat_flat_parts(flats)
        if result:
            self._af_parts.append(iso_flat if iso_flat is not None
                                  else _fcl.flatten_contigs(result))
        self.frag_len_dist(result, cluster, log, iso_flat=iso_flat)
        return result

    def assemble_cluster(self, cluster: HitCluster, log: TextIO
                         ) -> List[Contig]:
        """Sample::assembleCluster (alignments.cpp:1429-1507), host solve."""
        from .assembly.lemonns import network_simplex
        units = self._resolve_units(self.prepare_cluster_assembly(cluster))
        if units is None:
            return []
        flows = [network_simplex(t.fn.g, t.cost_map, t.min_flow_map)
                 if t.fn is not None else None for (_k, t) in units]
        return self.finish_cluster_assembly(cluster, units, flows, log)

    # ------------------------------------------------------------------
    def assemble_sample(self, log: TextIO):
        """Pass 1 (alignments.cpp:1658-1729)."""
        if self.cfg.device_batch:
            return self._assemble_batched(log)
        self.num_cluster = self.num_cluster_base
        for cluster in self.iter_clusters("refguide"):
            with PROF.phase("pass1_cluster"):
                asmb = self.assemble_cluster(cluster, log)
                self.assembly.extend(asmb)
                if not getattr(log, "is_null", False):
                    ref_name = self.table.ref_real_names[cluster.ref_id]
                    log.write(f"Inspect gene: {ref_name}:"
                              f"{cluster.leftmost}-{cluster.rightmost}\n")
                    log.write(f"Has inspected {self.total_mapped_reads} "
                              f"reads\n")
                if len(self._fld_specs) >= 128:
                    self._flush_fld_async()
        self._drain_fld()

    def _assemble_batched(self, log: TextIO):
        """Pass 1: prepare each cluster's flow problems on host, solve
        them with the lemon-exact NetworkSimplex (or, under
        STRAWB_DEVICE_MCF, as bucketed batches on the GPU), then finish in
        cluster order (ids, naming, fragment-length learning).

        Work drains in chunks as the cluster stream produces them, so the
        resolve/solve/finish Python work overlaps the native clustering of
        later chromosomes."""
        from .assembly.device import batched_mcf
        from .assembly.lemonns import network_simplex
        self.num_cluster = self.num_cluster_base
        collected = []

        def _drain():
            if not collected:
                return
            self._resolve_units_batch(collected)
            tasks = []
            index = []
            nsolved = 0
            for ci, (_cluster, units) in enumerate(collected):
                if not units:
                    continue
                for ui, (_k, task) in enumerate(units):
                    if task.native_txs is not None:
                        nsolved += 1  # solved on the native prep worker
                    elif task.fn is not None:
                        index.append((ci, ui))
                        tasks.append(task)
            if nsolved:
                self.flow_stats["native_ns"] = self.flow_stats.get(
                    "native_ns", 0) + nsolved
            # GOLDEN path: the lemon-exact NetworkSimplex — degenerate
            # optima must land on the reference's flow (realistic loci hit
            # equal-cost alternatives; see assembly/lemonns.py). The
            # batched device solve (assembly/device.batched_mcf) finds A
            # min-cost flow but not always lemon's on ties, so it is the
            # opt-in path (STRAWB_DEVICE_MCF=1). With it set, the native
            # prep workers ship the dense problems back unsolved
            # (core/fastcluster.native_solve_enabled).
            with PROF.phase("flow_dp", items=len(tasks)):
                if os.environ.get("STRAWB_DEVICE_MCF"):
                    flows_flat = batched_mcf([t.dense for t in tasks],
                                             stats=self.flow_stats)
                else:
                    flows_flat = [network_simplex(t.fn.g, t.cost_map,
                                                  t.min_flow_map)
                                  for t in tasks]
                    self.flow_stats["host_ns"] = self.flow_stats.get(
                        "host_ns", 0) + len(tasks)
            flowmap = dict(zip(index, flows_flat))
            for ci, (cluster, units) in enumerate(collected):
                flows = [flowmap.get((ci, ui))
                         for ui in range(len(units or []))]
                asmb = self.finish_cluster_assembly(cluster, units, flows,
                                                    log)
                self.assembly.extend(asmb)
                if not getattr(log, "is_null", False):
                    ref_name = self.table.ref_real_names[cluster.ref_id]
                    log.write(f"Inspect gene: {ref_name}:"
                              f"{cluster.leftmost}-{cluster.rightmost}\n")
                    log.write(f"Has inspected {self.total_mapped_reads} "
                              f"reads\n")
            collected.clear()

        for cluster in self.iter_clusters("refguide"):
            with PROF.phase("pass1_cluster"):
                collected.append((cluster,
                                  self.prepare_cluster_assembly(cluster)))
                if len(collected) >= 128:
                    _drain()
                    self._flush_fld_async()
        _drain()
        self._drain_fld()

    def pre_process(self, log: TextIO):
        """Pass 1 for --no-assembly (alignments.cpp:1189-1233)."""
        self.num_cluster = self.num_cluster_base
        for cluster in self.iter_clusters("refdemand"):
            with PROF.phase("pass1_cluster"):
                self.num_cluster += 1
                cluster.id = self.num_cluster
                self.frag_len_dist(cluster.ref_mrnas, cluster, log)
                if len(self._fld_specs) >= 128:
                    self._flush_fld_async()
        self._drain_fld()

    # ------------------------------------------------------------------
    def select_insert_size(self, verbose: bool = False):
        """driver() insert-size selection (Strawberry.cpp:329-356)."""
        self._drain_fld()  # defensive: direct per-cluster callers
        cfg = self.cfg
        mean, sd = cfg.insert_size_mean, cfg.insert_size_sd
        if not self.table.paired_end:
            mean, sd = cfg.single_end_default_insert
        if self.long_read_sample:
            return
        if mean != 0 and sd != 0:
            if verbose:
                sys.stderr.write(
                    f"Using user specified insert size mean: {_g(mean)}"
                    f" and standard deviation: {_g(sd)}\n")
            self.insert_dist = InsertSize(mean, sd)
        else:
            self.insert_dist = InsertSize(frag_lens=self.frag_dist,
                                          verbose=verbose)
            if verbose:
                sys.stderr.write(
                    "Using empirical insert size distribution \n")

    # ------------------------------------------------------------------
    def build_locus_context(self, cluster: HitCluster,
                            transcripts: List[Contig],
                            log: TextIO) -> LocusContext:
        hits = []
        for ph in cluster.uniq_hits:
            c = cluster.pair_to_contig(ph)
            if c is not None:
                hits.append(c)
            else:
                log.write("paired reads are not compatible\n")
        return LocusContext(self.cfg, self.read_len, self.insert_dist,
                            hits, transcripts,
                            long_read_sample=self.long_read_sample,
                            hit_flat=getattr(cluster, "flat", None))

    def quantify_cluster(self, cluster: HitCluster,
                         transcripts: List[Contig], log: TextIO
                         ) -> Tuple[List[Isoform], Optional[LocusContext]]:
        """Sample::quantifyCluster (alignments.cpp:1510-1546)."""
        est = self.build_locus_context(cluster, transcripts, log)
        success = est.estimate_abundances(self.total_mapped_reads, log)
        if success:
            return est.transcripts, est
        return [], None

    def _quantify_batched(self, log: TextIO,
                          fragfile: Optional[TextIO],
                          want_isoforms: bool = True) -> List[Isoform]:
        """Device-batched pass 2: build locus contexts on host (or, under
        STRAWB_DEVICE_PREP=all|budget, their integer half on the GPU),
        solve every locus EM as fixed-tier batched kernel launches on the
        GPU, then finalize FPKM/filters in cluster order. EM batches
        launch the moment they fill (launches are asynchronous), so the
        GPU solves EM while the host is still streaming clusters and
        prepping the next loci."""
        from .quant.device import LocusProblem, EmDispatcher
        from .quant.fastlocus import build_prebuilt_locus

        pending: List[Tuple[HitCluster, LocusContext]] = []
        use_fast = fragfile is None
        ref_flat = None
        if use_fast and self.factory.ref_mrnas:
            ref_flat = self.factory.ref_flat
            if ref_flat is None:
                try:
                    from .core.fastcluster import flatten_contigs
                    ref_flat = flatten_contigs(self.factory.ref_mrnas)
                except Exception:
                    ref_flat = None

        # fused quant prep: the clustering workers compute each locus's EM
        # inputs (quantprep.cc) as soon as its cluster is built. With
        # device prep enabled, the reads x isoforms integer kernels run on
        # the GPU instead (quant/device_prep.py) and the clustering workers
        # only cluster.
        fuse_quant = rexlen = None
        prep_state = None
        if use_fast and ref_flat is not None:
            from .quant.binweights import pdf_table
            off, code, _left, lens = ref_flat
            mlen = np.where(code == 0, lens.astype(np.int64), 0)
            cs = np.concatenate([np.zeros(1, np.int64), np.cumsum(mlen)])
            rexlen = cs[off[1:]] - cs[off[:-1]]
            if self.long_read_sample or self.insert_dist is None:
                tbl = np.zeros(1, np.float64)
                base_lmin = 0
            else:
                max_len = int(rexlen.max()) if len(rexlen) else 0
                tbl = getattr(self.insert_dist, "_pdf_table", None)
                if tbl is None or len(tbl) <= max_len:
                    tbl = pdf_table(self.insert_dist, max(max_len, 4096))
                    self.insert_dist._pdf_table = tbl
                base_lmin = self.insert_dist.start_offset \
                    if self.insert_dist.use_emp else self.read_len
            prep_mode = self._use_device_prep()
            if prep_mode != "off":
                from .quant.device_prep import PrepState
                prep_state = PrepState(ref_flat, rexlen, tbl, base_lmin,
                                       self.read_len, self.long_read_sample)
                if prep_mode == "budget":
                    from .routing import prep_granule
                    prep_state.budget_pairs = prep_granule()
                self.prep_stats = prep_state.stats
            else:
                fuse_quant = (self.read_len, ref_flat, rexlen, tbl,
                              base_lmin, self.long_read_sample)
        native_specs = []  # (index into pending, spec)
        # quantprep chunks run on a side thread (the native call releases
        # the GIL) so C++ bin/weight computation overlaps the cluster stream
        from concurrent.futures import ThreadPoolExecutor
        futures = []
        pool = ThreadPoolExecutor(max_workers=1) if use_fast else None
        chunk_start = 0
        dispatcher = EmDispatcher(fast_em=self.cfg.fast_em)
        fut_drained = 0

        def _em_add(i, est):
            n, alpha = est.build_problem()
            dispatcher.add(i, LocusProblem(counts=n, weights=alpha))

        def _drain_ready_futures(block=False):
            # feed completed quantprep chunks to the device EM dispatcher
            # while the cluster stream is still running
            nonlocal fut_drained
            while fut_drained < len(futures):
                entry = futures[fut_drained]
                chunk, fut = entry
                if not block and not fut.done():
                    return
                for (i, _), est in zip(chunk, fut.result()):
                    pending[i] = (pending[i][0], est)
                    _em_add(i, est)
                futures[fut_drained] = None  # free the specs (pool views)
                fut_drained += 1

        dev_pool = dev_fut = None

        def _flush():
            nonlocal chunk_start, dev_pool, dev_fut
            chunk = native_specs[chunk_start:]
            if not chunk:
                return
            # free the consumed slots (the chunk list keeps the specs —
            # and with them the cluster pools — alive only until its
            # future drains, instead of for the whole pass)
            native_specs[chunk_start:] = [None] * len(chunk)
            chunk_start = len(native_specs)
            if prep_state is not None and prep_state.budget_pairs is None:
                # "all" mode: every eligible locus on the GPU
                from .quant.device_prep import build_batch_device
                futures.append((chunk, pool.submit(
                    build_batch_device, self.cfg, self.read_len,
                    self.insert_dist, [s for _, s in chunk], prep_state,
                    self.long_read_sample)))
                _drain_ready_futures()
                return
            if prep_state is not None and (dev_fut is None
                                           or dev_fut.done()):
                # self-pacing offload: carve one granule of (hit x iso)
                # pairs for the GPU only when it is idle, so device prep
                # runs concurrently with the host batches and never blocks
                # the critical path
                from .quant.device_prep import build_batch_device
                granule = prep_state.budget_pairs
                acc = 0
                ndev = 0
                for (_i, s) in chunk:
                    p = (len(s[0][0]) - 1) * (len(s[4])
                                              if s[4] is not None else 0)
                    if ndev and acc + p > granule:
                        break
                    acc += p
                    ndev += 1
                dev_chunk, chunk = chunk[:ndev], chunk[ndev:]
                if dev_chunk:
                    if dev_pool is None:
                        from concurrent.futures import ThreadPoolExecutor
                        dev_pool = ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="dev-prep")
                    dev_fut = dev_pool.submit(
                        build_batch_device, self.cfg, self.read_len,
                        self.insert_dist, [s for _, s in dev_chunk],
                        prep_state, self.long_read_sample)
                    futures.append((dev_chunk, dev_fut))
            if chunk:
                from .quant.fastlocus import build_batch_native
                if prep_state is not None:  # honest device_frac denominator
                    prep_state.stats["host_loci"] += len(chunk)
                futures.append((chunk, pool.submit(
                    build_batch_native, self.cfg, self.read_len,
                    self.insert_dist, [s[:4] for _, s in chunk],
                    long_read_sample=self.long_read_sample)))
            _drain_ready_futures()

        # vectorized finalize: skip per-locus LocusContext/Isoform churn
        # when nothing needs the per-isoform objects until after EM (null
        # log, default normalization) — the array math below reproduces
        # finalize_abundances bit-for-bit (validated by the realistic
        # byte-parity run, which takes this path)
        vec_ok = (getattr(log, "is_null", False)
                  and not self.cfg.effective_len_norm)
        # raw-slice host EM: the whole per-locus preamble (trunc, total,
        # row filter, theta0) runs inside one chunked native call instead
        # of 18k+ small numpy ops on the stream's critical path
        from .quant.device import host_em_raw_available, host_em_batch_raw
        use_raw = dispatcher.force_host and host_em_raw_available()
        raw_pend: List[tuple] = []   # (pending idx, counts, alpha, niso)
        raw_futs: List[tuple] = []   # (idxs, future)
        raw_pool = None

        def _flush_raw():
            # each chunk ships to a side thread (the native call releases
            # the GIL) so the EM overlaps the cluster stream; the chunk
            # list keeps the partition pool views alive only until then
            nonlocal raw_pool
            if not raw_pend:
                return
            if raw_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                raw_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="em-raw")
            idxs = [r[0] for r in raw_pend]
            cs = [r[1] for r in raw_pend]
            als = [r[2] for r in raw_pend]
            ns = [r[3] for r in raw_pend]
            raw_futs.append((idxs, raw_pool.submit(
                host_em_batch_raw, cs, als, ns)))
            raw_pend.clear()

        for cluster in self.iter_clusters("refdemand", fuse_quant=fuse_quant):
            with PROF.phase("locus_context"):
                qp = getattr(cluster, "quant_prebuilt", None)
                if qp is not None and vec_ok and use_raw:
                    ids = cluster.ref_indices
                    raw_pend.append((len(pending), qp[0], qp[1], len(ids)))
                    pending.append(("vec", ids))
                    if len(raw_pend) >= 2048:
                        _flush_raw()
                elif qp is not None and vec_ok:
                    ids = cluster.ref_indices
                    counts = np.trunc(qp[0])
                    alpha = np.array(qp[1], np.float64).reshape(
                        len(counts), len(ids))
                    dispatcher.add(len(pending), LocusProblem(
                        counts=counts, weights=alpha))
                    pending.append(("vec", ids))
                elif qp is not None:
                    exl = [rexlen[i] for i in cluster.ref_indices]
                    est = build_prebuilt_locus(
                        self.cfg, self.read_len, self.insert_dist,
                        cluster.ref_mrnas, exl, qp[0], qp[1])
                    _em_add(len(pending), est)
                    pending.append((None, est))
                elif use_fast and getattr(cluster, "flat", None) is not None:
                    iso_flat = _fcl.take_flat(ref_flat, cluster.ref_indices) \
                        if ref_flat is not None and \
                        getattr(cluster, "ref_indices", None) is not None \
                        else _fcl.flatten_contigs(cluster.ref_mrnas)
                    native_specs.append(
                        (len(pending), (cluster.flat, cluster.flat_mass,
                                        cluster.ref_mrnas, iso_flat,
                                        getattr(cluster, "ref_indices",
                                                None))))
                    # keep the cluster object (and with it the partition's
                    # pool arrays) only when the fragment-context export
                    # needs it; otherwise the pool frees as the stream moves
                    pending.append((None, None))
                    if len(native_specs) - chunk_start >= 128:
                        _flush()
                else:
                    est = self.build_locus_context(cluster,
                                                   cluster.ref_mrnas, log)
                    _em_add(len(pending), est)
                    pending.append((cluster if fragfile is not None
                                    else None, est))
        if native_specs:
            # (specs only exist when the native clusterizer produced flat
            # arrays, so the native quant batch is always available here)
            with PROF.phase("quant_native", items=len(native_specs)):
                _flush()
                _drain_ready_futures(block=True)
        if pool is not None:
            pool.shutdown(wait=False)
        if dev_pool is not None:
            dev_pool.shutdown(wait=False)

        _flush_raw()
        with PROF.phase("em_finish", items=len(pending)):
            thetas = dispatcher.finish()
            thetas.extend([None] * (len(pending) - len(thetas)))
        n_raw_ok = 0
        with PROF.phase("host_em_wait",
                        items=sum(len(i) for i, _f in raw_futs)):
            raw_done = [(idxs, *f.result()) for idxs, f in raw_futs]
        if raw_pool is not None:
            raw_pool.shutdown(wait=False)
        for idxs, th, to, st in raw_done:
            for m, idx in enumerate(idxs):
                if st[m]:
                    thetas[idx] = th[to[m]:to[m + 1]]
                    n_raw_ok += 1
        self.em_stats = {"device": dispatcher.n_device,
                         "host": dispatcher.n_host + n_raw_ok,
                         "init_failed": len(pending) - dispatcher.n_device
                         - dispatcher.n_host - n_raw_ok,
                         "tiers": dispatcher.tier_counts}

        per_entry: List[Optional[List[Isoform]]] = []
        vec_rows: List[Tuple[int, object, object]] = []  # (entry, ids, th)
        has_nonvec = False
        for (cluster, est), theta in zip(pending, thetas):
            if cluster == "vec":
                if theta is None:
                    per_entry.append([])
                    continue
                vec_rows.append((len(per_entry), est, theta))
                per_entry.append(None)  # filled by the vector pass
                continue
            if theta is None:
                per_entry.append([])
                continue  # EM init failed: no surviving bins
            est.finalize_abundances(theta, self.total_mapped_reads, log)
            per_entry.append(list(est.transcripts))
            has_nonvec = has_nonvec or bool(est.transcripts)
            if fragfile is not None:
                from .quant.fragcontext import print_context
                fa = self._chrom_fasta(cluster.ref_id)
                print_context(self, est, cluster, fragfile, fa_getter=fa,
                              bias_correction=self.cfg.bias_correction)
        if vec_rows:
            if (not want_isoforms and fragfile is None and not has_nonvec
                    and self.factory.ref_flat is not None
                    and _fcl.native_gtf_emit_available()):
                # bytes-only finalize: skip the Isoform objects entirely;
                # proc_sample formats the GTF natively from the arrays
                gids, fpkm, frac, keep, _L, _off = \
                    self._finalize_vec_arrays(vec_rows, rexlen)
                self._vec_emit = (gids[keep], fpkm[keep], frac[keep])
                return []
            self._finalize_vec(vec_rows, rexlen, per_entry)
        isoforms: List[Isoform] = []
        for lst in per_entry:
            isoforms.extend(lst or [])
        return isoforms

    def _finalize_vec_arrays(self, vec_rows, rexlen):
        """Shared array math of the vectorized finalize_abundances
        (ref: estimate.cpp:315-355). Bit-identical to the scalar path: the
        elementwise ops use the same operands in the same order, and the
        per-locus FPKM sums run sequentially via the masked j-loop.
        Returns (gids, fpkm, frac, keep, L, off) in vec_rows order."""
        cfg = self.cfg
        L = np.fromiter((len(ids) for (_e, ids, _t) in vec_rows),
                        np.int64, len(vec_rows))
        off = np.zeros(len(vec_rows) + 1, np.int64)
        np.cumsum(L, out=off[1:])
        gids = np.concatenate(
            [np.asarray(ids, np.int64) for (_e, ids, _t) in vec_rows])
        th = np.concatenate(
            [np.asarray(t, np.float64) for (_e, _ids, t) in vec_rows])
        lens_v = np.asarray(rexlen, np.int64)[gids]
        rpm = 1e6 / self.total_mapped_reads
        kb = 1e3 / lens_v
        fpkm = (th * rpm) * kb
        # per-locus sequential sums (identical accumulation order)
        acc = np.zeros(len(vec_rows), np.float64)
        maxn = int(L.max()) if len(L) else 0
        for j in range(maxn):
            m = L > j
            idx = off[:-1][m] + j
            acc[m] = acc[m] + fpkm[idx]
        denom = np.repeat(np.where(acc != 0.0, acc, np.nan), L)
        frac = fpkm / denom
        if cfg.filter_by_expression:
            keep = ~(frac < cfg.min_isoform_frac)
        else:
            keep = np.ones(len(fpkm), bool)
        return gids, fpkm, frac, keep, L, off

    def _finalize_vec(self, vec_rows, rexlen, per_entry):
        """Isoform-object finalize over the shared vectorized math (used
        when a caller needs the per-isoform objects: fragment context,
        sharded TPM merges)."""
        refs = self.factory.ref_mrnas
        gids, fpkm, frac, keep, L, off = self._finalize_vec_arrays(
            vec_rows, rexlen)
        lens_v = np.asarray(rexlen, np.int64)[gids]
        gl = gids.tolist()
        ll = lens_v.tolist()
        fl = fpkm.tolist()
        frl = frac.tolist()
        kl = keep.tolist()
        offl = off.tolist()
        for k, (entry, _ids, _t) in enumerate(vec_rows):
            out: List[Isoform] = []
            for pos, p in enumerate(range(offl[k], offl[k + 1])):
                if not kl[p]:
                    continue
                r = refs[gl[p]]
                iso = Isoform(contig=r, length=ll[p],
                              gene_str=r.parent_id, isoform_str=r.trans_id,
                              ref_gene_id=r.ref_gene_id,
                              ref_gene_name=r.ref_gene_name,
                              frac=frl[p], fpkm=fl[p],
                              frac_s=c_str(frl[p]), fpkm_s=c_str(fl[p]),
                              id=pos)
                out.append(iso)
            per_entry[entry] = out

    def _chrom_fasta(self, ref_id: int):
        if self.fasta is None or ref_id < 0:
            return None
        name = self.table.ref_real_names[ref_id]
        if not self.fasta.load_chrom(name):
            return None
        return self.fasta

    def vec_emit_render(self, total_fpkm: float) -> bytes:
        """Render the deferred vec-finalize arrays to GTF bytes with the
        given global FPKM total (sharded runs reduce the total across
        shards first; single-process passes its own sequential sum)."""
        rows, fpkm, frac = self._vec_emit
        self._vec_emit = None
        refs = self.factory.ref_mrnas
        if total_fpkm != 0:
            tpm = (1e6 * fpkm) / total_fpkm
        else:
            tpm = np.full(len(fpkm), np.nan)
        n = len(refs)
        strand = np.fromiter((r.strand for r in refs), np.int8, n)
        chrom = np.fromiter((r.ref_id for r in refs), np.int32, n)
        blob = _fcl.native_gtf_emit(
            rows, self.factory.ref_flat, strand, chrom,
            "\n".join(self.table.ref_real_names),
            "\n".join(r.parent_id for r in refs),
            "\n".join(r.trans_id for r in refs),
            "\n".join(r.ref_gene_id for r in refs),
            "\n".join(r.ref_gene_name for r in refs),
            fpkm, frac, tpm)
        return blob

    def _emit_vec_native(self, out: TextIO) -> None:
        """Format + write the whole GTF natively from the vec-finalize
        arrays (gtfemit.cc; byte-twin of io/gtfwriter.print2gtf). Global
        TPM uses the same naive sequential FPKM accumulation as the
        object path (alignments.cpp:1821-1829)."""
        total_fpkm = 0.0
        for v in self._vec_emit[1].tolist():  # left-to-right, like the
            total_fpkm += v                   # object loop
        out.write(self.vec_emit_render(total_fpkm).decode())

    def proc_sample(self, out: TextIO, log: TextIO,
                    fragfile: Optional[TextIO] = None,
                    want_isoforms: bool = True,
                    defer_vec_emit: bool = False):
        """Pass 2 (alignments.cpp:1736-1835). With defer_vec_emit, a
        fully-vectorized finalize leaves its arrays in self._vec_emit for
        the caller to render (sharded runs reduce the FPKM total first);
        otherwise the GTF is written to `out` here."""
        self.factory.reset_cursor()
        # reset_refmRNAs (alignments.cpp:1091-1101)
        if not self.cfg.no_assembly:
            flat = None
            if self._af_parts and sum(
                    len(p[0]) - 1 for p in self._af_parts) == len(
                    self.assembly):
                flat = _fcl.concat_flat_parts(self._af_parts)
            self._af_parts = []
            if flat is not None:
                refs, flat = _fcl.sort_contigs_flat(self.assembly, flat)
            else:
                refs = sort_contigs(self.assembly)
            self.assembly = []
            self.factory.set_ref_mrnas(refs, flat=flat)
        else:
            self.factory.refmrna_offset = 0
            self.factory.has_load_all_refs = False
        if self._read_diags:
            # pass-2 re-decode diagnostics (the reference streams the BAM
            # again through getHitFromBuf during procSample)
            c2, ex2 = _decode_pass_counts(self.table, self.cfg,
                                          self.factory.ref_mrnas,
                                          "refdemand")
            _emit_read_diags(self._read_diags, counts=c2, exhausted=ex2)
            self._read_diags = None

        isoforms: List[Isoform] = []
        if self.cfg.device_batch:
            isoforms = self._quantify_batched(log, fragfile,
                                              want_isoforms=want_isoforms)
            if self._vec_emit is not None:
                if defer_vec_emit:
                    return []  # caller renders via vec_emit_render
                self._emit_vec_native(out)
                return []
        else:
            for cluster in self.iter_clusters("refdemand"):
                iso, est = self.quantify_cluster(cluster, cluster.ref_mrnas,
                                                 log)
                if fragfile is not None and est is not None:
                    from .quant.fragcontext import print_context
                    fa = self._chrom_fasta(cluster.ref_id)
                    print_context(self, est, cluster, fragfile, fa_getter=fa,
                                  bias_correction=self.cfg.bias_correction)
                isoforms.extend(iso)

        total_fpkm = 0.0
        for iso in isoforms:
            total_fpkm += iso.fpkm
        for iso in isoforms:  # global (not per-locus) TPM, alignments.cpp:1821
            iso.tpm = 1e6 * iso.fpkm / total_fpkm if total_fpkm != 0 \
                else float("nan")
            iso.tpm_s = c_str(iso.tpm)
        for iso in isoforms:
            ref_name = self.table.ref_real_names[iso.contig.ref_id] \
                if iso.contig.ref_id >= 0 else "?"
            print2gtf(out, iso.contig, ref_name, iso.fpkm_s, iso.frac_s,
                      iso.tpm_s, iso.gene_str, iso.isoform_str,
                      iso.ref_gene_id, iso.ref_gene_name)
        return isoforms


def _gene_barriers(refs, flat=None, pad: int = 50):
    """Padded merged annotation-GENE intervals per chromosome — the
    no-split zones for low-mem sub-chromosome block cutting (a split
    inside one could scatter an annotation cluster's hits across two
    decode blocks). Spans are per GENE (parent_id), not per transcript:
    a gene with disjoint transcripts must stay in one block, or the
    dispatcher's linked-gene chain-merge would have to hold an unbounded
    run of sub-chromosome blocks (a deadlock against the low-mem
    retained-bytes cap). Returns (chrom i32, left i64, right i64)
    arrays, sorted and non-overlapping within each chromosome."""
    n = len(refs)
    if n == 0:
        return None
    rref = np.fromiter((r.ref_id for r in refs), np.int64, n)
    if flat is not None and len(flat[0]) - 1 == n:
        off, _code, left, lens = flat
        e = off[1:] - 1
        rleft = left[off[:-1]].astype(np.int64)
        rright = (left[e] + lens[e] - 1).astype(np.int64)
    else:
        rleft = np.fromiter((r.left for r in refs), np.int64, n)
        rright = np.fromiter((r.right for r in refs), np.int64, n)
    # widen each transcript to its gene's full span
    spans: dict = {}
    rr = rref.tolist()
    rl = rleft.tolist()
    rrt = rright.tolist()
    for i, r in enumerate(refs):
        key = (rr[i], r.parent_id)
        s = spans.get(key)
        if s is None:
            spans[key] = [rl[i], rrt[i]]
        else:
            if rl[i] < s[0]:
                s[0] = rl[i]
            if rrt[i] > s[1]:
                s[1] = rrt[i]
    gl_ = spans
    for i, r in enumerate(refs):
        s = gl_[(rr[i], r.parent_id)]
        rl[i] = s[0]
        rrt[i] = s[1]
    rleft = np.asarray(rl, np.int64)
    rright = np.asarray(rrt, np.int64)
    rleft = np.maximum(rleft - pad, 0)
    rright = rright + pad
    # per-chromosome interval merge via a chrom-offset key (refs are
    # sorted by (ref_id, left))
    SHIFT = 44
    kl = (rref << SHIFT) + rleft
    kr = (rref << SHIFT) + rright
    order = np.argsort(kl, kind="stable")  # defensive: -1 ref_ids first
    kl, kr = kl[order], kr[order]
    runmax = np.maximum.accumulate(kr)
    new = np.ones(n, bool)
    new[1:] = kl[1:] > runmax[:-1]
    starts = np.flatnonzero(new)
    gl = kl[starts]
    gr = np.maximum.reduceat(kr, starts)
    mask = (1 << SHIFT) - 1
    keep = (gl >> SHIFT) >= 0  # drop unmatched (-1) chromosomes
    gl, gr = gl[keep], gr[keep]
    return ((gl >> SHIFT).astype(np.int32),
            (gl & mask).astype(np.int64), (gr & mask).astype(np.int64))


def _trace_columns(table):
    """Random-access column table for the decode-trace simulation (a
    plain HitTable passes through; a drained streaming table concatenates
    its blocks; a low-mem stream has dropped them -> None)."""
    from .io.sbam import StreamingHitTable
    if not isinstance(table, StreamingHitTable):
        return table
    if table.low_mem:
        return None
    try:
        nb = table.num_blocks()
        tabs = [table.block_table(k) for k in range(nb)]
    except Exception:
        return None
    from .io.bamreader import HitTable
    n = sum(len(tt) for tt in tabs)

    def cat(attr, dtype):
        if not tabs:
            return np.zeros(0, dtype)
        return np.concatenate([getattr(tt, attr) for tt in tabs])

    return HitTable(
        ref_id=cat("ref_id", np.int32), left=cat("left", np.int64),
        right=cat("right", np.int64), strand=cat("strand", np.int8),
        flag=cat("flag", np.uint16), mate_ref=cat("mate_ref", np.int32),
        mate_pos=cat("mate_pos", np.int64), nh=cat("nh", np.int32),
        read_id=cat("read_id", np.uint64),
        cigar_hash=cat("cigar_hash", np.uint64),
        feat_off=np.zeros(n + 1, np.int64),  # feats unused by the trace
        feat_code=np.zeros(0, np.int8), feat_left=np.zeros(0, np.int64),
        feat_len=np.zeros(0, np.int32), ref_names=table.ref_names,
        ref_real_names=table.ref_real_names, ref_lens=table.ref_lens,
        read_len_hist={}, paired_end=True)


def _decode_pass_counts(table, cfg: Config, refs, mode: str):
    """Simulate one reference pass's record cursor (the oracle cluster
    iterators carry the exact rewind semantics of nextCluster_refGuide /
    nextClusterRefDemand, alignments.cpp:1103-1286) and return
    (per-accepted-row decode counts, cursor-exhausted flag). A hit that
    starts the next cluster is decoded again after its rewind, so its -v
    diagnostics print once per decode — the counts reproduce that
    multiplicity. None = simulation unavailable (low-mem stream)."""
    from dataclasses import replace as _dc_replace
    from .core.cluster import ClusterFactory, HitCluster
    t = _trace_columns(table)
    if t is None:
        return None, True
    if mode == "refdemand" and not refs:
        return np.zeros(len(t), np.int32), False
    qcfg = _dc_replace(cfg, verbose=False)  # no duplicate bounds cerr
    f = ClusterFactory(t, qcfg)
    f.set_ref_mrnas(list(refs))
    counts = np.zeros(len(t), np.int32)
    f.decode_counts = counts
    while True:
        c = HitCluster(qcfg)
        c.trace_only = True
        rc = (f.next_cluster_refguide(c) if mode == "refguide"
              else f.next_cluster_ref_demand(c))
        if rc == -1:
            break
    return counts, f.cursor >= len(t)


def _emit_read_diags(events, cap: Optional[int] = None,
                     counts=None, exhausted: bool = True) -> None:
    """Replay the decode-captured per-read -v diagnostics to stderr
    (read.cpp:611-614,679-684). With `cap`, only events seen before the
    cap-th accepted hit — the reference's inspect_read_len window (a
    linear scan: every line once). With `counts` (from
    _decode_pass_counts), accepted-row events repeat once per decode and
    consumed rejects print iff the pass's cursor reached them."""
    if not events:
        return
    lines = []
    n_ev = len(events)
    nrows = len(counts) if counts is not None else 0
    for j, (row, kind, name) in enumerate(events):
        if cap is not None and row >= cap:
            break
        line = (f"read {name} has unmapped pair\n" if kind == 0
                else f"Ignoring read {name} has multiple hits\n")
        if counts is None:
            lines.append(line)
            continue
        on_reject = kind == 1 or (j + 1 < n_ev and events[j + 1][0] == row
                                  and events[j + 1][1] == 1
                                  and events[j + 1][2] == name)
        if not on_reject:
            mult = int(counts[row]) if row < nrows else 0
        elif row < nrows:
            # rejected records are consumed (never rewound); they decode
            # once iff the pass read up to the next accepted row
            mult = 1 if counts[row] > 0 else 0
        else:
            mult = 1 if exhausted else 0  # trailing rejects after EOF hunt
        lines.extend([line] * mult)
    sys.stderr.write("".join(lines))


def _heap(when: str) -> dict:
    """What the process's heap holds (malloctune.heap), keys prefixed."""
    from .utils.malloctune import heap
    return {f"{when}_{k}": v for k, v in heap().items()}


def _end_run(heap: dict) -> None:
    """run_driver's end: the heap beside what its start found (PROF.heap,
    the -v report's line; the args of the trace's heap range), then the
    trace stops."""
    heap.update(_heap("end"))
    PROF.heap = heap
    PROF.annotate("heap", heap)
    PROF.stop_trace()


def run_driver(bam_path: str, cfg: Config, out: TextIO,
               log: Optional[TextIO] = None,
               fragfile: Optional[TextIO] = None,
               cmdline: str = "") -> Optional[Sample]:
    """driver() (Strawberry.cpp:237-371), with the device work on the GPU.
    Returns the Sample, except on the forked -p path (the work lives in
    the shard workers; the parent has no table) where it returns None."""
    from .utils.malloctune import tune, cap_blas_threads, tune_gc
    tune()
    cap_blas_threads()
    tune_gc()
    log = log or _NullLog()
    if cfg.verbose:
        from .utils import profiling
        profiling.enable()
        # native decoders capture the per-read cerr diagnostics
        # (read.cpp:611-614,679-684) when this is set; replayed below
        os.environ["STRAWB_VERBOSE"] = "1"
    else:
        os.environ.pop("STRAWB_VERBOSE", None)
    multiproc = cfg.num_threads > 1 and not cfg.no_quant
    PROF.start_trace(cuda=not multiproc)  # -p: no CUDA before the forks
    with PROF.phase("heap"):
        heap = _heap("start")
    if multiproc:
        # -p N: forked shard workers, each inflating only its own BGZF
        # block span (no parent-side decode). Falls back to the COW-table
        # variant below when the native span decoder is unavailable.
        try:
            from .io.native import get_lib
            get_lib()
            from .parallel.multiproc import run_multiprocess_ranged
            with PROF.phase("multiprocess_pipeline"):
                nrows = run_multiprocess_ranged(
                    bam_path, cfg, out, n_procs=cfg.num_threads,
                    fragfile=fragfile)
            _end_run(heap)
            if cfg.verbose:
                sys.stderr.write(PROF.report(total_reads=nrows) + "\n")
            return None
        except OSError:
            pass
    # the GTF parse AND the ref-Contig build are independent of the main
    # thread's decode consumption; run both on a side thread while the
    # native decoder (which releases the GIL for the duration of the
    # ctypes call) chews through the BAM. The Contig build needs the BAM
    # header's name->id map, delivered via name2id_box + event once the
    # stream opens.
    gtf_thread = gtf_box = name2id_evt = None
    name2id_box = {}
    if cfg.ref_gtf_filename:
        import threading
        gtf_box = {}
        name2id_evt = threading.Event()

        def _read_gtf():
            try:
                reader = None
                with PROF.phase("gtf_parse"):
                    try:
                        from .io.gff import parse_native
                        reader = parse_native(cfg.ref_gtf_filename)
                    except OSError:
                        r = GffReader(cfg.ref_gtf_filename)
                        r.read_all()
                        reader = r
                name2id_evt.wait()
                name2id = name2id_box.get("m")
                if name2id is None:
                    gtf_box["reader"] = reader  # main thread will load
                    return
                with PROF.phase("gtf_ref_build"):
                    if isinstance(reader, GffReader):
                        gtf_box["refs"] = (load_ref_mrnas(reader, name2id),
                                           None)
                    else:
                        from .io.gff import load_ref_mrnas_native
                        gtf_box["refs"] = load_ref_mrnas_native(
                            reader, name2id, return_flat=True)
            except Exception as e:  # surfaced on the main thread below
                gtf_box["error"] = e
        gtf_thread = threading.Thread(target=_read_gtf, daemon=True)
        gtf_thread.start()
    table = None
    if not multiproc and cfg.stream_decode and cfg.native_cluster:
        # streaming decode: the BAM inflate+parse runs on a background
        # pipeline and pass-1 clustering consumes chromosome blocks as they
        # finalize, so decode wall time overlaps the pipeline instead of
        # being a serial phase (and decode memory is O(window))
        try:
            from .io.sbam import open_bam_stream
            with PROF.phase("bam_open_stream"):
                table = open_bam_stream(bam_path, cfg, low_mem=cfg.low_mem,
                                        defer_start=True)
        except OSError:
            table = None  # native lib unavailable
    if table is None:
        with PROF.phase("bam_decode"):
            try:
                from .io.native import load_bam_native
                table = load_bam_native(bam_path, cfg)
            except Exception:
                table = load_bam(bam_path, cfg)  # portable fallback
    if gtf_thread is not None:
        # release the side thread's ref build now that the header is known
        name2id_box["m"] = {n: i
                            for i, n in enumerate(table.ref_names)}
        name2id_evt.set()
    from .io.sbam import StreamingHitTable as _SHT
    if isinstance(table, _SHT) and not table._started:
        barriers = None
        if cfg.low_mem and gtf_thread is not None:
            # sub-chromosome block splits must respect annotation gene
            # spans; low-mem serializes the GTF ref build before decode
            gtf_thread.join()
            if "refs" in gtf_box:
                barriers = _gene_barriers(*gtf_box["refs"],
                                          pad=cfg.max_olap_dist)
        table.start(barriers)
    sample = Sample(table, cfg, bam_path)
    if gtf_thread is not None:
        gtf_thread.join()
        if "error" in gtf_box:
            raise gtf_box["error"]
        if "refs" in gtf_box:
            refs, flat = gtf_box["refs"]
            sample.factory.set_ref_mrnas(refs, flat=flat)
        else:
            sample.load_ref_gtf(cfg.ref_gtf_filename,
                                reader=gtf_box["reader"])
    sample.long_read_sample = table.is_long_read_sample(cfg.long_read_len) \
        or cfg.long_read_sample
    if cfg.bias_correction and cfg.ref_fasta_file:
        from .io.fasta import FastaInterface
        sample.fasta = FastaInterface(cfg.ref_fasta_file)

    if multiproc:
        # reference's -p thread pool -> forked shard workers
        from .parallel.multiproc import run_multiprocess
        with PROF.phase("multiprocess_pipeline", items=len(table)):
            run_multiprocess(table, cfg, bam_path, out, log,
                             n_procs=cfg.num_threads)
        _end_run(heap)
        if cfg.verbose:
            sys.stderr.write(PROF.report(total_reads=len(table)) + "\n")
        return sample

    # len() on a streaming table blocks until EOF; don't force it pre-pass
    from .io.sbam import StreamingHitTable
    n_known = 0 if isinstance(table, StreamingHitTable) else len(table)
    if cfg.verbose:
        # Strawberry.cpp:305-310 cerr diagnostics
        sys.stderr.write("Inspecting sample......\n"
                         f"read len mode: {sample.read_len}\n")
    with PROF.phase("pass1_assemble", items=n_known):
        if cfg.no_assembly:
            sample.pre_process(log)
        else:
            sample.assemble_sample(log)

    read_diags = None
    if cfg.verbose:
        # the reference decodes the BAM once for inspect_read_len (the
        # first max_read_num_4_rl accepted hits) and once per pass, and
        # getHitFromBuf prints its per-read diagnostics on every decode
        # (read.cpp:611-614,679-684); we decode once and replay the
        # captured events with the same per-pass multiplicity. Captured
        # here, after pass 1 drained the stream (a reopened low-mem
        # stream would block on its own EOF otherwise).
        try:
            read_diags = table.diag_events
        except Exception:
            read_diags = None
        _emit_read_diags(read_diags, cap=cfg.max_read_num_4_rl)  # inspect
        if read_diags:
            c1, ex1 = _decode_pass_counts(
                table, cfg, sample.factory.ref_mrnas,
                "refdemand" if cfg.no_assembly else "refguide")
            _emit_read_diags(read_diags, counts=c1, exhausted=ex1)  # pass 1
        sample._read_diags = read_diags  # pass-2 replay (proc_sample)

    if cfg.no_quant:
        for iso in sample.assembly:
            ref_name = table.ref_real_names[iso.ref_id] \
                if iso.ref_id >= 0 else "?"
            print2gtf(out, iso, ref_name, "", "", "", iso.parent_id,
                      iso.trans_id, iso.ref_gene_id, iso.ref_gene_name)
        _end_run(heap)
        return sample

    if cfg.verbose:
        sys.stderr.write("Total number of mapped reads is: "
                         f"{sample.total_mapped_reads}\n")
    if sample.long_read_sample:
        sys.stderr.write("Invoking long read workflow\n")
    from .core.insert_size import NotEnoughReads
    try:
        sample.select_insert_size(verbose=cfg.verbose)
    except NotEnoughReads:
        # reference: "Not enough reads" + exit(0) (read.cpp:241-245)
        sys.stderr.write("Not enough reads\nExit program...\n")
        _end_run(heap)
        return sample
    if fragfile is not None:
        from .quant.fragcontext import FRAG_HEADER
        fragfile.write("\t".join(FRAG_HEADER) + "\n")
    if cfg.low_mem:
        # release pass 1's transient heap (tune() disables auto-trimming)
        import gc
        gc.collect()
        from .utils.malloctune import trim
        trim()
    if isinstance(table, StreamingHitTable) and cfg.low_mem:
        # pass 1 dropped its blocks as it consumed them; re-decode for
        # pass 2 (the reference's bgzf_seek rewind, src/read.cpp:1740)
        sample.table = table = table.reopen()
    with PROF.phase("pass2_quant",
                    items=0 if isinstance(table, StreamingHitTable)
                    and cfg.low_mem else len(table)):
        # single-process direct output: the per-isoform objects are only
        # an intermediate for the GTF bytes — let pass 2 skip them
        sample.proc_sample(out, log, fragfile, want_isoforms=False)
    _end_run(heap)
    if cfg.verbose:
        sys.stderr.write(PROF.report(total_reads=len(table)) + "\n")
    return sample
