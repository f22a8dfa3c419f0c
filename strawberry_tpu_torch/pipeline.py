"""Two-pass pipeline driver with the device work on the GPU.

The counterpart of strawberry_tpu/pipeline.py. Everything on the main path
except the device dispatches is host code the two packages share:
`TorchSample` inherits strawberry_tpu's `Sample` and overrides only the two
methods whose originals import the JAX device modules.

- `_assemble_batched` solves the flow problems with the host
  NetworkSimplex, or, under STRAWB_DEVICE_MCF, with the port's batched
  min-cost flow (strawberry_tpu_torch.assembly.device).
- `_quantify_batched` takes its EM dispatcher from
  strawberry_tpu_torch.quant.device and, under STRAWB_DEVICE_PREP=all|budget,
  its device quant prep from strawberry_tpu_torch.quant.device_prep.
- `run_driver` is the original building a `TorchSample`; the forked `-p`
  workers and the STRAWB_TRACE_DIR profiler trace are not ported yet.

Both methods are kept close to the originals so they can be diffed
against them.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, TextIO, Tuple

import numpy as np

from strawberry_tpu.config import Config
from strawberry_tpu.core import fastcluster as _fcl
from strawberry_tpu.core.cluster import HitCluster
from strawberry_tpu.io.bamreader import load_bam
from strawberry_tpu.io.gff import GffReader, load_ref_mrnas
from strawberry_tpu.io.gtfwriter import print2gtf
from strawberry_tpu.pipeline import (Sample, _NullLog, _decode_pass_counts,
                                     _emit_read_diags, _gene_barriers)
from strawberry_tpu.quant.locus import Isoform, LocusContext
from strawberry_tpu.utils.profiling import GLOBAL as PROF


class TorchSample(Sample):
    """strawberry_tpu's Sample with the device work dispatched to the
    GPU."""

    def _assemble_batched(self, log: TextIO):
        """Pass 1: prepare each cluster's flow problems on host, solve
        them with the lemon-exact NetworkSimplex (or, under
        STRAWB_DEVICE_MCF, as bucketed batches on the GPU), then finish in
        cluster order (ids, naming, fragment-length learning).

        Work drains in chunks as the cluster stream produces them, so the
        resolve/solve/finish Python work overlaps the native clustering of
        later chromosomes."""
        from .assembly.device import batched_mcf
        from strawberry_tpu.assembly.lemonns import network_simplex
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
            collected.append((cluster, self.prepare_cluster_assembly(cluster)))
            if len(collected) >= 128:
                _drain()
                self._flush_fld_async()
        _drain()
        self._drain_fld()

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
        from strawberry_tpu.quant.fastlocus import build_prebuilt_locus

        pending: List[Tuple[HitCluster, LocusContext]] = []
        use_fast = fragfile is None
        ref_flat = None
        if use_fast and self.factory.ref_mrnas:
            ref_flat = self.factory.ref_flat
            if ref_flat is None:
                try:
                    from strawberry_tpu.core.fastcluster import \
                        flatten_contigs
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
            from strawberry_tpu.quant.binweights import pdf_table
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
                    prep_state.budget_pairs = int(os.environ.get(
                        "STRAWB_PREP_BUDGET", "8192"))
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
                        dev_pool = ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="dev-prep")
                    dev_fut = dev_pool.submit(
                        build_batch_device, self.cfg, self.read_len,
                        self.insert_dist, [s for _, s in dev_chunk],
                        prep_state, self.long_read_sample)
                    futures.append((dev_chunk, dev_fut))
            if chunk:
                from strawberry_tpu.quant.fastlocus import build_batch_native
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
        with PROF.phase("host_em", items=sum(len(i) for i, _f in raw_futs)):
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
                         - dispatcher.n_host - n_raw_ok}

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
                from strawberry_tpu.quant.fragcontext import print_context
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


def run_driver(bam_path: str, cfg: Config, out: TextIO,
               log: Optional[TextIO] = None,
               fragfile: Optional[TextIO] = None,
               cmdline: str = "") -> Optional[Sample]:
    """driver() (Strawberry.cpp:237-371), single process, with the EM on
    the GPU. Returns the TorchSample."""
    if cfg.num_threads > 1 and not cfg.no_quant:
        raise NotImplementedError(
            "-p > 1: the forked shard workers are not ported to "
            "strawberry_tpu_torch yet (ROADMAP.md queue 1 item 7)")
    if os.environ.get("STRAWB_TRACE_DIR"):
        raise NotImplementedError(
            "STRAWB_TRACE_DIR: the profiler trace is not ported to "
            "strawberry_tpu_torch yet (ROADMAP.md queue 1 item 8)")
    from strawberry_tpu.utils.malloctune import tune, cap_blas_threads, \
        tune_gc
    tune()
    cap_blas_threads()
    tune_gc()
    log = log or _NullLog()
    if cfg.verbose:
        from strawberry_tpu.utils import profiling
        profiling.enable()
        # native decoders capture the per-read cerr diagnostics
        # (read.cpp:611-614,679-684) when this is set; replayed below
        os.environ["STRAWB_VERBOSE"] = "1"
    else:
        os.environ.pop("STRAWB_VERBOSE", None)
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
                        from strawberry_tpu.io.gff import parse_native
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
                        from strawberry_tpu.io.gff import \
                            load_ref_mrnas_native
                        gtf_box["refs"] = load_ref_mrnas_native(
                            reader, name2id, return_flat=True)
            except Exception as e:  # surfaced on the main thread below
                gtf_box["error"] = e
        gtf_thread = threading.Thread(target=_read_gtf, daemon=True)
        gtf_thread.start()
    table = None
    if cfg.stream_decode and cfg.native_cluster:
        # streaming decode: the BAM inflate+parse runs on a background
        # pipeline and pass-1 clustering consumes chromosome blocks as they
        # finalize, so decode wall time overlaps the pipeline instead of
        # being a serial phase (and decode memory is O(window))
        try:
            from strawberry_tpu.io.sbam import open_bam_stream
            with PROF.phase("bam_open_stream"):
                table = open_bam_stream(bam_path, cfg, low_mem=cfg.low_mem,
                                        defer_start=True)
        except OSError:
            table = None  # native lib unavailable
    if table is None:
        with PROF.phase("bam_decode"):
            try:
                from strawberry_tpu.io.native import load_bam_native
                table = load_bam_native(bam_path, cfg)
            except Exception:
                table = load_bam(bam_path, cfg)  # portable fallback
    if gtf_thread is not None:
        # release the side thread's ref build now that the header is known
        name2id_box["m"] = {n: i
                            for i, n in enumerate(table.ref_names)}
        name2id_evt.set()
    from strawberry_tpu.io.sbam import StreamingHitTable
    if isinstance(table, StreamingHitTable) and not table._started:
        barriers = None
        if cfg.low_mem and gtf_thread is not None:
            # sub-chromosome block splits must respect annotation gene
            # spans; low-mem serializes the GTF ref build before decode
            gtf_thread.join()
            if "refs" in gtf_box:
                barriers = _gene_barriers(*gtf_box["refs"],
                                          pad=cfg.max_olap_dist)
        table.start(barriers)
    sample = TorchSample(table, cfg, bam_path)
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
        from strawberry_tpu.io.fasta import FastaInterface
        sample.fasta = FastaInterface(cfg.ref_fasta_file)

    # len() on a streaming table blocks until EOF; don't force it pre-pass
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
        return sample

    if cfg.verbose:
        sys.stderr.write("Total number of mapped reads is: "
                         f"{sample.total_mapped_reads}\n")
    if sample.long_read_sample:
        sys.stderr.write("Invoking long read workflow\n")
    from strawberry_tpu.core.insert_size import NotEnoughReads
    try:
        sample.select_insert_size(verbose=cfg.verbose)
    except NotEnoughReads:
        # reference: "Not enough reads" + exit(0) (read.cpp:241-245)
        sys.stderr.write("Not enough reads\nExit program...\n")
        return sample
    if fragfile is not None:
        from strawberry_tpu.quant.fragcontext import FRAG_HEADER
        fragfile.write("\t".join(FRAG_HEADER) + "\n")
    if cfg.low_mem:
        # release pass 1's transient heap (tune() disables auto-trimming)
        import gc
        gc.collect()
        from strawberry_tpu.utils.malloctune import trim
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
    if cfg.verbose:
        sys.stderr.write(PROF.report(total_reads=len(table)) + "\n")
    return sample
