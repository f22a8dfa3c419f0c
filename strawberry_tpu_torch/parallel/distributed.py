"""Data-parallel (multi-shard / multi-process) pipeline: the counterpart of
strawberry_tpu/parallel/distributed.py, copied from it.

The genome is split into per-shard coordinate ranges (chromosome
granularity — the cluster scan never crosses chromosomes, so the split is
exact); each shard runs the two-pass pipeline on its reads + annotation
subset. The only cross-shard state is:

  pass 1 -> pass 2:  fragment-length histogram + total mapped reads
                     (all-reduce; ref: src/alignments.cpp:1372,1401)
  output:            the global FPKM sum for TPM normalization + ordered
                     GTF merge (gather; ref: alignments.cpp:1821-1829)

The reductions are summed on the GPU by the hand-written kernel of
cuda_reduce.py (parallel/collectives.py). With several processes
(`run_distributed`) each is one shard; torch.distributed over gloo carries
the rows and the isoform records between them, and every process sums the
gathered rows on its own device. Output is byte-identical to the
single-shard pipeline (tests/test_torch_parallel.py asserts this on the
CPU, the chip smoke on the GPU).
"""
from __future__ import annotations

import io
from dataclasses import replace
from typing import List, Optional, TextIO, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.bamreader import HitTable
from ..io.gtfwriter import print2gtf
from ..pipeline import Sample, _NullLog
from ..quant.locus import Isoform, c_str
from ..utils.torchsetup import device, to_device
from . import cuda_reduce
from .collectives import allreduce_hist, allreduce_scalar
from .mesh import Mesh, make_mesh


def shard_table(table: HitTable, ref_ids: List[int]) -> HitTable:
    """Row-subset of a HitTable for the given chromosomes (global ref ids
    kept, so annotations and output naming stay consistent). The table is
    position-sorted, so a contiguous chromosome range is a pure slice —
    zero-copy views; non-contiguous id sets take the gather path."""
    mask = np.isin(table.ref_id, ref_ids)
    idx = np.nonzero(mask)[0]
    if len(idx) and int(idx[-1]) - int(idx[0]) + 1 == len(idx):
        i0, i1 = int(idx[0]), int(idx[-1]) + 1
        f0, f1 = int(table.feat_off[i0]), int(table.feat_off[i1])
        return HitTable(
            ref_id=table.ref_id[i0:i1], left=table.left[i0:i1],
            right=table.right[i0:i1], strand=table.strand[i0:i1],
            flag=table.flag[i0:i1], mate_ref=table.mate_ref[i0:i1],
            mate_pos=table.mate_pos[i0:i1], nh=table.nh[i0:i1],
            read_id=table.read_id[i0:i1],
            cigar_hash=table.cigar_hash[i0:i1],
            feat_off=table.feat_off[i0:i1 + 1] - f0,
            feat_code=table.feat_code[f0:f1],
            feat_left=table.feat_left[f0:f1],
            feat_len=table.feat_len[f0:f1],
            ref_names=table.ref_names,
            ref_real_names=table.ref_real_names,
            ref_lens=table.ref_lens, read_len_hist=table.read_len_hist,
            paired_end=table.paired_end)
    # rebuild the feature ragged arrays for the kept rows
    lens = (table.feat_off[1:] - table.feat_off[:-1])[idx]
    new_off = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    fidx = np.concatenate([
        np.arange(table.feat_off[i], table.feat_off[i + 1])
        for i in idx]) if len(idx) else np.zeros(0, np.int64)
    return HitTable(
        ref_id=table.ref_id[idx], left=table.left[idx],
        right=table.right[idx], strand=table.strand[idx],
        flag=table.flag[idx], mate_ref=table.mate_ref[idx],
        mate_pos=table.mate_pos[idx], nh=table.nh[idx],
        read_id=table.read_id[idx], cigar_hash=table.cigar_hash[idx],
        feat_off=new_off, feat_code=table.feat_code[fidx],
        feat_left=table.feat_left[fidx], feat_len=table.feat_len[fidx],
        ref_names=table.ref_names, ref_real_names=table.ref_real_names,
        ref_lens=table.ref_lens, read_len_hist=table.read_len_hist,
        paired_end=table.paired_end)


def split_counts(counts: np.ndarray, n_shards: int) -> List[List[int]]:
    """Contiguous chromosome ranges balanced by per-chromosome read
    counts. Contiguity keeps global cluster numbering and output order
    identical to the single-shard run."""
    total = int(counts.sum())
    shards: List[List[int]] = [[] for _ in range(max(1, n_shards))]
    if total == 0:
        shards[0] = list(range(len(counts)))
        return shards
    cum = 0
    for rid in range(len(counts)):
        # assign by the midpoint quantile of this chromosome's read range;
        # monotone in rid, so shards stay contiguous
        k = min(len(shards) - 1,
                (cum + int(counts[rid]) // 2) * len(shards) // total)
        shards[k].append(rid)
        cum += int(counts[rid])
    return shards


def split_by_chrom(table: HitTable, n_shards: int) -> List[List[int]]:
    return split_counts(
        np.bincount(table.ref_id, minlength=len(table.ref_names)), n_shards)


def run_sharded(table: HitTable, cfg: Config, bam_path: str, out: TextIO,
                log: Optional[TextIO] = None, n_shards: int = 0,
                mesh=None, fragfile=None) -> List[Isoform]:
    """Locus-data-parallel two-pass pipeline over n_shards genome shards.

    Single-process form: shards run in sequence on this host while the
    cross-shard reductions are summed on the mesh's device. With several
    processes (run_distributed), each runs exactly one shard (its
    coordinate range) and the same reduction synchronizes — per-shard
    pipeline code is shared.
    """
    log = log or _NullLog()
    mesh = mesh or make_mesh(mdl=1)
    if n_shards <= 0:
        n_shards = mesh.shape["dp"]
    shards = split_by_chrom(table, n_shards)

    samples: List[Sample] = []
    for ref_ids in shards:
        sub = shard_table(table, ref_ids)
        s = Sample(sub, cfg, bam_path)
        s.long_read_sample = table.is_long_read_sample(cfg.long_read_len) \
            or cfg.long_read_sample
        if cfg.ref_gtf_filename:
            s.load_ref_gtf(cfg.ref_gtf_filename)
            s.factory.set_ref_mrnas(
                [r for r in s.factory.ref_mrnas if r.ref_id in ref_ids])
        if cfg.bias_correction and cfg.ref_fasta_file:
            from ..io.fasta import FastaInterface
            s.fasta = FastaInterface(cfg.ref_fasta_file)
        samples.append(s)

    # ---- pass 1 per shard -------------------------------------------------
    # Cluster ids thread shard-to-shard (contiguous chromosome split), so
    # transcript naming matches the single-shard run. Across processes this
    # is an exclusive scan of per-shard cluster counts between the passes.
    next_id = 0
    for s in samples:
        s.num_cluster_base = next_id
        if cfg.no_assembly:
            if s.factory.ref_mrnas:
                s.pre_process(log)
        else:
            s.assemble_sample(log)
        next_id = max(next_id, s.num_cluster)

    # ---- all-reduce global statistics on the mesh's device ----------------
    dp = mesh.shape["dp"]
    max_fl = max((max(s.frag_dist) if len(s.frag_dist) else 0)
                 for s in samples)
    H = max_fl + 1
    local_hist = np.zeros((dp, H), dtype=np.float64)
    for k, s in enumerate(samples):
        for v in s.frag_dist:
            local_hist[k % dp, v] += 1
    global_hist = allreduce_hist(mesh, local_hist)
    totals = np.zeros((dp,), dtype=np.float64)
    for k, s in enumerate(samples):
        totals[k % dp] += s.total_mapped_reads
    total_mapped = int(allreduce_scalar(mesh, totals))

    global_frag_dist: List[int] = []
    for v, c in enumerate(global_hist):
        global_frag_dist.extend([v] * int(c))

    # ---- pass 2 per shard with the global statistics ----------------------
    all_isoforms: List[Isoform] = []
    for s in samples:
        if cfg.no_assembly:
            if not s.factory.ref_mrnas:
                continue  # empty shard: no annotation in range
        elif not s.assembly:
            continue      # empty shard: nothing assembled
        s.total_mapped_reads = total_mapped
        s.frag_dist = global_frag_dist
        s.select_insert_size()
        buf = io.StringIO()
        iso = s.proc_sample(buf, log, fragfile)
        all_isoforms.extend(iso)

    # ---- global TPM + ordered merge (gather-equivalent) -------------------
    # NB proc_sample already computed a per-shard TPM; recompute globally.
    total_fpkm = sum(i.fpkm for i in all_isoforms)
    for i in all_isoforms:
        i.tpm = 1e6 * i.fpkm / total_fpkm if total_fpkm != 0 else float("nan")
        i.tpm_s = c_str(i.tpm)
    all_isoforms.sort(key=lambda i: (i.contig.ref_id,))
    for i in all_isoforms:
        ref_name = table.ref_real_names[i.contig.ref_id] \
            if i.contig.ref_id >= 0 else "?"
        print2gtf(out, i.contig, ref_name, i.fpkm_s, i.frac_s, i.tpm_s,
                  i.gene_str, i.isoform_str, i.ref_gene_id, i.ref_gene_name)
    return all_isoforms


# ---------------------------------------------------------------------------
# Real multi-process execution: one process per shard (torch.distributed
# over gloo, collectives.init_distributed), each running exactly its genome
# shard; the per-process statistics rows and the per-shard isoform records
# gather to every process, the rows are summed on each process's own device,
# and process 0 writes the ordered GTF.


def _process_allgather(x: np.ndarray) -> np.ndarray:
    """One array of the same shape and type from every process, stacked in
    rank order as (nproc, ...), on every process."""
    import torch.distributed as dist
    mine = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).numpy()


def _global_mesh() -> Mesh:
    """This process's one-slot mesh: its device is GPU (rank modulo the
    GPU count), made the current one so that the pipeline's own device work
    lands on it too; the CPU on STRAWB_PLATFORM=cpu. Several processes may
    share one GPU. Raises when CUDA is asked for (the default) and absent."""
    import torch.distributed as dist
    dev = device()
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh((dev,), 1)


def allreduce_rows_multihost(local_row: np.ndarray) -> np.ndarray:
    """Sum one (H,) float64 contribution per process: the rows gather to
    every process in rank order and each sums them on its own device with
    the reduction kernel, so every process gets the same bits. Every
    process must call with the same H."""
    mesh = _global_mesh()
    rows = _process_allgather(np.asarray(local_row, np.float64))
    return cuda_reduce.shard_colsum(
        to_device(rows, mesh.devices[0], torch.float64)).cpu().numpy()


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Gather one byte blob per process to every process (ragged: lengths
    gather first, payloads zero-pad to the max)."""
    lens = _process_allgather(
        np.array([len(payload)], np.int64)).reshape(-1)
    H = max(1, int(lens.max()))
    buf = np.zeros(H, np.uint8)
    if payload:
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = _process_allgather(buf)
    return [gathered[k, :int(lens[k])].tobytes()
            for k in range(gathered.shape[0])]


def _ranged_ingest(bam_path: str, cfg: Config):
    """Per-process ranged BAM decode (ref anchor src/read.cpp:428-478
    bgzf_seek design).

    Every process inflates only its ~1/N compressed-byte block span
    (io.native.SpanDecoder). BAM records are not self-synchronizing, so
    the exact record boundary at each span start is produced by the
    previous span's record-length skip-scan and relayed through one
    all-gather round per process (the scans are ~ms; the expensive
    inflate already ran in parallel before the relay). Rows are then
    redistributed to their owning process under the same contiguous
    chromosome split as the all-decode path, so everything downstream —
    and the output — is byte-identical.

    Returns (owned HitTable, my chromosome ids, ingest stats)."""
    import pickle

    import torch.distributed as dist

    from ..io.native import SpanDecoder

    pid, nproc = dist.get_rank(), dist.get_world_size()
    dec = SpanDecoder(bam_path, pid, nproc, cfg)

    # record-boundary relay: start_0 = header end; start_{p+1} = span p's
    # first record offset at/after its owned end
    start = dec.header_end if pid == 0 else -1
    for k in range(nproc - 1):
        mine = dec.end_from(start) if pid == k else 0
        ends = _process_allgather(
            np.array([mine], np.int64)).reshape(-1)
        if pid == k + 1:
            start = int(ends[k])
    end = dec.end_from(start) if pid < nproc - 1 else dec.total_ucomp
    arrs, seq_lens, paired = dec.parse(start, end)

    # global per-chromosome counts -> the canonical contiguous split
    nref = len(dec.ref_names)
    local_counts = np.bincount(arrs["ref_id"], minlength=nref) \
        .astype(np.int64)
    counts = _process_allgather(local_counts)
    counts = counts.reshape(nproc, nref).sum(axis=0)
    shards = split_counts(counts, nproc)
    owner_of = np.zeros(nref, np.int32)
    for k, ids in enumerate(shards):
        for rid in ids:
            owner_of[rid] = k

    # redistribute rows to their owners (chromosomes are contiguous runs
    # in a position-sorted span, so per-owner slices are cheap; gathered
    # spans concatenate in pid order = file order)
    def subrows(mask):
        idx = np.nonzero(mask)[0]
        if not len(idx):
            return None
        i0, i1 = int(idx[0]), int(idx[-1]) + 1
        f0 = int(arrs["feat_off"][i0])
        f1 = int(arrs["feat_off"][i1])
        return {k: (np.asarray(v[i0:i1 + 1] - f0) if k == "feat_off" else
                    np.asarray(v[f0:f1] if k.startswith("feat_") else
                               v[i0:i1]))
                for k, v in arrs.items()}

    row_owner = owner_of[arrs["ref_id"]]
    outbound = []
    for q in range(nproc):
        if q == pid:
            outbound.append(None)  # own rows stay local
            continue
        outbound.append(subrows(row_owner == q))
    blobs = allgather_bytes(pickle.dumps((outbound, seq_lens.tolist(),
                                          paired, dec.comp_bytes)))

    # stitch my rows: contributions from every span in pid order
    parts = []
    all_seqlens = []
    any_paired = False
    comp_list = []
    for p in range(nproc):
        ob, sl, pr, cb = pickle.loads(blobs[p])
        any_paired |= pr
        all_seqlens.append(sl)
        comp_list.append(cb)
        if p == pid:
            parts.append(subrows(row_owner == pid))
        elif ob[pid] is not None:
            parts.append(ob[pid])
    parts = [p for p in parts if p is not None]

    def cat(key):
        if not parts:
            base = np.zeros(1 if key == "feat_off" else 0,
                            arrs[key].dtype)
            return base
        if key == "feat_off":
            segs = [np.asarray(p[key]) for p in parts]
            out = [segs[0]]
            base = segs[0][-1]
            for s in segs[1:]:
                out.append(s[1:] + base)
                base += s[-1]
            return np.concatenate(out)
        return np.concatenate([np.asarray(p[key]) for p in parts])

    # global read-length histogram: first max_read_num_4_rl accepted hits
    # in FILE order (spans are file-ordered, per-span lists are ordered)
    hist: dict = {}
    n_hist = 0
    for sl in all_seqlens:
        for v in sl:
            if n_hist >= cfg.max_read_num_4_rl:
                break
            hist[v] = hist.get(v, 0) + 1
            n_hist += 1

    table = HitTable(
        ref_id=cat("ref_id"), left=cat("left"), right=cat("right"),
        strand=cat("strand"), flag=cat("flag"), mate_ref=cat("mate_ref"),
        mate_pos=cat("mate_pos"), nh=cat("nh"), read_id=cat("read_id"),
        cigar_hash=cat("cigar_hash"), feat_off=cat("feat_off"),
        feat_code=cat("feat_code"), feat_left=cat("feat_left"),
        feat_len=cat("feat_len"),
        ref_names=dec.ref_names, ref_real_names=dec.ref_real_names,
        ref_lens=dec.ref_lens, read_len_hist=hist, paired_end=any_paired)
    stats = {"comp_bytes_inflated": int(comp_list[pid]),
             "comp_bytes_all": [int(c) for c in comp_list]}
    return table, shards[pid] if pid < len(shards) else [], stats


def run_distributed(bam_path: str, cfg: Config, out: TextIO,
                    log: Optional[TextIO] = None,
                    fragfile=None) -> List[Isoform]:
    """Multi-process two-pass pipeline: this process runs shard
    dist.get_rank() of the chromosome split. torch.distributed must be
    initialized (collectives.init_distributed). Process 0 writes the
    merged, globally-TPM-normalized GTF; the return value is this shard's
    isoforms.

    Byte parity with the single-process run is asserted by
    tests/test_torch_parallel.py over real multi-process CPU runs."""
    import pickle

    import torch.distributed as dist

    from .multiproc import _renumber_parent, _renumber_trans

    pid = dist.get_rank()
    log = log or _NullLog()
    _global_mesh()  # this process's GPU, before any device work
    # ranged ingest: this process inflates only its ~1/N block span
    sub, mine, ingest_stats = _ranged_ingest(bam_path, cfg)
    table = sub  # header metadata lives on the owned table
    s = Sample(sub, cfg, bam_path)
    s.ingest_stats = ingest_stats
    tot = sum(ingest_stats["comp_bytes_all"])
    log.write(f"ranged ingest: inflated "
              f"{ingest_stats['comp_bytes_inflated']} of {tot} "
              f"compressed bytes\n")
    s.long_read_sample = table.is_long_read_sample(cfg.long_read_len) \
        or cfg.long_read_sample
    if cfg.ref_gtf_filename:
        s.load_ref_gtf(cfg.ref_gtf_filename)
        ids = set(mine)
        s.factory.set_ref_mrnas(
            [r for r in s.factory.ref_mrnas if r.ref_id in ids])
    if cfg.bias_correction and cfg.ref_fasta_file:
        from ..io.fasta import FastaInterface
        s.fasta = FastaInterface(cfg.ref_fasta_file)
    if fragfile is not None:
        from ..quant.fragcontext import FRAG_HEADER
        fragfile.write("\t".join(FRAG_HEADER) + "\n")

    # ---- pass 1 on this shard ---------------------------------------------
    if cfg.no_assembly:
        if s.factory.ref_mrnas:
            s.pre_process(log)
    else:
        s.assemble_sample(log)

    # ---- global statistics between the passes -----------------------------
    # cluster-count exclusive scan -> renumber this shard's assembly so the
    # merged naming matches the sequential single-process numbering
    counts = _process_allgather(
        np.array([s.num_cluster], np.int64)).reshape(-1)
    base = int(counts[:pid].sum())
    if base:
        for c in s.assembly:
            c.parent_id = _renumber_parent(c.parent_id, base)
            c.trans_id = _renumber_trans(c.trans_id, base)

    # fragment-length histogram + total mapped reads: summed on the device
    # (ragged: gather the max first so every process builds the same H)
    maxes = _process_allgather(np.array(
        [max(s.frag_dist) if len(s.frag_dist) else 0],
        np.int64)).reshape(-1)
    H = int(maxes.max()) + 1
    local_hist = np.zeros(H + 1, np.float64)
    for v in s.frag_dist:
        local_hist[v] += 1
    local_hist[H] = s.total_mapped_reads
    summed = allreduce_rows_multihost(local_hist)
    total_mapped = int(summed[H] + 0.5)
    global_frag: List[int] = []
    for v in range(H):
        global_frag.extend([v] * int(summed[v] + 0.5))

    # ---- pass 2 on this shard with the global statistics -------------------
    iso: List[Isoform] = []
    runnable = (s.factory.ref_mrnas if cfg.no_assembly else s.assembly)
    if runnable:
        s.total_mapped_reads = total_mapped
        s.frag_dist = global_frag
        s.select_insert_size()
        iso = s.proc_sample(io.StringIO(), log, fragfile)

    # ---- gather isoform records; process 0 writes the ordered GTF ----------
    blobs = allgather_bytes(pickle.dumps(iso))
    if pid == 0:
        all_isoforms: List[Isoform] = []
        for b in blobs:
            all_isoforms.extend(pickle.loads(b))
        total_fpkm = sum(i.fpkm for i in all_isoforms)
        for i in all_isoforms:
            i.tpm = 1e6 * i.fpkm / total_fpkm if total_fpkm != 0 \
                else float("nan")
            i.tpm_s = c_str(i.tpm)
        # shards are contiguous chromosome ranges in genome order, so the
        # gathered order is already the single-process output order
        for i in all_isoforms:
            ref_name = table.ref_real_names[i.contig.ref_id] \
                if i.contig.ref_id >= 0 else "?"
            print2gtf(out, i.contig, ref_name, i.fpkm_s, i.frac_s, i.tpm_s,
                      i.gene_str, i.isoform_str, i.ref_gene_id,
                      i.ref_gene_name)
    return iso
