"""The port's streaming BAM decoder (io/sbam.py over native/bamdecode.cc)
across its windows, against the whole-file decoder (io/native.py::
load_bam_native), row for row.

The stream decodes the file a window at a time: the BGZF blocks of its first
256 KiB of compressed bytes, then of each 4 MiB. A window of 4,096 records or
more is parsed on several threads, each into a partial of its own; a shorter
one on one thread. The sets here are made so that a threaded first window is
followed by a short last one, which must append its own rows alone: once
where the short window starts inside the second of two chromosomes, once
inside the only one, and each again under --low-mem's sub-chromosome split,
before and after `reopen()` (pass 2's fresh stream)."""
import json
import os
import struct
import zlib

import numpy as np
import pytest

from portbench import gen
from strawberry_tpu_torch.config import Config
from strawberry_tpu_torch.io.native import load_bam_native
from strawberry_tpu_torch.io.sbam import open_bam_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_WINDOW = 256 << 10     # compressed bytes of the stream's first window
THREADED = 4096              # records from which a window is parsed threaded
FIELDS = ("ref_id", "left", "right", "strand", "flag", "mate_ref",
          "mate_pos", "nh", "read_id", "cigar_hash", "feat_code",
          "feat_left", "feat_len")


def window_records(path):
    """Records wholly inside the stream's first window, and after it."""
    data = open(path, "rb").read()
    raw, first, p = [], None, 0
    while p < len(data):
        bsize = struct.unpack_from("<H", data, p + 16)[0] + 1
        if first is None and p + bsize > FIRST_WINDOW:
            first = sum(map(len, raw))
        raw.append(zlib.decompress(data[p + 18:p + bsize - 8], -15))
        p += bsize
    raw = b"".join(raw)
    l_text = struct.unpack_from("<i", raw, 4)[0]
    q = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, q)[0]
    q += 4
    for _ in range(n_ref):
        q += 8 + struct.unpack_from("<i", raw, q)[0]
    counts = [0, 0]
    while q < len(raw):
        q += 4 + struct.unpack_from("<i", raw, q)[0]
        counts[first is not None and q > first] += 1
    return counts


@pytest.fixture(scope="module", params=[(2, 400_000), (1, 800_000)],
                ids=["short_window_in_the_second_chromosome",
                     "short_window_inside_the_only_chromosome"])
def windowed_set(request, tmp_path_factory):
    n_chroms, chrom_len = request.param
    with open(os.path.join(ROOT, "portbench", "configs",
                           "human_scale_fr.json")) as f:
        cfg = json.load(f)
    cfg.update(n_chroms=n_chroms, chrom_len=chrom_len, n_frags=9_800)
    ann = gen.make_annotation(cfg, 5)
    bam = str(tmp_path_factory.mktemp("windows") / "sample.bam")
    gen.write_bam(bam, ann, gen.sample_reads(cfg, 5, ann))
    first, rest = window_records(bam)
    assert first >= THREADED > rest > 0, (first, rest)
    return bam, n_chroms


def blocks_of(stream):
    out, k = [], 0
    while stream.wait_block(k):
        out.append(stream.block_table(k))
        k += 1
    return out


def assert_rows_equal(blocks, whole):
    for f in FIELDS:
        cat = np.concatenate([getattr(b, f) for b in blocks])
        assert np.array_equal(cat, getattr(whole, f)), f
    fo = np.concatenate([[0]] + [np.diff(b.feat_off)
                                 for b in blocks]).cumsum()
    assert np.array_equal(fo, whole.feat_off)
    chroms = [int(b.ref_id[0]) for b in blocks]
    assert chroms == sorted(chroms)
    assert all((b.ref_id == b.ref_id[0]).all() for b in blocks)


def test_stream_appends_each_window_once(windowed_set):
    bam, n_chroms = windowed_set
    cfg = Config(fr_strand=True)
    whole = load_bam_native(bam, cfg)
    s = open_bam_stream(bam, cfg)
    blocks = blocks_of(s)
    assert_rows_equal(blocks, whole)
    assert len(blocks) == n_chroms == len(np.unique(whole.ref_id))
    assert len(s) == len(whole)
    assert s.read_len_hist == whole.read_len_hist


def test_low_mem_split_and_reopen_append_each_window_once(windowed_set,
                                                          monkeypatch):
    """--low-mem's sub-chromosome split at its smallest target (1 MB, about
    12k rows a block): it cuts the one-chromosome set's 19k rows, and leaves
    the two-chromosome set's 9-11k a chromosome whole."""
    bam, n_chroms = windowed_set
    monkeypatch.setenv("STRAWB_SPLIT_MB", "1")
    cfg = Config(fr_strand=True)
    whole = load_bam_native(bam, cfg)
    s = open_bam_stream(bam, cfg, low_mem=True)
    for stream in (s, s.reopen()):
        blocks = blocks_of(stream)
        assert_rows_equal(blocks, whole)
        assert len(blocks) == (2 if n_chroms == 1 else n_chroms)
        assert len(stream) == len(whole)
