"""--low-mem's peak RSS as the depth grows: the port's counterpart of the
JAX package's tools/bench_lowmem_scaling.py.

    python -m strawberry_tpu_torch.tools.lowmem_scaling [--device cpu]
        [--sizes 2500000,5000000,10000000] [--deep-sizes 5000000]
        [--data-dir DIR] [--out]

Rows: `-g --rf --low-mem` on the easy shape (bench.py's dataset_10m: one
annotation at every size, the reads scaled) at each of --sizes fragments,
and on the deep shape (the same reads on one chromosome of 32 Mb, which
only sub-chromosome blocks keep to a window) at each of --deep-sizes.
Every missing set is generated first, all side by side, each in a
process of its own, under --data-dir as <shape>_<n> (the directories the
other tools use). Each row's run is the only run of a fresh process, and
beside it the default `-g --rf` at the same size in another: its body
must equal the --low-mem body byte for byte. Per row: fragments, reads,
BAM MB, the annotation's sha256, and for each mode the wall, the
process's peak RSS (common.peak_rss_mb) before the run and after it, and
whether the run initialized CUDA, with the --low-mem saving. Per
shape: whether every size has the same annotation, and each mode's peak
RSS growth over the last two rows (a doubling at the default sizes).
Prints one JSON line, the card first (with --out also written to
build/strawberry_tpu_torch/lowmem_scaling.json), and exits 1 when a body
differs. RSS is the record; walls share the host with nothing else the
tool runs, but are secondary.
"""
from __future__ import annotations

import hashlib
import os
import sys

from . import common

MODES = (("low_mem", ["--low-mem"]), ("default", []))


def sizes(text):
    return [int(x) for x in text.split(",") if x]


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def row(ds, work, device):
    """Both modes on one set, each alone in a fresh process."""
    out = {"frags": ds.n_frags, "bam_mb": os.path.getsize(ds.bam) / 1e6,
           "annotation_sha256": sha256(ds.gtf)}
    bodies = {}
    for mode, extra in MODES:
        g = os.path.join(work, f"{ds.shape}_{ds.n_frags}_{mode}.gtf")
        (r,) = common.cli_process(
            [["-g", ds.gtf, *ds.flags, *extra, "-o", g, "-T", g[:-4] + ".log",
              ds.bam]], {}, device)
        out["reads"] = r["reads"]
        out[mode] = {"wall_s": r["wall_s"], "peak_rss_mb": r["max_rss_mb"],
                     "start_rss_mb": r["start_rss_mb"],
                     "cuda_initialized": r["cuda_initialized"]}
        bodies[mode] = common.digest(g)
        for path in (g, g[:-4] + ".log"):
            os.remove(path)
    out["body_equal"] = bodies["low_mem"] == bodies["default"]
    out["low_mem_saving_mb"] = (out["default"]["peak_rss_mb"]
                                - out["low_mem"]["peak_rss_mb"])
    return out


def growth(rows):
    """Each mode's peak RSS growth, in percent, from the second-last row to
    the last, with the ratio of their fragments."""
    if len(rows) < 2:
        return None
    a, b = rows[-2], rows[-1]
    return {"frags_ratio": b["frags"] / a["frags"],
            **{f"{mode}_pct": (b[mode]["peak_rss_mb"]
                               / a[mode]["peak_rss_mb"] - 1) * 100
               for mode, _ in MODES}}


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0])
    p.add_argument("--sizes", default="2500000,5000000,10000000",
                   help="fragments of the easy rows")
    p.add_argument("--deep-sizes", default="5000000",
                   help="fragments of the deep rows (none: empty)")
    p.add_argument("--data-dir", default=common.OUT_DIR,
                   help="where the sets <shape>_<n> are found or generated")
    args = p.parse_args(argv)
    common.setup(args)
    wanted = [("easy", n) for n in sorted(sizes(args.sizes))] + \
        [("deep", n) for n in sorted(sizes(args.deep_sizes))]
    sets = common.datasets(wanted, args.data_dir)
    shapes = {}
    with common.scratch_dir() as work:
        for (shape, _n), ds in sets.items():
            shapes.setdefault(shape, {"rows": []})["rows"].append(
                row(ds, work, args.device))
    for shape, s in shapes.items():
        s["same_annotation"] = len({r["annotation_sha256"]
                                    for r in s["rows"]}) == 1
        s["last_growth"] = growth(s["rows"])
    ok = all(r["body_equal"] for s in shapes.values() for r in s["rows"])
    common.emit("lowmem_scaling", args, {
        "device": args.device, "shapes": shapes, "bodies_equal": ok,
        "note": "each mode of a row alone in a fresh process: -g with the "
                "shape's strand, with and without --low-mem; wall of "
                "cli.main on the host's clock; peak_rss_mb the process's "
                "own (common.peak_rss_mb); the sets made beforehand in "
                "processes of their own"})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
