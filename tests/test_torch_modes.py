"""The port's CLI against the JAX package's in the modes the other port tests
do not run: --no-quant, --low-mem, --no-tpu, single-process -b/-f and -f,
-v, checkpoint then resume, a GFF3 annotation, long reads, -e/-i, -c,
--allow-multimapped-hits and an empty BAM. Each mode runs on the input of
the JAX package's test of it (those compare against the C++ binary, which
this checkout cannot build), and must give the JAX CLI's GTF body, -T log
and, where written, -f TSV byte for byte; under -v the run-level stderr
lines of tests/test_verbose_parity.py. One process per package runs every
mode, the port's with jax and the JAX package blocked from import. Then
the port's own sub-chromosome --low-mem splits against its default run, as
tests/test_checkpoint_resume.py holds the JAX package's."""
import io
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawberry_tpu.io.bamwriter import BamWriter
from strawberry_tpu.io.fasta import build_fai
from strawberry_tpu.sim import make_dataset, write_genome_fasta
from test_torch_pipeline import assert_standalone, body, read
from test_verbose_parity import _extract as run_level_lines

# Runs the steps of a JSON list through <package>.cli.main in one process:
# a step is an argv, or {"normalize": [src, dst]}, which copies a --no-quant
# checkpoint with its score column set to "." (the GFF parser drops
# numeric-score lines, so a checkpoint resumes only so; both packages get
# the same copy). Prints the exit codes and whether jax or the JAX package
# was imported, as JSON. BLOCK_JAX=1 makes both imports fail.
_RUNNER = """
import json, os, sys
if os.environ.get("BLOCK_JAX"):
    sys.modules["jax"] = None
    sys.modules["strawberry_tpu"] = None
import importlib
cli = importlib.import_module(sys.argv[1] + ".cli")
rcs = []
for step in json.loads(sys.argv[2]):
    if isinstance(step, dict):
        src, dst = step["normalize"]
        with open(src) as f, open(dst, "w") as g:
            for line in f:
                t = line.split("\\t")
                if len(t) > 5:
                    t[5] = "."
                g.write("\\t".join(t))
        continue
    rcs.append(cli.main(step))
with open("/proc/self/maps") as f:
    libs = sorted({l.split()[-1] for l in f if l.rstrip().endswith(".so")})
print(json.dumps({"rcs": rcs, "jax": sys.modules.get("jax") is not None,
                  "jax_package": any(
                      m.split(".")[0] == "strawberry_tpu"
                      and sys.modules[m] is not None for m in sys.modules),
                  "libs": libs}))
"""

# mode -> (make_dataset arguments, argv before -o, the JAX package's test
# of the mode). {gtf}, {fa} and {tsv} are filled in per package; the -v
# mode runs last, since -v turns the phase timer on for the process.
MODES = {
    "no_quant": (dict(seed=21, n_frags=4000), ["-g", "{gtf}", "--no-quant"],
                 "test_golden_assembly.py::test_no_quant_golden"),
    "low_mem": (dict(seed=15, n_frags=3000, n_chroms=3),
                ["-g", "{gtf}", "--low-mem"],
                "test_sbam_stream.py::test_low_mem_pipeline_matches_default"),
    "no_tpu": (dict(seed=9, n_frags=3000, max_isoforms=3),
               ["-g", "{gtf}", "--no-tpu"], None),
    "bias_frag": (dict(seed=9, n_frags=3000, max_isoforms=3),
                  ["-g", "{gtf}", "-r", "-b", "{fa}", "-f", "{tsv}"],
                  "test_golden_features.py::"
                  "test_frag_context_with_bias_golden"),
    "frag": (dict(seed=5, n_frags=2000), ["-g", "{gtf}", "-r", "-f", "{tsv}"],
             "test_golden_features.py::test_frag_context_no_bias_golden"),
    "gff3": (dict(seed=9, n_frags=3000, max_isoforms=3,
                  annotation_format="gff3"), ["-g", "{gtf}", "-r"],
             "test_golden_features.py::test_gff3_annotation_golden"),
    "long_reads": (dict(seed=17, n_frags=2500, paired=False,
                        read_len_range=(1001, 1400), chrom_len=600_000),
                   ["-g", "{gtf}", "-r"],
                   "test_golden_features.py::test_long_read_golden"),
    "expression_insert_size": (
        dict(seed=88, n_frags=3000, max_isoforms=4),
        ["-g", "{gtf}", "-e", "0.2", "-i", "300/60"],
        "test_golden_features.py::"
        "test_expression_filter_and_insert_size_flags_golden"),
    "combine_short": (dict(seed=9, n_frags=3000, max_isoforms=3), ["-c"],
                      None),
    "multimapped": (dict(seed=41, n_frags=3500, multimap_frac=0.25),
                    ["-g", "{gtf}", "--allow-multimapped-hits"],
                    "test_golden_readpaths.py::test_multimappers_golden"),
    "empty_bam": (None, [], "test_edge_cases.py::test_empty_bam"),
    "verbose": (dict(seed=17, n_frags=6000, n_chroms=2, max_isoforms=3),
                ["-v", "-g", "{gtf}"],
                "test_verbose_parity.py::"
                "test_verbose_run_level_lines_match_reference"),
}
# --no-quant, then quantification from its normalized checkpoint
# (test_checkpoint_resume.py::test_checkpoint_then_resume_golden)
CHECKPOINT = dict(seed=21, n_frags=4000, max_isoforms=2)
PACKAGES = ("strawberry_tpu", "strawberry_tpu_torch")


def genome_with_fai(path):
    """The genome and .fai of test_golden_features.py (chr1, 300 kb,
    seed 7)."""
    write_genome_fasta(path, {"chr1": 300_000}, seed=7)
    with open(path + ".fai", "w") as fh:
        for n, r in build_fai(path).items():
            fh.write(f"{n}\t{r.seq_len}\t{r.fpos}\t{r.line_len}"
                     f"\t{r.line_blen}\n")
    return path


def run_package(package, steps, stderr_path):
    """Every step through one process of `package`; its stderr kept."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("STRAWB_")}
    env["STRAWB_PLATFORM"] = "cpu"
    if package == "strawberry_tpu_torch":
        env["BLOCK_JAX"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, package, json.dumps(steps)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    with open(stderr_path, "w") as f:
        f.write(proc.stderr)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rcs"] == [0] * len(res["rcs"]), proc.stderr[-4000:]
    if package == "strawberry_tpu_torch":
        assert_standalone(res)
    return res


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """Every mode and the checkpoint-resume pair through both CLIs; returns
    {(package, mode): output stem} and {package: stderr path}."""
    root = tmp_path_factory.mktemp("torch_modes")
    fa = genome_with_fai(str(root / "genome.fa"))
    empty = str(root / "empty.bam")
    with BamWriter(empty, ["chr1"], [100000]):
        pass
    steps = {pkg: [] for pkg in PACKAGES}
    stems = {}
    data = {}
    for mode, (kw, flags, _test) in MODES.items():
        if kw is None:
            bam, gtf = empty, ""
        else:
            key = json.dumps(kw, sort_keys=True)
            if key not in data:
                data[key] = make_dataset(str(root / f"d{len(data)}"),
                                         **kw)[:2]
            bam, gtf = data[key]
        for pkg in PACKAGES:
            stem = stems[(pkg, mode)] = str(root / f"{pkg}_{mode}")
            steps[pkg].append(
                [f.format(gtf=gtf, fa=fa, tsv=stem + ".tsv") for f in flags]
                + ["-o", stem + ".gtf", "-T", stem + ".log", bam])
    bam, _gtf, _ = make_dataset(str(root / "ckpt"), **CHECKPOINT)
    for pkg in PACKAGES:
        ckpt = stems[(pkg, "checkpoint")] = str(root / f"{pkg}_checkpoint")
        final = stems[(pkg, "resume")] = str(root / f"{pkg}_resume")
        # before the -v run
        steps[pkg][-1:-1] = [
            ["--no-quant", "-o", ckpt + ".gtf", "-T", ckpt + ".log", bam],
            {"normalize": [ckpt + ".gtf", ckpt + "_fixed.gtf"]},
            ["-g", ckpt + "_fixed.gtf", "-r", "-o", final + ".gtf", "-T",
             final + ".log", bam]]
    stderr = {pkg: str(root / f"{pkg}.stderr") for pkg in PACKAGES}
    for pkg in PACKAGES:
        run_package(pkg, steps[pkg], stderr[pkg])
    return stems, stderr


@pytest.mark.parametrize("mode", [m for m in MODES if m != "verbose"]
                         + ["checkpoint", "resume"])
def test_port_mode_byte_identical_to_jax_cli(modes, mode):
    stems, _stderr = modes
    jax_out, port_out = (stems[(pkg, mode)] for pkg in PACKAGES)
    want = body(jax_out + ".gtf")
    if mode == "empty_bam":
        assert want == ""
    else:
        assert want.count("\ttranscript\t") > 0
    assert body(port_out + ".gtf") == want
    assert read(port_out + ".log") == read(jax_out + ".log")
    if os.path.exists(jax_out + ".tsv"):
        assert read(jax_out + ".tsv").count("\n") > 1
        assert read(port_out + ".tsv") == read(jax_out + ".tsv")
    else:
        assert not os.path.exists(port_out + ".tsv")


def test_port_verbose_run_level_lines_equal_jax_cli(modes):
    """-v: the GTF body and -T log as in the other modes, and the run-level
    stderr lines of both processes equal (the phase report's timings differ
    by nature)."""
    stems, stderr = modes
    jax_out, port_out = (stems[(pkg, "verbose")] for pkg in PACKAGES)
    assert body(port_out + ".gtf") == body(jax_out + ".gtf")
    assert read(port_out + ".log") == read(jax_out + ".log")
    jax_lines, port_lines = (run_level_lines(read(stderr[pkg]))
                             for pkg in PACKAGES)
    assert any(line.startswith("Calculated averaged fragment length")
               for line in jax_lines), jax_lines
    assert port_lines == jax_lines


@pytest.fixture(scope="module")
def deep_single_chromosome(tmp_path_factory):
    """The deep single-chromosome set of test_checkpoint_resume.py::
    test_lowmem_subchromosome_splits_byte_identical."""
    d = str(tmp_path_factory.mktemp("splits"))
    make_dataset(d, seed=71, n_frags=30_000, n_chroms=1, chrom_len=1_500_000,
                 n_genes_hint=30, max_isoforms=4)
    return f"{d}/sample_01.sorted.bam", f"{d}/annotation.gtf"


@pytest.mark.parametrize("config", ["quant_only", "ref_guided", "abinitio"])
def test_port_lowmem_subchromosome_splits_byte_identical(
        deep_single_chromosome, config, monkeypatch):
    """Forced sub-chromosome block splits under --low-mem change no output
    byte of the port's run_driver."""
    from strawberry_tpu_torch.config import Config
    from strawberry_tpu_torch.pipeline import run_driver
    monkeypatch.setenv("STRAWB_SPLIT_MB", "1")
    monkeypatch.setenv("STRAWB_STREAM_CAP_MB", "8")
    bam, gtf = deep_single_chromosome
    kw = {"quant_only": dict(ref_gtf_filename=gtf, utilize_ref_models=True,
                             no_assembly=True),
          "ref_guided": dict(ref_gtf_filename=gtf, utilize_ref_models=True),
          "abinitio": dict()}[config]
    split, whole = io.StringIO(), io.StringIO()
    run_driver(bam, Config(low_mem=True, **kw), split)
    run_driver(bam, Config(**kw), whole)
    assert split.getvalue() == whole.getvalue()
    assert split.getvalue()
