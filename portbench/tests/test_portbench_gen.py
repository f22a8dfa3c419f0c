"""The generator: one seed, one set of bytes; the reads the port decodes."""
import glob
import hashlib
import json
import os

import pytest

from portbench import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def small(name, frags=2000, chroms=2):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    return dict(cfg, n_frags=frags, n_chroms=chroms, warmup_frags=300)


def digest(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in ("annotation.gtf", "sample.bam",
                                   "warmup.bam")}


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-5] for p in glob.glob(
        os.path.join(ROOT, "portbench", "configs", "*.json"))))
def test_one_seed_one_set(tmp_path, name):
    cfg = small(name)
    big = 2 ** 31 + 17          # a seed past 32 signed bits
    a = gen.write_set(cfg, big, str(tmp_path / "a"))
    b = gen.write_set(cfg, big, str(tmp_path / "b"))
    c = gen.write_set(cfg, big + 1, str(tmp_path / "c"))
    assert a == b and a["reads"] == 2 * cfg["n_frags"]
    assert digest(tmp_path / "a") == digest(tmp_path / "b")
    other = digest(tmp_path / "c")
    assert all(other[f] != v for f, v in digest(tmp_path / "a").items())


def test_port_reads_every_record(tmp_path):
    """The port's pure-Python BAM decoder parses the file whole: every
    record is there, in position order, with its mate's position."""
    from strawberry_tpu_torch.config import Config
    from strawberry_tpu_torch.io.bamreader import load_bam
    cfg = small("paper_scale_rf")
    gen.write_set(cfg, 5, str(tmp_path))
    R = gen.sample_reads(cfg, 5)
    t = load_bam(str(tmp_path / "sample.bam"), Config(rf_strand=True))
    from portbench.reference import decode
    kept, _, span = decode(cfg, R)
    assert len(t) == int(kept.sum())
    assert (t.left == R.pos[kept] + 1).all()
    assert (t.right == R.pos[kept] + span[kept]).all()
    assert (t.mate_pos == R.next_pos[kept] + 1).all()


def test_effective_lengths_match_the_scalar_form():
    """The reference's bin weights take effective lengths over every
    fragment length at once; the scalar form (isoform.h's loop) is the
    oracle for each segment count and set of skipped segments."""
    import random
    import numpy as np
    from portbench.reference import effective_len, effective_lens
    rnd = random.Random(1)
    for _ in range(400):
        n = rnd.randint(1, 7)
        seg = [rnd.randint(1, 120) for _ in range(n)]
        inner = list(range(1, n - 1))
        if n == 3:
            implicit = rnd.choice([[], [1]])
        elif n == 4:
            implicit = rnd.choice([[], [1], [2], [1, 2]])
        else:
            implicit = sorted(rnd.sample(inner, rnd.randint(0, len(inner))))
        fl = np.arange(1, sum(seg) + 200)
        want = [effective_len(seg, implicit, int(f), 75) for f in fl]
        assert effective_lens(seg, implicit, fl, 75).tolist() == want
