"""The port stands on its own: no module of strawberry_tpu_torch (its
routing tools in tools/ too), and not chip_smoke.py, imports jax or anything of the JAX package (strawberry_tpu),
read statically with `ast` (the subprocess runs of test_torch_pipeline.py
show the same at run time). Also the port's host library: built from its
own native/ sources into build/strawberry_tpu_torch/, named by a hash of
the sources and the flags."""
import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PORT = os.path.join(ROOT, "strawberry_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "strawberry_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def forbidden_imports(path):
    """(line, module) of every absolute import of jax or strawberry_tpu,
    at any depth (lazy imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("rel", _sources())
def test_no_jax_or_jax_package_import(rel):
    assert forbidden_imports(os.path.join(ROOT, rel)) == []


def test_scan_covers_the_tools():
    """The routing tools (strawberry_tpu_torch/tools/) are scanned too."""
    tools = os.path.join(PORT, "tools")
    names = sorted(f for f in os.listdir(tools) if f.endswith(".py"))
    assert {"em_crossover.py", "mcf_crossover.py", "prep_crossover.py",
            "device_character.py", "realistic.py", "lowmem_scaling.py",
            "bench.py", "budget.py"} <= set(names)
    scanned = set(_sources())
    for f in names:
        assert os.path.relpath(os.path.join(tools, f), ROOT) in scanned, f


def test_the_check_finds_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "def f():\n    from strawberry_tpu.io import native\n"
                   "    from . import sim\n"
                   "    import strawberry_tpu_torch.sim\n")
    assert forbidden_imports(str(src)) == [(2, "jax.numpy"),
                                           (4, "strawberry_tpu.io")]


def test_host_library_built_from_port_sources():
    from strawberry_tpu_torch.io import native
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == os.path.join(
        ROOT, "build", "strawberry_tpu_torch")
    assert os.path.basename(lib._name).startswith("libstrawberry_host-")
    assert native._NATIVE == os.path.join(PORT, "native")
    for f in native._SOURCES:
        assert os.path.exists(os.path.join(native._NATIVE, f)), f
    # the name follows the flags, so a library linked against libdeflate
    # is never loaded where it is absent
    assert native._lib_path(("-lz",)) != native._lib_path(("-lz",
                                                             "-ldeflate"))
