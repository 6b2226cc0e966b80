"""No module of the benchmark imports JAX, flax or the JAX package (by
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import os

from benchmark.harness import HERE, forbidden_loaded

FORBIDDEN = {"jax", "jaxlib", "flax", "ddsp_pytorch_tpu"}
PORT = "ddsp_pytorch_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p, m) for p in _modules() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert found == []


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    found = [(f, m) for f in os.listdir(ref) if f.endswith(".py")
             for m in _imports(os.path.join(ref, f)) if m.split(".")[0] == PORT]
    assert found == []


def test_the_scan_sees_an_import_it_must_refuse(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom ddsp_pytorch_tpu.ops import x\nimport ddsp_pytorch_tpu_torch\n")
    names = [m.split(".")[0] for m in _imports(str(p))]
    assert [n for n in names if n in FORBIDDEN] == ["jax", "ddsp_pytorch_tpu"]


def test_forbidden_loaded_compares_whole_names():
    assert forbidden_loaded(["ddsp_pytorch_tpu_torch.ops", "numpy"]) == []
    assert forbidden_loaded(["ddsp_pytorch_tpu.ops", "jaxlib.xla", "flax"]) == ["ddsp_pytorch_tpu", "flax", "jaxlib"]
