"""The port's import boundary, by an AST scan of every module of
``tpushare_torch`` and of ``chip_smoke.py``: no JAX and nothing of the JAX
package, and no ``triton`` or kernel library loaded at module top level,
so that collecting the tests never needs them."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "tpushare_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, top level?) for every import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


def _root(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _ in _imports(tree):
        assert _root(name) not in ("jax", "jaxlib", "tpushare", "flax",
                                   "optax"), f"{path.name} imports {name}"


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_kernel_toolchain_at_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        if top:
            assert _root(name) != "triton", f"{path.name} imports {name}"
    for node in tree.body:
        for call in ast.walk(node):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                break
            if isinstance(call, ast.Call):
                fn = call.func
                name = getattr(fn, "attr", getattr(fn, "id", ""))
                assert name not in ("CDLL", "LoadLibrary", "load", "build"), \
                    f"{path.name} loads a library at import"


def test_the_scan_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"tpushare_torch/kernels/flash.py",
            "tpushare_torch/kernels/flash_bwd.py", "tpushare_torch/entry.py",
            "tpushare_torch/workloads/serve.py",
            "tpushare_torch/workloads/player.py",
            "tpushare_torch/workloads/vit.py",
            "tpushare_torch/workloads/checkpoint.py",
            "tpushare_torch/workloads/migrate.py",
            "tpushare_torch/workloads/moe.py",
            "tpushare_torch/workloads/parallel.py",
            "tpushare_torch/workloads/ringattention.py",
            "tpushare_torch/workloads/ulysses.py",
            "tpushare_torch/workloads/pipeline.py", "chip_smoke.py"} <= names
    tree = ast.parse("import jax\nfrom tpushare.x import y\n"
                     "def f():\n    import triton\n")
    assert list(_imports(tree)) == [("jax", True), ("tpushare.x", True),
                                    ("triton", False)]
