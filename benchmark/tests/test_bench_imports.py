"""The benchmark measures the port alone: no module under ``benchmark/``
imports JAX or the JAX package (compared by whole top-level names, since
the port's name begins with the JAX package's), the plain reference
imports nothing of the port, and nothing reads the JAX package's own
benchmark or records."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FILES = sorted(BENCH.rglob("*.py"))
THIS = Path(__file__).resolve()
REFERENCE = sorted((BENCH / "reference").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpushare"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_module():
    assert len(FILES) > 20 and REFERENCE


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "tpushare_torch" not in names
    assert names <= {"__future__", "dataclasses", "math", "torch"}, names


@pytest.mark.parametrize("path", [f for f in FILES if f != THIS],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_jax_benchmark_or_records(path):
    text = path.read_text()
    for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.",
                 "tests_tpu", '"tpushare/', "'tpushare/"):
        assert name not in text, f"{path} names {name}"


def test_scan_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import tpushare_torch.workloads\nfrom jaxtyping import x\n"
                   "import tpushare.core as c\nfrom . import sibling\n")
    assert top_level_imports(src) == {"tpushare_torch", "jaxtyping",
                                      "tpushare"}
