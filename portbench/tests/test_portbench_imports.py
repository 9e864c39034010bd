"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "adversarial_spec_tpu"}


def top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_names(path) <= {"__future__", "math", "torch"}


def test_the_check_sees_a_prefixed_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import adversarial_spec_tpu_torch.engine\n"
                     "from adversarial_spec_tpu.engine import x\n")
    assert top_names(probe) == {"adversarial_spec_tpu_torch", "adversarial_spec_tpu"}
