"""Import discipline of the PyTorch port.

The port imports torch, numpy and the standard library: never jax, and
nothing of the reference package ``adversarial_spec_tpu`` (whose name is a
prefix of the port's own — matched here by whole dotted components).
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import adversarial_spec_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG_DIR = Path(adversarial_spec_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adversarial_spec_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize(
    "path",
    sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_matcher_minds_the_suffix():
    assert _forbidden("adversarial_spec_tpu.engine.tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("adversarial_spec_tpu_torch.engine.gpu")


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    (and the reference package) fail."""
    mods = [
        m.name
        for m in pkgutil.walk_packages([str(PKG_DIR)], "adversarial_spec_tpu_torch.")
    ]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['adversarial_spec_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    paged_path = {
        f"adversarial_spec_tpu_torch.{m}"
        for m in (
            "engine.kvcache", "engine.kvtier", "engine.prefix_cache",
            "engine.procconfig", "engine.interleave", "engine.streaming",
            "engine.scheduler", "ops.paged_attention",
        )
    }
    assert paged_path <= set(mods)
    assert len(mods) >= 23


def test_materialize_params_requires_device_or_gpu():
    import torch

    from adversarial_spec_tpu_torch.engine.loader import materialize_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize_params("random", "llama", "tiny")
