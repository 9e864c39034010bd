"""Import discipline of the PyTorch port.

The port imports torch, numpy and the standard library: never jax, and
nothing of the reference package ``adversarial_spec_tpu`` (whose name is a
prefix of the port's own — matched here by whole dotted components). Nor
does it import the packages the GPU machine lacks — ``safetensors``,
``orbax``, ``ml_dtypes``, ``transformers``, ``tokenizers``, ``regex`` — anywhere
(``engine/tokenizer_json.py`` reads ``tokenizer.json`` itself).
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
# ml_dtypes ships with jax: the port writes and reads bf16 KV-tier
# entries without it (engine/kvtier.py), and the card's machine lacks it.
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "adversarial_spec_tpu")


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


# Packages the GPU machine does not have; (package, the port files that
# may import it).
ABSENT_ON_CARD = {
    "safetensors": (),
    "orbax": (),
    "ml_dtypes": (),
    "transformers": (),
    "tokenizers": (),
    "regex": (),
}


@pytest.mark.parametrize(
    "path",
    sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path",
    sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_imports_the_card_machine_lacks(path):
    rel = str(path.relative_to(REPO))
    bad = [
        n for n in _imported_modules(path)
        if n.split(".")[0] in ABSENT_ON_CARD and rel not in ABSENT_ON_CARD[n.split(".")[0]]
    ]
    assert not bad, f"{rel} imports {bad}"


def test_loader_runs_without_the_packages_the_card_machine_lacks(tmp_path):
    """In a process where jax, the reference package and every package of
    ``ABSENT_ON_CARD`` fail to import, the port writes an HF-layout
    checkpoint with its own ``save_file``, loads it (cold, then from its
    native cache) and quantizes it."""
    blocked = ["jax", "adversarial_spec_tpu", *ABSENT_ON_CARD]
    code = (
        "import sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "import json, torch\n"
        "from adversarial_spec_tpu_torch.engine import checkpoint, loader\n"
        "from adversarial_spec_tpu_torch.models.config import get_config\n"
        "from adversarial_spec_tpu_torch.models.transformer import init_params\n"
        "from adversarial_spec_tpu_torch.utils.safetensors import save_file\n"
        "cfg = get_config('llama', 'tiny')\n"
        "p = init_params(cfg, device=torch.device('cpu'), dtype=torch.float32)\n"
        "names = {'input_layernorm.weight': 'attn_norm', 'self_attn.q_proj.weight': 'wq',\n"
        "    'self_attn.k_proj.weight': 'wk', 'self_attn.v_proj.weight': 'wv',\n"
        "    'self_attn.o_proj.weight': 'wo', 'post_attention_layernorm.weight': 'ffn_norm',\n"
        "    'mlp.gate_proj.weight': 'w_gate', 'mlp.up_proj.weight': 'w_up',\n"
        "    'mlp.down_proj.weight': 'w_down'}\n"
        "hf = {'model.embed_tokens.weight': p['embed'], 'model.norm.weight': p['final_norm'],\n"
        "      'lm_head.weight': p['lm_head'].t()}\n"
        "for i, lp in enumerate(p['layers']):\n"
        "    for h, k in names.items():\n"
        "        hf[f'model.layers.{i}.{h}'] = lp[k].t() if lp[k].dim() == 2 else lp[k]\n"
        f"d = {str(tmp_path)!r}\n"
        "save_file(hf, d + '/model.safetensors')\n"
        "got, _ = loader.materialize_params(d, 'llama', 'tiny', dtype=torch.float32,\n"
        "                                   device='cpu', quant='int4')\n"
        "cache = checkpoint.cache_dir_for(d, 'llama', 'tiny', 'float32', 'int4')\n"
        "checkpoint.save_native(got, cache)\n"
        "again = checkpoint.load_native(cache, cfg, torch.float32, 'int4', torch.device('cpu'))\n"
        "a, b = checkpoint.flatten(got), checkpoint.flatten(again)\n"
        "assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)\n"
        "print('ok', len(a))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_forbidden_matcher_minds_the_suffix():
    assert _forbidden("adversarial_spec_tpu.engine.tpu")
    assert _forbidden("jax.numpy")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("adversarial_spec_tpu_torch.engine.gpu")


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    (and ``ml_dtypes`` and the reference package) fail."""
    mods = [
        m.name
        for m in pkgutil.walk_packages([str(PKG_DIR)], "adversarial_spec_tpu_torch.")
    ]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
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
    debate_path = {
        f"adversarial_spec_tpu_torch.{m}"
        for m in (
            "cli", "debate.core", "debate.journal", "debate.session",
            "debate.profiles", "debate.parsing", "debate.prompts",
            "debate.telegram", "debate.types", "debate.usage", "obs",
            "obs.events", "obs.metrics", "obs.retrace", "obs.trace",
            "resilience", "resilience.breaker", "resilience.faults",
            "resilience.injector", "resilience.lockdep", "utils.tracing",
            "engine.mock", "engine.weightres", "engine.dispatch",
        )
    }
    assert debate_path <= set(mods)
    assert len(mods) >= 47


def test_materialize_params_requires_device_or_gpu():
    import torch

    from adversarial_spec_tpu_torch.engine.loader import materialize_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize_params("random", "llama", "tiny")
