"""Local model registry for the ``tpu://`` provider (PyTorch port).

Counterpart of ``adversarial_spec_tpu/engine/registry.py``, kept as the
port's own copy: the same built-in aliases, the same ``tpu://`` scheme and
the same registry file, so a debate's model list means the same thing to
both packages.


TPU-native replacement for the reference's provider registry + API keys +
Bedrock alias map (scripts/providers.py:57-185, 358-486; SURVEY §2.3): instead
of credentials for remote gateways, a registry entry describes how to
materialize a model locally — checkpoint path, family, tokenizer, mesh shape,
dtype. Aliasing (``tpu://llama3-8b`` → a checkpoint dir) mirrors Bedrock's
friendly-name aliasing; ``validate`` mirrors the per-model availability
preflight with actionable errors.

Built-in ``random-*`` entries materialize synthetic (randomly initialized)
checkpoints of real model-family shapes, so the full TPU path runs with zero
network egress — the test/bench story in an air-gapped environment.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from pathlib import Path

from adversarial_spec_tpu_torch.obs.events import atomic_write_text

REGISTRY_PATH = Path.home() / ".config" / "adversarial-spec-tpu" / "registry.json"

TPU_PREFIX = "tpu://"

# The ``quant`` field's vocabulary ("" = full precision). Lives here —
# not in ops/quant.py, which implements the formats — so validation and
# the CLI stay jax-free (importing ops.quant pulls in jax.numpy).
QUANT_FORMATS = ("", "int8", "int4")


@dataclass
class ModelSpec:
    """Everything needed to materialize one model on the mesh."""

    alias: str
    family: str = "llama"  # llama | mistral | gemma2 | qwen2 — see models/
    checkpoint: str = "random"  # HF checkpoint dir, or "random" for synthetic
    tokenizer: str = ""  # tokenizer dir/file; "" = whitespace fallback
    size: str = "tiny"  # named config within the family (tiny/1b/8b/70b)
    dtype: str = "bfloat16"
    mesh: dict[str, int] = field(default_factory=dict)  # e.g. {"tp": 8}
    # 0 = keep the model config's native context length (e.g. 131072 for
    # llama-3.2 1b/3b); nonzero overrides it.
    max_seq_len: int = 0
    # "" = full precision; "int8" / "int4" = weight-only quantization
    # (ops/quant.py QUANT_FORMATS) — int4 packs two weights per byte,
    # the format that fits a multi-model opponent pool resident.
    quant: str = ""
    kv: str = "dense"  # "dense" | "paged" — KV-cache layout for decode
    kv_dtype: str = ""  # "" = model dtype, "int8" = quantized KV cache

    def to_dict(self) -> dict:
        return asdict(self)


# Synthetic entries available without any registry file or downloads.
_BUILTIN: dict[str, ModelSpec] = {
    spec.alias: spec
    for spec in [
        ModelSpec(alias="random-tiny", family="llama", size="tiny"),
        ModelSpec(alias="random-gemma-tiny", family="gemma2", size="tiny"),
        ModelSpec(alias="random-mistral-tiny", family="mistral", size="tiny"),
        ModelSpec(alias="random-qwen-tiny", family="qwen2", size="tiny"),
        ModelSpec(alias="random-1b", family="llama", size="1b"),
        ModelSpec(alias="random-3b", family="llama", size="3b"),
        ModelSpec(alias="random-8b", family="llama", size="8b"),
        ModelSpec(alias="random-70b", family="llama", size="70b", mesh={"tp": 8}),
    ]
}


def parse_tpu_model_id(model: str) -> str:
    """``tpu://alias`` → ``alias`` (raises on other schemes)."""
    if not model.startswith(TPU_PREFIX):
        raise ValueError(f"not a tpu:// model id: {model}")
    return model[len(TPU_PREFIX) :]


def load_registry(registry_path: Path | None = None) -> dict[str, ModelSpec]:
    """Built-ins merged with user entries (user entries win)."""
    path = Path(registry_path or REGISTRY_PATH)
    out = dict(_BUILTIN)
    if path.is_file():
        try:
            data = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            return out
        for alias, entry in data.items():
            known = {f for f in ModelSpec.__dataclass_fields__}
            fields = {k: v for k, v in entry.items() if k in known}
            fields["alias"] = alias
            out[alias] = ModelSpec(**fields)
    return out


def save_registry_entry(
    spec: ModelSpec, registry_path: Path | None = None
) -> Path:
    path = Path(registry_path or REGISTRY_PATH)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {}
    if path.is_file():
        try:
            data = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            data = {}
    data[spec.alias] = spec.to_dict()
    # tmp+replace (GL-ATOMIC): a crash mid-save must not tear the
    # registry every later ``tpu://`` resolve parses.
    atomic_write_text(str(path), json.dumps(data, indent=2))
    return path


def remove_registry_entry(
    alias: str, registry_path: Path | None = None
) -> bool:
    path = Path(registry_path or REGISTRY_PATH)
    if not path.is_file():
        return False
    data = json.loads(path.read_text())
    if alias not in data:
        return False
    del data[alias]
    # tmp+replace (GL-ATOMIC): same discipline as save_registry_entry.
    atomic_write_text(str(path), json.dumps(data, indent=2))
    return True


def resolve_model_spec(
    model: str, registry_path: Path | None = None
) -> ModelSpec:
    alias = parse_tpu_model_id(model)
    registry = load_registry(registry_path)
    if alias not in registry:
        known = ", ".join(sorted(registry))
        raise KeyError(
            f"unknown tpu model alias {alias!r}. Registered aliases: {known}. "
            f"Add one with: debate registry add-model {alias} "
            f"--checkpoint /path/to/hf/dir --family llama"
        )
    return registry[alias]


def validate_tpu_model(
    model: str,
    registry_path: Path | None = None,
    registry: dict[str, ModelSpec] | None = None,
) -> str | None:
    """None if servable, else an actionable error (exit-code-2 material).

    Pass a preloaded ``registry`` to avoid re-reading the registry file once
    per model when validating a batch.
    """
    try:
        if registry is not None:
            alias = parse_tpu_model_id(model)
            if alias not in registry:
                known = ", ".join(sorted(registry))
                raise KeyError(
                    f"unknown tpu model alias {alias!r}. Registered "
                    f"aliases: {known}"
                )
            spec = registry[alias]
        else:
            spec = resolve_model_spec(model, registry_path)
    except (ValueError, KeyError) as e:
        return str(e).strip("'\"")
    if spec.quant not in QUANT_FORMATS:
        return (
            f"model {model} registers unknown quantization "
            f"{spec.quant!r}; known: "
            + ", ".join(repr(q) for q in QUANT_FORMATS)
        )
    if spec.checkpoint != "random":
        ckpt = Path(spec.checkpoint)
        if not ckpt.exists():
            return (
                f"checkpoint for {model} not found at {ckpt}; update it with "
                f"debate registry add-model {spec.alias} --checkpoint <dir>"
            )
    return None
