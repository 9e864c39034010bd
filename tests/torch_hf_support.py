"""Tiny HF checkpoints for the port's loader and cache tests
(``test_torch_loader.py``, ``test_torch_checkpoint.py``).

Each checkpoint is written locally by ``transformers`` ``save_pretrained``
(nothing is downloaded): ``config.json`` plus ``model.safetensors``, or,
sharded, several ``model-0000k-of-0000n.safetensors`` files with a
``model.safetensors.index.json``. Five configurations: the tiny configs of
``llama``, ``mistral``, ``qwen2`` (qkv bias) and ``gemma2`` (sandwich
norms, tied embeddings), and a tied llama (``dataclasses.replace``, as
``tests/test_loader.py`` builds one).

``assert_bit_identical`` holds the port's params (per-layer lists of
tensors) against the reference's (layer-stacked numpy arrays) leaf by
leaf, bits included.
"""

import copy
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from adversarial_spec_tpu.models.config import get_config as ref_get_config
from adversarial_spec_tpu_torch.engine import checkpoint as ckpt_mod
from adversarial_spec_tpu_torch.models.config import get_config

CASES = ("llama", "mistral", "qwen2", "gemma2", "llama_tied")
SOURCE_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def family_of(case: str) -> str:
    return "llama" if case == "llama_tied" else case


def configs(case: str):
    """(the port's config, the reference's) for ``case``."""
    family = family_of(case)
    cfg, ref_cfg = get_config(family, "tiny"), ref_get_config(family, "tiny")
    if case == "llama_tied":
        cfg = replace(cfg, tied_embeddings=True)
        ref_cfg = replace(ref_cfg, tied_embeddings=True)
    return cfg, ref_cfg


def hf_model(case: str):
    """A transformers model of ``case``'s tiny config, seeded."""
    import transformers

    cfg, _ = configs(case)
    kwargs = dict(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.dim,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        intermediate_size=cfg.ffn_dim,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps,
        max_position_embeddings=256,
        tie_word_embeddings=cfg.tied_embeddings,
    )
    family = family_of(case)
    if family == "llama":
        hf_cfg = transformers.LlamaConfig(**kwargs)
    elif family == "qwen2":
        hf_cfg = transformers.Qwen2Config(**kwargs)
    elif family == "mistral":
        hf_cfg = transformers.MistralConfig(**kwargs, sliding_window=cfg.sliding_window)
    else:
        hf_cfg = transformers.Gemma2Config(
            **kwargs,
            head_dim=cfg.head_dim,
            hidden_activation="gelu_pytorch_tanh",
            query_pre_attn_scalar=cfg.head_dim,
            attn_logit_softcapping=cfg.attn_softcap,
            final_logit_softcapping=cfg.logit_softcap,
            sliding_window=cfg.sliding_window,
        )
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg)
    # Weights at the reference's init scale (transformers' std 0.02 makes
    # near-uniform logits, where greedy text would hinge on rounding), and
    # norms and biases away from their init (ones or zeros), so a
    # misplaced one cannot pass as the right one.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "bias" in name:
                p.uniform_(-0.5, 0.5)
            elif "embed" in name:
                p.normal_(0.0, 1.0)
            else:
                p.normal_(0.0, p.shape[1] ** -0.5)
    return model


def write_checkpoint(model, path: Path, dtype: str = "f32", sharded: bool = False) -> Path:
    """``model`` saved at ``path`` in ``dtype``, sharded (several files and
    an index) or as one file."""
    copy.deepcopy(model).to(SOURCE_DTYPES[dtype]).save_pretrained(
        path, safe_serialization=True, max_shard_size="200KB" if sharded else "5GB"
    )
    return path


def _bits(x) -> np.ndarray:
    """An array's raw bits, bf16 included (as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def ref_leaf(ref_params, name: str):
    """The reference's leaf (numpy) under the port's flat cache name."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = ref_params["layers"][parts[2]]
        if len(parts) == 4:
            node = node[parts[3]]
        return np.asarray(node)[int(parts[1])]
    node = ref_params[parts[0]]
    return np.asarray(node[parts[1]] if len(parts) == 2 else node)


def ref_names(ref_params, n_layers: int) -> set[str]:
    """The reference's leaves under the port's flat names."""
    names = set()
    for key, leaf in ref_params.items():
        if key == "layers":
            for sub, stacked in leaf.items():
                parts = stacked.keys() if isinstance(stacked, dict) else [None]
                for i in range(n_layers):
                    for p in parts:
                        names.add(f"layers.{i}.{sub}" + (f".{p}" if p else ""))
        elif isinstance(leaf, dict):
            names |= {f"{key}.{p}" for p in leaf}
        else:
            names.add(key)
    return names


def assert_bit_identical(port_params, ref_params, n_layers: int) -> int:
    """Every leaf of both packages present in both, of one dtype and shape
    and the same bits. Returns the number of leaves compared."""
    flat = ckpt_mod.flatten(port_params)
    assert set(flat) == ref_names(ref_params, n_layers)
    for name, t in flat.items():
        got, want = _bits(t.cpu()), _bits(ref_leaf(ref_params, name))
        assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype)
        assert np.array_equal(got, want), name
    return len(flat)
