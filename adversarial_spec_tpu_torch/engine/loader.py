"""Parameter materialization for the PyTorch port.

Counterpart of ``adversarial_spec_tpu/engine/loader.py``. Three jobs:

- ``materialize_params``: ``checkpoint == "random"`` builds synthetic
  weights of the family's real shape directly on the target device
  (``models/transformer.py:init_params``); any other checkpoint is an HF
  safetensors directory read by ``load_hf_checkpoint``. For
  ``quant="int8"`` or ``"int4"`` the matmul weights are quantized
  (``ops/quant.py``) layer by layer.
- ``load_hf_checkpoint``: the checkpoint's ``config.json`` is checked
  against the registered config first (``preflight_config``), then each
  tensor is read on its own (``utils/safetensors.py``, the port's own
  reader), moved to the device and cast to the model dtype and, for a
  Linear weight, transposed there from torch's ``[out, in]`` to the
  ``[in, out]`` layout the port shares with the reference. The port keeps
  per-layer lists, so nothing is stacked: the host stages one tensor at a
  time (the reference stages one layer-stacked param), and with ``quant``
  a layer is quantized as it lands, so the device never holds the whole
  model at full precision.
- ``params_from_jax``: the weight bridge from the reference package's
  param pytree (as numpy arrays) to the port's layout, so both packages
  can run on the SAME weights.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from adversarial_spec_tpu_torch.engine.checkpoint import (
    layer_shapes,
    transposed_head_flag,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig, get_config
from adversarial_spec_tpu_torch.models.transformer import Params, init_params
from adversarial_spec_tpu_torch.parallel.sharding import place_tree
from adversarial_spec_tpu_torch.ops.quant import quantize_params
from adversarial_spec_tpu_torch.utils import safetensors
from adversarial_spec_tpu_torch.utils.device import resolve_device

# Our layer-param name → HF per-layer tensor name (layers.{i} prefix added).
_HF_LAYER_MAP = {
    "attn_norm": "input_layernorm.weight",
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "bq": "self_attn.q_proj.bias",
    "bk": "self_attn.k_proj.bias",
    "bv": "self_attn.v_proj.bias",
    "ffn_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
    # Gemma-2 sandwich norms (HF names).
    "post_attn_norm": "post_attention_layernorm.weight",
    "ffn_norm_gemma2": "pre_feedforward_layernorm.weight",
    "post_ffn_norm": "post_feedforward_layernorm.weight",
}

_TRANSPOSE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


class CheckpointConfigError(ValueError):
    """Registered architecture contradicts the checkpoint's config.json."""


def preflight_config(
    ckpt_dir: str | Path, cfg: ModelConfig, family: str
) -> None:
    """Cross-check the registered ModelConfig against the checkpoint's own
    ``config.json`` before any tensor is read.

    A mis-registered alias (wrong --family/--size for the directory it
    points at) would otherwise produce garbage logits with no error —
    shapes can coincide while rope_theta, GQA ratio, or tied embeddings
    differ. The upstream debate tool fails fast with an actionable
    message at model access time (scripts/providers.py:418-486, key/alias
    preflight); this is the checkpoint-dir analog, with the JAX package's
    checks and words. A checkpoint without config.json (e.g. bare
    safetensors exports, test fixtures) is not checked.
    """
    path = Path(ckpt_dir) / "config.json"
    if not path.is_file():
        return
    try:
        hf = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointConfigError(
            f"unreadable config.json under {ckpt_dir}: {e}"
        ) from e

    problems: list[str] = []
    model_type = hf.get("model_type")
    if model_type is not None and str(model_type) != family:
        problems.append(
            f"model_type: checkpoint is {model_type!r}, "
            f"alias registered as family {family!r}"
        )

    scalar_checks = [
        ("hidden_size", "dim", cfg.dim),
        ("num_hidden_layers", "n_layers", cfg.n_layers),
        ("num_attention_heads", "n_heads", cfg.n_heads),
        ("num_key_value_heads", "n_kv_heads", cfg.n_kv_heads),
        ("intermediate_size", "ffn_dim", cfg.ffn_dim),
        ("vocab_size", "vocab_size", cfg.vocab_size),
        ("head_dim", "head_dim", cfg.head_dim),
        ("tie_word_embeddings", "tied_embeddings", cfg.tied_embeddings),
    ]
    # Qwen2 configs ship "sliding_window": 131072 with
    # "use_sliding_window": false — the declared window is inert, so
    # only compare when the checkpoint actually uses it.
    if hf.get("use_sliding_window", True):
        scalar_checks.append(
            ("sliding_window", "sliding_window", cfg.sliding_window)
        )
    for hf_key, field, want in scalar_checks:
        got = hf.get(hf_key)
        if got is None:
            continue
        try:
            if isinstance(want, bool):
                # Only a real JSON boolean (or 0/1) may match — bool([])
                # style coercion would silently pass malformed values.
                ok = (
                    isinstance(got, bool)
                    or (isinstance(got, int) and got in (0, 1))
                ) and bool(got) == want
            elif isinstance(want, float):
                ok = abs(float(got) - float(want)) < 1e-6
            else:
                ok = int(got) == want
        except (TypeError, ValueError):
            # A malformed value (string where a number belongs) is a
            # mismatch to report, never a crash.
            ok = False
        if not ok:
            problems.append(
                f"{hf_key}: checkpoint has {got!r}, registered config "
                f"({field}) has {want!r}"
            )

    theta = hf.get("rope_theta")
    if theta is not None:
        try:
            theta_mismatch = abs(float(theta) - cfg.rope_theta) > 1e-3
        except (TypeError, ValueError):
            theta_mismatch = True
        if theta_mismatch:
            problems.append(
                f"rope_theta: checkpoint has {theta!r}, registered config "
                f"has {cfg.rope_theta!r}"
            )

    rs = hf.get("rope_scaling")
    if rs is not None and not isinstance(rs, dict):
        problems.append(
            f"rope_scaling: checkpoint value {rs!r} is not an object"
        )
        rs = None
    rs_type = (rs or {}).get("rope_type", (rs or {}).get("type"))
    if rs and rs_type == "llama3":
        if cfg.rope_scaling is None:
            problems.append(
                "rope_scaling: checkpoint uses llama3 scaling "
                f"(factor={rs.get('factor')}), registered config is "
                "unscaled — long-context positions would be wrong"
            )
        else:
            want_f, want_lo, want_hi, want_orig = cfg.rope_scaling
            pairs = [
                ("factor", rs.get("factor"), want_f),
                ("low_freq_factor", rs.get("low_freq_factor"), want_lo),
                ("high_freq_factor", rs.get("high_freq_factor"), want_hi),
                (
                    "original_max_position_embeddings",
                    rs.get("original_max_position_embeddings"),
                    want_orig,
                ),
            ]
            for key, got, want in pairs:
                if got is None:
                    continue
                try:
                    pair_mismatch = abs(float(got) - want) > 1e-6
                except (TypeError, ValueError):
                    pair_mismatch = True
                if pair_mismatch:
                    problems.append(
                        f"rope_scaling.{key}: checkpoint has {got!r}, "
                        f"registered config has {want!r}"
                    )
    elif not rs and cfg.rope_scaling is not None:
        problems.append(
            "rope_scaling: registered config expects llama3 scaling "
            f"(factor={cfg.rope_scaling[0]}), checkpoint has none"
        )

    if problems:
        detail = "\n  - ".join(problems)
        raise CheckpointConfigError(
            f"checkpoint {ckpt_dir} does not match the registered "
            f"architecture for family {family!r}:\n  - {detail}\n"
            "Fix: re-register the alias with the family/size that matches "
            "this checkpoint (`registry` action, see `status`), or point "
            "it at the right directory. Loading anyway would produce "
            "garbage logits, not an error."
        )


def _open_safetensors(ckpt_dir: Path) -> dict[str, Path]:
    """Return {tensor_name: file} across all shards: the index's weight
    map when there is one, else every ``*.safetensors`` of the directory."""
    index_path = ckpt_dir / "model.safetensors.index.json"
    files: dict[str, Path] = {}
    if index_path.is_file():
        index = json.loads(index_path.read_text())
        for name, fname in index["weight_map"].items():
            files[name] = ckpt_dir / fname
    else:
        shards = sorted(ckpt_dir.glob("*.safetensors"))
        if not shards:
            raise FileNotFoundError(f"no *.safetensors under {ckpt_dir}")
        for shard in shards:
            for name in safetensors.read_header(shard).tensors:
                files[name] = shard
    return files


def load_hf_checkpoint(
    ckpt_dir: str | Path,
    cfg: ModelConfig,
    family: str,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    transposed_head: bool | None = None,
    quant: str = "",
    device_put=None,
) -> Params:
    """Read an HF checkpoint dir into the port's per-layer params on
    ``device`` (default ``cuda``).

    Each tensor is read alone, moved to the device and cast to ``dtype``
    and, for a Linear weight, transposed there; its host buffer is freed
    before the next tensor is read. With ``quant`` ("int8" /
    "int4"), each layer's matmul weights, and then the head, are
    quantized as soon as they have landed — the leaves are bit-identical
    to ``quantize_params`` over the whole full-precision model.

    ``transposed_head``: materialize the [D, V] head copy for tied
    configs (models/transformer.py:init_params). None reads the
    ADVSPEC_TRANSPOSED_HEAD env var (default on).

    ``device_put(path, tensor)`` (``parallel/sharding.py``
    ``make_device_put``) places each leaf on a mesh as soon as its layer
    (or, for the embedding, the norm and the head, the model) is read and
    quantized: the full-precision layer on ``device`` is freed before the
    next layer is read. The leaves are then the hook's values.
    """
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    preflight_config(ckpt_dir, cfg, family)
    files = _open_safetensors(ckpt_dir)
    prefix = "model."

    def hf_name(layer_key: str) -> str:
        if family == "gemma2" and layer_key == "ffn_norm":
            return _HF_LAYER_MAP["ffn_norm_gemma2"]
        return _HF_LAYER_MAP[layer_key]

    # Every tensor present before any is read, checked in the order the
    # reference reads them (so a gap is named as the reference names it).
    needed = [
        f"{prefix}layers.{i}.{hf_name(key)}"
        for key in layer_shapes(cfg)
        for i in range(cfg.n_layers)
    ] + [f"{prefix}embed_tokens.weight", f"{prefix}norm.weight"]
    if not cfg.tied_embeddings:
        needed.append("lm_head.weight")
    for name in needed:
        if name not in files:
            raise KeyError(f"tensor {name!r} missing from checkpoint")

    def take(name: str, transpose: bool = False) -> torch.Tensor:
        t = safetensors.read_tensor(files[name], name).to(device=device, dtype=dtype)
        return t.t().contiguous() if transpose else t  # [out, in] → [in, out]

    params: Params = {"embed": take(f"{prefix}embed_tokens.weight"), "layers": []}
    for i in range(cfg.n_layers):
        lp = {
            key: take(f"{prefix}layers.{i}.{hf_name(key)}", key in _TRANSPOSE)
            for key in layer_shapes(cfg)
        }
        lp = quantize_params(lp, fmt=quant) if quant else lp
        if device_put is not None:
            lp = place_tree(device_put, lp, ("layers", i), consume=True)
        params["layers"].append(lp)
    params["final_norm"] = take(f"{prefix}norm.weight")
    if transposed_head is None:
        transposed_head = transposed_head_flag()
    if not cfg.tied_embeddings:
        params["lm_head"] = take("lm_head.weight", transpose=True)
    elif transposed_head:
        # Transposed [D, V] copy of the tied table (the decode head's
        # row-major weight, models/transformer.py:init_params).
        params["lm_head_t"] = params["embed"].t().contiguous()
    # Layer leaves already placed are neither tensors nor dicts to the
    # quantizer: only the head is left to quantize.
    params = quantize_params(params, fmt=quant) if quant else params
    if device_put is not None:
        for name in [k for k in params if k != "layers"]:
            params[name] = place_tree(device_put, params[name], (name,), consume=True)
    return params


def materialize_params(
    checkpoint: str,
    family: str,
    size: str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    max_seq_len: int = 0,
    quant: str = "",
    device: str | torch.device | None = None,
    device_put=None,
) -> tuple[Params, ModelConfig]:
    """``checkpoint == "random"`` → synthetic init on ``device`` (default
    ``cuda``); else the HF safetensors dir it names. The matmul weights
    are quantized when ``quant`` names a format (as the reference
    quantizes at materialization). ``device_put``: the mesh placement
    hook (see ``load_hf_checkpoint``). The synthetic init quantizes and
    places each layer as it is drawn, before the next: one layer's full
    leaves are held at a time beside what is already placed. Returns
    (params, cfg)."""
    device = resolve_device(device)
    cfg = get_config(family, size, max_seq_len=max_seq_len)
    if checkpoint != "random":
        params = load_hf_checkpoint(
            checkpoint, cfg, family, dtype=dtype, device=device, quant=quant,
            device_put=device_put,
        )
        return params, cfg
    place = None
    if quant or device_put is not None:
        def place(path, node):
            if quant:
                node = quantize_params({path[-1]: node}, fmt=quant)[path[-1]]
            if device_put is not None:
                node = place_tree(device_put, node, path, consume=True)
            return node

    params = init_params(cfg, device=device, dtype=dtype, seed=seed, place=place)
    return params, cfg


def _take(a, layer: int | None) -> np.ndarray:
    """One layer's slice of a stacked array (or the array itself)."""
    a = np.asarray(a)
    return a if layer is None else a[layer]


def params_from_jax(
    np_params: dict,
    cfg: ModelConfig,
    device: str | torch.device,
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """The reference's param pytree (numpy arrays) → the port's params.

    Input layout (``adversarial_spec_tpu/models/transformer.py``): layer
    weights stacked on a leading ``n_layers`` axis,
    ``{"embed": [V, D], "layers": {name: [L, ...]}, "final_norm": [D],
    "lm_head": [D, V]}`` — or, for tied embeddings, ``"lm_head_t"``
    ([D, V], the transposed copy of the table) or no head at all.
    Matmul weights are ``[in, out]`` in both packages, so nothing is
    transposed; the qkv biases (qwen-2) and the sandwich post-norms
    (gemma-2) map by name.

    Output layout: the same names with ``"layers"`` split into a list of
    per-layer dicts. Norm weights are copied raw: a ``(1 + w)`` scale
    (``cfg.norm_scale_plus_one``, gemma) is applied at run time by
    ``rms_norm`` in both packages, so the stored ``w`` is the same.

    Quantized leaves (``ops/quant.py``: ``{"q" | "q4", "scale"}``, stacked
    ``[L, K | ceil(K/2), N]`` and ``[L, 1, N]`` in the layers) are sliced
    per layer and keep their types — int8 ``q``/``q4``, f32 ``scale`` —
    instead of taking the model dtype.
    """
    device = torch.device(device)

    def conv(x, layer=None):
        if isinstance(x, dict):  # a quantized leaf: its types kept
            return {
                k: torch.from_numpy(np.array(_take(v, layer))).to(device)
                for k, v in x.items()
            }
        arr = np.array(_take(x, layer), dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    stacked = np_params["layers"]
    layers = [
        {name: conv(stacked[name], i) for name in stacked}
        for i in range(cfg.n_layers)
    ]
    params: Params = {
        "embed": conv(np_params["embed"]),
        "layers": layers,
        "final_norm": conv(np_params["final_norm"]),
    }
    for head in ("lm_head", "lm_head_t"):
        if head in np_params:
            params[head] = conv(np_params[head])
    return params
