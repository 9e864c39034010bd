"""Parameter materialization for the PyTorch port.

Counterpart of ``adversarial_spec_tpu/engine/loader.py``. Two jobs:

- ``materialize_params``: ``checkpoint == "random"`` builds synthetic
  weights of the family's real shape directly on the target device
  (``models/transformer.py:init_params``), then, for ``quant="int8"`` or
  ``"int4"``, quantizes the matmul weights (``ops/quant.py``) layer by
  layer in place. HF safetensors loading is not ported yet and raises.
- ``params_from_jax``: the weight bridge from the reference package's
  param pytree (as numpy arrays) to the port's layout, so both packages
  can run on the SAME weights.
"""

from __future__ import annotations

import numpy as np
import torch

from adversarial_spec_tpu_torch.models.config import ModelConfig, get_config
from adversarial_spec_tpu_torch.models.transformer import Params, init_params
from adversarial_spec_tpu_torch.ops.quant import quantize_params
from adversarial_spec_tpu_torch.utils.device import resolve_device


def materialize_params(
    checkpoint: str,
    family: str,
    size: str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    max_seq_len: int = 0,
    quant: str = "",
    device: str | torch.device | None = None,
) -> tuple[Params, ModelConfig]:
    """Synthetic init for ``checkpoint="random"`` on ``device`` (default
    ``cuda``), its matmul weights quantized when ``quant`` names a format
    (as the reference quantizes at materialization). Returns (params,
    cfg)."""
    device = resolve_device(device)
    cfg = get_config(family, size, max_seq_len=max_seq_len)
    if checkpoint != "random":
        raise NotImplementedError(
            f"checkpoint {checkpoint!r}: HF safetensors loading is not yet "
            "ported to the PyTorch package (synthetic 'random' only)"
        )
    params = init_params(cfg, device=device, dtype=dtype, seed=seed)
    if quant:
        # In place, layer by layer: each full-precision weight is freed
        # as its quantized form replaces it.
        quantize_params(params, fmt=quant)
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
