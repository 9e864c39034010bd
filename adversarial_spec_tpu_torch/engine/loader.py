"""Parameter materialization for the PyTorch port.

Counterpart of ``adversarial_spec_tpu/engine/loader.py``. Two jobs:

- ``materialize_params``: ``checkpoint == "random"`` builds synthetic
  weights of the family's real shape directly on the target device
  (``models/transformer.py:init_params``). HF safetensors loading and
  weight quantization are not ported yet and raise.
- ``params_from_jax``: the weight bridge from the reference package's
  param pytree (as numpy arrays) to the port's layout, so both packages
  can run on the SAME weights.
"""

from __future__ import annotations

import numpy as np
import torch

from adversarial_spec_tpu_torch.models.config import ModelConfig, get_config
from adversarial_spec_tpu_torch.models.transformer import Params, init_params
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
    ``cuda``). Returns (params, cfg)."""
    device = resolve_device(device)
    cfg = get_config(family, size, max_seq_len=max_seq_len)
    if checkpoint != "random":
        raise NotImplementedError(
            f"checkpoint {checkpoint!r}: HF safetensors loading is not yet "
            "ported to the PyTorch package (synthetic 'random' only)"
        )
    if quant:
        raise NotImplementedError(
            f"weight quantization {quant!r} is not yet ported to the "
            "PyTorch package"
        )
    return init_params(cfg, device=device, dtype=dtype, seed=seed), cfg


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
    Quantized leaves are not ported and raise.
    """
    device = torch.device(device)

    def conv(x) -> torch.Tensor:
        if isinstance(x, dict):
            raise NotImplementedError(
                "quantized weights are not yet ported to the PyTorch package"
            )
        arr = np.array(x, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    stacked = np_params["layers"]
    layers = [
        {name: conv(np.asarray(stacked[name])[i]) for name in stacked}
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
