"""Rotary position embeddings (half-rotation NeoX/Llama layout).

Counterpart of ``adversarial_spec_tpu/ops/rope.py``: features split into
two halves that rotate together, the layout HF Llama/Mistral/Gemma/Qwen
checkpoints use. Tables are float32; the rotation is computed in float32
and cast back to the input dtype, as the reference does.
"""

from __future__ import annotations

import math

import torch


def _llama3_scale(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Llama-3.1/3.2 frequency-dependent scaling (HF ``rope_type="llama3"``)."""
    factor, low, high, original_max = scaling
    wavelen = 2.0 * math.pi / freqs
    ratio = original_max / wavelen
    smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
    return torch.where(
        ratio < low,
        freqs / factor,
        (1.0 - smooth) * freqs / factor + smooth * freqs,
    )


def rope_angles(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: tuple[float, float, float, float] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim//2] (float32) for integer positions."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (exps / half))
    if scaling is not None:
        freqs = _llama3_scale(freqs, scaling)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D//2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
