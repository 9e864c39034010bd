"""The plain online-softmax (flash) block update.

Counterpart of ``adversarial_spec_tpu/ops/flash_common.py:flash_update``.
The plain versions of all four decode-attention kernels
(``ops/decode_attention.py``, ``ops/paged_attention.py``) fold the cache
block by block through this one function, so the ``-inf`` handling for
fully masked blocks lives in exactly one place: a row whose window is
empty so far keeps ``m = -inf``, its ``alpha`` is forced to 0 and
``m_safe`` pins the exponent, so no NaN ever enters ``l`` or ``acc`` and
an empty window finalizes to exact zeros. The CUDA kernel
(``csrc/decode_attention.cu``) runs the same recurrence.
"""

from __future__ import annotations

import torch


def flash_update(
    q: torch.Tensor,  # [..., G, D] f32, pre-scaled
    k: torch.Tensor,  # [..., Tb, D] f32
    v: torch.Tensor,  # [..., Tb, D] f32
    t0: int,  # global slot index of k[..., 0, :]
    start: torch.Tensor,  # [..., G, 1] first valid slot (inclusive)
    end: torch.Tensor,  # [..., G, 1] first invalid slot (exclusive)
    m: torch.Tensor,  # [..., G, 1] running max
    l: torch.Tensor,  # [..., G, 1] running normalizer
    acc: torch.Tensor,  # [..., G, D] running weighted values
    *,
    attn_softcap: float,
    valid: torch.Tensor | None = None,  # [..., 1|G, Tb] bool: slot mapped
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One accumulation over a K/V block; returns (m, l, acc). ``valid``
    masks slots out on top of the window (the paged plain versions pass
    which slots lie in mapped pages)."""
    s = torch.matmul(q, k.transpose(-1, -2))  # [..., G, Tb]
    if attn_softcap > 0.0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    slot = t0 + torch.arange(k.shape[-2], device=k.device)
    ok = (slot >= start) & (slot < end)
    if valid is not None:
        ok = ok & valid
    s = torch.where(ok, s, float("-inf"))

    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.where(
        torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m)
    )
    p = torch.exp(s - m_safe)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p, v)
    return m_new, l_new, acc_new
