"""The plain online-softmax (flash) block update.

Counterpart of ``adversarial_spec_tpu/ops/flash_common.py:flash_update``.
The plain versions of all four decode-attention kernels
(``ops/decode_attention.py``, ``ops/paged_attention.py``) fold the cache
block by block through this one function, so the ``-inf`` handling for
fully masked blocks lives in exactly one place: a row whose window is
empty so far keeps ``m = -inf``, its ``alpha`` is forced to 0 and
``m_safe`` pins the exponent, so no NaN ever enters ``l`` or ``acc`` and
an empty window finalizes to exact zeros. The CUDA kernels
(``csrc/decode_attention.cu``, ``csrc/verify_attention.cu``) run the same
recurrence.

``combine_partials`` is the plain form of the verify kernels' combine
pass (split-KV partials merged by the log-sum-exp rescale); the tests
fold a split-and-combine mirror of those kernels through it.
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
    k_col_scale: torch.Tensor | None = None,  # [..., 1, Tb] f32
    v_row_scale: torch.Tensor | None = None,  # [..., 1, Tb] f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One accumulation over a K/V block; returns (m, l, acc). ``valid``
    masks slots out on top of the window (the paged plain versions pass
    which slots lie in mapped pages). ``k_col_scale`` multiplies each slot's
    score column and ``v_row_scale`` each slot's probability in the P V
    product only (not in ``l``): an int8 block's scales applied as the
    bf16 verify kernel applies them, to undequantized K/V."""
    s = torch.matmul(q, k.transpose(-1, -2))  # [..., G, Tb]
    if k_col_scale is not None:
        s = s * k_col_scale
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
    pv = p if v_row_scale is None else p * v_row_scale
    acc_new = acc * alpha + torch.matmul(pv, v)
    return m_new, l_new, acc_new


def combine_partials(
    m: torch.Tensor,  # [n_split, ..., G, 1] each split's running max
    l: torch.Tensor,  # [n_split, ..., G, 1] its normalizer
    acc: torch.Tensor,  # [n_split, ..., G, D] its unnormalized weighted values
) -> torch.Tensor:
    """Merge split-KV partials by the log-sum-exp rescale: f32 [..., G, D]
    ``sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30)`` with ``w_i = exp(m_i -
    max_i m_i)``. A split that saw no slot of a row (``m = -inf``) weighs
    0, and a row no split saw gives exact zeros."""
    mx = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isfinite(mx), mx, 0.0))
    w = torch.where(torch.isfinite(m), w, 0.0)
    den = (w * l).sum(dim=0)
    return (w * acc).sum(dim=0) / torch.clamp(den, min=1e-30)
