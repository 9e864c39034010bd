"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``adversarial_spec_tpu/engine/sampling.py`` with the same
semantics: ``filtered_logits`` is the post-filter logits whose softmax IS
the sampling distribution (greedy and temperature <= 0 degenerate to a
one-hot at the argmax). Random draws take an explicit, seeded
``torch.Generator``; the greedy path draws nothing.
"""

from __future__ import annotations

import torch


def filtered_logits(
    logits: torch.Tensor,  # [..., V] f32
    *,
    greedy: bool,
    top_k: int,
    temperature: float,
    top_p: float,
    use_top_p: bool = True,
) -> torch.Tensor:
    """Logits after temperature, top-k and top-p filtering. Constants are
    Python scalars: no host-to-device copy, so a decode step holding this
    is captured whole in a CUDA graph."""
    neg_inf = float("-inf")
    idx = torch.arange(logits.shape[-1], device=logits.device)
    onehot = torch.where(
        idx == logits.argmax(dim=-1, keepdim=True), 0.0, neg_inf
    )
    if greedy or temperature <= 0.0:
        return onehot

    scaled = logits / max(float(temperature), 1e-6)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if use_top_p:
        # Nucleus: keep the smallest prefix of the probability-sorted vocab
        # whose mass exceeds top_p (the token that crosses it included).
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cumulative = torch.cumsum(sorted_probs, dim=-1)
        cutoff_mask = cumulative - sorted_probs > top_p
        cutoff_logit = torch.where(
            cutoff_mask, float("inf"), sorted_logits
        ).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff_logit, neg_inf, scaled)
    return scaled


def categorical(
    logits: torch.Tensor, generator: torch.Generator | None
) -> torch.Tensor:
    """One draw per row from softmax(logits) [..., V] → [...] int64.

    ``torch.multinomial``'s one-sample draw written out (the same
    exponential race on the same generator, so the same draws): its
    validity check reads the device, which would stall every step and
    cannot be captured in a CUDA graph."""
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    q = torch.empty_like(flat).exponential_(1, generator=generator)
    return torch.argmax(flat / q, dim=-1).reshape(probs.shape[:-1])


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator | None,
    *,
    greedy: bool,
    top_k: int,
    temperature: float,
    top_p: float,
    use_top_p: bool = True,
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int64."""
    if greedy:
        return logits.argmax(dim=-1)
    filt = filtered_logits(
        logits,
        greedy=greedy,
        top_k=top_k,
        temperature=temperature,
        top_p=top_p,
        use_top_p=use_top_p,
    )
    return categorical(filt, generator)
