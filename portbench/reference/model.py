"""A decoder-only transformer in plain float32 PyTorch, from the published
description of Mistral-7B and Qwen2-7B, and the served-token gap.

It imports nothing of the program. It reads a configuration file's keys
and the weights of ``portbench/weights.py`` (``[in, out]`` matrices), and
computes the logits of a whole sequence with no cache, no kernels and no
batching: token embedding; per layer an RMSNorm (``x * rsqrt(mean(x^2) +
eps) * w``), q/k/v projections (plus their biases where
``attention_bias``), rotary embeddings in the half-split layout of the HF
checkpoints (``inv_freq = theta^(-2i/head_dim)``), causal grouped-query
attention (query head ``h`` reads key/value head ``h // (H / Hkv)``,
scale ``head_dim^-0.5``), the output projection, a residual, an RMSNorm,
the SwiGLU block ``w_down(silu(w_gate h) * w_up h)`` and a residual; a
final RMSNorm and the head. Float32 products run with TF32 off. A key
that the file lists under ``departures`` (a value the program runs in
place of the published one) is taken at the value run.

Each layer is computed for the whole sequence before the next, query
rows in blocks, so the memory it needs is a few layers' float32 copies
and one block's scores.
"""

from __future__ import annotations

import math

import torch

Q_BLOCK = 1024


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, heads, hd], positions [n]."""
    hd = x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal GQA over the whole sequence; q [n, H, hd], k/v [n, Hkv, hd]."""
    n, H, hd = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, n, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, n, Q_BLOCK):
        b = min(a + Q_BLOCK, n)
        s = torch.matmul(q[a:b].transpose(0, 1), k[:, :b].transpose(1, 2)) * scale
        rows = torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(b, device=q.device)[None, :] > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.matmul(p, v[:, :b]).transpose(0, 1)
    return out


def logits(weights: dict, cfg: dict, ids: list[int], score_from: int) -> torch.Tensor:
    """Float32 logits ``[len(ids) - score_from, V]`` at positions
    ``score_from ..`` of the sequence ``ids``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, cfg, ids, score_from)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits(weights, cfg, ids, score_from):
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    eps = float(cfg.get("departures", {}).get("rms_norm_eps", cfg["rms_norm_eps"]))
    theta = float(cfg["rope_theta"])
    bias = bool(cfg.get("attention_bias", False))
    dev = weights["embed"].device
    tok = torch.as_tensor(ids, dtype=torch.long, device=dev)
    n = tok.shape[0]
    pos = torch.arange(n, device=dev)
    x = weights["embed"][tok].float()
    for lw in weights["layers"]:
        w = {k: t.float() for k, t in lw.items()}
        h = _norm(x, w["attn_norm"], eps)
        q, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
        if bias:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q = _rope(q.view(n, H, hd), pos, theta)
        k = _rope(k.view(n, Hkv, hd), pos, theta)
        a = _attention(q, k, v.view(n, Hkv, hd), 1.0 / math.sqrt(hd))
        x = x + a.reshape(n, H * hd) @ w["wo"]
        h = _norm(x, w["ffn_norm"], eps)
        x = x + (torch.nn.functional.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
        del w, h, q, k, v, a
    x = _norm(x[score_from:], weights["final_norm"], eps)
    head = weights["embed"].t() if "lm_head" not in weights else weights["lm_head"]
    return x @ head.float()


def served_gaps(weights: dict, cfg: dict, prompt: list[int], served: list[int]) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position ([len(served)], float32, >= 0)."""
    lg = logits(weights, cfg, list(prompt) + list(served[:-1]), len(prompt) - 1)
    got = lg.gather(1, torch.as_tensor(served, device=lg.device)[:, None])[:, 0]
    return lg.max(dim=1).values - got


def control_gaps(ref_logits: torch.Tensor, low_logits: torch.Tensor) -> torch.Tensor:
    """For each position, how far the token that ``low_logits`` puts first
    lies below the reference's best."""
    top = low_logits.argmax(dim=1, keepdim=True)
    return ref_logits.max(dim=1).values - ref_logits.gather(1, top)[:, 0]
