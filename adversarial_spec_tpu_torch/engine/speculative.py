"""Prompt-lookup speculative decoding — batched, any sampling mode.

Counterpart of ``adversarial_spec_tpu/engine/speculative.py`` on one
device. One step per batch row: draft γ tokens from the most recent
[prev, cur] bigram match in prompt ++ generated text (``_draft``); run ONE
verification forward over [cur, d_0..d_{γ-1}] at per-row cache slots (the
multi-query kernel B2 on the GPU); accept drafts by rejection sampling
against the true sampling distribution (``accept_spans``), so greedy output
is bit-identical to plain decode and sampled output keeps its
distribution. Rows accept different counts and desynchronize, so the tail
finishes on ``rowwise_decode_steps`` (per-row slots, kernel B1).

The reference runs each loop as one device program; here the loops run on
the host and check their exit condition between iterations. State tensors
(``out_buf``, the cache) are updated in place.

EOS contract (mirror of generate._sample_step): the EOS token itself is
kept in the output; slots after it emit 0.
"""

from __future__ import annotations

import torch

from adversarial_spec_tpu_torch.engine.sampling import (
    categorical,
    filtered_logits,
    sample_tokens,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.models.transformer import (
    Cache,
    Params,
    forward,
)


def _rowwise_slice(buf: torch.Tensor, starts: torch.Tensor, size: int):
    """[B, N] gathered at per-row starts → [B, size]. Starts clamp to
    [0, N - size] as the reference's ``dynamic_slice`` does."""
    starts = torch.clamp(starts, 0, buf.shape[1] - size)
    idx = starts[:, None] + torch.arange(size, device=buf.device)
    return torch.gather(buf, 1, idx)


def _rowwise_write(buf: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor):
    """Write [B, size] into [B, N] at per-row starts, in place (starts
    clamp like the reference's ``dynamic_update_slice``)."""
    size = vals.shape[1]
    starts = torch.clamp(starts, 0, buf.shape[1] - size)
    idx = starts[:, None] + torch.arange(size, device=buf.device)
    buf.scatter_(1, idx, vals.to(buf.dtype))
    return buf


def accept_spans(
    probs: torch.Tensor,  # [B, γ+1, V] filtered target distribution
    draft: torch.Tensor,  # [B, γ]
    n_allowed: torch.Tensor,  # [B] draft positions eligible to commit
    generator: torch.Generator | None,
    *,
    greedy: bool,
):
    """Rejection-sample a per-row accept length; returns (n_acc, bonus).

    Positions at or past ``n_allowed`` are forced rejections whose bonus
    token is drawn from the FULL distribution there (not the residual).
    Greedy draws no random numbers: a one-hot target accepts exactly the
    argmax, and the bonus is the residual's argmax.
    """
    B, gamma = draft.shape
    rows = torch.arange(B, device=draft.device)
    p_draft = torch.gather(probs[:, :-1], 2, draft[..., None])[..., 0]
    if greedy:
        u = torch.zeros((B, gamma), device=probs.device)
    else:
        u = torch.rand((B, gamma), device=probs.device, generator=generator)
    pos = torch.arange(gamma, device=draft.device)[None, :]
    accept = (u < p_draft) & (pos < n_allowed[:, None])
    n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)

    at = probs[rows, n_acc]  # [B, V] distribution at the emit position
    rejected = n_acc < n_allowed
    rej_draft = draft[rows, torch.clamp(n_acc, max=gamma - 1)]
    res = at.clone()
    res[rows, rej_draft] = torch.where(rejected, 0.0, at[rows, rej_draft])
    res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-30)
    if greedy:
        bonus = res.argmax(dim=-1)
    else:
        bonus = categorical(torch.log(torch.clamp(res, min=1e-30)), generator)
    return n_acc, bonus


def _draft(context, prev, cur, limits, gamma: int):
    """Most recent [prev, cur] bigram match in each row's context.

    context: [B, N] prompt ++ generated-so-far (zeros beyond ``limits``);
    limits: [B] one past the last real context token. Returns draft
    [B, gamma] — the tokens that followed the match (zeros when none).
    """
    B, N = context.shape
    pos = torch.arange(N - 1, device=context.device)[None, :]
    match = (
        (context[:, :-1] == prev[:, None])
        & (context[:, 1:] == cur[:, None])
        & (pos + 2 < limits[:, None])
    )
    best = torch.where(match, pos, -1).amax(dim=1)
    d_start = torch.clamp(best + 2, 0, N - gamma)
    draft = _rowwise_slice(context, d_start, gamma)
    return torch.where((best >= 0)[:, None], draft, 0)


def speculative_decode_steps(
    params: Params,
    cfg: ModelConfig,
    cache: Cache,
    prompt_tokens: torch.Tensor,  # [B, S] left-padded prompts (draft source)
    prev_tokens: torch.Tensor,  # [B] token before cur
    cur_tokens: torch.Tensor,  # [B] last emitted token per row
    pad_lens: torch.Tensor,  # [B]
    finished: torch.Tensor,  # [B] bool
    out_buf: torch.Tensor,  # [B, max_new], updated in place
    steps: torch.Tensor,  # [B] per-row decode step (out_buf position)
    stop_at: int,  # decode no further than this step
    eos_ids: torch.Tensor,  # [E]
    generator: torch.Generator | None,
    temperature: float,
    top_p: float,
    *,
    prompt_len: int,
    iters: int,
    gamma: int,
    greedy: bool = False,
    top_k: int = 0,
    use_top_p: bool = True,
):
    """Up to ``iters`` speculative rounds over the rows that still fit a
    full γ+1 span. Returns (prev, cur, finished, out_buf, steps, n_iters,
    n_emitted_total, n_row_iters); the caller's adaptive off-switch reads
    the emit rate n_emitted_total / n_row_iters."""
    B = prompt_tokens.shape[0]
    T = cache["k"].shape[3]
    max_new = out_buf.shape[1]
    dev = prompt_tokens.device
    kv_base = torch.arange(T, device=dev)[None, :] >= pad_lens[:, None]
    span = gamma + 1
    rows = torch.arange(B, device=dev)
    j = torch.arange(span, device=dev)[None, :]
    bound = min(stop_at, max_new)
    prev, cur = prev_tokens, cur_tokens
    n_emit_tot = n_row_iters = it = 0
    while it < iters:
        active = ~finished & (steps + span <= bound)
        if not bool(active.any()):
            break
        context = torch.cat([prompt_tokens, out_buf], dim=1)
        draft = _draft(context, prev, cur, prompt_len + steps, gamma)

        # Verify: one forward over [cur, draft] at per-row slots.
        toks = torch.cat([cur[:, None], draft], dim=1)
        cache_index = prompt_len + steps - 1
        positions = cache_index[:, None] + j - pad_lens[:, None]
        logits = forward(
            params, cfg, toks, positions, cache, cache_index, kv_base
        )
        filt = filtered_logits(
            logits,
            greedy=greedy,
            top_k=top_k,
            temperature=temperature,
            top_p=top_p,
            use_top_p=use_top_p,
        )
        probs = torch.softmax(filt, dim=-1)
        n_acc, bonus = accept_spans(
            probs,
            draft,
            torch.full((B,), gamma, device=dev, dtype=torch.int64),
            generator,
            greedy=greedy,
        )
        emitted = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
        emitted[rows, n_acc] = bonus

        # EOS + per-row emit counts (EOS kept, zeros after).
        is_eos = torch.isin(emitted, eos_ids)
        eos_hits = is_eos & (j <= n_acc[:, None])
        any_eos = eos_hits.any(dim=1)
        first_eos = torch.argmax(eos_hits.to(torch.int32), dim=1)
        n_emit = torch.where(any_eos, first_eos + 1, n_acc + 1)
        n_emit = torch.where(active, n_emit, 0)
        emitted = torch.where(j < n_emit[:, None], emitted, 0)

        # Inactive rows write their existing slots back (a no-op write).
        w_start = torch.clamp(steps, max=max_new - span)
        current = _rowwise_slice(out_buf, w_start, span)
        _rowwise_write(
            out_buf, torch.where(active[:, None], emitted, current), w_start
        )

        finished = finished | (any_eos & active)
        last = emitted[rows, torch.clamp(n_emit - 1, min=0)]
        before = emitted[rows, torch.clamp(n_emit - 2, min=0)]
        new_cur = torch.where(active, last, cur)
        prev = torch.where(
            active, torch.where(n_emit >= 2, before, cur), prev
        )
        cur = new_cur
        steps = steps + n_emit
        n_emit_tot += int(n_emit.sum())
        n_row_iters += int(active.sum())
        it += 1
    return prev, cur, finished, out_buf, steps, it, n_emit_tot, n_row_iters


def rowwise_decode_steps(
    params: Params,
    cfg: ModelConfig,
    cache: Cache,
    cur_tokens: torch.Tensor,  # [B]
    pad_lens: torch.Tensor,  # [B]
    finished: torch.Tensor,  # [B] bool
    out_buf: torch.Tensor,  # [B, max_new], updated in place
    steps: torch.Tensor,  # [B] per-row decode step
    stop_at: int,
    eos_ids: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_p: float,
    *,
    prompt_len: int,
    chunk: int,
    greedy: bool,
    top_k: int,
    use_top_p: bool = True,
):
    """Plain single-token decode with PER-ROW cache slots (the tail after
    any speculative phase). Returns (cur, finished, out_buf, steps)."""
    B = cur_tokens.shape[0]
    T = cache["k"].shape[3]
    max_new = out_buf.shape[1]
    dev = cur_tokens.device
    kv_base = torch.arange(T, device=dev)[None, :] >= pad_lens[:, None]
    rows = torch.arange(B, device=dev)
    bound = min(stop_at, max_new)
    cur = cur_tokens
    for _ in range(chunk):
        active = ~finished & (steps < bound)
        if not bool(active.any()):
            break
        cache_index = prompt_len + steps - 1
        positions = (cache_index - pad_lens)[:, None]
        logits = forward(
            params, cfg, cur[:, None], positions, cache, cache_index, kv_base
        )
        nxt = sample_tokens(
            logits[:, 0],
            generator,
            greedy=greedy,
            top_k=top_k,
            temperature=temperature,
            top_p=top_p,
            use_top_p=use_top_p,
        )
        is_eos = torch.isin(nxt, eos_ids)
        nxt = torch.where(finished, 0, nxt)
        idx = torch.clamp(steps, max=max_new - 1)
        out_buf[rows, idx] = torch.where(active, nxt, out_buf[rows, idx])
        finished = finished | (is_eos & active)
        steps = steps + active.to(steps.dtype)
        cur = torch.where(active, nxt, cur)
    return cur, finished, out_buf, steps
