"""Batched autoregressive generation on one device, dense KV cache.

Counterpart of ``adversarial_spec_tpu/engine/generate.py`` (single-device
dense path). Same execution model and the same shapes, because the
speculative loop's fit test depends on them:

- prompts left-padded to a shared power-of-two bucket (>= 128), so every
  row's prompt KV lands at the same slots; the cache holds
  ``S + max_new`` slots, ``max_new`` bucketed to a multiple of
  ``DECODE_CHUNK``;
- prefill in ``PREFILL_CHUNK`` chunks; identical prompts prefill once and
  tile (shared prefix), equal-length prompts share their common chunks;
- prompt-lookup speculation (engine/speculative.py) when enabled, with
  the adaptive off-switch and the rowwise catch-up;
- chunked single-token decode with EOS early exit and the ``timeout_s``
  deadline checked between chunks.

The reference's mesh, sequence-parallel, data-parallel and paged branches
are not ported. The host drives every step (PyTorch runs eagerly), so the
early-exit checks read one flag per step.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine import spec as spec_cfg_mod
from adversarial_spec_tpu_torch.engine.sampling import sample_tokens
from adversarial_spec_tpu_torch.engine.speculative import (
    rowwise_decode_steps,
    speculative_decode_steps,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.models.transformer import (
    Cache,
    Params,
    forward,
    init_cache,
)
from adversarial_spec_tpu_torch.utils.device import resolve_device

DECODE_CHUNK = int(os.environ.get("ADVSPEC_DECODE_CHUNK", "128"))
MIN_BUCKET = 128
PREFILL_CHUNK = 1024


def bucket_length(n: int, minimum: int = MIN_BUCKET) -> int:
    """Next power-of-two bucket ≥ n (≥ minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_batch(
    prompt_ids: list[list[int]], pad_id: int, bucket: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to a shared bucketed length.

    Returns (tokens [B, S] int32, pad_lens [B] int32).
    """
    max_len = max(len(p) for p in prompt_ids)
    S = bucket if bucket is not None else bucket_length(max_len)
    if S < max_len:
        raise ValueError(f"bucket {S} smaller than longest prompt {max_len}")
    B = len(prompt_ids)
    tokens = np.full((B, S), pad_id, dtype=np.int32)
    pad_lens = np.zeros((B,), dtype=np.int32)
    for i, p in enumerate(prompt_ids):
        tokens[i, S - len(p) :] = np.asarray(p, dtype=np.int32)
        pad_lens[i] = S - len(p)
    return tokens, pad_lens


def _sample_step(
    logits, generator, finished, out_buf, step, eos_ids, *, greedy, top_k,
    temperature, top_p, use_top_p=True,
):
    """Per-decode-step tail: sample, record EOS (the EOS token itself is
    kept; finished rows emit 0 thereafter), write output slot ``step``
    (clamped to the buffer, as the reference's update clamps). Mirrored
    by the emission logic of engine/speculative.py."""
    nxt = sample_tokens(
        logits,
        generator,
        greedy=greedy,
        top_k=top_k,
        temperature=temperature,
        top_p=top_p,
        use_top_p=use_top_p,
    )
    is_eos = torch.isin(nxt, eos_ids)
    nxt = torch.where(finished, 0, nxt)
    out_buf[:, min(step, out_buf.shape[1] - 1)] = nxt
    return nxt, finished | is_eos


def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Sc] one left-padded prompt chunk
    pad_lens: torch.Tensor,  # [B]
    cache: Cache,  # written in place
    cache_index: int,  # slot of this chunk's first token
) -> torch.Tensor:
    """Run ONE prompt chunk; returns last-position logits [B, vocab].

    Every chunk length takes the plain masked ``attention``, as the
    reference's prompt chunks do — also the short ones the batcher's
    canonical admissions run (a chunk of S <= 16 would otherwise route
    to the decode kernels)."""
    Sc = tokens.shape[1]
    T = cache["k"].shape[3]
    dev = tokens.device
    positions = torch.clamp(
        cache_index + torch.arange(Sc, device=dev)[None, :] - pad_lens[:, None],
        min=0,
    )
    kv_valid = torch.arange(T, device=dev)[None, :] >= pad_lens[:, None]
    logits = forward(
        params,
        cfg,
        tokens,
        positions,
        cache,
        cache_index,
        kv_valid,
        use_kernels=False,
        lm_head_last_only=True,
    )
    return logits[:, -1]


def decode_chunk_steps(
    params: Params,
    cfg: ModelConfig,
    cache: Cache,
    cur: torch.Tensor,  # [B] last sampled token per row
    pad_lens: torch.Tensor,  # [B]
    finished: torch.Tensor,  # [B] bool
    out_buf: torch.Tensor,  # [B, max_new], written in place
    start_step: int,
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
    """Up to ``chunk`` shared-slot single-token steps; stops early once
    every row is finished. Returns (cur, finished, step)."""
    T = cache["k"].shape[3]
    dev = cur.device
    slots = torch.arange(T, device=dev)[None, :]
    kv_base = slots >= pad_lens[:, None]
    bound = min(start_step + chunk, stop_at, out_buf.shape[1])
    step = start_step
    while step < bound and not bool(finished.all()):
        # ``cur`` is the token at out index step-1, i.e. sequence slot
        # prompt_len + step - 1.
        cache_index = prompt_len + step - 1
        positions = (cache_index - pad_lens)[:, None]
        kv_valid = kv_base & (slots <= cache_index)
        logits = forward(
            params, cfg, cur[:, None], positions, cache, cache_index, kv_valid
        )
        cur, finished = _sample_step(
            logits[:, 0],
            generator,
            finished,
            out_buf,
            step,
            eos_ids,
            greedy=greedy,
            top_k=top_k,
            temperature=temperature,
            top_p=top_p,
            use_top_p=use_top_p,
        )
        step += 1
    return cur, finished, step


@dataclass
class GenerateResult:
    tokens: np.ndarray  # [B, <=max_new] generated ids (0 past each row's end)
    n_generated: np.ndarray  # [B] tokens produced per row (incl. EOS)
    prefill_time_s: float
    decode_time_s: float
    decode_tokens: int  # total across batch
    timed_out: bool = False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    params: Params,
    cfg: ModelConfig,
    prompt_ids: list[list[int]],
    *,
    max_new_tokens: int,
    eos_ids: list[int],
    pad_id: int = 0,
    greedy: bool = False,
    temperature: float = 0.7,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int | None = None,
    timeout_s: float = 0.0,
    share_prefix: bool = True,
    speculative: bool | None = None,
    device: str | torch.device | None = None,
    kv_dtype: str = "",
) -> GenerateResult:
    """End-to-end batched generation on ``device`` (default ``cuda``;
    ``params`` must already live there).

    ``speculative``: prompt-lookup speculative decoding; None = the
    process switchboard (engine/spec.py). Decode steps and verify spans
    go through the decode-attention wrappers.

    ``kv_dtype="int8"``: the KV cache stores int8 K/V with per-(token,
    head) f32 scales (half the cache bytes); the decode kernels read it
    as int8.
    """
    device = resolve_device(device)
    tokens_np, pad_lens_np = pad_batch(prompt_ids, pad_id)
    B, S = tokens_np.shape
    max_new = bucket_length(max_new_tokens, minimum=DECODE_CHUNK)
    total_len = S + max_new

    tokens = torch.as_tensor(tokens_np, dtype=torch.int64, device=device)
    pad_lens = torch.as_tensor(pad_lens_np, dtype=torch.int64, device=device)
    if seed is None:
        # Fresh entropy per call: unseeded rounds must actually vary.
        seed = int.from_bytes(os.urandom(4), "little")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    use_top_p = float(top_p) < 1.0
    eos = torch.as_tensor(
        sorted(set(eos_ids)) or [-1], dtype=torch.int64, device=device
    )
    sample_kw = dict(
        greedy=greedy,
        top_k=top_k,
        temperature=float(temperature),
        top_p=float(top_p),
        use_top_p=use_top_p,
    )
    deadline = time.monotonic() + timeout_s if timeout_s > 0 else None

    # Shared prefix: identical rows prefill once and tile.
    shared = (
        share_prefix
        and B > 1
        and all(p == prompt_ids[0] for p in prompt_ids[1:])
    )
    # Partial sharing: equal-length rows that diverge only in a suffix
    # prefill their common chunks once at B=1, tile the cache, and run
    # the divergent tail at full batch. Granularity is the prefill chunk.
    shared_until = 0
    if (
        share_prefix
        and not shared
        and B > 1
        and all(len(p) == len(prompt_ids[0]) for p in prompt_ids[1:])
    ):
        p0 = prompt_ids[0]
        common = len(p0)
        for p in prompt_ids[1:]:
            i = 0
            while i < common and p[i] == p0[i]:
                i += 1
            common = i
        chunk0 = min(S, PREFILL_CHUNK)
        shared_until = ((S - len(p0) + common) // chunk0) * chunk0
    prefill_tokens = tokens[:1] if shared else tokens
    prefill_pads = pad_lens[:1] if shared else pad_lens

    t0 = time.monotonic()
    cache = init_cache(
        cfg,
        1 if shared_until else prefill_tokens.shape[0],
        total_len,
        device=device,
        dtype=params["embed"].dtype,
        kv_dtype=kv_dtype,
    )
    chunk_len = min(S, PREFILL_CHUNK)
    last_logits = None
    for ci in range(0, S, chunk_len):
        if shared_until and ci == shared_until:
            cache = {k: v.repeat_interleave(B, dim=1) for k, v in cache.items()}
        one_row = bool(shared_until) and ci < shared_until
        last_logits = prefill_chunk(
            params,
            cfg,
            (prefill_tokens[:1] if one_row else prefill_tokens)[
                :, ci : ci + chunk_len
            ],
            prefill_pads[:1] if one_row else prefill_pads,
            cache,
            ci,
        )
    # The rows that reused the shared prefill count as saved prefill
    # tokens in ``perf.prefix_cache``, as the reference counts them.
    if shared_until:
        prefix_mod.stats.record_prefill(0, (B - 1) * shared_until)
    if shared:
        cache = {k: v.repeat_interleave(B, dim=1) for k, v in cache.items()}
        last_logits = last_logits.repeat_interleave(B, dim=0)
        prefix_mod.stats.record_prefill(0, (B - 1) * S)
    first = sample_tokens(last_logits, gen, **sample_kw)
    _sync(device)
    prefill_time = time.monotonic() - t0

    out_buf = torch.zeros((B, max_new), dtype=torch.int64, device=device)
    out_buf[:, 0] = first
    finished = torch.isin(first, eos)
    cur = first
    step = 1
    timed_out = False

    sp_cfg = spec_cfg_mod.config()
    gamma = sp_cfg.gamma
    if speculative is None:
        speculative = sp_cfg.enabled
    use_spec = speculative and max_new_tokens > gamma + 1
    desynced = False  # per-row steps diverge after any speculative phase
    steps_rows = None
    if use_spec:
        prev_rows = tokens[:, -1]
        steps_rows = torch.ones((B,), dtype=torch.int64, device=device)

    t1 = time.monotonic()

    def _steps_exit() -> int:
        """min over rows of (done ? max_new_tokens : steps)."""
        if steps_rows is None:
            return step
        return int(torch.where(finished, max_new_tokens, steps_rows).min())

    while _steps_exit() < max_new_tokens and not bool(finished.all()):
        if deadline is not None and time.monotonic() >= deadline:
            timed_out = True
            break
        spec_fits = use_spec and bool(
            (~finished & (steps_rows + gamma + 1 <= max_new_tokens)).any()
        )
        if spec_fits:
            (
                prev_rows, cur, finished, out_buf, steps_rows,
                _, n_emitted, n_row_iters,
            ) = speculative_decode_steps(
                params, cfg, cache, tokens, prev_rows, cur, pad_lens,
                finished, out_buf, steps_rows, max_new_tokens, eos, gen,
                float(temperature), float(top_p),
                prompt_len=S,
                gamma=gamma,
                iters=max(1, DECODE_CHUNK // (gamma + 1)),
                greedy=greedy,
                top_k=top_k,
                use_top_p=use_top_p,
            )
            desynced = True
            step = int(steps_rows.max())
            # Adaptive off-switch: each verification forward is γ+1 wide;
            # barely more than one emitted token per active row-iteration
            # means drafts aren't matching and plain decode is cheaper.
            if n_emitted / max(n_row_iters, 1) < 1.5:
                use_spec = False
        elif desynced:
            # Rows no longer share a step count. With speculation off,
            # let the laggards catch up to the frontmost unfinished row,
            # then decode the rest synced; with speculation merely out of
            # span budget, rowwise runs the whole tail.
            need_catchup = True
            if use_spec:
                target = max_new_tokens
            else:
                target = min(
                    int(torch.where(finished, -1, steps_rows).max()),
                    max_new_tokens,
                )
                if bool((finished | (steps_rows >= target)).all()):
                    desynced = False
                    step = target
                    need_catchup = False
            if need_catchup:
                cur, finished, out_buf, steps_rows = rowwise_decode_steps(
                    params, cfg, cache, cur, pad_lens, finished, out_buf,
                    steps_rows, target, eos, gen,
                    float(temperature), float(top_p),
                    prompt_len=S,
                    chunk=DECODE_CHUNK,
                    greedy=greedy,
                    top_k=top_k,
                    use_top_p=use_top_p,
                )
                step = int(steps_rows.max())
                if not use_spec and bool(
                    (finished | (steps_rows >= target)).all()
                ):
                    desynced = False
                    step = target
        else:
            # Plain chunked decode owns the rest of the budget; the
            # deadline is checked before each chunk.
            while True:
                if deadline is not None and time.monotonic() >= deadline:
                    if not (
                        step >= max_new_tokens or bool(finished.all())
                    ):
                        timed_out = True
                    break
                cur, finished, step = decode_chunk_steps(
                    params, cfg, cache, cur, pad_lens, finished, out_buf,
                    step, max_new_tokens, eos, gen,
                    float(temperature), float(top_p),
                    prompt_len=S,
                    chunk=DECODE_CHUNK,
                    **{k: sample_kw[k] for k in ("greedy", "top_k", "use_top_p")},
                )
                if step >= max_new_tokens or bool(finished.all()):
                    break
            if steps_rows is not None:
                # Synced again after a speculative phase + catch-up.
                steps_rows = torch.clamp(steps_rows, min=step)
    _sync(device)
    decode_time = time.monotonic() - t1

    out_np = out_buf.cpu().numpy()[:, :max_new_tokens]
    # Per-row step counts: shared scalar on the synced paths; the
    # speculative paths desynchronize rows.
    if steps_rows is not None:
        row_steps = np.minimum(steps_rows.cpu().numpy(), max_new_tokens)
    else:
        row_steps = np.full((B,), min(step, max_new_tokens))
    eos_np = np.asarray(sorted(set(eos_ids)) or [-1])
    n_generated = np.zeros((B,), np.int64)
    for b in range(B):
        row = out_np[b, : row_steps[b]]
        eos_hits = np.isin(row, eos_np)
        if eos_hits.any():
            n_generated[b] = int(np.argmax(eos_hits)) + 1
        else:
            n_generated[b] = row_steps[b]
    return GenerateResult(
        tokens=out_np.astype(np.int32),
        n_generated=n_generated,
        prefill_time_s=prefill_time,
        decode_time_s=decode_time,
        decode_tokens=int(n_generated.sum()),
        timed_out=timed_out,
    )
