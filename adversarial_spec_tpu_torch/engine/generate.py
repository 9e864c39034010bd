"""Batched autoregressive generation on one device.

Counterpart of ``adversarial_spec_tpu/engine/generate.py`` (its
single-device dense and paged paths). Same execution model and the same
shapes, because the speculative loop's fit test depends on them:

- prompts left-padded to a shared power-of-two bucket (>= 128), so every
  row's prompt KV lands at the same slots; the cache holds
  ``S + max_new`` slots, ``max_new`` bucketed to a multiple of
  ``DECODE_CHUNK``;
- prefill in ``PREFILL_CHUNK`` chunks; identical prompts prefill once and
  tile (shared prefix), equal-length prompts share their common chunks;
- prompt-lookup speculation (engine/speculative.py) when enabled, with
  the adaptive off-switch and the rowwise catch-up;
- chunked single-token decode with EOS early exit and the ``timeout_s``
  deadline checked between chunks;
- ``paged=True``: the round-synchronous paged decode. The dense prefill
  cache holds the prompt slots only; its K/V migrates into a page pool
  (physical page 0 the trash page, allocator ids shifted +1), identical
  prompts keep one physical copy of their prompt pages when the page
  size divides the bucket, and decode runs the continuous batcher's
  chunk (engine/scheduler.py ``_decode_chunk_impl``, kernel B3 on the
  GPU). Speculation does not apply to this path.
- ``mesh``: the reference's dp, tp and dp×tp branches (``params`` are
  ``MeshParams``, ``parallel/sharding.py``). Rows pad up to a multiple of
  dp and unpad on return; the cache is born sharded; there is no shared
  prefill. Dense decode runs the sharded ``forward`` (W1 for the S=1
  step), paged decode lays the pool out per dp slice and runs the
  sharded paged step (W3 on a tp-only mesh, W2 on any mesh with dp > 1),
  and speculation runs the sharded program too: every mesh, dp-only
  included, runs one program with the round's generator. The sp axis is
  not ported.

The host drives every step (PyTorch runs eagerly), so the early-exit
checks read one flag per step.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine import spec as spec_cfg_mod
from adversarial_spec_tpu_torch.engine.kvcache import (
    PageAllocator,
    PagedCacheLayout,
    init_page_pool,
    slice_page_tables,
    write_tokens,
)
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
from adversarial_spec_tpu_torch.parallel.mesh import DP, SP, TP, Mesh
from adversarial_spec_tpu_torch.parallel.sharding import (
    MeshParams,
    Sharded,
    local,
    local_config,
)
from adversarial_spec_tpu_torch.utils.device import resolve_device

DECODE_CHUNK = int(os.environ.get("ADVSPEC_DECODE_CHUNK", "128"))
MIN_BUCKET = 128
PREFILL_CHUNK = 1024

# One-time flag for the speculative x paged warning in ``generate``:
# paged speculation is the ContinuousBatcher's per-slot step, and this
# path has none.
_PAGED_SPEC_WARNED = False


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


def _migrate_to_pages(
    cache: Cache,
    cfg: ModelConfig,
    B: int,
    S: int,
    total_len: int,
    page_size: int,
    share_prompt_pages: bool,
    kv_dtype: str,
    device: torch.device,
) -> tuple[dict, torch.Tensor]:
    """Build the page pool and table of a paged ``generate`` and scatter
    the prompt KV (slots [0, S)) of the dense prefill ``cache`` into it.
    Pad-slot garbage lands too but stays masked by each row's window
    start. With shared prompt pages the one-row cache scatters once.
    Returns (pool, page_table [B, pages per row] int32)."""
    # Physical page 0 is the TRASH page (the batcher's decode chunk
    # redirects inactive rows' writes there), so allocator ids shift +1.
    n_pages_per_row = -(-total_len // page_size)
    if share_prompt_pages:
        prompt_pages = S // page_size
        decode_pages = n_pages_per_row - prompt_pages
        allocator = PageAllocator(prompt_pages + B * decode_pages, page_size)
        allocator.new_sequence("prompt")
        allocator.extend("prompt", S)
        shared_table = np.asarray(allocator.table("prompt"), np.int32)
        for b in range(B):
            allocator.new_sequence(b)
            allocator.extend(b, total_len - S)
        table_np = (
            np.concatenate(
                [
                    np.broadcast_to(shared_table, (B, prompt_pages)),
                    allocator.table_array(list(range(B)), decode_pages),
                ],
                axis=1,
            )
            + 1
        )
        n_phys_pages = prompt_pages + B * decode_pages
    else:
        allocator = PageAllocator(B * n_pages_per_row, page_size)
        for b in range(B):
            allocator.new_sequence(b)
            allocator.extend(b, total_len)
        table_np = allocator.table_array(list(range(B)), n_pages_per_row) + 1
        n_phys_pages = B * n_pages_per_row
    layout = PagedCacheLayout(
        n_pages=n_phys_pages + 1,  # +1: trash page 0
        page_size=page_size,
        n_layers=cfg.n_layers,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
    )
    pool = init_page_pool(
        layout, device=device, dtype=cache["k"].dtype, kv_dtype=kv_dtype
    )
    B_mig = cache["k"].shape[1]
    slots = np.tile(np.arange(S, dtype=np.int64)[None, :], (B_mig, 1))
    page_ids = table_np[np.arange(B_mig)[:, None], slots // page_size]
    quant = "ks" in cache
    write_tokens(
        pool,
        cache["k"][..., :S, :],
        cache["v"][..., :S, :],
        page_ids,
        slots % page_size,
        ks_new=cache["ks"][..., :S, :] if quant else None,
        vs_new=cache["vs"][..., :S, :] if quant else None,
    )
    page_table = torch.as_tensor(table_np, dtype=torch.int32, device=device)
    return pool, page_table


def _migrate_to_pages_mesh(
    cache: dict,
    cfg: ModelConfig,
    mesh: Mesh,
    B: int,
    S: int,
    total_len: int,
    page_size: int,
    kv_dtype: str,
) -> tuple[dict, torch.Tensor]:
    """The mesh counterpart of ``_migrate_to_pages``: the per-dp-slice pool
    layout (``kvcache.slice_page_tables``; one slice on a tp-only mesh),
    each shard's pool part holding its slice's pages and its KV heads, the
    prompt KV scattered shard by shard from the sharded prefill cache.
    Returns (pool of ``Sharded``, page table of global ids on the
    controller; the sharded step rebases them per slice)."""
    dp, tp = mesh.shape[DP], mesh.shape[TP]
    n_pages_per_row = -(-total_len // page_size)
    local_table, global_table, lp = slice_page_tables(B, dp, n_pages_per_row)
    lcfg = local_config(cfg, tp)
    layout = PagedCacheLayout(
        n_pages=lp, page_size=page_size, n_layers=cfg.n_layers,
        n_kv_heads=lcfg.n_kv_heads, head_dim=cfg.head_dim,
    )
    r = B // dp
    slots = np.tile(np.arange(S, dtype=np.int64)[None, :], (r, 1))
    quant = "ks" in cache
    grid = []
    for d in range(dp):
        row_table = local_table[d * r : (d + 1) * r]
        page_ids = row_table[np.arange(r)[:, None], slots // page_size]
        row = []
        for t in range(tp):
            part = init_page_pool(layout, device=mesh.device(d, t),
                                  dtype=cache["k"].dtype, kv_dtype=kv_dtype)
            c = local(cache, d, t)
            write_tokens(
                part, c["k"][..., :S, :], c["v"][..., :S, :], page_ids, slots % page_size,
                ks_new=c["ks"][..., :S, :] if quant else None,
                vs_new=c["vs"][..., :S, :] if quant else None,
            )
            row.append(part)
        grid.append(row)
    spec = (None, DP, TP, None, None)
    pool = {k: Sharded(mesh, spec, [[p[k] for p in row] for row in grid]) for k in grid[0][0]}
    return pool, torch.as_tensor(global_table, dtype=torch.int32, device=mesh.controller)


def check_mesh(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise for a mesh the port cannot serve yet: an sp axis (the ring
    prefill), or a tp that does not divide the KV heads (the reference's
    kernel-free GSPMD fallback)."""
    if mesh.shape[SP] > 1:
        raise NotImplementedError(
            f"a sequence-parallel mesh {mesh.shape} is not yet ported to "
            "the PyTorch/CUDA package"
        )
    if cfg.n_kv_heads % mesh.shape[TP]:
        raise NotImplementedError(
            f"tp={mesh.shape[TP]} not dividing the {cfg.n_kv_heads} KV heads "
            "is not yet ported to the PyTorch/CUDA package"
        )


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
    paged: bool = False,
    page_size: int = 128,
    speculative: bool | None = None,
    device: str | torch.device | None = None,
    kv_dtype: str = "",
    mesh: Mesh | None = None,
) -> GenerateResult:
    """End-to-end batched generation on ``device`` (default ``cuda``;
    ``params`` must already live there).

    ``speculative``: prompt-lookup speculative decoding; None = the
    process switchboard (engine/spec.py). Decode steps and verify spans
    go through the decode-attention wrappers.

    ``kv_dtype="int8"``: the KV cache stores int8 K/V with per-(token,
    head) f32 scales (half the cache bytes); the decode kernels read it
    as int8.

    ``paged``: decode against a page pool of ``page_size``-slot pages
    instead of the dense per-row cache (the reference's single-device
    paged path); an int8 ``kv_dtype`` gives int8 pages with scale pages.
    An explicit ``speculative=True`` is ignored here, with a one-time
    warning on stderr.

    ``mesh``: a multi-device mesh, with ``params`` the ``MeshParams``
    placed on it; the round's global state lives on the mesh's
    controller (``device`` is ignored).
    """
    n_real = len(prompt_ids)
    on_mesh = mesh is not None and mesh.size > 1
    if on_mesh:
        if not isinstance(params, MeshParams):
            raise TypeError("generate(mesh=...) takes MeshParams (parallel/sharding.py)")
        check_mesh(cfg, mesh)
        device = mesh.controller
        short = (-n_real) % mesh.shape[DP]
        prompt_ids = prompt_ids + [prompt_ids[-1]] * short
    else:
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
    # Off the mesh only: dp slices prefill their own rows.
    shared = (
        share_prefix
        and not on_mesh
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
        and not on_mesh
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
    # Paged runs drop the dense cache after migrating the prompt KV, so it
    # holds only the prompt slots.
    dtype = (params.shard() if on_mesh else params)["embed"].dtype
    cache = init_cache(
        cfg,
        1 if shared_until else prefill_tokens.shape[0],
        S if paged else total_len,
        device=device,
        dtype=dtype,
        kv_dtype=kv_dtype,
        mesh=mesh if on_mesh else None,  # born sharded
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
    # Paged + identical prompts: the rows share one physical copy of the
    # prompt pages (never written after migration: decode slots start at
    # S, page-aligned when the page size divides the bucket), so the
    # cache stays one row; only the logits tile.
    share_prompt_pages = shared and paged and S % page_size == 0
    if shared:
        if not share_prompt_pages:
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

    if paged:
        pool, page_table = (
            _migrate_to_pages_mesh(
                cache, cfg, mesh, B, S, total_len, page_size, kv_dtype
            )
            if on_mesh
            else _migrate_to_pages(
                cache, cfg, B, S, total_len, page_size, share_prompt_pages,
                kv_dtype, device,
            )
        )
        cache = None  # the dense prefill cache is no longer needed
        # Per-row state of the batcher's decode chunk, which this path
        # shares: cur's KV slot is S, one token emitted so far.
        paged_cur_len = torch.full((B,), S + 1, dtype=torch.int64, device=device)
        paged_n_emitted = torch.ones((B,), dtype=torch.int64, device=device)
        paged_max_new = torch.full(
            (B,), max_new_tokens, dtype=torch.int64, device=device
        )
        paged_active = ~finished

    sp_cfg = spec_cfg_mod.config()
    gamma = sp_cfg.gamma
    spec_explicit = speculative is not None
    if speculative is None:
        speculative = sp_cfg.enabled
    use_spec = speculative and not paged and max_new_tokens > gamma + 1
    if spec_explicit and speculative and paged and max_new_tokens > gamma + 1:
        # Only an EXPLICIT speculative=True warns: a paged call that
        # inherited the default-on process config asked for nothing.
        global _PAGED_SPEC_WARNED
        if not _PAGED_SPEC_WARNED:
            _PAGED_SPEC_WARNED = True
            print(
                "warning: speculative=True is ignored when paged=True in "
                "generate() — dense-path speculation has no paged "
                "variant; paged speculation runs per-slot in the "
                "ContinuousBatcher (GpuEngine.chat / run_all). "
                "Pass speculative=False to silence this.",
                file=sys.stderr,
            )
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
        elif paged:
            from adversarial_spec_tpu_torch.engine.scheduler import (
                _decode_chunk_impl,
            )

            cur, paged_cur_len, paged_n_emitted, paged_active = (
                _decode_chunk_impl(
                    params, cfg, pool, page_table, cur, paged_cur_len,
                    pad_lens, paged_n_emitted, paged_max_new, paged_active,
                    out_buf, eos, gen, float(temperature), float(top_p),
                    chunk=DECODE_CHUNK,
                    record_syncs=False,
                    **{k: sample_kw[k] for k in ("greedy", "top_k", "use_top_p")},
                )
            )
            step = int(paged_n_emitted.max())
            finished = ~paged_active
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

    # The dp padding rows are dropped.
    out_np = out_buf.cpu().numpy()[:n_real, :max_new_tokens]
    B = n_real
    # Per-row step counts: shared scalar on the synced paths; the
    # speculative paths desynchronize rows.
    if steps_rows is not None:
        row_steps = np.minimum(steps_rows.cpu().numpy()[:n_real], max_new_tokens)
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
