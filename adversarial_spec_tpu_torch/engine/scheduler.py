"""Continuous batching scheduler over the paged KV pool.

Counterpart of ``adversarial_spec_tpu/engine/scheduler.py``'s
``ContinuousBatcher`` on one device. A slot-based scheduler keeps one
decode batch hot while sequences of different lengths join and leave it:

- ``max_batch`` slots decode together as rows of one batch;
- a finished row's pages free immediately and a queued request is admitted
  into the empty slot at the next step boundary — its prompt chunks ride
  the same drive-loop iteration as the residents' decode chunk
  (``fused_prefill_decode_chunk``, Sarathi-style piggybacked chunked
  prefill), so admission never pauses the batch for a whole prompt;
- per-row lengths/budgets/EOS live in device tensors, so rows at different
  positions coexist in one step (per-row ``q_pos`` drives page writes,
  RoPE positions and window bounds);
- with speculation on (the default) every step drafts up to γ tokens per
  row from its own context and verifies them in ONE multi-position paged
  forward (kernel B4 on the GPU); with it off, every step is an S=1
  paged decode (kernel B3).

PyTorch idiom: plain functions on tensors with an explicit device; the
pool is a dict of tensors mutated IN PLACE where the reference donates
buffers; an explicit, seeded ``torch.Generator`` replaces the PRNG key.
The reference's ``while_loop`` condition ``active.any()`` becomes one host
read per decode step, and the drive loop runs one step deep (the
reference's pipelined loop at depth 1): each step's flags (or the spec
path's accept counts) are read right after it. Every such host read is
counted in ``interleave.stats.sync_points``.

Inactive-slot safety: physical page 0 is a reserved TRASH page no sequence
owns. Allocator ids are shifted +1 and inactive rows (and rejected drafts)
write their masked, discarded K/V there, so a dead slot can never scribble
into pages re-allocated to a newcomer; the paged kernels skip page 0.

Not ported yet (a fault propagates out of ``run_all``; the engine drops
the batcher): fault isolation and requeue, the per-request watchdog, the
chaos injector seams and flight-recorder events, the KV tiers, depth-2
pipelining, the legacy serialized loop, sharded decode and int8 pools.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from adversarial_spec_tpu_torch.engine import interleave as interleave_mod
from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine.generate import (
    _sync,
    bucket_length,
    pad_batch,
    prefill_chunk,
)
from adversarial_spec_tpu_torch.engine.kvcache import (
    OutOfPages,
    PageAllocator,
    PagedCacheLayout,
    init_page_pool,
    read_tokens,
    write_tokens,
)
from adversarial_spec_tpu_torch.engine.sampling import (
    filtered_logits,
    sample_tokens,
)
from adversarial_spec_tpu_torch.engine.speculative import (
    _draft,
    _rowwise_slice,
    _rowwise_write,
    accept_spans,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.models.transformer import (
    forward_paged_decode,
    init_cache,
)

TRASH_PAGE = 0
# Admission prefill granularity — finer than generate.py's PREFILL_CHUNK
# (1024): decode steps slot in between more often while a newcomer's
# prompt streams in.
ADMISSION_CHUNK = 512


@dataclass
class SchedRequest:
    req_id: int
    prompt_ids: list[int]
    max_new_tokens: int
    # Host-side streaming consumer (engine/streaming.py): called at the
    # drive loop's existing fetch points with ALL token ids this request
    # has emitted so far (np.ndarray); return False to cancel the request
    # mid-decode (``_cancel_slot``). None = the blocking path.
    on_tokens: object = None


@dataclass
class _Admission:
    """An in-flight admission: its prompt prefills one chunk per drive-loop
    iteration (beside the resident rows' decode) instead of stalling
    decode for the whole prompt.

    Two coordinate systems coexist (per admission, chosen at start):

    - padded (prefix cache off): tokens left-padded to the bucket; KV
      slot = pad + logical position.
    - canonical (prefix cache on): tokens at slot = logical position,
      pad 0, right-padded to the bucket — a token's K/V then depends only
      on its logical position, so a block cached by one admission drops
      into any later one.
    """

    slot: int
    req: SchedRequest
    seq_id: int
    tokens: torch.Tensor  # [1, S]
    pads: torch.Tensor  # [1]
    cache: dict  # 1-row dense cache being prefilled
    pos: int  # next chunk start
    S: int  # bucketed token-array length
    last_logits: torch.Tensor | None = None
    canonical: bool = False
    S_real: int = 0  # true prompt length (== S when padded)
    matched: int = 0  # tokens adopted from the cache (page multiple)
    prefill_end: int = 0  # prefill covers [pos0, prefill_end)
    prefill_s: float = 0.0  # this request's own prefill wall-clock

    @property
    def remaining(self) -> int:
        return self.prefill_end - self.pos


@dataclass
class SchedResult:
    req_id: int
    tokens: np.ndarray  # generated ids (0 past the row's end)
    n_generated: int
    # Prompt tokens served from the prefix cache and the wall-clock this
    # request's own admission prefill took.
    cached_tokens: int = 0
    prefill_time_s: float = 0.0
    # Speculation telemetry: verify steps this row took part in, eligible
    # draft positions verified, and positions accepted.
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # This request's own decode wall: each step's decode share splits
    # evenly over the rows live at dispatch.
    decode_time_s: float = 0.0
    # A CLEAN mid-decode stop requested by the stream consumer (``tokens``
    # holds the partial transcript); ``tokens_saved`` is the budget
    # remainder never decoded.
    cancelled: bool = False
    tokens_saved: int = 0


def _next_chunk_len(remaining: int) -> int:
    """Largest power-of-two chunk ≤ min(remaining, ADMISSION_CHUNK)."""
    c = ADMISSION_CHUNK
    while c > remaining:
        c //= 2
    return max(c, 1)


def decode_write_targets(
    page_table: torch.Tensor,  # [B, P]
    q_pos: torch.Tensor,  # [B] logical slot of each row's token
    active: torch.Tensor,  # [B] bool
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(write_page, write_off) [B] of one decode step: the row's page, or
    the trash page for inactive rows. The reference's
    ``page_table[rows, q_pos // page]`` relies on JAX clamping the index
    into the table; torch raises instead, so the clamp is explicit."""
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    idx = torch.clamp(q_pos // page_size, 0, page_table.shape[1] - 1)
    page = torch.where(active, page_table[rows, idx].long(), TRASH_PAGE)
    return page, q_pos % page_size


def spec_write_targets(
    page_table: torch.Tensor,  # [B, P]
    q_pos: torch.Tensor,  # [B, span] logical slot of each span position
    writable: torch.Tensor,  # [B, span] bool
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(write_page, write_off) [B, span] of one verify step: positions
    that may commit write their page, the rest the trash page. ``safe_q``
    is the reference's explicit clamp to the table's span."""
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    safe_q = torch.clamp(q_pos, 0, page_table.shape[1] * page_size - 1)
    page = torch.where(
        writable, page_table[rows[:, None], safe_q // page_size].long(), TRASH_PAGE
    )
    return page, safe_q % page_size


def _decode_chunk_impl(
    params,
    cfg: ModelConfig,
    pool: dict,  # written in place
    page_table: torch.Tensor,  # [B, Pmax] physical ids (0 = trash/unmapped)
    cur_tok: torch.Tensor,  # [B]
    cur_len: torch.Tensor,  # [B] prompt+emitted tokens so far
    pad_lens: torch.Tensor,  # [B]
    n_emitted: torch.Tensor,  # [B]
    max_new: torch.Tensor,  # [B] per-row budget
    active: torch.Tensor,  # [B] bool
    out_buf: torch.Tensor,  # [B, cap], written in place
    eos_ids: torch.Tensor,
    generator: torch.Generator,
    temperature: float,
    top_p: float,
    *,
    chunk: int,
    greedy: bool,
    top_k: int,
    use_top_p: bool = True,
):
    """Up to ``chunk`` decode steps over whatever rows are active; stops
    early once no row is. THE paged decode loop: the fused step runs this
    same body, so the write-page lookup, bounds and sampling glue exist
    once. Returns (cur, cur_len, n_emitted, active)."""
    B = cur_tok.shape[0]
    page_size = pool["k"].shape[3]
    cap = out_buf.shape[1]
    rows = torch.arange(B, device=cur_tok.device)
    cur = cur_tok
    for _ in range(chunk):
        # The reference's while_loop condition: one host read per step.
        interleave_mod.stats.record_sync()
        if not bool(active.any()):
            break
        q_pos = cur_len - 1  # [B] logical slot of cur's KV
        write_page, write_off = decode_write_targets(
            page_table, q_pos, active, page_size
        )
        bounds = torch.stack([pad_lens, q_pos + 1], dim=1)
        positions = (q_pos - pad_lens)[:, None]
        logits = forward_paged_decode(
            params,
            cfg,
            cur[:, None],
            positions,
            pool,
            page_table,
            write_page,
            write_off,
            bounds,
            q_pos,
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
        nxt = torch.where(active, nxt, 0)
        write_pos = torch.clamp(n_emitted, max=cap - 1)
        out_buf[rows, write_pos] = torch.where(
            active, nxt, out_buf[rows, write_pos]
        )
        n_emitted = n_emitted + active.long()
        cur_len = cur_len + active.long()
        done = (is_eos | (n_emitted >= max_new)) & active
        active = active & ~done
        cur = nxt
    return cur, cur_len, n_emitted, active


def fused_prefill_decode_chunk(
    params, cfg: ModelConfig, adm: _Admission, chunk_len: int, *decode_args,
    **decode_kw,
):
    """ONE drive-loop step: the in-flight admission's prompt chunk (into
    its private 1-row dense cache) AND every resident row's decode chunk
    (against the paged pool). The halves touch disjoint state; each is
    the SAME body as its standalone form (``prefill_chunk`` /
    ``_decode_chunk_impl``), so greedy tokens are identical either way.
    Returns (admission logits, the decode chunk's outputs)."""
    adm_logits = prefill_chunk(
        params,
        cfg,
        adm.tokens[:, adm.pos : adm.pos + chunk_len],
        adm.pads,
        adm.cache,
        adm.pos,
    )
    return adm_logits, _decode_chunk_impl(params, cfg, *decode_args, **decode_kw)


def _spec_chunk_impl(
    params,
    cfg: ModelConfig,
    pool: dict,  # written in place
    page_table: torch.Tensor,  # [B, Pmax] physical ids (0 = trash/unmapped)
    ctx_buf: torch.Tensor,  # [B, C] prompt ++ emitted tokens (draft source)
    ctx_len: torch.Tensor,  # [B] tokens valid in ctx_buf
    prev_tok: torch.Tensor,  # [B] token before cur (bigram context)
    cur_tok: torch.Tensor,  # [B]
    cur_len: torch.Tensor,  # [B] prompt+emitted tokens so far
    pad_lens: torch.Tensor,  # [B]
    n_emitted: torch.Tensor,  # [B]
    max_new: torch.Tensor,  # [B] per-row budget
    alloc_len: torch.Tensor,  # [B] KV slots covered by allocated pages
    active: torch.Tensor,  # [B] bool
    out_buf: torch.Tensor,  # [B, cap], written in place
    eos_ids: torch.Tensor,
    generator: torch.Generator,
    temperature: float,
    top_p: float,
    *,
    gamma: int,
    greedy: bool,
    top_k: int,
    use_top_p: bool = True,
):
    """ONE speculative step over whatever rows are active: draft up to γ
    tokens per row from its own context (prompt-lookup bigram rule), run
    ONE multi-position verification forward over the paged pool, accept
    a prefix by rejection sampling against the true sampling distribution
    (``accept_spans``; greedy output equals plain decode).

    Rollback discipline: draft position k writes its K/V at slot
    ``cur_len-1+k`` only while the host's page allocation covers it AND
    the output budget could commit it (``n_allowed``); everything else
    lands on the trash page. Rows that cannot fit a draft degrade to a
    plain single-token step inside the same step.

    Returns (ctx_len, prev, cur, cur_len, n_emitted, active, counts) —
    ``counts`` [5, B] = (n_allowed, n_acc, n_emit, active, cur_len), ONE
    stacked tensor so the drive loop's accept read is a single copy.
    ``ctx_buf``, ``out_buf`` and the pool are updated in place.
    """
    B = cur_tok.shape[0]
    dev = cur_tok.device
    page_size = pool["k"].shape[3]
    cap = out_buf.shape[1]
    C = ctx_buf.shape[1]
    span = gamma + 1
    rows = torch.arange(B, device=dev)
    j = torch.arange(span, device=dev)[None, :]  # [1, span]

    # Draft positions eligible to COMMIT: bounded by the output budget
    # (the bonus token always needs one slot) and the KV pages held.
    n_allowed = torch.clamp(
        torch.minimum(max_new - n_emitted - 1, alloc_len - cur_len), 0, gamma
    )
    n_allowed = torch.where(active, n_allowed, 0)

    draft = _draft(ctx_buf, prev_tok, cur_tok, ctx_len, gamma)  # [B, γ]
    toks = torch.cat([cur_tok[:, None], draft], dim=1)  # [B, span]
    q_pos = (cur_len - 1)[:, None] + j  # [B, span]
    writable = active[:, None] & (j <= n_allowed[:, None])
    write_page, write_off = spec_write_targets(
        page_table, q_pos, writable, page_size
    )
    bounds = torch.stack(
        [pad_lens[:, None].expand(B, span), q_pos + 1], dim=-1
    )  # [B, span, 2]
    positions = q_pos - pad_lens[:, None]

    logits = forward_paged_decode(
        params,
        cfg,
        toks,
        positions,
        pool,
        page_table,
        write_page,
        write_off,
        bounds,
        q_pos,
    )

    filt = filtered_logits(
        logits,
        greedy=greedy,
        top_k=top_k,
        temperature=temperature,
        top_p=top_p,
        use_top_p=use_top_p,
    )  # [B, span, V]
    probs = torch.softmax(filt, dim=-1)
    n_acc, bonus = accept_spans(
        probs, draft, n_allowed, generator, greedy=greedy
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

    def append(buf, start_raw, width):
        """Write ``emitted[:n_emit]`` at per-row ``start_raw``, masked so
        every other slot keeps its value (a clamped window near the end
        of the buffer must never smash earlier tokens)."""
        w_start = torch.clamp(start_raw, max=width - span)
        d = start_raw - w_start  # [B] ≥ 0 in-window shift
        src = torch.gather(
            emitted, 1, torch.clamp(j - d[:, None], 0, span - 1)
        )
        current = _rowwise_slice(buf, w_start, span)
        mask = (
            active[:, None]
            & (j >= d[:, None])
            & (j < (d + n_emit)[:, None])
        )
        _rowwise_write(buf, torch.where(mask, src, current), w_start)

    append(out_buf, torch.clamp(n_emitted, max=cap - 1), cap)
    append(ctx_buf, torch.clamp(ctx_len, max=C - 1), C)

    new_cur = torch.where(
        active, emitted[rows, torch.clamp(n_emit - 1, min=0)], cur_tok
    )
    new_prev = torch.where(
        active,
        torch.where(
            n_emit >= 2, emitted[rows, torch.clamp(n_emit - 2, min=0)], cur_tok
        ),
        prev_tok,
    )
    n_emitted = n_emitted + n_emit
    cur_len = cur_len + n_emit
    ctx_len = ctx_len + n_emit
    done = (any_eos | (n_emitted >= max_new)) & active
    active = active & ~done
    counts = torch.stack([n_allowed, n_acc, n_emit, active.long(), cur_len])
    return ctx_len, new_prev, new_cur, cur_len, n_emitted, active, counts


def fused_prefill_spec_chunk(
    params, cfg: ModelConfig, adm: _Admission, chunk_len: int, *spec_args,
    **spec_kw,
):
    """``fused_prefill_decode_chunk``'s speculative sibling: the in-flight
    admission's prompt chunk AND every resident row's draft+verify step,
    each the same body as its standalone form."""
    adm_logits = prefill_chunk(
        params,
        cfg,
        adm.tokens[:, adm.pos : adm.pos + chunk_len],
        adm.pads,
        adm.cache,
        adm.pos,
    )
    return adm_logits, _spec_chunk_impl(params, cfg, *spec_args, **spec_kw)


class ContinuousBatcher:
    """Admits requests into decode slots over one shared model + pool.

    Every tensor lives on the params' device (the engine's).
    ``kv_dtype="int8"`` makes the pool and every admission's dense cache
    int8 with per-(token, head) f32 scales (the reference's int8 layout).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_batch: int = 4,
        page_size: int = 64,
        capacity_tokens: int = 16384,
        max_new_cap: int = 1024,
        eos_ids: list[int] | None = None,
        greedy: bool = True,
        temperature: float = 0.7,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        chunk: int = 32,
        prefix_cache: bool | None = None,
        step_tokens: int = 0,
        speculative: bool | None = None,
        gamma: int | None = None,
        kv_dtype: str = "",
    ):
        if not interleave_mod.config().enabled:
            raise NotImplementedError(
                "the legacy serialized drive loop (interleave off) is not "
                "ported; the port's batcher runs the fused loop"
            )
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.device = params["embed"].device
        self._dtype = params["embed"].dtype
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.chunk = chunk
        # Sarathi-style shared per-step token budget: a fused step's
        # prompt chunk shrinks so chunk_len + n_live·width stays under it.
        self.step_tokens = step_tokens or (ADMISSION_CHUNK + max_batch * chunk)
        cfg_sp = spec_mod.config()
        self.speculative = (
            cfg_sp.enabled if speculative is None else bool(speculative)
        )
        self.gamma = self._clamp_gamma(
            cfg_sp.gamma if gamma is None else int(gamma), max_new_cap
        )
        self.greedy = greedy
        self.top_k = top_k
        self._temp = float(temperature)
        self._top_p = float(top_p)
        self._use_top_p = float(top_p) < 1.0
        dev = self.device
        self._eos = torch.as_tensor(
            sorted(set(eos_ids or [])) or [-1], dtype=torch.int64, device=dev
        )
        self._eos_np = np.asarray(sorted(set(eos_ids or [])) or [-1])
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)

        n_pages = -(-capacity_tokens // page_size)
        # Physical page 0 is the trash page; allocator ids shift +1.
        self.allocator = PageAllocator(n_pages, page_size)
        # Cross-round prefix KV cache over this pool (None = disabled):
        # its lifetime is the pool's, so a batcher kept alive across
        # rounds carries round R's blocks into round R+1's admissions.
        if prefix_cache is None:
            prefix_cache = prefix_mod.config().enabled
        self.prefix_cache = (
            prefix_mod.PrefixCache(
                self.allocator,
                page_size,
                max_pages=prefix_mod.config().max_pages,
            )
            if prefix_cache
            else None
        )
        layout = PagedCacheLayout(
            n_pages=n_pages + 1,
            page_size=page_size,
            n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim,
        )
        self.pool = init_page_pool(
            layout, device=dev, dtype=self._dtype, kv_dtype=kv_dtype
        )
        self.max_pages_per_seq = -(-cfg.max_seq_len // page_size)

        B, cap = self.B, max_new_cap
        self.cap = cap
        i64 = dict(dtype=torch.int64, device=dev)
        self.page_table = torch.zeros(
            (B, self.max_pages_per_seq), dtype=torch.int32, device=dev
        )
        self.cur_tok = torch.zeros((B,), **i64)
        self.cur_len = torch.ones((B,), **i64)  # ≥1 so q_pos ≥ 0
        self.pad_lens = torch.zeros((B,), **i64)
        self.n_emitted = torch.zeros((B,), **i64)
        self.max_new = torch.zeros((B,), **i64)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.out_buf = torch.zeros((B, cap), **i64)
        # Host view of ``active``, updated at handoff, release and each
        # step's flags read (the drive loop is one step deep, so a slot
        # cannot change owners between a step and its read).
        self._active_np = np.zeros((B,), bool)
        # Speculation state. ctx_buf is the DRAFT SOURCE: each row's real
        # (unpadded) prompt ids followed by everything it has emitted;
        # submit() guarantees prompt + budget fits max_seq_len. The host
        # views of cur_len/row_len/budget size draft page coverage.
        self._ctx_cap = cfg.max_seq_len
        self.ctx_buf = torch.zeros((B, self._ctx_cap), **i64)
        self.ctx_len = torch.zeros((B,), **i64)
        self.prev_tok = torch.zeros((B,), **i64)
        self._cur_len_np = np.ones((B,), np.int64)
        self._row_len_np = np.zeros((B,), np.int64)
        self._max_new_np = np.zeros((B,), np.int64)
        self._slot_spec: list[list[int]] = [[0, 0, 0] for _ in range(B)]

        self._slot_req: list[SchedRequest | None] = [None] * B
        self._slot_seq: list[int | None] = [None] * B
        self._slot_consumer: list = [None] * B
        self._slot_streamed: list[int] = [0] * B
        self._slot_cached: list[int] = [0] * B
        self._slot_prefill_s: list[float] = [0.0] * B
        self._slot_decode_s: list[float] = [0.0] * B
        self._admission: _Admission | None = None
        self._seq_counter = 0
        self.capacity_tokens = n_pages * page_size
        self.queue: list[SchedRequest] = []
        self.results: list[SchedResult] = []
        # Wall-clock telemetry: admission prefill (stalled vs overlapped)
        # vs decode; decode_time_s feeds the engine's per-row usage.
        self.stalled_prefill_s = 0.0
        self.overlapped_prefill_s = 0.0
        self.decode_time_s = 0.0

    @property
    def prefill_time_s(self) -> float:
        """Total admission-prefill wall clock: the stalled and overlapped
        buckets summed."""
        return self.stalled_prefill_s + self.overlapped_prefill_s

    def _record_prefill_time(self, seconds: float, *, overlapped: bool) -> None:
        if overlapped:
            self.overlapped_prefill_s += seconds
        else:
            self.stalled_prefill_s += seconds
        interleave_mod.stats.record_prefill_time(seconds, overlapped=overlapped)

    def reconfigure_sampling(
        self,
        *,
        greedy: bool | None = None,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int | None = None,
    ) -> None:
        """Retune sampling between rounds on a REUSED batcher (the pool,
        allocator and prefix cache survive). ``seed`` reseeds the
        generator for the new round."""
        if greedy is not None:
            self.greedy = greedy
        if top_k is not None:
            self.top_k = top_k
        if temperature is not None:
            self._temp = float(temperature)
        if top_p is not None:
            self._top_p = float(top_p)
            self._use_top_p = float(top_p) < 1.0
        if seed is not None:
            self._gen.manual_seed(seed)

    def reconfigure_speculative(
        self, enabled: bool | None = None, gamma: int | None = None
    ) -> None:
        """Retune speculation between DRAINS on a reused batcher. Only
        legal while no rows are resident: the admission's page
        reservation (full budget up front vs lazy per verify step)
        depends on the flag."""
        if any(self._active_np) or any(r is not None for r in self._slot_req):
            raise RuntimeError(
                "reconfigure_speculative on a batcher with resident rows"
            )
        if enabled is not None:
            self.speculative = bool(enabled)
            if self.speculative:
                self.gamma = self._clamp_gamma(self.gamma, self.cap)
        if gamma is not None:
            self.gamma = self._clamp_gamma(
                spec_mod._validate_gamma(int(gamma)), self.cap
            )

    def _clamp_gamma(self, gamma: int, cap: int) -> int:
        """Bound γ so a step's full span (γ drafts + the bonus token) fits
        the per-row output buffer; a 1-token cap degrades to plain
        decode."""
        if cap <= 1:
            self.speculative = False
            return gamma
        return max(1, min(gamma, cap - 1))

    # -- admission ---------------------------------------------------------

    def submit(self, req: SchedRequest) -> None:
        """Reject infeasible requests up front — anything accepted here is
        schedulable once enough resident sequences finish."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.max_new_tokens > self.cap:
            raise ValueError(
                f"max_new_tokens {req.max_new_tokens} exceeds scheduler "
                f"cap {self.cap}"
            )
        total = bucket_length(len(req.prompt_ids)) + req.max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt (bucketed) + budget = {total} tokens exceeds the "
                f"model context {self.cfg.max_seq_len}"
            )
        if total > self.capacity_tokens:
            raise ValueError(
                f"request needs {total} tokens but the pool holds only "
                f"{self.capacity_tokens}; raise capacity_tokens"
            )
        self.queue.append(req)

    def _new_cache(self, S: int) -> dict:
        return init_cache(
            self.cfg, 1, S, device=self.device, dtype=self._dtype,
            kv_dtype=self.kv_dtype,
        )

    def _start_admission(self, slot: int, req: SchedRequest) -> bool:
        """Reserve pages and set up the chunked prefill for ``slot``;
        False if the pool is momentarily full (the request stays queued
        and retries after residents free pages)."""
        if self.prefix_cache is not None:
            return self._start_admission_cached(slot, req)
        tokens_np, pads_np = pad_batch([req.prompt_ids], pad_id=0)
        S = tokens_np.shape[1]
        # Speculative rows reserve only the prompt + the first decode
        # write slot (draft headroom is allocated per verify step and
        # rolled back); plain rows reserve their full budget up front.
        total = S + (1 if self.speculative else req.max_new_tokens)
        seq_id = self._seq_counter
        self.allocator.new_sequence(seq_id)
        try:
            self.allocator.extend(seq_id, total)
            self._admission = _Admission(
                slot=slot,
                req=req,
                seq_id=seq_id,
                tokens=torch.as_tensor(tokens_np, device=self.device).long(),
                pads=torch.as_tensor(pads_np, device=self.device).long(),
                cache=self._new_cache(S),
                pos=0,
                S=S,
                S_real=S,
                prefill_end=S,
            )
        except OutOfPages:
            self.allocator.free_sequence(seq_id)
            return False
        except BaseException:
            self.allocator.free_sequence(seq_id)
            raise
        self._seq_counter += 1
        return True

    def _extend_evicting(self, seq_id: int, n_tokens: int) -> None:
        """``allocator.extend`` that converts allocation pressure into
        prefix-cache LRU eviction before giving up."""
        if self.prefix_cache is None:
            self.allocator.extend(seq_id, n_tokens)
        else:
            self.prefix_cache.extend_evicting(seq_id, n_tokens)

    def _start_admission_cached(self, slot: int, req: SchedRequest) -> bool:
        """Prefix-cache admission: adopt the longest cached prefix and set
        up a CANONICAL-layout (pad 0, slot == logical position) prefill of
        only the remainder. The last prompt token always re-runs, even on
        a full-prefix hit: its logits seed sampling."""
        ids = req.prompt_ids
        S_real = len(ids)
        ps = self.page_size
        # record=False: a pool-full deferral retries this method every
        # iteration; stats count once, on success, with the adopted match.
        matched, pages = self.prefix_cache.lookup(ids, record=False)
        limit = ((S_real - 1) // ps) * ps
        matched = min(matched, limit)
        pages = pages[: matched // ps]
        S = bucket_length(S_real)
        prefill_end = min(-(-S_real // ps) * ps, S)
        tokens_np = np.zeros((1, S), np.int64)
        tokens_np[0, :S_real] = np.asarray(ids, np.int64)
        seq_id = self._seq_counter
        self.allocator.new_sequence(seq_id)
        try:
            if matched:
                self.allocator.adopt(seq_id, pages, matched)
            self._extend_evicting(
                seq_id,
                (S_real - matched)
                + (1 if self.speculative else req.max_new_tokens),
            )
            cache = self._new_cache(S)
            if matched:
                # Materialize the adopted prefix KV (and an int8 pool's
                # scales: every pool key) into the dense admission cache
                # so the delta's attention sees it.
                table = (
                    np.asarray(self.allocator.table(seq_id)[: matched // ps])
                    + 1
                )  # physical ids
                slots = np.arange(matched)[None, :]
                gathered = read_tokens(self.pool, table[slots // ps], slots % ps)
                for k in cache:
                    cache[k][:, :, :, :matched] = gathered[k]
            self._admission = _Admission(
                slot=slot,
                req=req,
                seq_id=seq_id,
                tokens=torch.as_tensor(tokens_np, device=self.device),
                pads=torch.zeros((1,), dtype=torch.int64, device=self.device),
                cache=cache,
                pos=matched,
                S=S,
                canonical=True,
                S_real=S_real,
                matched=matched,
                prefill_end=prefill_end,
            )
        except OutOfPages:
            self.allocator.free_sequence(seq_id)
            return False
        except BaseException:
            self.allocator.free_sequence(seq_id)
            raise
        self._seq_counter += 1
        self.prefix_cache.stats.record_lookup(matched)
        return True

    def _advance_admission(self) -> None:
        """One STANDALONE prefill chunk of the in-flight admission — used
        when no resident row is decoding (nothing to ride with) and for
        the final chunk. Timed to its completion: a genuine stall."""
        adm = self._admission
        t0 = time.monotonic()
        chunk_len = _next_chunk_len(adm.remaining)
        adm.last_logits = prefill_chunk(
            self.params,
            self.cfg,
            adm.tokens[:, adm.pos : adm.pos + chunk_len],
            adm.pads,
            adm.cache,
            adm.pos,
        )
        adm.pos += chunk_len
        _sync(self.device)
        elapsed = time.monotonic() - t0
        self._record_prefill_time(elapsed, overlapped=False)
        adm.prefill_s += elapsed
        interleave_mod.stats.record_step(fused=False, prefill_only=True)
        prefix_mod.stats.record_prefill(chunk_len, 0)
        if adm.pos >= adm.prefill_end:
            self._finish_admission()

    def _finish_admission(self) -> None:
        """Prefill done: scatter the dense cache into this sequence's pages
        (+1 shift: page 0 is trash), sample the first token and activate
        the slot. A host sync: the first token decides activation."""
        t0 = time.monotonic()
        adm = self._admission
        slot, req, seq_id, S = adm.slot, adm.req, adm.seq_id, adm.S
        cache, last_logits = adm.cache, adm.last_logits
        table = np.asarray(self.allocator.table(seq_id), np.int64) + 1
        if adm.canonical:
            if adm.prefill_end > adm.S_real:
                # The final chunk's last slot is bucket garbage; re-run the
                # last REAL token (identical KV rewrite) for its logits.
                last_logits = prefill_chunk(
                    self.params,
                    self.cfg,
                    adm.tokens[:, adm.S_real - 1 : adm.S_real],
                    adm.pads,
                    cache,
                    adm.S_real - 1,
                )
            # Scatter only the delta [matched, S_real): adopted prefix
            # pages are shared and never rewritten.
            scat = np.arange(adm.matched, adm.S_real)
            pad = 0
        else:
            scat = np.arange(S)
            pad = int(adm.pads[0])
        slots = scat[None, :]
        lo, hi = int(scat[0]), int(scat[-1]) + 1
        quant_kv = "ks" in cache
        write_tokens(
            self.pool,
            cache["k"][:, :, :, lo:hi],
            cache["v"][:, :, :, lo:hi],
            table[slots // self.page_size],
            slots % self.page_size,
            ks_new=cache["ks"][:, :, :, lo:hi] if quant_kv else None,
            vs_new=cache["vs"][:, :, :, lo:hi] if quant_kv else None,
        )
        first = sample_tokens(
            last_logits,
            self._gen,
            greedy=self.greedy,
            top_k=self.top_k,
            temperature=self._temp,
            top_p=self._top_p,
            use_top_p=self._use_top_p,
        )[0]

        row_table = np.zeros((self.max_pages_per_seq,), np.int32)
        row_table[: len(table)] = table
        self.page_table[slot] = torch.as_tensor(row_table, device=self.device)
        self.cur_tok[slot] = first
        # Canonical rows live at pad 0 with their true length; padded rows
        # keep the bucketed length + left pad. Per-row pad_lens and
        # cur_len let both layouts coexist in one decode batch.
        row_len = adm.S_real if adm.canonical else S
        self.cur_len[slot] = row_len + 1
        self.pad_lens[slot] = pad
        self.out_buf[slot] = 0
        self.out_buf[slot, 0] = first
        interleave_mod.stats.record_sync()
        first_np = int(first)
        first_is_eos = bool(np.isin(first_np, self._eos_np))
        self.n_emitted[slot] = 1
        self.max_new[slot] = req.max_new_tokens
        row_active = (req.max_new_tokens > 1) and not first_is_eos
        self.active[slot] = row_active
        self._active_np[slot] = row_active
        if self.speculative:
            # Seed the draft source: the REAL (unpadded) prompt ids
            # followed by the first sampled token.
            ids_np = np.asarray(req.prompt_ids, np.int64)
            row_ctx = np.zeros((self._ctx_cap,), np.int64)
            row_ctx[: len(ids_np)] = ids_np
            row_ctx[len(ids_np)] = first_np
            self.ctx_buf[slot] = torch.as_tensor(row_ctx, device=self.device)
            self.ctx_len[slot] = len(ids_np) + 1
            self.prev_tok[slot] = int(ids_np[-1]) if len(ids_np) else 0
            self._cur_len_np[slot] = row_len + 1
            self._row_len_np[slot] = row_len
            self._max_new_np[slot] = req.max_new_tokens
        self._slot_spec[slot] = [0, 0, 0]
        if adm.canonical and self.prefix_cache is not None:
            # Cache this prompt's full blocks (an adopted prefix
            # re-inserts as a no-op; only new tail blocks take refs).
            n_full = adm.S_real // self.page_size
            if n_full:
                self.prefix_cache.insert(
                    list(req.prompt_ids[: n_full * self.page_size]),
                    self.allocator.table(seq_id)[:n_full],
                )
            prefix_mod.stats.record_prefill(0, adm.matched)
        # Ownership handoff: from here the slot accounts for the sequence.
        self._admission = None
        self._slot_req[slot] = req
        self._slot_seq[slot] = seq_id
        self._slot_cached[slot] = adm.matched
        self._slot_decode_s[slot] = 0.0
        self._slot_consumer[slot] = req.on_tokens
        self._slot_streamed[slot] = 0
        if req.on_tokens is not None:
            stream_mod.stats.record_request()
        elapsed = time.monotonic() - t0
        self._record_prefill_time(elapsed, overlapped=False)
        self._slot_prefill_s[slot] = adm.prefill_s + elapsed
        # First-token stream delivery rides the handoff's read of it.
        if req.on_tokens is not None:
            first_arr = np.asarray([first_np])
            keep = self._deliver_stream(slot, 1, first_arr)
            if not keep and row_active:
                self._cancel_slot(slot, 1, first_arr)
                return
        if not row_active:
            self._finish_slot(slot)

    def _admit(self) -> None:
        """Fill free slots from the queue. Prompts with at most one
        ADMISSION_CHUNK of work left admit to completion immediately, so a
        burst fills the batch before the next decode step; the first
        longer prompt stays in flight and its chunks ride the residents'
        steps (one chunked admission at a time)."""
        for slot in range(self.B):
            if self._admission is not None or not self.queue:
                return
            if self._slot_req[slot] is None and not self._active_np[slot]:
                if not self._start_admission(slot, self.queue[0]):
                    return  # pool full: the request stays queued (FIFO)
                self.queue.pop(0)
                while (
                    self._admission is not None
                    and self._admission.slot == slot
                    and self._admission.remaining <= ADMISSION_CHUNK
                ):
                    self._advance_admission()

    # -- slot release, streaming, completion -------------------------------

    def _release_slot(self, slot: int) -> int:
        """THE slot-release surgery, shared by completion and
        cancellation: drop the sequence's page references (pages shared
        with the prefix cache survive), clear ownership and streaming
        state, deactivate the row and zero its page-table row. Returns
        the pages actually freed."""
        free0 = self.allocator.free_pages
        self.allocator.free_sequence(self._slot_seq[slot])
        self._slot_req[slot] = None
        self._slot_seq[slot] = None
        self._slot_consumer[slot] = None
        self._slot_streamed[slot] = 0
        self.active[slot] = False
        self._active_np[slot] = False
        self.page_table[slot] = 0
        return self.allocator.free_pages - free0

    def _stream_armed(self, slots) -> bool:
        """True when any of ``slots`` has a streaming consumer — the gate
        for the token reads that ride the step's flags read."""
        return any(self._slot_consumer[s] is not None for s in slots)

    def _deliver_stream(self, slot: int, n: int, tokens) -> bool:
        """Deliver this slot's tokens-so-far to its consumer (pure host
        callback). Returns False when the consumer asked to cancel. A
        consumer that RAISES is disabled for the rest of the request and
        the row decodes to its budget."""
        cb = self._slot_consumer[slot]
        if cb is None or n <= self._slot_streamed[slot]:
            return True
        new = n - self._slot_streamed[slot]
        self._slot_streamed[slot] = n
        stream_mod.stats.record_delivery(new)
        try:
            return bool(cb(np.asarray(tokens[:n])))
        except Exception:
            self._slot_consumer[slot] = None
            return True

    def _stream_entry(
        self, emitted_np: np.ndarray, out_np: np.ndarray, live: list[int]
    ) -> None:
        """Stream one step's tokens to every live consumer and cancel the
        rows whose consumers are done."""
        for slot in live:
            if self._slot_consumer[slot] is None:
                continue
            n = int(emitted_np[slot])
            keep = self._deliver_stream(slot, n, out_np[slot])
            if not keep and self._active_np[slot]:
                self._cancel_slot(slot, n, out_np[slot, :n])

    def _cancel_slot(self, slot: int, n: int, tokens) -> None:
        """Mid-decode cancellation: a clean result carrying the partial
        transcript. Before the references drop, the computed KV is
        SALVAGED: the full pages covering prompt + emitted tokens go into
        the prefix cache (the last emitted token's KV is only written when
        it is consumed, so full pages cover at most prompt + n - 1)."""
        req = self._slot_req[slot]
        seq = self._slot_seq[slot]
        saved = max(int(req.max_new_tokens) - n, 0)
        if self.prefix_cache is not None:
            covered = len(req.prompt_ids) + max(n - 1, 0)
            n_full = covered // self.page_size
            if n_full:
                ids = list(req.prompt_ids) + [
                    int(t) for t in tokens[: max(n - 1, 0)]
                ]
                self.prefix_cache.insert(
                    ids[: n_full * self.page_size],
                    self.allocator.table(seq)[:n_full],
                )
        st = self._slot_spec[slot]
        self._release_slot(slot)
        stream_mod.stats.record_cancel(n, saved)
        self.results.append(
            SchedResult(
                req_id=req.req_id,
                tokens=np.asarray(tokens[:n], np.int32),
                n_generated=n,
                cancelled=True,
                tokens_saved=saved,
                cached_tokens=self._slot_cached[slot],
                prefill_time_s=self._slot_prefill_s[slot],
                spec_steps=st[0],
                spec_drafted=st[1],
                spec_accepted=st[2],
                decode_time_s=self._slot_decode_s[slot],
            )
        )

    def _finish_slot(self, slot: int) -> None:
        """Slot completion: read the row's count and tokens (a host sync;
        the row is frozen), deliver the final tail to its consumer, and
        release the slot."""
        interleave_mod.stats.record_sync()
        self._active_np[slot] = False  # invariant: no owner ⇒ not live
        req = self._slot_req[slot]
        n = int(self.n_emitted[slot])
        row = self.out_buf[slot, :n].cpu().numpy().astype(np.int32)
        st = self._slot_spec[slot]
        self._deliver_stream(slot, n, row)
        self.results.append(
            SchedResult(
                req_id=req.req_id,
                tokens=row,
                n_generated=n,
                cached_tokens=self._slot_cached[slot],
                prefill_time_s=self._slot_prefill_s[slot],
                spec_steps=st[0],
                spec_drafted=st[1],
                spec_accepted=st[2],
                decode_time_s=self._slot_decode_s[slot],
            )
        )
        self._release_slot(slot)

    def _collect(self) -> None:
        """Resolve finished slots from the host view of ``active`` (a row
        inactive after the last step is frozen)."""
        for slot in range(self.B):
            if self._slot_req[slot] is not None and not self._active_np[slot]:
                self._finish_slot(slot)

    # -- main loop ---------------------------------------------------------

    def run_all(self, timeout_s: float = 0.0) -> list[SchedResult]:
        """Drain the queue: admit, step (fused prefill+decode), collect,
        repeat. ``timeout_s`` > 0 is a best-effort wall-clock budget:
        on expiry resident rows finish with what they have emitted and
        queued requests return zero tokens. Every submitted ``req_id``
        gets exactly one ``SchedResult``."""
        self._drive(timeout_s)
        out = sorted(self.results, key=lambda r: r.req_id)
        # Drain per-run state: a batcher kept alive across rounds must
        # not replay old results.
        self.results = []
        return out

    def _has_work(self) -> bool:
        return bool(
            self.queue
            or self._admission is not None
            or any(r is not None for r in self._slot_req)
        )

    def _expire_timeout(self) -> None:
        """Deadline hit: the in-flight admission unwinds (pages freed,
        its request reports with the queue), resident rows finish with
        what they have, queued requests resolve with zero tokens."""
        interleave_mod.stats.record_sync()
        if self._admission is not None:
            adm = self._admission
            self._admission = None
            self.allocator.free_sequence(adm.seq_id)
            self.queue.insert(0, adm.req)
        self.active.zero_()
        self._active_np[:] = False
        self._collect()
        for req in self.queue:
            self.results.append(
                SchedResult(
                    req_id=req.req_id,
                    tokens=np.zeros((0,), np.int32),
                    n_generated=0,
                )
            )
        self.queue.clear()

    def _fused_chunk_len(self, remaining: int, n_live: int, width: int) -> int:
        """Prompt-chunk length for a fused step: the largest power of two
        that fits the shared per-step token budget after the live rows'
        work (``width`` tokens each: the decode chunk, or γ+1 verify
        positions) — the newcomer's prefill shrinks before resident
        latency does."""
        cap = min(ADMISSION_CHUNK, max(self.step_tokens - n_live * width, 1))
        c = ADMISSION_CHUNK
        while c > cap or c > remaining:
            c //= 2
        return max(c, 1)

    def _decode_args(self) -> tuple:
        return (
            self.pool,
            self.page_table,
            self.cur_tok,
            self.cur_len,
            self.pad_lens,
            self.n_emitted,
            self.max_new,
            self.active,
            self.out_buf,
            self._eos,
            self._gen,
            self._temp,
            self._top_p,
        )

    def _decode_kw(self) -> dict:
        return dict(
            chunk=self.chunk,
            greedy=self.greedy,
            top_k=self.top_k,
            use_top_p=self._use_top_p,
        )

    def _dispatch_fused(self, adm: _Admission, chunk_len: int) -> None:
        """ONE step advancing the admission's prompt chunk and all live
        rows' decode chunk."""
        adm.last_logits, (
            self.cur_tok,
            self.cur_len,
            self.n_emitted,
            self.active,
        ) = fused_prefill_decode_chunk(
            self.params, self.cfg, adm, chunk_len, *self._decode_args(),
            **self._decode_kw(),
        )
        adm.pos += chunk_len
        interleave_mod.stats.record_step(fused=True)
        prefix_mod.stats.record_prefill(chunk_len, 0)

    def _dispatch_decode(self) -> None:
        """One decode-only chunk."""
        (
            self.cur_tok,
            self.cur_len,
            self.n_emitted,
            self.active,
        ) = _decode_chunk_impl(
            self.params, self.cfg, *self._decode_args(), **self._decode_kw()
        )
        interleave_mod.stats.record_step(fused=False)

    def _prepare_spec_step(self, live: list[int]) -> torch.Tensor:
        """Size page coverage for ONE speculative step over ``live`` rows
        and return the per-row draft bound (the step's ``alloc_len``).

        - extend each row to ``cur_len + min(γ+1, budget left)`` KV slots
          through the prefix cache's LRU-evicting extend;
        - under genuine pressure fall back to ``cur_len + 1`` (the next
          mandatory write), degrading the row to a plain step (an
          ``OutOfPages`` there propagates: fault isolation is not
          ported);
        - the step receives ``covered_tokens - 1`` as its draft bound:
          the −1 reserves the slot the step's LAST emitted token needs
          next step, so the post-step fix-up never allocates.

        The page table is re-pushed from the allocator's host tables every
        step (rolled-back pages may have moved to another row).
        """
        span = self.gamma + 1
        alloc = np.zeros((self.B,), np.int64)
        for slot in live:
            seq = self._slot_seq[slot]
            cl = int(self._cur_len_np[slot])
            remaining = int(self._max_new_np[slot]) - (
                cl - int(self._row_len_np[slot])
            )
            length = self.allocator.length(seq)
            want = cl + min(span, max(remaining, 1))
            try:
                if want > length:
                    self._extend_evicting(seq, want - length)
            except OutOfPages:
                if cl + 1 > length:
                    self._extend_evicting(seq, cl + 1 - length)
            alloc[slot] = self.allocator.covered_tokens(seq) - 1
        tables = np.zeros((self.B, self.max_pages_per_seq), np.int32)
        for slot in live:
            t = self.allocator.table(self._slot_seq[slot])
            tables[slot, : len(t)] = np.asarray(t, np.int32) + 1
        self.page_table = torch.as_tensor(tables, device=self.device)
        return torch.as_tensor(alloc, device=self.device)

    def _dispatch_spec(
        self, alloc_len: torch.Tensor, adm: _Admission | None, chunk_len: int
    ) -> torch.Tensor:
        """ONE speculative step — every live row's draft+verify, fused
        with the in-flight admission's next prompt chunk when ``adm`` is
        given — returning the stacked per-row counts (still on device)."""
        args = (
            self.pool,
            self.page_table,
            self.ctx_buf,
            self.ctx_len,
            self.prev_tok,
            self.cur_tok,
            self.cur_len,
            self.pad_lens,
            self.n_emitted,
            self.max_new,
            alloc_len,
            self.active,
            self.out_buf,
            self._eos,
            self._gen,
            self._temp,
            self._top_p,
        )
        kw = dict(
            gamma=self.gamma,
            greedy=self.greedy,
            top_k=self.top_k,
            use_top_p=self._use_top_p,
        )
        if adm is not None:
            adm.last_logits, outs = fused_prefill_spec_chunk(
                self.params, self.cfg, adm, chunk_len, *args, **kw
            )
            adm.pos += chunk_len
            interleave_mod.stats.record_step(fused=True)
            prefix_mod.stats.record_prefill(chunk_len, 0)
        else:
            outs = _spec_chunk_impl(self.params, self.cfg, *args, **kw)
            interleave_mod.stats.record_step(fused=False)
        (
            self.ctx_len,
            self.prev_tok,
            self.cur_tok,
            self.cur_len,
            self.n_emitted,
            self.active,
            counts,
        ) = outs
        return counts

    def _apply_spec_counts(self, counts_np: np.ndarray, live: list[int]) -> None:
        """Apply one spec step's per-row counts to the host state: advance
        the cur_len/active views, ROLL BACK draft pages past each row's
        accepted prefix (``PageAllocator.truncate``), record telemetry."""
        for slot in live:
            n_allowed, n_acc = int(counts_np[0, slot]), int(counts_np[1, slot])
            new_cl = int(counts_np[4, slot])
            seq = self._slot_seq[slot]
            length = self.allocator.length(seq)
            if new_cl > length:
                # Fully accepted span: a pure length bump within the pages
                # already held (the draft bound's −1 reserve).
                self.allocator.extend(seq, new_cl - length)
            else:
                self.allocator.truncate(seq, new_cl)
            self._cur_len_np[slot] = new_cl
            st = self._slot_spec[slot]
            st[0] += 1
            st[1] += n_allowed
            st[2] += n_acc
            self._active_np[slot] = bool(counts_np[3, slot])

    def _drive(self, timeout_s: float) -> None:
        """Admit → one step (fused when an admission and live rows
        coexist) → read the step's flags or counts → collect. The
        reference's pipelined loop at depth 1."""
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        while self._has_work():
            if deadline is not None and time.monotonic() > deadline:
                self._expire_timeout()
                break
            self._admit()
            adm = self._admission
            live = [s for s in range(self.B) if self._active_np[s]]
            t0 = time.monotonic()
            fused_share = 0.0
            dispatched = False
            spec = self.speculative
            width = (self.gamma + 1) if spec else self.chunk
            spec_counts = None
            # Fuse only the LEADING prefill chunks: the FINAL chunk runs
            # standalone so the handoff happens before this iteration's
            # decode step and the newcomer joins it immediately.
            chunk_len = (
                self._fused_chunk_len(adm.remaining, len(live), width)
                if adm is not None and live
                else 0
            )
            ride = adm is not None and bool(live) and chunk_len < adm.remaining
            if spec and live and (ride or adm is None):
                alloc_len = self._prepare_spec_step(live)
            if ride:
                if spec:
                    spec_counts = self._dispatch_spec(alloc_len, adm, chunk_len)
                else:
                    self._dispatch_fused(adm, chunk_len)
                # The halves are not separately measurable without a
                # profiler: split the wall by token share.
                fused_share = chunk_len / (chunk_len + len(live) * width)
                dispatched = True
            else:
                if adm is not None:
                    # Final chunk, or nothing live to ride with: a
                    # standalone (stalled) chunk, which also performs the
                    # handoff when the prefill completes.
                    self._advance_admission()
                    live = [s for s in range(self.B) if self._active_np[s]]
                    if spec and live:
                        alloc_len = self._prepare_spec_step(live)
                    t0 = time.monotonic()
                if live:
                    if spec:
                        spec_counts = self._dispatch_spec(alloc_len, None, 0)
                    else:
                        self._dispatch_decode()
                    dispatched = True
            if dispatched:
                interleave_mod.stats.record_sync()
                if spec:
                    # The accept counts: the host cannot size the next
                    # step's coverage or roll drafts back without them.
                    self._apply_spec_counts(spec_counts.cpu().numpy(), live)
                    emitted_np = self._cur_len_np - self._row_len_np
                else:
                    act = self.active.cpu().numpy()
                    for s in live:
                        self._active_np[s] = bool(act[s])
                    emitted_np = None
                if self._stream_armed(live):
                    if emitted_np is None:
                        emitted_np = self.n_emitted.cpu().numpy()
                    self._stream_entry(emitted_np, self.out_buf.cpu().numpy(), live)
                dt = time.monotonic() - t0
                dec_dt = dt
                if fused_share > 0.0:
                    p = dt * fused_share
                    self._record_prefill_time(p, overlapped=True)
                    adm.prefill_s += p
                    dec_dt = dt - p
                self.decode_time_s += dec_dt
                for s in live:
                    self._slot_decode_s[s] += dec_dt / len(live)
            self._collect()
