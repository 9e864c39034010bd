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
read per decode step.

Drive loops (engine/interleave.py holds the config and telemetry): the
default loop (``_drive_pipelined``) is the reference's fused + pipelined
loop, up to ``pipeline_depth`` steps in flight (default 2, the double
buffer). Each decode step's flags are copied into pinned host memory with
``non_blocking=True`` right after its dispatch, behind a CUDA event; the
host applies them (``_fetch_entry``) as soon as the event has completed
(``_entry_ready``), or waits on it when the depth bound forces the fetch.
Fetches only DEACTIVATE, and only rows whose slot still has the ownership
generation (``_slot_gen``) recorded at dispatch: a slot freed and
re-admitted while a step was in flight bumps its generation. The
speculative path runs one step deep (the host needs each step's accept
counts before the next). ``interleave=False`` (CLI ``--no-interleave``,
``ADVSPEC_INTERLEAVE=0``) runs the reference's legacy serialized loop
(``_drive_legacy``): one prompt-chunk dispatch, one decode dispatch and
their host syncs per iteration. Every host read is counted in
``interleave.stats.sync_points``. Each dispatch is reported to the retrace
watch (``obs.retrace``) under the reference's program name and key; the
port has no jit cache to probe, so the watch counts compiles by key
novelty.

Inactive-slot safety: physical page 0 is a reserved TRASH page no sequence
owns. Allocator ids are shifted +1 and inactive rows (and rejected drafts)
write their masked, discarded K/V there, so a dead slot can never scribble
into pages re-allocated to a newcomer; the paged kernels skip page 0.

Fault isolation (the reference's): a fault at the decode step, the
admission prefill or page allocation evicts only the affected slot — its
``SchedResult`` carries the partial tokens and ``error``/``fault_kind`` —
frees its pages and leaves the rest of the batch decoding. Transient
faults (resilience/faults.py) get one requeue. A fault that leaves the
device unusable re-raises instead (the engine then drops the batcher):
on CUDA that is every runtime error but out-of-memory, which is sticky
and poisons the context. The pool is written in place, so a step that
faults part-way may have written K/V at or past a row's committed length;
those slots lie in the row's own tail pages, never in a page the prefix
cache shares (cached blocks are full prompt pages, and every write
position is at or past the prompt), and the row rewrites them when it
decodes again. The chaos injector's ``scheduler_chunk``, ``kv_alloc`` and
``kv_swap`` seams live here.

Per-request watchdog (``SchedRequest.deadline_s``): both drive loops check
per-request deadlines once per iteration — host clock math only — and
evict an over-deadline slot as ``FaultKind.TIMEOUT`` through the same
surgery, partial text delivered to its stream consumer, co-residents
untouched, no batcher-level requeue.

Tiered KV (engine/kvtier.py): with the prefix cache on and tiers armed,
LRU-evicted prefix blocks demote to host RAM (and the disk store), and an
admission whose prefix continues in a lower tier promotes those blocks
into its pages instead of prefilling them. Demotion copies land in a
reused pinned arena (``kvtier.DemotionArena``) with ``non_blocking=True``
and a CUDA event; the lazy materializer waits on that event only.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine import interleave as interleave_mod
from adversarial_spec_tpu_torch.engine import kvtier as kvtier_mod
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
from adversarial_spec_tpu_torch.resilience import faults, injector

TRASH_PAGE = 0
# Admission prefill granularity — finer than generate.py's PREFILL_CHUNK
# (1024): decode steps slot in between more often while a newcomer's
# prompt streams in.
ADMISSION_CHUNK = 512
# numpy's names for the pool dtypes: the tier store's fingerprint part
# (the reference's ``str`` of its dtype), so both packages namespace a
# model's KV the same way.
_DTYPE_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
}


def context_lost(exc: BaseException) -> bool:
    """True when ``exc`` leaves the device unusable, so no slot surgery
    may follow: a CUDA runtime error other than out-of-memory (illegal
    address, launch failure, device-side assert) is sticky and poisons
    the context; an out-of-memory error leaves it usable. A sticky error
    that a kernel wrapper reports as its launch's return code resurfaces
    as ``torch.AcceleratorError`` at the next CUDA call."""
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    return isinstance(exc, torch.AcceleratorError)


@dataclass
class SchedRequest:
    req_id: int
    prompt_ids: list[int]
    max_new_tokens: int
    # Per-request watchdog deadline in seconds from submission (0 = none),
    # checked once per drive-loop iteration (``_expire_request_deadlines``).
    deadline_s: float = 0.0
    # Causal-trace ids (obs/trace.py) of the debate round that issued the
    # request; every flight-recorder event for it is stamped with them.
    trace_id: str = ""
    span_id: str = ""
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
    matched: int = 0  # tokens adopted or promoted (page multiple)
    prefill_end: int = 0  # prefill covers [pos0, prefill_end)
    prefill_s: float = 0.0  # this request's own prefill wall-clock
    # Set when a fused step carrying this admission faulted: the next
    # chunk runs STANDALONE, so a prefill-side error is attributed to the
    # admission (_abort_admission) instead of evicting another resident
    # every iteration.
    fuse_deferred: bool = False

    @property
    def remaining(self) -> int:
        return self.prefill_end - self.pos


@dataclass
class SchedResult:
    req_id: int
    tokens: np.ndarray  # generated ids (0 past the row's end)
    n_generated: int
    # Set when a fault evicted this request: ``tokens`` then holds the
    # PARTIAL decode up to the fault and ``fault_kind`` is the
    # resilience-taxonomy value (resilience/faults.py). None = clean.
    error: str | None = None
    fault_kind: str | None = None
    # Prompt tokens served from the prefix cache (and lower tiers) and the
    # wall-clock this request's own admission prefill took.
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
    # Echo of the request's causal-trace ids.
    trace_id: str = ""
    span_id: str = ""


class _StepEntry(NamedTuple):
    """One decode step in flight: host copies of its flags (and, while a
    stream consumer is attached, its emitted counts and output buffer),
    taken at dispatch, and the (slot, generation) pairs live then. On
    CUDA the copies are ``non_blocking`` into pinned memory and ``done``
    is the event recorded behind them; on the CPU they are done when
    taken and ``done`` is None."""

    done: object  # torch.cuda.Event | None
    active: torch.Tensor
    n_emitted: torch.Tensor | None
    out_buf: torch.Tensor | None
    live: tuple


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
    record_syncs: bool = True,
):
    """Up to ``chunk`` decode steps over whatever rows are active; stops
    early once no row is. THE paged decode loop: the fused step and the
    round-synchronous ``generate(paged=True)`` run this same body, so the
    write-page lookup, bounds and sampling glue exist once. Each step's
    flag read counts as a drive-loop sync point unless ``record_syncs``
    is False (``generate`` has no drive loop). On a mesh it runs over
    ``MeshParams`` and a sharded pool (``forward_paged_decode`` takes the
    mesh). Returns (cur, cur_len, n_emitted, active)."""
    B = cur_tok.shape[0]
    page_size = pool["k"].shape[3]
    cap = out_buf.shape[1]
    rows = torch.arange(B, device=cur_tok.device)
    cur = cur_tok
    for _ in range(chunk):
        # The reference's while_loop condition: one host read per step.
        if record_syncs:
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
    ``interleave`` (None = the process config) picks the drive loop and
    ``pipeline_depth`` (None = the process config, clamped to [1, 2]) the
    steps the pipelined loop keeps in flight.
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
        interleave: bool | None = None,
        pipeline_depth: int | None = None,
        step_tokens: int = 0,
        speculative: bool | None = None,
        gamma: int | None = None,
        kv_dtype: str = "",
    ):
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.device = params["embed"].device
        self._dtype = params["embed"].dtype
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.chunk = chunk
        cfg_il = interleave_mod.config()
        self.interleave = cfg_il.enabled if interleave is None else bool(interleave)
        self.pipeline_depth = interleave_mod.clamp_depth(
            cfg_il.pipeline_depth if pipeline_depth is None else pipeline_depth
        )
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
        # Tiered KV (engine/kvtier.py): host-RAM demotion of LRU-evicted
        # prefix blocks and the persistent disk store, both below this
        # pool. The host budget is denominated in real block bytes (K and
        # V, plus an int8 pool's f32 scale pages); the store is namespaced
        # by a model/config/layout fingerprint. None when tiering (or the
        # prefix cache) is off.
        self.tiers = None
        self._arena = None
        if self.prefix_cache is not None and kvtier_mod.armed():
            kv_bytes = 1 if kv_dtype == "int8" else self._dtype.itemsize
            block_bytes = (
                cfg.n_layers * cfg.n_kv_heads * page_size * cfg.head_dim
            ) * kv_bytes * 2
            if kv_dtype == "int8":  # per-(token, head) f32 scale pages
                block_bytes += cfg.n_layers * cfg.n_kv_heads * page_size * 4 * 2
            self.tiers = kvtier_mod.build_for(
                block_bytes,
                (cfg, page_size, kv_dtype, _DTYPE_NAMES.get(self._dtype, self._dtype)),
            )
            if self.tiers is not None:
                if dev.type == "cuda":
                    host = self.tiers.host
                    n_slots = (
                        host.capacity_bytes // host.block_bytes if host is not None else 0
                    ) + kvtier_mod._LAZY_RESOLVE_AFTER
                    # Slot layout: each pool key's block slice, 256-B
                    # aligned (an int8 pool's scale pages included).
                    slot_bytes = sum(
                        kvtier_mod.DemotionArena._aligned(
                            t.shape[0] * t.shape[2] * page_size * t.shape[4]
                            * t.element_size()
                        )
                        for t in self.pool.values()
                    )
                    self._arena = kvtier_mod.DemotionArena(slot_bytes, n_slots)
                # The cache holds the fetch through a weak reference:
                # a bound method would tie the batcher (which owns the
                # cache) into a cycle, and its device pool and arena
                # would outlive the engine until a garbage collection.
                fetch = weakref.WeakMethod(self._fetch_page_kv)
                self.prefix_cache.attach_tiers(
                    self.tiers, kv_fetch=lambda page, n: fetch()(page, n)
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
        # Host view of ``active``, updated at handoff, release, eviction
        # and each fetched step's flags. The pipelined loop decides
        # against this view instead of waiting on the step in flight: a
        # stale True costs one step that exits at once. Fetches only
        # DEACTIVATE, and only while the slot's ownership generation
        # still matches the one recorded at dispatch — a slot freed and
        # re-admitted while a step was in flight bumps it, so the old
        # step's "this row finished" flag never truncates the newcomer.
        self._active_np = np.zeros((B,), bool)
        self._slot_gen = [0] * B
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
        self._slot_trace: list[str] = [""] * B
        self._slot_span: list[str] = [""] * B
        # Host submit time per queued req_id (the 'queued' span's wall).
        self._queued_t: dict[int, float] = {}
        # Per-request watchdog deadlines: req_id -> absolute monotonic
        # expiry, armed at submit. The absolute time survives a
        # transient-fault requeue: the watchdog bounds the request's total
        # wall. Entries clear when the request finally resolves.
        self._deadline_t: dict[int, float] = {}
        self._admission: _Admission | None = None
        self._seq_counter = 0
        self.capacity_tokens = n_pages * page_size
        self.queue: list[SchedRequest] = []
        self.results: list[SchedResult] = []
        # req_ids that already consumed their one transient-fault requeue.
        self._retried: set[int] = set()
        # Wall-clock telemetry: admission prefill (stalled vs overlapped)
        # vs decode; decode_time_s feeds the engine's per-row usage.
        self.stalled_prefill_s = 0.0
        self.overlapped_prefill_s = 0.0
        self.decode_time_s = 0.0
        # The pipelined loop's fetches: those that found their step's
        # copies landed, and those the depth bound made wait on them.
        self.fetch_counts = {"ready": 0, "depth_bound": 0}

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
        if req.deadline_s > 0:
            self._deadline_t[req.req_id] = time.monotonic() + req.deadline_s
        if obs_mod.config().enabled:
            self._queued_t[req.req_id] = time.monotonic()
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="queued",
                    tokens=len(req.prompt_ids),
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            for name in ("request", "queued"):
                obs_mod.emit(
                    obs_mod.SpanEvent(
                        name=name,
                        phase="begin",
                        req_id=req.req_id,
                        trace_id=req.trace_id,
                        span_id=req.span_id,
                    )
                )

    def _new_cache(self, S: int) -> dict:
        return init_cache(
            self.cfg, 1, S, device=self.device, dtype=self._dtype,
            kv_dtype=self.kv_dtype,
        )

    def _start_admission(self, slot: int, req: SchedRequest) -> bool:
        """Reserve pages and set up the chunked prefill for ``slot``;
        False if the pool is momentarily full (the request stays queued
        and retries after residents free pages). Any other failure —
        including an injected ``kv_alloc`` fault — propagates with the
        allocator state rolled back; ``_admit`` isolates it to this
        request."""
        injector.fire("kv_alloc", slot)
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
        obs_mod.emit(
            obs_mod.RequestEvent(
                req_id=req.req_id, state="admitted", slot=slot, tokens=S
            )
        )
        self._emit_admitted_spans(req, slot)
        return True

    def _extend_evicting(self, seq_id: int, n_tokens: int) -> None:
        """``allocator.extend`` that converts allocation pressure into
        prefix-cache LRU eviction before giving up."""
        if self.prefix_cache is None:
            self.allocator.extend(seq_id, n_tokens)
        else:
            self.prefix_cache.extend_evicting(seq_id, n_tokens)

    # -- tiered KV swaps ---------------------------------------------------

    def _fetch_page_kv(self, page: int, n_tokens: int):
        """Demotion fetch: copy one evicted block's KV off its pool page
        and hand the tier a lazy materializer. The page returns to the
        free list right after (and may be re-used by the very allocation
        that triggered the eviction), so the copy is taken now: a device
        gather into an independent tensor, then, on CUDA, a
        ``non_blocking`` device→host copy into a pinned arena slot with a
        CUDA event recorded behind it — no host sync on the drive loop.
        The materializer waits on that event only. The payload has the
        reference's layout ([L, 1, Hkv, n, D] per pool key)."""
        p = page + 1  # physical id: page 0 is trash
        gathered = {
            k: v[:, p, :, :n_tokens].unsqueeze(1).clone(
                memory_format=torch.contiguous_format
            )
            for k, v in self.pool.items()
        }
        if self._arena is None:
            return lambda: gathered
        payload = self._arena.payload(gathered)
        for k, v in gathered.items():
            payload[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def materialize() -> dict:
            done.synchronize()
            return payload

        return materialize

    def _promote_tier_blocks(
        self, slot: int, seq_id: int, ids, matched: int, tier_hits: list
    ) -> int:
        """Promote a contiguous run of lower-tier blocks into this
        admission's freshly reserved pages: the blocks' payloads copy
        host→device into ONE staging tensor (``non_blocking`` from the
        pinned demotion slots) and ONE pool scatter writes the run, all on
        the current stream — the stream the admission's prefill runs on,
        so its gather of the promoted pages queues behind the scatter.
        Each target page is swap-pinned around the scatter.

        A hit whose entry vanished since lookup (host LRU overflow, a
        quarantined disk read — the promotion "lost the race") stops the
        run; the remaining tokens fall back to plain prefill, which is
        always correct. Returns the promoted token count; the promoted
        blocks are re-inserted into the radix index so co-admitted
        requests share them immediately."""
        tiers = self.tiers
        ps = self.page_size
        consumed: list = []
        payloads: list[dict] = []
        t0 = time.monotonic()
        for hit in tier_hits:
            injector.fire("kv_swap", slot)
            ok, payload = tiers.materialize(hit)
            if not ok or payload is None:
                break  # lost the race: prefill recomputes from here
            consumed.append(hit)
            payloads.append(payload)
        if not consumed:
            return 0
        done = len(consumed) * ps
        table = self.allocator.table(seq_id)
        pages = [table[(matched + i * ps) // ps] for i in range(len(consumed))]
        phys = np.repeat(np.asarray(pages, np.int64) + 1, ps)[None, :]
        offs = np.tile(np.arange(ps, dtype=np.int64), len(consumed))[None, :]
        promo_kv = {}
        for k, first in payloads[0].items():
            shape = list(first.shape)
            shape[3] = done
            buf = torch.empty(shape, dtype=first.dtype, device=self.device)
            for i, p in enumerate(payloads):
                buf[:, :, :, i * ps : (i + 1) * ps].copy_(p[k], non_blocking=True)
            promo_kv[k] = buf
        pinned: list[int] = []
        try:
            for page in pages:
                self.allocator.swap_pin(page)
                pinned.append(page)
            write_tokens(
                self.pool,
                promo_kv["k"],
                promo_kv["v"],
                phys,
                offs,
                ks_new=promo_kv.get("ks"),
                vs_new=promo_kv.get("vs"),
            )
        finally:
            for page in pinned:
                self.allocator.swap_unpin(page)
        # Consume BEFORE the radix re-insert: insert's cap enforcement may
        # LRU-evict tail blocks straight back into the host tier, and
        # consuming afterwards would pop those freshly re-demoted entries.
        per = (time.monotonic() - t0) / len(consumed)
        for hit in consumed:
            tiers.consume(hit, slot=slot, wall_s=per)
        self.prefix_cache.insert(
            list(ids[: matched + done]),
            table[: (matched + done) // ps],
        )
        return done

    def _start_admission_cached(self, slot: int, req: SchedRequest) -> bool:
        """Prefix-cache admission: adopt the longest cached prefix, promote
        the lower-tier blocks that continue it, and set up a
        CANONICAL-layout (pad 0, slot == logical position) prefill of only
        the remainder. The last prompt token always re-runs, even on a
        full-prefix hit: its logits seed sampling."""
        ids = req.prompt_ids
        S_real = len(ids)
        ps = self.page_size
        # record=False: a pool-full deferral retries this method every
        # iteration; stats count once, on success, with the adopted match.
        if self.tiers is not None:
            matched, pages, tier_hits = self.prefix_cache.lookup_tiered(
                ids, record=False
            )
        else:
            matched, pages = self.prefix_cache.lookup(ids, record=False)
            tier_hits = []
        limit = ((S_real - 1) // ps) * ps
        matched = min(matched, limit)
        pages = pages[: matched // ps]
        tier_hits = tier_hits[: (limit - matched) // ps]
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
            # Lower-tier blocks continuing the device match promote into
            # the pages the extend just reserved; a hit that lost the race
            # degrades to prefill (chaos seam: kv_swap).
            promoted = (
                self._promote_tier_blocks(slot, seq_id, ids, matched, tier_hits)
                if tier_hits
                else 0
            )
            total = matched + promoted
            cache = self._new_cache(S)
            if total:
                # Materialize the adopted + promoted prefix KV (and an int8
                # pool's scales: every pool key) into the dense admission
                # cache so the delta's attention sees it.
                table = (
                    np.asarray(self.allocator.table(seq_id)[: total // ps]) + 1
                )  # physical ids
                slots = np.arange(total)[None, :]
                gathered = read_tokens(self.pool, table[slots // ps], slots % ps)
                for k in cache:
                    cache[k][:, :, :, :total] = gathered[k]
            self._admission = _Admission(
                slot=slot,
                req=req,
                seq_id=seq_id,
                tokens=torch.as_tensor(tokens_np, device=self.device),
                pads=torch.zeros((1,), dtype=torch.int64, device=self.device),
                cache=cache,
                pos=total,
                S=S,
                canonical=True,
                S_real=S_real,
                matched=total,
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
        if self.tiers is not None:
            self.tiers.record_lookup(tier_hits)
        obs_mod.emit(
            obs_mod.RequestEvent(
                req_id=req.req_id,
                state="admitted",
                slot=slot,
                tokens=S_real,
                cached_tokens=total,
            )
        )
        self._emit_admitted_spans(req, slot)
        return True

    def _emit_admitted_spans(self, req: SchedRequest, slot: int) -> None:
        """Trace-span bookkeeping at admission start: the 'queued' span
        ends (wall = the measured queue wait) and the 'prefill' span
        opens."""
        if not obs_mod.config().enabled:
            return
        t0 = self._queued_t.pop(req.req_id, None)
        wait = (time.monotonic() - t0) if t0 is not None else 0.0
        obs_mod.emit(
            obs_mod.SpanEvent(
                name="queued",
                phase="end",
                req_id=req.req_id,
                slot=slot,
                wall_s=wait,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )
        obs_mod.emit(
            obs_mod.SpanEvent(
                name="prefill",
                phase="begin",
                req_id=req.req_id,
                slot=slot,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )

    def _advance_admission(self) -> None:
        """One STANDALONE prefill chunk of the in-flight admission — used
        when no resident row is decoding (nothing to ride with), for the
        final chunk, and by the legacy loop. Timed to its completion: a
        genuine stall."""
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
        if obs_mod.config().enabled:
            obs_mod.retrace.observe("prefill_chunk", ("prefill", chunk_len, adm.S))
            obs_mod.hot.prefill_chunk.observe(elapsed)
            obs_mod.emit(
                obs_mod.StepEvent(
                    kind="prefill",
                    n_live=int(sum(self._active_np)),
                    admission_slot=adm.slot,
                    prefill_tokens=chunk_len,
                )
            )
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=adm.req.req_id,
                    state="prefill",
                    slot=adm.slot,
                    tokens=chunk_len,
                )
            )
        if adm.pos >= adm.prefill_end:
            self._finish_admission()

    def _finish_admission(self) -> None:
        """Prefill done: scatter the dense cache into this sequence's pages
        (+1 shift: page 0 is trash), sample the first token and activate
        the slot. A host sync: the first token decides activation.

        ``self._admission`` stays set until the slot takes ownership of
        the sequence: the pool scatter and first-token sampling can fault,
        and ``_abort_admission`` needs the record to free its pages."""
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
                if obs_mod.config().enabled:
                    # The chunked-prefill site's program: every dispatch
                    # of it is observed.
                    obs_mod.retrace.observe("prefill_chunk", ("prefill", 1, adm.S))
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
        obs_mod.record_sync("admission_handoff")
        first_np = int(first)
        first_is_eos = bool(np.isin(first_np, self._eos_np))
        self.n_emitted[slot] = 1
        self.max_new[slot] = req.max_new_tokens
        row_active = (req.max_new_tokens > 1) and not first_is_eos
        self.active[slot] = row_active
        self._active_np[slot] = row_active
        self._slot_gen[slot] += 1  # new owner: expire in-flight flags
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
        self._slot_trace[slot] = req.trace_id
        self._slot_span[slot] = req.span_id
        self._slot_decode_s[slot] = 0.0
        self._slot_consumer[slot] = req.on_tokens
        self._slot_streamed[slot] = 0
        if req.on_tokens is not None:
            stream_mod.stats.record_request()
        elapsed = time.monotonic() - t0
        self._record_prefill_time(elapsed, overlapped=False)
        self._slot_prefill_s[slot] = adm.prefill_s + elapsed
        if obs_mod.config().enabled:
            obs_mod.hot.ttft.observe(self._slot_prefill_s[slot])
            obs_mod.hot.pool_util.set(self._pool_util())
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="decode",
                    slot=slot,
                    tokens=1,
                    cached_tokens=adm.matched,
                )
            )
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="prefill",
                    phase="end",
                    req_id=req.req_id,
                    slot=slot,
                    wall_s=self._slot_prefill_s[slot],
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="decode",
                    phase="begin",
                    req_id=req.req_id,
                    slot=slot,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            obs_mod.slo_check("ttft", req.span_id, self._slot_prefill_s[slot])
        # First-token stream delivery rides the handoff's read of it.
        if req.on_tokens is not None:
            first_arr = np.asarray([first_np])
            keep = self._deliver_stream(slot, 1, first_arr)
            if not keep and row_active:
                self._cancel_slot(slot, 1, first_arr)
                return
        if not row_active:
            self._finish_slot(slot)

    def _pool_util(self) -> float:
        return round(1.0 - self.allocator.free_pages / self.allocator.n_pages, 6)

    def _admit(self) -> None:
        """Fill free slots from the queue. Prompts with at most one
        ADMISSION_CHUNK of work left admit to completion immediately, so a
        burst fills the batch before the next decode step; the first
        longer prompt stays in flight and its chunks ride the residents'
        steps (one chunked admission at a time). A fault while admitting
        resolves only that request."""
        for slot in range(self.B):
            if self._admission is not None or not self.queue:
                return
            if self._slot_req[slot] is None and not self._active_np[slot]:
                req0 = self.queue[0]
                try:
                    with obs_mod.trace_scope(req0.trace_id, req0.span_id):
                        started = self._start_admission(slot, req0)
                except Exception as e:
                    # Faults that know their seam (an injected kv_swap
                    # mid-promotion) keep it; everything else faulted
                    # reserving pages.
                    self._fault_request(
                        self.queue.pop(0),
                        e,
                        getattr(e, "seam", "kv_alloc") or "kv_alloc",
                        slot=slot,
                    )
                    continue
                if not started:
                    return  # pool full: the request stays queued (FIFO)
                self.queue.pop(0)
                try:
                    with obs_mod.trace_scope(req0.trace_id, req0.span_id):
                        while (
                            self._admission is not None
                            and self._admission.slot == slot
                            and self._admission.remaining <= ADMISSION_CHUNK
                        ):
                            self._advance_admission()
                except Exception as e:
                    self._abort_admission(e)

    # -- fault containment -------------------------------------------------

    def _fault_request(
        self,
        req: SchedRequest,
        exc: BaseException,
        seam: str,
        tokens: np.ndarray | None = None,
        n: int = 0,
        cached_tokens: int = 0,
        prefill_time_s: float = 0.0,
        slot: int = -1,
        pages_freed: int = 0,
        spec_counts: tuple[int, int, int] = (0, 0, 0),
        decode_time_s: float = 0.0,
    ) -> None:
        """Resolve one faulted request: requeue once if the fault is
        transient and this req_id has not been retried yet, else finalize
        with the partial tokens and the fault's metadata. Every event here
        stamps the INJURED request's trace/span, and a final resolution
        dumps the flight recorder at once."""
        kind = faults.classify(exc)
        faults.record(kind, seam)
        requeued = kind.transient and req.req_id not in self._retried
        obs_mod.emit(
            obs_mod.FaultEvent(
                seam=seam,
                kind=kind.value,
                slot=slot,
                req_id=req.req_id,
                pages_freed=pages_freed,
                requeued=requeued,
                error=f"{type(exc).__name__}: {exc}",
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )
        if requeued:
            self._retried.add(req.req_id)
            self.queue.append(req)
            if obs_mod.config().enabled:
                self._queued_t[req.req_id] = time.monotonic()
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="queued",
                    tokens=len(req.prompt_ids),
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="queued",
                    phase="begin",
                    req_id=req.req_id,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            return
        # Final resolution: the watchdog stops tracking this request.
        self._deadline_t.pop(req.req_id, None)
        obs_mod.emit(
            obs_mod.RequestEvent(
                req_id=req.req_id,
                state="evicted",
                slot=slot,
                tokens=n,
                cached_tokens=cached_tokens,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )
        if obs_mod.config().enabled:
            obs_mod.hot.req_evicted.inc()
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="request",
                    phase="end",
                    req_id=req.req_id,
                    slot=slot,
                    wall_s=prefill_time_s + decode_time_s,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
        obs_mod.autodump("fault")
        self.results.append(
            SchedResult(
                req_id=req.req_id,
                tokens=(
                    tokens if tokens is not None else np.zeros((0,), np.int32)
                ),
                n_generated=n,
                error=f"{type(exc).__name__}: {exc}",
                fault_kind=kind.value,
                cached_tokens=cached_tokens,
                prefill_time_s=prefill_time_s,
                spec_steps=spec_counts[0],
                spec_drafted=spec_counts[1],
                spec_accepted=spec_counts[2],
                decode_time_s=decode_time_s,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )

    def _abort_admission(self, exc: BaseException) -> None:
        """The in-flight admission's prefill faulted: free its pages and
        resolve its request; resident rows are untouched. A fault that
        left the device unusable re-raises."""
        if context_lost(exc):
            raise exc
        adm = self._admission
        self._admission = None
        if adm is None:
            # The fault landed after the slot took ownership (tail of
            # _finish_admission): nothing to unwind here.
            raise exc
        free0 = self.allocator.free_pages
        self.allocator.free_sequence(adm.seq_id)
        if self._slot_req[adm.slot] is None:
            # A handoff that faulted part-way may have set the row's
            # device state: the slot has no owner, so it must not run.
            self.active[adm.slot] = False
            self._active_np[adm.slot] = False
            self.page_table[adm.slot] = 0
        if obs_mod.config().enabled:
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="prefill",
                    phase="end",
                    req_id=adm.req.req_id,
                    slot=adm.slot,
                    wall_s=adm.prefill_s,
                    trace_id=adm.req.trace_id,
                    span_id=adm.req.span_id,
                )
            )
        self._fault_request(
            adm.req,
            exc,
            "admission",
            cached_tokens=adm.matched,
            prefill_time_s=adm.prefill_s,
            slot=adm.slot,
            pages_freed=self.allocator.free_pages - free0,
        )

    def _handle_decode_fault(self, exc: BaseException) -> None:
        """A decode step faulted: evict ONE slot, keep the rest.

        The victim is the slot the fault names (injected faults carry
        one), else the occupied slot with the longest resident sequence
        (it owns the most pages). A fault that left the device unusable —
        a CUDA error other than out-of-memory, or device state that no
        longer reads back — re-raises: the engine drops the batcher and
        fails the group, and no step is launched on a dead context."""
        if context_lost(exc):
            raise exc
        try:
            cur_len_np = self.cur_len.cpu().numpy()
            self.out_buf[:, :1].cpu()  # probe the output buffer
        except Exception:
            raise exc from None
        slot = getattr(exc, "slot", None)
        if slot is None or not 0 <= slot < self.B or self._slot_req[slot] is None:
            occupied = [s for s in range(self.B) if self._slot_req[s] is not None]
            if not occupied:
                raise exc
            slot = max(occupied, key=lambda s: int(cur_len_np[s]))
        n = int(self.n_emitted[slot])
        partial = self.out_buf[slot, :n].cpu().numpy().astype(np.int32)
        # Faults that know their seam keep it (the watchdog's evictions
        # report at "watchdog"; injected scheduler_chunk faults already
        # carry that name).
        seam = getattr(exc, "seam", None) or "scheduler_chunk"
        self._evict_slot(slot, exc, seam, n, partial)

    def _evict_slot(
        self,
        slot: int,
        exc: BaseException,
        seam: str,
        n: int,
        partial: np.ndarray,
    ) -> None:
        """Shared slot-eviction surgery of both fault paths
        (``_handle_decode_fault``, ``_evict_spec_row``). Eviction only
        drops this slot's REFERENCES: pages shared with the prefix cache
        survive untouched; for a speculating row ``free_sequence`` drops
        its committed pages AND any draft pages. The partial transcript
        reaches the stream consumer before the slot frees."""
        req = self._slot_req[slot]
        st = self._slot_spec[slot]
        self._deliver_stream(slot, n, partial)
        pages_freed = self._release_slot(slot)
        interleave_mod.stats.record_sync()  # fault decision point
        obs_mod.record_sync("fault")
        if obs_mod.config().enabled:
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="decode",
                    phase="end",
                    req_id=req.req_id,
                    slot=slot,
                    wall_s=self._slot_decode_s[slot],
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
        self._fault_request(
            req,
            exc,
            seam,
            tokens=partial,
            n=n,
            cached_tokens=self._slot_cached[slot],
            prefill_time_s=self._slot_prefill_s[slot],
            slot=slot,
            pages_freed=pages_freed,
            spec_counts=(st[0], st[1], st[2]),
            decode_time_s=self._slot_decode_s[slot],
        )

    # -- slot release, streaming, completion -------------------------------

    def _release_slot(self, slot: int) -> int:
        """THE slot-release surgery, shared by completion, cancellation and
        fault eviction: drop the sequence's page references (pages shared
        with the prefix cache survive), clear ownership and streaming
        state, deactivate the row, zero its page-table row and bump the
        ownership generation, so any in-flight flags, counts or
        deliveries for the old owner expire. Returns the pages actually
        freed."""
        free0 = self.allocator.free_pages
        self.allocator.free_sequence(self._slot_seq[slot])
        self._slot_req[slot] = None
        self._slot_seq[slot] = None
        self._slot_consumer[slot] = None
        self._slot_streamed[slot] = 0
        self.active[slot] = False
        self._active_np[slot] = False
        self._slot_gen[slot] += 1
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
        self, emitted_np: np.ndarray, out_np: np.ndarray, live_slots
    ) -> None:
        """Stream one fetched step's tokens to every live consumer and
        cancel the rows whose consumers are done. ``live_slots`` are
        (slot, generation) pairs recorded at dispatch: a slot freed (and
        maybe re-admitted) since then is skipped."""
        for slot, gen in live_slots:
            if (
                gen != self._slot_gen[slot]
                or self._slot_req[slot] is None
                or self._slot_consumer[slot] is None
            ):
                continue
            n = int(emitted_np[slot])
            keep = self._deliver_stream(slot, n, out_np[slot])
            if not keep and self._active_np[slot]:
                self._cancel_slot(slot, n, out_np[slot, :n])

    def _cancel_slot(
        self, slot: int, n: int, tokens, reason: str = "early_converge"
    ) -> None:
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
        cached = self._slot_cached[slot]
        prefill_s = self._slot_prefill_s[slot]
        decode_s = self._slot_decode_s[slot]
        self._release_slot(slot)
        self._deadline_t.pop(req.req_id, None)
        stream_mod.stats.record_cancel(n, saved)
        self.results.append(
            SchedResult(
                req_id=req.req_id,
                tokens=np.asarray(tokens[:n], np.int32),
                n_generated=n,
                cancelled=True,
                tokens_saved=saved,
                cached_tokens=cached,
                prefill_time_s=prefill_s,
                spec_steps=st[0],
                spec_drafted=st[1],
                spec_accepted=st[2],
                decode_time_s=decode_s,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )
        if obs_mod.config().enabled:
            obs_mod.hot.cancel(reason).inc()
            obs_mod.hot.cancel_tokens_saved.observe(float(saved))
            if self.speculative and st[1]:
                obs_mod.hot.spec_acceptance.observe(st[2] / st[1])
            obs_mod.hot.pool_util.set(self._pool_util())
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="cancelled",
                    slot=slot,
                    tokens=n,
                    cached_tokens=cached,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            obs_mod.emit(
                obs_mod.CancelEvent(
                    req_id=req.req_id,
                    slot=slot,
                    reason=reason,
                    tokens_emitted=n,
                    tokens_saved=saved,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            for name, phase, wall in (
                ("decode", "end", decode_s),
                ("request", "cancelled", prefill_s + decode_s),
            ):
                obs_mod.emit(
                    obs_mod.SpanEvent(
                        name=name,
                        phase=phase,
                        req_id=req.req_id,
                        slot=slot,
                        wall_s=wall,
                        trace_id=req.trace_id,
                        span_id=req.span_id,
                    )
                )
            obs_mod.slo_check("round", req.span_id, prefill_s + decode_s)

    def _finish_slot(self, slot: int) -> None:
        """Slot completion: read the row's count and tokens (a host sync;
        the row is frozen), deliver the final tail to its consumer, and
        release the slot."""
        interleave_mod.stats.record_sync()
        obs_mod.record_sync("slot_complete")
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
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )
        if self.speculative and st[1] and obs_mod.config().enabled:
            obs_mod.hot.spec_acceptance.observe(st[2] / st[1])
        self._release_slot(slot)
        self._deadline_t.pop(req.req_id, None)
        if obs_mod.config().enabled:
            obs_mod.hot.req_finished.inc()
            obs_mod.hot.pool_util.set(self._pool_util())
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="finished",
                    slot=slot,
                    tokens=n,
                    cached_tokens=self._slot_cached[slot],
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            service_s = self._slot_prefill_s[slot] + self._slot_decode_s[slot]
            for name, wall in (
                ("decode", self._slot_decode_s[slot]),
                ("request", service_s),
            ):
                obs_mod.emit(
                    obs_mod.SpanEvent(
                        name=name,
                        phase="end",
                        req_id=req.req_id,
                        slot=slot,
                        wall_s=wall,
                        trace_id=req.trace_id,
                        span_id=req.span_id,
                    )
                )
            obs_mod.slo_check("round", req.span_id, service_s)

    def _collect(self, active_np: np.ndarray | None = None) -> None:
        """Resolve finished slots. The fused loop passes its host view of
        ``active`` (a row inactive after the last step is frozen); the
        legacy loop passes nothing and reads the device flags (its full
        sync, uncounted, as the reference's)."""
        if active_np is None:
            active_np = self.active.cpu().numpy()
        for slot in range(self.B):
            if self._slot_req[slot] is not None and not active_np[slot]:
                self._finish_slot(slot)

    # -- main loop ---------------------------------------------------------

    def run_all(self, timeout_s: float = 0.0) -> list[SchedResult]:
        """Drain the queue: admit, step, collect, repeat — the fused loop
        by default, the legacy serialized loop with ``interleave`` off.
        ``timeout_s`` > 0 is a best-effort wall-clock budget: on expiry
        resident rows finish with what they have emitted and queued
        requests return zero tokens. Every submitted ``req_id`` gets
        exactly one ``SchedResult``: a fault on one slot evicts that slot
        only (partial tokens + ``fault_kind``, one requeue first when
        transient) while co-resident rows keep decoding."""
        if self.interleave:
            self._drive_pipelined(timeout_s)
        else:
            self._drive_legacy(timeout_s)
        if self.tiers is not None:
            # Drain-end settle: flush queued disk write-through entries
            # and resolve lazy demotion payloads — host work (file I/O and
            # copies whose events have long fired).
            self.tiers.settle()
        out = sorted(self.results, key=lambda r: r.req_id)
        # Drain per-run state: a batcher kept alive across rounds must
        # not replay old results.
        self.results = []
        self._retried.clear()
        return out

    def _has_work(self) -> bool:
        return bool(
            self.queue
            or self._admission is not None
            or any(r is not None for r in self._slot_req)
        )

    def _expire_timeout(self) -> None:
        """Deadline hit: the in-flight admission unwinds (pages freed, its
        request reports with the queue), resident rows finish with what
        they have, queued requests resolve with zero tokens."""
        interleave_mod.stats.record_sync()
        obs_mod.record_sync("timeout")
        if self._admission is not None:
            adm = self._admission
            self._admission = None
            self.allocator.free_sequence(adm.seq_id)
            self.queue.insert(0, adm.req)
        self.active.zero_()
        self._active_np[:] = False
        self._collect(self._active_np)
        for req in self.queue:
            self.results.append(
                SchedResult(
                    req_id=req.req_id,
                    tokens=np.zeros((0,), np.int32),
                    n_generated=0,
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req.req_id,
                    state="timeout",
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
            if obs_mod.config().enabled:
                obs_mod.hot.req_timeout.inc()
                obs_mod.emit(
                    obs_mod.SpanEvent(
                        name="request",
                        phase="end",
                        req_id=req.req_id,
                        trace_id=req.trace_id,
                        span_id=req.span_id,
                    )
                )
        self.queue.clear()
        self._queued_t.clear()
        self._deadline_t.clear()
        obs_mod.autodump("timeout")

    def _watchdog_exc(self, req: SchedRequest, where: str) -> TimeoutError:
        exc = TimeoutError(
            "DEADLINE_EXCEEDED: per-request watchdog deadline "
            f"{req.deadline_s:g}s expired ({where}, req {req.req_id})"
        )
        exc.seam = "watchdog"
        # The request's budget is spent: no batcher-level requeue (it
        # would re-expire on arrival); a hedged re-admission is the debate
        # layer's decision.
        self._retried.add(req.req_id)
        return exc

    def _expire_request_deadlines(self) -> None:
        """Per-request watchdog (``SchedRequest.deadline_s``), called once
        per iteration in both drive loops: host clock math only (one dict
        check when no deadline is armed). An over-deadline RESIDENT row
        evicts through the decode-fault surgery, its partial tokens
        delivered to its stream consumer; an over-deadline in-flight
        ADMISSION aborts; an over-deadline QUEUED request resolves with
        zero tokens."""
        if not self._deadline_t:
            return
        now = time.monotonic()
        for slot in range(self.B):
            req = self._slot_req[slot]
            if req is None:
                continue
            dl = self._deadline_t.get(req.req_id)
            if dl is None or now <= dl:
                continue
            exc = self._watchdog_exc(req, "mid-decode")
            exc.slot = slot
            self._handle_decode_fault(exc)
        adm = self._admission
        if adm is not None:
            dl = self._deadline_t.get(adm.req.req_id)
            if dl is not None and now > dl:
                self._abort_admission(self._watchdog_exc(adm.req, "mid-prefill"))
        expired = [r for r in self.queue if self._deadline_t.get(r.req_id, now) < now]
        for req in expired:
            self.queue.remove(req)
            self._deadline_t.pop(req.req_id, None)
            self._fault_request(req, self._watchdog_exc(req, "queued"), "watchdog")

    # -- stepping ----------------------------------------------------------

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
        injector.fire("scheduler_chunk")
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
        if obs_mod.config().enabled:
            obs_mod.retrace.observe(
                "fused_prefill_decode_chunk",
                ("fused", chunk_len, adm.S, self.B, self.cap, self.chunk),
            )

    def _dispatch_decode(self) -> None:
        """One decode-only chunk."""
        injector.fire("scheduler_chunk")
        (
            self.cur_tok,
            self.cur_len,
            self.n_emitted,
            self.active,
        ) = _decode_chunk_impl(
            self.params, self.cfg, *self._decode_args(), **self._decode_kw()
        )
        interleave_mod.stats.record_step(fused=False)
        if obs_mod.config().enabled:
            obs_mod.retrace.observe(
                "scheduler_decode_chunk",
                ("decode", self.B, self.cap, self.chunk, self.greedy),
            )

    def _evict_spec_row(self, slot: int, exc: BaseException, seam: str) -> None:
        """A speculative step could not secure this row's next KV slot
        (genuine pool exhaustion after prefix-cache LRU eviction) or an
        injected ``kv_alloc`` fault fired mid-decode: evict ONLY this row
        while co-resident rows keep decoding."""
        n = int(self._cur_len_np[slot] - self._row_len_np[slot])
        partial = self.out_buf[slot, :n].cpu().numpy().astype(np.int32)
        self._evict_slot(slot, exc, seam, n, partial)

    def _prepare_spec_step(self, live: list[int]) -> torch.Tensor:
        """Size page coverage for ONE speculative step over ``live`` rows
        and return the per-row draft bound (the step's ``alloc_len``).

        - extend each row to ``cur_len + min(γ+1, budget left)`` KV slots
          through the prefix cache's LRU-evicting extend;
        - under genuine pressure fall back to ``cur_len + 1`` (the next
          mandatory write), degrading the row to a plain step; if even
          that page cannot be found, evict the row with a classified OOM
          (transient → one requeue) — ``live`` loses it;
        - the step receives ``covered_tokens - 1`` as its draft bound:
          the −1 reserves the slot the step's LAST emitted token needs
          next step, so the post-step fix-up never allocates.

        The page table is re-pushed from the allocator's host tables every
        step (rolled-back pages may have moved to another row).
        """
        span = self.gamma + 1
        alloc = np.zeros((self.B,), np.int64)
        for slot in list(live):
            seq = self._slot_seq[slot]
            cl = int(self._cur_len_np[slot])
            remaining = int(self._max_new_np[slot]) - (
                cl - int(self._row_len_np[slot])
            )
            length = self.allocator.length(seq)
            want = cl + min(span, max(remaining, 1))
            try:
                injector.fire("kv_alloc", slot)
                if want > length:
                    with obs_mod.trace_scope(
                        self._slot_trace[slot], self._slot_span[slot]
                    ):
                        self._extend_evicting(seq, want - length)
            except OutOfPages:
                try:
                    if cl + 1 > length:
                        with obs_mod.trace_scope(
                            self._slot_trace[slot], self._slot_span[slot]
                        ):
                            self._extend_evicting(seq, cl + 1 - length)
                except OutOfPages as e:
                    self._evict_spec_row(slot, e, "kv_alloc")
                    live.remove(slot)
                    continue
            except Exception as e:
                # Injected/bug fault at the alloc seam: isolate to this
                # row, co-residents keep decoding.
                self._evict_spec_row(slot, e, "kv_alloc")
                live.remove(slot)
                continue
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
        injector.fire("scheduler_chunk")
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
            if obs_mod.config().enabled:
                obs_mod.retrace.observe(
                    "fused_prefill_spec_chunk",
                    ("fused_spec", chunk_len, adm.S, self.gamma, self.B, self.cap),
                )
        else:
            outs = _spec_chunk_impl(self.params, self.cfg, *args, **kw)
            interleave_mod.stats.record_step(fused=False)
            if obs_mod.config().enabled:
                obs_mod.retrace.observe(
                    "scheduler_spec_chunk",
                    ("spec", self.gamma, self.B, self.cap, self.greedy),
                )
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

    def _apply_spec_counts(self, counts_np: np.ndarray, live_slots) -> None:
        """Apply one spec step's per-row counts to the host state: advance
        the cur_len/active views, ROLL BACK draft pages past each row's
        accepted prefix (``PageAllocator.truncate``), record telemetry
        (``perf.spec``: one step per live row, as the reference counts).
        ``live_slots`` are (slot, generation) pairs recorded at dispatch:
        rows whose owner changed since (evicted, or freed and
        re-admitted) are skipped."""
        for slot, gen in live_slots:
            if gen != self._slot_gen[slot] or self._slot_seq[slot] is None:
                continue
            n_allowed, n_acc = int(counts_np[0, slot]), int(counts_np[1, slot])
            n_emit = int(counts_np[2, slot])
            new_cl = int(counts_np[4, slot])
            seq = self._slot_seq[slot]
            length = self.allocator.length(seq)
            released = 0
            if new_cl > length:
                # Fully accepted span: a pure length bump within the pages
                # already held (the draft bound's −1 reserve).
                self.allocator.extend(seq, new_cl - length)
            else:
                released = len(self.allocator.truncate(seq, new_cl))
            self._cur_len_np[slot] = new_cl
            st = self._slot_spec[slot]
            st[0] += 1
            st[1] += n_allowed
            st[2] += n_acc
            spec_mod.stats.record_step(n_allowed, n_acc, n_emit)
            if released:
                spec_mod.stats.record_rollback(released)
            if obs_mod.config().enabled:
                obs_mod.hot.spec_tokens_per_step.observe(float(n_emit))
                obs_mod.emit(
                    obs_mod.SpecEvent(
                        slot=slot,
                        req_id=self._slot_req[slot].req_id,
                        drafted=n_allowed,
                        accepted=n_acc,
                        emitted=n_emit,
                        rolled_back_pages=released,
                        trace_id=self._slot_trace[slot],
                        span_id=self._slot_span[slot],
                    )
                )
            self._active_np[slot] = bool(counts_np[3, slot])

    def _record_step_wall(
        self, dt: float, live: list[int], fused_share: float, adm, width: int,
        emitted: int, kind: str, sync_reason: str, chunk_len: int = 0,
        depth: int = 1,
    ) -> None:
        """Attribute one step's wall: the riding admission's token share to
        its prefill (overlapped), the rest to decode, split evenly over
        the rows live at dispatch; the spec path's draft/verify split;
        the step's flight-recorder event (``depth``: the steps in flight
        after this dispatch)."""
        dec_dt = dt
        if fused_share > 0.0:
            p = dt * fused_share
            self._record_prefill_time(p, overlapped=True)
            adm.prefill_s += p
            dec_dt = dt - p
        self.decode_time_s += dec_dt
        for s in live:
            self._slot_decode_s[s] += dec_dt / len(live)
        if self.speculative:
            # Draft/verify wall split by position share (the reference's
            # SpecStats convention).
            span = self.gamma + 1
            spec_mod.stats.record_wall(
                dec_dt / (span + 1), dec_dt * span / (span + 1)
            )
        if obs_mod.config().enabled:
            obs_mod.hot.step_wall.observe(dt)
            if live:
                obs_mod.hot.inter_token.observe(
                    dt * len(live) / max(emitted, 1)
                    if self.speculative
                    else dt / self.chunk
                )
            riding = fused_share > 0.0
            obs_mod.emit(
                obs_mod.StepEvent(
                    kind=kind,
                    n_live=len(live),
                    admission_slot=adm.slot if riding else -1,
                    prefill_tokens=chunk_len if riding else 0,
                    decode_chunk=width,
                    pipeline_depth=depth,
                    sync_reason=sync_reason,
                    span_id=adm.req.span_id if riding else "",
                    trace_id=adm.req.trace_id if riding else "",
                )
            )

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` as of now in stream order: on CUDA a
        ``non_blocking`` copy into pinned memory (complete once an event
        recorded after it has), on the CPU a clone. Later in-place writes
        to ``t`` never reach it."""
        if self.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _step_entry(self, live: list[int], streaming: bool) -> _StepEntry:
        """The in-flight record of the decode step just dispatched: its
        flags (and, when a consumer streams, its emitted counts and an
        out_buf snapshot) copied to the host at once, behind one event."""
        active = self._host_copy(self.active)
        n_emitted = self._host_copy(self.n_emitted) if streaming else None
        out_buf = self._host_copy(self.out_buf) if streaming else None
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return _StepEntry(
            done,
            active,
            n_emitted,
            out_buf,
            tuple((s, self._slot_gen[s]) for s in live),
        )

    @staticmethod
    def _entry_ready(entry: _StepEntry) -> bool:
        """True when a step's host copies have already landed — fetching
        them is then free (no stall). On the CPU every copy is done when
        taken."""
        return entry.done is None or entry.done.query()

    def _fetch_entry(self, entry: _StepEntry) -> None:
        """Apply one completed step's flags to the trailing host view.
        Fetches only DEACTIVATE, and only rows whose slot still belongs
        to the request that was live at dispatch (generation match): a
        slot freed and re-admitted mid-flight must not have the old
        row's completion flag truncate its new owner. With streaming
        armed, the step's emitted counts and out_buf snapshot ride the
        same fetch. Waits on the entry's event first: a pinned buffer
        read before its copy has landed holds garbage."""
        if entry.done is not None:
            entry.done.synchronize()
        act = entry.active.numpy()
        for s, gen in entry.live:
            if gen == self._slot_gen[s] and not act[s]:
                self._active_np[s] = False
        if entry.n_emitted is None:
            return
        self._stream_entry(entry.n_emitted.numpy(), entry.out_buf.numpy(), entry.live)

    def _drive_pipelined(self, timeout_s: float) -> None:
        """Admit → dispatch (fused when an admission and live rows
        coexist) → fetch the step before last → collect; the host's own
        work (queue admission, radix lookups, page allocation,
        collection) overlaps the step in flight. A fault at dispatch or
        at a fetch evicts one slot (``_handle_decode_fault``)."""
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        inflight: deque[_StepEntry] = deque()
        while self._has_work():
            if deadline is not None and time.monotonic() > deadline:
                # The in-flight steps' flags are moot now.
                inflight.clear()
                self._expire_timeout()
                break
            # Per-request watchdog: evict over-deadline work before
            # admitting or dispatching more.
            self._expire_request_deadlines()
            self._admit()
            adm = self._admission
            live = [s for s in range(self.B) if self._active_np[s]]
            t0 = time.monotonic()
            fused_share = 0.0
            dispatched = False
            # Speculation: the host must learn each row's accepted length
            # before it can dispatch the next step (draft pages roll back,
            # coverage re-sizes), so the spec path runs one step deep with
            # a counts read per iteration instead of the double buffer.
            spec = self.speculative
            width = (self.gamma + 1) if spec else self.chunk
            spec_counts = None
            spec_slots: tuple = ()
            # Fuse only the LEADING prefill chunks: the FINAL chunk runs
            # standalone so the handoff happens before this iteration's
            # decode step and the newcomer joins it immediately.
            chunk_len = (
                self._fused_chunk_len(adm.remaining, len(live), width)
                if adm is not None and live
                else 0
            )
            ride = (
                adm is not None
                and bool(live)
                and not adm.fuse_deferred
                and chunk_len < adm.remaining
            )
            if spec and live and (ride or adm is None):
                alloc_len = self._prepare_spec_step(live)
            if ride:
                try:
                    # Fused dispatches run under the riding admission's
                    # trace scope (its retrace observations included).
                    with obs_mod.trace_scope(adm.req.trace_id, adm.req.span_id):
                        if spec:
                            spec_slots = tuple(
                                (s, self._slot_gen[s]) for s in live
                            )
                            spec_counts = self._dispatch_spec(
                                alloc_len, adm, chunk_len
                            )
                        else:
                            self._dispatch_fused(adm, chunk_len)
                    # The halves are not separately measurable without a
                    # profiler: split the wall by token share.
                    fused_share = chunk_len / (chunk_len + len(live) * width)
                    dispatched = True
                except Exception as e:
                    # Treated as decode-side surgery (older in-flight
                    # entries stay valid: they can only deactivate); the
                    # NEXT chunk runs standalone so a fault that
                    # originates in the prefill half aborts the admission
                    # there instead of evicting another resident every
                    # iteration.
                    adm.fuse_deferred = True
                    spec_counts = None
                    self._handle_decode_fault(e)
            else:
                if adm is not None:
                    # Final chunk, nothing live to ride, or the last fused
                    # step carrying this admission faulted: a standalone
                    # (stalled) chunk, which also performs the handoff.
                    try:
                        with obs_mod.trace_scope(
                            adm.req.trace_id, adm.req.span_id
                        ):
                            self._advance_admission()
                        adm.fuse_deferred = False
                    except Exception as e:
                        self._abort_admission(e)
                    live = [s for s in range(self.B) if self._active_np[s]]
                    if spec and live:
                        alloc_len = self._prepare_spec_step(live)
                    # The standalone chunk's seconds are already in the
                    # stalled-prefill bucket.
                    t0 = time.monotonic()
                if live:
                    try:
                        if spec:
                            spec_slots = tuple(
                                (s, self._slot_gen[s]) for s in live
                            )
                            spec_counts = self._dispatch_spec(alloc_len, None, 0)
                        else:
                            self._dispatch_decode()
                        dispatched = True
                    except Exception as e:
                        spec_counts = None
                        self._handle_decode_fault(e)
            if dispatched and spec:
                emitted = 0
                if spec_counts is not None:
                    counts_np = None
                    try:
                        # The spec path's one per-step sync: the host cannot
                        # size the next step's coverage or roll drafts back
                        # without the accept counts.
                        counts_np = spec_counts.cpu().numpy()
                    except Exception as e:
                        # A device fault that surfaces at the read: the
                        # same eviction surgery as at dispatch.
                        self._handle_decode_fault(e)
                    interleave_mod.stats.record_sync()
                    obs_mod.record_sync("spec_counts")
                    if counts_np is not None:
                        self._apply_spec_counts(counts_np, spec_slots)
                        emitted = int(
                            sum(int(counts_np[2, s]) for s, _ in spec_slots)
                        )
                        if self._stream_armed(s for s, _ in spec_slots):
                            # Stream delivery at the counts read: the step
                            # is complete, so its out_buf is read as is.
                            self._stream_entry(
                                self._cur_len_np - self._row_len_np,
                                self.out_buf.cpu().numpy(),
                                spec_slots,
                            )
                self._record_step_wall(
                    time.monotonic() - t0, live, fused_share, adm, width,
                    emitted, "fused_spec" if fused_share else "spec",
                    "spec_counts", chunk_len,
                )
            elif dispatched:
                inflight.append(self._step_entry(live, self._stream_armed(live)))
                depth = len(inflight)
                step_sync = ""
                try:
                    # Retire completed steps adaptively: an entry whose
                    # copies have landed applies now, so completions are
                    # seen with no lag whenever the device keeps up. Only
                    # the depth bound forces a blocking fetch — the double
                    # buffer's one sanctioned blocking point.
                    while inflight and (
                        len(inflight) >= self.pipeline_depth
                        or self._entry_ready(inflight[0])
                    ):
                        if self._entry_ready(inflight[0]):
                            self.fetch_counts["ready"] += 1
                        else:
                            obs_mod.record_sync("depth_fetch")
                            step_sync = "depth_fetch"
                            self.fetch_counts["depth_bound"] += 1
                        self._fetch_entry(inflight.popleft())
                except Exception as e:
                    # An async device fault surfaces at the fetch, one
                    # step late: the same eviction surgery as at dispatch.
                    inflight.clear()
                    self._handle_decode_fault(e)
                self._record_step_wall(
                    time.monotonic() - t0, live, fused_share, adm, width, 0,
                    "fused" if fused_share else "decode", step_sync,
                    chunk_len, depth,
                )
            self._collect(self._active_np)

    # -- legacy serialized loop -------------------------------------------

    def _drive_legacy(self, timeout_s: float) -> None:
        """The pre-fusion loop (``interleave`` off, the escape hatch): one
        standalone prompt-chunk dispatch, then one decode (or speculative)
        dispatch over the resident rows, each followed by its host sync,
        every iteration. Sync points are counted as the reference's
        legacy loop counts them."""
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        while self._has_work():
            if deadline is not None and time.monotonic() > deadline:
                self._expire_timeout()
                break
            self._expire_request_deadlines()
            self._admit()
            if self._admission is not None:
                # One prompt chunk, then fall through to a decode step —
                # resident rows keep emitting while the newcomer prefills.
                adm = self._admission
                try:
                    with obs_mod.trace_scope(adm.req.trace_id, adm.req.span_id):
                        self._advance_admission()
                except Exception as e:
                    self._abort_admission(e)
            if bool(self.active.any()):
                t_dec = time.monotonic()
                if self.speculative:
                    self._active_np[:] = self.active.cpu().numpy()
                    live = [s for s in range(self.B) if self._active_np[s]]
                    alloc_len = self._prepare_spec_step(live)
                    width = self.gamma + 1
                    emitted = 0
                    if live:
                        live_slots = tuple((s, self._slot_gen[s]) for s in live)
                        try:
                            counts = self._dispatch_spec(alloc_len, None, 0)
                            counts_np = counts.cpu().numpy()
                            self._apply_spec_counts(counts_np, live_slots)
                            emitted = int(sum(int(counts_np[2, s]) for s in live))
                            if self._stream_armed(live):
                                self._stream_entry(
                                    self._cur_len_np - self._row_len_np,
                                    self.out_buf.cpu().numpy(),
                                    live_slots,
                                )
                        except Exception as e:
                            self._handle_decode_fault(e)
                        finally:
                            self._record_step_wall(
                                time.monotonic() - t_dec, live, 0.0, None,
                                width, emitted, "spec", "legacy_step",
                            )
                            if obs_mod.config().enabled:
                                obs_mod.record_sync("legacy_step")
                else:
                    live = [
                        s for s in range(self.B) if self._slot_req[s] is not None
                    ]
                    try:
                        self._dispatch_decode()
                        _sync(self.device)
                    except Exception as e:
                        self._handle_decode_fault(e)
                    finally:
                        self._record_step_wall(
                            time.monotonic() - t_dec, live, 0.0, None,
                            self.chunk, 0, "decode", "legacy_step",
                        )
                        if obs_mod.config().enabled:
                            obs_mod.record_sync("legacy_step")
                    if self._stream_armed(live):
                        self._active_np[:] = self.active.cpu().numpy()
                        self._stream_entry(
                            self.n_emitted.cpu().numpy(),
                            self.out_buf.cpu().numpy(),
                            tuple((s, self._slot_gen[s]) for s in live),
                        )
            self._collect()
        self._active_np[:] = self.active.cpu().numpy()
