"""Decode attention over a PAGED KV pool: CUDA kernels + plain versions.

Counterpart of ``adversarial_spec_tpu/ops/pallas_paged.py``:

- ``paged_decode_attention`` (B3): one query token per row through the
  row's page table — the continuous batcher's S=1 decode step. Replaces
  the Pallas ``_paged_attn_kernel``.
- ``paged_decode_attention_mq`` (B4): a short span of S query positions
  per row, each under its own ``[start, end)`` window, one pass over the
  row's pages — the batcher's span-native speculative verify. Replaces
  the Pallas ``_paged_mq_attn_kernel``.
- ``paged_decode_attention_tp`` (W3) and ``paged_decode_attention_dp_tp``
  (W2): B3 on a mesh, the reference's ``shard_map`` wrappers of the same
  names. Every shard that one device holds is served by one launch of the
  sharded entry (``paged_decode_attention_sharded``: B3's body with a
  shard axis, each shard's page base subtracted where the kernel reads
  its table); ``mesh_launches`` counts those launches, ``mesh_shards``
  the shards they served.

Both take an int8 pool as the reference does (``kv_dtype="int8"``):
``k_scale``/``v_scale`` (both or neither) are the f32 scale pages
``[n_pages, Hkv, page, 1]`` beside int8 K/V pages, read through the same
page table and dequantized inside the kernel's tiles; such a call counts
under its own name (``paged_decode_attention_int8kv``,
``paged_decode_attention_mq_int8kv``).

Page-table sentinel convention (shared with the gather path of
``models/transformer.py:forward_paged_decode``): physical page 0 is the
reserved TRASH page and negative ids are padding, so any entry <= 0 is
unmapped and never contributes.

Each wrapper launches a hand-written Hopper kernel for CUDA tensors — B3
the paged slot policy of the split-KV kernel of ``csrc/decode_attention.cu``
(16 KB tiles aligned in slot space: part of a page, one page or several),
B4 the split-KV verify kernel of ``csrc/verify_attention.cu`` (one page per
tile, padded to a multiple of 16 slots), each with its combine pass; both
read the page ids on the card, never load a page with id <= 0 or a slot
outside the rows' windows, and take any page size — and counts each launch
in ``launches``; for CPU
tensors it runs the plain PyTorch version beside it (``*_plain``, the
``ops/flash_common.py`` update folded over the gathered pages), which the
tests and the chip smoke also use as the reference. A CUDA tensor never
takes the plain version: the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adversarial_spec_tpu_torch.ops import _build, split_kv
from adversarial_spec_tpu_torch.ops.decode_attention import (
    SOURCE,
    VERIFY_SOURCE,
    _check,
    _none,
    _raise_on,
    _strides_args,
    check_table,
    launch_sharded,
    scale_args,
    scales_pair,
    sharded_args,
    span_calls,
    span_strides,
    verify_plan,
)
from adversarial_spec_tpu_torch.ops.flash_common import flash_update
from adversarial_spec_tpu_torch.parallel.mesh import group_map

# Slots the plain versions gather per online-softmax update.
_PLAIN_BLOCK = 512

# Kernel launches per wrapper (the chip smoke zeroes and reads these to
# show the batcher really went through the kernels). Plain runs on CPU
# tensors never count.
launches = {
    "paged_decode_attention": 0,
    "paged_decode_attention_mq": 0,
    "paged_decode_attention_int8kv": 0,
    "paged_decode_attention_mq_int8kv": 0,
}

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


# W2's and W3's launches of the sharded entry and the shards they served,
# by K/V type as B3's are.
mesh_launches = {
    "paged_decode_attention_tp": 0,
    "paged_decode_attention_tp_int8kv": 0,
    "paged_decode_attention_dp_tp": 0,
    "paged_decode_attention_dp_tp_int8kv": 0,
}
mesh_shards = dict.fromkeys(mesh_launches, 0)


def reset_launches() -> None:
    for counts in (launches, mesh_launches, mesh_shards):
        for name in counts:
            counts[name] = 0


def _b3_entry():
    return _build.entry(
        SOURCE,
        "advspec_paged_decode_attention",
        [_P, _L, _L]  # q
        + [_P, _L, _L, _L] * 4  # k, v pages, k, v scale pages
        + [_P, _L]  # table
        + [_P, _L]  # bounds
        + [_P, _L, _L]  # out
        + [_P, _I]  # split workspace, n_split
        + [_I] * 7
        + [_F, _F, _P],
    )


def _w2_entry():
    return _build.entry(
        SOURCE,
        "advspec_paged_decode_attention_sharded",
        [ctypes.POINTER(_L), _I]  # shard table, shards
        + _strides_args()
        + [_L, _L]  # table and bounds row strides
        + [_P, _L, _L]  # out
        + [_P, _I]  # split workspace, n_split
        + [_I] * 7
        + [_F, _F, _P],
    )


def _b4_entry():
    return _build.entry(
        VERIFY_SOURCE,
        "advspec_paged_decode_attention_mq",
        [_P, _L, _L, _L]  # q
        + [_P, _L, _L, _L] * 4  # k, v pages, k, v scale pages
        + [_P, _L]  # table
        + [_P, _L, _L] * 2  # starts, ends
        + [_P, _L, _L, _L]  # out
        + [_P, _I]  # split workspace, n_split
        + [_I] * 8
        + [_F, _F, _P],
    )


# -- plain PyTorch versions ---------------------------------------------------


def paged_decode_attention_mq_plain(
    q: torch.Tensor,  # [B, S, Hq, D]
    k_pages: torch.Tensor,  # [n_pages, Hkv, page, D] float, or int8 + scales
    v_pages: torch.Tensor,  # [n_pages, Hkv, page, D]
    page_table: torch.Tensor,  # [B, P] int; <= 0 = unmapped
    starts: torch.Tensor,  # [B, S] or [B, 1] int
    ends: torch.Tensor,  # [B, S] or [B, 1] int
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [n_pages, Hkv, page, 1] f32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain B4: f32 online softmax over the row's gathered pages, per-row
    windows; unmapped pages are masked, and their K/V SELECTED to zero
    (never multiplied in), so a poisoned trash page cannot leak. An int8
    pool's pages dequantize as ``k.float() * ks`` (scale pages gathered
    beside them) before that select. Rows with an empty window give exact
    zeros. Returns [B, S, Hq, D]."""
    scales_pair(k_scale, v_scale)
    B, S, Hq, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    P = page_table.shape[1]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # [B, Hkv, S*g, D]: row r = query (r // g), group lane (r % g).
    qg = q.reshape(B, S, Hkv, g, D).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, Hkv, S * g, D).to(torch.float32) * scale
    rows = lambda x: (  # noqa: E731
        x.expand(B, S).repeat_interleave(g, dim=1).reshape(B, 1, S * g, 1)
    )
    lo, hi = rows(starts), rows(ends)
    m = torch.full((B, Hkv, S * g, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, S * g, 1), device=q.device)
    acc = torch.zeros((B, Hkv, S * g, D), device=q.device)
    per = max(1, _PLAIN_BLOCK // page)
    for p0 in range(0, P, per):
        ids = page_table[:, p0 : p0 + per]  # [B, n]
        n = ids.shape[1]
        mapped = (ids > 0).repeat_interleave(page, dim=1)  # [B, n*page]
        safe = torch.clamp(ids, min=0).long()

        def dense(pages):  # [n_pages, Hkv, page, X] → [B, Hkv, n*page, X]
            x = pages[safe].permute(0, 2, 1, 3, 4)
            return x.reshape(B, Hkv, n * page, pages.shape[-1])

        def gather(pages, scales):  # → f32, dequantized, unmapped slots = 0
            x = dense(pages).to(torch.float32)
            if scales is not None:
                x = x * dense(scales)
            return torch.where(mapped[:, None, :, None], x, 0.0)

        m, l, acc = flash_update(
            qg,
            gather(k_pages, k_scale),
            gather(v_pages, v_scale),
            p0 * page,
            lo,
            hi,
            m,
            l,
            acc,
            attn_softcap=attn_softcap,
            valid=mapped[:, None, None, :],
        )
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    out = out.reshape(B, Hkv, S, g, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, Hq, D)


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    bounds: torch.Tensor,  # [B, 2] (start, end)
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain B3 (the S=1 case of the plain B4). Returns [B, Hq, D]."""
    return paged_decode_attention_mq_plain(
        q[:, None],
        k_pages,
        v_pages,
        page_table,
        bounds[:, 0:1],
        bounds[:, 1:2],
        attn_softcap=attn_softcap,
        scale=scale,
        k_scale=k_scale,
        v_scale=v_scale,
    )[:, 0]


# -- kernel wrappers ----------------------------------------------------------


def _kernel_name(name: str, k_scale) -> str:
    return name + ("_int8kv" if k_scale is not None else "")


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D] one query token per row
    k_pages: torch.Tensor,  # [n_pages, Hkv, page, D] heads-major pages
    v_pages: torch.Tensor,  # [n_pages, Hkv, page, D]
    page_table: torch.Tensor,  # [B, P] int32; <= 0 = unmapped (0 = trash)
    bounds: torch.Tensor,  # [B, 2] int32 (start, end) token window
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [n_pages, Hkv, page, 1] f32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """B3: fused paged decode attention. Returns [B, Hq, D] in q.dtype."""
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, bounds,
            attn_softcap=attn_softcap, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    bounds = bounds.contiguous()
    out, ws, args = decode_args(
        q, k_pages, v_pages, page_table, bounds, attn_softcap, scale, k_scale, v_scale
    )
    rc = _b3_entry()(*args, torch.cuda.current_stream(q.device).cuda_stream)
    del ws  # the partials live until the launch is queued
    name = _kernel_name("paged_decode_attention", k_scale)
    _raise_on(rc, name)
    launches[name] += 1
    return out


def decode_args(
    q, k_pages, v_pages, page_table, bounds, attn_softcap, scale, k_scale, v_scale
) -> tuple[torch.Tensor, torch.Tensor | None, list]:
    """B3's output, partials workspace and C arguments (all but the
    stream), from shapes, strides and pointers alone: nothing here reads a
    device tensor (the bounds and the page table included)."""
    code = _check(
        q, k_pages, v_pages, page_table, bounds, k_scale=k_scale, v_scale=v_scale
    )
    B, Hq, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    check_table(page_table, B)
    if bounds.shape != (B, 2) or bounds.stride(1) != 1:
        raise ValueError(f"bounds must be a contiguous ({B}, 2), got {tuple(bounds.shape)}")
    P, g = page_table.shape[1], Hq // Hkv
    n_split = split_kv.decode_splits(B, Hkv, g, P * page, D, k_pages.element_size())
    ws = split_kv.workspace(n_split, B, Hkv, g, D, q.device)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    return out, ws, [
        q.data_ptr(), q.stride(0), q.stride(1),
        k_pages.data_ptr(), k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.data_ptr(), v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        *scale_args(k_scale, v_scale),
        page_table.data_ptr(), page_table.stride(0),
        bounds.data_ptr(), bounds.stride(0),
        out.data_ptr(), out.stride(0), out.stride(1),
        None if ws is None else ws.data_ptr(), n_split,
        B, Hq, Hkv, P, page, D, code,
        float(scale if scale is not None else 1.0 / math.sqrt(D)),
        float(attn_softcap),
    ]


def paged_decode_attention_mq(
    q: torch.Tensor,  # [B, S, Hq, D] a short query span (spec verify)
    k_pages: torch.Tensor,  # [n_pages, Hkv, page, D]
    v_pages: torch.Tensor,  # [n_pages, Hkv, page, D]
    page_table: torch.Tensor,  # [B, P] int32; <= 0 = unmapped
    starts: torch.Tensor,  # [B, S] or [B, 1] int32 first valid slot
    ends: torch.Tensor,  # [B, S] or [B, 1] int32 one past the last
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [n_pages, Hkv, page, 1] f32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """B4: multi-position paged decode attention. Returns [B, S, Hq, D]."""
    if not q.is_cuda:
        return paged_decode_attention_mq_plain(
            q, k_pages, v_pages, page_table, starts, ends,
            attn_softcap=attn_softcap, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    out, ws, calls = mq_args(
        q, k_pages, v_pages, page_table, starts, ends, attn_softcap, scale,
        k_scale, v_scale,
    )
    entry, stream = _b4_entry(), torch.cuda.current_stream(q.device).cuda_stream
    name = _kernel_name("paged_decode_attention_mq", k_scale)
    for args in calls:
        _raise_on(entry(*args, stream), name)
        launches[name] += 1
    del ws  # the partials live until the launches are queued
    return out


def mq_args(
    q, k_pages, v_pages, page_table, starts, ends, attn_softcap, scale,
    k_scale, v_scale,
) -> tuple[torch.Tensor, torch.Tensor | None, list]:
    """B4's output, partials workspace and one C argument list (all but
    the stream) per run of span positions, from shapes, strides and
    pointers alone: nothing here reads a device tensor (the page table
    included)."""
    code = _check(
        q, k_pages, v_pages, page_table, starts, ends,
        k_scale=k_scale, v_scale=v_scale,
    )
    B, S, Hq, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    check_table(page_table, B)
    span_strides(starts, ends, B, S)
    P = page_table.shape[1]
    runs, n_split, ws = verify_plan(q, k_pages, P, page)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    middle = [
        k_pages.data_ptr(), k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.data_ptr(), v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        *scale_args(k_scale, v_scale),
        page_table.data_ptr(), page_table.stride(0),
    ]
    tail = [
        Hq, Hkv, P, page, D, code,
        float(scale if scale is not None else 1.0 / math.sqrt(D)),
        float(attn_softcap),
    ]
    return out, ws, span_calls(q, starts, ends, out, runs, middle, tail, ws, n_split)


# -- W2 / W3: B3 on a mesh ------------------------------------------------------


def page_bases(shards, k_pages, rebase: bool) -> list[int]:
    """Each shard's page base: ``d·Lp`` (slice d's first global page id,
    ``Lp`` its pool's pages) when the table holds global ids of a
    per-dp-slice pool (W2), else 0 (W3's replicated table)."""
    return [d * k.shape[0] if rebase else 0 for (d, _), k in zip(shards, k_pages)]


def _plain_shards(qs, ks, vs, tables, bounds, bases, attn_softcap, scale, k_scales,
                  v_scales, plan_shards=None):
    """B3's plain version on each shard's own operands, each table rebased
    on the host first (``tab - base``: the yardstick of the kernel's own
    rebase; the trash page and padding land <= 0 and stay masked;
    ``plan_shards`` is the kernel's, unused here)."""
    n = len(qs)
    return [
        paged_decode_attention_plain(q, k, v, tab - base if base else tab, b,
                                     attn_softcap=attn_softcap, scale=scale,
                                     k_scale=ksc, v_scale=vsc)
        for q, k, v, tab, b, base, ksc, vsc in zip(qs, ks, vs, tables, bounds, bases,
                                                    _none(k_scales, n), _none(v_scales, n))
    ]


def paged_decode_attention_sharded(
    qs, ks, vs, tables, bounds, bases, attn_softcap: float = 0.0,
    scale: float | None = None, k_scales=None, v_scales=None, plan_shards: int | None = None,
    *, counter: str,
) -> list[torch.Tensor]:
    """B3 over shards that one device holds: lists of each shard's ``q``
    ``[B, Hq, D]``, pool ``[n_pages, Hkv, page, D]`` (and int8 scale
    pages), table ``[B, P]``, bounds ``[B, 2]`` and page base, every shard
    with the same shapes and strides. One launch of the sharded entry for
    CUDA tensors (a launch per ``MAX_SHARDS``), counted under ``counter``
    (the mesh wrapper's name); B3's plain version on each shard for CPU
    ones. Returns each shard's ``[B, Hq, D]``. ``plan_shards``: see
    ``decode_attention.sharded_args``."""
    scales_pair(k_scales, v_scales)
    if not qs[0].is_cuda:
        return _plain_shards(qs, ks, vs, tables, bounds, bases, attn_softcap, scale,
                             k_scales, v_scales)
    bounds = [b.contiguous() for b in bounds]
    runs = sharded_args(qs, ks, vs, bounds, k_scales, v_scales, attn_softcap, scale,
                        tables=tables, bases=bases, plan_shards=plan_shards)
    return launch_sharded(_w2_entry(), runs, _kernel_name(counter, k_scales), qs[0].device,
                          (mesh_launches, mesh_shards))


def _paged_mesh(run, rebase: bool, q, k_pages, v_pages, page_table, bounds, mesh,
                attn_softcap, scale, k_scale, v_scale):
    """Shared body of W2/W3 and their plain versions: ``run`` (the sharded
    entry, or the plain shards) for each device group. ``rebase``: the
    table holds global ids of a per-dp-slice pool, which each shard's page
    base (``page_bases``) takes back to its slice. Splits are planned for
    every shard on the group's card (``Mesh.card_shards``)."""
    scales_pair(k_scale, v_scale)

    def group(shards, qs, ks, vs, tabs, bs, kss, vss):
        return run(qs, ks, vs, tabs, bs, page_bases(shards, ks, rebase), attn_softcap, scale,
                   kss, vss, plan_shards=mesh.card_shards(*shards[0]))

    return group_map(group, mesh, q, k_pages, v_pages, page_table, bounds, k_scale, v_scale)


def paged_decode_attention_tp(
    q,  # [1][tp] grid of [B, Hq/tp, D]
    k_pages,  # [1][tp] grid of [n_pages, Hkv/tp, page, D]
    v_pages,
    page_table,  # [1][tp] grid of the (replicated) [B, P] table
    bounds,  # [1][tp] grid of the (replicated) [B, 2] windows
    mesh,
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale=None,  # grids like k_pages, [..., 1] f32 (int8 pool)
    v_scale=None,
):
    """W3: fused paged decode attention with the head axis tp-sharded.
    Returns the grid of each shard's ``[B, Hq/tp, D]``.

    The reference's ``paged_decode_attention_tp``: one global pool whose
    KV-head axis is split over ``tp``; the page table and the bounds are
    replicated, so every shard reads the same pages, its own heads. The
    shards one device holds run as one sharded B3 launch (page base 0); a
    GQA group stays on its shard, so there is no collective in or around
    the kernel."""
    return _paged_mesh(
        functools.partial(paged_decode_attention_sharded, counter="paged_decode_attention_tp"),
        False, q, k_pages, v_pages, page_table, bounds, mesh, attn_softcap, scale, k_scale,
        v_scale,
    )


def paged_decode_attention_dp_tp(
    q,  # [dp][tp] grid of [B/dp, Hq/tp, D]
    k_pages,  # [dp][tp] grid of [Lp, Hkv/tp, page, D]: slice d's pages
    v_pages,
    page_table,  # [dp][tp] grid of [B/dp, P] GLOBAL ids (slice d's rows)
    bounds,  # [dp][tp] grid of [B/dp, 2]
    mesh,
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale=None,
    v_scale=None,
):
    """W2: fused paged decode attention on a mixed dp×tp mesh. Returns the
    grid of each shard's ``[B/dp, Hq/tp, D]``.

    The reference's ``paged_decode_attention_dp_tp``. Layout contract: the
    pool is laid out per dp slice — slice d owns global pages
    ``[d·Lp, (d+1)·Lp)``, its local page 0 is that slice's trash page, and
    every row's pages live in its own slice. The table carries global ids;
    each shard's base ``d·Lp`` is subtracted where the kernel reads an
    entry, so the trash page and padding land <= 0 and stay masked. The
    shards one device holds run as one sharded B3 launch."""
    return _paged_mesh(
        functools.partial(paged_decode_attention_sharded, counter="paged_decode_attention_dp_tp"),
        True, q, k_pages, v_pages, page_table, bounds, mesh, attn_softcap, scale, k_scale,
        v_scale,
    )


def paged_decode_attention_tp_plain(q, k_pages, v_pages, page_table, bounds, mesh,
                                    attn_softcap: float = 0.0, scale=None,
                                    k_scale=None, v_scale=None):
    """Plain W3: B3's plain version on each shard's own operands."""
    return _paged_mesh(_plain_shards, False, q, k_pages, v_pages, page_table, bounds, mesh,
                       attn_softcap, scale, k_scale, v_scale)


def paged_decode_attention_dp_tp_plain(q, k_pages, v_pages, page_table, bounds,
                                       mesh, attn_softcap: float = 0.0,
                                       scale=None, k_scale=None, v_scale=None):
    """Plain W2: the same per-shard split (and rebase) around B3's plain
    version."""
    return _paged_mesh(_plain_shards, True, q, k_pages, v_pages, page_table, bounds, mesh,
                       attn_softcap, scale, k_scale, v_scale)
