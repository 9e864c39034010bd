"""Decode attention over a PAGED KV pool: CUDA kernels + plain versions.

Counterpart of ``adversarial_spec_tpu/ops/pallas_paged.py``:

- ``paged_decode_attention`` (B3): one query token per row through the
  row's page table — the continuous batcher's S=1 decode step. Replaces
  the Pallas ``_paged_attn_kernel``.
- ``paged_decode_attention_mq`` (B4): a short span of S query positions
  per row, each under its own ``[start, end)`` window, one pass over the
  row's pages — the batcher's span-native speculative verify. Replaces
  the Pallas ``_paged_mq_attn_kernel``.

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
import math

import torch

from adversarial_spec_tpu_torch.ops import _build, split_kv
from adversarial_spec_tpu_torch.ops.decode_attention import (
    SOURCE,
    VERIFY_SOURCE,
    _check,
    _raise_on,
    scale_args,
    scales_pair,
    span_calls,
    span_strides,
    verify_plan,
)
from adversarial_spec_tpu_torch.ops.flash_common import flash_update

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


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _check_table(page_table: torch.Tensor, B: int) -> None:
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page table shape {tuple(page_table.shape)} vs B={B}")
    if page_table.stride(1) != 1:
        raise ValueError("page table entries must be contiguous")


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
    _check_table(page_table, B)
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
    _check_table(page_table, B)
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
