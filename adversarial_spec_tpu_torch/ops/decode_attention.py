"""Decode attention over a dense heads-major KV cache: CUDA kernel + plain.

Counterpart of ``adversarial_spec_tpu/ops/pallas_decode.py``:

- ``decode_attention`` (B1): one query token per row, every S=1 decode
  step. Replaces the Pallas ``_decode_attn_kernel``.
- ``decode_attention_mq`` (B2): a short span of S query positions per row
  (the speculative verify), each position with its own ``[start, end)``
  window. Replaces the Pallas ``_mq_attn_kernel``.

Both take an int8 cache as the reference does (``kv_dtype="int8"``):
``k_scale``/``v_scale`` (both or neither) are the per-(token, head) f32
scales ``[B, Hkv, T, 1]`` of int8 K/V, dequantized inside the kernel's
tiles (``float(k8) * ks``, the Pallas kernels' order); such a call counts
under its own name (``decode_attention_int8kv``,
``decode_attention_mq_int8kv``).

Each wrapper launches a hand-written Hopper kernel for CUDA tensors — B1
the split-KV CUDA-core kernel of ``csrc/decode_attention.cu``, B2 the
split-KV, tensor-core verify kernel of ``csrc/verify_attention.cu``, each
with its combine pass (``n_split`` from ``ops/split_kv.py``), built by
``ops/_build.py`` — and counts each launch in ``launches`` (a bf16 span
longer than the verify kernel's registers hold is cut into runs of
positions, one launch each); for CPU tensors it runs the plain PyTorch
version beside it (``*_plain``), which the tests and the chip smoke also
use as the reference. A CUDA tensor never takes the plain version: the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adversarial_spec_tpu_torch.ops import _build, split_kv
from adversarial_spec_tpu_torch.ops.flash_common import flash_update

SOURCE = "decode_attention.cu"  # B1 (and B3)
VERIFY_SOURCE = "verify_attention.cu"  # B2 (and B4)
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Cache block the plain versions fold per online-softmax update.
_PLAIN_BLOCK = 512

# Kernel launches per wrapper (the chip smoke zeroes and reads these to
# show the main path really went through the kernels). Plain runs on CPU
# tensors never count.
launches = {
    "decode_attention": 0,
    "decode_attention_mq": 0,
    "decode_attention_int8kv": 0,
    "decode_attention_mq_int8kv": 0,
}

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _b1_entry():
    return _build.entry(
        SOURCE,
        "advspec_decode_attention",
        [_P, _L, _L]
        + [_P, _L, _L, _L] * 4  # k, v, k scales, v scales
        + [_P, _L]  # bounds
        + [_P, _L, _L]  # out
        + [_P, _I]  # split workspace, n_split
        + [_I] * 6
        + [_F, _F, _P],
    )


def _b2_entry():
    return _build.entry(
        VERIFY_SOURCE,
        "advspec_decode_attention_mq",
        [_P, _L, _L, _L]
        + [_P, _L, _L, _L] * 4  # k, v, k scales, v scales
        + [_P, _L, _L] * 2  # starts, ends
        + [_P, _L, _L, _L]  # out
        + [_P, _I]  # split workspace, n_split
        + [_I] * 7
        + [_F, _F, _P],
    )


@functools.lru_cache(maxsize=None)
def f32_max_rows(D: int, kv_itemsize: int, page: int | None) -> int:
    """The most query rows per KV head one f32-q verify launch holds (B2
    when ``page`` is None, else B4 over ``page``-slot pages), as the
    kernel's own tile choice reports it (``advspec_verify_max_rows``)."""
    fn = _build.entry(VERIFY_SOURCE, "advspec_verify_max_rows", [_I] * 4)
    rows = fn(D, kv_itemsize, int(page is not None), page or 0)
    if rows < 0:
        raise ValueError(f"verify kernel takes no head_dim {D} / {kv_itemsize}-byte cache")
    return rows


def scales_pair(k_scale, v_scale) -> bool:
    """True for an int8 cache (both scales given), False for a float one;
    raises when only one is given."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    return k_scale is not None


# -- plain PyTorch versions ---------------------------------------------------


def decode_attention_mq_plain(
    q: torch.Tensor,  # [B, S, Hq, D]
    k_cache: torch.Tensor,  # [B, Hkv, T, D] float, or int8 with scales
    v_cache: torch.Tensor,  # [B, Hkv, T, D]
    starts: torch.Tensor,  # [B, S] or [B, 1] int
    ends: torch.Tensor,  # [B, S] or [B, 1] int
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [B, Hkv, T, 1] f32 (int8 cache)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain B2: f32 online softmax over cache blocks, per-row windows;
    rows with an empty window give exact zeros. An int8 block dequantizes
    as ``k.float() * ks`` before the update. Returns [B, S, Hq, D]."""
    scales_pair(k_scale, v_scale)
    B, S, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
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

    def block(x, x_scale, t0):  # → f32 [B, Hkv, block, D]
        xb = x[:, :, t0 : t0 + _PLAIN_BLOCK].to(torch.float32)
        if x_scale is None:
            return xb
        return xb * x_scale[:, :, t0 : t0 + _PLAIN_BLOCK]

    for t0 in range(0, T, _PLAIN_BLOCK):
        m, l, acc = flash_update(
            qg,
            block(k_cache, k_scale, t0),
            block(v_cache, v_scale, t0),
            t0,
            lo,
            hi,
            m,
            l,
            acc,
            attn_softcap=attn_softcap,
        )
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    out = out.reshape(B, Hkv, S, g, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, Hq, D)


def decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    bounds: torch.Tensor,  # [B, 2] (start, end)
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain B1 (the S=1 case of the plain B2). Returns [B, Hq, D]."""
    return decode_attention_mq_plain(
        q[:, None],
        k_cache,
        v_cache,
        bounds[:, 0:1],
        bounds[:, 1:2],
        attn_softcap=attn_softcap,
        scale=scale,
        k_scale=k_scale,
        v_scale=v_scale,
    )[:, 0]


# -- kernel wrappers ----------------------------------------------------------


def _check(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *ints,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> int:
    """Validate what the kernel takes; returns the dtype code. K/V are in
    q's dtype, or int8 beside f32 scales ``k.shape[:-1] + (1,)``."""
    quant = scales_pair(k_scale, v_scale)
    dev = q.device
    scales = (k_scale, v_scale) if quant else ()
    for t in (k, v, *scales, *ints):
        if t.device != dev:
            raise ValueError(
                f"decode attention operands on {t.device} and {dev}"
            )
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"decode attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if quant:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(
                f"scaled K/V must be int8, got {k.dtype}, {v.dtype}"
            )
        for s in scales:
            if s.dtype != torch.float32:
                raise TypeError(f"K/V scales must be float32, got {s.dtype}")
            if s.shape != k.shape[:-1] + (1,):
                raise ValueError(
                    f"scale shape {tuple(s.shape)} vs cache {tuple(k.shape)}"
                )
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}"
            + (" (an int8 cache needs k_scale and v_scale)"
               if k.dtype == torch.int8 else "")
        )
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {D} unsupported; kernel takes {SUPPORTED_HEAD_DIMS}"
        )
    if k.shape != v.shape or k.shape[-1] != D or k.dim() != 4:
        raise ValueError(f"bad cache shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-2] % k.shape[1] != 0:
        raise ValueError(f"{q.shape[-2]} query heads over {k.shape[1]} KV heads")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("head_dim axis must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"bounds must be int32, got {t.dtype}")
    return _DTYPE_CODE[q.dtype]


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def span_strides(starts, ends, B: int, S: int) -> list:
    """(row, position) strides of ``starts`` and ``ends``, each [B, S] or a
    [B, 1] broadcast (a zero position stride)."""
    strides = []
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dim() != 2 or t.shape[0] != B or t.shape[1] not in (1, S):
            raise ValueError(f"{name} shape {tuple(t.shape)} vs B={B}, S={S}")
        strides.append((t.stride(0), t.stride(1) if t.shape[1] == S else 0))
    return strides


def verify_plan(
    q, k_cache, n_tiles: int, page: int | None = None
) -> tuple[list[tuple[int, int]], int, torch.Tensor | None]:
    """B2/B4's runs of span positions (one launch each), n_split and
    partials workspace (sized for the longest run, reused by each launch in
    stream order), from shapes alone. ``page``: B4's slots per page. f32 q
    on the card takes its runs from the kernel's own row limit."""
    B, S, Hq, D = q.shape
    Hkv = k_cache.shape[1]
    g = Hq // Hkv
    max_rows = None
    if q.dtype == torch.float32 and q.is_cuda:
        max_rows = f32_max_rows(D, k_cache.element_size(), page)
    runs = split_kv.span_runs(S, g, D, q.dtype, max_rows)
    n_split = split_kv.plan_splits(B, Hkv, n_tiles)
    R = g * max(s1 - s0 for s0, s1 in runs)
    return runs, n_split, split_kv.workspace(n_split, B, Hkv, R, D, q.device)


def span_calls(q, starts, ends, out, runs, middle: list, tail: list, ws, n_split) -> list:
    """One C argument list (all but the stream) per run ``[s0, s1)`` of
    span positions: q, ``middle`` (the cache operands), the run's starts,
    ends and output slice, the workspace and ``n_split``, ``B`` and the
    run's length, then ``tail`` (the remaining sizes, dtype code, scale and
    softcap). Pointers and strides only: nothing here reads a device
    tensor."""
    B, S = q.shape[:2]
    calls = []
    for s0, s1 in runs:
        qr, orun = q[:, s0:s1], out[:, s0:s1]
        st, en = (t[:, s0:s1] if t.shape[1] == S else t for t in (starts, ends))
        strides = span_strides(st, en, B, s1 - s0)
        calls.append([
            qr.data_ptr(), qr.stride(0), qr.stride(1), qr.stride(2),
            *middle,
            st.data_ptr(), *strides[0],
            en.data_ptr(), *strides[1],
            orun.data_ptr(), orun.stride(0), orun.stride(1), orun.stride(2),
            None if ws is None else ws.data_ptr(), n_split,
            B, s1 - s0, *tail,
        ])
    return calls


def scale_args(k_scale, v_scale) -> list:
    """The C entry points' scale operands: pointer and (row or page, head,
    slot) strides of each, or nulls for a float cache."""
    if k_scale is None:
        return [None, 0, 0, 0] * 2
    return [
        x
        for s in (k_scale, v_scale)
        for x in (s.data_ptr(), s.stride(0), s.stride(1), s.stride(2))
    ]


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D] one query token per row
    k_cache: torch.Tensor,  # [B, Hkv, T, D] heads-major
    v_cache: torch.Tensor,  # [B, Hkv, T, D]
    bounds: torch.Tensor,  # [B, 2] int32 (start, end) valid-slot window
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [B, Hkv, T, 1] f32 (int8 cache)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """B1: fused decode attention. Returns [B, Hq, D] in q.dtype."""
    if not q.is_cuda:
        return decode_attention_plain(
            q, k_cache, v_cache, bounds, attn_softcap=attn_softcap,
            scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    bounds = bounds.contiguous()
    out, ws, args = decode_args(
        q, k_cache, v_cache, bounds, attn_softcap, scale, k_scale, v_scale
    )
    rc = _b1_entry()(*args, torch.cuda.current_stream(q.device).cuda_stream)
    del ws  # the partials live until the launch is queued
    name = "decode_attention" + ("_int8kv" if k_scale is not None else "")
    _raise_on(rc, name)
    launches[name] += 1
    return out


def decode_args(
    q, k_cache, v_cache, bounds, attn_softcap, scale, k_scale, v_scale
) -> tuple[torch.Tensor, torch.Tensor | None, list]:
    """B1's output, partials workspace and C arguments (all but the
    stream), from shapes, strides and pointers alone: nothing here reads a
    device tensor (the bounds included)."""
    code = _check(q, k_cache, v_cache, bounds, k_scale=k_scale, v_scale=v_scale)
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if bounds.shape != (B, 2) or bounds.stride(1) != 1:
        raise ValueError(f"bounds must be a contiguous ({B}, 2), got {tuple(bounds.shape)}")
    g = Hq // Hkv
    n_split = split_kv.decode_splits(B, Hkv, g, T, D, k_cache.element_size())
    ws = split_kv.workspace(n_split, B, Hkv, g, D, q.device)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    kc, vc = k_cache, v_cache
    return out, ws, [
        q.data_ptr(), q.stride(0), q.stride(1),
        kc.data_ptr(), kc.stride(0), kc.stride(1), kc.stride(2),
        vc.data_ptr(), vc.stride(0), vc.stride(1), vc.stride(2),
        *scale_args(k_scale, v_scale),
        bounds.data_ptr(), bounds.stride(0),
        out.data_ptr(), out.stride(0), out.stride(1),
        None if ws is None else ws.data_ptr(), n_split,
        B, Hq, Hkv, T, D, code,
        float(scale if scale is not None else 1.0 / math.sqrt(D)),
        float(attn_softcap),
    ]


def decode_attention_mq(
    q: torch.Tensor,  # [B, S, Hq, D] a short query span
    k_cache: torch.Tensor,  # [B, Hkv, T, D]
    v_cache: torch.Tensor,  # [B, Hkv, T, D]
    starts: torch.Tensor,  # [B, S] or [B, 1] int32 first valid slot
    ends: torch.Tensor,  # [B, S] or [B, 1] int32 one past the last
    attn_softcap: float = 0.0,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # [B, Hkv, T, 1] f32 (int8 cache)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """B2: multi-query fused decode attention. Returns [B, S, Hq, D]."""
    if not q.is_cuda:
        return decode_attention_mq_plain(
            q, k_cache, v_cache, starts, ends,
            attn_softcap=attn_softcap, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    out, ws, calls = mq_args(
        q, k_cache, v_cache, starts, ends, attn_softcap, scale, k_scale, v_scale
    )
    entry, stream = _b2_entry(), torch.cuda.current_stream(q.device).cuda_stream
    name = "decode_attention_mq" + ("_int8kv" if k_scale is not None else "")
    for args in calls:
        _raise_on(entry(*args, stream), name)
        launches[name] += 1
    del ws  # the partials live until the launches are queued
    return out


def mq_args(
    q, k_cache, v_cache, starts, ends, attn_softcap, scale, k_scale, v_scale
) -> tuple[torch.Tensor, torch.Tensor | None, list]:
    """B2's output, partials workspace and one C argument list (all but
    the stream) per run of span positions, from shapes, strides and
    pointers alone: nothing here reads a device tensor."""
    code = _check(
        q, k_cache, v_cache, starts, ends, k_scale=k_scale, v_scale=v_scale
    )
    B, S, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    span_strides(starts, ends, B, S)
    runs, n_split, ws = verify_plan(q, k_cache, -(-T // split_kv.DENSE_TILE))
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    kc, vc = k_cache, v_cache
    middle = [
        kc.data_ptr(), kc.stride(0), kc.stride(1), kc.stride(2),
        vc.data_ptr(), vc.stride(0), vc.stride(1), vc.stride(2),
        *scale_args(k_scale, v_scale),
    ]
    tail = [
        Hq, Hkv, T, D, code,
        float(scale if scale is not None else 1.0 / math.sqrt(D)),
        float(attn_softcap),
    ]
    return out, ws, span_calls(q, starts, ends, out, runs, middle, tail, ws, n_split)
