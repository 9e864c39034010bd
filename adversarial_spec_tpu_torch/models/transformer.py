"""Generic decoder-only transformer in PyTorch — plain functions on tensors.

Counterpart of ``adversarial_spec_tpu/models/transformer.py``. Parameters
keep the reference's names and matmul-friendly ``[in, out]`` layout, but
the layer-stacked pytree walked by ``lax.scan`` becomes a list of per-layer
dicts walked by a Python loop:

    {"embed": [V, D], "layers": [{"attn_norm", "wq", ...}, ...],
     "final_norm": [D], "lm_head": [D, V] | "lm_head_t": [D, V] (tied)}

The KV cache keeps the reference's heads-major ``[L, B, Hkv, T, D]``
layout (one tensor each for K and V): a layer's slice ``cache["k"][l]`` is
a view the decode-attention kernels read through its strides, with no
copy. Unlike the reference, ``forward`` updates the cache IN PLACE (the
reference returns a new functional cache; the port saves the copy).
``kv_dtype="int8"`` stores int8 K/V beside per-(token, head) f32 scales
``{"ks", "vs"}: [L, B, Hkv, T, 1]`` (the reference's int8 cache); every
path below writes and reads both layouts.

Attention routes like the reference's kernel path: S=1 steps through
``decode_attention`` (B1), short spans (1 < S <= 16, the speculative
verify) through ``decode_attention_mq`` (B2) — each a CUDA kernel on the
GPU, its plain version on the CPU — and prefill chunks through the plain
masked ``attention`` (plain XLA in the reference too).

``forward_paged_decode`` is the continuous batcher's step over the paged
pool ``[L, n_pages, Hkv, page, D]`` (int8 pages beside ``[..., 1]`` scale
pages for an int8 pool): the paged kernels B3 (S=1) and B4 (the verify
span) on the GPU, the reference's gather path on the CPU.

Every projection and the head go through ``ops/quant.py:matmul``: a
weight quantized at load (``{"q", "scale"}`` int8 or ``{"q4", "scale"}``
int4) runs the dequant-matmul kernels B5/B6 on the GPU (their plain
versions on the CPU), on both serving paths; a plain weight stays a plain
product.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_mq,
)
from adversarial_spec_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_mq,
)
from adversarial_spec_tpu_torch.ops.quant import matmul
from adversarial_spec_tpu_torch.ops.rope import apply_rope, rope_angles

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

# Longest query span routed through the multi-query kernel (reference:
# models/transformer.py pallas_mq gate).
MQ_MAX_SPAN = 16


def init_params(
    cfg: ModelConfig,
    *,
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    transposed_head: bool = True,
) -> Params:
    """Random init with truncated-normal fan-in scaling, made directly on
    ``device`` from a seeded generator (synthetic checkpoints and tests).

    The draw is not the reference's (torch and jax generators differ);
    tests that compare the two packages bridge the reference's weights
    with ``engine/loader.py:params_from_jax`` instead.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(dtype)

    D, Fd = cfg.dim, cfg.ffn_dim
    QD = cfg.n_heads * cfg.head_dim
    KD = cfg.n_kv_heads * cfg.head_dim
    norm_init = torch.zeros if cfg.norm_scale_plus_one else torch.ones
    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "attn_norm": norm_init(D, dtype=dtype, device=device),
            "wq": dense((D, QD), D),
            "wk": dense((D, KD), D),
            "wv": dense((D, KD), D),
            "wo": dense((QD, D), QD),
            "ffn_norm": norm_init(D, dtype=dtype, device=device),
            "w_gate": dense((D, Fd), D),
            "w_up": dense((D, Fd), D),
            "w_down": dense((Fd, D), Fd),
        }
        if cfg.qkv_bias:
            lp["bq"] = torch.zeros(QD, dtype=dtype, device=device)
            lp["bk"] = torch.zeros(KD, dtype=dtype, device=device)
            lp["bv"] = torch.zeros(KD, dtype=dtype, device=device)
        if cfg.post_norms:
            lp["post_attn_norm"] = norm_init(D, dtype=dtype, device=device)
            lp["post_ffn_norm"] = norm_init(D, dtype=dtype, device=device)
        layers.append(lp)
    params: Params = {
        "embed": dense((cfg.vocab_size, D), D),
        "layers": layers,
        "final_norm": norm_init(D, dtype=dtype, device=device),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size), D)
    elif transposed_head:
        # [D, V] copy of the tied table: the head matmul then streams a
        # row-major weight like every other projection.
        params["lm_head_t"] = params["embed"].t().contiguous()
    return params


KV_DTYPES = ("", "int8")


def check_kv_dtype(kv_dtype: str) -> bool:
    """True for an int8 cache, False for one in the model's dtype; raises
    on any other value."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not one of {KV_DTYPES}")
    return kv_dtype == "int8"


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    *,
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    kv_dtype: str = "",
) -> Cache:
    """Zeroed dense cache ``{"k", "v"}: [L, B, Hkv, max_seq, D]``.

    ``kv_dtype="int8"``: K/V int8 plus f32 scales ``{"ks", "vs"}:
    [L, B, Hkv, max_seq, 1]`` (the reference's layout); the presence of
    ``"ks"`` marks a quantized cache. An unwritten slot's scale is 0, so
    it dequantizes to 0.
    """
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    if check_kv_dtype(kv_dtype):
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# The reference writes ``max(amax, 1e-8) / 127.0``, but every path that
# fills a cache runs it compiled, and XLA rewrites a division by a constant
# into a product with the constant's f32 reciprocal: that product is what
# the reference's caches hold, so it is what the port computes. A Python
# scalar reaches an f32 op as f32(1/127), the same bits, with no copy to
# the device.
_INV_127 = 1.0 / 127.0


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the feature axis, bit-identical
    to the reference's compiled quantization: f32 amax, ``max(amax, 1e-8)
    * f32(1/127)``, round half to even, clip to ±127. Returns (int8, f32
    scale [..., 1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 cache read for the plain attention, in the activations'
    dtype, as the reference reads it: ``(q.float() * scale).to(dtype)``."""
    return (q.to(torch.float32) * scale).to(dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool
) -> torch.Tensor:
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    scale = weight.to(torch.float32)
    if plus_one:
        scale = scale + 1.0
    return (norm * scale).to(x.dtype)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, Hkv, T, D] heads-major (cache layout)
    v: torch.Tensor,  # [B, Hkv, T, D]
    mask: torch.Tensor,  # [B, S, T] bool — True = attend
    attn_softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked GQA attention, f32 softmax. Returns [B, S, Hq, D].

    Fully masked rows (left-pad query slots) give EXACT zeros, and the
    probabilities are cast to v's dtype before the PV product — both as
    the reference does (``scaled_dot_product_attention`` would give NaN
    for those rows, so it is not used here).
    """
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # [B, Hkv, g*S, D] query rows; logits f32 as the reference's
    # preferred_element_type=f32 (inputs exact in f32, f32 accumulation).
    qg = q.reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, Hkv, g * S, D)
    logits = torch.matmul(
        qg.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
    )
    logits = logits.reshape(B, Hkv, g, S, T) * scale
    if attn_softcap > 0.0:
        logits = _softcap(logits, attn_softcap)
    logits = logits.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m)
    probs = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(probs.to(v.dtype).reshape(B, Hkv, g * S, T), v)
    out = out.reshape(B, Hkv, g, S, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, Hq, D)


def _project_qkv(lp, cfg: ModelConfig, h, B: int, S: int, cos, sin):
    """QKV projection + bias + head reshape + RoPE."""
    q = matmul(h, lp["wq"])
    k = matmul(h, lp["wk"])
    v = matmul(h, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out_and_ffn(x, attn_out, lp, cfg: ModelConfig, B: int, S: int):
    """Output projection, residuals and the FFN block."""
    out = matmul(attn_out.reshape(B, S, cfg.n_heads * cfg.head_dim), lp["wo"])
    if cfg.post_norms:
        out = rms_norm(
            out, lp["post_attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one
        )
    x = x + out
    h = rms_norm(x, lp["ffn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
    ff = _activation(matmul(h, lp["w_gate"]), cfg.activation) * matmul(
        h, lp["w_up"]
    )
    ff = matmul(ff, lp["w_down"])
    if cfg.post_norms:
        ff = rms_norm(
            ff, lp["post_ffn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one
        )
    return x + ff


def _layer_window_start(cfg: ModelConfig, layer_id: int, base_start, q_pos):
    """Per-layer valid-window start: a sliding window tightens it (on the
    windowed layers only, for alternating-pattern families)."""
    if cfg.sliding_window <= 0:
        return base_start
    if cfg.sliding_window_pattern > 1 and layer_id % cfg.sliding_window_pattern:
        return base_start
    return torch.maximum(base_start, q_pos - cfg.sliding_window + 1)


def _write_kv(pairs, cache_index) -> None:
    """Store each ``(buf, val)`` of ``pairs`` — a chunk's K, V (or an int8
    cache's scales) ``val [B, S, Hkv, D|1]`` into a layer's cache slice
    ``buf [B, Hkv, T, D|1]`` — in place.

    Start slots clamp to ``[0, T - S]`` exactly as the reference's
    ``dynamic_update_slice`` does: a span that would run past the end of
    the buffer lands shifted back so it fits (rows at their budget in the
    speculative verify rely on this). A vector ``cache_index`` ([B])
    writes each row at its own slot: an advanced-index scatter.
    """
    buf0, val0 = pairs[0]
    S, T = val0.shape[1], buf0.shape[2]
    if isinstance(cache_index, int):
        i = min(max(cache_index, 0), T - S)
        for buf, val in pairs:
            buf[:, :, i : i + S] = val.transpose(1, 2).to(buf.dtype)
        return
    start = torch.clamp(cache_index, 0, T - S)
    slots = start[:, None] + torch.arange(S, device=buf0.device)  # [B, S]
    rows = torch.arange(buf0.shape[0], device=buf0.device)[:, None]
    # Advanced indices at dims 0 and 2 put (B, S) first: [B, S, Hkv, D].
    for buf, val in pairs:
        buf[rows, :, slots] = val.to(buf.dtype)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    positions: torch.Tensor,  # [B, S] rope positions
    cache: Cache,  # updated in place
    cache_index,  # int, or [B] int tensor: slot of this chunk's first token
    kv_valid: torch.Tensor,  # [B, T] bool: slots holding real tokens
    *,
    use_kernels: bool = True,
    lm_head_last_only: bool = False,
) -> torch.Tensor:
    """One forward pass over a chunk (prefill: S=chunk, decode: S=1, the
    speculative verify: S=γ+1). Returns logits [B, S|1, vocab] (f32).

    ``use_kernels`` routes short spans through the decode-attention
    wrappers (the reference's ``use_pallas_decode``); False keeps every
    chunk on the plain masked ``attention``.

    An int8 cache (``"ks"`` in it) stores each chunk's K/V quantized, as
    the reference's ``_write_and_read_kv`` does: the plain attention reads
    the layer dequantized to x's dtype (so the chunk attends to its own
    quantized K/V); the kernels get the raw int8 K/V and the scales.
    """
    B, S = tokens.shape
    T = cache["k"].shape[3]
    dev = tokens.device
    vector_index = isinstance(cache_index, torch.Tensor)
    if not vector_index:
        cache_index = int(cache_index)
    quant_kv = "ks" in cache
    kernel_b1 = use_kernels and S == 1
    kernel_b2 = use_kernels and 1 < S <= MQ_MAX_SPAN

    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = (x.to(torch.float32) * math.sqrt(cfg.dim)).to(x.dtype)
    cos, sin = rope_angles(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )

    ci = (
        cache_index.reshape(-1, 1)
        if vector_index
        else torch.full((1, 1), cache_index, device=dev)
    )  # [1|B, 1]
    q_pos = ci + torch.arange(S, device=dev)  # [1|B, S] slot of each query
    if kernel_b1 or kernel_b2:
        # Per-row window [start, end) for the kernels; the sliding-window
        # start tightening happens per layer.
        start = torch.argmax(kv_valid.to(torch.int32), dim=1).to(torch.int32)
        q_pos = q_pos.expand(B, S).to(torch.int32)
        ends = (q_pos + 1).contiguous()
    else:
        slot_ids = torch.arange(T, device=dev)[None, None, :]
        causal = slot_ids <= q_pos[:, :, None]
        base_mask = kv_valid[:, None, :] & causal  # [B, S, T]
        window_mask = base_mask
        if cfg.sliding_window > 0:
            window_mask = base_mask & (
                slot_ids > q_pos[:, :, None] - cfg.sliding_window
            )

    for layer_id, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
        q, k, v = _project_qkv(lp, cfg, h, B, S, cos, sin)
        k_l, v_l = cache["k"][layer_id], cache["v"][layer_id]
        skw = {}  # the int8 cache's scales, for the kernels
        if quant_kv:
            ks_l, vs_l = cache["ks"][layer_id], cache["vs"][layer_id]
            kvq, kvs = _quantize_kv(torch.stack([k, v]))  # K and V in one pass
            _write_kv(
                ((k_l, kvq[0]), (v_l, kvq[1]), (ks_l, kvs[0]), (vs_l, kvs[1])),
                cache_index,
            )
            skw = dict(k_scale=ks_l, v_scale=vs_l)
        else:
            _write_kv(((k_l, k), (v_l, v)), cache_index)
        if kernel_b1:
            lo = _layer_window_start(cfg, layer_id, start, q_pos[:, 0])
            bounds = torch.stack([lo, ends[:, 0]], dim=1)
            out = decode_attention(
                q[:, 0],
                k_l,
                v_l,
                bounds,
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
                **skw,
            )[:, None]
        elif kernel_b2:
            starts = _layer_window_start(cfg, layer_id, start[:, None], q_pos)
            out = decode_attention_mq(
                q,
                k_l,
                v_l,
                starts.to(torch.int32).contiguous(),
                ends,
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
                **skw,
            )
        else:
            windowed = cfg.sliding_window > 0 and not (
                cfg.sliding_window_pattern > 1
                and layer_id % cfg.sliding_window_pattern
            )
            if quant_kv:
                k_l = _dequantize_kv(k_l, ks_l, x.dtype)
                v_l = _dequantize_kv(v_l, vs_l, x.dtype)
            out = attention(
                q,
                k_l,
                v_l,
                window_mask if windowed else base_mask,
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
            )
        x = _attn_out_and_ffn(x, out, lp, cfg, B, S)
    return _lm_head_logits(params, cfg, x, lm_head_last_only)


def forward_paged_decode(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] — decode step (S=1) or verify span (γ+1)
    positions: torch.Tensor,  # [B, S] rope positions
    pool: Cache,  # {"k","v": [L, n_pages, Hkv, page, D]} (+"ks"/"vs"
    # [..., 1] f32 scale pages when the pool is int8), written in place
    page_table: torch.Tensor,  # [B, P] int32; <= 0 = unmapped (0 = trash)
    write_page: torch.Tensor,  # [B(, S)] physical page per token's KV
    write_off: torch.Tensor,  # [B(, S)] slot within that page
    bounds: torch.Tensor,  # [B(, S), 2] (start, end) valid-slot window
    q_pos: torch.Tensor,  # [B] or [B, S]: logical slot per token
) -> torch.Tensor:
    """One decode step (or one multi-position verify span) over the PAGED
    KV pool; returns logits [B, S, vocab] (f32).

    Counterpart of the reference's ``forward_paged_decode``. Token
    (b, j)'s K/V scatters to ``(write_page[b, j], write_off[b, j])`` of
    each layer's pool view — in place, where the reference returns a new
    pool — before attention, so in-span causality comes from the bounds
    alone: position j's window ends at its own slot. Attention reads
    through the page table: for a pool on the GPU, S=1 goes to the B3
    kernel and S>1 to the B4 kernel (``ops/paged_attention.py``); on the
    CPU it takes the reference's gather path — the page table densified
    once per row, then the plain masked ``attention`` — which is what
    the reference runs off the TPU, so the two packages agree there.

    An int8 pool (``"ks"`` in it) scatters quantized K/V and their scales;
    the kernels read the int8 pages and scale pages, the gather path
    densifies both and dequantizes to x's dtype, as the reference does.
    """
    B, S = tokens.shape
    page_size = pool["k"].shape[3]
    use_kernels = pool["k"].is_cuda
    quant_kv = "ks" in pool
    write_page = write_page.reshape(B, S)
    write_off = write_off.reshape(B, S)
    bounds = bounds.reshape(B, S, 2)
    if q_pos.dim() <= 1:
        q_pos = q_pos.reshape(-1, 1).expand(B, S)

    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = (x.to(torch.float32) * math.sqrt(cfg.dim)).to(x.dtype)
    cos, sin = rope_angles(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    flat_page = write_page.reshape(-1).long()
    flat_off = write_off.reshape(-1).long()
    if not use_kernels:
        # Gather reference path: page table → dense [B, Hkv, T, D] per
        # layer (the whole span reads it); <= 0 entries are unmapped.
        safe_table = torch.clamp(page_table, min=0).long()
        slot = torch.arange(page_table.shape[1] * page_size, device=x.device)
        mapped = torch.repeat_interleave(page_table > 0, page_size, dim=1)[:, None, :]

    for layer_id, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
        q, k, v = _project_qkv(lp, cfg, h, B, S, cos, sin)
        k_pages, v_pages = pool["k"][layer_id], pool["v"][layer_id]
        # Advanced indices at dims 0 and 2, separated by the head slice,
        # put the flattened (row, span) axis first: update [B·S, Hkv, D].
        # One scatter per layer; rejected-draft and inactive-row targets
        # are the trash page, never read.
        kf = k.reshape(B * S, cfg.n_kv_heads, cfg.head_dim)
        vf = v.reshape(B * S, cfg.n_kv_heads, cfg.head_dim)
        skw = {}  # the int8 pool's scale pages, for the kernels
        if quant_kv:
            ks_pages, vs_pages = pool["ks"][layer_id], pool["vs"][layer_id]
            # K and V in one pass: [2, B·S, Hkv, D] and [2, B·S, Hkv, 1].
            (kf, vf), (ks, vs) = _quantize_kv(torch.stack([kf, vf]))
            ks_pages[flat_page, :, flat_off] = ks
            vs_pages[flat_page, :, flat_off] = vs
            skw = dict(k_scale=ks_pages, v_scale=vs_pages)
        k_pages[flat_page, :, flat_off] = kf.to(k_pages.dtype)
        v_pages[flat_page, :, flat_off] = vf.to(v_pages.dtype)

        start = _layer_window_start(cfg, layer_id, bounds[..., 0], q_pos)
        end = bounds[..., 1]
        if use_kernels and S == 1:
            layer_bounds = torch.stack([start[:, 0], end[:, 0]], dim=1)
            out = paged_decode_attention(
                q[:, 0],
                k_pages,
                v_pages,
                page_table,
                layer_bounds.to(torch.int32).contiguous(),
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
                **skw,
            )[:, None]
        elif use_kernels:
            out = paged_decode_attention_mq(
                q,
                k_pages,
                v_pages,
                page_table,
                start.to(torch.int32).contiguous(),
                end.to(torch.int32).contiguous(),
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
                **skw,
            )
        else:

            def to_dense(pages):  # [B, P, Hkv, page, X] → [B, Hkv, T, X]
                g = pages[safe_table]
                return g.transpose(1, 2).reshape(
                    B, cfg.n_kv_heads, -1, pages.shape[-1]
                )

            k_dense, v_dense = to_dense(k_pages), to_dense(v_pages)
            if quant_kv:
                k_dense = _dequantize_kv(k_dense, to_dense(ks_pages), x.dtype)
                v_dense = _dequantize_kv(v_dense, to_dense(vs_pages), x.dtype)

            mask = (
                mapped
                & (slot >= start[..., None])
                & (slot < end[..., None])
            )  # [B, S, T]
            out = attention(
                q,
                k_dense,
                v_dense,
                mask,
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale,
            )
        x = _attn_out_and_ffn(x, out, lp, cfg, B, S)
    return _lm_head_logits(params, cfg, x, lm_head_last_only=False)


def _lm_head_logits(params: Params, cfg: ModelConfig, x, lm_head_last_only):
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
    if lm_head_last_only:
        # Prompt chunks only need the final position's logits.
        x = x[:, -1:]
    # f32 logits (the reference's preferred_element_type=f32), quantized
    # heads included.
    if cfg.tied_embeddings:
        if "lm_head_t" in params:
            logits = matmul(x, params["lm_head_t"], torch.float32)
        else:
            logits = matmul(x, params["embed"].t(), torch.float32)
    else:
        logits = matmul(x, params["lm_head"], torch.float32)
    if cfg.logit_softcap > 0.0:
        logits = _softcap(logits, cfg.logit_softcap)
    return logits


def leaves(params):
    """Every tensor of the params, quantized dict leaves included."""
    if isinstance(params, dict):
        for v in params.values():
            yield from leaves(v)
    elif isinstance(params, list):
        for v in params:
            yield from leaves(v)
    else:
        yield params


def map_params(fn, params):
    """The params with ``fn`` applied to every tensor (quantized dict
    leaves included), in the same structure — e.g. to move them between
    devices: ``map_params(lambda t: t.cpu(), params)``."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, list):
        return [map_params(fn, v) for v in params]
    return fn(params)


def count_params(params: Params) -> int:
    """Stored elements over all leaves (a quantized leaf counts its
    integer weight and its scales), as the reference counts them."""
    return sum(t.numel() for t in leaves(params))
