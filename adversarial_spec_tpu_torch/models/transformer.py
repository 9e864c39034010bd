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

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_mq,
    decode_attention_tp,
)
from adversarial_spec_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_dp_tp,
    paged_decode_attention_mq,
    paged_decode_attention_tp,
)
from adversarial_spec_tpu_torch.ops.quant import matmul
from adversarial_spec_tpu_torch.ops.rope import apply_rope, rope_angles
from adversarial_spec_tpu_torch.parallel.collectives import all_gather, all_reduce, exchange
from adversarial_spec_tpu_torch.parallel.mesh import DP, TP, device_ctx
from adversarial_spec_tpu_torch.parallel.sharding import (
    MeshParams,
    Sharded,
    cache_sharding,
    check_split,
    local,
    local_config,
    map_shards,
)

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
    place=None,
) -> Params:
    """Random init with truncated-normal fan-in scaling, made directly on
    ``device`` from a seeded generator (synthetic checkpoints and tests).

    ``place(path, node)``, when given, takes each layer's dict (path
    ``("layers", i)``) and each top-level leaf (path ``(name,)``) as soon
    as it is made, before the next is drawn, and its value stands in the
    node's place: a loader quantizes or shards there, so one layer's
    full leaves are held at a time. The draw order, and so the weights,
    do not depend on it.

    The draw is not the reference's (torch and jax generators differ);
    tests that compare the two packages bridge the reference's weights
    with ``engine/loader.py:params_from_jax`` instead.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if place is None:
        def place(path, node):
            return node

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(dtype)

    D, Fd = cfg.dim, cfg.ffn_dim
    QD = cfg.n_heads * cfg.head_dim
    KD = cfg.n_kv_heads * cfg.head_dim
    norm_init = torch.zeros if cfg.norm_scale_plus_one else torch.ones
    layers = []
    for i in range(cfg.n_layers):
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
        layers.append(place(("layers", i), lp))
    embed = dense((cfg.vocab_size, D), D)
    # [D, V] copy of the tied table: the head matmul then streams a
    # row-major weight like every other projection.
    head_t = (
        embed.t().contiguous() if cfg.tied_embeddings and transposed_head else None
    )
    params: Params = {
        "embed": place(("embed",), embed),
        "layers": layers,
        "final_norm": place(("final_norm",), norm_init(D, dtype=dtype, device=device)),
    }
    del embed
    if not cfg.tied_embeddings:
        params["lm_head"] = place(("lm_head",), dense((D, cfg.vocab_size), D))
    elif head_t is not None:
        params["lm_head_t"] = place(("lm_head_t",), head_t)
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
    mesh=None,
) -> Cache:
    """Zeroed dense cache ``{"k", "v"}: [L, B, Hkv, max_seq, D]``.

    ``kv_dtype="int8"``: K/V int8 plus f32 scales ``{"ks", "vs"}:
    [L, B, Hkv, max_seq, 1]`` (the reference's layout); the presence of
    ``"ks"`` marks a quantized cache. An unwritten slot's scale is 0, so
    it dequantizes to 0.

    On a ``mesh`` the cache is born sharded (rows over dp, heads over tp):
    a dict of ``Sharded``, each shard zeroed on its own device (this
    process's shards only, on a mesh across processes). A tp that
    does not divide the KV heads raises the reference's ``ValueError``
    ("implies that array axis 2 is partitioned ...").
    """
    if mesh is not None:
        dp, tp = mesh.shape[DP], mesh.shape[TP]
        check_split(
            (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim),
            cache_sharding(mesh), mesh,
        )
        lcfg = local_config(cfg, tp)
        grid = [
            [init_cache(lcfg, batch // dp, max_seq, device=mesh.device(d, t),
                        dtype=dtype, kv_dtype=kv_dtype) if mesh.is_local(d, t) else None
             for t in range(tp)]
            for d in range(dp)
        ]
        names = next(c for row in grid for c in row if c is not None)
        return {
            k: Sharded(mesh, cache_sharding(mesh),
                       [[None if c is None else c[k] for c in row] for row in grid])
            for k in names
        }
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


def _quantize_kv(x: torch.Tensor, eager: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the feature axis, bit-identical
    to the reference's compiled quantization: f32 amax, ``max(amax, 1e-8)
    * f32(1/127)``, round half to even, clip to ±127. Returns (int8, f32
    scale [..., 1]). ``eager``: the scale is a true division by 127, as in
    the one place the reference quantizes outside a compiled program (its
    sequence-parallel cache's reshard to the decode layout)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    amax = torch.clamp(amax, min=1e-8)
    scale = amax / 127.0 if eager else amax * _INV_127
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


def _o_proj(attn_out, lp, cfg: ModelConfig, B: int, S: int):
    """Attention output projection (a partial sum on a tp shard)."""
    return matmul(attn_out.reshape(B, S, cfg.n_heads * cfg.head_dim), lp["wo"])


def _residual(x, out, lp, cfg: ModelConfig, post_norm: str):
    """``x + out``, the sandwich post-norm applied to ``out`` first."""
    if cfg.post_norms:
        out = rms_norm(out, lp[post_norm], cfg.rms_eps, cfg.norm_scale_plus_one)
    return x + out


def _ffn(x, lp, cfg: ModelConfig):
    """The FFN block's output (a partial sum on a tp shard)."""
    h = rms_norm(x, lp["ffn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
    ff = _activation(matmul(h, lp["w_gate"]), cfg.activation) * matmul(
        h, lp["w_up"]
    )
    return matmul(ff, lp["w_down"])


def _attn_out_and_ffn(x, attn_out, lp, cfg: ModelConfig, B: int, S: int):
    """Output projection, residuals and the FFN block."""
    x = _residual(x, _o_proj(attn_out, lp, cfg, B, S), lp, cfg, "post_attn_norm")
    return _residual(x, _ffn(x, lp, cfg), lp, cfg, "post_ffn_norm")


def _layer_window_start(cfg: ModelConfig, layer_id: int, base_start, q_pos):
    """Per-layer valid-window start: a sliding window tightens it (on the
    windowed layers only, for alternating-pattern families)."""
    if cfg.sliding_window <= 0:
        return base_start
    if cfg.sliding_window_pattern > 1 and layer_id % cfg.sliding_window_pattern:
        return base_start
    return torch.maximum(base_start, q_pos - cfg.sliding_window + 1)


def _write_kv(pairs, cache_index, keep=None) -> None:
    """Store each ``(buf, val)`` of ``pairs`` — a chunk's K, V (or an int8
    cache's scales) ``val [B, S, Hkv, D|1]`` into a layer's cache slice
    ``buf [B, Hkv, T, D|1]`` — in place.

    Start slots clamp to ``[0, T - S]`` exactly as the reference's
    ``dynamic_update_slice`` does: a span that would run past the end of
    the buffer lands shifted back so it fits (rows at their budget in the
    speculative verify rely on this). A vector ``cache_index`` ([B])
    writes each row at its own slot: an advanced-index scatter. ``keep``
    ([B] bool, with a vector ``cache_index``): rows whose False leaves
    their slots as they were (a decode loop's step past its exit).
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
        val = val.to(buf.dtype)
        if keep is not None:
            val = torch.where(keep[:, None, None, None], val, buf[rows, :, slots])
        buf[rows, :, slots] = val


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = (x.to(torch.float32) * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _dense_prep(cfg: ModelConfig, positions, cache_index, kv_valid, T: int, kernels: bool):
    """What every layer of a dense forward shares: RoPE angles, and the
    kernels' per-row windows or the plain attention's masks."""
    B, S = positions.shape
    dev = positions.device
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    prep = {"cos": cos, "sin": sin, "cache_index": cache_index}
    ci = (
        cache_index.reshape(-1, 1)
        if isinstance(cache_index, torch.Tensor)
        else torch.full((1, 1), cache_index, device=dev)
    )  # [1|B, 1]
    q_pos = ci + torch.arange(S, device=dev)  # [1|B, S] slot of each query
    if kernels:
        # Per-row window [start, end) for the kernels; the sliding-window
        # start tightening happens per layer.
        prep["start"] = torch.argmax(kv_valid.to(torch.int32), dim=1).to(torch.int32)
        prep["q_pos"] = q_pos.expand(B, S).to(torch.int32)
        prep["ends"] = (prep["q_pos"] + 1).contiguous()
    else:
        slot_ids = torch.arange(T, device=dev)[None, None, :]
        causal = slot_ids <= q_pos[:, :, None]
        prep["base_mask"] = kv_valid[:, None, :] & causal  # [B, S, T]
        prep["window_mask"] = prep["base_mask"]
        if cfg.sliding_window > 0:
            prep["window_mask"] = prep["base_mask"] & (
                slot_ids > q_pos[:, :, None] - cfg.sliding_window
            )
    return prep


def _store_kv(cache: Cache, layer_id: int, k, v, cache_index, keep=None):
    """Write a chunk's K/V into layer ``layer_id`` of ``cache`` (quantized
    for an int8 cache; ``keep``: see ``_write_kv``); returns the layer's
    K, V and the kernels' scale kwargs."""
    k_l, v_l = cache["k"][layer_id], cache["v"][layer_id]
    if "ks" not in cache:
        _write_kv(((k_l, k), (v_l, v)), cache_index, keep)
        return k_l, v_l, {}
    ks_l, vs_l = cache["ks"][layer_id], cache["vs"][layer_id]
    kvq, kvs = _quantize_kv(torch.stack([k, v]))  # K and V in one pass
    _write_kv(
        ((k_l, kvq[0]), (v_l, kvq[1]), (ks_l, kvs[0]), (vs_l, kvs[1])),
        cache_index,
        keep,
    )
    return k_l, v_l, dict(k_scale=ks_l, v_scale=vs_l)


def _b1_bounds(cfg: ModelConfig, layer_id: int, prep) -> torch.Tensor:
    lo = _layer_window_start(cfg, layer_id, prep["start"], prep["q_pos"][:, 0])
    return torch.stack([lo, prep["ends"][:, 0]], dim=1)


def _dense_attention(cfg: ModelConfig, layer_id: int, q, k_l, v_l, skw, prep, dtype):
    """One layer's attention on one device: B1 for S=1 and B2 for short
    spans when the prep holds kernel windows, else the plain masked
    ``attention`` (an int8 layer dequantized to ``dtype``)."""
    S = q.shape[1]
    if "start" in prep and S == 1:
        return decode_attention(
            q[:, 0], k_l, v_l, _b1_bounds(cfg, layer_id, prep),
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
        )[:, None]
    if "start" in prep:
        starts = _layer_window_start(cfg, layer_id, prep["start"][:, None], prep["q_pos"])
        return decode_attention_mq(
            q, k_l, v_l, starts.to(torch.int32).contiguous(), prep["ends"],
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
        )
    windowed = cfg.sliding_window > 0 and not (
        cfg.sliding_window_pattern > 1 and layer_id % cfg.sliding_window_pattern
    )
    if skw:
        k_l = _dequantize_kv(k_l, skw["k_scale"], dtype)
        v_l = _dequantize_kv(v_l, skw["v_scale"], dtype)
    return attention(
        q, k_l, v_l, prep["window_mask"] if windowed else prep["base_mask"],
        attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale,
    )


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
    write_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """One forward pass over a chunk (prefill: S=chunk, decode: S=1, the
    speculative verify: S=γ+1). Returns logits [B, S|1, vocab] (f32).

    ``write_mask`` ([B] bool, with a ``[B]`` ``cache_index``): rows whose
    False write no K/V (a decode loop's step past the reference's exit).

    ``use_kernels`` routes short spans through the decode-attention
    wrappers (the reference's ``use_pallas_decode``); False keeps every
    chunk on the plain masked ``attention``.

    An int8 cache (``"ks"`` in it) stores each chunk's K/V quantized, as
    the reference's ``_write_and_read_kv`` does: the plain attention reads
    the layer dequantized to x's dtype (so the chunk attends to its own
    quantized K/V); the kernels get the raw int8 K/V and the scales.

    ``params`` on a mesh (``MeshParams``, with a cache of ``Sharded``
    tensors) runs the tp-sharded forward: see ``_forward_mesh``.
    """
    if isinstance(params, MeshParams):
        return _forward_mesh(
            params, cfg, tokens, positions, cache, cache_index, kv_valid,
            use_kernels=use_kernels, lm_head_last_only=lm_head_last_only,
            write_mask=write_mask,
        )
    B, S = tokens.shape
    if not isinstance(cache_index, torch.Tensor):
        cache_index = int(cache_index)
    kernels = use_kernels and S <= MQ_MAX_SPAN
    prep = _dense_prep(cfg, positions, cache_index, kv_valid, cache["k"].shape[3], kernels)
    x = _embed(params, cfg, tokens)
    for layer_id, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
        q, k, v = _project_qkv(lp, cfg, h, B, S, prep["cos"], prep["sin"])
        k_l, v_l, skw = _store_kv(cache, layer_id, k, v, cache_index, write_mask)
        out = _dense_attention(cfg, layer_id, q, k_l, v_l, skw, prep, x.dtype)
        x = _attn_out_and_ffn(x, out, lp, cfg, B, S)
    return _lm_head_logits(params, cfg, x, lm_head_last_only)


# -- the tp-sharded forwards ---------------------------------------------------


class _MeshRows:
    """Each dp slice's rows of the round's global tensors, on each shard's
    device (copied once per device: shards that share a device share
    them)."""

    def __init__(self, mesh, B: int):
        self.mesh = mesh
        self.r = B // mesh.shape[DP]
        self._memo: dict = {}

    def __call__(self, name: str, x, d: int, t: int):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        dev = self.mesh.device(d, t)
        key = (name, d, str(dev))
        if key not in self._memo:
            self._memo[key] = x[d * self.r : (d + 1) * self.r].to(dev)
        return self._memo[key]

    def per_device(self, key, d: int, t: int, make):
        """``make()``'s value once per (dp slice, device)."""
        k = (key, d, str(self.mesh.device(d, t)))
        if k not in self._memo:
            self._memo[k] = make()
        return self._memo[k]


def _shards(mesh):
    """The decode shards this process holds (every shard on one process)."""
    return mesh.local_shards()


def _grid(mesh, f):
    """``f(d, t)`` of every shard this process holds as a ``[dp][tp]`` grid
    (a wrapper's operand; None where another process holds the shard)."""
    return [[f(d, t) if mesh.is_local(d, t) else None for t in range(mesh.shape[TP])]
            for d in range(mesh.shape[DP])]


def _tp_groups(keys):
    """Shard keys (``(d, t)``, or ``(d, t, s)`` in the sp prefill) grouped
    by all but their tp rank ``t``, each group in tp order."""
    groups: dict = {}
    for k in sorted(keys):
        groups.setdefault((k[0],) + tuple(k[2:]), []).append(k)
    return list(groups.values())


def _reduce_residual(mesh, x, partial, layers, layer_id, cfg, post_norm):
    """All-reduce each tp group's partials and add them to x (in the
    grids ``x`` and ``partial``, keyed by shard; a group that spans
    processes takes the ``dist`` way)."""
    for group in _tp_groups(partial):
        k = group[0]
        span = mesh.tp_span(k[0], k[2] if len(k) > 2 else None)
        summed = all_reduce([partial[k] for k in group], span=span)
        for k, total in zip(group, summed):
            with device_ctx(mesh.device(*k)):
                x[k] = _residual(x[k], total, layers[k][layer_id], cfg, post_norm)


def _mesh_logits(params: MeshParams, cfg: ModelConfig, x, last_only: bool, s: int | None = None):
    """The head on each shard, each dp slice's vocab shards gathered, the
    slices' rows concatenated on the controller. A tied head without its
    transposed copy reads the replicated table: no gather. ``s``: the
    shards of sp rank ``s`` (``x`` keyed ``(d, t, s)``).

    Across processes every process computes the head on its own shards
    (at its decode rank, or at ``s``), a tp group that spans processes
    gathers its vocab shards over them, and each dp slice's rows go from
    the first process holding it to every other that decodes where this
    one does (``collectives.exchange``); the sp prefill's rows, from the
    last sp rank, go to every process, including one that holds no shard
    there. Every process ends with all the rows, so the round's state
    stays replicated."""
    mesh = params.mesh
    sp_rank = mesh.decode_rank if s is None else s
    sharded_head = "lm_head" in params.shard() or "lm_head_t" in params.shard()
    rows = {}
    for d in range(mesh.shape[DP]):
        tps = [t for t in range(mesh.shape[TP]) if mesh.is_local(d, t, sp_rank)]
        if not tps:
            continue
        parts = []
        for t in tps if sharded_head else tps[:1]:
            k = (d, t) if s is None else (d, t, s)
            with device_ctx(mesh.device(*k)):
                parts.append(_lm_head_logits(params.shard(*k), cfg, x[k], last_only))
        span = mesh.tp_span(d, sp_rank) if sharded_head else None
        rows[d] = all_gather(parts, dim=-1, span=span).to(mesh.controller)
    everyone = s is not None
    if mesh.multiprocess and not mesh.rows_everywhere(sp_rank, everyone):
        owners = [mesh.row_owner(d, sp_rank) for d in range(mesh.shape[DP])]
        span = mesh.members(owners, everyone)
        mine = [rows[d] for d in range(mesh.shape[DP]) if owners[d] == mesh.rank]
        x0 = next(iter(x.values()))
        like = torch.empty((x0.shape[0], 1 if last_only else x0.shape[1], cfg.vocab_size),
                           dtype=torch.float32, device=mesh.controller)
        # Owners rise with d (the mesh is laid out by rank): rank order is d order.
        rows = dict(enumerate(exchange(mine, span, like=like)))
    return torch.cat([rows[d] for d in range(mesh.shape[DP])], dim=0)


def _forward_mesh(
    params: MeshParams, cfg, tokens, positions, cache, cache_index, kv_valid,
    *, use_kernels: bool, lm_head_last_only: bool, write_mask=None,
):
    """``forward`` on a dp×tp mesh: the reference's GSPMD program, shard
    by shard.

    The round's tensors stay global on the controller; each dp slice's
    rows go to its shards. Every shard runs the single-device layer on
    its own widths (``local_config``: its KV heads with their query
    heads, its FFN columns) against its own cache shard; the row-parallel
    ``wo`` / ``w_down`` partials are all-reduced within each dp slice
    before the residual, and the vocab-sharded logits are all-gathered.
    The S=1 step runs W1 (``decode_attention_tp``); a verify span runs
    B2 on each shard (the reference runs plain XLA there: the port runs
    no plain version on the card); a prefill chunk the plain attention.
    """
    mesh = params.mesh
    lcfg = local_config(cfg, mesh.shape[TP])
    B, S = tokens.shape
    rows = _MeshRows(mesh, B)
    if not isinstance(cache_index, torch.Tensor):
        cache_index = int(cache_index)
    kernels = use_kernels and S <= MQ_MAX_SPAN
    T = cache["k"].shape[3]
    shards = _shards(mesh)
    layers = {(d, t): params.parts[d][t]["layers"] for d, t in shards}
    caches = {(d, t): local(cache, d, t) for d, t in shards}
    preps, x = {}, {}
    for d, t in shards:
        with device_ctx(mesh.device(d, t)):
            preps[d, t] = rows.per_device("prep", d, t, lambda: _dense_prep(
                cfg, rows("positions", positions, d, t),
                rows("cache_index", cache_index, d, t),
                rows("kv_valid", kv_valid, d, t), T, kernels,
            ))
            x[d, t] = rows.per_device("x", d, t, lambda: _embed(
                params.parts[d][t], cfg, rows("tokens", tokens, d, t)
            ))
    r = rows.r
    for layer_id in range(cfg.n_layers):
        q, kv = {}, {}
        for d, t in shards:
            with device_ctx(mesh.device(d, t)):
                lp, prep = layers[d, t][layer_id], preps[d, t]
                h = rms_norm(x[d, t], lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
                q[d, t], k, v = _project_qkv(lp, lcfg, h, r, S, prep["cos"], prep["sin"])
                kv[d, t] = _store_kv(caches[d, t], layer_id, k, v, prep["cache_index"],
                                     rows("write_mask", write_mask, d, t))
        if kernels and S == 1:
            grid = functools.partial(_grid, mesh)
            skw = {}
            if "ks" in cache:
                skw = {s: grid(lambda d, t, s=s: kv[d, t][2][s]) for s in ("k_scale", "v_scale")}
            outs = decode_attention_tp(
                grid(lambda d, t: q[d, t][:, 0]),
                grid(lambda d, t: kv[d, t][0]),
                grid(lambda d, t: kv[d, t][1]),
                grid(lambda d, t: _b1_bounds(cfg, layer_id, preps[d, t])),
                mesh, attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
            )
            out = {(d, t): outs[d][t][:, None] for d, t in shards}
        else:
            out = {}
            for d, t in shards:
                with device_ctx(mesh.device(d, t)):
                    out[d, t] = _dense_attention(
                        lcfg, layer_id, q[d, t], *kv[d, t], preps[d, t], x[d, t].dtype
                    )
        _mesh_block(mesh, lcfg, cfg, x, out, layers, layer_id, r, S)
    return _mesh_logits(params, cfg, x, lm_head_last_only)


def _mesh_block(mesh, lcfg, cfg, x, attn_out, layers, layer_id, r, S):
    """A layer's output projection, FFN and residuals on every shard, each
    partial all-reduced over its tp group (``x`` updated; shards keyed
    ``(d, t)``, or ``(d, t, s)`` in the sp prefill)."""
    partial = {}
    for k, out in attn_out.items():
        with device_ctx(mesh.device(*k)):
            partial[k] = _o_proj(out, layers[k][layer_id], lcfg, r, S)
    _reduce_residual(mesh, x, partial, layers, layer_id, cfg, "post_attn_norm")
    for k in attn_out:
        with device_ctx(mesh.device(*k)):
            partial[k] = _ffn(x[k], layers[k][layer_id], lcfg)
    _reduce_residual(mesh, x, partial, layers, layer_id, cfg, "post_ffn_norm")


def _paged_store(pool: Cache, layer_id: int, k, v, flat_page, flat_off):
    """Scatter a step's K/V ``[B, S, Hkv, D]`` into layer ``layer_id`` of
    the page pool (quantized for an int8 pool); returns the layer's page
    views and the kernels' scale kwargs.

    Advanced indices at dims 0 and 2, separated by the head slice, put the
    flattened (row, span) axis first: update [B·S, Hkv, D]. One scatter
    per layer; rejected-draft and inactive-row targets are the trash page,
    never read."""
    k_pages, v_pages = pool["k"][layer_id], pool["v"][layer_id]
    kf = k.reshape(-1, k.shape[2], k.shape[3])
    vf = v.reshape(-1, v.shape[2], v.shape[3])
    skw = {}
    if "ks" in pool:
        ks_pages, vs_pages = pool["ks"][layer_id], pool["vs"][layer_id]
        # K and V in one pass: [2, B·S, Hkv, D] and [2, B·S, Hkv, 1].
        (kf, vf), (ks, vs) = _quantize_kv(torch.stack([kf, vf]))
        ks_pages[flat_page, :, flat_off] = ks
        vs_pages[flat_page, :, flat_off] = vs
        skw = dict(k_scale=ks_pages, v_scale=vs_pages)
    k_pages[flat_page, :, flat_off] = kf.to(k_pages.dtype)
    v_pages[flat_page, :, flat_off] = vf.to(v_pages.dtype)
    return k_pages, v_pages, skw


def _paged_prep(cfg: ModelConfig, positions, page_table, bounds, q_pos, page_size, gather: bool):
    """What every layer of a paged step shares: RoPE angles, the windows,
    and for the gather path the page table's clamped ids and mapped mask."""
    B, S = positions.shape
    if q_pos.dim() <= 1:
        q_pos = q_pos.reshape(-1, 1).expand(B, S)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    prep = {"cos": cos, "sin": sin, "bounds": bounds.reshape(B, S, 2),
            "q_pos": q_pos, "table": page_table}
    if gather:
        # Gather reference path: page table → dense [B, Hkv, T, D] per
        # layer (the whole span reads it); <= 0 entries are unmapped.
        prep["safe_table"] = torch.clamp(page_table, min=0).long()
        prep["slot"] = torch.arange(page_table.shape[1] * page_size, device=positions.device)
        prep["mapped"] = torch.repeat_interleave(
            page_table > 0, page_size, dim=1
        )[:, None, :]
    return prep


def _paged_window(cfg: ModelConfig, layer_id: int, prep):
    start = _layer_window_start(cfg, layer_id, prep["bounds"][..., 0], prep["q_pos"])
    return start, prep["bounds"][..., 1]


def _paged_attention(cfg: ModelConfig, layer_id: int, q, k_pages, v_pages, skw, prep, dtype):
    """One layer's paged attention on one device: B3 for S=1 and B4 for a
    span when the pool is on the GPU, else the reference's gather path."""
    B, S = q.shape[:2]
    start, end = _paged_window(cfg, layer_id, prep)
    if "safe_table" not in prep and S == 1:
        layer_bounds = torch.stack([start[:, 0], end[:, 0]], dim=1)
        return paged_decode_attention(
            q[:, 0], k_pages, v_pages, prep["table"],
            layer_bounds.to(torch.int32).contiguous(),
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
        )[:, None]
    if "safe_table" not in prep:
        return paged_decode_attention_mq(
            q, k_pages, v_pages, prep["table"],
            start.to(torch.int32).contiguous(), end.to(torch.int32).contiguous(),
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
        )

    def to_dense(pages):  # [B, P, Hkv, page, X] → [B, Hkv, T, X]
        g = pages[prep["safe_table"]]
        return g.transpose(1, 2).reshape(B, cfg.n_kv_heads, -1, pages.shape[-1])

    k_dense, v_dense = to_dense(k_pages), to_dense(v_pages)
    if skw:
        k_dense = _dequantize_kv(k_dense, to_dense(skw["k_scale"]), dtype)
        v_dense = _dequantize_kv(v_dense, to_dense(skw["v_scale"]), dtype)
    mask = (
        prep["mapped"]
        & (prep["slot"] >= start[..., None])
        & (prep["slot"] < end[..., None])
    )  # [B, S, T]
    return attention(
        q, k_dense, v_dense, mask, attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale
    )


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

    ``params`` on a mesh (``MeshParams``, with a pool of ``Sharded``
    tensors) runs the tp-sharded step: see ``_forward_paged_mesh``.
    """
    if isinstance(params, MeshParams):
        return _forward_paged_mesh(
            params, cfg, tokens, positions, pool, page_table, write_page,
            write_off, bounds, q_pos,
        )
    B, S = tokens.shape
    prep = _paged_prep(cfg, positions, page_table, bounds, q_pos,
                       pool["k"].shape[3], gather=not pool["k"].is_cuda)
    flat_page = write_page.reshape(-1).long()
    flat_off = write_off.reshape(-1).long()
    x = _embed(params, cfg, tokens)
    for layer_id, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
        q, k, v = _project_qkv(lp, cfg, h, B, S, prep["cos"], prep["sin"])
        k_pages, v_pages, skw = _paged_store(pool, layer_id, k, v, flat_page, flat_off)
        out = _paged_attention(cfg, layer_id, q, k_pages, v_pages, skw, prep, x.dtype)
        x = _attn_out_and_ffn(x, out, lp, cfg, B, S)
    return _lm_head_logits(params, cfg, x, lm_head_last_only=False)


def _forward_paged_mesh(
    params: MeshParams, cfg, tokens, positions, pool, page_table, write_page,
    write_off, bounds, q_pos,
):
    """``forward_paged_decode`` on a tp-only or dp×tp mesh, shard by shard
    as ``_forward_mesh`` runs the dense step.

    tp-only: one global pool, its head axis split over tp; the table is
    replicated. dp×tp: the pool is laid out per dp slice (slice d owns
    global pages ``[d·Lp, (d+1)·Lp)``, its local page 0 its trash page)
    and the table carries global ids. Each shard writes its K/V at the
    local id (a write aimed outside its slice — the global trash page 0
    of an inactive row — lands on the slice's own trash page) and attends
    through W3 (tp-only) or W2 (dp×tp) for S=1, B4 with the rebased table
    for a span, and the gather path with the rebased table on the CPU.
    """
    mesh = params.mesh
    dp = mesh.shape[DP]
    lcfg = local_config(cfg, mesh.shape[TP])
    B, S = tokens.shape
    rows = _MeshRows(mesh, B)
    k0 = pool["k"].first
    page_size, local_pages, on_gpu = k0.shape[3], k0.shape[1], k0.is_cuda
    shards = _shards(mesh)
    layers = {(d, t): params.parts[d][t]["layers"] for d, t in shards}
    pools = {(d, t): local(pool, d, t) for d, t in shards}
    preps, x, writes = {}, {}, {}
    for d, t in shards:
        with device_ctx(mesh.device(d, t)):
            base = d * local_pages

            def make(d=d, t=t, base=base):
                table = rows("table", page_table, d, t)
                local_table = table - base if base else table
                prep = _paged_prep(
                    cfg, rows("positions", positions, d, t), local_table,
                    rows("bounds", bounds, d, t), rows("q_pos", q_pos, d, t),
                    page_size, gather=not on_gpu,
                )
                prep["global_table"] = table
                wp = rows("write_page", write_page, d, t).reshape(-1).long() - base
                prep["flat_page"] = torch.where((wp >= 0) & (wp < local_pages), wp, 0)
                prep["flat_off"] = rows("write_off", write_off, d, t).reshape(-1).long()
                return prep

            preps[d, t] = rows.per_device("prep", d, t, make)
            x[d, t] = rows.per_device("x", d, t, lambda: _embed(
                params.parts[d][t], cfg, rows("tokens", tokens, d, t)
            ))
    r = rows.r
    for layer_id in range(cfg.n_layers):
        q, kv = {}, {}
        for d, t in shards:
            with device_ctx(mesh.device(d, t)):
                lp, prep = layers[d, t][layer_id], preps[d, t]
                h = rms_norm(x[d, t], lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
                q[d, t], k, v = _project_qkv(lp, lcfg, h, r, S, prep["cos"], prep["sin"])
                kv[d, t] = _paged_store(
                    pools[d, t], layer_id, k, v, prep["flat_page"], prep["flat_off"]
                )
        if on_gpu and S == 1:
            grid = functools.partial(_grid, mesh)

            def layer_bounds(d, t):
                start, end = _paged_window(cfg, layer_id, preps[d, t])
                return torch.stack([start[:, 0], end[:, 0]], dim=1).to(torch.int32).contiguous()

            skw = {}
            if "ks" in pool:
                skw = {s: grid(lambda d, t, s=s: kv[d, t][2][s]) for s in ("k_scale", "v_scale")}
            wrapper = paged_decode_attention_dp_tp if dp > 1 else paged_decode_attention_tp
            outs = wrapper(
                grid(lambda d, t: q[d, t][:, 0]),
                grid(lambda d, t: kv[d, t][0]),
                grid(lambda d, t: kv[d, t][1]),
                grid(lambda d, t: preps[d, t]["global_table"]),
                grid(layer_bounds),
                mesh, attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale, **skw,
            )
            out = {(d, t): outs[d][t][:, None] for d, t in shards}
        else:
            out = {}
            for d, t in shards:
                with device_ctx(mesh.device(d, t)):
                    out[d, t] = _paged_attention(
                        lcfg, layer_id, q[d, t], *kv[d, t], preps[d, t], x[d, t].dtype
                    )
        _mesh_block(mesh, lcfg, cfg, x, out, layers, layer_id, r, S)
    return _mesh_logits(params, cfg, x, False)


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
    """Every tensor of the params, quantized dict leaves included; of
    ``MeshParams``, every distinct shard tensor once."""
    if isinstance(params, MeshParams):
        seen = set()
        for row in params.parts:
            for part in row:
                if part is None:  # another process's shard
                    continue
                for t in leaves(part):
                    if id(t) not in seen:
                        seen.add(id(t))
                        yield t
        return
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
    devices: ``map_params(lambda t: t.cpu(), params)``. Of ``MeshParams``,
    each distinct shard tensor is mapped once (shards that share one share
    the result)."""
    if isinstance(params, MeshParams):
        return map_shards(lambda t, _dev: fn(t), params)
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, list):
        return [map_params(fn, v) for v in params]
    return fn(params)


def count_params(params: Params) -> int:
    """Stored elements over all leaves (a quantized leaf counts its
    integer weight and its scales), as the reference counts them."""
    return sum(t.numel() for t in leaves(params))
