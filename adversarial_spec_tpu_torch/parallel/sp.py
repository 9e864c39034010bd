"""Sequence-parallel (long-context) prefill: the whole transformer forward
with the prompt's sequence split over ``sp``, composable with tensor
parallelism over ``tp`` and data parallelism over ``dp``.

Counterpart of ``adversarial_spec_tpu/parallel/sp.py``. BASELINE config 5
is a 16k-token PRD judged by a TP=8 70B model: at that shape prefill
needs both axes at once. On each dp slice's sp×tp devices:

- the slice's rows are split into ``sp`` contiguous blocks of the padded
  prompt; each sp rank embeds its block (positions offset by its start,
  less each row's pad), and projections and FFNs run on local blocks;
  attention is a K/V ring over the sp ranks (``parallel/ring.py``);
- each shard computes on the shard view of the config (heads and FFN
  columns divided by tp: ``sharding.local_config``), and the row-parallel
  products are all-reduced over tp (``collectives.all_reduce``), through
  the mesh forward's own layer tail (``models/transformer.py``
  ``_mesh_block``);
- the last-position logits come from the last sp block, gathered over tp.

The reference replicates the prompt over dp and lets each dp replica
compute every row; the port gives each dp slice its own rows (the same
rows the decode layout gives it), so a row's result is the same and a dp
slice prefills only its rows. The cache comes back with its sequence
split over sp (``cache_sharding(mesh, prefill=True)``), and
``reshard_cache_for_decode`` gathers it into the decode layout (rows over
dp, heads over tp, replicated over sp).

Across processes an sp group may span several: each process steps the
``(dp, tp)`` groups it holds at any sp rank, in grid order (the same on
every process), the ring's hops between processes are send/receive pairs,
the last sp rank's logits reach every process, and the reshard gathers
each group's blocks over its processes onto each one's decode rank.

Sliding windows (Gemma-2's alternating layers included) are applied per
layer inside the ring. Constraints, the reference's: the padded length
must split sp ways; tp must divide n_heads, n_kv_heads, ffn_dim and the
vocab; the rows must split dp ways (``generate`` pads them).
"""

from __future__ import annotations

import torch

from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.models.transformer import (
    _embed,
    _mesh_block,
    _mesh_logits,
    _project_qkv,
    _quantize_kv,
    rms_norm,
)
from adversarial_spec_tpu_torch.ops.rope import rope_angles
from adversarial_spec_tpu_torch.parallel.collectives import all_gather, exchange
from adversarial_spec_tpu_torch.parallel.mesh import DP, SP, TP, Mesh, device_ctx
from adversarial_spec_tpu_torch.parallel.ring import ring_attention_local
from adversarial_spec_tpu_torch.parallel.sharding import (
    MeshParams,
    Sharded,
    cache_sharding,
    local_config,
)

# Calls of ``sp_prefill`` and ``reshard_cache_for_decode``.
counts = {"prefills": 0, "reshards": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _layer_window(cfg: ModelConfig, layer_id: int) -> int:
    """The layer's sliding window (0 = global): Gemma-2's windowed layers
    are every ``sliding_window_pattern``-th, from layer 0."""
    if cfg.sliding_window > 0 and cfg.sliding_window_pattern > 1:
        return cfg.sliding_window if layer_id % cfg.sliding_window_pattern == 0 else 0
    return cfg.sliding_window


def sp_prefill(
    params: MeshParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] left-padded, S % sp == 0
    pad_lens: torch.Tensor,  # [B]
    mesh: Mesh,
):
    """Sequence-parallel (× tensor-parallel) prefill over the full prompt.

    Returns (last_logits [B, vocab] f32 on the mesh's controller, cache
    ``{"k", "v"}`` of ``Sharded`` ``[L, B, Hkv, S, D]``: rows over dp,
    heads over tp, sequence over sp; each block in the params' dtype)."""
    dp, sp, tp = mesh.shape[DP], mesh.shape[SP], mesh.shape[TP]
    B, S = tokens.shape
    if S % sp != 0:
        raise ValueError(f"padded length {S} not divisible by sp={sp}")
    if tp > 1 and (
        cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp or cfg.vocab_size % tp
    ):
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}, ffn_dim={cfg.ffn_dim}, "
            f"vocab={cfg.vocab_size}"
        )
    if B % dp:
        raise ValueError(f"{B} rows do not split over dp={dp}")
    counts["prefills"] += 1
    lcfg = local_config(cfg, tp)
    r, n = B // dp, S // sp
    # This process's shards, and the (dp, tp) groups it holds a rank of:
    # a group across processes rings through them all.
    keys = [(d, t, s) for d in range(dp) for t in range(tp) for s in range(sp)
            if mesh.is_local(d, t, s)]
    groups = sorted({k[:2] for k in keys})
    layers = {k: params.shard(*k)["layers"] for k in keys}

    # Per (dp slice, sp rank, device): the block's tokens, pads and RoPE
    # angles, and its embedding (tp shards on one device share them).
    memo: dict = {}

    def block(d, t, s):
        dev = mesh.device(d, t, s)
        key = (d, s, str(dev))
        if key not in memo:
            with device_ctx(dev):
                tok = tokens[d * r : (d + 1) * r, s * n : (s + 1) * n].to(dev)
                pads = pad_lens[d * r : (d + 1) * r].to(dev)
                pos = torch.clamp(
                    s * n + torch.arange(n, device=dev)[None, :] - pads[:, None], min=0
                )
                cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
                memo[key] = (pads, cos, sin, _embed(params.shard(d, t, s), cfg, tok))
        return memo[key]

    x, caches = {}, {}
    for k in keys:
        pads, _, _, x[k] = block(*k)
        with device_ctx(mesh.device(*k)):
            kv_shape = (cfg.n_layers, r, lcfg.n_kv_heads, n, cfg.head_dim)
            dtype = x[k].dtype
            caches[k] = tuple(torch.empty(kv_shape, dtype=dtype, device=pads.device)
                              for _ in range(2))
    for layer_id in range(cfg.n_layers):
        q, kv = {}, {}
        for k in keys:
            with device_ctx(mesh.device(*k)):
                pads, cos, sin, _ = block(*k)
                lp = layers[k][layer_id]
                h = rms_norm(x[k], lp["attn_norm"], cfg.rms_eps, cfg.norm_scale_plus_one)
                q[k], kk, vv = _project_qkv(lp, lcfg, h, r, n, cos, sin)
                # The cache is heads-major: [B, Hkv, S_loc, D] per layer.
                caches[k][0][layer_id].copy_(kk.transpose(1, 2))
                caches[k][1][layer_id].copy_(vv.transpose(1, 2))
                kv[k] = (kk.to(torch.float32), vv.to(torch.float32))
        out = {}
        for d, t in groups:
            group = [k for k in keys if k[:2] == (d, t)]
            outs = ring_attention_local(
                [q[k] for k in group], [kv[k][0] for k in group],
                [kv[k][1] for k in group], sp, causal=True,
                kv_start=[block(*k)[0] for k in group],
                attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale,
                window=_layer_window(cfg, layer_id),
                ranks=[k[2] for k in group], span=mesh.sp_span(d, t),
            )
            out.update(zip(group, outs))
        del q, kv
        _mesh_block(mesh, lcfg, cfg, x, out, layers, layer_id, r, n)
    logits = _mesh_logits(params, cfg, x, True, s=sp - 1)[:, 0]
    spec = cache_sharding(mesh, prefill=True)
    cache = {
        name: Sharded(mesh, spec, [
            [[caches[d, t, s][i] if (d, t, s) in caches else None for s in range(sp)]
             if (d, t) in groups else None for t in range(tp)] for d in range(dp)
        ])
        for i, name in enumerate(("k", "v"))
    }
    return logits, cache


def reshard_cache_for_decode(cache, mesh: Mesh, total_len: int, kv_dtype: str = ""):
    """The sequence-split prefill cache → the decode layout: each (dp, tp)
    shard's sp blocks gathered onto its decode-rank device
    (``collectives.all_gather``; across processes ``collectives.exchange``
    over the shard's sp group, every process holding a block taking
    part), padded with zeros to ``total_len`` slots; rows stay over dp
    and heads over tp.

    ``kv_dtype="int8"``: the gathered, padded cache is quantized into the
    int8 decode layout (``models/transformer.py`` ``_quantize_kv``), as the
    reference quantizes at this boundary: the ring ran on full-precision
    K/V. The reference runs this quantization eagerly, so its scale is a
    true division by 127 (``eager=True``), not the compiled product the
    prefill's per-chunk quantization computes. It runs a layer at a time
    (each (token, head) quantizes alone), so its f32 temporaries are one
    layer's, not the whole cache's."""
    counts["reshards"] += 1
    dp, tp = mesh.shape[DP], mesh.shape[TP]

    def gathered(blocks, d, t):
        span = mesh.sp_span(d, t)
        if span is not None:
            blocks = exchange([b for b in blocks if b is not None], span)
        with device_ctx(mesh.device(d, t)):
            full = all_gather(blocks, dim=3)
            S = full.shape[3]
            if total_len <= S:
                return full
            pad = full.new_zeros(full.shape[:3] + (total_len - S,) + full.shape[4:])
            return torch.cat([full, pad], dim=3)

    grids = {
        name: [[None if cells is None else gathered(cells, d, t)
                for t, cells in enumerate(row)] for d, row in enumerate(cache[name].parts)]
        for name in ("k", "v")
    }
    def quantized(x):
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
        for layer in range(x.shape[0]):
            q[layer], scale[layer] = _quantize_kv(x[layer], eager=True)
        return q, scale

    if kv_dtype == "int8":
        for name in ("k", "v"):
            q = [[None if x is None else quantized(x) for x in row] for row in grids[name]]
            grids[name] = [[None if c is None else c[0] for c in row] for row in q]
            grids[name + "s"] = [[None if c is None else c[1] for c in row] for row in q]
    spec = cache_sharding(mesh)
    return {name: Sharded(mesh, spec, grid) for name, grid in grids.items()}
