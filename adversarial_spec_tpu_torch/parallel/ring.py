"""Ring attention: causal attention with the sequence axis sharded over sp.

Counterpart of ``adversarial_spec_tpu/parallel/ring.py``. Each sp rank
holds one contiguous block of the sequence. Every rank attends its query
block to the K/V block it currently holds, accumulates the online-softmax
statistics (running max, normaliser and weighted values: the
flash-attention recurrence), and hands its K/V block to the next rank
(``collectives.ring_shift``: a peer copy between cards, a hand-off on a
virtual mesh). After ``ring_hops`` hops every query block has seen every
key block it may attend to.

The reference runs one SPMD program per device, so its ranks step the
ring in lockstep inside ``shard_map``. The port's single controller
drives one sp group at a time: ``ring_attention_local`` takes the group's
blocks as lists in rank order and steps every rank through each hop.
Across processes each process passes the blocks of the ranks it holds,
with their global ranks and the group's ``Span``; a hop that leaves a
process is a send/receive with the next one, and every process posts the
same hops in the same order (the hop count and the skips below depend on
the ranks and the window alone). A key block wholly in a query block's
future is skipped (the reference computes it masked; its contribution is
exactly zero either way).

Causality is enforced at block granularity and, on the diagonal block,
by the in-block triangular mask; a per-row ``kv_start`` masks left-pad
slots; ``window`` (a sliding window, per layer) masks keys that fell out
of it, and a windowed layer leaves the ring after ``ring_hops`` hops.
The arithmetic is f32, as the reference's. A fully masked row gives
exact zeros, not NaN (the ``-inf`` and ``m_safe``/``alpha`` guards), so
this is plain PyTorch and not ``scaled_dot_product_attention``, which
gives NaN there. The reference has no Pallas kernel here either.

``ring_attention`` wraps the body for global tensors: it splits the
sequence into the mesh's sp blocks and concatenates the result.
"""

from __future__ import annotations

import math

import torch

from adversarial_spec_tpu_torch.parallel.collectives import ring_shift
from adversarial_spec_tpu_torch.parallel.mesh import SP, Mesh, Span, device_ctx

# One ``ring_attention_local`` call per sp group, the hops it ran, and
# the shifts among them that crossed processes.
counts = {"calls": 0, "hops": 0, "crossed": 0}

# The most bytes one block's f32 scores may take: longer query blocks are
# attended in runs of rows (rows are independent).
SCORE_BYTES = 1 << 30


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _block_attend(
    q: torch.Tensor,  # [B, Sq, H, D] f32
    k: torch.Tensor,  # [B, Sk, Hkv, D] f32
    v: torch.Tensor,  # [B, Sk, Hkv, D] f32
    mask: torch.Tensor,  # [B, Sq, Sk] bool, True = attend
    m: torch.Tensor,  # [B, H, Sq] running max
    l: torch.Tensor,  # [B, H, Sq] running normaliser
    acc: torch.Tensor,  # [B, Sq, H, D] running weighted values
    scale: float,
    attn_softcap: float = 0.0,
):
    """One flash-attention accumulation step over a K/V block."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k).mul_(scale)  # [B, Hkv, g, Sq, Sk]
    s = s.reshape(B, H, Sq, Sk)
    if attn_softcap > 0.0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    # -inf (not the dtype's min): a fully masked row must give EXACT
    # zeros; the m/alpha guards below keep -inf NaN-free.
    s.masked_fill_(~mask[:, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, float("-inf")))
    p = s.sub_(m_safe[..., None]).exp_()  # [B, H, Sq, Sk]
    l_new = l * alpha + p.sum(dim=-1)
    pg = p.reshape(B, Hkv, g, Sq, Sk)
    delta = torch.einsum("bhgst,bthd->bshgd", pg, v).reshape(B, Sq, H, D)
    acc_new = acc * alpha.transpose(1, 2)[..., None] + delta
    return m_new, l_new, acc_new


def _attend_rows(q, k, v, mask, m, l, acc, scale, attn_softcap):
    """``_block_attend`` in runs of query rows whose scores fit
    ``SCORE_BYTES``."""
    B, Sq, H, _ = q.shape
    run = max(1, SCORE_BYTES // max(1, B * H * k.shape[1] * 4))
    if run >= Sq:
        return _block_attend(q, k, v, mask, m, l, acc, scale, attn_softcap)
    parts = [
        _block_attend(q[:, i : i + run], k, v, mask[:, i : i + run], m[..., i : i + run],
                      l[..., i : i + run], acc[:, i : i + run], scale, attn_softcap)
        for i in range(0, Sq, run)
    ]
    return (torch.cat([p[0] for p in parts], dim=-1), torch.cat([p[1] for p in parts], dim=-1),
            torch.cat([p[2] for p in parts], dim=1))


def ring_hops(sp: int, block: int, window, causal: bool) -> int:
    """Number of ring hops that can possibly contribute.

    Causal + sliding window W: hop h hands rank idx the K block of rank
    idx - h; a non-wrapped block sits h·block slots behind the query
    block, and every (query, key) pair of hop h is outside the window once
    (h-1)·block + 1 >= W: the same bound on every rank. Wrapped blocks are
    wholly in the future. ``window`` is an int (a 0-d tensor is read as
    one); 0 means global attention."""
    if not causal:
        return sp
    window = int(window)
    if window <= 0:
        return sp
    return min(sp, (window + block - 2) // block + 1)


def ring_attention_local(
    qbs: list[torch.Tensor],  # per rank [B, S_loc, H, D], on its device
    kbs: list[torch.Tensor],  # per rank [B, S_loc, Hkv, D]
    vbs: list[torch.Tensor],
    sp: int,
    causal: bool = True,
    kv_start: list[torch.Tensor] | None = None,  # per rank [B] first valid global slot
    attn_softcap: float = 0.0,
    scale: float | None = None,
    window: int = 0,  # sliding window in slots; 0 = global
    ranks: list[int] | None = None,  # the blocks' global sp ranks (default all)
    span: Span | None = None,  # the group's processes, when it spans several
) -> list[torch.Tensor]:
    """One sp group's ring: the blocks of every rank, in rank order, each
    on its rank's device; returns each rank's output block (q's dtype).
    Across processes (``span``) the lists hold this process's ranks,
    ``ranks`` naming them.

    Key slots below ``q_slot - window + 1`` are masked, and a windowed
    layer leaves the ring after ``ring_hops`` hops: the blocks left are
    outside every query's window on every rank."""
    B, Sq, H, D = qbs[0].shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    window = int(window)
    hops = ring_hops(sp, Sq, window, causal)
    ranks = list(range(sp)) if ranks is None else list(ranks)
    states, consts = [], []
    for idx, qb in enumerate(qbs):
        dev = qb.device
        with device_ctx(dev):
            states.append((
                torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=dev),
                torch.zeros((B, H, Sq), dtype=torch.float32, device=dev),
                torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev),
            ))
            rows = torch.arange(Sq, device=dev)[:, None]
            cols = torch.arange(Sq, device=dev)[None, :]
            consts.append((qb.to(torch.float32), rows, cols))
    for h in range(hops):
        for j, idx in enumerate(ranks):
            src = (idx - h) % sp  # after h hops rank idx holds rank src's block
            if causal and src > idx:
                continue  # wholly in the future: masked to nothing
            q32, rows, cols = consts[j]
            with device_ctx(q32.device):
                if not causal or src < idx:
                    mask = torch.ones((Sq, Sq), dtype=torch.bool, device=q32.device)
                else:
                    mask = rows >= cols
                key_slot = src * Sq + cols
                if window > 0:
                    mask = mask & (key_slot > idx * Sq + rows - window)
                mask = mask[None].expand(B, Sq, Sq)
                if kv_start is not None:
                    mask = mask & (key_slot[None] >= kv_start[j][:, None, None])
                states[j] = _attend_rows(q32, kbs[j], vbs[j], mask, *states[j],
                                         scale, attn_softcap)
        if h + 1 < hops:
            kbs, vbs = ring_shift(kbs, ranks, span), ring_shift(vbs, ranks, span)
            counts["crossed"] += span is not None
    counts["calls"] += 1
    counts["hops"] += hops
    outs = []
    for qb, (_, l, acc) in zip(qbs, states):
        with device_ctx(qb.device):
            l_safe = torch.clamp(l, min=1e-30)
            outs.append((acc / l_safe.transpose(1, 2)[..., None]).to(qb.dtype))
    return outs


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D], S the global sequence length
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    mesh: Mesh,
    causal: bool = True,
    kv_start: torch.Tensor | None = None,  # [B]
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Attention with the sequence split over the mesh's ``sp`` axis:
    global tensors in, the global result out (on ``q``'s device). Each sp
    block runs on ``mesh.device(0, 0, s)``, as one sp group of the
    reference's ``shard_map`` (its other dp and tp shards compute the
    same)."""
    sp = mesh.shape[SP]
    S = q.shape[1]
    if S % sp != 0:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    n = S // sp
    devs = [mesh.device(0, 0, s) for s in range(sp)]

    def blocks(x):
        return [x[:, s * n : (s + 1) * n].to(dev) for s, dev in enumerate(devs)]

    starts = None if kv_start is None else [kv_start.to(dev) for dev in devs]
    outs = ring_attention_local(
        blocks(q), blocks(k.to(torch.float32)), blocks(v.to(torch.float32)), sp,
        causal=causal, kv_start=starts, attn_softcap=attn_softcap,
    )
    return torch.cat([o.to(q.device) for o in outs], dim=1)
