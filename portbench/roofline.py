"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of the attention kernels and of the model, from shapes alone.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates without sparsity (the same figures as the chip smoke's
``HBM_BYTES_PER_S`` and ``PEAK_OPS``). ``bound_s`` is the chip smoke's
``finish_bounds``: the larger of bytes over the memory rate and
operations over the bf16 tensor-core peak. Bytes count each input byte
once and each output byte once: a row's key/value window, its query and
its output; operations count a multiply-add as two.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time the chip could take for this work."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["bfloat16"])


def attn_launch(kv_slots: int, attended: list[int], n_query: int, Hq: int, Hkv: int,
                hd: int, itemsize: int = 2) -> tuple[float, float]:
    """(bytes, ops) of one attention launch over one layer: ``kv_slots``
    distinct key/value slots read once (rows that share pages share their
    slots), and for each row its ``n_query`` queries, as many outputs,
    and the products over its ``attended[row]`` slots."""
    kv = kv_slots * Hkv * hd * 2 * itemsize
    qo = len(attended) * n_query * Hq * hd * 2 * itemsize
    ops = sum(attended) * n_query * Hq * hd * 4
    return float(kv + qo), float(ops)


def _heads(cfg: dict) -> tuple[int, int, int, int]:
    H = cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], H, cfg["num_key_value_heads"],
            cfg.get("head_dim") or cfg["hidden_size"] // H)


def dense_attention_bound_s(cfg: dict, rows: list[dict], s1: int, s2: int, gamma: int) -> float:
    """Least time of one round's dense attention launches (B1, B2) over
    every layer. Each row holds its own copy of its window; a row is
    counted while it has tokens left (``output_tokens``). The schedule is
    the program's: the ``s2`` verify steps come first, each advancing a
    row by at least one token (counted as one: the fewest bytes), then the
    ``s1`` single-token steps make the last tokens, the one making token
    ``j`` reading ``input_tokens + j`` slots."""
    L, H, Hkv, hd = _heads(cfg)
    g_max = max(r["output_tokens"] for r in rows)
    total = 0.0
    for k in range(s2):
        att = [r["input_tokens"] + k + gamma + 1 for r in rows if k + 1 < r["output_tokens"]]
        if att:
            total += bound_s(*attn_launch(sum(att), att, gamma + 1, H, Hkv, hd))
    for j in range(max(1, g_max - s1), g_max):
        att = [r["input_tokens"] + j for r in rows if j < r["output_tokens"]]
        if att:
            total += bound_s(*attn_launch(sum(att), att, 1, H, Hkv, hd))
    return L * total


def paged_attention_bound_s(cfg: dict, rows: list[dict], s3: int, s4: int, gamma: int) -> float:
    """Least time of one round's paged attention launches (B3, B4) over
    every layer. Rows of one prompt share its cached pages: a step reads
    the shared prefix once (the shortest row's ``cached_tokens``, the
    pages every row adopted) and each row's own slots beside it. Token
    ``j`` of a row (1 <= j < its ``output_tokens``) is made by one
    single-token step over ``input_tokens + j`` slots; verify steps (B4)
    are counted at one token each."""
    L, H, Hkv, hd = _heads(cfg)
    shared = min(r["cached_tokens"] for r in rows)
    total = 0.0
    if s3:
        # Steps in which rows are live together: the per-row sums are
        # exact, the shared prefix is counted once a step.
        kv = s3 * shared
        att_all = []
        for r in rows:
            for j in range(1, r["output_tokens"]):
                kv += r["input_tokens"] - r["cached_tokens"] + j
                att_all.append(r["input_tokens"] + j)
        # One launch a step: spread the rows' work evenly over the steps
        # (bound_s is linear in each argument while bytes bound it).
        n_b, n_ops = attn_launch(kv, att_all, 1, H, Hkv, hd)
        total += bound_s(n_b, n_ops)
    for k in range(s4):
        live = [r for r in rows if k + 1 < r["output_tokens"]]
        if live:
            att = [r["input_tokens"] + k + gamma + 1 for r in live]
            kv = shared + sum(a - r["cached_tokens"] for a, r in zip(att, live))
            total += bound_s(*attn_launch(kv, att, gamma + 1, H, Hkv, hd))
    return L * total


# Kernel symbols as the profiler names them (demangled templates).
_DECODE = re.compile(r"decode_attn_kernel<([^()]*)>")
_VERIFY = re.compile(r"verify_(?:tc|f32)_kernel<([^()]*)>")


def attention_kind(name: str) -> str | None:
    """``dense`` (B1, B2), ``paged`` (B3, B4), ``combine`` (the split-KV
    combine both share) or None for any other kernel."""
    m = _DECODE.search(name)
    if m:  # <TQ, TK, kPaged, kD, kShards>
        return "paged" if m.group(1).split(",")[2].strip() == "true" else "dense"
    m = _VERIFY.search(name)
    if m:  # <TK, kPaged, kD, kSt>
        return "paged" if m.group(1).split(",")[1].strip() == "true" else "dense"
    if "combine_kernel" in name:
        return "combine"
    return None


def matrix_params(cfg: dict) -> int:
    """Parameters of one layer's projections (biases and norms left out)."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    return D * H * hd * 2 + D * Hkv * hd * 2 + 3 * D * F


def token_flops(cfg: dict, context: int, head: bool) -> float:
    """Model operations of one token that attends over ``context`` slots
    (itself included), with the head's product where ``head``."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or D // H
    flops = 2.0 * matrix_params(cfg) * L + 4.0 * L * H * hd * context
    return flops + (2.0 * D * V if head else 0.0)


def prompt_flops(cfg: dict, n: int, cached: int = 0) -> float:
    """A causal prefill of positions ``cached .. n-1`` of an ``n``-token
    prompt (the first ``cached`` come from a cache); the head for the
    last position only."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or D // H
    attended = (n * (n + 1) - cached * (cached + 1)) / 2
    return (2.0 * matrix_params(cfg) * L * (n - cached) + 4.0 * L * H * hd * attended
            + 2.0 * D * V)


def decode_flops(cfg: dict, n_prompt: int, n_generated: int) -> float:
    """The decode steps of one row: token ``j`` (1 <= j < n_generated) is
    computed from a context of ``n_prompt + j`` slots; token 0 comes from
    the prefill's logits."""
    return sum(token_flops(cfg, n_prompt + j, True) for j in range(1, n_generated))
