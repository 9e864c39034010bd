#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # device, build and kernel phases only
    python3 chip_smoke.py --profile  # also profile one more chat call
    python3 chip_smoke.py --qmm-only # device, build and B5/B6 only: their checks
                                     # and device times (chiprun_out/chip_smoke_qmm.json);
                                     # run from another checkout's root, it times that
                                     # checkout's B5/B6 the same way

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card's name, and its name and power limit as nvidia-smi
   reports them (that line is printed raw as well);
2. build   — compiles every CUDA source of the port with nvcc (in
   parallel), from this checkout, into build/kernels, and prints each
   attention kernel's registers, spills and shared memory (``ptxas``);
3. kernels — each kernel at its main path's shapes against its plain
   PyTorch version on the card, with the tolerance stated, bf16 and f32:
   - dense B1/B2 (Llama-3-8B: B=4, Hq=32, Hkv=8, D=128, T=4224; S=9 for
     the verify) with left-pad windows, an empty window and softcap;
   - paged B3/B4 (the batcher's 8 slots, page 64, a 128-page table =
     8192/64; S=9) with scattered pages, -1 padding, a trash page inside
     a window, a NaN-poisoned trash page and unused pages, left pads, an
     empty row and [B, 1] starts;
   each timed on the device (CUDA graphs replayed between CUDA events, so
   the host's per-call work is left out; ``call_ms`` is the eager call,
   host included) with a cold L2, beside its plain version (eager),
   scaled_dot_product_attention over the same windows (a yardstick only —
   the port never calls it; for B3/B4 the pages are gathered dense
   beforehand, untimed; timed as the kernel is) and the least time the
   card could take; B2 and B4 also over a range of forced split counts;
   - the dequant-matmuls B5 (int8) and B6 (int4) at Llama-3-8B's weights
     (K, N) = (4096, 4096) wq/wo, (4096, 1024) wk/wv, (4096, 14336)
     w_gate/w_up, (14336, 4096) w_down and (4096, 128256) the head (f32
     out), at M = 4, 36, 72, 512, 1024 and 4096 rows (the head at the
     decode rows and at the 1 or 4 rows a prefill chunk ends), plus edge
     cases (M=1, int4 odd K=255 at decode and prefill rows, N=40 and
     N=144, ragged rows past 128, a 3-D x, unaligned x row strides,
     weight scales near 1e-12 and 1e12), each main case called twice and
     required bit-identical; bf16 device times by CUDA-graph replay
     (``ms``; ``call_ms`` the eager call) over enough weight copies to
     span twice the L2, beside the plain version, a bf16 cuBLAS product on
     the weight dequantized beforehand, timed the same way (the
     yardstick; the port never calls it), and the bound (packed weight +
     x + output bytes over 3.35 TB/s, or 2MKN over 989 TFLOP/s). The
     kernels line gives B5/B6 as one forward (224 layer products and the
     head; B5 at M=36, B6 at M=72); each case and the per-forward sums at
     every M are in chip_smoke.json, printed as "qmm" lines; the decode
     path's K split is swept over 1-16 blocks at the line's M, and the
     planned split is timed against whole-K tiles at 96-256 rows;
   - the int8-KV variants of B1-B4 (kv_dtype="int8": int8 K/V beside
     per-(slot, head) f32 scales) at the same shapes and windows, bf16 and
     f32 q, the pool's trash and unused pages holding int8 -128 and NaN
     scales, B4 over one position against B3 and the plain version within
     the tolerance; timed beside the plain version, SDPA over the cache
     dequantized to bf16 beforehand and the bound (int8 K/V and scale
     bytes in the windows, q and out);
   - the split-KV verify kernels B2/B4 (csrc/verify_attention.cu), float
     and int8 K/V, bf16 and f32 q, head_dim 64/128/256, on their edges: a
     ragged tail past T, a one-tile union shorter than n_split, an empty
     row, [B, 1] starts, softcap, 64 query rows per KV head, unaligned
     strides, pages of 16 and 64 slots with a trash entry, -1 padding and
     a NaN-poisoned trash page, B4 over one position against B3;
   - the split-KV S=1 kernels B1/B3 (csrc/decode_attention.cu), float and
     int8 K/V, bf16 and f32 q, head_dim 64/128/256, on their edges: a
     ragged tail past T, left pads, one slot (exactly v), an empty window,
     softcap, 4, 1 and 7 query heads per KV head, unaligned strides, pages
     of 1, 8, 24 and 64 slots with a trash entry, -1 padding and a
     poisoned trash page, B4 at S=1 against B3; then B4 on pages of 8 and
     24 slots, B2/B4 over a 33-position span (132 query rows per KV
     head: two launches in bf16; f32 runs from the kernel's own row limit)
     and B4 at D = 256 over 128-slot pages (S = 9 and 33); B1 and B3, like
     B2 and B4, are also timed over a range of forced split counts;
4. slice   — the dense path: GpuEngine.chat on tpu://random-8b (Llama-3-8B
   at full width, bf16, random weights from seed 0) for four opponent
   requests, greedy, 128 new tokens, speculation on, then the same round
   with speculation off (every decode step B1: its wall, decode seconds
   and launches); B1/B2 launch counters are zeroed just before each call
   and read just after, B2 must launch in the first and B1 in the second;
   with ``--profile``, one more chat call runs under torch.profiler
   (device time by kernel, idle share);
5. paged   — the paged path: GpuEngine.chat on a temporary registry entry
   random-8b with kv="paged" (the continuous batcher): twelve opponent
   requests through 8 slots, 128 new tokens, greedy; round 1 with
   speculation on, round 2 the same requests with it off, on the same
   batcher. B3/B4 counters are zeroed before round 1 and read after
   round 2; B4 must launch in round 1, B3 in round 2, and round 2 must
   hit the prefix cache; with ``--profile``, a third round (speculation
   on, warm cache) runs under torch.profiler;
6. quant   — weight-quantized serving on temporary registry entries:
   (a) random-8b with quant="int8" on the dense path (the slice's four
   requests), (b) random-8b with quant="int4" and kv="paged" (the paged
   slice's twelve requests through 8 slots, one round); speculation on,
   128 new tokens each, greedy. Every counter is zeroed just before each
   chat() and read just after: B5 and B2 must launch in (a), B6 and B4 in
   (b). Reports walls, prefill/decode seconds, tokens/s, resident weight
   bytes beside the bf16 model's, and peak memory; with ``--profile``,
   one more chat() of each runs under torch.profiler;
7. kv8     — the int8 KV cache on temporary registry entries: (a)
   random-8b with kv_dtype="int8" on the dense path (the slice's four
   requests, speculation on); (b) random-8b with kv="paged",
   kv_dtype="int8" and quant="int4" (the paged slice's twelve requests
   through 8 slots, round 1 speculation on, round 2 off, one batcher).
   Counters zeroed just before each chat() and read just after: B2-i8 must
   launch in (a), B1-i8 in (a) repeated with speculation off, B4-i8 and B6
   in (b) round 1, B3-i8 in round 2, the float-cache B1-B4 never, and
   round 2 must hit the prefix cache.
   Reports walls, prefill/decode seconds, tokens/s, the cache or pool
   bytes beside the bf16 layout's, resident weight bytes and peak memory;
8. agree   — tiny f32 models decoded greedily on the card (kernels) and on
   the CPU (plain versions) give identical tokens: dense generate(), and
   the paged batcher with speculation on and off; full precision, the
   same weights quantized int8 (B5) and int4 (B6), and an int8 KV cache
   beside full-precision and int4 weights.

Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adversarial_spec_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
B, HQ, HKV, D, S_SPAN = 4, 32, 8, 128, 9
T_CACHE = 4096 + 128  # the slice's 4096-token bucket + 128 new tokens
NS, PAGE, P_TAB = 8, 64, 128  # batcher slots, page size, 8192 / 64 pages
N_ROTATE = 4  # distinct caches the timing loops cycle through
# Each kernel of the port: (its source under the package, the TPU kernel
# it replaces).
KERNELS = {
    "decode_attention": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:422"),
    "decode_attention_mq": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:249"),
    "paged_decode_attention": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:120"),
    "paged_decode_attention_mq": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:271"),
    "decode_attention_int8kv": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:422"),
    "decode_attention_mq_int8kv": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:249"),
    "paged_decode_attention_int8kv": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:120"),
    "paged_decode_attention_mq_int8kv": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:271"),
    "matmul_int8": ("csrc/quant_matmul.cu", "adversarial_spec_tpu/ops/pallas_quant.py:180"),
    "matmul_int4": ("csrc/quant_matmul.cu", "adversarial_spec_tpu/ops/pallas_quant.py:216"),
}
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)  # one bf16 rounding of the output
F32_TOL = dict(rtol=5e-5, atol=5e-5)  # summation order over 4224 slots


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call ``fn(i)`` from CUDA events, after one
    warm-up; ``i`` lets the caller rotate inputs so the L2 is cold."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int, torch) -> float:
    """Mean device milliseconds per call ``fn(i)``: the call for each of
    the N_ROTATE inputs is captured once in a CUDA graph (after an eager
    warm-up) and the graphs replay in turn between CUDA events, so the
    host's per-call work (Python, argument checks, the launches) is not
    in the time; the rotation keeps the L2 cold."""
    graphs = []
    for i in range(N_ROTATE):
        fn(i)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(i)
        graphs.append(g)
    graphs[0].replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        graphs[i % N_ROTATE].replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed(fn, iters: int, torch) -> dict:
    """A kernel's device time per call (``ms``, graph_ms) and the time of
    an eager call as the path makes it (``call_ms``, host work included:
    a host-bound call is timed by its enqueue rate)."""
    return {"ms": graph_ms(fn, iters, torch), "call_ms": cuda_ms(fn, iters, torch)}


SWEEP_SPLITS = (1, 2, 3, 5, 8, 9, 12)  # the verify kernels (B2, B4)
DECODE_SWEEP = (1, 2, 4, 8, 9, 12, 17, 24, 34, 48)  # the S=1 kernels (B1, B3)


def split_sweep(torch, fn, n_tiles: int, splits=SWEEP_SPLITS) -> dict:
    """Device ms of a split-KV call with n_split forced to each count of
    ``splits`` (capped by the tiles), beside the planner's choice."""
    from adversarial_spec_tpu_torch.ops import split_kv

    real = split_kv.plan_splits
    out = {}
    try:
        for n in splits:
            split_kv.plan_splits = lambda *args, n=n, **kw: max(1, min(n, n_tiles))
            out[str(n)] = graph_ms(fn, 20, torch)
    finally:
        split_kv.plan_splits = real
    return out


def spec_document(n_bytes: int, seed: int) -> str:
    """A spec-style markdown document of about ``n_bytes`` bytes."""
    topics = [
        "authentication", "rate limiting", "audit logging", "billing",
        "search indexing", "data retention", "webhooks", "notifications",
    ]
    parts = [f"# Product Spec {seed}: {topics[seed % len(topics)].title()}\n"]
    i = 0
    while sum(len(p) for p in parts) < n_bytes:
        t = topics[(seed + i) % len(topics)]
        parts.append(
            f"\n## {i + 1}. {t.title()}\n"
            f"- The service MUST expose {t} through a versioned API "
            f"(v{1 + i % 3}) with p99 latency under {50 + 10 * i} ms.\n"
            f"- Failures in {t} are retried with exponential backoff, at "
            f"most {3 + i % 4} attempts, and surfaced to the operator.\n"
            f"- Acceptance: an integration test covers {t} under load.\n"
        )
        i += 1
    return "".join(parts)[:n_bytes]


def window_bytes(starts, ends, T, per_slot):
    """Bytes of K/V a call must read: each row's union of windows."""
    total = 0
    for lo_row, hi_row in zip(starts, ends):
        spans = [(max(lo, 0), min(hi, T)) for lo, hi in zip(lo_row, hi_row)]
        spans = [(lo, hi) for lo, hi in spans if lo < hi]
        if spans:
            total += (max(h for _, h in spans) - min(lo for lo, _ in spans))
    return total * per_slot


# B1 windows: left pads, a full row, a single slot, an empty window.
B1_BOUNDS = [[0, T_CACHE], [700, T_CACHE], [1500, 3001], [2000, 2000]]
B1_SINGLE = [[0, T_CACHE], [700, T_CACHE], [3000, 3001], [1200, T_CACHE]]
# B2: rows desynchronized (own cache index), per-query causal ends.
B2_PADS = [0, 700, 1500, 2300]
B2_ENDS = [[c + j + 1 for j in range(S_SPAN)] for c in (4100, 4150, 4000, 4214)]
B2_STARTS = [[p] * S_SPAN for p in B2_PADS]
B2_STARTS_EMPTY = B2_STARTS[:3] + [B2_ENDS[3][:]]  # row 3: empty windows


def finish_bounds(results: dict) -> None:
    """Each result's bound: the larger of its bytes over the memory rate
    and its operations over the bf16 peak."""
    for r in results.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def sdpa(qq, kk, vv, mask):
    """scaled_dot_product_attention over a cache of HKV heads shared by
    HQ // HKV query heads: the library yardstick (the port never calls it)."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, enable_gqa=True)
    except TypeError:  # older torch: no enable_gqa
        g = HQ // HKV
        return F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1), attn_mask=mask
        )


def check_close(checks: list, name, got, want, tol, empty_row=None) -> float:
    """Raise unless ``got`` is finite (no poison leaked), within ``tol`` of
    ``want`` and, for ``empty_row``, exactly zero; record the case in
    ``checks`` and return the max abs error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output (poison leaked)")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if empty_row is not None and not bool((got[empty_row] == 0).all()):
        raise AssertionError(f"{name}: empty window did not give exact zeros")
    checks.append({"case": name, "max_abs_err": err, "tol": tol})
    return err


def phase_kernels(torch, da) -> tuple[dict, list]:
    from adversarial_spec_tpu_torch.ops import split_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results, checks = {}, []

    def cache(dtype):
        # A layer's slice of an [L, B, Hkv, T, D] cache, as the model reads.
        shape = (2, B, HKV, T_CACHE, D)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        return k[1], v[1]

    def qdraw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b1_bounds, b1_single = B1_BOUNDS, B1_SINGLE
    pads, ends, starts, starts_empty = B2_PADS, B2_ENDS, B2_STARTS, B2_STARTS_EMPTY

    def check(name, got, want, tol, extra=None):
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if extra is not None:
            extra(got)
        checks.append({"case": name, "max_abs_err": err, "tol": tol})
        return err

    def zeros_row(row):
        def f(out):
            sel = out[row]
            if not bool((sel == 0).all()):
                raise AssertionError("empty window did not give exact zeros")
        return f

    kw_b1, kw_b2 = {}, {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k, v = cache(dtype)
        q1 = qdraw((B, HQ, D), dtype)
        q2 = qdraw((B, S_SPAN, HQ, D), dtype)
        for label, bnd in (("windows", b1_bounds), ("single", b1_single)):
            bounds = torch.tensor(bnd, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention(q1, k, v, bounds, attn_softcap=cap)
                want = da.decode_attention_plain(q1, k, v, bounds, attn_softcap=cap)
                err = check(
                    f"B1 {tn} {label} softcap={cap}", got, want, tol,
                    zeros_row(3) if label == "windows" else None,
                )
                if label == "single":
                    # One valid slot: the output is v at that slot.
                    torch.testing.assert_close(
                        got[2].float(),
                        v[2, :, 3000].repeat_interleave(HQ // HKV, 0).float(),
                        rtol=0, atol=0,
                    )
                if dtype == torch.bfloat16 and label == "windows" and cap == 0.0:
                    kw_b1 = dict(q=q1, k=k, v=v, bounds=bounds, err=err, bnd=bnd)
        e_t = torch.tensor(ends, dtype=torch.int32, device=dev)
        for label, st in (("per-query", starts), ("empty", starts_empty)):
            s_t = torch.tensor(st, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention_mq(q2, k, v, s_t, e_t, attn_softcap=cap)
                want = da.decode_attention_mq_plain(q2, k, v, s_t, e_t, attn_softcap=cap)
                err = check(
                    f"B2 {tn} {label} softcap={cap}", got, want, tol,
                    zeros_row(3) if label == "empty" else None,
                )
                if dtype == torch.bfloat16 and label == "per-query" and cap == 0.0:
                    kw_b2 = dict(q=q2, k=k, v=v, starts=s_t, ends=e_t, err=err, st=st)
        # [B, 1] broadcast starts (global layers share one start per row).
        s1 = torch.tensor([[p] for p in pads], dtype=torch.int32, device=dev)
        got = da.decode_attention_mq(q2, k, v, s1, e_t)
        want = da.decode_attention_mq_plain(q2, k, v, s1, e_t)
        check(f"B2 {tn} broadcast-starts", got, want, tol)
    torch.cuda.synchronize()

    # ---- timing at the main path's shapes (bf16) ----
    # Calls rotate over N_ROTATE caches (4 x 69 MB > the 50 MB L2), so each
    # finds its cache cold, as each layer's decode step does.
    elem = 2
    rot = [(kw_b1["k"], kw_b1["v"])] + [
        cache(torch.bfloat16) for _ in range(N_ROTATE - 1)
    ]
    kv = lambda i: rot[i % N_ROTATE]  # noqa: E731
    a = kw_b1
    q, bounds = a["q"], a["bounds"]
    b1_bytes = window_bytes(
        [[lo] for lo, _ in a["bnd"]], [[hi] for _, hi in a["bnd"]],
        T_CACHE, 2 * HKV * D * elem,
    ) + 2 * q.numel() * elem + bounds.numel() * 4
    b1_valid = sum(max(hi - lo, 0) for lo, hi in a["bnd"])
    b1_ops = 4 * HQ * D * b1_valid  # QK and PV, 2 ops per multiply-add
    mask1 = torch.zeros((B, 1, 1, T_CACHE), dtype=torch.bool, device=dev)
    for r, (lo, hi) in enumerate(a["bnd"]):
        mask1[r, :, :, lo:hi] = True

    b1_tiles = -(-T_CACHE // split_kv.decode_tile(D, elem))
    results["decode_attention"] = {
        **timed(lambda i: da.decode_attention(q, *kv(i), bounds), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_plain(q, *kv(i), bounds), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q[:, :, None], *kv(i), mask1), 20, torch
        ),
        "bytes": b1_bytes,
        "ops": b1_ops,
        "max_abs_err": a["err"],
        "n_split": split_kv.decode_splits(B, HKV, HQ // HKV, T_CACHE, D, elem),
        "split_sweep": split_sweep(
            torch, lambda i: da.decode_attention(q, *kv(i), bounds), b1_tiles, DECODE_SWEEP
        ),
    }
    a = kw_b2
    q, s_t, e_t = a["q"], a["starts"], a["ends"]
    b2_bytes = window_bytes(a["st"], ends, T_CACHE, 2 * HKV * D * elem) + (
        2 * q.numel() * elem + 2 * s_t.numel() * 4
    )
    b2_valid = sum(
        max(e - s, 0) for srow, erow in zip(a["st"], ends) for s, e in zip(srow, erow)
    )
    b2_ops = 4 * HQ * D * b2_valid
    mask2 = torch.zeros((B, 1, S_SPAN, T_CACHE), dtype=torch.bool, device=dev)
    for r in range(B):
        for j in range(S_SPAN):
            mask2[r, 0, j, a["st"][r][j] : ends[r][j]] = True
    results["decode_attention_mq"] = {
        **timed(
            lambda i: da.decode_attention_mq(q, *kv(i), s_t, e_t), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_mq_plain(q, *kv(i), s_t, e_t), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q.transpose(1, 2), *kv(i), mask2), 20, torch
        ),
        "bytes": b2_bytes,
        "ops": b2_ops,
        "max_abs_err": a["err"],
        "n_split": split_kv.plan_splits(B, HKV, -(-T_CACHE // split_kv.DENSE_TILE)),
        "split_sweep": split_sweep(
            torch, lambda i: da.decode_attention_mq(q, *kv(i), s_t, e_t),
            -(-T_CACHE // split_kv.DENSE_TILE),
        ),
    }
    finish_bounds(results)
    return results, checks


def kv_pair(torch, gen, dev, shape, dtype, kv):
    """Layer 1 of a random two-layer K/V pair: in ``dtype``, or int8 beside
    its f32 scales (``kv="int8"``)."""
    from adversarial_spec_tpu_torch.ops import kv_inputs

    kf = torch.randn((2, *shape), generator=gen, device=dev)[1]
    vf = torch.randn((2, *shape), generator=gen, device=dev)[1]
    return kv_inputs.kv_pair(kf, vf, dtype, kv)


def phase_verify_edges(torch, da, pa) -> list:
    """The split-KV verify kernels (B2, B4) against their plain versions on
    the edges their grid, ring and combine must get right; returns the
    checks."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    checks = []
    check = functools.partial(check_close, checks)
    pair = functools.partial(kv_pair, torch, gen, dev)

    def tensor(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        for kv in ("float", "int8"):
            for hd in (64, 128, 256):
                tag = f"{tn} {kv} D={hd}"
                k, v, sc = pair((3, 2, 300, hd), dtype, kv)
                q = torch.randn((3, 16, 8, hd), generator=gen, device=dev).to(dtype)
                q9 = q[:, :S_SPAN]
                # Row 0 runs past the last full tile (T = 300), row 1's union
                # is one tile (fewer than n_split), row 2 is empty.
                ends = tensor([[291 + j for j in range(9)], [71 + j for j in range(9)], [300] * 9])
                starts = tensor([[0] * 9, [70] * 9, [300] * 9])
                for cap in (0.0, 50.0):
                    got = da.decode_attention_mq(q9, k, v, starts, ends, attn_softcap=cap, **sc)
                    want = da.decode_attention_mq_plain(q9, k, v, starts, ends, attn_softcap=cap,
                                                        **sc)
                    check(f"B2 edges {tag} softcap={cap}", got, want, tol, empty_row=2)
                b1 = tensor([[0], [70], [0]])
                check(f"B2 edges {tag} [B, 1] starts", da.decode_attention_mq(q9, k, v, b1, ends, **sc),
                      da.decode_attention_mq_plain(q9, k, v, b1, ends, **sc), tol)
                e16 = tensor([[280 + j for j in range(16)]] * 3)
                s16 = tensor([[5], [100], [250]])
                check(f"B2 edges {tag} 64 rows per KV head",
                      da.decode_attention_mq(q, k, v, s16, e16, **sc),
                      da.decode_attention_mq_plain(q, k, v, s16, e16, **sc), tol)
                if kv == "float":  # rows 2 (D + 1) bytes apart: no 16-byte copies
                    buf = torch.randn((3, 2, 300, hd + 1), generator=gen, device=dev).to(dtype)
                    ku, vu = buf[..., :hd], buf[..., 1:]
                    check(f"B2 edges {tag} unaligned rows",
                          da.decode_attention_mq(q9, ku, vu, starts, ends),
                          da.decode_attention_mq_plain(q9, ku, vu, starts, ends), tol, empty_row=2)
                for page in (16, 64):
                    n_pages, P = 24, 8
                    kp, vp, psc = pair((n_pages, 2, page, hd), dtype, kv)
                    table = tensor([[3, 0, 5, 6, 7, 8, 9, 10], [11, 12, 13] + [-1] * 5,
                                    [14] + [-1] * 7])
                    used = set(table.flatten().tolist())
                    poisoned = [0] + [p for p in range(n_pages) if p not in used]
                    if kv == "int8":
                        kp[poisoned] = -128
                        vp[poisoned] = -128
                        for x in psc.values():
                            x[poisoned] = float("nan")
                    else:
                        kp[poisoned] = float("nan")
                        vp[poisoned] = float("nan")
                    last = P * page - 9
                    ends = tensor([[last + j for j in range(1, 10)],
                                   [2 * page + j for j in range(9)], [page // 2] * 9])
                    starts = tensor([[1], [page + 3], [page // 2]])
                    for cap in (0.0, 30.0):
                        got = pa.paged_decode_attention_mq(q9, kp, vp, table, starts, ends,
                                                           attn_softcap=cap, **psc)
                        want = pa.paged_decode_attention_mq_plain(q9, kp, vp, table, starts, ends,
                                                                  attn_softcap=cap, **psc)
                        check(f"B4 edges {tag} page={page} softcap={cap}", got, want, tol,
                              empty_row=2)
                    bnd = tensor([[1, last], [page + 3, 2 * page], [0, 5]])
                    one = pa.paged_decode_attention_mq(q[:, :1], kp, vp, table, bnd[:, :1],
                                                       bnd[:, 1:], **psc)[:, 0]
                    check(f"B4 edges {tag} page={page} S=1 vs B3", one,
                          pa.paged_decode_attention(q[:, 0], kp, vp, table, bnd, **psc), tol)
                    check(f"B4 edges {tag} page={page} S=1", one,
                          pa.paged_decode_attention_plain(q[:, 0], kp, vp, table, bnd, **psc), tol)
    torch.cuda.synchronize()
    return checks


def phase_decode_edges(torch, da, pa) -> list:
    """The split-KV S=1 kernels (B1, B3) against their plain versions on
    the edges their grid, ring and combine must get right, then the
    verify kernels on the spans and pages they refused before (a span of
    g * S = 132 query rows per KV head, pages of 8 and 24 slots, D = 256
    over 128-slot pages); returns the checks."""
    from adversarial_spec_tpu_torch.ops import kv_inputs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    checks = []
    check = functools.partial(check_close, checks)
    pair = functools.partial(kv_pair, torch, gen, dev)

    def tensor(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    paged = functools.partial(kv_inputs.poisoned_pages, gen, dev)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        for kv in ("float", "int8"):
            for hd in (64, 128, 256):
                tag = f"{tn} {kv} D={hd}"
                k, v, sc = pair((4, 2, 300, hd), dtype, kv)
                # Row 0 runs past the last full tile (T = 300), row 1 has a
                # left pad, row 2 one slot, row 3 an empty window.
                bnd = tensor([[0, 300], [37, 250], [100, 101], [80, 80]])
                for hq in (8, 2, 14):  # 4, 1 and 7 query heads per KV head
                    q = torch.randn((4, hq, hd), generator=gen, device=dev).to(dtype)
                    for cap in (0.0, 50.0):
                        got = da.decode_attention(q, k, v, bnd, attn_softcap=cap, **sc)
                        want = da.decode_attention_plain(q, k, v, bnd, attn_softcap=cap, **sc)
                        check(f"B1 edges {tag} g={hq // 2} softcap={cap}", got, want, tol,
                              empty_row=3)
                    one = v[2, :, 100].float()
                    if kv == "int8":
                        one = one * sc["v_scale"][2, :, 100]
                    if not torch.equal(got[2], one.to(dtype).repeat_interleave(hq // 2, 0)):
                        raise AssertionError(f"B1 edges {tag}: one slot is not exactly v")
                if kv == "float":  # rows (D + 1) elements apart: no 16-byte copies
                    buf = torch.randn((4, 2, 300, hd + 1), generator=gen, device=dev).to(dtype)
                    ku, vu = buf[..., :hd], buf[..., 1:]
                    check(f"B1 edges {tag} unaligned rows", da.decode_attention(q, ku, vu, bnd),
                          da.decode_attention_plain(q, ku, vu, bnd), tol, empty_row=3)
                q = q[:3, :8]
                for page in (1, 8, 24, 64):
                    kp, vp, psc, table, pb = paged(page, hd, dtype, kv)
                    for cap in (0.0, 30.0):
                        got = pa.paged_decode_attention(q, kp, vp, table, pb, attn_softcap=cap,
                                                        **psc)
                        want = pa.paged_decode_attention_plain(q, kp, vp, table, pb,
                                                               attn_softcap=cap, **psc)
                        check(f"B3 edges {tag} page={page} softcap={cap}", got, want, tol,
                              empty_row=2)
                    one = pa.paged_decode_attention_mq(q[:, None], kp, vp, table, pb[:, :1],
                                                       pb[:, 1:], **psc)[:, 0]
                    check(f"B4 {tag} page={page} S=1 vs B3", one,
                          pa.paged_decode_attention(q, kp, vp, table, pb, **psc), tol, empty_row=2)
                    if page in (8, 24):  # pages no multiple of 16 (B4 pads them)
                        ends = (pb[:, 1:] - 8 + torch.arange(9, device=dev)).int()
                        ends[2] = 0
                        q9 = torch.randn((3, 9, 8, hd), generator=gen, device=dev).to(dtype)
                        check(f"B4 odd pages {tag} page={page}",
                              pa.paged_decode_attention_mq(q9, kp, vp, table, pb[:, :1], ends,
                                                           **psc),
                              pa.paged_decode_attention_mq_plain(q9, kp, vp, table, pb[:, :1],
                                                                 ends, **psc), tol, empty_row=2)
            # A span of 33 positions at g = 4: 132 query rows per KV head
            # (bf16 q: two launches, runs of 32 and 1 positions; f32 q: one).
            q33 = torch.randn((3, 33, 8, 128), generator=gen, device=dev).to(dtype)
            k, v, sc = pair((3, 2, 300, 128), dtype, kv)
            ends = tensor([[250 + j for j in range(1, 34)], [100 + j for j in range(33)],
                           [60] * 33])
            starts = tensor([[0], [40], [60]])
            check(f"B2 long span {tn} {kv} S=33",
                  da.decode_attention_mq(q33, k, v, starts, ends, **sc),
                  da.decode_attention_mq_plain(q33, k, v, starts, ends, **sc), tol, empty_row=2)
            # f32 q keeps its rows in shared memory: beside 132 of them a
            # 64-slot f32 page is staged in smaller tiles.
            kp, vp, psc, table, _ = paged(64, 128, dtype, kv)
            check(f"B4 long span {tn} {kv} S=33",
                  pa.paged_decode_attention_mq(q33, kp, vp, table, starts, ends, **psc),
                  pa.paged_decode_attention_mq_plain(q33, kp, vp, table, starts, ends, **psc),
                  tol, empty_row=2)
            # D = 256 over 128-slot pages (one f32 page's K + V, 256 KB, is
            # more than a block's shared memory), at S = 9 and S = 33.
            kp, vp, psc, table, _ = paged(128, 256, dtype, kv)
            q256 = torch.randn((3, 33, 8, 256), generator=gen, device=dev).to(dtype)
            for S in (9, 33):
                check(f"B4 D=256 page=128 {tn} {kv} S={S}",
                      pa.paged_decode_attention_mq(q256[:, :S], kp, vp, table, starts,
                                                   ends[:, :S], **psc),
                      pa.paged_decode_attention_mq_plain(q256[:, :S], kp, vp, table, starts,
                                                         ends[:, :S], **psc),
                      tol, empty_row=2)
    torch.cuda.synchronize()
    return checks


def paged_layout(rng):
    """The batcher's shapes for B3/B4: 8 rows, each with its own page
    list drawn from a shared pool (scattered physical ids, -1 padding),
    left pads on two rows, a trash (0) entry inside row 3's window, and
    an empty window on row 7. Returns (table, pads, cur_lens, n_pages)."""
    cur_lens = [4224, 4100, 3000, 2200, 4224, 1800, 3500, 2600]
    pads = [0, 0, 700, 0, 1500, 0, 0, 2000]
    n_row = [-(-(c + S_SPAN) // PAGE) for c in cur_lens]
    n_used = sum(n_row)
    ids = list(rng.permutation(n_used) + 1)  # physical page 0 = trash
    table = [[-1] * P_TAB for _ in range(NS)]
    for r, n in enumerate(n_row):
        for p in range(n):
            table[r][p] = int(ids.pop())
    table[3][10] = 0  # a trash entry inside the window: never read
    return table, pads, cur_lens, n_used + 1 + 16  # 16 unused pages


def paged_counts(table, starts, ends):
    """(K/V slots the call must read — each row's union window, mapped
    pages only — and the (query row, slot) pairs it scores)."""
    read, scored = 0, 0
    for r in range(len(table)):
        mapped = [table[r][t // PAGE] > 0 for t in range(P_TAB * PAGE)]
        spans = [(max(lo, 0), hi) for lo, hi in zip(starts[r], ends[r]) if lo < hi]
        if spans:
            lo = min(a for a, _ in spans)
            hi = max(b for _, b in spans)
            read += sum(mapped[lo:hi])
        scored += sum(sum(mapped[a:b]) for a, b in spans)
    return read, scored


def phase_paged_kernels(torch, pa) -> tuple[dict, list]:
    import numpy as np

    from adversarial_spec_tpu_torch.ops import split_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table_l, pads, cur_lens, n_pages = paged_layout(np.random.RandomState(0))
    used = sorted({p for row in table_l for p in row if p > 0})
    unused = [p for p in range(n_pages) if p not in set(used)]
    table = torch.tensor(table_l, dtype=torch.int32, device=dev)
    b3_bnd = [[pads[r], cur_lens[r]] for r in range(NS)]
    b3_bnd[7] = [2600, 2600]  # empty window
    b4_st = [[pads[r]] * S_SPAN for r in range(NS)]
    b4_en = [[cur_lens[r] + j for j in range(S_SPAN)] for r in range(NS)]
    b4_st[7] = b4_en[7][:]  # empty windows
    results, checks = {}, []

    def pool(dtype):
        # A layer's view of a two-layer [L, n_pages, Hkv, page, D] pool,
        # NaN in the trash page and in every page no row maps.
        shape = (2, n_pages, HKV, PAGE, D)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for x in (k, v):
            x[1, [0] + unused] = float("nan")
        return k[1], v[1]

    check = functools.partial(check_close, checks)

    kw = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k, v = pool(dtype)
        q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        bnd = torch.tensor(b3_bnd, dtype=torch.int32, device=dev)
        st = torch.tensor(b4_st, dtype=torch.int32, device=dev)
        en = torch.tensor(b4_en, dtype=torch.int32, device=dev)
        for cap in (0.0, 50.0):
            got = pa.paged_decode_attention(q1, k, v, table, bnd, attn_softcap=cap)
            want = pa.paged_decode_attention_plain(q1, k, v, table, bnd, attn_softcap=cap)
            err = check(f"B3 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                kw["b3"] = dict(q=q1, bnd=bnd, err=err)
            got = pa.paged_decode_attention_mq(q2, k, v, table, st, en, attn_softcap=cap)
            want = pa.paged_decode_attention_mq_plain(q2, k, v, table, st, en, attn_softcap=cap)
            err = check(f"B4 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                kw["b4"] = dict(q=q2, st=st, en=en, err=err)
        # [B, 1] starts broadcast over the span (row 7 no longer empty).
        s1 = st[:, :1].contiguous()
        got = pa.paged_decode_attention_mq(q2, k, v, table, s1, en)
        want = pa.paged_decode_attention_mq_plain(q2, k, v, table, s1, en)
        check(f"B4 {tn} broadcast-starts", got, want, tol)
        if dtype == torch.bfloat16:
            kw["pool"] = (k, v)
    torch.cuda.synchronize()

    # ---- timing at the batcher's shapes (bf16), pools rotating ----
    rot = [kw["pool"]] + [pool(torch.bfloat16) for _ in range(N_ROTATE - 1)]
    kv = lambda i: rot[i % N_ROTATE]  # noqa: E731
    ids = torch.clamp(table, min=0).long()

    def dense(pages):  # untimed gather for the SDPA yardstick
        x = pages[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, D)
        return torch.nan_to_num(x)  # unmapped slots are masked anyway

    rot_dense = [(dense(k), dense(v)) for k, v in rot]
    kvd = lambda i: rot_dense[i % N_ROTATE]  # noqa: E731
    mapped = (table > 0).repeat_interleave(PAGE, dim=1)  # [NS, T]
    slot = torch.arange(P_TAB * PAGE, device=dev)

    def mask(starts, ends):
        s_t = torch.tensor(starts, device=dev)[..., None]
        e_t = torch.tensor(ends, device=dev)[..., None]
        return ((slot >= s_t) & (slot < e_t) & mapped[:, None, :])[:, None]

    elem = 2
    per_slot = 2 * HKV * D * elem
    b3_starts = [[lo] for lo, _ in b3_bnd]
    b3_ends = [[hi] for _, hi in b3_bnd]
    m3 = mask(b3_starts, b3_ends)
    m3[7] = True  # SDPA gives NaN for an all-masked row; the yardstick only
    q, bnd = kw["b3"]["q"], kw["b3"]["bnd"]
    read, scored = paged_counts(table_l, b3_starts, b3_ends)
    b3_tiles = -(-P_TAB * PAGE // split_kv.decode_tile(D, elem))
    results["paged_decode_attention"] = {
        **timed(lambda i: pa.paged_decode_attention(q, *kv(i), table, bnd), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_plain(q, *kv(i), table, bnd), 8, torch
        ),
        "library_ms": graph_ms(lambda i: sdpa(q[:, :, None], *kvd(i), m3), 20, torch),
        "bytes": read * per_slot + 2 * q.numel() * elem + table.numel() * 4 + bnd.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": kw["b3"]["err"],
        "n_split": split_kv.decode_splits(NS, HKV, HQ // HKV, P_TAB * PAGE, D, elem),
        "split_sweep": split_sweep(
            torch, lambda i: pa.paged_decode_attention(q, *kv(i), table, bnd), b3_tiles,
            DECODE_SWEEP,
        ),
    }
    m4 = mask(b4_st, b4_en)
    m4[7] = True
    q, st, en = kw["b4"]["q"], kw["b4"]["st"], kw["b4"]["en"]
    read, scored = paged_counts(table_l, b4_st, b4_en)
    results["paged_decode_attention_mq"] = {
        **timed(
            lambda i: pa.paged_decode_attention_mq(q, *kv(i), table, st, en), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_mq_plain(q, *kv(i), table, st, en), 8, torch
        ),
        "library_ms": graph_ms(lambda i: sdpa(q.transpose(1, 2), *kvd(i), m4), 20, torch),
        "bytes": read * per_slot + 2 * q.numel() * elem + table.numel() * 4
        + 2 * st.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": kw["b4"]["err"],
        "n_split": split_kv.plan_splits(NS, HKV, P_TAB),
        "split_sweep": split_sweep(
            torch, lambda i: pa.paged_decode_attention_mq(q, *kv(i), table, st, en), P_TAB
        ),
    }
    del rot, rot_dense
    finish_bounds(results)
    return results, checks


def phase_int8kv_kernels(torch, da, pa) -> tuple[dict, list]:
    """The int8-KV variants of B1-B4 (kv_dtype="int8": int8 K/V beside
    per-(slot, head) f32 scales) at the float cases' shapes and windows,
    q and out in bf16 and f32, against their plain versions; the paged
    pool's trash page and unused pages hold int8 -128 values and NaN
    scales. Then bf16 timings with a cold L2 beside the plain version,
    SDPA over the cache dequantized to bf16 beforehand (the yardstick;
    the port never calls it) and the bound."""
    import numpy as np

    from adversarial_spec_tpu_torch.models.transformer import _quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    results, checks = {}, []

    def int8_pair(shape):
        # Layer 1 of a two-layer int8 cache or pool and its [..., 1] scales.
        k8, ks = _quantize_kv(torch.randn((2, *shape), generator=gen, device=dev))
        v8, vs = _quantize_kv(torch.randn((2, *shape), generator=gen, device=dev))
        return k8[1], v8[1], dict(k_scale=ks[1], v_scale=vs[1])

    def dequant(x8, s):  # untimed, for the SDPA yardstick
        return (x8.float() * s).to(torch.bfloat16)

    check = functools.partial(check_close, checks)

    # ---- dense B1-i8 / B2-i8 (B=4, Hq=32, Hkv=8, D=128, T=4224, S=9) ----
    errs = {}
    e_t = torch.tensor(B2_ENDS, dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k8, v8, sc = int8_pair((B, HKV, T_CACHE, D))
        q1 = torch.randn((B, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((B, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        for label, bnd in (("windows", B1_BOUNDS), ("single", B1_SINGLE)):
            bounds = torch.tensor(bnd, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention(q1, k8, v8, bounds, attn_softcap=cap, **sc)
                want = da.decode_attention_plain(q1, k8, v8, bounds, attn_softcap=cap, **sc)
                err = check(f"B1-i8 {tn} {label} softcap={cap}", got, want, tol,
                            3 if label == "windows" else None)
                if label == "single":
                    # One valid slot: the output is that slot's dequantized v.
                    one = (v8[2, :, 3000].float() * sc["v_scale"][2, :, 3000]).to(dtype)
                    torch.testing.assert_close(
                        got[2], one.repeat_interleave(HQ // HKV, 0), rtol=0, atol=0
                    )
                if dtype == torch.bfloat16 and label == "windows" and cap == 0.0:
                    errs["b1"] = err
        for label, st in (("per-query", B2_STARTS), ("empty", B2_STARTS_EMPTY)):
            s_t = torch.tensor(st, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention_mq(q2, k8, v8, s_t, e_t, attn_softcap=cap, **sc)
                want = da.decode_attention_mq_plain(q2, k8, v8, s_t, e_t, attn_softcap=cap, **sc)
                err = check(f"B2-i8 {tn} {label} softcap={cap}", got, want, tol,
                            3 if label == "empty" else None)
                if dtype == torch.bfloat16 and label == "per-query" and cap == 0.0:
                    errs["b2"] = err
        s1 = torch.tensor([[p] for p in B2_PADS], dtype=torch.int32, device=dev)
        got = da.decode_attention_mq(q2, k8, v8, s1, e_t, **sc)
        want = da.decode_attention_mq_plain(q2, k8, v8, s1, e_t, **sc)
        check(f"B2-i8 {tn} broadcast-starts", got, want, tol)
        del k8, v8, sc
    torch.cuda.synchronize()

    # ---- dense timing (bf16 q), int8 caches rotating past the L2 ----
    rot = [int8_pair((B, HKV, T_CACHE, D)) for _ in range(N_ROTATE)]
    rot_deq = [(dequant(k8, sc["k_scale"]), dequant(v8, sc["v_scale"])) for k8, v8, sc in rot]
    q1 = torch.randn((B, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    q2 = torch.randn((B, S_SPAN, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    bounds = torch.tensor(B1_BOUNDS, dtype=torch.int32, device=dev)
    s_t = torch.tensor(B2_STARTS, dtype=torch.int32, device=dev)
    per_slot = 2 * HKV * (D + 4)  # int8 K and V rows plus one f32 scale each
    mask1 = torch.zeros((B, 1, 1, T_CACHE), dtype=torch.bool, device=dev)
    for r, (lo, hi) in enumerate(B1_BOUNDS):
        mask1[r, :, :, lo:hi] = True
    mask2 = torch.zeros((B, 1, S_SPAN, T_CACHE), dtype=torch.bool, device=dev)
    for r in range(B):
        for j in range(S_SPAN):
            mask2[r, 0, j, B2_STARTS[r][j] : B2_ENDS[r][j]] = True

    def kv(i):
        k8, v8, sc = rot[i % N_ROTATE]
        return (k8, v8), sc

    b1_valid = sum(max(hi - lo, 0) for lo, hi in B1_BOUNDS)
    results["decode_attention_int8kv"] = {
        **timed(lambda i: da.decode_attention(q1, *kv(i)[0], bounds, **kv(i)[1]), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_plain(q1, *kv(i)[0], bounds, **kv(i)[1]), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q1[:, :, None], *rot_deq[i % N_ROTATE], mask1), 20, torch
        ),
        "bytes": window_bytes([[lo] for lo, _ in B1_BOUNDS], [[hi] for _, hi in B1_BOUNDS],
                              T_CACHE, per_slot) + 2 * q1.numel() * 2 + bounds.numel() * 4,
        "ops": 4 * HQ * D * b1_valid,
        "max_abs_err": errs["b1"],
    }
    b2_valid = sum(max(e - st, 0) for srow, erow in zip(B2_STARTS, B2_ENDS)
                   for st, e in zip(srow, erow))
    results["decode_attention_mq_int8kv"] = {
        **timed(
            lambda i: da.decode_attention_mq(q2, *kv(i)[0], s_t, e_t, **kv(i)[1]), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_mq_plain(q2, *kv(i)[0], s_t, e_t, **kv(i)[1]), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q2.transpose(1, 2), *rot_deq[i % N_ROTATE], mask2), 20, torch
        ),
        "bytes": window_bytes(B2_STARTS, B2_ENDS, T_CACHE, per_slot)
        + 2 * q2.numel() * 2 + 2 * s_t.numel() * 4,
        "ops": 4 * HQ * D * b2_valid,
        "max_abs_err": errs["b2"],
    }
    del rot, rot_deq
    torch.cuda.empty_cache()

    # ---- paged B3-i8 / B4-i8 (8 slots, page 64, a 128-page table) ----
    table_l, pads, cur_lens, n_pages = paged_layout(np.random.RandomState(0))
    used = {p for row in table_l for p in row if p > 0}
    poisoned = [0] + [p for p in range(n_pages) if p not in used]
    table = torch.tensor(table_l, dtype=torch.int32, device=dev)
    b3_bnd = [[pads[r], cur_lens[r]] for r in range(NS)]
    b3_bnd[7] = [2600, 2600]  # empty window
    b4_st = [[pads[r]] * S_SPAN for r in range(NS)]
    b4_en = [[cur_lens[r] + j for j in range(S_SPAN)] for r in range(NS)]
    b4_st[7] = b4_en[7][:]  # empty windows

    def pool():
        k8, v8, sc = int8_pair((n_pages, HKV, PAGE, D))
        for x in (k8, v8):
            x[poisoned] = -128
        for x in sc.values():
            x[poisoned] = float("nan")
        return k8, v8, sc

    bnd = torch.tensor(b3_bnd, dtype=torch.int32, device=dev)
    st = torch.tensor(b4_st, dtype=torch.int32, device=dev)
    en = torch.tensor(b4_en, dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k8, v8, sc = pool()
        q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        for cap in (0.0, 50.0):
            got3 = pa.paged_decode_attention(q1, k8, v8, table, bnd, attn_softcap=cap, **sc)
            want3 = pa.paged_decode_attention_plain(q1, k8, v8, table, bnd, attn_softcap=cap, **sc)
            err = check(f"B3-i8 {tn} softcap={cap}", got3, want3, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                errs["b3"] = err
            got = pa.paged_decode_attention_mq(q2, k8, v8, table, st, en, attn_softcap=cap, **sc)
            want = pa.paged_decode_attention_mq_plain(
                q2, k8, v8, table, st, en, attn_softcap=cap, **sc
            )
            err = check(f"B4-i8 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                errs["b4"] = err
            # B4-i8 over one position (the split verify kernel) against
            # B3-i8 (the S = 1 body) and against the plain version.
            one = pa.paged_decode_attention_mq(
                q1[:, None], k8, v8, table, bnd[:, :1], bnd[:, 1:], attn_softcap=cap, **sc
            )[:, 0]
            check(f"B4-i8 {tn} S=1 vs B3-i8 softcap={cap}", one, got3, tol, empty_row=7)
            check(f"B4-i8 {tn} S=1 softcap={cap}", one, want3, tol, empty_row=7)
        s1 = st[:, :1].contiguous()
        got = pa.paged_decode_attention_mq(q2, k8, v8, table, s1, en, **sc)
        want = pa.paged_decode_attention_mq_plain(q2, k8, v8, table, s1, en, **sc)
        check(f"B4-i8 {tn} broadcast-starts", got, want, tol)
        del k8, v8, sc
    torch.cuda.synchronize()

    # ---- paged timing (bf16 q), pools rotating ----
    rot = [pool() for _ in range(N_ROTATE)]
    ids = torch.clamp(table, min=0).long()

    def dense(pages, scales):  # untimed gather + dequant for the yardstick
        x = pages[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, D)
        s = scales[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, 1)
        return torch.nan_to_num(dequant(x, s))  # unmapped slots are masked anyway

    rot_dense = [(dense(k8, sc["k_scale"]), dense(v8, sc["v_scale"])) for k8, v8, sc in rot]
    mapped = (table > 0).repeat_interleave(PAGE, dim=1)
    slot = torch.arange(P_TAB * PAGE, device=dev)

    def mask(starts, ends):
        s_ = torch.tensor(starts, device=dev)[..., None]
        e_ = torch.tensor(ends, device=dev)[..., None]
        m = ((slot >= s_) & (slot < e_) & mapped[:, None, :])[:, None]
        m[7] = True  # SDPA gives NaN for an all-masked row; the yardstick only
        return m

    def pkv(i):
        k8, v8, sc = rot[i % N_ROTATE]
        return (k8, v8), sc

    q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    b3_starts, b3_ends = [[lo] for lo, _ in b3_bnd], [[hi] for _, hi in b3_bnd]
    m3, m4 = mask(b3_starts, b3_ends), mask(b4_st, b4_en)
    read, scored = paged_counts(table_l, b3_starts, b3_ends)
    results["paged_decode_attention_int8kv"] = {
        **timed(
            lambda i: pa.paged_decode_attention(q1, *pkv(i)[0], table, bnd, **pkv(i)[1]), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_plain(q1, *pkv(i)[0], table, bnd, **pkv(i)[1]),
            8, torch,
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q1[:, :, None], *rot_dense[i % N_ROTATE], m3), 20, torch
        ),
        "bytes": read * per_slot + 2 * q1.numel() * 2 + table.numel() * 4 + bnd.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": errs["b3"],
    }
    read, scored = paged_counts(table_l, b4_st, b4_en)
    results["paged_decode_attention_mq_int8kv"] = {
        **timed(
            lambda i: pa.paged_decode_attention_mq(q2, *pkv(i)[0], table, st, en, **pkv(i)[1]),
            50, torch,
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_mq_plain(
                q2, *pkv(i)[0], table, st, en, **pkv(i)[1]
            ), 8, torch,
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q2.transpose(1, 2), *rot_dense[i % N_ROTATE], m4), 20, torch
        ),
        "bytes": read * per_slot + 2 * q2.numel() * 2 + table.numel() * 4 + 2 * st.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": errs["b4"],
    }
    del rot, rot_dense
    torch.cuda.empty_cache()
    finish_bounds(results)
    return results, checks


# Llama-3-8B's matmul weights (K, N), with launches per forward: each of the
# 32 layers runs wq, wk, wv, wo, w_gate, w_up, w_down (224 products); the
# head runs once with f32 logits, at every row of a decode step and at the
# last position of each row of a prefill (lm_head_last_only).
QMM_SHAPES = [
    ("wq/wo", 4096, 4096, 64),
    ("wk/wv", 4096, 1024, 64),
    ("w_gate/w_up", 4096, 14336, 64),
    ("w_down", 14336, 4096, 32),
    ("head", 4096, 128256, 1),
]
# Rows: dense S=1 step, dense verify 4x9, paged verify 8x9, the batcher's
# admission chunk (ADMISSION_CHUNK), one row's prefill chunk, the dense
# path's prefill chunk (4 rows x 1024).
QMM_M = [4, 36, 72, 512, 1024, 4096]
# The head's rows in a forward of M rows: all of them at decode, one per
# prompt row in a prefill chunk.
QMM_HEAD_ROWS = {4: 4, 36: 36, 72: 72, 512: 1, 1024: 1, 4096: 4}
# The main path's rows for each kernel's line: B5 serves phase quant (a),
# the dense int8 path (most products there are the 4 x 9 verify); B6 serves
# (b), the paged int4 path (8 x 9 verify).
QMM_LINE_M = {"matmul_int8": 36, "matmul_int4": 72}
QMM_SWEEP_M = (96, 128, 160, 192, 256)  # the planned split against none, around 128 rows
# The kernels and their plain versions both accumulate in f32 (the plain
# version exactly, by cuBLAS sgemm with TF32 off): they differ by summation
# order (~1e-6 of the largest output at K = 14336) and, for a bf16 output,
# by one bf16 rounding of nearly equal values (2^-7 relative).
QMM_TOL = {"float32": (0.0, 2e-5), "bfloat16": (1e-2, 2e-5)}  # (rtol, atol x max|want|)
L2_BYTES = 50e6


def qmm_check(torch, got, want, out_name: str) -> float:
    """max |got - want|; raises unless |got - want| <= rtol |want| +
    atol max|want| everywhere (QMM_TOL) and the output is finite."""
    rtol, atol = QMM_TOL[out_name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    d = (g - w).abs()
    lim = rtol * w.abs() + atol * float(w.abs().max())
    if not bool((d <= lim).all()):
        i = int(torch.argmax(d - lim))
        raise AssertionError(
            f"max excess {float((d - lim).flatten()[i])} at {i}: got "
            f"{float(g.flatten()[i])}, want {float(w.flatten()[i])}"
        )
    return float(d.max())


def graph_seq_ms(fn, n: int, torch, reps: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(0) .. fn(n - 1)`` captured
    in one CUDA graph (after an eager warm-up of each), replayed ``reps``
    times between CUDA events: the host's per-call work is left out, and
    ``n`` inputs spanning twice the L2 keep it cold."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * n)
    del g
    return ms


@contextlib.contextmanager
def forced_plan(qm, plan):
    """The wrappers' plan (``qm.planned``) replaced by ``plan(M, N, K,
    int4, tma_ok)``."""
    real = qm.planned
    qm.planned = plan
    try:
        yield
    finally:
        qm.planned = real


def phase_quant_kernels(torch, qm, quant) -> tuple[dict, list, list, dict]:
    """B5/B6 against their plain versions on the card, bf16 and f32, at
    Llama-3-8B's shapes and the path's row counts, plus edge cases, each
    main case twice and bit-identical; then bf16 device times with a cold
    L2 beside the plain version, a bf16 cuBLAS product on the weight
    dequantized beforehand (the yardstick), and the bound, summed into
    forwards at every QMM_M; the K-split and path-threshold sweeps.
    Returns (per-kernel line numbers, checks, per-case timings, sweeps)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    fmts = {
        "matmul_int8": (quant.quantize_int8, lambda w: (w["q"],), qm.matmul_int8,
                        qm.matmul_int8_plain),
        "matmul_int4": (quant.quantize_int4, lambda w: (w["q4"],), qm.matmul_int4,
                        qm.matmul_int4_plain),
    }
    checks, cases = [], []
    worst = {name: 0.0 for name in fmts}

    def run_case(label, x, w_f, out_dtype=None, main=False):
        for name, (qz, qw, fn, plain) in fmts.items():
            leaf = qz(w_f)
            args = (x, *qw(leaf), leaf["scale"])
            got = fn(*args, out_dtype=out_dtype)
            want = plain(*args, out_dtype=out_dtype)
            out_name = str(got.dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label}: {got.shape}/{got.dtype}")
            try:
                err = qmm_check(torch, got, want, out_name)
            except AssertionError as e:
                raise AssertionError(f"{name} {label}: {e}") from None
            if main:
                worst[name] = max(worst[name], err)
                if not torch.equal(got, fn(*args, out_dtype=out_dtype)):
                    raise AssertionError(f"{name} {label}: two calls differ")
            checks.append({"case": f"{name} {label}", "max_abs_err": err,
                           "max_abs_want": float(want.float().abs().max()),
                           "tol": QMM_TOL[out_name]})

    def randn(shape, dtype, mag=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * mag).to(dtype)

    def rows_of(label):
        if label != "head":
            return QMM_M
        return sorted(set(QMM_HEAD_ROWS.values()))

    for dtype in (torch.bfloat16, torch.float32):
        tn = str(dtype).split(".")[1]
        for label, K, N, _ in QMM_SHAPES:
            w_f = randn((K, N), dtype, K ** -0.5)
            head_out = torch.float32 if label == "head" else None
            for M in rows_of(label):
                run_case(f"{tn} {label} M={M}", randn((M, K), dtype), w_f, head_out, main=True)
            del w_f
        # Edges: one row, odd K (int4 packs a zero row) at decode and
        # prefill rows, N no multiple of 16 and N = 144 (no tile multiple),
        # ragged rows past 128, a 3-D x, unaligned x row strides (scalar
        # loads), tiny and huge scales.
        w_odd = randn((255, 40), dtype)
        run_case(f"{tn} M=1 K=4096 N=4096", randn((1, 4096), dtype), randn((4096, 4096), dtype))
        run_case(f"{tn} odd K=255 N=40 M=5", randn((5, 255), dtype), w_odd)
        run_case(f"{tn} odd K=255 N=40 M=130", randn((130, 255), dtype), w_odd)
        run_case(f"{tn} odd K=1023 N=144 M=300", randn((300, 1023), dtype),
                 randn((1023, 144), dtype))
        run_case(f"{tn} 3-D x (2, 3, 4096) N=1024", randn((2, 3, 4096), dtype),
                 randn((4096, 1024), dtype))
        run_case(f"{tn} x row stride 4099 M=36", randn((36, 4099), dtype)[:, :4096],
                 randn((4096, 1024), dtype), torch.float32)
        run_case(f"{tn} x row stride 4099 M=300", randn((300, 4099), dtype)[:, :4096],
                 randn((4096, 1024), dtype))
        for mag in (1e-12, 1e12):
            run_case(f"{tn} scale~{mag:g} K=255 N=40 M=72", randn((72, 255), dtype),
                     randn((255, 40), dtype, mag))
    torch.cuda.synchronize()

    # ---- timing (bf16), weights rotating so each call finds the L2 cold ----
    sweeps = {"ksplit": [], "threshold": []}
    sweeps_on = hasattr(qm, "planned")  # a checkout whose B5/B6 have a K-split plan
    for label, K, N, per_fwd in QMM_SHAPES:
        w_f = randn((K, N), torch.bfloat16, K ** -0.5)
        head_out = torch.float32 if label == "head" else None
        leaves = {name: [fmts[name][0](w_f)] for name in fmts}
        lib_w = [quant.dequantize(leaves["matmul_int8"][0], torch.bfloat16)]
        # Enough copies that a rotation spans twice the L2.
        for name in fmts:
            leaf = leaves[name][0]
            copies = 1 + int(2 * L2_BYTES // fmts[name][1](leaf)[0].numel())
            leaves[name] += [{k: t.clone() for k, t in leaf.items()} for _ in range(copies - 1)]
        lib_copies = 1 + int(2 * L2_BYTES // (lib_w[0].numel() * 2))
        lib_w += [lib_w[0].clone() for _ in range(lib_copies - 1)]
        del w_f
        rows = rows_of(label)
        sweep_rows = () if label == "head" else QMM_SWEEP_M
        for M in sorted(set(rows) | set(sweep_rows)):
            x = randn((M, K), torch.bfloat16)
            out_bytes = M * N * (4 if head_out else 2)

            def lib(i, x=x):
                w = lib_w[i % len(lib_w)]
                if head_out:
                    return torch.mm(x, w, out_dtype=torch.float32)
                return torch.matmul(x, w)

            lib_ms = graph_seq_ms(lib, len(lib_w), torch) if M in rows else None
            for name, (_, qw, fn, plain) in fmts.items():
                ls = leaves[name]

                def call(i, fn=fn, ls=ls, x=x):
                    leaf = ls[i % len(ls)]
                    return fn(x, *qw(leaf), leaf["scale"], out_dtype=head_out)

                if M in sweep_rows and sweeps_on:  # the planned split against whole-K tiles
                    planned = qm.planned(M, N, K, name == "matmul_int4", True)
                    for path, pl in (("planned", planned), ("whole-K", (qm.DECODE_WIDTHS[0], 1))):
                        with forced_plan(qm, lambda *a, pl=pl: pl):
                            sweeps["threshold"].append({
                                "kernel": name, "weight": label, "M": M, "path": path,
                                "bn": pl[0], "ksplit": pl[1],
                                "ms": graph_seq_ms(call, len(ls), torch)})
                if M not in rows:
                    continue
                w_bytes = qw(ls[0])[0].numel() + N * 4
                t_bytes = (w_bytes + x.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * M * K * N / PEAK_OPS["bfloat16"] * 1e3
                bn, ks = (qm.planned(M, N, K, name == "matmul_int4", True) if sweeps_on
                          else (None, None))
                cases.append({
                    "kernel": name, "weight": label, "M": M, "K": K, "N": N,
                    "per_forward": per_fwd, "bn": bn, "ksplit": ks,
                    "ms": graph_seq_ms(call, len(ls), torch),
                    "call_ms": cuda_ms(call, 20, torch),
                    "plain_ms": cuda_ms(lambda i: plain(x, *qw(ls[i % len(ls)]),
                                                        ls[i % len(ls)]["scale"],
                                                        out_dtype=head_out), 3, torch),
                    "library_ms": lib_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                })
                if M == QMM_LINE_M[name] and sweeps_on:  # the decode path's K split
                    for n in range(1, qm.MAX_CLUSTER + 1):
                        with forced_plan(qm, lambda *a, bn=bn, n=n: (bn, n)):
                            sweeps["ksplit"].append({
                                "kernel": name, "weight": label, "M": M, "bn": bn,
                                "ksplit": n, "planned": n == ks,
                                "ms": graph_seq_ms(call, len(ls), torch)})
        del leaves, lib_w
        torch.cuda.empty_cache()

    def forward(name, M):
        """One forward's sums at M rows: 224 layer products and the head."""
        rows = [c for c in cases if c["kernel"] == name and (
            (c["weight"] != "head" and c["M"] == M)
            or (c["weight"] == "head" and c["M"] == QMM_HEAD_ROWS[M]))]
        tot = {k: sum(c[k] * c["per_forward"] for c in rows)
               for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(c["bound_ms"] * c["per_forward"] for c in rows if c["bound_by"] == "bytes")
        tot["bound_by"] = "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations"
        return tot

    per_m = {name: {str(M): forward(name, M) for M in QMM_M} for name in fmts}
    sweeps["per_forward"] = per_m
    results = {}
    for name in fmts:
        results[name] = {
            **per_m[name][str(QMM_LINE_M[name])],
            "max_abs_err": worst[name],
            "line_is": f"one forward (224 products and the head) at M={QMM_LINE_M[name]}",
        }
    return results, checks, cases, sweeps


def profile_chat(torch, engine, reqs, sp, name="chip_profile.txt") -> dict:
    """One more chat call under torch.profiler: device busy time by
    kernel, and the idle share of the call's wall time (the profiler's own
    host overhead lengthens the wall, so the share is an upper bound).
    The full table goes to chiprun_out/<name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.chat(reqs, sp)
        torch.cuda.synchronize()
    wall = time.monotonic() - t
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            kernels.append({"name": ev.key[:120], "count": ev.count, "ms": us / 1e3})
    kernels.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in kernels)
    for r in kernels:
        r["share"] = r["ms"] / busy_ms if busy_ms else 0.0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"wall_s {wall}\nbusy_ms {busy_ms}\n")
        for r in kernels:
            f.write(f"{r['ms']:12.3f} ms {r['count']:7d}x {r['share']:.4f}  {r['name']}\n")
    return {
        "phase": "profile",
        "wall_s": wall,
        "device_busy_s": busy_ms / 1e3 if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / 1e3 / wall if kernels else "not measured",
        "top_kernels": kernels[:12],
    }


def slice_requests() -> list:
    """The dense slice's four opponents on tpu://random-8b: spec documents
    of 1600-3400 bytes."""
    from adversarial_spec_tpu_torch.engine.types import ChatRequest

    return [
        ChatRequest(
            model="tpu://random-8b",
            system=p,
            user=spec_document(n, i) + "\n\nCritique this spec.",
        )
        for i, (p, n) in enumerate(zip(PERSONAS[:4], [1600, 2300, 2900, 3400]))
    ]


def paged_requests() -> list:
    """The paged slice's twelve opponents on tpu://random-8b: spec
    documents of 1600-3360 bytes."""
    from adversarial_spec_tpu_torch.engine.types import ChatRequest

    return [
        ChatRequest(
            model="tpu://random-8b",
            system=p,
            user=spec_document(1600 + 160 * i, 10 + i) + "\n\nCritique this spec.",
        )
        for i, p in enumerate(PERSONAS)
    ]


@contextlib.contextmanager
def temp_registry(*specs):
    """The port's registry pointed at a temporary file under build/ that
    holds ``specs`` (user entries shadow the built-in aliases)."""
    import tempfile
    from pathlib import Path

    from adversarial_spec_tpu_torch.engine import registry

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    prev_path = registry.REGISTRY_PATH
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        registry.REGISTRY_PATH = Path(tmp) / "registry.json"
        try:
            for spec in specs:
                registry.save_registry_entry(spec)
            yield
        finally:
            registry.REGISTRY_PATH = prev_path


def phase_slice(torch, profile: bool = False) -> dict:
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da

    spec_mod.configure(enabled=True)
    reqs = slice_requests()
    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    engine = GpuEngine()
    t = time.monotonic()
    warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
    if not warm[0].ok:
        raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
    load_s = time.monotonic() - t

    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    t = time.monotonic()
    comps = engine.chat(reqs, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    floats = ("decode_attention", "decode_attention_mq")
    calls = [{"call": "main", "speculative": True, **dict(da.launches)}]
    launched = {k: da.launches[k] for k in floats}
    bad = [c.error for c in comps if not c.ok]
    if bad:
        raise RuntimeError(f"chat failed: {bad}")
    if any(c.usage.output_tokens != 128 for c in comps):
        raise RuntimeError(
            f"rows stopped early: {[c.usage.output_tokens for c in comps]}"
        )
    prefill_s = sum(c.usage.prefill_time_s for c in comps)
    decode_s = sum(c.usage.decode_time_s for c in comps)
    out_tok = sum(c.usage.output_tokens for c in comps)
    # The same round with speculation off (the user's ADVSPEC_SPECULATIVE=0,
    # or the adaptive off-switch): every decode step is B1, at full width.
    spec_mod.configure(enabled=False)
    try:
        da.reset_launches()
        t = time.monotonic()
        off = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall_off = time.monotonic() - t
    finally:
        spec_mod.configure(enabled=True)
    bad = [c.error for c in off if not c.ok]
    if bad or any(c.usage.output_tokens != 128 for c in off):
        raise RuntimeError(f"speculation-off chat failed: {bad or [c.usage for c in off]}")
    off_decode_s = sum(c.usage.decode_time_s for c in off)
    calls.append({"call": "speculation off", "speculative": False, **dict(da.launches)})
    speculation_off = {
        "chat_wall_s": wall_off,
        "prefill_s": sum(c.usage.prefill_time_s for c in off),
        "decode_s": off_decode_s,
        "decode_tokens_per_s": 128 * len(off) / off_decode_s if off_decode_s > 0 else 0.0,
        "launches": dict(da.launches),
    }
    if da.launches["decode_attention"] == 0:
        raise RuntimeError(f"B1 never launched with speculation off: {calls}")
    launched["decode_attention"] += da.launches["decode_attention"]
    if min(launched.values()) == 0:
        raise RuntimeError(f"a kernel of the path never launched: {calls}")
    prof = profile_chat(torch, engine, reqs, sp) if profile else None
    return {
        "phase": "slice",
        "model": "tpu://random-8b",
        "requests": len(reqs),
        "input_tokens": [c.usage.input_tokens for c in comps],
        "output_tokens": [c.usage.output_tokens for c in comps],
        "load_and_warmup_s": load_s,
        "chat_wall_s": wall,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "speculation_off": speculation_off,
        "launch_calls": calls,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


PERSONAS = [
    "You are a security engineer reviewing a product spec.",
    "You are an SRE focused on reliability and operability.",
    "You are a product manager checking scope and acceptance criteria.",
    "You are a staff engineer looking for design flaws and ambiguity.",
    "You are a privacy counsel checking data handling.",
    "You are a QA lead looking for untestable requirements.",
    "You are a database engineer reviewing storage and migrations.",
    "You are a frontend engineer checking API ergonomics.",
    "You are a cost analyst reviewing infrastructure spend.",
    "You are an accessibility specialist reviewing user flows.",
    "You are a support lead checking operability for on-call staff.",
    "You are a compliance auditor checking audit and retention rules.",
]


def phase_paged(torch, profile: bool = False) -> dict:
    """GpuEngine.chat on a kv="paged" random-8b: round 1 speculation on,
    round 2 the same requests with it off, on the same batcher. With
    ``profile``, a third round (speculation on, warm prefix cache) runs
    under torch.profiler."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import registry
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    reqs = paged_requests()
    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    with temp_registry(
        registry.ModelSpec(alias="random-8b", family="llama", size="8b", kv="paged")
    ):
        try:
            engine = GpuEngine()
            t = time.monotonic()
            warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
            if not warm[0].ok:
                raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
            load_s = time.monotonic() - t
            rounds = []
            da.reset_launches()
            pa.reset_launches()
            texts = []
            for label, on in (("round 1, speculation on", True), ("round 2, speculation off", False)):
                spec_mod.configure(enabled=on)
                before = {**da.launches, **pa.launches}
                il.reset_stats()
                torch.cuda.reset_peak_memory_stats()
                t = time.monotonic()
                comps = engine.chat(reqs, sp)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
                bad = [c.error for c in comps if not c.ok]
                if bad:
                    raise RuntimeError(f"{label}: chat failed: {bad}")
                if any(c.usage.output_tokens < 1 for c in comps):
                    raise RuntimeError(f"{label}: a row emitted nothing")
                after = {**da.launches, **pa.launches}
                decode_s = sum(c.usage.decode_time_s for c in comps)
                out_tok = sum(c.usage.output_tokens for c in comps)
                texts.append([c.text for c in comps])
                rounds.append({
                    "round": label,
                    "wall_s": wall,
                    "prefill_s": sum(c.usage.prefill_time_s for c in comps),
                    "decode_s": decode_s,
                    "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
                    "input_tokens": [c.usage.input_tokens for c in comps],
                    "output_tokens": [c.usage.output_tokens for c in comps],
                    "cached_tokens": sum(c.usage.cached_tokens for c in comps),
                    "launches": {k: after[k] - before[k] for k in after},
                    "host_syncs": il.stats.sync_points,
                    "fused_steps": il.stats.fused_steps,
                    "decode_steps": il.stats.decode_steps,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                })
            launched = {k: pa.launches[k] for k in ("paged_decode_attention",
                                                    "paged_decode_attention_mq")}
            prof = None
            if profile:
                spec_mod.configure(enabled=True)
                prof = profile_chat(torch, engine, reqs, sp, "chip_profile_paged.txt")
            lm = engine._resident
            pool_bytes = sum(t.numel() * t.element_size() for t in lm.batcher.pool.values())
            batcher = {"slots": lm.batcher.B, "capacity_tokens": lm.batcher.capacity_tokens,
                       "pool_bytes": pool_bytes}
        finally:
            spec_mod.configure(enabled=True)
    r1, r2 = rounds
    if r1["launches"]["paged_decode_attention_mq"] == 0:
        raise RuntimeError(f"B4 never launched with speculation on: {r1['launches']}")
    if r2["launches"]["paged_decode_attention"] == 0:
        raise RuntimeError(f"B3 never launched with speculation off: {r2['launches']}")
    if r2["cached_tokens"] == 0:
        raise RuntimeError("round 2 found no prefix-cache hits on the reused batcher")
    return {
        "phase": "paged",
        "model": "tpu://random-8b (kv=paged)",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        "batcher": batcher,
        "rounds": rounds,
        "rows_same_text_spec_on_off": sum(a == b for a, b in zip(*texts)),
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


def weight_bytes(params) -> tuple[int, int]:
    """(resident bytes of the params, the bytes the same model takes in
    bf16): a quantized leaf would be its unpacked integer weight at two
    bytes, with no scales."""
    from adversarial_spec_tpu_torch.models.transformer import leaves

    resident = sum(t.numel() * t.element_size() for t in leaves(params))
    weights = [v for k, v in params.items() if k != "layers"]
    weights += [v for lp in params["layers"] for v in lp.values()]
    bf16 = 0
    for v in weights:
        if isinstance(v, dict):  # int8 {"q", "scale"} or int4 {"q4", "scale"}
            bf16 += 2 * v["q"].numel() if "q" in v else 4 * v["q4"].numel()
        else:
            bf16 += 2 * v.numel()
    return resident, bf16


def serve_quantized(torch, spec, reqs, must_launch, profile=False) -> dict:
    """One warm-up call, then one chat() of ``reqs`` on tpu://random-8b as
    ``spec`` (speculation on, 128 new tokens, greedy) with every launch
    counter zeroed just before and read just after; each kernel named in
    ``must_launch`` must have launched, and every row must be ok with 128
    tokens. With ``profile``, one more chat() runs under torch.profiler
    (chiprun_out/chip_profile_quant_<fmt>.txt)."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    spec_mod.configure(enabled=True)
    with temp_registry(spec):
        engine = GpuEngine()
        t = time.monotonic()
        warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
        if not warm[0].ok:
            raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
        load_s = time.monotonic() - t
        resident, bf16 = weight_bytes(engine._resident.params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        il.reset_stats()
        for mod in (da, pa, qm):
            mod.reset_launches()
        t = time.monotonic()
        comps = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launched = {**da.launches, **pa.launches, **qm.launches}
        peak = torch.cuda.max_memory_allocated()
        prof = (
            profile_chat(torch, engine, reqs, sp, f"chip_profile_quant_{spec.quant}.txt")
            if profile else None
        )
        del engine
    torch.cuda.empty_cache()
    bad = [c.error for c in comps if not c.ok]
    if bad:
        raise RuntimeError(f"{spec.alias} quant={spec.quant}: chat failed: {bad}")
    if any(c.usage.output_tokens != 128 for c in comps):
        raise RuntimeError(f"rows stopped early: {[c.usage.output_tokens for c in comps]}")
    missing = [k for k in must_launch if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{missing} never launched on quant={spec.quant}: {launched}")
    decode_s = sum(c.usage.decode_time_s for c in comps)
    out_tok = sum(c.usage.output_tokens for c in comps)
    return {
        "model": f"tpu://random-8b (quant={spec.quant}, kv={spec.kv})",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        "chat_wall_s": wall,
        "prefill_s": sum(c.usage.prefill_time_s for c in comps),
        "decode_s": decode_s,
        "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
        "input_tokens": [c.usage.input_tokens for c in comps],
        "output_tokens": [c.usage.output_tokens for c in comps],
        "resident_weight_bytes": resident,
        "bf16_weight_bytes": bf16,
        "max_memory_allocated_bytes": peak,
        "host_syncs": il.stats.sync_points,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


def phase_quant(torch, profile: bool = False) -> dict:
    """Weight-quantized serving of Llama-3-8B on both paths: (a) int8 on
    the dense path (the slice's four requests; B5 with B2), (b) int4 on the
    paged batcher (the paged slice's twelve requests through 8 slots, one
    round; B6 with B4)."""
    from adversarial_spec_tpu_torch.engine.registry import ModelSpec

    dense = serve_quantized(
        torch,
        ModelSpec(alias="random-8b", family="llama", size="8b", quant="int8"),
        slice_requests(),
        ("matmul_int8", "decode_attention_mq"),
        profile,
    )
    paged = serve_quantized(
        torch,
        ModelSpec(alias="random-8b", family="llama", size="8b", quant="int4", kv="paged"),
        paged_requests(),
        ("matmul_int4", "paged_decode_attention_mq"),
        profile,
    )
    return {"phase": "quant", "dense_int8": dense, "paged_int4": paged}


FLOAT_ATTENTION = (
    "decode_attention", "decode_attention_mq",
    "paged_decode_attention", "paged_decode_attention_mq",
)


@contextlib.contextmanager
def recording_dense_caches(made: list):
    """Record (bytes, the same cache's bytes in bf16) of every dense cache
    ``generate()`` builds while the block runs."""
    from adversarial_spec_tpu_torch.engine import generate as gen_mod

    real = gen_mod.init_cache

    def init_cache(*args, **kwargs):
        cache = real(*args, **kwargs)
        made.append((
            sum(t.numel() * t.element_size() for t in cache.values()),
            2 * 2 * cache["k"].numel(),
        ))
        return cache

    gen_mod.init_cache = init_cache
    try:
        yield
    finally:
        gen_mod.init_cache = real


def phase_kv8(torch, profile: bool = False) -> dict:
    """The int8 KV cache (kv_dtype="int8") on random-8b, on temporary
    registry entries: (a) the dense path, the slice's four requests,
    speculation on; (b) the paged path beside int4 weights, the paged
    slice's twelve requests through 8 slots, round 1 with speculation on
    and round 2 with it off on the same batcher. Every launch counter is
    zeroed just before each chat() and read just after: B2-i8 and B1-i8
    must launch in (a), B4-i8 and B6 in (b) round 1, B3-i8 in round 2,
    and the float-cache B1-B4 never. With ``profile``, one more chat() of
    each runs under torch.profiler."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.registry import ModelSpec
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)

    def load(reqs):
        engine = GpuEngine()
        t = time.monotonic()
        warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
        if not warm[0].ok:
            raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
        return engine, time.monotonic() - t

    def chat(engine, reqs, label, full_rows=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in (da, pa, qm):
            mod.reset_launches()
        il.reset_stats()
        t = time.monotonic()
        comps = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launched = {**da.launches, **pa.launches, **qm.launches}
        bad = [c.error for c in comps if not c.ok]
        if bad:
            raise RuntimeError(f"{label}: chat failed: {bad}")
        out = [c.usage.output_tokens for c in comps]
        if (full_rows and any(n != 128 for n in out)) or min(out) < 1:
            raise RuntimeError(f"{label}: rows stopped early: {out}")
        leaked = {k: launched[k] for k in FLOAT_ATTENTION if launched[k]}
        if leaked:
            raise RuntimeError(f"{label}: float-cache kernels ran on an int8 cache: {leaked}")
        decode_s = sum(c.usage.decode_time_s for c in comps)
        return comps, {
            "wall_s": wall,
            "prefill_s": sum(c.usage.prefill_time_s for c in comps),
            "decode_s": decode_s,
            "decode_tokens_per_s": sum(out) / decode_s if decode_s > 0 else 0.0,
            "input_tokens": [c.usage.input_tokens for c in comps],
            "output_tokens": out,
            "cached_tokens": sum(c.usage.cached_tokens for c in comps),
            "host_syncs": il.stats.sync_points,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in launched.items() if v},
        }

    report = {"phase": "kv8"}
    # (a) dense int8 KV, full-precision (bf16) weights.
    reqs = slice_requests()
    spec_mod.configure(enabled=True)
    with temp_registry(ModelSpec(alias="random-8b", family="llama", size="8b", kv_dtype="int8")):
        engine, load_s = load(reqs)
        made = []
        with recording_dense_caches(made):
            _, main = chat(engine, reqs, "kv8 dense")
        calls = [main]
        launched = dict(main["launches"])
        # The same round with speculation off: every decode step is B1-i8.
        spec_mod.configure(enabled=False)
        try:
            _, off = chat(engine, reqs, "kv8 dense, speculation off")
        finally:
            spec_mod.configure(enabled=True)
        calls.append({"speculation": "off", **off})
        if not off["launches"].get("decode_attention_int8kv"):
            raise RuntimeError(f"kv8 dense: B1-i8 never launched with speculation off: {off}")
        launched["decode_attention_int8kv"] = (
            launched.get("decode_attention_int8kv", 0) + off["launches"]["decode_attention_int8kv"]
        )
        missing = [k for k in ("decode_attention_int8kv", "decode_attention_mq_int8kv")
                   if not launched.get(k)]
        if missing:
            raise RuntimeError(f"kv8 dense: {missing} never launched: {calls}")
        resident, _ = weight_bytes(engine._resident.params)
        prof = (profile_chat(torch, engine, reqs, sp, "chip_profile_kv8_dense.txt")
                if profile else None)
        del engine
    torch.cuda.empty_cache()
    report["dense"] = {
        "model": "tpu://random-8b (kv_dtype=int8)",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        **main,
        "cache_bytes": made[0][0],
        "bf16_cache_bytes": made[0][1],
        "resident_weight_bytes": resident,
        "speculation_off": off,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }

    # (b) paged int8 KV beside int4 weights, two rounds on one batcher.
    reqs = paged_requests()
    with temp_registry(ModelSpec(alias="random-8b", family="llama", size="8b", kv="paged",
                                 quant="int4", kv_dtype="int8")):
        engine, load_s = load(reqs)
        rounds, launched = [], {}
        try:
            for label, on in (("round 1, speculation on", True),
                              ("round 2, speculation off", False)):
                spec_mod.configure(enabled=on)
                _, r = chat(engine, reqs, f"kv8 paged {label}", full_rows=False)
                rounds.append({"round": label, **r})
                for k, v in r["launches"].items():
                    launched[k] = launched.get(k, 0) + v
            prof = None
            if profile:
                spec_mod.configure(enabled=True)
                prof = profile_chat(torch, engine, reqs, sp, "chip_profile_kv8_paged.txt")
        finally:
            spec_mod.configure(enabled=True)
        lm = engine._resident
        pool = lm.batcher.pool
        resident, bf16 = weight_bytes(lm.params)
        paged = {
            "model": "tpu://random-8b (kv=paged, quant=int4, kv_dtype=int8)",
            "requests": len(reqs),
            "load_and_warmup_s": load_s,
            "slots": lm.batcher.B,
            "capacity_tokens": lm.batcher.capacity_tokens,
            "pool_bytes": sum(t.numel() * t.element_size() for t in pool.values()),
            "bf16_pool_bytes": 2 * 2 * pool["k"].numel(),
            "pool_dtypes": {k: str(t.dtype) for k, t in pool.items()},
            "resident_weight_bytes": resident,
            "bf16_weight_bytes": bf16,
            "rounds": rounds,
            "launches": launched,
            **({"profile": prof} if prof else {}),
        }
        del engine, lm, pool
    torch.cuda.empty_cache()
    r1, r2 = rounds
    for r, names in ((r1, ("paged_decode_attention_mq_int8kv", "matmul_int4")),
                     (r2, ("paged_decode_attention_int8kv",))):
        missing = [k for k in names if not r["launches"].get(k)]
        if missing:
            raise RuntimeError(f"kv8 paged {r['round']}: {missing} never launched: {r['launches']}")
    if r2["cached_tokens"] == 0:
        raise RuntimeError("kv8 paged round 2 found no prefix-cache hits on int8 pages")
    report["paged_int4"] = paged
    return report


def phase_agree(torch) -> dict:
    """Tiny f32 llama, full precision and quantized int8 and int4 from the
    same weights, and with an int8 KV cache beside full-precision and int4
    weights: greedy tokens on the card (kernels) and on the CPU (plain
    versions) must be identical, through generate() and through the paged
    batcher with speculation on and off."""
    from adversarial_spec_tpu_torch.engine.generate import generate
    from adversarial_spec_tpu_torch.engine.loader import materialize_params
    from adversarial_spec_tpu_torch.engine.scheduler import (
        ContinuousBatcher,
        SchedRequest,
    )
    from adversarial_spec_tpu_torch.models.transformer import map_params
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    prompts = [[1] + [5 + (i * 7 + j) % 200 for j in range(60 + 25 * i)] for i in range(3)]
    base, cfg = materialize_params(
        "random", "llama", "tiny", dtype=torch.float32, device="cuda"
    )
    report = {"phase": "agree"}
    # (weights, KV cache): the report key and the kernels that must launch
    # (of each group, at least one: generate() decodes by verify spans or
    # by single steps, as its drafts allow).
    dense8 = ("decode_attention_int8kv", "decode_attention_mq_int8kv")
    paged8 = ("paged_decode_attention_int8kv", "paged_decode_attention_mq_int8kv")
    cases = (
        ("", "", None, ()),
        ("int8", "", "quant_int8", (("matmul_int8",),)),
        ("int4", "", "quant_int4", (("matmul_int4",),)),
        ("", "int8", "kv8", (dense8, paged8)),
        ("int4", "int8", "kv8_int4", (("matmul_int4",), dense8, paged8)),
    )
    for fmt, kv_dtype, key, must_launch in cases:
        params = base if not fmt else quant.quantize_params(map_params(torch.clone, base), fmt=fmt)
        on_cpu = map_params(lambda t: t.cpu(), params)  # the same weights on the CPU
        for mod in (da, pa, qm):
            mod.reset_launches()
        out = {
            dev: generate(
                p, cfg, prompts, max_new_tokens=48, eos_ids=[2], greedy=True,
                device=dev, kv_dtype=kv_dtype,
            ).tokens
            for dev, p in (("cuda", params), ("cpu", on_cpu))
        }
        name = f"tiny f32{' ' + fmt if fmt else ''}{' kv ' + kv_dtype if kv_dtype else ''}"
        same = bool((out["cuda"] == out["cpu"]).all())
        if not same:
            raise RuntimeError(f"{name} greedy tokens differ between card and CPU")
        # The paged batcher (B3/B4 on the card, the gather path on the CPU):
        # 3 requests through 2 slots, prefix cache on, speculation on and off.
        paged = {}
        for spec in (True, False):
            toks = {}
            for dev, p in (("cuda", params), ("cpu", on_cpu)):
                b = ContinuousBatcher(
                    p, cfg, max_batch=2, page_size=16, capacity_tokens=2048,
                    max_new_cap=48, eos_ids=[2], speculative=spec, kv_dtype=kv_dtype,
                )
                for i, pr in enumerate(prompts):
                    b.submit(SchedRequest(req_id=i, prompt_ids=pr, max_new_tokens=40))
                toks[dev] = [r.tokens.tolist() for r in b.run_all()]
                b.allocator.check_invariants()
            paged["spec_on" if spec else "spec_off"] = toks["cuda"] == toks["cpu"]
            if toks["cuda"] != toks["cpu"]:
                raise RuntimeError(
                    f"{name} paged batcher tokens differ between card and CPU "
                    f"(speculation {'on' if spec else 'off'})"
                )
        launched = {**da.launches, **pa.launches, **qm.launches}
        missing = [g for g in must_launch if not sum(launched[k] for k in g)]
        if missing:
            raise RuntimeError(f"{name}: none of {missing} launched on the card")
        if kv_dtype:
            leaked = {k: launched[k] for k in FLOAT_ATTENTION if launched[k]}
            if leaked:
                raise RuntimeError(f"{name}: float-cache kernels ran on an int8 cache: {leaked}")
        entry = {"identical_tokens": same, "shape": list(out["cuda"].shape),
                 "paged_identical_tokens": paged}
        if key:
            report[key] = {**entry, "launches": {k: launched[k] for g in must_launch for k in g}}
        else:
            report.update(entry)
    return report


def main(argv: list[str]) -> int:
    t_start = time.monotonic()
    quick = "--quick" in argv
    qmm_only = "--qmm-only" in argv
    profile = "--profile" in argv
    if not os.path.isdir(os.path.join(HERE, PKG)):
        return fail(f"{PKG}/ not found beside chip_smoke.py: run from a checkout")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs a CUDA card")
    sys.path.insert(0, HERE)
    os.environ.setdefault(
        "ADVSPEC_KERNEL_BUILD_DIR", os.path.join(HERE, "build", "kernels")
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from adversarial_spec_tpu_torch.ops import _build
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "not measured"
    emit({
        "phase": "device", "kind": kind, "count": torch.cuda.device_count(),
        "nvidia_smi": smi_line, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })

    t = time.monotonic()
    libs = _build.build_all()
    ptxas = [
        ln.strip() for src in libs for ln in _build.ptxas_report(src).splitlines()
        if "registers" in ln or "spill" in ln
    ]
    emit({"phase": "build", "seconds": time.monotonic() - t,
          "sources": sorted(libs), "ptxas": ptxas})
    # Each kernel's registers, shared memory and spills, by function.
    for src in ("decode_attention.cu", "verify_attention.cu", "quant_matmul.cu"):
        report = [
            ln.split(":", 1)[-1].strip()
            for ln in _build.ptxas_report(src).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln
        ]
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            report = subprocess.run(["c++filt"], input="\n".join(report), capture_output=True,
                                    text=True, timeout=60).stdout.splitlines() or report
        emit({"phase": "ptxas", "source": src, "lines": report})

    if qmm_only:
        qres, qchecks, qcases, qsweeps = phase_quant_kernels(torch, qm, quant)
        for c in qcases:
            print(f"qmm {c['kernel']} {c['weight']} M={c['M']}: ms {c['ms']:.5f} call "
                  f"{c['call_ms']:.5f} library {c['library_ms']:.5f}", flush=True)
        for name, per_m in qsweeps["per_forward"].items():
            for M, t in per_m.items():
                print(f"qmm forward {name} M={M}: ms {t['ms']:.4f} call {t['call_ms']:.4f} "
                      f"library {t['library_ms']:.4f} bound {t['bound_ms']:.4f}", flush=True)
        out_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_qmm.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi_line, "kernels": qres,
                       "checks": qchecks, "quant_cases": qcases, "quant_sweeps": qsweeps}, f,
                      indent=1)
        print(smi_line, flush=True)
        return 0
    kres, checks = phase_kernels(torch, da)
    pres, pchecks = phase_paged_kernels(torch, pa)
    kres.update(pres)
    checks += pchecks
    ires, ichecks = phase_int8kv_kernels(torch, da, pa)
    kres.update(ires)
    checks += ichecks
    checks += phase_verify_edges(torch, da, pa)
    checks += phase_decode_edges(torch, da, pa)
    qres, qchecks, qcases, qsweeps = phase_quant_kernels(torch, qm, quant)
    kres.update(qres)
    emit({"phase": "kernels", "checks": checks, "quant_checks": len(qchecks),
          "quant_worst": {name: r["max_abs_err"] for name, r in qres.items()}})
    for c in qcases:  # one short line per B5/B6 timing (all in chip_smoke.json)
        print(f"qmm {c['kernel']} {c['weight']} M={c['M']} bn={c['bn']} ks={c['ksplit']}: "
              f"ms {c['ms']:.5f} call {c['call_ms']:.5f} plain {c['plain_ms']:.4f} library "
              f"{c['library_ms']:.5f} bound {c['bound_ms']:.5f} ({c['bound_by']})", flush=True)
    for name, per_m in qsweeps["per_forward"].items():
        for M, t in per_m.items():
            print(f"qmm forward {name} M={M}: ms {t['ms']:.4f} call {t['call_ms']:.4f} "
                  f"library {t['library_ms']:.4f} bound {t['bound_ms']:.4f}", flush=True)
    for c in qsweeps["ksplit"]:
        print(f"qmm ksplit {c['kernel']} {c['weight']} M={c['M']} bn={c['bn']} "
              f"ks={c['ksplit']}{'*' if c['planned'] else ''}: ms {c['ms']:.5f}", flush=True)
    for c in qsweeps["threshold"]:
        print(f"qmm threshold {c['kernel']} {c['weight']} M={c['M']} {c['path']}: "
              f"ms {c['ms']:.5f}", flush=True)
    checks += qchecks
    torch.cuda.empty_cache()
    record = {"device": kind, "nvidia_smi": smi_line, "kernels": kres, "checks": checks,
              "quant_cases": qcases, "quant_sweeps": qsweeps}

    launches = {name: None for name in kres}
    if not quick:
        sl = phase_slice(torch, profile=profile)
        emit(sl)
        launches.update(sl["launches"])
        torch.cuda.empty_cache()
        pg = phase_paged(torch, profile=profile)
        emit(pg)
        launches.update(pg["launches"])
        torch.cuda.empty_cache()
        qt = phase_quant(torch, profile=profile)
        emit(qt)
        launches["matmul_int8"] = qt["dense_int8"]["launches"]["matmul_int8"]
        launches["matmul_int4"] = qt["paged_int4"]["launches"]["matmul_int4"]
        kv8 = phase_kv8(torch, profile=profile)
        emit(kv8)
        for name in KERNELS:
            if name.endswith("_int8kv"):
                launches[name] = (kv8["dense"]["launches"].get(name, 0)
                                  + kv8["paged_int4"]["launches"].get(name, 0))
        ag = phase_agree(torch)
        emit(ag)
        record.update(slice=sl, paged=pg, quant=qt, kv8=kv8, agree=ag)

    line = []
    for name, r in kres.items():
        source, replaces = KERNELS[name]
        line.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"],
            "kernel_ms": r["ms"],
            "call_ms": r.get("call_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    record["kernels_line"] = line
    record["seconds"] = time.monotonic() - t_start
    emit({"phase": "done", "seconds": record["seconds"]})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(smi_line, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
