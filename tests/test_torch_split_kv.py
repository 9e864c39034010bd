"""The split-KV kernels on the CPU — the verify kernels
(``csrc/verify_attention.cu``: B2 dense, B4 paged) and the S=1 kernels
(``csrc/decode_attention.cu``: B1 dense, B3 paged): their host planner,
and plain mirrors of their algorithms against the unsplit plain versions
and the reference's Pallas kernels in interpret mode.

- ``ops/split_kv.py``: ``plan_splits`` fills the card's resident-block
  slots (two verify blocks, or four S=1 blocks, on each of 132 SMs) with
  the least ``n_split`` the tiles allow; ``split_tiles`` cuts a window
  union's tiles into runs that cover each tile exactly once, on tile (page)
  boundaries; ``span_runs`` cuts a bf16 verify span longer than the
  kernel's registers hold into runs of positions, one launch each, whose
  outputs concatenated are the span's; the wrappers' launch planning
  (``mq_args``, ``decode_args``) runs on meta tensors, so it reads no
  device tensor (a read would raise).
- ``mirror_s1`` folds the S=1 kernel's algorithm: the row's window
  clipped to the cache, its 16 KB tiles (aligned in slot space, so a tile
  may hold part of a page, one page or several) cut into ``n_split`` runs,
  slots outside the window or in a page with id <= 0 never loaded (zero)
  and masked, a tile with no scored slot skipped, q pre-scaled and int8
  K/V dequantized first (the reference's order, for f32 and bf16 q alike),
  each run through ``flash_update`` and the partials merged by
  ``combine_partials``.
- ``mirror_mq`` folds the kernel's algorithm in plain PyTorch: per (row,
  KV head) the union of its windows, its tiles cut into ``n_split`` runs,
  slots outside the union zero-filled, pages with id <= 0 skipped, each
  run through ``flash_update`` and the partials merged by
  ``combine_partials``; bf16-style query rows padded to 16 with ``[T, 0)``
  windows. ``fold=True`` applies scale and the int8 K scale to the score
  column and the V scale to p, as the bf16 kernel does; otherwise q is
  pre-scaled and int8 K/V dequantize first, the reference's order (the
  f32 kernel's).

Tolerances: f32 at 2e-5 (summation order: everything accumulates in
f32); bf16 inputs at rtol 1.6e-2, atol 1e-5 (one bf16 rounding of the
output).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.ops import pallas_decode, pallas_paged
from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa
from adversarial_spec_tpu_torch.ops import split_kv
from adversarial_spec_tpu_torch.ops.flash_common import (
    combine_partials,
    flash_update,
)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the planner --------------------------------------------------------------


SLOTS = split_kv.SMS * split_kv.BLOCKS_PER_SM  # 264 resident blocks
DECODE_SLOTS = split_kv.SMS * split_kv.DECODE_BLOCKS_PER_SM  # 528 resident S=1 blocks


@pytest.mark.parametrize(
    "B, Hkv, n_tiles, want",
    [
        (4, 8, 66, 9),  # the dense smoke: 32 blocks -> 288
        (8, 8, 128, 5),  # the batcher's 8 slots: 64 blocks -> 320
        (1, 2, 3, 3),  # capped by the tiles a row can have
        (33, 8, 128, 1),  # 264 blocks already fill every slot
        (17, 8, 128, 2),
        (2, 2, 0, 1),  # never below one split
    ],
)
def test_plan_splits_least_count_that_fills_the_card(B, Hkv, n_tiles, want):
    n = split_kv.plan_splits(B, Hkv, n_tiles)
    assert n == want
    if n < n_tiles:  # not capped: fills the slots, and one less would not
        assert n * B * Hkv >= SLOTS
        assert n == 1 or (n - 1) * B * Hkv < SLOTS


@pytest.mark.parametrize("slots", [SLOTS, DECODE_SLOTS], ids=["verify", "decode"])
def test_plan_splits_over_a_grid_of_shapes(slots):
    for B in range(1, 40):
        for Hkv in (1, 2, 4, 8, 16):
            for n_tiles in (1, 2, 5, 66, 2048):
                n = split_kv.plan_splits(B, Hkv, n_tiles, slots=slots)
                assert 1 <= n <= max(n_tiles, 1)
                if n < n_tiles:
                    assert n * B * Hkv >= slots
                    assert n == 1 or (n - 1) * B * Hkv < slots


@pytest.mark.parametrize(
    "D, itemsize, tile",
    [(128, 2, 32), (128, 1, 64), (128, 4, 16), (64, 2, 64), (64, 1, 128), (256, 4, 8)],
)
def test_decode_tile_is_16_kb_of_k_and_v(D, itemsize, tile):
    assert split_kv.decode_tile(D, itemsize) == tile
    assert 2 * tile * D * itemsize == split_kv.DECODE_STAGE_BYTES


@pytest.mark.parametrize(
    "B, Hkv, g, T, D, itemsize, want",
    [
        (4, 8, 4, 4224, 128, 2, 17),  # the dense smoke: 32 blocks -> 544 of 528 slots
        (8, 8, 4, 8192, 128, 2, 9),  # the batcher's 8 slots: 64 blocks -> 576
        (4, 8, 4, 4224, 128, 1, 17),  # int8 cache: 64-slot tiles, same blocks
        (4, 8, 8, 4224, 128, 2, 9),  # g = 8: two blocks of 4 query rows per head
        (4, 4, 7, 4224, 128, 2, 17),  # g = 7: two blocks, one pad row
        (1, 2, 4, 64, 64, 4, 2),  # capped by the two 32-slot tiles
        (66, 8, 4, 4224, 128, 2, 1),  # 528 blocks already fill every slot
    ],
)
def test_decode_splits_fill_the_s1_kernels_own_slots(B, Hkv, g, T, D, itemsize, want):
    """B1/B3 plan at four blocks per SM (the S=1 kernel's launch bound and
    shared memory), not the verify kernel's two."""
    assert split_kv.DECODE_BLOCKS_PER_SM != split_kv.BLOCKS_PER_SM
    n = split_kv.decode_splits(B, Hkv, g, T, D, itemsize)
    assert n == want
    blocks = B * Hkv * -(-g // split_kv.DECODE_GROUP)
    n_tiles = -(-T // split_kv.decode_tile(D, itemsize))
    if n < n_tiles:
        assert n * blocks >= DECODE_SLOTS
        assert n == 1 or (n - 1) * blocks < DECODE_SLOTS


@pytest.mark.parametrize(
    "S, g, D, dtype, want",
    [
        (9, 4, 128, torch.bfloat16, [(0, 9)]),  # the main path: one launch
        (33, 4, 128, torch.bfloat16, [(0, 32), (32, 33)]),  # gamma = 32: 132 rows
        (40, 4, 256, torch.bfloat16, [(0, 16), (16, 32), (32, 40)]),
        (19, 7, 128, torch.bfloat16, [(0, 18), (18, 19)]),  # 126 rows pad to 128
        (70, 4, 64, torch.bfloat16, [(0, 64), (64, 70)]),
        (33, 4, 128, torch.float32, [(0, 33)]),  # f32 rows live in shared memory
    ],
)
def test_span_runs_fit_the_kernel(S, g, D, dtype, want):
    """bf16 q: each run's query rows, padded to 16, times D fit the verify
    block's registers, and one more position would not, unless the run is
    the whole span. f32 q: one launch."""
    runs = split_kv.span_runs(S, g, D, dtype)
    assert runs == want
    assert [t for a, b in runs for t in range(a, b)] == list(range(S))
    if dtype == torch.bfloat16:
        per = runs[0][1] - runs[0][0]

        def padded(n):
            return -(-g * n // split_kv.ROW_PAD) * split_kv.ROW_PAD * D

        assert padded(per) <= split_kv.MAX_ACC
        assert per == S or padded(per + 1) > split_kv.MAX_ACC


@pytest.mark.parametrize(
    "S, g, max_rows, want",
    [
        (33, 4, 205, [(0, 33)]),  # f32 K/V in 64-slot pages at D=128: one launch
        (33, 4, 92, [(0, 23), (23, 33)]),  # D=256 in 128-slot f32 pages
        (9, 4, 36, [(0, 9)]),
        (10, 4, 36, [(0, 9), (9, 10)]),
    ],
)
def test_span_runs_f32_take_the_kernels_row_limit(S, g, max_rows, want):
    """f32 q: runs of ``max_rows // g`` positions, ``max_rows`` being what
    the kernel's own C entry reports for the launch (read on the card);
    without it (a CPU or meta tensor) one run."""
    runs = split_kv.span_runs(S, g, 128, torch.float32, max_rows)
    assert runs == want
    assert all(g * (s1 - s0) <= max_rows for s0, s1 in runs)
    assert split_kv.span_runs(S, g, 128, torch.float32) == [(0, S)]
    with pytest.raises(ValueError, match="at most 3 query rows"):
        split_kv.span_runs(1, g, 128, torch.float32, 3)


def test_span_runs_raise_when_one_position_does_not_fit():
    with pytest.raises(ValueError, match="at most 64 query rows"):
        split_kv.span_runs(1, 65, 256, torch.bfloat16)
    assert split_kv.span_runs(1, 64, 256, torch.bfloat16) == [(0, 1)]


@pytest.mark.parametrize("tile", [8, 16, 32, 64, 128])
@pytest.mark.parametrize(
    "lo, hi", [(0, 4224), (700, 4109), (63, 65), (64, 128), (5, 6), (300, 300), (9, 2)]
)
def test_split_tiles_cover_the_union_exactly_once(lo, hi, tile):
    for n_split in range(1, 12):
        runs = [split_kv.split_tiles(lo, hi, tile, n_split, i) for i in range(n_split)]
        tiles = [t for a, b in runs for t in range(a, b)]
        if lo >= hi:
            assert tiles == []
            continue
        first, end = lo // tile, -(-hi // tile)
        assert tiles == list(range(first, end))  # each tile once, in order
        # Contiguous runs whose lengths differ by at most one.
        assert all(runs[i][1] == runs[i + 1][0] for i in range(n_split - 1))
        sizes = [b - a for a, b in runs]
        assert max(sizes) - min(sizes) <= 1
        # On tile boundaries, covering [lo, hi) and no tile outside it.
        assert first * tile <= lo < (first + 1) * tile
        assert (end - 1) * tile < hi <= end * tile


def test_window_union_skips_empty_windows_and_clips():
    assert split_kv.window_union([5, -3, 40], [9, 2, 41], 30) == (0, 9)
    assert split_kv.window_union([10, 7], [10, 3], 64) == (64, 0)
    assert split_kv.window_union([0, 50], [20, 90], 64) == (0, 64)


def test_launch_planning_reads_no_device_tensor():
    """``mq_args`` of both wrappers on meta tensors (shapes without data:
    any read raises) give the planner's split count and workspace."""
    meta = torch.device("meta")
    B, S, Hq, Hkv, D, T = 4, 9, 32, 8, 128, 4224
    q = torch.empty((B, S, Hq, D), dtype=torch.bfloat16, device=meta)
    k = torch.empty((2, B, Hkv, T, D), dtype=torch.bfloat16, device=meta)[1]
    se = torch.empty((B, S), dtype=torch.int32, device=meta)
    out, ws, calls = da.mq_args(q, k, k, se[:, :1], se, 0.0, None, None, None)
    n_split = split_kv.plan_splits(B, Hkv, -(-T // split_kv.DENSE_TILE))
    # C order: q (4), k, v, k and v scales (4 each), starts, ends (3 each),
    # out (4), then the workspace and n_split.
    (args,) = calls
    assert n_split == 9 and args[30:32] == [ws.data_ptr(), 9]
    assert out.shape == q.shape and ws.numel() == 9 * B * Hkv * 36 * (D + 2)
    # B1 at the same shapes: q (3), k, v, scales (4 each), bounds (2), out
    # (3), then the workspace and n_split, planned at four blocks per SM.
    q1 = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=meta)
    bounds = torch.empty((B, 2), dtype=torch.int32, device=meta)
    out, ws, args = da.decode_args(q1, k, k, bounds, 0.0, None, None, None)
    assert args[24:26] == [ws.data_ptr(), 17] and out.shape == q1.shape
    assert ws.numel() == 17 * B * Hkv * 4 * (D + 2)

    n_pages, page, P = 1025, 64, 128
    q = torch.empty((8, S, Hq, D), dtype=torch.bfloat16, device=meta)
    kp = torch.empty((n_pages, Hkv, page, D), dtype=torch.int8, device=meta)
    sc = torch.empty((n_pages, Hkv, page, 1), dtype=torch.float32, device=meta)
    table = torch.empty((8, P), dtype=torch.int32, device=meta)
    se = torch.empty((8, S), dtype=torch.int32, device=meta)
    out, ws, (args,) = pa.mq_args(q, kp, kp, table, se, se, 50.0, None, sc, sc)
    assert out.shape == q.shape and ws.numel() == 5 * 8 * Hkv * 36 * (D + 2)
    assert args[32:34] == [ws.data_ptr(), 5]  # after the table's pointer and stride
    # B3 (int8 pages) at the batcher's shapes: after the table (2) and the
    # bounds (2) come out (3), then the workspace and n_split.
    q1 = torch.empty((8, Hq, D), dtype=torch.bfloat16, device=meta)
    bounds = torch.empty((8, 2), dtype=torch.int32, device=meta)
    out, ws, args = pa.decode_args(q1, kp, kp, table, bounds, 50.0, None, sc, sc)
    assert args[26:28] == [ws.data_ptr(), 9] and out.shape == q1.shape
    assert ws.numel() == 9 * 8 * Hkv * 4 * (D + 2)
    # One split when B * Hkv fills the card: no workspace, no combine.
    q = torch.empty((33, S, Hq, D), dtype=torch.bfloat16, device=meta)
    table = torch.empty((33, P), dtype=torch.int32, device=meta)
    se = torch.empty((33, S), dtype=torch.int32, device=meta)
    _, ws, (args,) = pa.mq_args(q, kp, kp, table, se, se, 0.0, None, sc, sc)
    assert ws is None and args[32:34] == [None, 1]
    q1 = torch.empty((66, Hq, D), dtype=torch.bfloat16, device=meta)
    table = torch.empty((66, P), dtype=torch.int32, device=meta)
    bounds = torch.empty((66, 2), dtype=torch.int32, device=meta)
    _, ws, args = pa.decode_args(q1, kp, kp, table, bounds, 0.0, None, sc, sc)
    assert ws is None and args[26:28] == [None, 1]


def test_launch_planning_cuts_long_spans_and_takes_any_page():
    """A bf16 span longer than the verify kernel's registers hold is one
    launch per run of positions: each run's q, starts, ends and output
    are slices of the span's (a [B, 1] start broadcasts to every run), its
    length is the launch's S, and the runs share one workspace. Pages of
    any size are taken (8 and 24 slots here)."""
    B, S, Hq, Hkv, D = 2, 33, 8, 2, 128  # CPU tensors: real pointers, never read
    q = torch.empty((B, S, Hq, D), dtype=torch.bfloat16)
    k = torch.empty((B, Hkv, 256, D), dtype=torch.bfloat16)
    se = torch.empty((B, S), dtype=torch.int32)
    s1 = torch.empty((B, 1), dtype=torch.int32)
    out, ws, calls = da.mq_args(q, k, k, s1, se, 0.0, None, None, None)
    assert len(calls) == 2 and ws.numel() == calls[0][31] * B * Hkv * 4 * 32 * (D + 2)
    for (s0, n), args in zip([(0, 32), (32, 1)], calls):
        assert args[0] == q[:, s0:].data_ptr() and args[32:34] == [B, n]  # q; B, S
        assert args[20:22] == [s1.data_ptr(), 1]  # [B, 1] starts, every run
        assert n == 1 or args[22] == 0  # broadcast over the run's positions
        assert args[23] == se[:, s0:].data_ptr()
        assert args[26] == out[:, s0:].data_ptr() and args[30] == ws.data_ptr()
    meta = torch.device("meta")
    # f32 q keeps its rows in shared memory: one launch.
    _, _, calls = da.mq_args(q.float(), k.float(), k.float(), se, se, 0.0, None, None, None)
    assert len(calls) == 1 and calls[0][33] == S
    for page in (8, 24):
        kp = torch.empty((9, Hkv, page, 64), device=meta)
        table = torch.empty((B, 4), dtype=torch.int32, device=meta)
        q = torch.empty((B, 3, Hq, 64), device=meta)
        se = torch.empty((B, 3), dtype=torch.int32, device=meta)
        _, _, calls = pa.mq_args(q, kp, kp, table, se, se, 0.0, None, None, None)
        assert len(calls) == 1 and calls[0][-5:-3] == [page, 64]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_span_runs_concatenated_equal_the_unsplit_plain(paged, dtype):
    """The runs of a long span, each through the plain verify with its
    slice of q, starts and ends, concatenate bit for bit to the unsplit
    plain version: each position attends only to its own window."""
    rng = np.random.default_rng(33)
    B, S, Hq, Hkv, D = 3, 40, 8, 2, 128
    q = _t(rng.standard_normal((B, S, Hq, D)).astype(np.float32)).to(dtype)
    ends = _t((np.array([150, 100, 160])[:, None] + np.arange(S) + 1).astype(np.int32))
    starts = _t(np.array([[0], [30], [5]], np.int32))
    if paged:
        page = 24
        k = _t(rng.standard_normal((12, Hkv, page, D)).astype(np.float32)).to(dtype)
        v = _t(rng.standard_normal((12, Hkv, page, D)).astype(np.float32)).to(dtype)
        table = _t(np.array([[3, 0, 5, 6, 7, 8, 9, 10, -1],
                             [11, 1, 2, 4, 9, -1, -1, -1, -1],
                             [6, 7, 8, 9, 10, 11, 1, 2, -1]], np.int32))

        def fn(qr, st, en):
            return pa.paged_decode_attention_mq_plain(qr, k, v, table, st, en, attn_softcap=30.0)
    else:
        k = _t(rng.standard_normal((B, Hkv, 208, D)).astype(np.float32)).to(dtype)
        v = _t(rng.standard_normal((B, Hkv, 208, D)).astype(np.float32)).to(dtype)

        def fn(qr, st, en):
            return da.decode_attention_mq_plain(qr, k, v, st, en, attn_softcap=30.0)

    runs = split_kv.span_runs(S, Hq // Hkv, D, torch.bfloat16)
    assert runs == [(0, 32), (32, 40)]
    for st in (starts, starts.expand(B, S).contiguous()):
        want = fn(q, st, ends)
        got = torch.cat([fn(q[:, s0:s1], st if st.shape[1] == 1 else st[:, s0:s1],
                            ends[:, s0:s1]) for s0, s1 in runs], dim=1)
        assert torch.equal(got, want)


# -- the plain mirror of the kernel's algorithm ---------------------------------


def mirror_mq(
    q, k, v, starts, ends, *, tile, n_split, softcap=0.0, table=None,
    k_scale=None, v_scale=None, fold=False, row_pad=16,
):
    """B2 (``table`` None: k, v [B, Hkv, T, D]) or B4 (k, v [n_pages, Hkv,
    page, D], ``tile`` = page) split and combined as the CUDA kernels do."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[1]
    g, R = Hq // Hkv, Hq // Hkv * S
    Rp = -(-R // row_pad) * row_pad
    T = table.shape[1] * k.shape[2] if table is not None else k.shape[2]
    scale = 1.0 / math.sqrt(D)
    st, en = starts.expand(B, S), ends.expand(B, S)
    out = torch.zeros((B, S, Hq, D))
    for b in range(B):
        lo_r = torch.full((Rp,), T, dtype=torch.long)  # pad rows: [T, 0)
        hi_r = torch.zeros((Rp,), dtype=torch.long)
        lo_r[:R] = st[b].repeat_interleave(g)
        hi_r[:R] = torch.clamp(en[b].repeat_interleave(g), max=T)
        lo, hi = split_kv.window_union(lo_r[:R].tolist(), hi_r[:R].tolist(), T)
        for h in range(Hkv):
            qh = torch.zeros((Rp, D))
            qh[:R] = q[b, :, h * g : (h + 1) * g].reshape(R, D).float()
            if not fold:
                qh = qh * scale
            parts = []
            for i in range(n_split):
                m = torch.full((Rp, 1), float("-inf"))
                l, acc = torch.zeros((Rp, 1)), torch.zeros((Rp, D))
                for ti in range(*split_kv.split_tiles(lo, hi, tile, n_split, i)):
                    t0 = ti * tile
                    slots = t0 + torch.arange(tile)
                    inside = ((slots >= lo) & (slots < hi))[:, None]
                    if table is not None:
                        pid = int(table[b, ti])
                        if pid <= 0:
                            continue  # trash page or padding: never loaded
                        idx = (pid, h)
                    else:
                        idx = (b, h, slice(t0, t0 + tile))

                    def stage(x, idx=idx, inside=inside):  # zero-filled copy
                        x = x[idx].float()
                        x = torch.cat([x, x.new_zeros(tile - x.shape[0], x.shape[1])])
                        return torch.where(inside, x, 0.0)

                    kt, vt = stage(k), stage(v)
                    kcol, vrow = None, None
                    if k_scale is not None:
                        ks, vs = stage(k_scale), stage(v_scale)
                        if fold:
                            kcol, vrow = ks.T, vs.T
                        else:
                            kt, vt = kt * ks, vt * vs
                    if fold:
                        kcol = (kcol if kcol is not None else torch.ones((1, tile))) * scale
                    m, l, acc = flash_update(
                        qh, kt, vt, t0, lo_r[:, None], hi_r[:, None], m, l, acc,
                        attn_softcap=softcap, k_col_scale=kcol, v_row_scale=vrow,
                    )
                parts.append((m, l, acc))
            o = combine_partials(*(torch.stack(x) for x in zip(*parts)))
            out[b, :, h * g : (h + 1) * g] = o[:R].reshape(S, g, D)
    return out.to(q.dtype)


def _dense_case(seed, B, S, Hq, Hkv, D, T, pads, cur, *, int8=False, bcast=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    ends = (np.asarray(cur)[:, None] + np.arange(S) + 1).astype(np.int32)
    starts = np.asarray(pads, np.int32)[:, None]
    if not bcast:
        starts = np.repeat(starts, S, axis=1)
    arrays = dict(q=q, k=k, v=v, starts=starts, ends=ends)
    if int8:
        for x in ("k", "v"):
            s = np.maximum(np.abs(arrays[x]).max(-1, keepdims=True), 1e-8) / 127.0
            arrays[x] = np.clip(np.round(arrays[x] / s), -127, 127).astype(np.int8)
            arrays[x + "_scale"] = s.astype(np.float32)
    return arrays


def _reference(fn, a, dtype, softcap, **kw):
    """The reference's Pallas kernel in interpret mode; q in ``dtype``."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = {key: jnp.asarray(x) for key, x in a.items()}
    for key in ("q", "k", "v"):
        if j[key].dtype != jnp.int8:
            j[key] = j[key].astype(jd)
    scales = {key: j[key] for key in ("k_scale", "v_scale") if key in j}
    args = [j["q"], j["k"], j["v"]] + ([j["table"]] if "table" in j else [])
    out = fn(*args, j["starts"], j["ends"], attn_softcap=softcap, interpret=True,
             **scales, **kw)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))


def _torch_inputs(a, dtype):
    t = {key: _t(x) for key, x in a.items()}
    for key in ("q", "k", "v"):
        if t[key].dtype != torch.int8:
            t[key] = t[key].to(dtype)
    return t


DENSE = {
    # name: (B, S, Hq, Hkv, D, T, pads, cur, softcap, options)
    "per_position_gqa": (3, 5, 8, 2, 64, 256, [0, 31, 7], [240, 128, 20], 0.0, {}),
    "softcap_gemma2": (2, 3, 8, 2, 64, 256, [0, 100], [200, 150], 50.0, {}),
    "broadcast_starts": (3, 9, 8, 2, 64, 256, [2, 40, 0], [200, 60, 9], 0.0,
                         dict(bcast=True)),
    "empty_row": (2, 4, 8, 2, 64, 128, [0, 90], [70, 80], 0.0, dict(empty=1)),
    "d128_one_tile_union": (2, 3, 4, 2, 128, 128, [64, 70], [66, 100], 0.0, {}),
    "int8": (3, 9, 8, 2, 64, 256, [0, 31, 7], [240, 128, 20], 30.0, dict(int8=True)),
}


def _dense_inputs(name):
    B, S, Hq, Hkv, D, T, pads, cur, cap, opt = DENSE[name]
    opt = dict(opt)
    empty = opt.pop("empty", None)
    a = _dense_case(len(name), B, S, Hq, Hkv, D, T, pads, cur, **opt)
    if empty is not None:
        a["starts"][empty] = a["ends"][empty]  # every window of that row empty
    return a, cap, empty


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_mirror_matches_unsplit_plain_for_every_split_count(name):
    a, cap, empty = _dense_inputs(name)
    t = _torch_inputs(a, torch.float32)
    sc = {key: t[key] for key in ("k_scale", "v_scale") if key in t}
    want = da.decode_attention_mq_plain(
        t["q"], t["k"], t["v"], t["starts"], t["ends"], attn_softcap=cap, **sc
    )
    T = t["k"].shape[2]
    for n_split in (1, 2, 3, 5, T // 64 + 3):  # past the union's tile count
        got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=64,
                        n_split=n_split, softcap=cap, **sc)
        torch.testing.assert_close(got, want, **F32)
        if empty is not None:
            assert (got[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_mirror_matches_reference_kernel(name, dtype):
    """f32: the f32 kernel's order within 2e-5; bf16 inputs: the bf16
    kernel's (scale, and an int8 cache's scales, folded into the score
    column and p) within the bf16 tolerance."""
    a, cap, empty = _dense_inputs(name)
    ref = _reference(pallas_decode.decode_attention_mq, a, dtype, cap)
    t = _torch_inputs(a, dtype)
    sc = {key: t[key] for key in ("k_scale", "v_scale") if key in t}
    fold = dtype == torch.bfloat16
    for n_split in (1, 4):
        got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=32,
                        n_split=n_split, softcap=cap, fold=fold, **sc)
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref, **(BF16 if fold else F32))
        if empty is not None:
            assert (got[empty] == 0).all()


def test_dense_mirror_ragged_tail_past_t():
    """T = 300 is no multiple of the 64-slot tile: the last tile's slots
    past T are zero-filled and masked."""
    a = _dense_case(11, 2, 9, 8, 2, 64, 300, [3, 90], [291, 150])
    t = _torch_inputs(a, torch.float32)
    want = da.decode_attention_mq_plain(t["q"], t["k"], t["v"], t["starts"], t["ends"],
                                        attn_softcap=30.0)
    for n_split in (1, 2, 7):
        got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=64,
                        n_split=n_split, softcap=30.0)
        torch.testing.assert_close(got, want, **F32)


def test_pad_rows_do_not_change_the_union_or_the_rows():
    """The bf16 kernel pads R = g*S query rows to a multiple of 16 with the
    empty window [T, 0): the output is that of unpadded rows."""
    a, cap, _ = _dense_inputs("per_position_gqa")
    t = _torch_inputs(a, torch.float32)
    kw = dict(tile=64, n_split=3, softcap=cap)
    args = (t["q"], t["k"], t["v"], t["starts"], t["ends"])
    torch.testing.assert_close(mirror_mq(*args, row_pad=16, **kw),
                               mirror_mq(*args, row_pad=1, **kw), rtol=0, atol=0)


def test_p_enters_pv_as_two_bf16_terms():
    """Why the bf16 kernel splits p into hi + lo bf16 terms: one bf16
    rounding of p moves outputs near zero past the bf16 tolerance; the two
    terms keep every output within it."""
    torch.manual_seed(0)
    B, Hkv, R, D, T = 2, 2, 36, 128, 2048
    q = torch.randn(B, Hkv, R, D).bfloat16().float() / math.sqrt(D)
    k = torch.randn(B, Hkv, T, D).bfloat16().float()
    v = torch.randn(B, Hkv, T, D).bfloat16().float()
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    want = (p @ v).bfloat16().float()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def past_tolerance(got):
        return int((got.bfloat16().float() - want).abs().gt(1e-5 + 1.6e-2 * want.abs()).sum())

    assert past_tolerance(hi @ v) > 0
    assert past_tolerance(hi @ v + lo @ v) == 0


# -- paged ------------------------------------------------------------------------

PAGED = {
    # Scattered pages, -1 padding, a trash (0) entry inside row 0's window.
    "trash_and_padding": dict(table=[[3, 0, 5, -1], [7, 2, 9, 11], [4, -1, -1, -1]],
                              starts=[[1], [5], [0]], ends=[36, 59, 9], cap=0.0),
    # Per-position ends inside one tile, softcap, a row of empty windows.
    "empty_row_softcap": dict(table=[[1, 2, 3, 4], [5, 6, -1, -1], [8, -1, -1, -1]],
                              starts=[[0], [17], [9]], ends=[50, 20, 9], cap=50.0,
                              empty=2),
    # A one-page union: fewer tiles than any split count above 1.
    "one_page_union": dict(table=[[6, 7, 8, 9], [10, -1, -1, -1]],
                           starts=[[20], [3]], ends=[25, 8], cap=0.0),
}


def _paged_inputs(name, int8=False, S=5):
    c = PAGED[name]
    rng = np.random.default_rng(len(name))
    table = np.asarray(c["table"], np.int32)
    B = table.shape[0]
    n_pages, Hkv, page, D, Hq = 12, 2, 16, 64, 8
    kp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    unused = [p for p in range(n_pages) if p not in set(table.ravel().tolist()) or p == 0]
    ends = (np.asarray(c["ends"])[:, None] + np.arange(S)).astype(np.int32)
    starts = np.repeat(np.asarray(c["starts"], np.int32), S, axis=1)
    if c.get("empty") is not None:
        starts[c["empty"]] = ends[c["empty"]]
    a = dict(q=rng.standard_normal((B, S, Hq, D)).astype(np.float32), k=kp, v=vp,
             table=table, starts=starts, ends=ends)
    if int8:
        for x in ("k", "v"):
            s = np.maximum(np.abs(a[x]).max(-1, keepdims=True), 1e-8) / 127.0
            a[x] = np.clip(np.round(a[x] / s), -127, 127).astype(np.int8)
            a[x][unused] = -128
            s[unused] = np.nan  # a poisoned trash page and unused scale pages
            a[x + "_scale"] = s.astype(np.float32)
    else:
        a["k"][unused] = np.nan  # the trash page and unused pages poisoned
        a["v"][unused] = np.nan
    return a, c["cap"], c.get("empty")


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_mirror_matches_unsplit_plain_for_every_split_count(name, int8):
    a, cap, empty = _paged_inputs(name, int8)
    t = _torch_inputs(a, torch.float32)
    sc = {key: t[key] for key in ("k_scale", "v_scale") if key in t}
    want = pa.paged_decode_attention_mq_plain(
        t["q"], t["k"], t["v"], t["table"], t["starts"], t["ends"], attn_softcap=cap, **sc
    )
    for n_split in range(1, 7):  # up to past the four-page table
        got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=16,
                        n_split=n_split, softcap=cap, table=t["table"], **sc)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **F32)
        if empty is not None:
            assert (got[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_mirror_matches_reference_kernel(name, int8, dtype):
    a, cap, empty = _paged_inputs(name, int8)
    ref = _reference(pallas_paged.paged_decode_attention_mq, a, dtype, cap)
    assert torch.isfinite(ref).all()
    t = _torch_inputs(a, dtype)
    sc = {key: t[key] for key in ("k_scale", "v_scale") if key in t}
    fold = dtype == torch.bfloat16
    for n_split in (1, 3):
        got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=16,
                        n_split=n_split, softcap=cap, table=t["table"], fold=fold, **sc)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref, **(BF16 if fold else F32))
        if empty is not None:
            assert (got[empty] == 0).all()


def test_paged_mirror_at_one_position_matches_b3():
    """B4 over one position runs the split kernel, B3 the S = 1 body: they
    agree within the f32 tolerance (no longer bit for bit on the card)."""
    a, cap, _ = _paged_inputs("trash_and_padding", int8=True, S=1)
    t = _torch_inputs(a, torch.float32)
    sc = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
    bounds = torch.cat([t["starts"], t["ends"]], dim=1)
    b3 = pa.paged_decode_attention_plain(t["q"][:, 0], t["k"], t["v"], t["table"], bounds,
                                         attn_softcap=cap, **sc)
    got = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=16, n_split=2,
                    softcap=cap, table=t["table"], **sc)
    torch.testing.assert_close(got[:, 0], b3, **F32)


def test_combine_partials_edges():
    """A split that saw nothing weighs 0; a row no split saw gives exact
    zeros; one split is its own normalized output."""
    m = torch.tensor([[[0.5]], [[float("-inf")]], [[2.0]]])  # [3 splits, 1 row, 1]
    l = torch.tensor([[[2.0]], [[0.0]], [[1.0]]])
    acc = torch.tensor([[[1.0, 2.0]], [[0.0, 0.0]], [[3.0, -1.0]]])
    w = torch.exp(torch.tensor([0.5 - 2.0, 0.0]))
    want = (w[0] * acc[0] + w[1] * acc[2]) / (w[0] * 2.0 + w[1] * 1.0)
    torch.testing.assert_close(combine_partials(m, l, acc), want, rtol=1e-6, atol=0)
    empty = combine_partials(torch.full((4, 2, 1), float("-inf")), torch.zeros((4, 2, 1)),
                             torch.zeros((4, 2, 3)))
    assert (empty == 0).all() and not torch.isnan(empty).any()
    torch.testing.assert_close(combine_partials(m[:1], l[:1], acc[:1]), acc[0] / 2.0)


# -- the S=1 kernels (B1 dense, B3 paged) ------------------------------------------


def mirror_s1(q, k, v, bounds, *, tile, n_split, softcap=0.0, table=None,
              k_scale=None, v_scale=None):
    """B1 (``table`` None: k, v [B, Hkv, T, D]) or B3 (k, v [n_pages, Hkv,
    page, D]) split and combined as ``csrc/decode_attention.cu`` does:
    per (row, KV head) the row's window clipped to [0, T), its ``tile``-slot
    tiles (aligned in slot space) cut into ``n_split`` runs; a slot outside
    the window or in a page with id <= 0 is never loaded (zero) and
    masked; a tile with no such slot left is skipped."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    if table is not None:
        page = k.shape[2]
        T = table.shape[1] * page
    else:
        T = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros((B, Hq, D))
    for b in range(B):
        lo, hi = max(int(bounds[b, 0]), 0), min(int(bounds[b, 1]), T)
        lo_t, hi_t = torch.full((g, 1), lo), torch.full((g, 1), hi)
        for h in range(Hkv):
            qh = q[b, h * g : (h + 1) * g].float() * scale
            parts = []
            for i in range(n_split):
                m = torch.full((g, 1), float("-inf"))
                l, acc = torch.zeros((g, 1)), torch.zeros((g, D))
                for ti in range(*split_kv.split_tiles(lo, hi, tile, n_split, i)):
                    slots = ti * tile + torch.arange(tile)
                    ok = (slots >= lo) & (slots < hi)
                    if table is not None:
                        pid = table[b, torch.clamp(slots // page, max=table.shape[1] - 1)]
                        ok = ok & (pid > 0)
                        idx = (torch.clamp(pid, min=0).long(), h, slots % page)
                    else:
                        idx = (b, h, torch.clamp(slots, max=T - 1))
                    if not ok.any():
                        continue  # nothing of the tile is scored: skipped

                    def stage(x, scales, idx=idx, ok=ok):  # zero-filled copy
                        x = x[idx].float()
                        if scales is not None:
                            x = x * scales[idx].float()
                        return torch.where(ok[:, None], x, 0.0)

                    m, l, acc = flash_update(
                        qh, stage(k, k_scale), stage(v, v_scale), ti * tile, lo_t, hi_t,
                        m, l, acc, attn_softcap=softcap, valid=ok[None, :],
                    )
                parts.append((m, l, acc))
            out[b, h * g : (h + 1) * g] = combine_partials(*(torch.stack(x) for x in zip(*parts)))
    return out.to(q.dtype)


def _int8_np(x, unused=None):
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    x8 = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    s = s.astype(np.float32)
    if unused is not None:
        x8[unused] = -128
        s[unused] = np.nan  # a poisoned trash page and unused scale pages
    return x8, s


def _s1_reference(fn, a, dtype, softcap):
    """The reference's Pallas B1 or B3 in interpret mode; q (and a float
    cache) in ``dtype``."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = {key: jnp.asarray(x) for key, x in a.items()}
    for key in ("q", "k", "v"):
        if j[key].dtype != jnp.int8:
            j[key] = j[key].astype(jd)
    scales = {key: j[key] for key in ("k_scale", "v_scale") if key in j}
    args = [j["q"], j["k"], j["v"]] + ([j["table"]] if "table" in j else [])
    out = fn(*args, j["bounds"], attn_softcap=softcap, interpret=True, **scales)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))


def _s1_check(a, dtype, softcap, ref, tile, empty, table=None):
    """The mirror for every split count from 1 to past the tile count,
    against the reference (f32 at 2e-5, bf16 at the bf16 tolerance) and,
    in f32, against the unsplit plain version."""
    t = _torch_inputs(a, dtype)
    sc = {key: t[key] for key in ("k_scale", "v_scale") if key in t}
    T = t["table"].shape[1] * t["k"].shape[2] if table else t["k"].shape[2]
    if table:
        plain = pa.paged_decode_attention_plain(t["q"], t["k"], t["v"], t["table"], t["bounds"],
                                                attn_softcap=softcap, **sc)
    else:
        plain = da.decode_attention_plain(t["q"], t["k"], t["v"], t["bounds"],
                                          attn_softcap=softcap, **sc)
    tol = F32 if dtype == torch.float32 else BF16
    for n_split in range(1, -(-T // tile) + 2):
        got = mirror_s1(t["q"], t["k"], t["v"], t["bounds"], tile=tile, n_split=n_split,
                        softcap=softcap, table=t.get("table"), **sc)
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref, **tol)
        if dtype == torch.float32:
            torch.testing.assert_close(got, plain, **F32)
        assert (got[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_s1_dense_mirror_matches_reference_kernel(kv, dtype):
    """B1's split-and-combine against the Pallas B1: left pads, a single
    slot, an empty window, a ragged tail (T = 264 is no multiple of the
    tile), softcap; the tile is the kernel's own for this cache type."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D, T = 4, 8, 2, 64, 264
    a = dict(q=rng.standard_normal((B, Hq, D)).astype(np.float32),
             k=rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
             v=rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
             bounds=np.array([[0, 264], [37, 250], [100, 101], [80, 80]], np.int32))
    if kv == "int8":
        a["k"], a["k_scale"] = _int8_np(a["k"])
        a["v"], a["v_scale"] = _int8_np(a["v"])
    itemsize = 1 if kv == "int8" else dtype.itemsize
    ref = _s1_reference(pallas_decode.decode_attention, a, dtype, 30.0)
    _s1_check(a, dtype, 30.0, ref, split_kv.decode_tile(D, itemsize), empty=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("page", [1, 8, 16, 24, 64])
def test_s1_paged_mirror_matches_reference_kernel(page, kv, dtype):
    """B3's split-and-combine against the Pallas B3: scattered pages, -1
    padding, a trash (0) entry inside a window, the trash page and unused
    pages poisoned (NaN, or int8 -128 beside NaN scales), an empty window,
    a window ending mid-tile; tiles of the kernel's 16 KB hold part of a
    page, one page or several."""
    rng = np.random.default_rng(page)
    B, Hq, Hkv, D, T = 3, 8, 2, 64, 192
    P = T // page
    n_pages = 2 * P + 4
    ids = list(rng.permutation(np.arange(1, n_pages))[: 2 * P])
    table = np.full((B, P), -1, np.int32)
    table[0] = ids[:P]
    table[1, : P // 2 + 1] = ids[P : P + P // 2 + 1]
    table[0, min(P - 1, 100 // page)] = 0  # a trash entry inside row 0's window
    table[2, 0] = ids[-1]
    bounds = np.array([[3, 190], [10, min(T, (P // 2 + 1) * page) - 1], [0, 0]], np.int32)
    used = set(table.ravel().tolist())
    unused = [p for p in range(n_pages) if p not in used or p == 0]
    a = dict(q=rng.standard_normal((B, Hq, D)).astype(np.float32),
             k=rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32),
             v=rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32),
             table=table, bounds=bounds)
    if kv == "int8":
        a["k"], a["k_scale"] = _int8_np(a["k"], unused)
        a["v"], a["v_scale"] = _int8_np(a["v"], unused)
    else:
        a["k"][unused] = np.nan
        a["v"][unused] = np.nan
    itemsize = 1 if kv == "int8" else dtype.itemsize
    ref = _s1_reference(pallas_paged.paged_decode_attention, a, dtype, 0.0)
    assert torch.isfinite(ref).all()
    _s1_check(a, dtype, 0.0, ref, split_kv.decode_tile(D, itemsize), empty=2, table=True)


def test_s1_mirror_agrees_with_the_verify_mirror_at_one_position():
    """B4 at S = 1 (one page per tile, the bf16-kernel fold) and B3 (16 KB
    tiles in slot space) split differently; both fold to the same
    attention within the f32 tolerance."""
    a, cap, _ = _paged_inputs("trash_and_padding", int8=True, S=1)
    t = _torch_inputs(a, torch.float32)
    sc = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
    bounds = torch.cat([t["starts"], t["ends"]], dim=1)
    b4 = mirror_mq(t["q"], t["k"], t["v"], t["starts"], t["ends"], tile=16, n_split=2,
                   softcap=cap, table=t["table"], **sc)[:, 0]
    for n_split in (1, 3):
        b3 = mirror_s1(t["q"][:, 0], t["k"], t["v"], bounds, tile=32, n_split=n_split,
                       softcap=cap, table=t["table"], **sc)
        torch.testing.assert_close(b3, b4, **F32)
