"""Host-side planning of the split-KV attention kernels (B1-B4).

``csrc/verify_attention.cu`` (B2, B4) and ``csrc/decode_attention.cu``
(B1, B3) run on a ``(n_split, heads, B)`` grid: each block finds its (row,
KV head)'s window (the verify kernels: the union of the span's windows) on
the card, cuts its tiles into ``n_split`` near-equal contiguous runs and
takes one; a second kernel merges the runs' f32 partials. The host picks
``n_split`` from shapes alone — it never reads ``bounds``, ``starts``,
``ends`` or the page table, which would cost a blocking device-to-host
copy per layer and keep the call out of a CUDA graph.

``split_tiles`` and ``window_union`` mirror the kernels' own arithmetic
(``csrc/split_kv.cuh`` ``split_run``) for the tests
(``tests/test_torch_split_kv.py``), which fold a plain split-and-combine
through ``ops/flash_common.py`` with them.
"""

from __future__ import annotations

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM
# Blocks of the bf16 verify kernel one SM holds at once: 128 registers a
# thread (its launch bound) and ~108 KB of shared memory each.
BLOCKS_PER_SM = 2
DENSE_TILE = 64  # the dense verify's largest tile, in cache slots
MAX_ACC = 16384  # bf16 q: padded rows x head_dim held in registers
ROW_PAD = 16  # bf16 q: query rows are padded to a multiple of the mma's 16
# The S=1 kernel (B1, B3): 128 threads at most 128 registers each (its
# launch bound) and ~49-52 KB of shared memory (a 3-stage ring of 16 KB
# K/V tiles), so one SM holds four blocks.
DECODE_BLOCKS_PER_SM = 4
DECODE_STAGE_BYTES = 16384  # K + V bytes of one staged tile
DECODE_GROUP = 4  # query rows a block holds; larger groups take more blocks


def plan_splits(
    B: int, Hkv: int, n_tiles: int, slots: int = SMS * BLOCKS_PER_SM
) -> int:
    """The least ``n_split`` for which ``n_split * B * Hkv`` blocks fill the
    card's ``slots`` resident-block slots, capped by the ``n_tiles`` tiles a
    row can have (and at least 1). ``slots`` is SMs times the blocks of
    the kernel at hand one SM holds: ``BLOCKS_PER_SM`` for the verify
    kernels, ``DECODE_BLOCKS_PER_SM`` for the S=1 kernel. A block streams
    its run of tiles with little else in flight to hide its latency, so
    every block an SM can hold is filled (``chip_smoke.py`` times B1-B4
    over a range of split counts beside this plan)."""
    return max(1, min(-(-slots // (B * Hkv)), n_tiles))


def decode_tile(D: int, kv_itemsize: int) -> int:
    """Slots of one staged tile of the S=1 kernel: 16 KB of K and V rows
    (32 at bf16 D=128, 64 for an int8 cache). Tiles are aligned in slot
    space, for the dense cache and the paged pool alike."""
    return DECODE_STAGE_BYTES // (2 * D * kv_itemsize)


def decode_splits(B: int, Hkv: int, g: int, T: int, D: int, kv_itemsize: int) -> int:
    """B1/B3's ``n_split`` for a ``T``-slot cache: ``plan_splits`` over the
    ``Hkv * ceil(g / DECODE_GROUP)`` blocks of each row, at the S=1
    kernel's own blocks per SM."""
    return plan_splits(
        B,
        Hkv * -(-g // DECODE_GROUP),
        -(-T // decode_tile(D, kv_itemsize)),
        slots=SMS * DECODE_BLOCKS_PER_SM,
    )


def window_union(starts, ends, T: int) -> tuple[int, int]:
    """The union ``[lo, hi)`` of a block's non-empty windows clipped to
    ``[0, T)``, or ``(T, 0)`` when every window is empty."""
    spans = [(max(s, 0), min(e, T)) for s, e in zip(starts, ends)]
    spans = [(s, e) for s, e in spans if s < e]
    if not spans:
        return T, 0
    return min(s for s, _ in spans), max(e for _, e in spans)


def split_tiles(lo: int, hi: int, tile: int, n_split: int, i: int) -> tuple[int, int]:
    """Split ``i``'s run ``[a, b)`` of tile indices: the union's tiles
    ``lo // tile .. ceil(hi / tile)`` cut into ``n_split`` contiguous runs
    whose lengths differ by at most one (empty when the union has fewer
    tiles than splits, or is empty)."""
    first, n = (lo // tile, -(-hi // tile) - lo // tile) if lo < hi else (0, 0)
    return first + i * n // n_split, first + (i + 1) * n // n_split


def span_runs(
    S: int, g: int, D: int, dtype: torch.dtype, max_rows: int | None = None
) -> list[tuple[int, int]]:
    """The runs ``[s0, s1)`` of span positions the verify kernel takes one
    launch each; each position attends only to its own window, so the
    runs' outputs are the span's. bf16 q keeps its query rows, padded to
    ``ROW_PAD``, times ``D`` in registers (at most ``MAX_ACC``), so a
    longer span is cut into runs of as many positions as fit. f32 q keeps
    its rows in shared memory beside a tile: ``max_rows`` is the most the
    kernel holds (its C entry ``advspec_verify_max_rows``, read by the
    wrappers for a CUDA tensor), and runs are ``max_rows // g`` positions;
    without it (a CPU or meta tensor) the span is one run."""
    if dtype == torch.bfloat16:
        limit = MAX_ACC // D // ROW_PAD * ROW_PAD
    elif max_rows is None:
        return [(0, S)]
    else:
        limit = max_rows
    per = limit // g
    if per == 0:
        raise ValueError(
            f"the verify kernel holds at most {limit} query rows per KV head "
            f"at head_dim {D} in {str(dtype).split('.')[-1]}; got {g} query heads "
            "per KV head"
        )
    return [(s0, min(s0 + per, S)) for s0 in range(0, S, per)]


def workspace(
    n_split: int, B: int, Hkv: int, R: int, D: int, device
) -> torch.Tensor | None:
    """The f32 partials of ``n_split > 1`` splits (acc, then m and l),
    uninitialized: every element is written before it is read."""
    if n_split == 1:
        return None
    return torch.empty(
        n_split * B * Hkv * R * (D + 2), dtype=torch.float32, device=device
    )
