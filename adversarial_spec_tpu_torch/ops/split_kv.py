"""Host-side planning of the split-KV verify kernels (B2, B4).

``csrc/verify_attention.cu`` runs the speculative verify on a
``(n_split, Hkv, B)`` grid: each block finds the union of its (row, KV
head)'s windows on the card, cuts the union's tiles into ``n_split``
near-equal contiguous runs and takes one; a second kernel merges the
runs' f32 partials. The host picks ``n_split`` from shapes alone — it
never reads ``starts``, ``ends`` or the page table, which would cost a
blocking device-to-host copy per layer.

``split_tiles`` and ``window_union`` mirror the kernel's own arithmetic
for the tests (``tests/test_torch_split_kv.py``), which fold a plain
split-and-combine through ``ops/flash_common.py`` with them.
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


def plan_splits(
    B: int, Hkv: int, n_tiles: int, slots: int = SMS * BLOCKS_PER_SM
) -> int:
    """The least ``n_split`` for which ``n_split * B * Hkv`` blocks fill the
    card's ``slots`` resident-block slots, capped by the ``n_tiles`` tiles a
    row can have (and at least 1). A block streams its run of tiles with
    little else in flight to hide its latency, so both blocks an SM can
    hold are filled (``chip_smoke.py`` times B2 and B4 over a range of
    split counts beside this plan)."""
    return max(1, min(-(-slots // (B * Hkv)), n_tiles))


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


def check_rows(R: int, D: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel holds ``R`` query rows per KV head (``g *
    S``): with bf16 q the padded rows times ``D`` live in registers."""
    if dtype == torch.bfloat16 and -(-R // ROW_PAD) * ROW_PAD * D > MAX_ACC:
        raise ValueError(
            f"the verify kernel takes at most {MAX_ACC // D} query rows per KV "
            f"head (g * S) at head_dim {D} in bfloat16, got {R}"
        )


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
