"""Random K/V inputs for holding the attention kernels against their plain
versions on the card.

``chip_smoke.py`` (phase ``kernels``) and ``tests/test_torch_kernels_gpu.py``
build their edge cases from these helpers, so both check the same layouts:

- ``int8_kv``: the int8 cache's symmetric per-(slot, head) quantization;
- ``kv_pair``: a float K/V pair in q's dtype, or int8 beside its scales;
- ``poisoned_pages``: a three-row page table over a pool whose trash page
  and unused pages are poisoned (NaN, or int8 -128 beside NaN scales), so
  a kernel that reads a page it must skip shows it in its output.
"""

from __future__ import annotations

import torch


def int8_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(slot, head) int8 of ``x`` [..., D]: (int8, f32 [..., 1])."""
    s = x.float().abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8), s


def kv_pair(kf: torch.Tensor, vf: torch.Tensor, dtype: torch.dtype, kv: str):
    """(k, v, scales): ``kf``/``vf`` in ``dtype`` (a float cache, no scales),
    or int8 with their f32 scales as ``k_scale``/``v_scale`` (``kv="int8"``)."""
    if kv == "int8":
        (k, ks), (v, vs) = int8_kv(kf), int8_kv(vf)
        return k, v, dict(k_scale=ks, v_scale=vs)
    return kf.to(dtype), vf.to(dtype), {}


def poisoned_pages(gen, dev, page: int, D: int, dtype: torch.dtype, kv: str, T: int = 384):
    """Three rows through a [3, T / page] table over layer 1 of a two-layer
    [2, n_pages, 2, page, D] pool: row 0 maps every page but one trash (0)
    entry inside its window, row 1 half its pages then -1 padding, row 2
    one page and an empty window. The trash page and every unused page
    are poisoned. Returns (k_pages, v_pages, scales, table, bounds), the
    last two int32 on ``dev``."""
    P = T // page
    n_pages = 2 * P + 4
    order = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(page))
    ids = (order + 1).tolist()
    table = torch.full((3, P), -1, dtype=torch.int32)
    table[0] = torch.tensor(ids[:P], dtype=torch.int32)
    table[0, min(P - 1, 200 // page)] = 0
    half = P // 2 + 1
    table[1, :half] = torch.tensor(ids[P : P + half], dtype=torch.int32)
    table[2, 0] = ids[-1]
    shape = (2, n_pages, 2, page, D)
    kf = torch.randn(shape, generator=gen, device=dev)[1]
    vf = torch.randn(shape, generator=gen, device=dev)[1]
    kp, vp, sc = kv_pair(kf, vf, dtype, kv)
    used = set(table.flatten().tolist())
    poisoned = [p for p in range(n_pages) if p not in used or p == 0]
    kp[poisoned] = vp[poisoned] = -128 if kv == "int8" else float("nan")
    for x in sc.values():
        x[poisoned] = float("nan")
    bounds = torch.tensor([[3, T - 5], [10, half * page - 1], [0, 0]], dtype=torch.int32)
    return kp, vp, sc, table.to(dev), bounds.to(dev)
