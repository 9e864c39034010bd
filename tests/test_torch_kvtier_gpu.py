"""The batcher's KV-tier swaps on the card: demotion into the pinned
arena, promotion back into the pool.

On a CUDA card a demoted block copies device->host with ``non_blocking``
into a slot of the batcher's pinned ``DemotionArena`` behind a CUDA
event, and a promoted run copies host->device into one staging tensor
before one pool scatter; on the CPU both are plain tensor copies. These
tests need the card (pinned memory has no CPU mode): each is marked
``gpu`` and skips without one. The file imports no jax:

    python -m pytest tests/test_torch_kvtier_gpu.py -q -m gpu

Tolerances are exact: the same f32 weights give the same greedy tokens,
counters and bytes on the card as on the CPU.
"""

import gc

import pytest
import torch

from adversarial_spec_tpu_torch.engine import kvtier, prefix_cache, spec
from adversarial_spec_tpu_torch.engine.scheduler import ContinuousBatcher, SchedRequest
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.models.transformer import init_params, map_params

PROMPT = [((i * 7) % 400) + 3 for i in range(96)]
PAGE = 16


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the demotion arena is pinned host memory)")
    for cfg, fields in (
        (kvtier.config(), ("enabled", "host_mb", "store_dir", "flush_blocks")),
        (prefix_cache.config(), ("enabled", "max_pages")),
        (spec.config(), ("enabled",)),
    ):
        for f in fields:
            monkeypatch.setattr(cfg, f, getattr(cfg, f))
    spec.configure(enabled=False)
    kvtier.configure(enabled=True, host_mb=16, store_dir="")
    prefix_cache.configure(enabled=True, max_pages=3)
    return torch.device("cuda")


def _rounds(params, cfg, kv_dtype):
    """Two rounds of a growing two-request prompt through one batcher
    whose prefix cache keeps 3 pages, so the rest demotes and promotes:
    per round the tokens, cached tokens and prefilled tokens, then the
    tier counters (walls aside) and the batcher."""
    kvtier.reset_stats()
    b = ContinuousBatcher(params, cfg, max_batch=2, max_new_cap=8, page_size=PAGE,
                          prefix_cache=True, kv_dtype=kv_dtype)
    doc, out = list(PROMPT), []
    for r in range(2):
        before = prefix_cache.stats.prefilled_tokens
        for i in range(2):
            b.submit(SchedRequest(req_id=i, prompt_ids=list(doc), max_new_tokens=8))
        res = b.run_all()
        out.append(([x.tokens.tolist() for x in res], [x.cached_tokens for x in res],
                    prefix_cache.stats.prefilled_tokens - before))
        doc = doc + [((r * 13 + k) % 400) + 3 for k in range(16)]
        b.allocator.check_invariants()
        b.tiers.check_invariants()
    snap = kvtier.snapshot()
    for f in ("swap_in_s", "swap_out_s"):
        snap.pop(f)
    return out, snap, b


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8kv"])
def test_arena_round_matches_cpu(cuda, kv_dtype):
    """A tiered round on the card gives the CPU's tokens, cached and
    prefilled tokens and tier counters, every demotion taken from the
    arena; a fetched payload is the page as it was when fetched, though
    the pool is rewritten right after; dropping it returns its slot."""
    cfg = get_config("llama", "tiny", max_seq_len=1024)
    params = init_params(cfg, device=torch.device("cpu"), dtype=torch.float32, seed=0)
    want, want_snap, _ = _rounds(params, cfg, kv_dtype)
    assert want_snap["demoted_blocks"] > 0 and want_snap["promoted_tokens"] > 0
    got, snap, b = _rounds(map_params(lambda t: t.to(cuda), params), cfg, kv_dtype)
    assert got == want
    assert snap == want_snap
    arena = b._arena
    assert arena is not None and arena.nbytes > 0 and arena.fresh == 0
    free = len(arena._free)
    page = next(iter(b.prefix_cache._by_page))
    fetch = b._fetch_page_kv(page, PAGE)
    assert len(arena._free) == free - 1
    want_kv = {k: v[:, page + 1, :, :PAGE].unsqueeze(1).cpu() for k, v in b.pool.items()}
    for v in b.pool.values():
        v[:, page + 1] = 0
    got_kv = fetch()
    assert set(got_kv) == set(want_kv)
    for k in want_kv:
        assert got_kv[k].is_pinned() and torch.equal(got_kv[k], want_kv[k]), k
    del fetch, got_kv
    gc.collect()
    assert len(arena._free) == free
