"""The port's paged serving path against the reference's, on the same
(bridged) weights.

- ``forward_paged_decode``: logits and the written pool equal to the
  reference's (its gather path, which is what both packages run on the
  CPU) at S=1 and at the verify span S=γ+1, for llama and for gemma2
  (softcap, alternating sliding window).
- The write-target lookups clamp a slot past the page table exactly as
  the reference's JAX indexing does.
- ``ContinuousBatcher``: greedy tokens IDENTICAL to the reference's
  batcher in f32 for five requests through two slots (queueing, slot
  reuse, per-request budgets, an EOS), speculation on and off, then a
  second round on the same batcher whose prompts extend the first
  round's (prefix-cache hits: the same ``cached_tokens``), and a
  streaming consumer that cancels mid-decode (the same deliveries, and a
  partial transcript equal to the blocking prefix). The allocator's
  invariants hold after every drain.

f32 because there the reference's CPU attention (gather + plain XLA) and
the port's agree to ~1e-6, far from any argmax near-tie of these models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import interleave as jax_interleave
from adversarial_spec_tpu.engine import kvtier as jax_kvtier
from adversarial_spec_tpu.engine import prefix_cache as jax_prefix
from adversarial_spec_tpu.engine import scheduler as jax_sched
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_config
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import scheduler as sched
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models import transformer as tf
from adversarial_spec_tpu_torch.models.config import get_config

PROMPTS = [(3, 8), (70, 20), (150, 12), (9, 30), (33, 17)]  # (length, budget)
EXTRA = 21  # round 2 appends this many tokens to each round-1 prompt
GAMMA = 8


@pytest.fixture(scope="module", autouse=True)
def _reference_defaults():
    """Both batchers read process-wide knobs at construction (prefix-cache
    cap, KV tiers, drive loop) that other test files of the same worker
    may have moved: pin the defaults for this module, the KV tiers off in
    both packages (their parity is tests/test_torch_kv_tier.py's)."""
    saved = [
        (cfg, {f: getattr(cfg, f) for f in fields})
        for cfg, fields in (
            (jax_prefix.config(), ("enabled", "max_pages")),
            (jax_kvtier.config(), ("enabled",)),
            (jax_interleave.config(), ("enabled", "pipeline_depth")),
            (port_prefix.config(), ("enabled", "max_pages")),
            (port_kvtier.config(), ("enabled",)),
            (port_interleave.config(), ("enabled",)),
        )
    ]
    jax_prefix.configure(enabled=True, max_pages=0)
    jax_kvtier.configure(enabled=False)
    jax_interleave.configure(enabled=True, pipeline_depth=2)
    port_prefix.configure(enabled=True, max_pages=0)
    port_kvtier.configure(enabled=False)
    port_interleave.configure(enabled=True)
    yield
    for cfg, values in saved:
        for f, v in values.items():
            setattr(cfg, f, v)


def _bridge(family: str, seed: int = 0):
    cfg = jax_config(family, "tiny")
    params = jax_tf.init_params(jax.random.key(seed), cfg, dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    pcfg = get_config(family, "tiny")
    return params, cfg, params_from_jax(np_params, pcfg, "cpu", torch.float32), pcfg


@pytest.fixture(scope="module")
def llama():
    return _bridge("llama")


def _prompts(round_: int) -> list[list[int]]:
    rng = np.random.default_rng(0)
    base = [[int(t) for t in rng.integers(3, 500, size=n)] for n, _ in PROMPTS]
    if round_ == 2:
        tail = np.random.default_rng(1)
        base = [p + [int(t) for t in tail.integers(3, 500, size=EXTRA)] for p in base]
    return base


def _drain(mod, b, prompts, budgets, consumers=None):
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        kw = {"on_tokens": consumers[i]} if consumers and consumers[i] else {}
        b.submit(mod.SchedRequest(req_id=i, prompt_ids=p, max_new_tokens=n, **kw))
    return b.run_all()


def _batcher(mod, params, cfg, spec, eos, chunk=32):
    return mod.ContinuousBatcher(
        params, cfg, max_batch=2, page_size=16, capacity_tokens=2048,
        max_new_cap=32, eos_ids=eos, speculative=spec, gamma=GAMMA,
        prefix_cache=True, chunk=chunk,
    )


def _eos_probe(llama) -> list[int]:
    """An EOS id that request 3 emits mid-budget (found on the port —
    the comparison below then pins both packages against it)."""
    _, _, tp, pcfg = llama
    b = _batcher(sched, tp, pcfg, False, [])
    res = _drain(sched, b, _prompts(1)[3:4], [30])
    return [int(res[0].tokens[6])]


@pytest.fixture(scope="module", params=[True, False], ids=["spec", "nospec"])
def two_rounds(request, llama):
    """Both packages, same batcher across two rounds."""
    params, cfg, tp, pcfg = llama
    spec = request.param
    eos = _eos_probe(llama)
    budgets = [n for _, n in PROMPTS]
    out = {}
    for name, mod, p, c in (("jax", jax_sched, params, cfg), ("port", sched, tp, pcfg)):
        b = _batcher(mod, p, c, spec, eos)
        r1 = _drain(mod, b, _prompts(1), budgets)
        inv1 = b.allocator.check_invariants() if name == "port" else None
        r2 = _drain(mod, b, _prompts(2), budgets)
        out[name] = (r1, r2, b)
        assert inv1 is None
    return spec, eos, out


def _same_tokens(ref, got):
    assert [r.req_id for r in got] == [r.req_id for r in ref]
    for r, g in zip(ref, got):
        assert g.n_generated == r.n_generated, f"req {r.req_id}"
        np.testing.assert_array_equal(
            g.tokens[: g.n_generated], np.asarray(r.tokens)[: r.n_generated],
            err_msg=f"req {r.req_id}",
        )


def test_more_requests_than_slots_match_reference(two_rounds):
    spec, eos, out = two_rounds
    r1_ref, r1 = out["jax"][0], out["port"][0]
    _same_tokens(r1_ref, r1)
    # The EOS row stopped at its EOS; the others ran to their budgets.
    assert r1[3].n_generated < 30 and int(r1[3].tokens[r1[3].n_generated - 1]) == eos[0]
    assert [r.n_generated for r in r1 if r.req_id != 3] == [8, 20, 12, 17]
    assert all(r.cached_tokens == 0 for r in r1)


def test_prefix_cache_round_matches_reference(two_rounds):
    spec, _, out = two_rounds
    r2_ref, r2 = out["jax"][1], out["port"][1]
    _same_tokens(r2_ref, r2)
    assert [r.cached_tokens for r in r2] == [r.cached_tokens for r in r2_ref]
    assert sum(r.cached_tokens for r in r2) > 0
    b = out["port"][2]
    b.allocator.check_invariants()
    # Every page not held by the prefix cache is back on the free list.
    assert b.allocator.free_pages + b.prefix_cache.cached_pages == b.allocator.n_pages


def test_spec_telemetry_matches_reference(two_rounds):
    spec, _, out = two_rounds
    for ref, got in zip(out["jax"][:2], out["port"][:2]):
        for r, g in zip(ref, got):
            assert (g.spec_steps, g.spec_drafted, g.spec_accepted) == (
                r.spec_steps, r.spec_drafted, r.spec_accepted,
            )
            assert (g.spec_steps > 0) == spec


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
def test_streaming_cancel_matches_reference(llama, spec):
    """A consumer on request 1 that cancels once it has seen 10 tokens:
    the same deliveries as the reference's, a clean cancelled result whose
    tokens are the blocking run's prefix, and co-residents untouched.
    Decode chunks of 4 steps, so plain decode delivers mid-budget too."""
    params, cfg, tp, pcfg = llama
    budgets = [n for _, n in PROMPTS]
    blocking = _drain(sched, _batcher(sched, tp, pcfg, spec, []), _prompts(1), budgets)
    seen = {"jax": [], "port": []}
    out = {}
    for name, mod, p, c in (("jax", jax_sched, params, cfg), ("port", sched, tp, pcfg)):
        def consumer(ids, _log=seen[name]):
            _log.append(len(ids))
            return len(ids) < 10

        b = _batcher(mod, p, c, spec, [], chunk=4)
        out[name] = _drain(mod, b, _prompts(1), budgets, [None, consumer, None, None, None])
    assert seen["port"] == seen["jax"] and seen["port"]
    ref, got = out["jax"][1], out["port"][1]
    assert got.cancelled and ref.cancelled
    assert got.n_generated == ref.n_generated >= 10
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(
        got.tokens, blocking[1].tokens[: got.n_generated]
    )
    assert got.tokens_saved == 20 - got.n_generated
    _same_tokens([out["jax"][i] for i in (0, 2, 3, 4)], [out["port"][i] for i in (0, 2, 3, 4)])


def _paged_inputs(rng, cfg, B, S, page, P):
    n_pages = 1 + B * P
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
    table = np.zeros((B, P), np.int32)
    cur = [37, 20]  # each row's current length (its span starts at cur-1)
    ids = list(rng.permutation(np.arange(1, n_pages)))
    for r in range(B):
        for p in range(-(-(cur[r] + S) // page)):
            table[r, p] = ids.pop()
    table[1, P - 1] = -1  # padding
    q_pos = np.stack([np.arange(S) + cur[r] - 1 for r in range(B)]).astype(np.int32)
    rows = np.arange(B)[:, None]
    write_page = table[rows, q_pos // page].astype(np.int32)
    write_page[1, S - 1] = 0  # a rejected draft parks on the trash page
    write_off = (q_pos % page).astype(np.int32)
    pads = np.array([0, 3], np.int32)
    bounds = np.stack([np.broadcast_to(pads[:, None], q_pos.shape), q_pos + 1], -1)
    positions = (q_pos - pads[:, None]).astype(np.int32)
    tokens = rng.integers(3, 500, size=(B, S)).astype(np.int32)
    return pool, table, write_page, write_off, bounds.astype(np.int32), q_pos, positions, tokens


@pytest.mark.parametrize("family", ["llama", "gemma2"])
@pytest.mark.parametrize("S", [1, 9], ids=["decode", "verify"])
def test_forward_paged_decode_matches_reference(family, S):
    params, cfg, tp, pcfg = _bridge(family, seed=3)
    rng = np.random.default_rng(5)
    pool, table, wp, wo, bounds, q_pos, positions, tokens = _paged_inputs(
        rng, cfg, B=2, S=S, page=8, P=7
    )
    ref_logits, ref_pool = jax_tf.forward_paged_decode(
        params, cfg, jnp.asarray(tokens), jnp.asarray(positions),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table),
        jnp.asarray(wp), jnp.asarray(wo), jnp.asarray(bounds), jnp.asarray(q_pos),
    )
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    logits = tf.forward_paged_decode(
        tp, pcfg, torch.from_numpy(tokens), torch.from_numpy(positions).long(),
        tpool, torch.from_numpy(table), torch.from_numpy(wp), torch.from_numpy(wo),
        torch.from_numpy(bounds).long(), torch.from_numpy(q_pos).long(),
    )
    assert logits.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-5, atol=2e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(ref_pool[k]), rtol=2e-5, atol=2e-5)


def test_write_targets_clamp_like_reference():
    """A slot past the page table (an inactive row whose length ran past
    the table's span, or a draft position beyond it): JAX clamps the
    gather index, torch would raise; the port clamps explicitly."""
    page, P = 4, 3
    table = np.array([[5, 6, 7], [1, 2, 3]], np.int32)
    q_pos = np.array([4 * 7 + 2, 5], np.int64)  # row 0: far past the table
    active = np.array([True, True])
    ref_page = jnp.where(
        jnp.asarray(active), jnp.asarray(table)[jnp.arange(2), jnp.asarray(q_pos) // page], 0
    )
    got_page, got_off = sched.decode_write_targets(
        torch.from_numpy(table), torch.from_numpy(q_pos), torch.from_numpy(active), page
    )
    np.testing.assert_array_equal(got_page.numpy(), np.asarray(ref_page))
    np.testing.assert_array_equal(got_off.numpy(), q_pos % page)

    span_pos = np.array([[9, 10, 11, 12, 13], [0, 1, 2, 3, 4]], np.int64)
    writable = np.array([[True] * 5, [True, True, False, True, True]])
    safe_q = jnp.minimum(jnp.asarray(span_pos), P * page - 1)
    ref_page = jnp.where(
        jnp.asarray(writable), jnp.asarray(table)[jnp.arange(2)[:, None], safe_q // page], 0
    )
    got_page, got_off = sched.spec_write_targets(
        torch.from_numpy(table), torch.from_numpy(span_pos), torch.from_numpy(writable), page
    )
    np.testing.assert_array_equal(got_page.numpy(), np.asarray(ref_page))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(safe_q % page))


def test_submit_rejects_infeasible_requests(llama):
    _, _, tp, pcfg = llama
    b = sched.ContinuousBatcher(tp, pcfg, max_batch=1, max_new_cap=8, capacity_tokens=128)
    with pytest.raises(ValueError, match="exceeds scheduler"):
        b.submit(sched.SchedRequest(req_id=0, prompt_ids=[1], max_new_tokens=99))
    with pytest.raises(ValueError, match="pool holds only"):
        b.submit(sched.SchedRequest(req_id=0, prompt_ids=[1] * 200, max_new_tokens=8))
    with pytest.raises(RuntimeError, match="resident rows"):
        b._slot_req[0] = object()
        b.reconfigure_speculative(enabled=False)
