"""The port's decode chunk loops against the reference's ``while_loop``s.

The reference runs each decode chunk as one ``jax.lax.while_loop`` with one
host boundary a chunk; the port runs the same bodies as masked steps over
a carry on the device (``engine/device_loop.py``), polling a copy of the
exit flag every ``SUB_CHUNK`` steps, so steps past the reference's exit
run and must change nothing. Here, on the CPU (the eager body; CUDA
graphs are the card's), on the reference's tiny f32 llama bridged into
the port:

- L1 ``scheduler._decode_chunk_impl`` (paged), L2 ``generate.decode_chunk_steps``,
  L3 ``speculative.speculative_decode_steps``, L4 ``speculative.rowwise_decode_steps``
  against the reference's, from the same state (a cache or pool the port
  prefilled, handed to both as numpy): equal tokens, ``out_buf``, K/V and
  exit state, with rows finishing at different steps, a chunk whose rows
  are done before its bound (steps past the exit run, and are counted),
  and a chunk that ends at its bound;
- no host read inside a chunk: ``bool``, ``int``, ``float``, ``index``,
  ``item``, ``tolist``, ``cpu`` and ``numpy`` of a tensor raise while a
  chunk runs;
- ``generate()`` over several chunks (``DECODE_CHUNK`` patched small in
  both packages), speculation on and off, and ``paged=True``;
- ``interleave.stats`` after a batcher's drain at depth 1 and 2, its
  ``sync_points`` included: the chunk body counts no sync, as the
  reference's does not.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as ref_gen
from adversarial_spec_tpu.engine import interleave as ref_interleave
from adversarial_spec_tpu.engine import kvtier as ref_kvtier
from adversarial_spec_tpu.engine import prefix_cache as ref_prefix
from adversarial_spec_tpu.engine import scheduler as ref_sched
from adversarial_spec_tpu.engine import spec as ref_spec
from adversarial_spec_tpu.engine import speculative as ref_specdec
from adversarial_spec_tpu.models import transformer as ref_tf
from adversarial_spec_tpu.models.config import get_config as ref_config
from adversarial_spec_tpu_torch.engine import device_loop
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import scheduler as port_sched
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine import speculative as specdec
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.models.transformer import init_cache

SEQ = 512
B = 3
LENS = (40, 97, 13)
# f32 K/V after a dozen steps: the two frameworks sum their products in
# other orders (up to 2e-5 seen); a write a no-op step failed to mask
# would be off by the values' own size, ~1.
KV_TOL = 1e-4
NEVER = -1  # an EOS id no row emits


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llama():
    cfg = ref_config("llama", "tiny", max_seq_len=SEQ)
    params = ref_tf.init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    pcfg = get_config("llama", "tiny", max_seq_len=SEQ)
    tp = params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu", torch.float32)
    return params, cfg, tp, pcfg


def _prompts(seed=0):
    """Repetitive prompts (prompt lookup finds drafts), unequal lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for n in LENS:
        base = rng.integers(3, 500, 12).tolist()
        out.append([1] + (base * (n // 12 + 1))[:n])
    return out


@pytest.fixture(scope="module")
def prefilled(llama):
    """The prompts left-padded and prefilled by the port, with room for
    ``max_new`` decode slots: numpy tokens, pads, cache and first token."""
    _, _, tp, pcfg = llama
    max_new = 32
    tokens, pads = gen.pad_batch(_prompts(), 0)
    S = tokens.shape[1]
    cache = init_cache(pcfg, B, S + max_new, device=torch.device("cpu"), dtype=torch.float32)
    logits = gen.prefill_chunk(
        tp, pcfg, torch.as_tensor(tokens, dtype=torch.int64),
        torch.as_tensor(pads, dtype=torch.int64), cache, 0,
    )
    return dict(
        tokens=tokens, pads=pads, S=S, max_new=max_new,
        cache={k: v.numpy().copy() for k, v in cache.items()},
        first=logits.argmax(-1).numpy(),
    )


def _t(x, dtype=torch.int64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _j(x, dtype=jnp.int32):
    return jnp.asarray(np.asarray(x), dtype)


def _eos(ids):
    return sorted(set(int(i) for i in ids)) or [NEVER]


@contextlib.contextmanager
def no_host_reads():
    """Every way of reading a tensor on the host raises."""

    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was read on the host inside a chunk")

    names = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _first_eos(out, eos, upto):
    """Each row's step of its first EOS in ``out[:, :upto]``, or None."""
    hits = [np.flatnonzero(np.isin(row[:upto], eos)) for row in out]
    return [int(h[0]) if len(h) else None for h in hits]


# -- L2: the dense shared-slot chunk ----------------------------------------------


def _l2(llama, st, eos, *, chunk=12, start=1, guard=False):
    params, cfg, tp, pcfg = llama
    max_new, S = st["max_new"], st["S"]
    out0 = np.zeros((B, max_new), np.int64)
    out0[:, 0] = st["first"]
    fin0 = np.isin(st["first"], eos)
    ref = ref_gen.decode_chunk_steps(
        params, cfg, {k: jnp.asarray(v) for k, v in st["cache"].items()},
        _j(st["first"]), _j(st["pads"]), jnp.asarray(fin0), _j(out0),
        jnp.int32(start), jnp.int32(max_new), _j(eos), jax.random.key(0),
        jnp.float32(1.0), jnp.float32(1.0), prompt_len=S, chunk=chunk,
        greedy=True, top_k=0,
    )
    cache = {k: torch.from_numpy(v.copy()) for k, v in st["cache"].items()}
    out = torch.from_numpy(out0.copy())
    with no_host_reads() if guard else contextlib.nullcontext():
        cur, fin, step = gen.decode_chunk_steps(
            tp, pcfg, cache, _t(st["first"]), _t(st["pads"]), torch.from_numpy(fin0), out,
            torch.tensor(start), max_new, _t(eos), None, 1.0, 1.0, prompt_len=S,
            chunk=chunk, greedy=True, top_k=0,
        )
    r_cache, r_cur, r_fin, r_out, r_step = ref
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    np.testing.assert_array_equal(cur.numpy(), np.asarray(r_cur))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(r_fin))
    assert int(step) == int(r_step)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(r_cache[k]), atol=KV_TOL)
    return out.numpy(), int(step), fin.numpy()


def _probe_l2(llama, st, chunk=12):
    return _l2(llama, st, [NEVER], chunk=chunk)[0]


def test_decode_chunk_rows_finish_at_different_steps(llama, prefilled):
    out = _probe_l2(llama, prefilled)
    eos = _eos([out[0, 3], out[1, 7]])
    got, step, fin = _l2(llama, prefilled, eos)
    steps = _first_eos(got, eos, step)
    assert steps[0] is not None and steps[1] is not None and steps[0] != steps[1]


def test_decode_chunk_exit_before_bound_runs_no_op_steps(llama, prefilled):
    out = _probe_l2(llama, prefilled)
    eos = _eos(out[:, 2])
    device_loop.reset_stats()
    _, step, fin = _l2(llama, prefilled, eos)
    assert fin.all() and step <= 3 < 1 + 12
    assert device_loop.snapshot()["past_exit_steps"] > 0


def test_decode_chunk_ends_at_its_bound(llama, prefilled):
    device_loop.reset_stats()
    _, step, fin = _l2(llama, prefilled, [NEVER], chunk=9, start=2)
    assert step == 11 and not fin.any()
    assert device_loop.snapshot()["past_exit_steps"] == 0


# -- L1: the paged chunk ------------------------------------------------------------


@pytest.fixture(scope="module")
def paged(llama, prefilled):
    """The prefilled prompt K/V migrated into a page pool (16-slot pages,
    physical page 0 the trash page) by the port."""
    _, _, _, pcfg = llama
    st = prefilled
    cache = {k: torch.from_numpy(v) for k, v in st["cache"].items()}
    pool, table = gen._migrate_to_pages(
        cache, pcfg, B, st["S"], st["S"] + st["max_new"], 16, False, "", torch.device("cpu")
    )
    return dict(pool={k: v.numpy().copy() for k, v in pool.items()}, table=table.numpy())


def _l1(llama, st, pg, eos, budgets, *, chunk=12, guard=False):
    params, cfg, tp, pcfg = llama
    cap, S = st["max_new"], st["S"]
    out0 = np.zeros((B, cap), np.int64)
    out0[:, 0] = st["first"]
    cur_len = np.full((B,), S + 1)
    n_emitted = np.ones((B,), np.int64)
    budgets = np.asarray(budgets)
    active = ~np.isin(st["first"], eos) & (budgets > 1)
    ref = ref_sched._decode_chunk_impl(
        params, cfg, {k: jnp.asarray(v) for k, v in pg["pool"].items()}, _j(pg["table"]),
        _j(st["first"]), _j(cur_len), _j(st["pads"]), _j(n_emitted), _j(budgets),
        jnp.asarray(active), _j(out0), _j(eos), jax.random.key(0), jnp.float32(1.0),
        jnp.float32(1.0), chunk=chunk, greedy=True, top_k=0,
    )
    pool = {k: torch.from_numpy(v.copy()) for k, v in pg["pool"].items()}
    state = [_t(st["first"]), _t(cur_len), _t(n_emitted), torch.from_numpy(active.copy())]
    out = torch.from_numpy(out0.copy())
    with no_host_reads() if guard else contextlib.nullcontext():
        got = port_sched._decode_chunk_impl(
            tp, pcfg, pool, torch.from_numpy(pg["table"]), state[0], state[1],
            _t(st["pads"]), state[2], _t(budgets), state[3], out, _t(eos),
            None, 1.0, 1.0, chunk=chunk, greedy=True, top_k=0,
        )
    # The carry is the caller's buffers, updated in place.
    assert all(g is s for g, s in zip(got, state))
    r_pool, r_cur, r_len, r_emitted, r_out, r_active = ref
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    for g, r in zip(got, (r_cur, r_len, r_emitted, r_active)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # Every page but the trash page (0), which inactive rows write and
    # nothing reads: the steps past the exit write it too.
    for k in pool:
        np.testing.assert_allclose(
            pool[k].numpy()[:, 1:], np.asarray(r_pool[k])[:, 1:], atol=KV_TOL
        )
    return out.numpy(), got[2].numpy(), got[3].numpy()


def test_paged_chunk_rows_finish_at_different_steps(llama, prefilled, paged):
    out, _, _ = _l1(llama, prefilled, paged, [NEVER], [32, 32, 32])
    eos = _eos([out[1, 5]])
    # Row 0 stops on its 4-token budget, row 1 on EOS, row 2 runs on.
    _, emitted, active = _l1(llama, prefilled, paged, eos, [4, 32, 32])
    assert emitted[0] == 4 and not active[0] and not active[1] and active[2]


def test_paged_chunk_exit_before_bound_runs_no_op_steps(llama, prefilled, paged):
    device_loop.reset_stats()
    _, emitted, active = _l1(llama, prefilled, paged, [NEVER], [3, 6, 2], chunk=16)
    assert not active.any() and emitted.tolist() == [3, 6, 2]
    assert device_loop.snapshot()["past_exit_steps"] > 0


def test_paged_chunk_ends_at_its_bound(llama, prefilled, paged):
    _, emitted, active = _l1(llama, prefilled, paged, [NEVER], [32, 32, 32], chunk=7)
    assert active.all() and emitted.tolist() == [8, 8, 8]


# -- L3: the speculative rounds ------------------------------------------------------


GAMMA = 3


def _l3(llama, st, eos, *, iters=8, stop_at=None, guard=False):
    params, cfg, tp, pcfg = llama
    max_new, S = st["max_new"], st["S"]
    stop_at = max_new if stop_at is None else stop_at
    out0 = np.zeros((B, max_new), np.int64)
    out0[:, 0] = st["first"]
    fin0 = np.isin(st["first"], eos)
    steps0 = np.ones((B,), np.int64)
    prev0 = st["tokens"][:, -1]
    ref = ref_specdec.speculative_decode_steps(
        params, cfg, {k: jnp.asarray(v) for k, v in st["cache"].items()},
        _j(st["tokens"]), _j(prev0), _j(st["first"]), _j(st["pads"]), jnp.asarray(fin0),
        _j(out0), _j(steps0), jnp.int32(stop_at), _j(eos), jax.random.key(0),
        jnp.float32(1.0), jnp.float32(1.0), prompt_len=S, iters=iters, gamma=GAMMA,
        greedy=True, top_k=0,
    )
    cache = {k: torch.from_numpy(v.copy()) for k, v in st["cache"].items()}
    out = torch.from_numpy(out0.copy())
    with no_host_reads() if guard else contextlib.nullcontext():
        got = specdec.speculative_decode_steps(
            tp, pcfg, cache, _t(st["tokens"]), _t(prev0), _t(st["first"]), _t(st["pads"]),
            torch.from_numpy(fin0), out, _t(steps0), stop_at, _t(eos), None, 1.0, 1.0,
            prompt_len=S, iters=iters, gamma=GAMMA, greedy=True, top_k=0,
        )
    r_cache, *r_rest = ref
    prev, cur, fin, out_t, steps, it, n_emit, n_rows = got
    assert out_t is out
    for g, r in zip((prev, cur, fin, out, steps, it, n_emit, n_rows), r_rest):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(r_cache[k]), atol=KV_TOL)
    return out.numpy(), steps.numpy(), fin.numpy(), int(it)


def test_speculative_rows_finish_at_different_steps(llama, prefilled):
    out, _, _, _ = _l3(llama, prefilled, [NEVER])
    eos = _eos([out[0, 4], out[2, 7]])
    _, steps, fin, _ = _l3(llama, prefilled, eos)
    assert fin[0] and fin[2] and steps[0] != steps[2]


def test_speculative_exit_before_iters_runs_no_op_steps(llama, prefilled):
    device_loop.reset_stats()
    # No row fits another full span within 9 steps: the loop leaves
    # early, with iterations to spare.
    _, steps, _, it = _l3(llama, prefilled, [NEVER], iters=8, stop_at=9)
    assert it < 8 and (steps + GAMMA + 1 > 9).all()
    assert device_loop.snapshot()["past_exit_steps"] > 0


def test_speculative_ends_at_its_iteration_bound(llama, prefilled):
    _, _, _, it = _l3(llama, prefilled, [NEVER], iters=2)
    assert it == 2


# -- L4: the rowwise tail ------------------------------------------------------------


def _l4(llama, st, eos, steps0, *, chunk=10, stop_at=None, guard=False):
    params, cfg, tp, pcfg = llama
    max_new, S = st["max_new"], st["S"]
    stop_at = max_new if stop_at is None else stop_at
    out0 = np.zeros((B, max_new), np.int64)
    out0[:, 0] = st["first"]
    fin0 = np.isin(st["first"], eos)
    steps0 = np.asarray(steps0, np.int64)
    ref = ref_specdec.rowwise_decode_steps(
        params, cfg, {k: jnp.asarray(v) for k, v in st["cache"].items()},
        _j(st["first"]), _j(st["pads"]), jnp.asarray(fin0), _j(out0), _j(steps0),
        jnp.int32(stop_at), _j(eos), jax.random.key(0), jnp.float32(1.0),
        jnp.float32(1.0), prompt_len=S, chunk=chunk, greedy=True, top_k=0,
    )
    cache = {k: torch.from_numpy(v.copy()) for k, v in st["cache"].items()}
    out = torch.from_numpy(out0.copy())
    with no_host_reads() if guard else contextlib.nullcontext():
        got = specdec.rowwise_decode_steps(
            tp, pcfg, cache, _t(st["first"]), _t(st["pads"]), torch.from_numpy(fin0), out,
            _t(steps0), stop_at, _t(eos), None, 1.0, 1.0, prompt_len=S, chunk=chunk,
            greedy=True, top_k=0,
        )
    r_cache, *r_rest = ref
    cur, fin, out_t, steps = got
    assert out_t is out
    for g, r in zip((cur, fin, out, steps), r_rest):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(r_cache[k]), atol=KV_TOL)
    return out.numpy(), steps.numpy(), fin.numpy()


def test_rowwise_rows_finish_at_different_steps(llama, prefilled):
    out, _, _ = _l4(llama, prefilled, [NEVER], [1, 1, 1])
    eos = _eos([out[0, 2], out[1, 6]])
    _, _, fin = _l4(llama, prefilled, eos, [1, 1, 1])
    assert fin[0] and fin[1]


def test_rowwise_exit_before_chunk_runs_no_op_steps(llama, prefilled):
    device_loop.reset_stats()
    # Desynchronized rows catch up to step 6 and the loop leaves.
    _, steps, _ = _l4(llama, prefilled, [NEVER], [1, 4, 2], chunk=16, stop_at=6)
    assert steps.tolist() == [6, 6, 6]
    assert device_loop.snapshot()["past_exit_steps"] > 0


def test_rowwise_ends_at_its_chunk(llama, prefilled):
    _, steps, _ = _l4(llama, prefilled, [NEVER], [1, 3, 2], chunk=5)
    assert steps.tolist() == [6, 8, 7]


# -- no host read inside a chunk ------------------------------------------------------


@pytest.mark.parametrize("loop", ["paged", "decode", "speculative", "rowwise"])
def test_no_host_read_inside_a_chunk(llama, prefilled, paged, loop):
    """Each loop's chunk completes with every host read of a tensor
    refused, past its exit too, and gives the reference's results (the
    helpers compare)."""
    if loop == "paged":
        _l1(llama, prefilled, paged, [NEVER], [3, 6, 2], chunk=16, guard=True)
    elif loop == "decode":
        _l2(llama, prefilled, _eos(_probe_l2(llama, prefilled)[:, 2]), guard=True)
    elif loop == "speculative":
        _l3(llama, prefilled, [NEVER], iters=8, stop_at=9, guard=True)
    else:
        _l4(llama, prefilled, [NEVER], [1, 4, 2], chunk=16, stop_at=6, guard=True)


# -- generate() over several chunks ------------------------------------------------------


@pytest.mark.parametrize(
    "mode", ["speculative", "plain", "paged"],
)
def test_generate_over_small_chunks_matches_reference(llama, monkeypatch, mode):
    params, cfg, tp, pcfg = llama
    for mod in (ref_gen, gen):
        monkeypatch.setattr(mod, "DECODE_CHUNK", 16)
    monkeypatch.setattr(ref_spec.config(), "gamma", GAMMA)
    monkeypatch.setattr(port_spec.config(), "gamma", GAMMA)
    prompts = _prompts(seed=5)
    kw = dict(max_new_tokens=40, eos_ids=[2], greedy=True,
              speculative=mode == "speculative", paged=mode == "paged", page_size=32)
    ref = ref_gen.generate(params, cfg, prompts, **kw)
    device_loop.reset_stats()
    got = gen.generate(tp, pcfg, prompts, device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.n_generated, ref.n_generated)
    assert device_loop.snapshot()["chunks"] >= 3  # 40 tokens in chunks of 16


# -- interleave.stats after a drain --------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_interleave_stats_match_reference_after_a_drain(llama, monkeypatch, depth):
    """At depth 2 every in-flight step reads as unresolved in both
    packages (``_entry_ready`` False, as ``test_torch_pipelined.py``
    holds the lagging loop): how many decode dispatches a drain takes
    then depends on the loop, not on when JAX's CPU work lands."""
    params, cfg, tp, pcfg = llama
    for sched in (ref_sched, port_sched):
        monkeypatch.setattr(
            sched.ContinuousBatcher, "_entry_ready", staticmethod(lambda entry: False)
        )
    for conf, fields in (
        (ref_kvtier.config(), ("enabled",)),
        (port_kvtier.config(), ("enabled",)),
        (ref_prefix.config(), ("enabled", "max_pages")),
        (port_prefix.config(), ("enabled", "max_pages")),
        (ref_interleave.config(), ("enabled", "pipeline_depth")),
        (port_interleave.config(), ("enabled", "pipeline_depth")),
    ):
        for f in fields:
            monkeypatch.setattr(conf, f, getattr(conf, f))
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(3, 500, size=n)] for n in (40, 9, 70)]
    snaps = {}
    for name, sched, kvtier, prefix, interleave, p, c in (
        ("ref", ref_sched, ref_kvtier, ref_prefix, ref_interleave, params, cfg),
        ("port", port_sched, port_kvtier, port_prefix, port_interleave, tp, pcfg),
    ):
        kvtier.configure(enabled=False)
        prefix.configure(enabled=True, max_pages=0)
        interleave.configure(enabled=True, pipeline_depth=depth)
        b = sched.ContinuousBatcher(
            p, c, max_batch=2, page_size=16, capacity_tokens=1024, max_new_cap=24,
            chunk=4, speculative=False, greedy=True, eos_ids=[2],
        )
        interleave.reset_stats()
        for i, ids in enumerate(prompts):
            b.submit(sched.SchedRequest(req_id=i, prompt_ids=ids, max_new_tokens=20 + i))
        results = b.run_all()
        snap = interleave.snapshot()
        for timing in ("stalled_prefill_s", "overlapped_prefill_s", "prefill_time_s"):
            snap.pop(timing)
        snaps[name] = (snap, [(r.req_id, r.tokens.tolist()) for r in results])
    assert snaps["port"] == snaps["ref"]
    assert snaps["port"][0]["sync_points"] > 0 and snaps["port"][0]["pipeline_depth"] == depth


@pytest.mark.parametrize("speculative", [False, True], ids=["decode", "speculative"])
def test_batcher_buffers_keep_their_storage_across_dispatches(llama, speculative):
    """Every buffer a decode step reads is updated in place, never
    rebound, so a step captured at the first dispatch reads the live state
    at the last: the page table too, which the speculative step pushes
    anew from the allocator every step."""
    _, _, tp, pcfg = llama
    b = port_sched.ContinuousBatcher(
        tp, pcfg, max_batch=2, page_size=16, capacity_tokens=1024, max_new_cap=24,
        chunk=4, speculative=speculative, greedy=True, eos_ids=[2],
    )
    names = ("page_table", "cur_tok", "cur_len", "pad_lens", "n_emitted", "max_new",
             "active", "out_buf", "ctx_buf", "ctx_len", "prev_tok")
    before = {n: (getattr(b, n), getattr(b, n).data_ptr()) for n in names}
    before.update({f"pool[{k}]": (v, v.data_ptr()) for k, v in b.pool.items()})
    rng = np.random.default_rng(7)
    for i, n in enumerate((40, 9, 70)):
        ids = [int(t) for t in rng.integers(3, 500, size=n)]
        b.submit(port_sched.SchedRequest(req_id=i, prompt_ids=ids, max_new_tokens=20))
    results = b.run_all()
    assert [r.n_generated for r in results] and all(r.error is None for r in results)
    after = {n: getattr(b, n) for n in names}
    after.update({f"pool[{k}]": v for k, v in b.pool.items()})
    for n, (t, ptr) in before.items():
        assert after[n] is t and t.data_ptr() == ptr, n
