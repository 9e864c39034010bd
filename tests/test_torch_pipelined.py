"""The port's pipelined drive loop (``_drive_pipelined``, depth 2 by
default) against the reference's, on the same (bridged) f32 weights.

- Depth 1 and depth 2 are scheduling choices only: the port's tokens are
  identical at both (the reference's ``test_pipeline_depth_one_matches_depth_two``).
- The lagging path, held to the reference deterministically:
  ``_entry_ready`` is forced False in BOTH packages, so every step's flags
  wait for the depth bound (``depth_fetch``) and the host decides one step
  behind the device. Results (tokens, counts, errors, fault kinds), the
  ``StepEvent`` sequence (kind, live rows, prefill tokens, depth, sync
  reason) and the ``depth_fetch`` count equal the reference's: a plain
  drain; a stream consumer that cancels row 0 after 8 tokens while a
  third request waits, so its slot is freed and re-admitted with a step
  in flight (the generation guard, and the entries' host copies that
  later in-place writes never reach); a ``scheduler_chunk`` fault; a
  timeout with a step in flight.
- ``GpuEngine(device="cpu")`` rebuilds its batcher when the depth flips
  between rounds.

On the CPU every copy is complete when taken, so the port's own
``_entry_ready`` is True there, as the reference's CPU entries almost
always are.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu import obs as ref_obs
from adversarial_spec_tpu.engine import interleave as ref_interleave
from adversarial_spec_tpu.engine import kvtier as ref_kvtier
from adversarial_spec_tpu.engine import prefix_cache as ref_prefix
from adversarial_spec_tpu.engine import scheduler as ref_sched
from adversarial_spec_tpu.models import transformer as ref_tf
from adversarial_spec_tpu.models.config import get_config as ref_config
from adversarial_spec_tpu.resilience import faults as ref_faults
from adversarial_spec_tpu.resilience import injector as ref_injector
from adversarial_spec_tpu_torch import obs as port_obs
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import scheduler as port_sched
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.resilience import faults as port_faults
from adversarial_spec_tpu_torch.resilience import injector as port_injector

PKG = {
    "ref": (ref_sched, ref_injector, ref_faults, ref_obs),
    "port": (port_sched, port_injector, port_faults, port_obs),
}
SEQ = 512
BUDGET = 24
rng = np.random.default_rng(3)
PROMPTS = [[int(t) for t in rng.integers(3, 500, size=n)] for n in (40, 9, 70)]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """The knobs both batchers read at construction, pinned per test and
    restored after: prefix cache on, KV tiers off, the pipelined loop,
    obs on with an empty ring; injectors and fault counters reset. One
    intra-op thread: the tiny model's ops gain nothing from a team of
    threads, which on a loaded host costs far more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for cfg, fields in (
        (ref_kvtier.config(), ("enabled",)),
        (port_kvtier.config(), ("enabled",)),
        (ref_prefix.config(), ("enabled", "max_pages")),
        (port_prefix.config(), ("enabled", "max_pages")),
        (ref_interleave.config(), ("enabled", "pipeline_depth")),
        (port_interleave.config(), ("enabled", "pipeline_depth")),
        (ref_obs.config(), ("enabled", "events_out")),
        (port_obs.config(), ("enabled", "events_out")),
    ):
        for f in fields:
            monkeypatch.setattr(cfg, f, getattr(cfg, f))
    for kvtier, prefix, interleave, obs in (
        (ref_kvtier, ref_prefix, ref_interleave, ref_obs),
        (port_kvtier, port_prefix, port_interleave, port_obs),
    ):
        kvtier.configure(enabled=False)
        prefix.configure(enabled=True, max_pages=0)
        interleave.configure(enabled=True, pipeline_depth=2)
        obs.configure(enabled=True, events_out="")
    for _, injector, faults, _ in PKG.values():
        injector.install(None)
        faults.reset()
    yield
    torch.set_num_threads(threads)
    for _, injector, faults, obs in PKG.values():
        injector.install(None)
        faults.reset()
        obs.reset_stats()


@pytest.fixture(scope="module")
def llama():
    cfg = ref_config("llama", "tiny", max_seq_len=SEQ)
    params = ref_tf.init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    pcfg = get_config("llama", "tiny", max_seq_len=SEQ)
    tp = params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu", torch.float32)
    return {"ref": (params, cfg), "port": (tp, pcfg)}


def _batcher(pkg, llama, **kw):
    params, cfg = llama[pkg]
    return PKG[pkg][0].ContinuousBatcher(
        params, cfg, max_batch=2, page_size=16, capacity_tokens=1024,
        max_new_cap=BUDGET, chunk=4, speculative=False, greedy=True, **kw,
    )


def _outcome(results) -> list:
    return [
        (r.req_id, r.n_generated, r.tokens.tolist(), r.fault_kind, r.error,
         r.cancelled, r.tokens_saved)
        for r in results
    ]


def _drain(pkg, b, consumers=None, timeout_s=0.0):
    sched, _, _, obs = PKG[pkg]
    obs.reset_stats()
    for i, p in enumerate(PROMPTS):
        cb = (consumers or {}).get(i)
        b.submit(sched.SchedRequest(req_id=i, prompt_ids=p, max_new_tokens=BUDGET,
                                    on_tokens=cb))
    results = b.run_all(timeout_s=timeout_s)
    b.allocator.check_invariants()
    steps = [
        (e["kind"], e["n_live"], e["prefill_tokens"], e["pipeline_depth"],
         e["sync_reason"])
        for e in obs.recorder.events() if e["type"] == "step"
    ]
    syncs = obs.snapshot()["host_syncs"]
    # Pages still held after the drain: the prefix cache's blocks only.
    return results, steps, syncs, b.allocator.free_pages


def _lagging(monkeypatch):
    """Every in-flight step reads as unresolved in both packages: each
    fetch waits for the depth bound."""
    for sched, _, _, _ in PKG.values():
        monkeypatch.setattr(
            sched.ContinuousBatcher, "_entry_ready", staticmethod(lambda entry: False)
        )


def test_depth_one_matches_depth_two(llama):
    """Depth 1 (fused but synchronous) and depth 2 (the double buffer)
    give the same tokens on the port, and each batcher reports its depth
    in its step events."""
    outs = {}
    for depth in (1, 2):
        b = _batcher("port", llama, pipeline_depth=depth)
        assert b.pipeline_depth == depth
        results, steps, _, _ = _drain("port", b)
        outs[depth] = _outcome(results)
        assert {s[3] for s in steps if s[0] in ("decode", "fused")} == {1}
        # On the CPU every entry's copies have landed when it is checked.
        assert b.fetch_counts["ready"] > 0 and b.fetch_counts["depth_bound"] == 0
    assert outs[1] == outs[2]
    assert all(n == BUDGET for _, n, *_ in outs[2])
    # The clamp is the reference's.
    assert _batcher("port", llama, pipeline_depth=7).pipeline_depth == 2
    assert _batcher("port", llama, pipeline_depth=0).pipeline_depth == 1


def _both_lagging(llama, monkeypatch, **run):
    _lagging(monkeypatch)
    got = {}
    for pkg in ("ref", "port"):
        b = _batcher(pkg, llama)
        results, steps, syncs, free = _drain(pkg, b, **run)
        got[pkg] = (_outcome(results), steps, syncs.get("depth_fetch", 0), free)
    assert got["port"] == got["ref"]
    return got["port"]


def test_lagging_drain_matches_reference(llama, monkeypatch):
    outcome, steps, depth_fetch, _ = _both_lagging(llama, monkeypatch)
    assert all(n == BUDGET and kind is None for _, n, _, kind, *_ in outcome)
    # Two steps in flight from the second decode step on, each retiring
    # the older one at the bound.
    assert {s[3] for s in steps if s[0] in ("decode", "fused")} == {1, 2}
    assert depth_fetch == sum(s[4] == "depth_fetch" for s in steps) > 0


def test_lagging_stream_cancel_and_readmission_match_reference(llama, monkeypatch):
    """Row 0's consumer cancels after 8 tokens; request 2 waits for a
    slot, so slot 0 is freed and re-admitted while a step is in flight.
    The deliveries (each call's token count) and results equal the
    reference's, the old owner's in-flight flags never touch the new
    one, and every entry's host copies at its fetch are those taken at
    its dispatch (later in-place writes to the device state never reach
    them)."""
    taken, checked = [], []
    real_entry = port_sched.ContinuousBatcher._step_entry
    real_fetch = port_sched.ContinuousBatcher._fetch_entry

    def step_entry(self, live, streaming):
        entry = real_entry(self, live, streaming)
        taken.append((id(entry.active), [t.clone() for t in entry[1:4] if t is not None]))
        return entry

    def fetch_entry(self, entry):
        copies = dict(taken)[id(entry.active)]
        now = [t for t in entry[1:4] if t is not None]
        checked.append(all(torch.equal(a, b) for a, b in zip(now, copies)))
        return real_fetch(self, entry)

    monkeypatch.setattr(port_sched.ContinuousBatcher, "_step_entry", step_entry)
    monkeypatch.setattr(port_sched.ContinuousBatcher, "_fetch_entry", fetch_entry)
    delivered = {"ref": [], "port": []}

    def consumers(pkg):
        def cancel_row0(toks):
            delivered[pkg].append(len(toks))
            return len(toks) < 8

        return {0: cancel_row0}

    _lagging(monkeypatch)
    got = {}
    for pkg in ("ref", "port"):
        b = _batcher(pkg, llama)
        results, steps, syncs, free = _drain(pkg, b, consumers=consumers(pkg))
        got[pkg] = (_outcome(results), steps, syncs.get("depth_fetch", 0), free)
        if pkg == "port":
            assert b._slot_gen[0] >= 3  # handoff, cancel, handoff, finish
    assert got["port"] == got["ref"]
    assert delivered["port"] == delivered["ref"]
    r0, r1, r2 = got["port"][0]
    assert r0[5] and r0[1] >= 8 and r0[6] == BUDGET - r0[1]
    assert r1[1] == r2[1] == BUDGET and not r1[5] and not r2[5]
    assert checked and all(checked)


def test_lagging_chunk_fault_matches_reference(llama, monkeypatch):
    """A ``scheduler_chunk`` fault with a step in flight: only slot 1's
    request is evicted, with the reference's partial tokens and kind."""
    chaos = "bug@scheduler_chunk:after=3:times=1:slot=1"
    _lagging(monkeypatch)
    got = {}
    for pkg in ("ref", "port"):
        _, injector, faults, _ = PKG[pkg]
        injector.install(injector.FaultInjector(injector.parse_chaos_spec(chaos)))
        try:
            b = _batcher(pkg, llama)
            results, steps, syncs, free = _drain(pkg, b)
        finally:
            injector.install(None)
        got[pkg] = (_outcome(results), steps, syncs.get("depth_fetch", 0), free,
                    faults.snapshot())
    assert got["port"] == got["ref"]
    faulted = [o for o in got["port"][0] if o[3] is not None]
    assert [o[0] for o in faulted] == [1] and faulted[0][1] < BUDGET
    assert all(o[1] == BUDGET for o in got["port"][0] if o[3] is None)


def test_lagging_timeout_matches_reference(llama, monkeypatch):
    """The drain's deadline passes with a step in flight. The clock is
    one tick per drive-loop iteration in both packages (each admits once
    per iteration), so the deadline falls on the same iteration: rows
    finish with what they have, the queued request with nothing."""
    clock = [0.0]
    real_time = time.monotonic
    for sched, _, _, _ in PKG.values():
        real_admit = sched.ContinuousBatcher._admit

        def admit(self, _real=real_admit):
            clock[0] += 1.0
            return _real(self)

        monkeypatch.setattr(sched.ContinuousBatcher, "_admit", admit)
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    try:
        outcome, steps, _, _ = _both_lagging(llama, monkeypatch, timeout_s=4.5)
    finally:
        monkeypatch.setattr(time, "monotonic", real_time)
    assert [o[1] for o in outcome][2] == 0
    assert 0 < outcome[0][1] < BUDGET and all(o[3] is None for o in outcome)
    assert steps[-1][3] == 2  # the last step dispatched had one before it in flight


def test_engine_rebuilds_its_batcher_when_the_depth_flips(tmp_path, monkeypatch):
    monkeypatch.setattr(registry, "REGISTRY_PATH", tmp_path / "registry.json")
    registry.save_registry_entry(
        registry.ModelSpec(alias="depth-tiny", family="llama", size="tiny",
                           dtype="float32", kv="paged")
    )
    eng = GpuEngine(device="cpu")
    reqs = [ChatRequest("tpu://depth-tiny", "sys", "hello there")] * 2
    sp = SamplingParams(max_new_tokens=8, greedy=True)
    texts, batchers = [], []
    for depth in (2, 2, 1):
        port_interleave.configure(pipeline_depth=depth)
        comps = eng.chat(reqs, sp)
        assert all(c.ok for c in comps)
        texts.append([c.text for c in comps])
        batchers.append(eng._models["depth-tiny"].batcher)
    assert batchers[0] is batchers[1] and batchers[2] is not batchers[1]
    assert [b.pipeline_depth for b in batchers] == [2, 2, 1]
    assert texts[0] == texts[1] == texts[2]
