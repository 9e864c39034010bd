"""The port's batcher under faults, deadlines and the legacy drive loop,
against the reference's batcher on the same (bridged) f32 weights.

- Fault containment (the cases of ``tests/test_failure_injection.py``'s
  scheduler isolation tests): a persistent fault on one slot evicts it
  with its partial tokens, a transient one requeues once and completes,
  a permanent ``kv_alloc`` fault fails one request, and a fault in the
  admission's pool scatter aborts only that admission. Each runs in the
  fused loop with plain decode and in the legacy loop with speculation,
  and gives exactly the reference's results (tokens, counts, fault
  kinds, errors) and fault counters. The auto-dumped flight record
  reconstructs the eviction.
- A step that faults part-way (the pool is written in place): the
  co-resident rows' tokens equal a fault-free run and the prefix cache's
  pages are byte-unchanged. A CUDA error that poisons the context is
  never contained: it escapes, and the engine fails the group.
- The per-request watchdog (``tests/test_durability.py``'s cases): an
  expired resident row is evicted as TIMEOUT with its partial tokens
  delivered, a queued request past its deadline resolves with zero
  tokens, no requeue, in both loops and under speculation.
- The legacy serialized loop (``interleave`` off) gives the reference's
  tokens and telemetry, and ``critique --no-interleave`` on a paged
  alias exits 0 with the reference's ``--json`` (fault C.6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu import obs as ref_obs
from adversarial_spec_tpu.engine import dispatch as ref_dispatch
from adversarial_spec_tpu.engine import interleave as ref_interleave
from adversarial_spec_tpu.engine import kvtier as ref_kvtier
from adversarial_spec_tpu.engine import prefix_cache as ref_prefix
from adversarial_spec_tpu.engine import scheduler as ref_sched
from adversarial_spec_tpu.engine import spec as ref_spec
from adversarial_spec_tpu.engine import streaming as ref_streaming
from adversarial_spec_tpu.models import transformer as ref_tf
from adversarial_spec_tpu.models.config import get_config as ref_config
from adversarial_spec_tpu.obs.events import validate_event
from adversarial_spec_tpu.resilience import faults as ref_faults
from adversarial_spec_tpu.resilience import injector as ref_injector
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch import obs as port_obs
from adversarial_spec_tpu_torch.engine import dispatch as port_dispatch
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import scheduler as port_sched
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine import streaming as port_streaming
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.resilience import faults as port_faults
from adversarial_spec_tpu_torch.resilience import injector as port_injector

from tests import torch_cli_support as sup

PKG = {
    "ref": (ref_sched, ref_injector, ref_faults, ref_obs),
    "port": (port_sched, port_injector, port_faults, port_obs),
}
SEQ = 1024
LOOPS = {"fused": True, "legacy": False}
SPEC = "# Cache Service\n\nA read-through cache with a write-behind queue."


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """The knobs both batchers read at construction, pinned per test (the
    KV tiers off in both packages; they are tests/test_torch_kv_tier.py's)
    and restored after; the injectors and fault counters reset. One
    intra-op thread: the tiny model's ops gain nothing from a team of
    threads, which on a loaded host costs far more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for cfg, fields in (
        (ref_kvtier.config(), ("enabled",)),
        (port_kvtier.config(), ("enabled",)),
        (ref_prefix.config(), ("enabled", "max_pages")),
        (port_prefix.config(), ("enabled", "max_pages")),
        (ref_spec.config(), ("enabled", "gamma")),
        (port_spec.config(), ("enabled", "gamma")),
        (ref_interleave.config(), ("enabled", "pipeline_depth")),
        (port_interleave.config(), ("enabled", "pipeline_depth")),
        (ref_streaming.config(), ("enabled",)),
        (port_streaming.config(), ("enabled",)),
    ):
        for f in fields:
            monkeypatch.setattr(cfg, f, getattr(cfg, f))
    ref_kvtier.configure(enabled=False)
    port_kvtier.configure(enabled=False)
    ref_prefix.configure(enabled=True, max_pages=0)
    port_prefix.configure(enabled=True, max_pages=0)
    ref_interleave.configure(enabled=True, pipeline_depth=2)
    port_interleave.configure(enabled=True, pipeline_depth=2)
    for _, injector, faults, _ in PKG.values():
        injector.install(None)
        faults.reset()
    yield
    torch.set_num_threads(threads)
    for _, injector, faults, _ in PKG.values():
        injector.install(None)
        faults.reset()


@pytest.fixture(scope="module")
def llama():
    # A 1024-token context: the batchers' page tables (and the CPU gather
    # path's dense windows) are sized by it; every prompt here fits.
    cfg = ref_config("llama", "tiny", max_seq_len=SEQ)
    params = ref_tf.init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    pcfg = get_config("llama", "tiny", max_seq_len=SEQ)
    tp = params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu", torch.float32)
    return {"ref": (params, cfg), "port": (tp, pcfg)}


def _batcher(pkg, llama, **kw):
    params, cfg = llama[pkg]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_new_cap", 16)
    kw.setdefault("chunk", 4)
    kw.setdefault("gamma", 4)
    return PKG[pkg][0].ContinuousBatcher(params, cfg, **kw)


def _submit(pkg, b, reqs):
    sched = PKG[pkg][0]
    for i, (prompt, n, extra) in enumerate(reqs):
        b.submit(sched.SchedRequest(req_id=i, prompt_ids=prompt, max_new_tokens=n, **extra))


def _outcome(results) -> list:
    return [
        (r.req_id, r.n_generated, r.tokens.tolist(), r.fault_kind, r.error, r.cancelled)
        for r in results
    ]


TWO = [([1, 5, 9], 12, {}), ([2, 6], 12, {})]
FAULT_CASES = {
    # (chaos spec, requests, the faulted req_id or None)
    "persistent_oom": ("oom@scheduler_chunk:after=1:times=2:slot=1", TWO, 1),
    "transient_retry": ("device_lost@scheduler_chunk:after=1:times=1:slot=0", TWO, None),
    "permanent_kv_alloc": ("bug@kv_alloc:times=1", TWO, 0),
    "finish_admission_oom": ("", TWO, None),
}


# Each case in the fused loop with plain decode (the reference's own
# setting) and in the legacy loop with speculation (the other loop, and
# faults landing between verify steps).
FAULT_MATRIX = [(c, "fused", False) for c in sorted(FAULT_CASES)] + [
    (c, "legacy", True) for c in sorted(FAULT_CASES)
]


@pytest.mark.parametrize(
    "case,loop,spec", FAULT_MATRIX,
    ids=[f"{c}-{lp}-{'spec' if sp else 'nospec'}" for c, lp, sp in FAULT_MATRIX],
)
def test_slot_fault_is_contained_as_reference(llama, monkeypatch, case, loop, spec):
    """Each fault case: the port's results and fault counters equal the
    reference's exactly, the faulted request (if any) carries its partial
    tokens and kind, co-residents complete, and every page returns to the
    pool."""
    chaos, reqs, victim = FAULT_CASES[case]
    got = {}
    for pkg in ("ref", "port"):
        sched, injector, faults, _ = PKG[pkg]
        faults.reset()
        if chaos:
            injector.install(injector.FaultInjector(injector.parse_chaos_spec(chaos)))
        else:  # a real error in the admission's pool scatter, once
            real, fired = sched.write_tokens, []

            def oom_once(*a, _real=real, _fired=fired, **kw):
                if not _fired:
                    _fired.append(1)
                    raise RuntimeError("RESOURCE_EXHAUSTED: pool scatter")
                return _real(*a, **kw)

            monkeypatch.setattr(sched, "write_tokens", oom_once)
        b = _batcher(pkg, llama, interleave=LOOPS[loop], speculative=spec)
        free0 = b.allocator.free_pages
        _submit(pkg, b, reqs)
        try:
            results = b.run_all()
        finally:
            injector.install(None)
        assert b.allocator.free_pages == free0
        b.allocator.check_invariants()
        got[pkg] = (_outcome(results), faults.snapshot())
    assert got["port"] == got["ref"]
    outcome, counters = got["port"]
    for req_id, n, toks, kind, error, _ in outcome:
        if req_id == victim:
            assert kind is not None and error
            assert len(toks) == n < 12
        else:
            assert kind is None and n == 12
    assert counters


@pytest.mark.parametrize("seam", ["kv_alloc", "scheduler_chunk"])
def test_fault_dump_reconstructs_the_eviction(llama, tmp_path, seam):
    """A final fault dumps the flight recorder at once, to the armed
    path's ``.fault`` sibling: schema-valid events whose FaultEvent names
    the seam, kind, slot, victim and pages freed as the reference's does,
    and whose victim's lifecycle ends ``evicted``."""
    chaos = {
        "kv_alloc": "bug@kv_alloc:times=1",
        "scheduler_chunk": "oom@scheduler_chunk:after=1:times=2:slot=1",
    }[seam]
    fault_events = {}
    for pkg in ("ref", "port"):
        sched, injector, _, obs = PKG[pkg]
        saved = (obs.config().enabled, obs.config().events_out)
        (tmp_path / pkg).mkdir()
        obs.configure(enabled=True, events_out=str(tmp_path / pkg / "flight.jsonl"))
        obs.reset_stats()
        try:
            injector.install(injector.FaultInjector(injector.parse_chaos_spec(chaos)))
            b = _batcher(pkg, llama, speculative=False)
            _submit(pkg, b, TWO)
            b.run_all()
        finally:
            injector.install(None)
            obs.configure(enabled=saved[0], events_out=saved[1])
        events = [
            json.loads(line)
            for line in (tmp_path / pkg / "flight.fault.jsonl").read_text().splitlines()
        ]
        assert all(validate_event(e) == [] for e in events)
        fe = [e for e in events if e["type"] == "fault"][-1]
        fault_events[pkg] = {
            k: fe[k] for k in ("seam", "kind", "slot", "req_id", "pages_freed", "requeued")
        }
        victim = [e for e in events if e["type"] == "request" and e["req_id"] == fe["req_id"]]
        assert victim[-1]["state"] == "evicted"
    assert fault_events["port"] == fault_events["ref"]
    fe = fault_events["port"]
    assert fe["seam"] == seam
    if seam == "kv_alloc":
        assert fe["pages_freed"] == 0 and fe["requeued"] is False
    else:
        assert fe["slot"] == 1 and fe["pages_freed"] > 0


def _cached_page_bytes(b) -> dict:
    return {
        page: {k: v[:, page + 1].clone() for k, v in b.pool.items()}
        for page in b.prefix_cache._by_page
    }


@pytest.mark.parametrize("spec", [False, True], ids=["nospec", "spec"])
def test_step_faulting_part_way_leaves_coresidents_and_cache_intact(llama, monkeypatch, spec):
    """A decode step that faults AFTER its forward wrote K/V into the pool
    (the port writes in place): the faulted slot is evicted, the
    co-resident rows' tokens equal a fault-free run, and every page the
    prefix cache held before the faulted round is byte-unchanged."""
    rng = np.random.default_rng(7)
    doc = [int(t) for t in rng.integers(3, 500, size=40)]
    prompts = [doc + [int(t) for t in rng.integers(3, 500, size=n)] for n in (5, 9, 14)]
    reqs = [(p, 8, {}) for p in prompts]

    def run(fault_at):
        b = _batcher("port", llama, max_batch=3, speculative=spec, prefix_cache=True,
                     page_size=16, capacity_tokens=1024)
        _submit("port", b, [(doc, 4, {})])
        b.run_all()  # round 1: the shared document's blocks are cached
        before = _cached_page_bytes(b)
        calls = {"n": 0}
        real = port_sched.forward_paged_decode

        def faulty(*a, **kw):
            out = real(*a, **kw)
            calls["n"] += 1
            if calls["n"] == fault_at:
                exc = RuntimeError("RESOURCE_EXHAUSTED: injected mid-step")
                exc.slot = 1
                raise exc
            return out

        monkeypatch.setattr(port_sched, "forward_paged_decode", faulty)
        _submit("port", b, reqs)
        results = b.run_all()
        monkeypatch.setattr(port_sched, "forward_paged_decode", real)
        after = _cached_page_bytes(b)
        for page, kv in before.items():
            for k in kv:
                assert torch.equal(after[page][k], kv[k]), (page, k)
        b.allocator.check_invariants()
        return results

    clean = run(fault_at=0)
    faulted = run(fault_at=3)
    assert [r.error for r in clean] == [None] * 3
    # Slot 1 (request 1) was evicted once (OOM is transient) and re-ran.
    for r, c in zip(faulted, clean):
        assert r.error is None
        assert r.tokens.tolist() == c.tokens.tolist(), r.req_id


def test_cuda_context_error_escapes_and_the_engine_fails_the_group(llama, monkeypatch):
    """A CUDA runtime error other than out-of-memory poisons the context:
    the batcher never evicts a slot and launches on; the error escapes
    ``run_all``, and ``GpuEngine`` drops the batcher and fails every row
    of the group. An out-of-memory error is contained to one slot."""
    real = port_sched.forward_paged_decode
    calls = {"n": 0}
    error = {"exc": None}

    def faulty(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise error["exc"]
        return real(*a, **kw)

    monkeypatch.setattr(port_sched, "forward_paged_decode", faulty)
    error["exc"] = torch.AcceleratorError("CUDA error: an illegal memory access was encountered")
    b = _batcher("port", llama, speculative=False)
    _submit("port", b, TWO)
    with pytest.raises(torch.AcceleratorError):
        b.run_all()
    calls["n"] = 0
    error["exc"] = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    b = _batcher("port", llama, speculative=False)
    _submit("port", b, TWO)
    results = b.run_all()
    assert [r.error for r in results] == [None, None]  # evicted once, requeued
    assert port_faults.snapshot() == {"scheduler_chunk.oom": 1}

    registry.save_registry_entry(
        registry.ModelSpec(alias="ctx-tiny", family="llama", size="tiny",
                           kv="paged", dtype="float32", mesh={"dp": 1},
                           max_seq_len=SEQ)
    )
    eng = GpuEngine(device="cpu")
    eng.install("ctx-tiny", llama["port"][0])
    calls["n"] = 0
    error["exc"] = torch.AcceleratorError("CUDA error: unspecified launch failure")
    comps = eng.chat(
        [ChatRequest("tpu://ctx-tiny", "s", "u")] * 2,
        SamplingParams(max_new_tokens=8, greedy=True),
    )
    assert [c.ok for c in comps] == [False, False]
    assert all("launch failure" in c.error for c in comps)
    assert eng._models["ctx-tiny"].batcher is None


@pytest.fixture
def paged_registry(tmp_path, monkeypatch):
    from adversarial_spec_tpu.engine import registry as ref_registry

    path = tmp_path / "registry.json"
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", path)
    registry.save_registry_entry(
        registry.ModelSpec(alias="chaos-tiny", family="llama", size="tiny",
                           kv="paged", dtype="float32", mesh={"dp": 1},
                           max_seq_len=SEQ)
    )


@pytest.mark.parametrize("seam", ["scheduler_chunk", "generate"])
def test_engine_faults_surface_as_the_reference(paged_registry, llama, seam):
    """Through the engines: a slot fault becomes that row's errored,
    transient completion while its co-resident stays clean; a fault at
    the ``generate`` seam fails the group. The same completions' status,
    errors and fault counters as the reference's ``TpuEngine``."""
    from adversarial_spec_tpu.engine.tpu import TpuEngine
    from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
    from adversarial_spec_tpu.engine.types import SamplingParams as RefParams

    chaos = {
        "scheduler_chunk": "oom@scheduler_chunk:after=1:times=2:slot=1",
        "generate": "device_lost@generate:times=1",
    }[seam]
    ref_spec.configure(enabled=False)
    port_spec.configure(enabled=False)
    got = {}
    for pkg in ("ref", "port"):
        _, injector, faults, _ = PKG[pkg]
        if pkg == "ref":
            eng, req, sp = TpuEngine(), RefChatRequest, RefParams
        else:
            eng, req, sp = GpuEngine(device="cpu"), ChatRequest, SamplingParams
        injector.install(injector.FaultInjector(injector.parse_chaos_spec(chaos)))
        try:
            comps = eng.chat(
                [req("tpu://chaos-tiny", "s", "u")] * 2,
                # Two 32-step chunks and the retry's: after=1 fires on
                # the second, then on the requeued row's first.
                sp(max_new_tokens=40, greedy=True),
            )
        finally:
            injector.install(None)
        got[pkg] = ([(c.ok, c.error, c.transient) for c in comps], faults.snapshot())
    assert got["port"] == got["ref"]
    oks = [ok for ok, _, _ in got["port"][0]]
    assert oks == ([True, False] if seam == "scheduler_chunk" else [False, False])
    assert all(t for ok, _, t in got["port"][0] if not ok)


# -- the per-request watchdog ------------------------------------------------


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_deadline_evicts_only_the_expired_slot(llama, loop):
    deliveries = []
    b = _batcher("port", llama, interleave=LOOPS[loop], max_new_cap=64,
                 speculative=False)
    total_pages = b.allocator.free_pages
    _submit("port", b, [
        ([1, 2, 3, 4] * 8, 64,
         {"deadline_s": 0.05, "on_tokens": lambda t: deliveries.append(len(t)) or True}),
        ([5, 6, 7] * 8, 8, {}),
    ])
    res = {r.req_id: r for r in b.run_all()}
    assert res[0].fault_kind == "timeout" and "watchdog deadline" in res[0].error
    assert res[0].n_generated < 64
    assert res[1].error is None and res[1].n_generated == 8
    b.allocator.check_invariants()
    assert b.allocator.free_pages == total_pages
    # The partial text reached the stream consumer before the eviction.
    if res[0].n_generated:
        assert deliveries[-1] == res[0].n_generated
    else:
        assert not deliveries
    # The co-resident's tokens are a fault-free run's.
    clean = _batcher("port", llama, interleave=LOOPS[loop], max_new_cap=64,
                     speculative=False)
    _submit("port", clean, [([5, 6, 7] * 8, 8, {})])
    assert clean.run_all()[0].tokens.tolist() == res[1].tokens.tolist()


@pytest.mark.parametrize("case", ["queued", "no_requeue", "speculative"])
def test_watchdog_cases(llama, case):
    """A queued request past its deadline resolves with zero tokens while
    the resident finishes; the watchdog's FaultEvent is at seam
    ``watchdog`` with no requeue; a speculating row times out too."""
    if case == "queued":
        b = _batcher("port", llama, max_batch=1, max_new_cap=32, speculative=False)
        _submit("port", b, [([1, 2, 3, 4], 32, {}), ([5, 6, 7, 8], 32, {"deadline_s": 1e-6})])
        res = {r.req_id: r for r in b.run_all()}
        assert res[0].error is None and res[0].n_generated == 32
        assert res[1].fault_kind == "timeout" and res[1].n_generated == 0
    elif case == "no_requeue":
        port_obs.recorder.clear()
        b = _batcher("port", llama, max_new_cap=64, speculative=False)
        _submit("port", b, [([1, 2, 3, 4] * 4, 64, {"deadline_s": 1e-4})])
        b.run_all()
        mine = [e for e in port_obs.recorder.events()
                if e["type"] == "fault" and e["seam"] == "watchdog"]
        assert mine and mine[-1]["kind"] == "timeout"
        assert mine[-1]["requeued"] is False
        assert port_faults.snapshot().get("watchdog.timeout", 0) >= 1
    else:
        b = _batcher("port", llama, max_new_cap=64, speculative=True, gamma=4)
        _submit("port", b, [([1, 2, 3, 4] * 8, 64, {"deadline_s": 0.05})])
        res = b.run_all()
        assert res[0].fault_kind == "timeout"
    b.allocator.check_invariants()


# -- the legacy loop ---------------------------------------------------------


@pytest.mark.parametrize("spec", [False, True], ids=["nospec", "spec"])
def test_legacy_loop_matches_reference(llama, spec):
    """``interleave`` off: four requests through two slots (queueing, slot
    reuse, a second round on the prefix cache) give the reference's
    tokens, cached tokens and speculation counts."""
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(3, 500, size=n)] for n in (3, 40, 70, 9)]
    budgets = [8, 10, 8, 10]
    got = {}
    for pkg in ("ref", "port"):
        b = _batcher(pkg, llama, interleave=False, speculative=spec,
                     page_size=16, capacity_tokens=1024, prefix_cache=True, chunk=8)
        assert b.interleave is False
        rounds = []
        for extra in (0, 17):
            reqs = [(p + [7] * extra, n, {}) for p, n in zip(prompts, budgets)]
            _submit(pkg, b, reqs)
            res = b.run_all()
            rounds.append([
                (r.tokens.tolist(), r.cached_tokens, r.spec_steps, r.spec_drafted,
                 r.spec_accepted)
                for r in res
            ])
        b.allocator.check_invariants()
        got[pkg] = rounds
    assert got["port"] == got["ref"]
    assert sum(r[1] for r in got["port"][1]) > 0


@pytest.fixture
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def paged_f32(_port_state, tmp_path, monkeypatch):
    """A ``kv="paged"`` f32 tiny alias served by both CLIs: the
    reference's engine loads it, the port's ``GpuEngine(device="cpu")``
    holds the same weights. Yields a runner: argv → each package's
    ``--json`` report without its walls."""
    registry_path = tmp_path / "registry.json"
    for pkg in ("ref", "port"):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg, registry_path)
    registry.save_registry_entry(
        registry.ModelSpec(alias="paged-f32", family="llama", size="tiny",
                           dtype="float32", mesh={"dp": 1}, kv="paged",
                           max_seq_len=SEQ)
    )
    ref_engine = ref_dispatch.get_engine("tpu://paged-f32")
    lm = ref_engine._load("paged-f32")
    port = GpuEngine(device="cpu")
    port.install(
        "paged-f32",
        params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32),
    )
    port_dispatch.install_engine("tpu://paged-f32", port)

    def run(extra, capsys):
        argv = ["critique", "--models", ",".join(["tpu://paged-f32"] * 3), "--greedy",
                "--max-new-tokens", "24", "--json", *extra]
        docs = []
        for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
            sup.point_state(monkeypatch, pkg, tmp_path / pkg, registry_path)
            code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, SPEC)
            assert code == 0, err
            docs.append(sup.without_walls(sup.normalize_report(json.loads(out), pkg)))
        return docs

    yield port, run


def _compiles_compared(docs) -> None:
    """Prepare two reports' ``perf.obs`` for comparison. The reference
    counts real jit compiles through its trace-cache probe, so a program
    another test of this process already compiled counts none there;
    the port has no jit cache and counts a compile for each new dispatch
    key. Where a program's ``compiles`` differ (the port's must then be
    its distinct keys, and more), that one field is dropped from both and
    the port's extra compile events are taken off its recorder totals.
    Programs, dispatches, distinct keys, unexpected recompiles (0 in
    both), sync reasons and every other event count stay compared."""
    ref, port = (d["perf"]["obs"] for d in docs)
    assert set(port["retrace"]["programs"]) == set(ref["retrace"]["programs"])
    assert ref["retrace"]["unexpected_recompiles"] == 0
    assert port["retrace"]["unexpected_recompiles"] == 0
    extra = 0
    for name, p in port["retrace"]["programs"].items():
        r = ref["retrace"]["programs"][name]
        if r["compiles"] != p["compiles"]:
            assert p["compiles"] == p["distinct_keys"] > r["compiles"], name
            extra += p.pop("compiles") - r.pop("compiles")
    if extra:
        events = port["events_by_type"]
        events["compile"] -= extra
        if not events["compile"]:
            del events["compile"]
        port["recorder"]["recorded"] -= extra
        port["recorder"]["buffered"] -= extra


def test_no_interleave_paged_critique_matches_reference(paged_f32, capsys):
    """Fault C.6: ``critique --no-interleave`` on a ``kv="paged"`` alias
    exits 0 through the port's CLI (its batcher runs the legacy loop)
    with the reference CLI's ``--json``, wall clocks aside, ``perf.obs``
    (the retrace watch's report) included."""
    port, run = paged_f32
    docs = run(["--no-interleave"], capsys)
    _compiles_compared(docs)
    assert docs[1] == docs[0]
    assert docs[1]["perf"]["interleave"]["enabled"] is False
    assert [r["error"] for r in docs[1]["results"]] == [None] * 3
    assert port._models["paged-f32"].batcher.interleave is False


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
def test_paged_critique_retrace_matches_reference(paged_f32, monkeypatch, capsys, spec):
    """A paged ``critique --json`` in the pipelined loop at depth 2: the
    retrace watch reports the reference's programs, dispatches and
    distinct keys, no unexpected recompile in either, and the same sync
    reasons. The reference's entries are made to resolve before they are
    checked, as the port's CPU copies always are: on the CPU its async
    dispatch otherwise leaves a step unresolved at random, and the depth
    bound then adds a dispatch. With speculation off the port's
    ``perf.interleave.sync_points`` also counts the decode loop's
    per-step host reads (engine/interleave.py), so that one field is
    left out there."""
    def resolved(entry):
        entry[0].block_until_ready()
        return True

    monkeypatch.setattr(ref_sched.ContinuousBatcher, "_entry_ready", staticmethod(resolved))
    port, run = paged_f32
    docs = run(["--interleave", "--speculative" if spec else "--no-speculative"], capsys)
    _compiles_compared(docs)
    retrace = docs[1]["perf"]["obs"]["retrace"]["programs"]
    used = {k for k, v in retrace.items() if v["dispatches"]}
    assert used == {"prefill_chunk", "scheduler_spec_chunk" if spec else "scheduler_decode_chunk"}
    if not spec:
        for d in docs:
            d["perf"]["interleave"].pop("sync_points")
    assert docs[1] == docs[0]
    assert port._models["paged-f32"].batcher.pipeline_depth == 2
