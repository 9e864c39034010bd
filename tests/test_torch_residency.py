"""``GpuEngine``'s weight residency on the CPU: the reference's
``TestEngineResidency`` (``tests/test_weightres.py``) and budget tests
(``tests/test_tpu_engine.py``), run on the port.

The budget is set with ``ADVSPEC_HBM_BUDGET_BYTES`` in multiples of one
model's bytes. Covered: LRU eviction under the byte budget, two models
resident together within it, the next group's prefetch, demote→promote
byte identity, the freeing where paging is off or the host budget is
too small, resident-first group order, int4 weights paged quantized, no
leak over many models, a swap fault that degrades only the admission
waiting on it, a staged promotion that rides the current group's decode,
and the ledger through the CLI's ``perf.weights``, and a re-promoted
model served with no unexpected recompile in the retrace watch (the port
compiles nothing: its watch counts new dispatch keys).
"""

import gc
import json
import weakref

import pytest
import torch

from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch import obs
from adversarial_spec_tpu_torch.engine import dispatch, registry, weightres
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine.gpu import (
    GpuEngine,
    HostArena,
    HostWeights,
    estimate_param_bytes,
    hbm_budget_bytes,
    param_bytes,
)
from adversarial_spec_tpu_torch.engine.registry import ModelSpec
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.ops.quant import is_quantized_int4
from adversarial_spec_tpu_torch.resilience import injector

from tests import torch_cli_support as sup

PARAMS = SamplingParams(max_new_tokens=8, greedy=True)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """The port's state under ``tmp_path``, speculation off (it only
    multiplies the work here), no budget override unless a test sets one,
    and one intra-op thread: a prefetch thread's torch ops beside the
    serving thread's would each spin up a team of every core, which on a
    loaded host costs the tiny models here far more than it saves."""
    monkeypatch.delenv("ADVSPEC_HBM_BUDGET_BYTES", raising=False)
    prev, threads = spec_mod.config().enabled, torch.get_num_threads()
    spec_mod.configure(enabled=False)
    torch.set_num_threads(1)
    yield from sup.isolate_port(tmp_path, monkeypatch)
    torch.set_num_threads(threads)
    spec_mod.configure(enabled=prev)
    injector.install(None)


def _req(model, user="hello"):
    return ChatRequest(model=model, system="sys", user=user)


def _one(eng, alias) -> int:
    return eng.ledger._entries[alias].bytes_device


def _budget(monkeypatch, nbytes: float) -> None:
    monkeypatch.setenv("ADVSPEC_HBM_BUDGET_BYTES", str(int(nbytes)))


def _register(alias, **kw):
    registry.save_registry_entry(
        ModelSpec(alias=alias, family="llama", size="tiny", dtype="float32", **kw)
    )


# -- budget (tests/test_tpu_engine.py) -----------------------------------------


def test_budget_from_env_or_device_memory(monkeypatch):
    assert hbm_budget_bytes(torch.device("cpu")) == int(16 * (1 << 30) * 0.75)
    _budget(monkeypatch, 12345)
    assert hbm_budget_bytes(torch.device("cpu")) == 12345


@pytest.mark.parametrize(
    "spec",
    [
        ModelSpec(alias="e-bf16", family="llama", size="tiny"),
        ModelSpec(alias="e-int8", family="llama", size="tiny", dtype="float32", quant="int8"),
        ModelSpec(alias="e-int4", family="mistral", size="tiny", quant="int4"),
        ModelSpec(alias="e-tied", family="gemma2", size="tiny"),
    ],
    ids=lambda s: s.alias,
)
def test_estimate_is_the_loaded_bytes(spec):
    registry.save_registry_entry(spec)
    eng = GpuEngine(device="cpu")
    lm = eng._load(spec.alias)
    assert estimate_param_bytes(spec) == param_bytes(lm.params) == lm.bytes_per_chip > 0


def test_byte_budget_evicts_lru(monkeypatch):
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    one = eng._models["random-tiny"].bytes_per_chip
    assert one > 0
    _budget(monkeypatch, one * 1.5)
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)
    assert "random-mistral-tiny" in eng._models
    assert "random-tiny" not in eng._models
    assert sum(m.bytes_per_chip for m in eng._models.values()) <= hbm_budget_bytes(eng.device)


def test_two_model_round_within_budget_stays_resident():
    eng = GpuEngine(device="cpu")
    reqs = [_req("tpu://random-tiny"), _req("tpu://random-mistral-tiny")]
    eng.chat(reqs, PARAMS)
    assert {"random-tiny", "random-mistral-tiny"} <= set(eng._models)
    weightres.reset_stats()
    assert all(c.ok for c in eng.chat(reqs, PARAMS))
    assert weightres.stats.loads == 0 and weightres.stats.promotions == 0


def test_heterogeneous_round_prefetches_next_group():
    eng = GpuEngine(device="cpu")
    comps = eng.chat([_req("tpu://random-tiny"), _req("tpu://random-mistral-tiny")], PARAMS)
    assert all(c.ok for c in comps), [c.error for c in comps]
    assert eng.prefetch_hits >= 1
    eng.check_residency_invariants()


# -- TestEngineResidency (tests/test_weightres.py) -----------------------------


def test_demote_promote_byte_identical(monkeypatch):
    eng = GpuEngine(device="cpu")
    base = eng.chat([_req("tpu://random-tiny")], PARAMS)[0]
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)
    assert eng.ledger.is_host("random-tiny")
    assert eng.ledger.is_resident("random-mistral-tiny")
    assert "random-tiny" not in eng._models
    again = eng.chat([_req("tpu://random-tiny")], PARAMS)[0]
    assert again.text == base.text
    assert eng.ledger.is_host("random-mistral-tiny")
    eng.check_residency_invariants()
    assert weightres.stats.promotions >= 1


def test_repromotion_zero_unexpected_recompiles(monkeypatch):
    """The reference's demote → promote → serve check: a promoted paged
    model serves through the same dispatch keys, so the retrace watch,
    cleared before the round, sees its programs and no unexpected
    recompile."""
    _register("cont-tiny", kv="paged")
    eng = GpuEngine(device="cpu")
    base = eng.chat([_req("tpu://cont-tiny", "alpha beta")], PARAMS)
    assert base[0].ok, base[0].error
    # random-tiny is bf16 (half the f32 bytes): 1.2x leaves no room for
    # even the half-size newcomer beside cont-tiny.
    _budget(monkeypatch, _one(eng, "cont-tiny") * 1.2)
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    assert eng.ledger.is_host("cont-tiny")
    obs.retrace.clear()
    again = eng.chat([_req("tpu://cont-tiny", "alpha beta")], PARAMS)
    assert again[0].ok and again[0].text == base[0].text
    snap = obs.retrace.snapshot()
    assert snap["unexpected_recompiles"] == 0, snap
    used = {k for k, v in snap["programs"].items() if v["dispatches"]}
    assert "prefill_chunk" in used
    assert used & {"scheduler_decode_chunk", "scheduler_spec_chunk"}


def test_paging_off_frees_instead(monkeypatch):
    weightres.configure(enabled=False)
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)
    assert eng.ledger.state("random-tiny") is None
    assert weightres.stats.freed_models == 1
    assert weightres.stats.demotions == 0
    eng.check_residency_invariants()


def test_entry_larger_than_the_host_budget_is_freed(monkeypatch):
    """A model whose weights exceed the whole host budget is freed, not
    copied to the host and dropped there."""
    weightres.configure(enabled=True, host_mb=1)
    _register("big-f32")
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://big-f32")], PARAMS)
    assert _one(eng, "big-f32") > 1 << 20
    _budget(monkeypatch, _one(eng, "big-f32") * 1.2)
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    assert eng.ledger.state("big-f32") is None
    assert weightres.stats.freed_models == 1 and weightres.stats.demotions == 0
    eng.check_residency_invariants()


def test_failed_demotion_frees_the_victim(monkeypatch):
    """A device→host copy that fails mid-demotion frees the victim in the
    ledger too: the admission that needed the room degrades, the ledger
    and the engine stay in step, and the next round loads afresh."""
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)

    def boom(params):
        raise RuntimeError("host copy failed")

    eng._to_host = boom
    (c,) = eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)
    assert not c.ok and "host copy failed" in c.error
    assert eng.ledger.state("random-tiny") is None
    eng.check_residency_invariants()
    del eng._to_host
    assert eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)[0].ok
    eng.check_residency_invariants()


def test_resident_first_group_order(monkeypatch):
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)
    served = []
    orig = GpuEngine._chat_one_model

    def spy(self, alias, *a, **k):
        served.append(alias)
        return orig(self, alias, *a, **k)

    monkeypatch.setattr(GpuEngine, "_chat_one_model", spy)
    before = weightres.stats.coalesced_groups
    comps = eng.chat([_req("tpu://random-tiny"), _req("tpu://random-mistral-tiny")], PARAMS)
    assert all(c.ok for c in comps)
    assert served == ["random-mistral-tiny", "random-tiny"]
    assert weightres.stats.coalesced_groups == before + 1


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_int4_model_serves_and_pages_quantized(monkeypatch, kv_dtype):
    """An int4 paged model serves through the batcher, its packed leaves
    are what demote to the host and promote back, and the text is
    byte-identical across the round trip (with an int8 KV cache too)."""
    _register("res-int4-tiny", quant="int4", kv="paged", kv_dtype=kv_dtype)
    eng = GpuEngine(device="cpu")
    base = eng.chat([_req("tpu://res-int4-tiny")], PARAMS)[0]
    assert base.ok, base.error
    lm = eng._models["res-int4-tiny"]
    assert is_quantized_int4(lm.params["layers"][0]["wq"])
    assert is_quantized_int4(lm.params["lm_head"])
    assert lm.batcher is not None
    _budget(monkeypatch, _one(eng, "res-int4-tiny") * 1.5)
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    assert eng.ledger.is_host("res-int4-tiny")
    entry = eng.ledger.peek_host("res-int4-tiny")
    assert isinstance(entry.payload, HostWeights)
    host_wq = entry.payload.host_params["layers"][0]["wq"]
    assert set(host_wq) == {"q4", "scale"}
    assert host_wq["q4"].dtype == torch.int8 and host_wq["q4"].device.type == "cpu"
    again = eng.chat([_req("tpu://res-int4-tiny")], PARAMS)[0]
    assert again.text == base.text
    assert is_quantized_int4(eng._models["res-int4-tiny"].params["layers"][0]["wq"])
    eng.check_residency_invariants()


def test_no_leak_many_models_one_process(monkeypatch):
    """Cycling many models keeps a bounded resident set, a byte-bounded
    host tier, and frees every demoted model's batcher with its weights."""
    aliases = [f"leak-{i}" for i in range(6)]
    for alias in aliases:
        _register(alias, kv="paged")
    eng = GpuEngine(device="cpu")
    eng.chat([_req(f"tpu://{aliases[0]}")], PARAMS)
    one = _one(eng, aliases[0])
    _budget(monkeypatch, one * 2.5)
    host_mb = max(1, (3 * one) >> 20)
    weightres.configure(enabled=True, host_mb=host_mb)
    batcher_refs = []
    for alias in aliases:
        comps = eng.chat([_req(f"tpu://{alias}")], PARAMS)
        assert comps[0].ok, comps[0].error
        lm = eng._models.get(alias)
        if lm is not None and lm.batcher is not None:
            batcher_refs.append(weakref.ref(lm.batcher))
    eng.check_residency_invariants()
    assert sum(m.bytes_per_chip for m in eng._models.values()) <= hbm_budget_bytes(eng.device)
    assert eng.ledger.resident_models <= 2
    assert eng.ledger.host_bytes <= host_mb << 20
    assert weightres.stats.freed_models > 0
    gc.collect()
    live = sum(1 for r in batcher_refs if r() is not None)
    assert live <= len(eng._models), f"{live} batchers alive for {len(eng._models)} models"


def test_swap_fault_evicts_only_waiting_admission(monkeypatch, tmp_path):
    """A fault mid-promotion degrades ONLY the group waiting on the swap;
    the ledger stays conservation-clean with the victim still on the
    host, the dump shows the failed swap, and the next round heals."""
    events_out = tmp_path / "ev.jsonl"
    obs.configure(enabled=True, events_out=str(events_out))
    eng = GpuEngine(device="cpu")
    eng.chat([_req("tpu://random-tiny")], PARAMS)
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)
    reqs = [_req("tpu://random-tiny"), _req("tpu://random-mistral-tiny")]
    base = eng.chat(reqs, PARAMS)
    assert all(c.ok for c in base)
    victim = next(a for a in ("random-tiny", "random-mistral-tiny") if eng.ledger.is_host(a))
    injector.install(
        injector.FaultInjector(injector.parse_chaos_spec("oom@weight_swap:times=1"))
    )
    try:
        comps = eng.chat(reqs, PARAMS)
    finally:
        injector.install(None)
    by_model = dict(zip(("random-tiny", "random-mistral-tiny"), comps))
    assert not by_model[victim].ok and by_model[victim].transient
    other = next(a for a in by_model if a != victim)
    assert by_model[other].ok, by_model[other].error
    assert eng.ledger.is_host(victim)
    eng.check_residency_invariants()
    assert weightres.stats.swap_faults == 1
    dump = tmp_path / "ev.fault.jsonl"
    lines = [json.loads(ln) for ln in dump.read_text().splitlines() if ln]
    swap_faults = [e for e in lines if e["type"] == "weight" and e["op"] == "swap_fault"]
    assert [e for e in lines if e["type"] == "fault"] and swap_faults
    assert swap_faults[-1]["alias"] == victim
    again = eng.chat(reqs, PARAMS)
    assert [c.text for c in again] == [c.text for c in base]
    eng.check_residency_invariants()


def test_staged_promotion_rides_the_current_decode(monkeypatch):
    """With the budget full and the next group's weights on the host, the
    LRU resident demotes while the current (pinned) group serves, and the
    next model promotes on the prefetch thread: counted as overlapped and
    as a prefetch hit, with the text of a foreground promotion."""
    for alias in ("st-a", "st-b", "st-c"):
        _register(alias)
    ref = GpuEngine(device="cpu")
    solo = {a: ref.chat([_req(f"tpu://{a}")], PARAMS)[0].text for a in ("st-a", "st-b", "st-c")}
    eng = GpuEngine(device="cpu")
    _budget(monkeypatch, _one(ref, "st-a") * 2.5)
    for alias in ("st-c", "st-a", "st-b"):  # loading st-b demotes st-c
        eng.chat([_req(f"tpu://{alias}")], PARAMS)
    assert eng.ledger.is_host("st-c")
    hits, overlapped = eng.prefetch_hits, weightres.stats.promotions_overlapped
    comps = eng.chat([_req("tpu://st-a"), _req("tpu://st-b"), _req("tpu://st-c")], PARAMS)
    assert [c.text for c in comps] == [solo["st-a"], solo["st-b"], solo["st-c"]]
    assert weightres.stats.promotions_overlapped == overlapped + 1
    assert eng.prefetch_hits == hits + 1
    eng.check_residency_invariants()


def test_host_arena_views_hold_exact_copies():
    """A demoted model's leaves are views of one host arena, each aligned,
    typed and shaped as its source and bit-identical to it."""
    leaves_ = [
        torch.randn(3, 5, dtype=torch.bfloat16),
        torch.randint(-128, 127, (7, 3), dtype=torch.int8),
        torch.randn(11, dtype=torch.float32),
        torch.randint(-8, 7, (1, 1), dtype=torch.int8),
    ]
    arena = HostArena(sum(HostArena.size_of(t) for t in leaves_), pin=False)
    views = [arena.take(t).copy_(t) for t in leaves_]
    assert not arena.pinned
    assert arena.buf.numel() == sum(HostArena.size_of(t) for t in leaves_)
    for v, t in zip(views, leaves_):
        assert v.dtype == t.dtype and v.shape == t.shape and torch.equal(v, t)
        assert (v.data_ptr() - arena.buf.data_ptr()) % HostArena.ALIGN == 0
    assert param_bytes(views) == param_bytes(leaves_)


def test_promoted_arena_serves_the_next_demotion(monkeypatch):
    """A promoted model's host arena is kept and the next demotion copies
    into it (no fresh host pages); spares and host-tier weights stay
    within the host budget."""
    eng = GpuEngine(device="cpu")
    base = eng.chat([_req("tpu://random-tiny")], PARAMS)[0]
    _budget(monkeypatch, _one(eng, "random-tiny") * 1.5)
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)  # tiny demotes
    first = eng.ledger.peek_host("random-tiny").payload.arena
    again = eng.chat([_req("tpu://random-tiny")], PARAMS)[0]  # promote; mistral demotes
    assert again.text == base.text
    assert eng._spare_arenas == [first]
    mistral = eng.ledger.peek_host("random-mistral-tiny").payload.arena
    assert mistral is not first
    eng.chat([_req("tpu://random-mistral-tiny")], PARAMS)  # tiny demotes again
    assert eng.ledger.peek_host("random-tiny").payload.arena is first
    assert eng._spare_arenas == [mistral]
    assert eng.chat([_req("tpu://random-tiny")], PARAMS)[0].text == base.text
    weightres.configure(host_mb=1)  # no spare holds 64 MiB: all dropped
    assert eng._arena_for(64 << 20) not in (first, mistral)
    assert eng._spare_arenas == []
    eng.check_residency_invariants()


def test_install_admits_to_the_ledger():
    eng = GpuEngine(device="cpu")
    ref = GpuEngine(device="cpu")
    lm = ref._load("random-tiny")
    eng.install("random-tiny", lm.params)
    assert eng.ledger.is_resident("random-tiny")
    assert _one(eng, "random-tiny") == param_bytes(lm.params)
    eng.check_residency_invariants()


# -- through the CLI -----------------------------------------------------------


def test_cli_reports_the_live_ledger(tmp_path, monkeypatch, capsys):
    """Two rounds through the port's CLI over a pool larger than the
    budget: round 1 loads both models and demotes one; round 2
    (``--resume``) serves the resident model first and promotes the other
    instead of loading it, and ``perf.weights`` says so."""
    for alias in ("cli-a", "cli-b"):
        _register(alias, max_seq_len=512)  # the debate prompt, trimmed
    eng = GpuEngine(device="cpu")
    dispatch.install_engine("tpu://cli-a", eng)
    one = estimate_param_bytes(registry.resolve_model_spec("tpu://cli-a"))
    _budget(monkeypatch, one * 1.5)
    spec = "# Spec\nThe API MUST rate-limit.\n"
    code, out, err = sup.run_cli(
        port_cli,
        ["critique", "--models", "tpu://cli-a,tpu://cli-b", "--session", "res",
         "--weight-host-mb", "64", "--greedy", "--max-new-tokens", "8", "--json"],
        monkeypatch, capsys, spec,
    )
    assert code == 0, err
    w1 = json.loads(out)["perf"]["weights"]
    assert (w1["enabled"], w1["host_mb"], w1["loads"], w1["demotions"]) == (True, 64, 2, 1)
    code, out, err = sup.run_cli(
        port_cli,
        ["critique", "--resume", "res", "--greedy", "--max-new-tokens", "8", "--json"],
        monkeypatch, capsys,
    )
    assert code == 0, err
    w2 = json.loads(out)["perf"]["weights"]
    assert w2["loads"] == 0 and w2["promotions"] == 1 and w2["demotions"] == 1
    assert w2["coalesced_groups"] == 1
    assert w2["reload_avoided_rate"] == 1.0
    eng.check_residency_invariants()
