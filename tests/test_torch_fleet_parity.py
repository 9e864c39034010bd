"""The port's fleet against the reference's, on the same inputs.

Scripted ``mock://`` scenarios run through both packages' ``FleetEngine``
over in-process replicas and give equal completions, ``perf.fleet``
snapshots, handoff ledgers and route/replica events (trace ids masked):
affinity over rounds, an injected replica-seam fault, a heartbeat
retirement, and the disaggregated handoff adopted, degraded and
abandoned. Both CLIs run ``critique --fleet --fleet-replicas 2
[--fleet-prefill-replicas 1] [--fleet-transport worker] --json`` and give
the same exit code and report.

Then ``tpu://random-tiny`` (paged, f32, one device) debates two rounds of
one session on a two-replica fleet through both CLIs: the reference's
replicas are fresh ``TpuEngine``s, the port's fresh ``GpuEngine(device=
"cpu")``s holding the reference's weights (``params_from_jax``, through
the fleet's ``engine_factory`` seam). Responses are byte-identical, round
2 lands on round 1's replica and is served partly from its prefix cache,
and with one prefill replica the handoff degrades as ``prefill_error``
(neither engine has a disaggregated ``prefill``) in both.

Last, the repair of the engine cycle: a ``GpuEngine`` whose paged
batcher ran with KV tiers is freed by ``del`` alone, with the garbage
collector off.
"""

from __future__ import annotations

import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from tests import torch_cli_support as sup

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu import fleet as ref_fleet
from adversarial_spec_tpu import obs as ref_obs
from adversarial_spec_tpu.engine import kvtier as ref_kvtier
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu.fleet.router import FleetEngine as RefFleetEngine
from adversarial_spec_tpu.resilience import injector as ref_injector
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch import fleet as port_fleet
from adversarial_spec_tpu_torch import obs as port_obs
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.fleet.router import FleetEngine
from adversarial_spec_tpu_torch.resilience import injector as port_injector

# Each package's fleet-facing modules, by the names the scenarios use.
PKG = {
    "ref": dict(
        fleet=ref_fleet, obs=ref_obs, kvtier=ref_kvtier, injector=ref_injector,
        FleetEngine=RefFleetEngine, ChatRequest=RefChatRequest, Params=RefParams,
    ),
    "port": dict(
        fleet=port_fleet, obs=port_obs, kvtier=port_kvtier, injector=port_injector,
        FleetEngine=FleetEngine, ChatRequest=ChatRequest, Params=SamplingParams,
    ),
}

DOC = (
    "## Goals\nShip the spec.\n## Constraints\n"
    + "The decode replica SHALL NOT re-prefill shipped blocks. " * 40
)


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    """The port's state under ``tmp_path``, and one intra-op thread: the
    tiny models here gain nothing from a team of every core, which on a
    loaded host costs them far more. The reference's speculation knobs
    outlive its tests (a serve brownout retunes gamma); both packages
    start these from their env."""
    from adversarial_spec_tpu.engine import spec as ref_spec

    ref_spec.configure(enabled=ref_spec.env_enabled(), gamma=ref_spec.env_gamma())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield from sup.isolate_port(tmp_path, monkeypatch)
    torch.set_num_threads(threads)


def _mask(node):
    if isinstance(node, dict):
        return {
            k: ("<m>" if k in ("trace_id", "span_id") else _mask(v))
            for k, v in node.items()
        }
    if isinstance(node, list):
        return [_mask(v) for v in node]
    return node


def _reqs(pkg, key, n=3, rnd=1):
    cls = PKG[pkg]["ChatRequest"]
    return [
        cls(
            model=f"mock://critic?v={k}",
            system="You are a reviewer.",
            user=f"--- DOCUMENT ---\n{DOC}\n--- END DOCUMENT ---\n"
            f"Debate round {rnd}, opponent {k}.",
            affinity_key=key,
            trace_id=f"tr-{key}-{rnd}",
            span_id=f"tr-{key}-{rnd}/s{k:02d}",
        )
        for k in range(n)
    ]


def _scenario(pkg, name, tmp_path):
    """One scripted scenario through ``pkg``'s fleet: (completions, the
    fleet snapshot, the handoff ledger's snapshot and outcomes, the
    masked route/replica events)."""
    m = PKG[pkg]
    fleet, obs = m["fleet"], m["obs"]
    fleet.reset_stats()
    obs.reset_stats()
    params = m["Params"](max_new_tokens=32, greedy=True)
    kw = {}
    if name.startswith("disagg"):
        store = "" if name == "disagg_no_store" else str(tmp_path / pkg / "store")
        m["kvtier"].configure(enabled=True, host_mb=64, store_dir=store)
        kw["prefill_replicas"] = 1
    eng = m["FleetEngine"](replicas=2 if kw else 3, transport="inproc", **kw)
    comps = []
    try:
        if name == "injected_fault":
            m["injector"].install(m["injector"].FaultInjector(
                m["injector"].parse_chaos_spec("device_lost@replica:times=1")
            ))
        if name == "heartbeat_retire":
            eng.router.replica(eng.router.alive_ids()[0]).closed = True
        if name == "disagg_prefill_error":
            def boom(requests, params):
                raise RuntimeError("prefill replica exploded")

            eng.router.replica("r0").prefill = boom
        keys = ["debate-A", "debate-B"] if not kw else ["debate-dis"]
        for rnd in (1, 2):
            for key in keys:
                comps += eng.chat(_reqs(pkg, key, rnd=rnd), params)
        events = [
            e for e in obs.recorder.events() if e["type"] in ("route", "replica")
        ]
        return (
            [(c.text, c.error, c.usage.cached_tokens) for c in comps],
            fleet.snapshot(),
            eng.handoff.snapshot(),
            [eng.handoff.outcome(k) for k in keys],
            _mask(events),
        )
    finally:
        m["injector"].install(None)
        eng.shutdown()
        m["kvtier"].configure(enabled=False, store_dir="")


SCENARIOS = (
    "affinity",
    "injected_fault",
    "heartbeat_retire",
    "disagg_adopt",
    "disagg_prefill_error",
    "disagg_no_store",
)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scripted_fleet_matches_reference(name, tmp_path):
    ref = _scenario("ref", name, tmp_path)
    got = _scenario("port", name, tmp_path)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2:4] == ref[2:4]
    assert got[4] == ref[4]
    assert all(err is None for _, err, _ in got[0])
    snap = got[1]
    assert snap["duplicated_completions"] == 0
    outcome = {
        "disagg_adopt": "adopted",
        "disagg_prefill_error": "degraded",
        "disagg_no_store": "abandoned",
    }.get(name)
    assert got[3] == ([outcome] if outcome else [None, None])
    if name == "affinity":
        assert snap["affinity_hit_rate"] == 1.0
        # Round 2 of each debate hit its replica's prefix cache.
        assert all(c > 0 for _, _, c in got[0][6:])
    if name == "injected_fault":
        assert snap["failover_hops"] == 3
    if name == "heartbeat_retire":
        assert snap["heartbeat_failures"] == 1 and snap["replicas_retired"] == 1


@pytest.mark.parametrize(
    "extra",
    [[], ["--fleet-prefill-replicas", "1"], ["--fleet-transport", "worker"]],
    ids=["symmetric", "prefill1", "worker"],
)
def test_cli_fleet_round_matches_reference(extra, tmp_path, monkeypatch, capsys):
    """``critique --fleet --fleet-replicas 2 ... --json`` through both
    CLIs: the same exit code, stderr summary and report, ``perf.fleet``
    included."""
    argv = ["critique", "--models", "mock://critic?v=1,mock://critic?v=2,mock://agree",
            "--fleet", "--fleet-replicas", "2", *extra, "--json"]
    got = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg)
        code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, DOC)
        got.append((code, sup.normalize_stdout(out, pkg),
                     [ln for ln in err.splitlines() if ln.startswith("fleet:")]))
        (ref_fleet if pkg == "ref" else port_fleet).shutdown_fleet()
    assert got[1] == got[0]
    code, doc, summary = got[1]
    assert code == 0
    fleet = doc["perf"]["fleet"]
    assert fleet["enabled"] is True and fleet["routed_requests"] == 3
    assert summary == ["fleet: 3 request(s) routed across 2 replica(s), affinity hit rate 100%"]
    if extra[:1] == ["--fleet-prefill-replicas"]:
        assert fleet["handoff_attempts"] == 1


# -- tpu://random-tiny on a two-replica fleet ---------------------------------


@pytest.fixture
def paged_tiny(tmp_path):
    """``tpu://random-tiny`` as a paged f32 one-device entry in the
    registry file both packages read; the reference's weights for it."""
    from adversarial_spec_tpu.engine.tpu import TpuEngine

    registry.save_registry_entry(registry.ModelSpec(
        alias="random-tiny", family="llama", size="tiny", dtype="float32",
        mesh={"dp": 1}, kv="paged",
    ))
    lm = TpuEngine()._load("random-tiny")
    return params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32)


def _port_replica_engine(params):
    def factory(model):
        eng = GpuEngine(device="cpu")
        eng.install("random-tiny", params)
        return eng

    return factory


@pytest.mark.parametrize("prefill", [0, 1], ids=["symmetric", "prefill1"])
def test_tpu_fleet_debate_matches_reference(prefill, paged_tiny, tmp_path, monkeypatch, capsys):
    """Two rounds of one session on two in-process replicas: byte-identical
    responses and equal token counts and ``perf.fleet``; round 2 routes to
    round 1's replica (affinity hit) and reuses its prefix cache; with one
    prefill replica the handoff degrades as ``prefill_error``."""
    fleet_argv = ["--fleet", "--fleet-replicas", "2",
                  "--fleet-prefill-replicas", str(prefill)]
    rounds = (
        ["critique", "--models", ",".join(["tpu://random-tiny"] * 3), "--greedy",
         "--max-new-tokens", "12", "--session", "fl", "--json", *fleet_argv],
        ["critique", "--resume", "fl", "--greedy", "--max-new-tokens", "12",
         "--json", *fleet_argv],
    )
    docs = {}
    for pkg, cli_mod, fleet, cls in (
        ("ref", ref_cli, ref_fleet, RefFleetEngine),
        ("port", port_cli, port_fleet, FleetEngine),
    ):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg, tmp_path / "registry.json")
        fleet.configure(enabled=True, replicas=2, transport="inproc",
                        prefill_replicas=prefill)
        factory = None if pkg == "ref" else _port_replica_engine(paged_tiny)
        engine = cls(replicas=2, transport="inproc", engine_factory=factory,
                     prefill_replicas=prefill)
        fleet.install_engine(engine)
        try:
            docs[pkg] = []
            for argv in rounds:
                code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, DOC)
                assert code == 0, err
                docs[pkg].append(json.loads(out))
            served = {s["replica"]: s["served"] for s in engine.router.replica_stats()}
        finally:
            fleet.shutdown_fleet()
        docs[pkg].append(served)
    for ref, got in zip(docs["ref"][:2], docs["port"][:2]):
        assert [r["error"] for r in got["results"]] == [None] * 3
        for r, g in zip(ref["results"], got["results"]):
            assert g["response"].encode() == r["response"].encode()
            for k in ("input_tokens", "output_tokens", "cached_tokens", "agreed"):
                assert g[k] == r[k], k
        assert got["perf"]["fleet"] == ref["perf"]["fleet"]
        assert got["perf"]["prefix_cache"] == ref["perf"]["prefix_cache"]
    assert docs["port"][2] == docs["ref"][2]
    r1, r2 = docs["port"][0], docs["port"][1]
    assert r2["round"] == 2
    # Every request of both rounds landed on one replica: its primary.
    assert r1["perf"]["fleet"]["affinity_hit_rate"] == 1.0
    assert r2["perf"]["fleet"]["affinity_hit_rate"] == 1.0
    assert len([s for s in docs["port"][2].values() if s]) == 1
    assert sum(r["cached_tokens"] for r in r2["results"]) > 0
    assert r1["results"][0]["output_tokens"] > 0
    if prefill:
        assert r1["perf"]["fleet"]["handoff_attempts"] == 1
        assert r1["perf"]["fleet"]["handoff_degraded"] == 1
        assert r1["perf"]["fleet"]["handoff_adopted"] == 0
        assert not hasattr(GpuEngine, "prefill")


# -- the engine cycle ----------------------------------------------------------


def test_dropped_tiered_engine_is_freed_without_collection(tmp_path):
    """With the garbage collector off, dropping the last reference to a
    ``GpuEngine`` whose paged batcher demoted blocks into the KV tiers
    frees the batcher (its page pool and tier arena with it): the prefix
    cache holds its fetch through a weak reference, so no cycle keeps it."""
    registry.save_registry_entry(registry.ModelSpec(
        alias="paged-tiny", family="llama", size="tiny", dtype="float32", kv="paged",
    ))
    from adversarial_spec_tpu_torch.engine import prefix_cache

    port_kvtier.configure(enabled=True, host_mb=16, store_dir=str(tmp_path / "store"))
    prefix_cache.configure(enabled=True, max_pages=2)
    enabled = gc.isenabled()
    gc.disable()
    try:
        eng = GpuEngine(device="cpu")
        doc = "# Spec\nThe API MUST rate-limit. " * 8
        reqs = [ChatRequest("tpu://paged-tiny", f"persona {i}", doc) for i in range(3)]
        for _ in range(2):
            assert all(c.ok for c in eng.chat(reqs, SamplingParams(max_new_tokens=8, greedy=True)))
        assert port_kvtier.stats.demoted_blocks > 0
        batchers = [lm.batcher for lm in eng._models.values() if lm.batcher is not None]
        assert len(batchers) == 1 and batchers[0].tiers is not None
        refs = [weakref.ref(batchers[0]), weakref.ref(eng)]
        del batchers, eng
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()


def test_scale_in_frees_the_replica_engine_without_collection(tmp_path):
    """The repair where the fleet needs it: with the garbage collector
    off, the ``Autoscaler``'s scale-in of an idle in-process replica whose
    ``GpuEngine`` ran a tiered paged batcher frees that batcher (its page
    pool with it) at once, and the surviving replica keeps serving."""
    from adversarial_spec_tpu_torch.engine import prefix_cache
    from adversarial_spec_tpu_torch.fleet.autoscale import Autoscaler
    from adversarial_spec_tpu_torch.fleet.hashring import HashRing

    registry.save_registry_entry(registry.ModelSpec(
        alias="paged-tiny", family="llama", size="tiny", dtype="float32", kv="paged",
    ))
    port_kvtier.configure(enabled=True, host_mb=16, store_dir=str(tmp_path / "store"))
    prefix_cache.configure(enabled=True, max_pages=2)
    port_fleet.configure(scale_in_ticks=1, scale_cooldown_s=0.0)
    ring = HashRing(["r0", "r1"])
    keys = {ring.primary(f"debate-{k}"): f"debate-{k}" for k in range(16)}
    eng = FleetEngine(replicas=2, engine_factory=lambda m: GpuEngine(device="cpu"))
    params = SamplingParams(max_new_tokens=8, greedy=True)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for rid in ("r0", "r1"):
            reqs = [ChatRequest("tpu://paged-tiny", f"persona {i}",
                                "# Spec\nThe API MUST rate-limit. " * 8,
                                affinity_key=keys[rid]) for i in range(3)]
            assert all(c.ok for c in eng.chat(reqs, params))
        assert port_kvtier.stats.demoted_blocks > 0
        (lm,) = eng.router.replica("r1")._engines["tpu"]._models.values()
        assert lm.batcher.tiers is not None
        victim = [weakref.ref(lm.batcher), weakref.ref(lm)]
        del lm
        scaler = Autoscaler(eng, pressure=lambda: {
            "backlog_tokens": 0, "brownout": False, "draining": False,
            "active_keys": [keys["r0"]], "model_mix": {},
        })
        assert scaler.tick() is True
        assert eng.router.alive_ids() == ["r0"]
        assert [r() for r in victim] == [None, None]
        again = eng.chat([ChatRequest("tpu://paged-tiny", "persona 0", "# Spec\n",
                                      affinity_key=keys["r1"])], params)
        assert again[0].ok
    finally:
        if enabled:
            gc.enable()
        eng.shutdown()
