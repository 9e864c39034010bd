"""The port's fleet over worker subprocesses: the worker protocol and the
reference's fleet chaos drills (``tests/test_fleet.py``'s worker and
``chaos`` classes), on ``python -m adversarial_spec_tpu_torch.fleet.worker``
replicas serving the port's mock engine.

The drills are the port's chaos runner's (``tools/chaos_run_torch.py
--replica-kill`` / ``--handoff-kill``), with the reference's asserts. Then one scripted worker-fleet round runs
through both packages' fleets, and a worker serving ``tpu://`` on a
machine without a GPU answers with the port's "no CUDA device" error.
"""

from __future__ import annotations

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.fleet.replica import WorkerReplica

PARAMS = SamplingParams()


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


def _req(model="mock://critic", key="debate-A", user=None, **kw):
    return ChatRequest(
        model=model,
        system="You are a reviewer.",
        user=(
            user
            if user is not None
            else "Debate round 1\n--- DOCUMENT ---\nA spec body.\n"
            "--- END DOCUMENT ---"
        ),
        affinity_key=key,
        **kw,
    )


@pytest.mark.chaos
class TestWorkerTransport:
    """One worker subprocess, full protocol round-trip."""

    def test_worker_protocol(self, tmp_path):
        rep = WorkerReplica(
            "rw0", request_timeout_s=60.0, log_dir=str(tmp_path)
        )
        try:
            assert rep.ping()
            assert rep.validate("mock://critic") is None
            got = []
            comps = rep.chat_batch(
                [_req(), _req(model="mock://agree")],
                PARAMS,
                on_completion=lambda j, c: got.append(j),
            )
            assert [c.ok for c in comps] == [True, True]
            assert got == [0, 1]  # completions streamed incrementally
            stats = rep.stats()
            assert stats["served"] == {
                "mock://critic": 1, "mock://agree": 1,
            }
            rep.check()  # allocator/tier invariants inside the worker
        finally:
            rep.close()
        assert not rep.ping()




@pytest.mark.chaos
class TestReplicaKillChaos:
    """The tier-1 fleet chaos smoke: the FULL drill from
    the replica-kill drill (tools/chaos_run_torch.py) — two worker replicas sharing one
    KV store, the serving replica SIGKILLed after its 2nd completion,
    round completed on the survivor with byte-identical transcripts,
    zero duplicated opponent attempts, store rehydration, and clean
    survivor invariants."""

    def test_replica_kill_recovery_contract(self):
        from tools.chaos_run_torch import run_replica_kill

        failures, payload = run_replica_kill(verbose=False)
        assert failures == []
        assert payload["transcripts_byte_identical"] is True
        assert payload["duplicated_completions"] == 0
        assert payload["reissued_requests"] == 2
        assert payload["survivor_rehydrated_blocks"] > 0
        assert payload["recovered_fraction"] == 0.5




@pytest.mark.chaos
class TestHandoffKillChaos:
    """The tier-1 disagg chaos smoke: the FULL drill from
    the handoff-kill drill (tools/chaos_run_torch.py) — a 1 prefill + 1 decode worker
    fleet, the prefill replica SIGKILLed (a) after its publications
    are durable (handoff must still adopt) and (b) mid-publication
    (handoff must degrade to local prefill), byte-identical
    transcripts and zero duplicated completions throughout."""

    def test_handoff_kill_contract(self):
        from tools.chaos_run_torch import run_handoff_kill

        failures, payload = run_handoff_kill(verbose=False)
        assert failures == []
        assert payload["adopted_after_kill"] is True
        assert payload["degraded_on_partial"] is True
        assert payload["transcripts_byte_identical"] is True
        assert payload["duplicated_completions"] == 0
        assert payload["decode_rehydrated_blocks"] > 0
        assert payload["invariants_clean"] is True




@pytest.mark.chaos
class TestWorkerDisaggProtocol:
    """Worker-transport round-trip of the disagg ops: role rides the
    spawn, prefill publishes durable chains to the shared store, and a
    second worker's prefetch finds every one of them."""

    def test_prefill_publishes_and_peer_prefetch_finds(self, tmp_path):
        import os

        env = dict(
            os.environ,
            ADVSPEC_KV_TIER="1",
            ADVSPEC_KV_HOST_MB="64",
            ADVSPEC_KV_STORE_DIR=str(tmp_path / "store"),
        )
        doc = "The prefill worker SHALL publish durable blocks. " * 40
        pre = WorkerReplica(
            "wp0", request_timeout_s=60.0, env=env,
            log_dir=str(tmp_path), role="prefill",
        )
        dec = WorkerReplica(
            "wd0", request_timeout_s=60.0, env=env,
            log_dir=str(tmp_path), role="decode",
        )
        try:
            assert pre.role == "prefill" and dec.role == "decode"
            outs = pre.prefill(
                [_req(user=doc), _req(model="mock://agree", user=doc)],
                PARAMS,
            )
            assert len(outs) == 2
            chains = sorted(
                {c for o in outs for c in o.get("chains", ())}
            )
            assert chains, outs  # something page-aligned shipped
            assert all(o.get("blocks", 0) > 0 for o in outs)
            # The peer worker sees every published chain in the store.
            assert dec.prefetch("mock://critic", chains) == len(chains)
            assert dec.prefetch("mock://critic", ["bogus-chain"]) == 0
        finally:
            pre.close()
            dec.close()


def test_worker_fleet_round_matches_reference(tmp_path):
    """One worker-transport round through both packages' fleets (each
    spawning its own package's workers, a shared store each, a disagg
    split): the same completions and ``perf.fleet`` snapshot."""
    import os

    from adversarial_spec_tpu import fleet as ref_fleet
    from adversarial_spec_tpu.engine.types import ChatRequest as RefRequest
    from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
    from adversarial_spec_tpu.fleet.router import FleetEngine as RefFleetEngine
    from adversarial_spec_tpu_torch import fleet as port_fleet
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine

    doc = "The workers SHALL agree byte for byte. " * 40
    got = []
    for pkg, fleet, cls, req, params in (
        ("ref", ref_fleet, RefFleetEngine, RefRequest, RefParams),
        ("port", port_fleet, FleetEngine, ChatRequest, SamplingParams),
    ):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            ADVSPEC_KV_TIER="1",
            ADVSPEC_KV_STORE_DIR=str(tmp_path / pkg / "store"),
        )
        fleet.reset_stats()
        eng = cls(replicas=2, transport="worker", request_timeout_s=60.0,
                  worker_env=env, log_dir=str(tmp_path / pkg), prefill_replicas=1)
        try:
            reqs = [
                req(model=f"mock://critic?v={k}", system="You are a reviewer.",
                    user=doc + f"\nOpponent {k}.", affinity_key="debate-w")
                for k in range(3)
            ]
            comps = eng.chat(reqs, params(max_new_tokens=32, greedy=True))
            got.append(([(c.text, c.error, c.usage.cached_tokens) for c in comps],
                        fleet.snapshot(), eng.handoff.snapshot()))
        finally:
            eng.shutdown()
    ref_fleet.reset_stats()
    assert got[1] == got[0]
    assert all(err is None for _, err, _ in got[1][0])
    assert got[1][1]["handoff_adopted"] == 1 and got[1][1]["routed_requests"] == 3


def test_tpu_worker_without_a_gpu_answers_no_cuda_device(tmp_path):
    """A worker asked to serve ``tpu://`` on a machine without a GPU
    answers each request with the port's "no CUDA device" error (the
    router resolves it as a failed completion); it never runs the model
    on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker serves on it")
    rep = WorkerReplica("rw0", request_timeout_s=60.0, log_dir=str(tmp_path))
    try:
        comps = rep.chat_batch([_req(model="tpu://random-tiny")], PARAMS)
        assert not comps[0].ok
        assert "no CUDA device is available" in comps[0].error
        assert comps[0].text == ""
        assert rep.stats()["served"] == {"tpu://random-tiny": 1}
    finally:
        rep.close()
