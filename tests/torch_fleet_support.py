"""The fleet's worker drills on the port: a replica SIGKILLed mid-round,
and a prefill replica SIGKILLed after (and during) its publication.

Each runs the port's ``FleetEngine`` in this process over
``python -m adversarial_spec_tpu_torch.fleet.worker`` subprocesses that
share one KV store, with the reference drills' asserts
(``tools/chaos_run.py --replica-kill`` / ``--handoff-kill``): identical
transcripts to an uninterrupted run, zero duplicated completions, the
in-flight remainder (and only it) reissued, the survivor rehydrating the
dead replica's blocks from the store, clean survivor invariants. The
reference's tool drives the reference's workers; this module imports
only the port.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

_CRASH_SPEC = (
    "## Goals\nServe heavy traffic from millions of users, fast.\n"
    "## Constraints\nThe allocator SHALL bound page reuse by refcount.\n"
)
_FLEET_MODELS = [f"mock://critic?v={k}" for k in range(1, 5)]
_FLEET_KILL_AFTER = 2  # SIGKILL the serving replica after 2 completions
_FLEET_DEBATE_ID = "replica-drill"


def run_replica_kill(verbose: bool = True) -> tuple[list[str], dict]:
    """The fleet replica-loss drill, in-process (this process hosts the
    router; the replicas are SIGKILL-able port workers). Returns
    (failures, payload)."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
    from adversarial_spec_tpu_torch.debate.journal import RoundJournal
    from adversarial_spec_tpu_torch.fleet.hashring import HashRing
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine

    def say(msg: str) -> None:
        if verbose:
            print(f"replica-kill drill: {msg}", flush=True)

    failures: list[str] = []
    payload: dict = {
        "opponents": len(_FLEET_MODELS),
        "kill_after_completions": _FLEET_KILL_AFTER,
    }
    spec = _CRASH_SPEC * 4  # a document long enough to span store blocks
    # The ring is deterministic (sha256): compute which replica the
    # drill's debate id lands on, and arm the kill trigger for exactly
    # that replica — the survivor stays disarmed.
    primary = HashRing(["r0", "r1"]).preference(_FLEET_DEBATE_ID)[0]
    survivor = "r1" if primary == "r0" else "r0"
    payload["primary"] = primary
    payload["survivor"] = survivor

    def fleet_round(store_dir: str, sessions_dir: str, kill: bool, log_dir: str):
        worker_env = {
            **os.environ,
            "ADVSPEC_KV_TIER": "1",
            "ADVSPEC_KV_HOST_MB": "64",
            "ADVSPEC_KV_STORE_DIR": store_dir,
        }
        if kill:
            worker_env["ADVSPEC_REPLICA_KILL_AFTER"] = (
                f"{primary}:{_FLEET_KILL_AFTER}"
            )
        engine = FleetEngine(
            replicas=2,
            transport="worker",
            request_timeout_s=60.0,
            worker_env=worker_env,
            log_dir=log_dir,
        )
        fleet_mod.install_engine(engine)
        journal = RoundJournal("fleet-drill", journal_dir=Path(sessions_dir))
        cfg = RoundConfig(journal=journal, debate_id=_FLEET_DEBATE_ID)
        result = run_round(spec, _FLEET_MODELS, round_num=1, cfg=cfg)
        return engine, journal, result

    old_cfg = fleet_mod.config()
    old = (old_cfg.enabled, old_cfg.replicas, old_cfg.transport)
    fleet_mod.configure(enabled=True, replicas=2, transport="worker")
    try:
        with tempfile.TemporaryDirectory(prefix="advspec-fleet-") as td:
            # Phase A — reference: the same fleet round, uninterrupted.
            eng_a, _, ref = fleet_round(
                os.path.join(td, "store-ref"),
                os.path.join(td, "sessions-ref"),
                kill=False,
                log_dir=os.path.join(td, "logs-ref"),
            )
            fleet_mod.shutdown_fleet()
            if not all(r.ok for r in ref.responses):
                failures.append("reference fleet round had failures")
            say(f"reference round complete ({len(ref.responses)} opponents)")

            # Phase B — the kill: replica `primary` dies the instant
            # its 2nd completion line crosses the pipe, mid-round.
            fleet_mod.reset_stats()
            eng_b, journal, got = fleet_round(
                os.path.join(td, "store"),
                os.path.join(td, "sessions"),
                kill=True,
                log_dir=os.path.join(td, "logs"),
            )
            stats = fleet_mod.stats

            # 1. Zero lost debates: every opponent resolved, cleanly.
            if not all(r.ok for r in got.responses):
                failures.append(
                    "round lost work across the replica kill: "
                    + "; ".join(
                        f"{r.model}: {r.error}" for r in got.responses if not r.ok
                    )
                )
            # 2. Byte-identical transcripts vs the uninterrupted run.
            mismatched = [
                i
                for i, (a, b) in enumerate(zip(got.responses, ref.responses))
                if a.critique != b.critique
            ]
            if mismatched:
                failures.append(
                    f"transcripts diverged at opponent(s) {mismatched}"
                )
            # 3. The router's ledger: the in-flight remainder (and only
            # it) re-issued; nothing resolved twice; one replica died.
            expected_reissue = len(_FLEET_MODELS) - _FLEET_KILL_AFTER
            if stats.reissued_requests != expected_reissue:
                failures.append(
                    f"expected {expected_reissue} reissued request(s), "
                    f"got {stats.reissued_requests}"
                )
            if stats.duplicated_completions != 0:
                failures.append(
                    f"{stats.duplicated_completions} duplicated completion(s)"
                )
            if stats.replicas_retired != 1:
                failures.append(
                    f"expected 1 retired replica, got {stats.replicas_retired}"
                )
            if eng_b.router.alive_ids() != [survivor]:
                failures.append(
                    f"expected survivor {survivor}, alive: "
                    f"{eng_b.router.alive_ids()}"
                )
            # 4. No duplicated opponent ATTEMPTS: the survivor served
            # exactly the re-routed remainder, once each — never an
            # opponent the dead replica already completed.
            surv_stats = eng_b.router.replica(survivor).stats()
            expect_served = {m: 1 for m in _FLEET_MODELS[_FLEET_KILL_AFTER:]}
            if surv_stats.get("served") != expect_served:
                failures.append(
                    f"survivor served {surv_stats.get('served')}, "
                    f"expected {expect_served}"
                )
            # 5. Journal replay counters: one durable completion per
            # opponent index, each replayable exactly once.
            replayed = journal.replay(1, spec, _FLEET_MODELS)
            if sorted(replayed) != list(range(len(_FLEET_MODELS))):
                failures.append(
                    f"journal replay serves indices {sorted(replayed)}, "
                    f"expected all of 0..{len(_FLEET_MODELS) - 1}"
                )
            # 6. Store-coherent recovery: the survivor rehydrated the
            # shared document prefix from the disk store the dead
            # replica wrote through — not a cold re-prefill.
            tier = surv_stats.get("kv_tier", {})
            if not tier.get("rehydrated_blocks"):
                failures.append(
                    "survivor rehydrated nothing from the shared store "
                    f"(kv_tier: {tier})"
                )
            # 7. Clean survivors: allocator + tier invariants.
            try:
                eng_b.router.check_invariants()
            except Exception as e:
                failures.append(f"survivor invariants violated: {e}")

            payload.update(
                {
                    "reissued_requests": stats.reissued_requests,
                    "duplicated_completions": stats.duplicated_completions,
                    "survivor_served": surv_stats.get("served"),
                    "survivor_rehydrated_blocks": int(
                        tier.get("rehydrated_blocks", 0)
                    ),
                    "transcripts_byte_identical": not mismatched,
                    "recovered_fraction": round(
                        (len(_FLEET_MODELS) - stats.reissued_requests)
                        / len(_FLEET_MODELS),
                        4,
                    ),
                    "invariants_clean": not any(
                        "invariants" in f for f in failures
                    ),
                }
            )
            say(
                f"{primary} SIGKILLed after {_FLEET_KILL_AFTER} completions; "
                f"{stats.reissued_requests} request(s) re-routed to "
                f"{survivor}; transcripts "
                + ("byte-identical" if not mismatched else "DIVERGED")
            )
    finally:
        fleet_mod.shutdown_fleet()
        fleet_mod.configure(
            enabled=old[0], replicas=old[1], transport=old[2]
        )
        fleet_mod.reset_stats()
    return failures, payload


_HANDOFF_MODELS = [f"mock://critic?v={k}" for k in range(1, 5)]
_HANDOFF_DEBATE_ID = "handoff-drill"


def run_handoff_kill(verbose: bool = True) -> tuple[list[str], dict]:
    """The prefill/decode handoff-loss drill: a 1 prefill + 1 decode worker fleet shares one
    content-addressed KV store, and the PREFILL replica is SIGKILLed at
    the exact worst moment — its published blocks are durable on disk
    but the decode replica has not yet promoted them
    (``ADVSPEC_PREFILL_KILL_AFTER``). The contract checked:

    1. the handoff still ADOPTS: the decode replica rehydrates the
       dead replica's shipped blocks from the store instead of
       re-prefilling (a durable publication survives its publisher);
    2. a PARTIAL publication (killed mid-publish) degrades cleanly:
       the router falls back to local prefill on the decode side, no
       error surfaces to the caller;
    3. transcripts are byte-identical to an uninterrupted disagg run
       in BOTH kill variants, with zero duplicated completions;
    4. the dead prefill replica is retired through the fleet
       lifecycle and allocator/tier invariants are clean on the
       survivor.

    Returns (failures, payload)."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine

    def say(msg: str) -> None:
        if verbose:
            print(f"handoff-kill drill: {msg}", flush=True)

    failures: list[str] = []
    spec = _CRASH_SPEC * 12  # long enough to cross the handoff threshold
    reqs = [
        ChatRequest(
            model=m,
            system="You are an adversarial spec reviewer.",
            user=f"Debate round 1\n--- DOCUMENT ---\n{spec}\n--- END ---",
            affinity_key=_HANDOFF_DEBATE_ID,
        )
        for m in _HANDOFF_MODELS
    ]
    params = SamplingParams()
    payload: dict = {
        "opponents": len(_HANDOFF_MODELS),
        "prefill_replica": "r0",
        "decode_replica": "r1",
    }

    def disagg_round(td: str, name: str, kill_after: int | None):
        """One disagg fleet round over worker replicas; r0 is the
        prefill founder, r1 the decode founder. ``kill_after`` N means
        r0 SIGKILLs itself the instant its Nth prefill result line is
        durable on the pipe (blocks already flushed to the store)."""
        worker_env = {
            **os.environ,
            "ADVSPEC_KV_TIER": "1",
            "ADVSPEC_KV_HOST_MB": "64",
            "ADVSPEC_KV_STORE_DIR": os.path.join(td, f"store-{name}"),
        }
        if kill_after is not None:
            worker_env["ADVSPEC_PREFILL_KILL_AFTER"] = f"r0:{kill_after}"
        fleet_mod.reset_stats()
        engine = FleetEngine(
            replicas=2,
            transport="worker",
            prefill_replicas=1,
            request_timeout_s=60.0,
            worker_env=worker_env,
            log_dir=os.path.join(td, f"logs-{name}"),
        )
        try:
            comps = engine.chat(reqs, params)
            snap = fleet_mod.snapshot()
            stats = fleet_mod.stats
            alive = engine.router.alive_ids()
            dec_stats = (
                engine.router.replica("r1").stats() if "r1" in alive else {}
            )
            problems: list[str] = []
            try:
                engine.router.check_invariants()
            except Exception as e:
                problems.append(str(e))
            return {
                "texts": [c.text for c in comps],
                "ok": all(c.ok for c in comps),
                "errors": [c.error for c in comps if not c.ok],
                "snap": snap,
                "duplicated": stats.duplicated_completions,
                "retired": stats.replicas_retired,
                "alive": alive,
                "rehydrated": int(
                    dec_stats.get("kv_tier", {}).get("rehydrated_blocks", 0)
                ),
                "invariant_problems": problems,
            }
        finally:
            engine.shutdown()

    with tempfile.TemporaryDirectory(prefix="advspec-handoff-") as td:
        # Phase A — reference: the same disagg round, uninterrupted.
        ref = disagg_round(td, "ref", kill_after=None)
        if not ref["ok"]:
            return [f"reference disagg round failed: {ref['errors']}"], payload
        if ref["snap"]["handoff_adopted"] != 1:
            failures.append(
                "reference round did not adopt its handoff: "
                f"{ref['snap']}"
            )
        say(
            f"reference round complete (handoff adopted, "
            f"{ref['snap']['handoff_shipped_blocks']} blocks shipped)"
        )

        # Phase B — durable-then-dead: r0 dies after ALL prefill
        # results (and their blocks) are durable, before r1 promotes.
        got = disagg_round(td, "kill", kill_after=len(_HANDOFF_MODELS))
        if not got["ok"]:
            failures.append(
                f"round lost work across the prefill kill: {got['errors']}"
            )
        if got["texts"] != ref["texts"]:
            failures.append(
                "transcripts diverged from the uninterrupted disagg run"
            )
        if got["snap"]["handoff_adopted"] != 1:
            failures.append(
                "durable publication was not adopted after the publisher "
                f"died: {got['snap']}"
            )
        if not got["rehydrated"]:
            failures.append(
                "decode replica rehydrated nothing from the dead "
                "replica's store writes"
            )
        if got["retired"] != 1:
            failures.append(
                f"expected 1 retired replica, got {got['retired']}"
            )
        if got["alive"] != ["r1"]:
            failures.append(f"expected survivor ['r1'], alive: {got['alive']}")
        if got["duplicated"]:
            failures.append(
                f"{got['duplicated']} duplicated completion(s)"
            )
        if got["invariant_problems"]:
            failures.append(
                f"survivor invariants violated: {got['invariant_problems']}"
            )
        say(
            "r0 SIGKILLed post-publication; decode adopted "
            f"{got['snap']['handoff_shipped_blocks']} durable blocks, "
            f"rehydrated {got['rehydrated']}, transcripts "
            + ("byte-identical" if got["texts"] == ref["texts"] else "DIVERGED")
        )

        # Phase C — mid-publish: r0 dies after HALF the prefill
        # results; the incomplete publication must degrade to local
        # prefill on the decode side, not error and not adopt.
        part = disagg_round(td, "partial", kill_after=2)
        if not part["ok"]:
            failures.append(
                f"partial-publish round lost work: {part['errors']}"
            )
        if part["texts"] != ref["texts"]:
            failures.append(
                "partial-publish transcripts diverged from the reference"
            )
        if part["snap"]["handoff_degraded"] != 1:
            failures.append(
                "partial publication did not degrade: "
                f"{part['snap']}"
            )
        if part["duplicated"]:
            failures.append(
                f"{part['duplicated']} duplicated completion(s) "
                "in the partial-publish variant"
            )
        if part["invariant_problems"]:
            failures.append(
                "partial-publish survivor invariants violated: "
                f"{part['invariant_problems']}"
            )
        say(
            "r0 SIGKILLed mid-publication; handoff degraded to local "
            "prefill, transcripts "
            + (
                "byte-identical"
                if part["texts"] == ref["texts"]
                else "DIVERGED"
            )
        )
        payload.update(
            {
                "shipped_blocks": got["snap"]["handoff_shipped_blocks"],
                "decode_rehydrated_blocks": got["rehydrated"],
                "adopted_after_kill": got["snap"]["handoff_adopted"] == 1,
                "degraded_on_partial": part["snap"]["handoff_degraded"] == 1,
                "transcripts_byte_identical": (
                    got["texts"] == ref["texts"]
                    and part["texts"] == ref["texts"]
                ),
                "duplicated_completions": got["duplicated"]
                + part["duplicated"],
                "invariants_clean": not (
                    got["invariant_problems"] or part["invariant_problems"]
                ),
            }
        )
    fleet_mod.reset_stats()
    return failures, payload
