"""Standalone chaos-suite runner + kill-chaos recovery drill for the
PyTorch port (``adversarial_spec_tpu_torch``): the port's counterpart of
``tools/chaos_run.py``, with its drills, flags, output lines and
``(failures, payload)`` returns. It imports torch and the port, never the
JAX package; its subprocesses are the port's CLI, serve daemon and fleet
workers, each drill with its own ``PYTHONPATH`` and temporary ``HOME``.

Runs the port's fault-injection / resilience tests (pytest marker
``chaos``, over ``tests/test_torch_*.py`` only) outside the main suite —
the quick gate after touching the port's scheduler, engine, or
resilience code — and optionally sweeps extra randomized fuzz seeds by
re-running the port's scheduler chaos fuzz under different
``ADVSPEC_CHAOS_FUZZ_SEED`` values (the in-suite fuzz pins 3 fixed seeds;
a sweep buys wider coverage when you want it, without slowing tier-1).
Reproduce a failing sweep seed N with ``ADVSPEC_CHAOS_FUZZ_SEED=N
pytest tests/test_torch_chaos.py -k ChaosFuzz``.

``--crash`` is the kill-chaos recovery drill (docs/resilience.md
"Durability and recovery"): it spawns a REAL mock debate round in a
subprocess, SIGKILLs it mid-round the instant the Nth opponent's
journal record becomes durable (``ADVSPEC_JOURNAL_KILL_AFTER``),
resumes the session in a second subprocess, and asserts the recovery
contract — only unfinished opponents re-issue (no duplicated opponent
work) and every journal-served transcript is byte-identical to an
uninterrupted run of the same round.

``--replica-kill`` is the FLEET variant (docs/fleet.md): a round runs
across two subprocess worker replicas sharing one content-addressed KV
store, the replica serving the round is SIGKILLed the instant its 2nd
completion crosses the pipe (``ADVSPEC_REPLICA_KILL_AFTER``), and the
drill asserts lose-a-replica-lose-nothing — the round completes on the
survivor with byte-identical transcripts vs an uninterrupted fleet
run, zero duplicated opponent attempts (per-worker serve counters +
the round journal's one-record-per-index replay), the survivor
rehydrating the shared document prefix from the disk store instead of
re-prefilling, and allocator + tier invariants clean on the survivor.

``--handoff-kill`` is the DISAGGREGATION variant (docs/fleet.md
"Disaggregation"): a 1 prefill + 1 decode worker fleet runs a debate
whose admission crosses the handoff threshold, and the prefill replica
is SIGKILLed at the worst moment — published KV blocks durable in the
shared store, decode replica not yet promoted
(``ADVSPEC_PREFILL_KILL_AFTER``). The drill asserts the decode replica
adopts the dead publisher's blocks (store rehydration, not a
re-prefill), a mid-publish kill degrades to local prefill instead of
erroring, transcripts stay byte-identical to an uninterrupted disagg
run in both variants, zero duplicated completions, the dead replica is
retired through the fleet lifecycle, and survivor invariants are
clean.

``--overload`` is the SERVE storm drill (docs/serving.md): an
in-process ``advspec serve`` daemon with tight admission caps takes an
open-loop burst several times its backlog cap and must shed, not
collapse — typed retry-after refusals, zero accepted-request loss,
interactive p99 TTFT within the drill SLO while the batch tier pauses
first (brownout), allocator/tier invariants clean.

``--weight-swap`` is the WEIGHT-RESIDENCY fault drill
(docs/weight_residency.md): two tiny real models, served by the port's
``GpuEngine`` on the CUDA card (``run_weight_swap(device="cpu")`` runs
the plain PyTorch paths; the flag never falls back to the CPU), share a
1-model device-memory budget so every round swaps, and an injected fault
fires exactly at
the ``weight_swap`` seam (mid-promotion of host-demoted shards). The
drill asserts the aborted swap evicts ONLY the waiting admission (the
co-scheduled group's completions are untouched), the residency ledger
stays conservation-clean (the faulted model is still host-resident —
never lost, never double-counted), the flight-recorder JSONL autodump
reconstructs the failed swap (a ``swap_fault`` WeightEvent + the
classified FaultEvent), and the NEXT round's retry promotes the same
shards to a byte-identical transcript.

``--drain`` is the SIGTERM graceful-drain drill: a real subprocess
daemon is SIGTERMed mid-burst and must resolve every accepted debate
(finished or typed-drained), exit 0 with a clean drain report, and
leave drained sessions journal-resumable — a fresh daemon serves their
completed opponents from the journal byte-identically.

``--scale-storm`` is the elastic-fleet load-step drill and
``--deadlock-hammer`` the lock-discipline drill (their docstrings below).

Usage:
    python tools/chaos_run_torch.py                 # pytest -m chaos (port's tests)
    python tools/chaos_run_torch.py --sweep 5       # + 5 extra fuzz seeds
    python tools/chaos_run_torch.py --crash         # SIGKILL + resume drill
    python tools/chaos_run_torch.py --replica-kill  # fleet replica-loss drill
    python tools/chaos_run_torch.py --handoff-kill  # prefill-loss handoff drill
    python tools/chaos_run_torch.py --overload      # serve storm + drain drills
    python tools/chaos_run_torch.py --drain         # serve SIGTERM drain drill
    python tools/chaos_run_torch.py --weight-swap   # weight-swap fault drill (CUDA)
    python tools/chaos_run_torch.py --scale-storm   # elastic-fleet load step
    python tools/chaos_run_torch.py --deadlock-hammer  # lockdep storm + inversion
    python tools/chaos_run_torch.py -- -x -k breaker    # extra pytest args
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_CRASH_SPEC = (
    "## Goals\nServe heavy traffic from millions of users, fast.\n"
    "## Constraints\nThe allocator SHALL bound page reuse by refcount.\n"
)
_CRASH_MODELS = [
    "mock://critic?v=1",
    "mock://critic?v=2",
    "mock://critic?v=3",
    "mock://critic?v=4",
]
_KILL_AFTER = 2  # SIGKILL once this many completion records are durable


def _drill_env(td: str) -> dict:
    """A drill subprocess's environment: the port importable from this
    checkout, and a HOME of the drill's own (the registry and profiles
    the CLI reads live under it)."""
    home = os.path.join(td, "home")
    os.makedirs(home, exist_ok=True)
    return {**os.environ, "PYTHONPATH": str(REPO), "HOME": home}


def _cli(args: list[str], env: dict, cwd: str, stdin: str | None = None):
    # cwd is the drill's tempdir, NOT the repo: the CLI writes
    # cwd-relative spec checkpoints, which must not litter the tree
    # (PYTHONPATH in env makes the package importable from anywhere).
    return subprocess.run(
        [sys.executable, "-m", "adversarial_spec_tpu_torch.cli", *args],
        input=stdin,
        text=True,
        capture_output=True,
        cwd=cwd,
        env=env,
    )


def crash_drill(verbose: bool = True) -> int:
    """SIGKILL a round mid-journal, resume, and check the recovery
    contract. Returns 0 on success, 1 with reasons on stderr."""

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --crash: {msg}", flush=True)

    failures: list[str] = []
    with tempfile.TemporaryDirectory(prefix="advspec-crash-") as td:
        base = _drill_env(td)
        # 1. The victim: a real round over 4 opponents, killed the
        # moment opponent _KILL_AFTER's completion record is durable.
        env1 = {
            **base,
            "ADVSPEC_SESSIONS_DIR": os.path.join(td, "sessions"),
            "ADVSPEC_JOURNAL_KILL_AFTER": str(_KILL_AFTER),
        }
        p1 = _cli(
            [
                "critique",
                "--session",
                "crash-drill",
                "--models",
                ",".join(_CRASH_MODELS),
                "--json",
            ],
            env1,
            td,
            stdin=_CRASH_SPEC,
        )
        if p1.returncode != -signal.SIGKILL:
            failures.append(
                f"victim expected SIGKILL exit, got rc={p1.returncode}: "
                f"{p1.stderr[-300:]}"
            )
        say(f"victim killed mid-round (rc={p1.returncode})")

        # 2. Resume: journal-served opponents must not re-issue.
        env2 = dict(env1)
        env2.pop("ADVSPEC_JOURNAL_KILL_AFTER")
        p2 = _cli(
            ["critique", "--resume", "crash-drill", "--json"], env2, td
        )
        if p2.returncode != 0:
            failures.append(
                f"resume failed rc={p2.returncode}: {p2.stderr[-300:]}"
            )
            print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
            return 1
        resumed = json.loads(p2.stdout)

        # 3. Reference: the same round uninterrupted, fresh state.
        env3 = {
            **base,
            "ADVSPEC_SESSIONS_DIR": os.path.join(td, "sessions-ref"),
        }
        p3 = _cli(
            [
                "critique",
                "--session",
                "crash-drill",
                "--models",
                ",".join(_CRASH_MODELS),
                "--json",
            ],
            env3,
            td,
            stdin=_CRASH_SPEC,
        )
        if p3.returncode != 0:
            failures.append(
                f"reference run failed rc={p3.returncode}: "
                f"{p3.stderr[-300:]}"
            )
            print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
            return 1
        reference = json.loads(p3.stdout)

        counters = resumed["perf"]["counters"]
        served = int(counters.get("debate/journal.served", 0))
        if served != _KILL_AFTER:
            failures.append(
                f"expected {_KILL_AFTER} journal-served opponents, "
                f"got {served}"
            )
        # No duplicated opponent work: journal-served models must have
        # burned ZERO engine attempts in the resumed process.
        for i, model in enumerate(_CRASH_MODELS):
            attempts = counters.get(f"debate/attempts.{model}", 0)
            want = 0 if i < _KILL_AFTER else 1
            if attempts != want:
                failures.append(
                    f"{model}: {attempts} engine attempt(s) on resume, "
                    f"expected {want}"
                )
        # Byte-identical transcripts for journal-served opponents (the
        # mock is deterministic, so re-issued ones match too — but the
        # journal-served equality is the recovery guarantee).
        for i in range(len(_CRASH_MODELS)):
            a = resumed["results"][i]["response"]
            b = reference["results"][i]["response"]
            if a != b:
                kind = "journal-served" if i < _KILL_AFTER else "re-issued"
                failures.append(
                    f"opponent {i} ({kind}) transcript diverged from the "
                    "uninterrupted run"
                )
        say(
            f"resume served {served} opponent(s) from the journal, "
            f"re-issued {len(_CRASH_MODELS) - served}; transcripts "
            "byte-identical"
        )
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    say("recovery contract holds")
    return 0


_FLEET_MODELS = [f"mock://critic?v={k}" for k in range(1, 5)]
_FLEET_KILL_AFTER = 2  # SIGKILL the serving replica after 2 completions
_FLEET_DEBATE_ID = "replica-drill"


def run_replica_kill(verbose: bool = True) -> tuple[list[str], dict]:
    """The fleet replica-loss drill, in-process (this process hosts the
    router; the replicas are SIGKILL-able ``python -m
    adversarial_spec_tpu_torch.fleet.worker`` processes). Returns
    (failures, payload) — the failure list is this CLI's verdict."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
    from adversarial_spec_tpu_torch.debate.journal import RoundJournal
    from adversarial_spec_tpu_torch.fleet.hashring import HashRing
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --replica-kill: {msg}", flush=True)

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
            **_drill_env(os.path.dirname(store_dir)),
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
    """The prefill/decode handoff-loss drill (docs/fleet.md
    "Disaggregation"): a 1 prefill + 1 decode worker fleet shares one
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

    Returns (failures, payload); ``tests/test_torch_fleet_workers.py``
    runs it under the ``chaos`` marker."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --handoff-kill: {msg}", flush=True)

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
            **_drill_env(td),
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


def handoff_kill_drill(verbose: bool = True) -> int:
    failures, _ = run_handoff_kill(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print(
            "chaos_run --handoff-kill: durable-publication adoption + "
            "partial-publish degradation hold",
            flush=True,
        )
    return 0


_OVERLOAD_SPEC = (
    "## Goals\nServe heavy traffic from millions of users, fast.\n"
    "## Constraints\n" + "The daemon SHALL shed, not collapse. " * 24
)
_OVERLOAD_MODELS = ["mock://critic?v=1", "mock://critic?v=2"]
# Interactive p99 TTFT budget for the drill (generous: the assertion is
# "bounded under overload", not "fast on a loaded CI box").
_OVERLOAD_TTFT_SLO_S = 5.0


def run_overload(verbose: bool = True) -> tuple[list[str], dict]:
    """The overload storm drill (docs/serving.md "shed, don't
    collapse"): an in-process serve daemon with TIGHT admission caps
    takes an open-loop burst several times its sustainable backlog —
    every line written before a byte is read. The contract checked:

    1. every refusal is TYPED (a SHED_REASONS member + retry_after_s);
    2. every ACCEPTED debate completes — zero lost;
    3. interactive traffic is never shed while batch still holds
       capacity, interactive p99 TTFT stays under the SLO, and the
       batch tier pauses first (brownout entered; typed ``brownout``
       sheds observed);
    4. allocator/tier invariants are clean after the storm (the
       daemon's ``check`` op);
    5. submitted == accepted + shed (nothing silently dropped).

    Returns (failures, payload) — the failure list is this CLI's
    verdict."""
    import asyncio
    import threading
    import time

    from adversarial_spec_tpu_torch import serve as serve_mod
    from adversarial_spec_tpu_torch.serve.client import ServeClient
    from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon
    from adversarial_spec_tpu_torch.serve.driver import estimate_debate_tokens
    from adversarial_spec_tpu_torch.serve.protocol import SHED_REASONS

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --overload: {msg}", flush=True)

    failures: list[str] = []
    n_tenants = 2
    n_interactive_per_tenant = 3  # under the depth cap: must all admit
    n_batch_per_tenant = 25  # way past every cap: must shed typed
    old = serve_mod.snapshot()
    serve_mod.reset_stats()
    serve_mod.configure(
        max_queue_depth=4,
        max_backlog_tokens=32000,
        tenant_quota_tokens=0,
        drain_deadline_s=3.0,
    )
    payload: dict = {}
    with tempfile.TemporaryDirectory(prefix="advspec-overload-") as td:
        sock = os.path.join(td, "serve.sock")
        ready = threading.Event()
        daemon = ServeDaemon(sock, sessions_dir=os.path.join(td, "sessions"))
        th = threading.Thread(
            target=lambda: asyncio.run(daemon.run(ready=ready)), daemon=True
        )
        th.start()
        if not ready.wait(10):
            return ["daemon did not come up"], {}
        client = ServeClient(sock, timeout_s=60)
        try:
            # The open-loop storm: interleave tiers, write everything,
            # read nothing until the burst is fully submitted.
            submitted: list[tuple[str, str]] = []  # (req id, tier)
            est_int = estimate_debate_tokens(
                {
                    "spec": _OVERLOAD_SPEC,
                    "models": _OVERLOAD_MODELS,
                    "max_new_tokens": 160,
                }
            )
            est_batch = estimate_debate_tokens(
                {
                    "spec": _OVERLOAD_SPEC,
                    "models": _OVERLOAD_MODELS,
                    "max_new_tokens": 1280,
                }
            )
            offered_tokens = 0
            t0 = time.monotonic()
            batch_left = {t: n_batch_per_tenant for t in range(n_tenants)}
            inter_left = {t: n_interactive_per_tenant for t in range(n_tenants)}
            while any(batch_left.values()) or any(inter_left.values()):
                for t in range(n_tenants):
                    if batch_left[t]:
                        batch_left[t] -= 1
                        offered_tokens += est_batch
                        submitted.append(
                            (
                                client.submit_debate(
                                    _OVERLOAD_SPEC,
                                    _OVERLOAD_MODELS,
                                    tenant=f"batch-{t}",
                                    tier="batch",
                                    stream=True,
                                    max_new_tokens=1280,
                                ),
                                "batch",
                            )
                        )
                    if inter_left[t]:
                        inter_left[t] -= 1
                        offered_tokens += est_int
                        submitted.append(
                            (
                                client.submit_debate(
                                    _OVERLOAD_SPEC,
                                    _OVERLOAD_MODELS,
                                    tenant=f"inter-{t}",
                                    tier="interactive",
                                    stream=True,
                                    max_new_tokens=160,
                                ),
                                "interactive",
                            )
                        )
            overload_factor = offered_tokens / serve_mod.config().max_backlog_tokens
            say(
                f"storm submitted: {len(submitted)} debates, "
                f"~{overload_factor:.1f}x the backlog cap, open-loop"
            )

            accepted = {"interactive": 0, "batch": 0}
            completed = {"interactive": 0, "batch": 0}
            shed = {"interactive": 0, "batch": 0}
            shed_reasons: dict[str, int] = {}
            lost: list[str] = []
            ttfts: list[float] = []
            for rid, tier in submitted:
                evs = client.collect(rid, timeout_s=120)
                first, last = evs[0]["event"], evs[-1]
                if first == "accepted":
                    accepted[tier] += 1
                    if last["event"] != "result":
                        lost.append(f"{rid}: terminal {last['event']}")
                        continue
                    opp_errors = [
                        r["error"]
                        for r in last.get("results", [])
                        if r["error"]
                    ]
                    if last.get("error") or opp_errors:
                        lost.append(
                            f"{rid} ({tier}): accepted but lost work: "
                            f"{last.get('error') or opp_errors[:1]}"
                        )
                    else:
                        completed[tier] += 1
                    if tier == "interactive":
                        ttfts.append(float(last["ttft_s"]))
                elif last["event"] == "shed":
                    shed[tier] += 1
                    reason = last.get("reason", "")
                    shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
                    if reason not in SHED_REASONS:
                        failures.append(f"untyped shed reason {reason!r}")
                    if not isinstance(last.get("retry_after_s"), (int, float)):
                        failures.append(f"shed without retry_after_s: {last}")
                else:
                    lost.append(f"{rid}: unexpected events {evs}")
            wall = time.monotonic() - t0

            # 1-2. zero accepted-request loss; full accounting.
            if lost:
                failures.append(
                    f"{len(lost)} accepted request(s) lost: {lost[:3]}"
                )
            total = sum(accepted.values()) + sum(shed.values())
            if total != len(submitted):
                failures.append(
                    f"accounting hole: {len(submitted)} submitted, "
                    f"{total} accounted"
                )
            # 3. tier contract: interactive fully admitted + served
            # within SLO; batch paused first (brownout + typed sheds).
            n_inter = n_tenants * n_interactive_per_tenant
            if accepted["interactive"] != n_inter:
                failures.append(
                    f"interactive shed under batch overload: "
                    f"{accepted['interactive']}/{n_inter} admitted "
                    f"(sheds: {shed_reasons})"
                )
            if shed["batch"] == 0:
                failures.append("batch tier never shed — no overload?")
            snap = serve_mod.snapshot()
            if snap["brownout_entries"] < 1:
                failures.append("brownout never entered under the storm")
            if shed_reasons.get("brownout", 0) < 1:
                failures.append("no typed brownout shed observed")
            from adversarial_spec_tpu_torch.obs.metrics import percentile

            p99 = percentile(ttfts, 0.99)
            if p99 > _OVERLOAD_TTFT_SLO_S:
                failures.append(
                    f"interactive p99 TTFT {p99:.3f}s breaches the "
                    f"{_OVERLOAD_TTFT_SLO_S}s drill SLO"
                )
            # 4. clean invariants after the storm.
            chk = client.check()
            if not chk.get("ok"):
                failures.append(f"invariants violated: {chk.get('problems')}")
            # 5. the daemon's own ledger agrees with the client's.
            if snap["shed_fraction"] <= 0.0:
                failures.append("daemon recorded no shed under overload")
            payload = {
                "submitted": len(submitted),
                "overload_factor": round(overload_factor, 2),
                "accepted": accepted,
                "completed": completed,
                "shed": shed,
                "shed_reasons": shed_reasons,
                "shed_fraction": snap["shed_fraction"],
                "brownout_entries": snap["brownout_entries"],
                "brownout_exits": snap["brownout_exits"],
                "units_preempted": snap["units_preempted"],
                "interactive_ttft_p99_s": round(p99, 4),
                "ttft_slo_s": _OVERLOAD_TTFT_SLO_S,
                "storm_wall_s": round(wall, 3),
                "invariants_clean": bool(chk.get("ok")),
                "zero_accepted_lost": not lost,
            }
            say(
                f"{sum(accepted.values())} accepted (all served), "
                f"{sum(shed.values())} shed typed "
                f"({shed_reasons}), brownout x{snap['brownout_entries']}, "
                f"interactive p99 TTFT {p99 * 1000:.0f}ms"
            )
            client.drain()
        finally:
            client.close()
            th.join(timeout=15)
            if th.is_alive():
                failures.append("daemon failed to drain/exit")
            serve_mod.configure(
                max_queue_depth=old["max_queue_depth"],
                max_backlog_tokens=old["max_backlog_tokens"],
                tenant_quota_tokens=old["tenant_quota_tokens"],
                drain_deadline_s=old["drain_deadline_s"],
            )
    return failures, payload


def overload_drill(verbose: bool = True) -> int:
    """The full serve resilience gate: the open-loop storm AND the
    SIGTERM drain drill — ``--overload`` green means both hold
    (``--drain`` runs the drain half alone)."""
    failures, _ = run_overload(verbose)
    drain_failures, _ = run_drain_drill(verbose)
    failures = failures + drain_failures
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print(
            "chaos_run --overload: shed-not-collapse + drain contract hold",
            flush=True,
        )
    return 0


_DRAIN_MODELS = [f"mock://critic?v={k}" for k in range(1, 5)]
_DRAIN_DEBATES = 48


def run_drain_drill(verbose: bool = True) -> tuple[list[str], dict]:
    """The SIGTERM graceful-drain drill (docs/serving.md "drain
    contract"): a REAL subprocess daemon takes a burst of journaled
    debates, is SIGTERMed mid-burst, and must (1) stop admissions with
    typed ``draining`` sheds, (2) resolve every accepted request —
    finished or drained with a typed error, (3) exit 0 with a parseable
    drain report, and (4) leave every drained session journal-resumable:
    a second daemon serves the completed opponents from the journal
    with zero engine work and byte-identical transcripts."""
    import time

    from adversarial_spec_tpu_torch.serve.client import ServeClient

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --drain: {msg}", flush=True)

    failures: list[str] = []
    payload: dict = {"debates": _DRAIN_DEBATES, "opponents": len(_DRAIN_MODELS)}
    spec = _OVERLOAD_SPEC * 6

    def start_daemon(td: str, name: str, deadline_s: float):
        sock = os.path.join(td, f"{name}.sock")
        env = {
            **_drill_env(td),
            "ADVSPEC_SESSIONS_DIR": os.path.join(td, "sessions"),
        }
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "adversarial_spec_tpu_torch.serve",
                "--socket",
                sock,
                "--serve-queue-depth",
                "64",
                "--serve-backlog-tokens",
                "10000000",
                "--serve-drain-deadline-s",
                str(deadline_s),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=td,
            env=env,
        )
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"daemon died at startup: {proc.stderr.read()[-400:]}"
                )
            if os.path.exists(sock):
                try:
                    return proc, ServeClient(sock, timeout_s=60)
                except OSError:
                    pass
            time.sleep(0.02)
        proc.kill()
        raise RuntimeError("daemon socket never appeared")

    with tempfile.TemporaryDirectory(prefix="advspec-drain-") as td:
        # Phase A: burst of journaled debates, SIGTERM mid-burst.
        proc, client = start_daemon(td, "a", deadline_s=0.05)
        ids = []
        try:
            for k in range(_DRAIN_DEBATES):
                ids.append(
                    client.submit_debate(
                        spec,
                        _DRAIN_MODELS,
                        tenant=f"t{k % 3}",
                        session=f"drain-{k:02d}",
                        max_new_tokens=512,
                    )
                )
            proc.send_signal(signal.SIGTERM)
            say(f"SIGTERM sent after {len(ids)} open-loop submissions")
            outcomes = {"finished": 0, "drained": 0, "shed": 0}
            resumable: list[int] = []
            for k, rid in enumerate(ids):
                evs = client.collect(rid, timeout_s=60)
                last = evs[-1]
                if evs[0]["event"] == "shed":
                    outcomes["shed"] += 1
                    if last.get("reason") != "draining":
                        failures.append(
                            f"post-SIGTERM shed typed {last.get('reason')!r},"
                            " expected 'draining'"
                        )
                elif last["event"] != "result":
                    failures.append(
                        f"accepted debate {rid} never resolved: "
                        f"{[e['event'] for e in evs]}"
                    )
                else:
                    errors = [
                        r["error"] for r in last["results"] if r["error"]
                    ]
                    if not errors and not last.get("error"):
                        outcomes["finished"] += 1
                    else:
                        outcomes["drained"] += 1
                        resumable.append(k)
                        for e in errors:
                            if "drained" not in e and "shed" not in e:
                                failures.append(
                                    f"drained debate carries untyped "
                                    f"error {e!r}"
                                )
        except (TimeoutError, ConnectionError) as e:
            failures.append(f"phase A transport failure: {e}")
            outcomes = {"finished": 0, "drained": 0, "shed": 0}
            resumable = []
        finally:
            client.close()
        rc = proc.wait(timeout=30)
        out, _err_txt = proc.communicate(timeout=10)
        if rc != 0:
            failures.append(f"daemon exited rc={rc}, expected 0")
        report = None
        for line in reversed(out.strip().splitlines()):
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if cand.get("event") == "drain_report":
                report = cand
                break
        if report is None:
            failures.append("no drain_report on daemon stdout")
        elif not report.get("clean_exit"):
            failures.append(f"drain report not clean: {report}")
        say(
            f"daemon exited rc={rc}: {outcomes['finished']} finished, "
            f"{outcomes['drained']} drained (journal-resumable), "
            f"{outcomes['shed']} shed at admission"
        )
        if not resumable and outcomes["shed"] == 0 and not failures:
            # The box outran the drill: everything finished before the
            # deadline. Still a valid drain, but say so.
            say("note: all debates finished before the drain deadline")

        # Phase B: resume on a fresh daemon — journal-served opponents
        # must re-issue ZERO engine work and match a finished debate's
        # transcripts byte-for-byte (same spec, same round, mock
        # determinism + the journal's byte-identity guarantee).
        proc2, client2 = start_daemon(td, "b", deadline_s=5.0)
        served_total = 0
        try:
            reference = None
            ref_rid = client2.submit_debate(
                spec, _DRAIN_MODELS, tenant="ref", session="drain-ref",
                max_new_tokens=512,
            )
            ref = client2.collect(ref_rid, timeout_s=60)[-1]
            if ref["event"] == "result" and not ref.get("error"):
                reference = [r["response"] for r in ref["results"]]
            else:
                failures.append("phase B reference debate failed")
            for k in resumable:
                rid = client2.submit_debate(
                    spec,
                    _DRAIN_MODELS,
                    tenant=f"t{k % 3}",
                    session=f"drain-{k:02d}",
                    max_new_tokens=512,
                )
                last = client2.collect(rid, timeout_s=60)[-1]
                if last["event"] != "result" or last.get("error"):
                    failures.append(f"resume of drain-{k:02d} failed")
                    continue
                served_total += int(last.get("journal_served", 0))
                errors = [r["error"] for r in last["results"] if r["error"]]
                if errors:
                    failures.append(
                        f"resume of drain-{k:02d} still lossy: {errors[:1]}"
                    )
                if reference is not None:
                    got = [r["response"] for r in last["results"]]
                    if got != reference:
                        failures.append(
                            f"drain-{k:02d} resumed transcripts diverged"
                        )
            client2.drain()
        except (TimeoutError, ConnectionError, RuntimeError) as e:
            failures.append(f"phase B transport failure: {e}")
        finally:
            client2.close()
            try:
                proc2.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc2.kill()
                failures.append("phase B daemon failed to drain")
        say(
            f"resumed {len(resumable)} drained debate(s): "
            f"{served_total} opponent(s) served from journals, "
            "transcripts byte-identical"
        )
        payload.update(
            {
                "sigterm_rc": rc,
                "outcomes": outcomes,
                "drain_report_clean": bool(report and report.get("clean_exit")),
                "resumable_debates": len(resumable),
                "journal_served_on_resume": served_total,
                "zero_accepted_lost": not any(
                    "never resolved" in f for f in failures
                ),
            }
        )
    return failures, payload


def drain_drill(verbose: bool = True) -> int:
    failures, _ = run_drain_drill(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print("chaos_run --drain: drain contract holds", flush=True)
    return 0


def replica_kill_drill(verbose: bool = True) -> int:
    failures, _ = run_replica_kill(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print("chaos_run --replica-kill: recovery contract holds", flush=True)
    return 0


def run_weight_swap(
    verbose: bool = True, device: str | None = None
) -> tuple[list[str], dict]:
    """The weight-swap fault drill (see module docstring): a fault
    mid-promotion must cost one degraded admission and one retry —
    never a lost model, a corrupted ledger, or a silent swap.

    The port's ``GpuEngine`` serves both models on ``device`` (None: the
    CUDA card; a machine without one fails here with the engine's "no
    CUDA device" error, never on the CPU), speculation off, so decode
    runs B1 (on the card each decode step a CUDA graph replay). The
    budget (``ADVSPEC_HBM_BUDGET_BYTES``) counts weight bytes only; a
    model's graph pool goes with it when it demotes, and the retry's
    promotion puts the weights at new addresses, so its decode captures
    new graphs (``retry_graph_captures``) instead of replaying ones that
    read freed memory. Beyond the reference's payload: the event kinds of
    the autodump, the retry's graph captures and its promotion seconds."""
    from adversarial_spec_tpu_torch import obs
    from adversarial_spec_tpu_torch.engine import device_loop, weightres
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.obs.events import validate_event
    from adversarial_spec_tpu_torch.resilience import injector

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --weight-swap: {msg}", flush=True)

    try:
        eng = GpuEngine(device=device)
    except RuntimeError as e:  # no CUDA device: the drill does not run
        return [str(e)], {}
    failures: list[str] = []
    payload: dict = {}
    old_obs = obs.config()
    old_obs = (old_obs.enabled, old_obs.events_out, old_obs.dump_on_fault)
    old_weights = weightres.config()
    old_weights = (old_weights.enabled, old_weights.host_mb)
    old_spec = spec_mod.config().enabled
    tmp = tempfile.mkdtemp(prefix="chaos_weight_swap_")
    events_out = os.path.join(tmp, "events.jsonl")
    obs.configure(enabled=True, events_out=events_out, dump_on_fault=True)
    obs.reset_stats()
    weightres.configure(enabled=True, host_mb=4096)
    weightres.reset_stats()
    spec_mod.configure(enabled=False)
    sampling = SamplingParams(max_new_tokens=12, greedy=True, seed=0)

    def round_reqs():
        return [
            ChatRequest(
                model=f"tpu://{a}",
                system="You are an adversarial spec critic.",
                user="Critique the document.\nDebate round 1",
            )
            for a in ("random-tiny", "random-mistral-tiny")
        ]

    try:
        say("round 0: sizing the budget off the first model alone")
        probe = eng.chat(round_reqs()[:1], sampling)
        if not all(c.ok for c in probe):
            return [f"sizing round failed: {[c.error for c in probe]}"], payload
        one = max(
            e.bytes_device for e in eng.ledger._entries.values()
        )
        # Fits ONE model: loading the second must demote the first, and
        # every later round swaps through the host tier.
        os.environ["ADVSPEC_HBM_BUDGET_BYTES"] = str(int(one * 1.5))
        say("round 1 (1-model budget): forcing the demotion")
        base = eng.chat(round_reqs(), sampling)
        if not all(c.ok for c in base):
            failures.append(f"round 1 failed: {[c.error for c in base]}")
        demoted = [
            a for a in ("random-tiny", "random-mistral-tiny")
            if eng.ledger.is_host(a)
        ]
        if not demoted:
            failures.append("no model demoted under the 1-model budget")
        victim = demoted[0] if demoted else "random-tiny"
        say(f"round 2: injected fault at the {victim} promotion")
        injector.install(
            injector.FaultInjector(
                injector.parse_chaos_spec("device_lost@weight_swap:times=1")
            )
        )
        r2 = eng.chat(round_reqs(), sampling)
        injector.install(None)
        by_model = {
            req.model.split("//")[1]: comp
            for req, comp in zip(round_reqs(), r2)
        }
        hurt = by_model[victim]
        other = next(
            c for a, c in by_model.items() if a != victim
        )
        if hurt.ok:
            failures.append(
                "faulted promotion's admission did not degrade"
            )
        elif not hurt.transient:
            failures.append(
                f"injected swap fault classified non-transient: "
                f"{hurt.error}"
            )
        if not other.ok:
            failures.append(
                "co-scheduled group was evicted by someone else's "
                f"swap fault: {other.error}"
            )
        if not eng.ledger.is_host(victim):
            failures.append(
                f"aborted swap lost the host entry for {victim} "
                f"(state={eng.ledger.state(victim)!r})"
            )
        try:
            eng.check_residency_invariants()
        except RuntimeError as e:
            failures.append(f"residency ledger invariant violated: {e}")
        if weightres.stats.swap_faults != 1:
            failures.append(
                f"expected 1 swap fault, saw {weightres.stats.swap_faults}"
            )
        # The autodump must reconstruct the failed swap.
        dump = os.path.join(tmp, "events.fault.jsonl")
        if not os.path.exists(dump):
            failures.append("fault autodump was not written")
        else:
            lines = [
                json.loads(ln)
                for ln in Path(dump).read_text().splitlines()
                if ln
            ]
            bad = [p for ln in lines for p in validate_event(ln)]
            if bad:
                failures.append(f"autodump schema violations: {bad[:3]}")
            sf = [
                e for e in lines
                if e["type"] == "weight" and e["op"] == "swap_fault"
            ]
            if not sf:
                failures.append("autodump lacks the swap_fault event")
            elif sf[-1]["alias"] != victim:
                failures.append(
                    f"swap_fault names {sf[-1]['alias']!r}, not the "
                    f"victim {victim!r}"
                )
            if not any(e["type"] == "fault" for e in lines):
                failures.append("autodump lacks the classified fault")
            payload["autodump_events"] = len(lines)
            payload["autodump_kinds"] = event_kinds(lines)
        say("round 3: the retry must promote the same shards")
        captures, promote_s = device_loop.stats.captures, weightres.stats.promote_s
        r3 = eng.chat(round_reqs(), sampling)
        payload["retry_graph_captures"] = device_loop.stats.captures - captures
        payload["retry_promote_s"] = weightres.stats.promote_s - promote_s
        if not all(c.ok for c in r3):
            failures.append(f"retry round failed: {[c.error for c in r3]}")
        if [c.text for c in r3] != [c.text for c in base]:
            failures.append(
                "retry transcripts are not byte-identical to the "
                "pre-fault round"
            )
        try:
            eng.check_residency_invariants()
        except RuntimeError as e:
            failures.append(f"post-retry ledger invariant violated: {e}")
        payload.update(
            victim=victim,
            swap_faults=weightres.stats.swap_faults,
            promotions=weightres.stats.promotions,
            transcripts_byte_identical=(
                [c.text for c in r3] == [c.text for c in base]
            ),
        )
    finally:
        os.environ.pop("ADVSPEC_HBM_BUDGET_BYTES", None)
        injector.install(None)
        obs.configure(
            enabled=old_obs[0], events_out=old_obs[1] or "", dump_on_fault=old_obs[2]
        )
        weightres.configure(enabled=old_weights[0], host_mb=old_weights[1])
        spec_mod.configure(enabled=old_spec)
        shutil.rmtree(tmp, ignore_errors=True)
    return failures, payload


def event_kinds(events: list[dict]) -> list[str]:
    """The distinct ``type`` (``type/op`` where an event has an ``op``)
    of a flight-recorder dump, sorted: what a dump holds, independent of
    how many steps a run took."""
    return sorted(
        {f"{e['type']}/{e['op']}" if "op" in e else e["type"] for e in events}
    )


_SCALE_SPEC = (
    "## Goals\nAbsorb a demand step without shedding accepted work.\n"
    "## Constraints\n" + "The fleet SHALL grow before it sheds. " * 10
)
_SCALE_MODELS = ["mock://critic?v=1", "mock://critic?v=2"]
_SCALE_SAMPLE_KEYS = 2000  # affinity keys sampled for ring-movement math


def _ring_movement(before: list[str], after: list[str]) -> float:
    """Fraction of a fixed key sample whose PRIMARY owner changes
    between two memberships, on real ``HashRing`` instances — the
    consistent-hashing contract (≈1/N keys move per membership change,
    not a full reshuffle) measured against the drill's actual replica
    ids."""
    from adversarial_spec_tpu_torch.fleet.hashring import HashRing

    ra, rb = HashRing(before), HashRing(after)
    moved = sum(
        1
        for k in range(_SCALE_SAMPLE_KEYS)
        if ra.primary(f"debate-{k}") != rb.primary(f"debate-{k}")
    )
    return moved / _SCALE_SAMPLE_KEYS


def run_scale_storm(verbose: bool = True) -> tuple[list[str], dict]:
    """The elastic-fleet load-step drill (docs/fleet.md "grow before
    you shed"): an in-process serve daemon with a TIGHT per-replica
    backlog cap and an elastic fleet (floor 1, ceiling 3) takes an
    open-loop load step. The contract checked:

    1. scale-out ENGAGES BEFORE any shed (first ScaleEvent precedes
       the first shed ServeEvent in the flight recorder — capacity
       grows under pressure before admission refuses);
    2. zero accepted-request loss across every membership change;
    3. each membership change moves ≈1/N of the affinity keyspace
       (consistent hashing, measured on the drill's real rings);
    4. the backlog's collapse after the step drives scale-IN back to
       the floor with zero duplicated completions (the lose-nothing
       drain handoff);
    5. allocator/tier invariants are clean after the storm (the
       daemon's ``check`` op).

    Returns (failures, payload); the deterministic mock-clock variant
    lives in tests/test_torch_autoscale.py under the ``chaos`` marker."""
    import asyncio
    import threading
    import time

    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch import obs as obs_mod
    from adversarial_spec_tpu_torch import serve as serve_mod
    from adversarial_spec_tpu_torch.serve.client import ServeClient
    from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon
    from adversarial_spec_tpu_torch.serve.protocol import SHED_REASONS

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --scale-storm: {msg}", flush=True)

    failures: list[str] = []
    n_debates = 18
    old_serve = serve_mod.snapshot()
    old_fleet = fleet_mod.config()
    old_obs = obs_mod.config().enabled
    serve_mod.reset_stats()
    serve_mod.configure(
        max_queue_depth=64,
        max_backlog_tokens=4000,  # PER-REPLICA: elastic cap = N x this
        tenant_quota_tokens=0,
        drain_deadline_s=3.0,
    )
    fleet_mod.shutdown_fleet()
    fleet_mod.configure(
        enabled=True,
        replicas=1,  # founders start AT the floor
        transport="inproc",
        autoscale=True,
        min_replicas=1,
        max_replicas=3,
        scale_out_fraction=0.6,
        scale_in_fraction=0.15,
        scale_out_ticks=1,
        scale_in_ticks=3,
        scale_cooldown_s=0.1,
        scale_interval_s=0.01,
    )
    fleet_mod.reset_stats()
    old_ring = obs_mod.config().recorder_size
    # The ordering + membership assertions replay the WHOLE storm from
    # the flight recorder; size the ring so step-event volume cannot
    # age the early scale/shed events out.
    obs_mod.configure(enabled=True, recorder_size=131072)
    obs_mod.reset_stats()
    payload: dict = {}
    with tempfile.TemporaryDirectory(prefix="advspec-scale-") as td:
        sock = os.path.join(td, "serve.sock")
        ready = threading.Event()
        daemon = ServeDaemon(sock, sessions_dir=os.path.join(td, "sessions"))
        th = threading.Thread(
            target=lambda: asyncio.run(daemon.run(ready=ready)), daemon=True
        )
        th.start()
        if not ready.wait(10):
            return ["daemon did not come up"], {}
        client = ServeClient(sock, timeout_s=60)
        try:
            # The load step: open-loop, but PACED like a demand ramp
            # (a storm front arrives over tens of milliseconds, not in
            # one scheduler quantum) — the elasticity claim is "grows
            # under a step", not "wins a race with a synchronous
            # burst".
            t0 = time.monotonic()
            submitted = []
            for k in range(n_debates):
                submitted.append(
                    client.submit_debate(
                        _SCALE_SPEC,
                        _SCALE_MODELS,
                        tenant=f"t{k % 2}",
                        tier="batch",
                        max_new_tokens=160,
                    )
                )
                time.sleep(0.02)
            say(f"load step submitted: {n_debates} debates, open-loop")
            accepted = completed = 0
            shed_reasons: dict[str, int] = {}
            lost: list[str] = []
            for rid in submitted:
                evs = client.collect(rid, timeout_s=120)
                first, last = evs[0]["event"], evs[-1]
                if first == "accepted":
                    accepted += 1
                    opp_errors = [
                        r["error"]
                        for r in last.get("results", [])
                        if r.get("error")
                    ]
                    if (
                        last["event"] != "result"
                        or last.get("error")
                        or opp_errors
                    ):
                        lost.append(f"{rid}: {last.get('error') or last['event']}")
                    else:
                        completed += 1
                elif last["event"] == "shed":
                    reason = last.get("reason", "")
                    shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
                    if reason not in SHED_REASONS:
                        failures.append(f"untyped shed reason {reason!r}")
                else:
                    lost.append(f"{rid}: unexpected events {evs}")
            wall = time.monotonic() - t0
            # Let the post-step idle drive scale-in BEFORE replaying
            # the recorder, so the membership history below covers the
            # whole lifecycle (out AND in).
            deadline = time.monotonic() + 8.0
            while (
                fleet_mod.stats.scale_ins < 1
                and time.monotonic() < deadline
            ):
                time.sleep(0.02)

            # 1. the fleet grew, and grew BEFORE any shed.
            if fleet_mod.stats.scale_outs < 1:
                failures.append("load step never triggered a scale-out")
            events = obs_mod.recorder.events()
            scale_seqs = [
                e["seq"] for e in events if e["type"] == "scale"
            ]
            shed_seqs = [
                e["seq"]
                for e in events
                if e["type"] == "serve" and e["op"] == "shed"
            ]
            if shed_seqs and (
                not scale_seqs or min(scale_seqs) > min(shed_seqs)
            ):
                failures.append(
                    "admission shed before the autoscaler engaged "
                    f"(first shed seq {min(shed_seqs)}, first scale "
                    f"seq {min(scale_seqs) if scale_seqs else 'never'})"
                )
            # 2. zero accepted-request loss.
            if lost:
                failures.append(
                    f"{len(lost)} accepted request(s) lost: {lost[:3]}"
                )
            if accepted + sum(shed_reasons.values()) != n_debates:
                failures.append("accounting hole in the storm ledger")

            # 3. ≈1/N key movement per membership change, on the real
            # ring implementation with the drill's replica ids.
            memberships: list[list[str]] = [["r0"]]
            for e in events:
                if e["type"] != "scale":
                    continue
                cur = list(memberships[-1])
                if e["op"] == "serving" and e["replica"] not in cur:
                    memberships.append(sorted(cur + [e["replica"]]))
                elif e["op"] == "draining" and e["replica"] in cur:
                    cur.remove(e["replica"])
                    memberships.append(cur)
            movements = []
            for before, after in zip(memberships, memberships[1:]):
                frac = _ring_movement(before, after)
                n_ref = max(len(before), len(after))
                movements.append(round(frac, 4))
                if not (0.5 / n_ref) <= frac <= min(1.0, 2.0 / n_ref):
                    failures.append(
                        f"membership change {before}->{after} moved "
                        f"{frac:.0%} of keys (expected ~{1 / n_ref:.0%})"
                    )

            # 4. the step's collapse drives scale-in back to the
            # floor, with the lose-nothing drain handoff.
            if fleet_mod.stats.scale_ins < 1:
                failures.append("idle fleet never scaled back in")
            if fleet_mod.stats.duplicated_completions:
                failures.append(
                    f"{fleet_mod.stats.duplicated_completions} duplicated "
                    "completion(s) across membership changes"
                )
            # 5. clean invariants after the storm.
            chk = client.check()
            if not chk.get("ok"):
                failures.append(f"invariants violated: {chk.get('problems')}")
            payload = {
                "submitted": n_debates,
                "accepted": accepted,
                "completed": completed,
                "shed_reasons": shed_reasons,
                "scale_outs": fleet_mod.stats.scale_outs,
                "scale_ins": fleet_mod.stats.scale_ins,
                "spawn_failures": fleet_mod.stats.spawn_failures,
                "flaps_suppressed": fleet_mod.stats.flaps_suppressed,
                "duplicated_completions": (
                    fleet_mod.stats.duplicated_completions
                ),
                "key_movement_per_change": movements,
                "memberships": [len(m) for m in memberships],
                "storm_wall_s": round(wall, 3),
                "invariants_clean": bool(chk.get("ok")),
                "zero_accepted_lost": not lost,
            }
            say(
                f"{accepted} accepted ({completed} completed), "
                f"{sum(shed_reasons.values())} shed, "
                f"{fleet_mod.stats.scale_outs} scale-out(s), "
                f"{fleet_mod.stats.scale_ins} scale-in(s), "
                f"key movement {movements}"
            )
            client.drain()
        finally:
            client.close()
            th.join(timeout=15)
            if th.is_alive():
                failures.append("daemon failed to drain/exit")
            serve_mod.configure(
                max_queue_depth=old_serve["max_queue_depth"],
                max_backlog_tokens=old_serve["max_backlog_tokens"],
                tenant_quota_tokens=old_serve["tenant_quota_tokens"],
                drain_deadline_s=old_serve["drain_deadline_s"],
            )
            fleet_mod.shutdown_fleet()
            fleet_mod.configure(
                enabled=old_fleet.enabled,
                replicas=old_fleet.replicas,
                transport=old_fleet.transport,
                autoscale=old_fleet.autoscale,
                min_replicas=old_fleet.min_replicas,
                max_replicas=old_fleet.max_replicas,
                scale_out_fraction=old_fleet.scale_out_fraction,
                scale_in_fraction=old_fleet.scale_in_fraction,
                scale_out_ticks=old_fleet.scale_out_ticks,
                scale_in_ticks=old_fleet.scale_in_ticks,
                scale_cooldown_s=old_fleet.scale_cooldown_s,
                scale_interval_s=old_fleet.scale_interval_s,
            )
            fleet_mod.reset_stats()
            obs_mod.configure(enabled=old_obs, recorder_size=old_ring)
    return failures, payload


def scale_storm_drill(verbose: bool = True) -> int:
    failures, _ = run_scale_storm(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print(
            "chaos_run --scale-storm: warm-before-ring growth + "
            "lose-nothing scale-in + ~1/N ring movement hold",
            flush=True,
        )
    return 0


def weight_swap_drill(verbose: bool = True) -> int:
    failures, _ = run_weight_swap(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print(
            "chaos_run --weight-swap: aborted-swap containment + "
            "ledger conservation + autodump reconstruction hold",
            flush=True,
        )
    return 0


def run_deadlock_hammer(verbose: bool = True) -> tuple[list[str], dict]:
    """The lock-discipline drill (docs/locking.md), two phases:

    1. CLEAN STORM: a real ServeScheduler and a real Autoscaler over a
       real in-proc fleet, all locks tracked by the lockdep sanitizer
       (resilience/lockdep.py). Worker threads hammer exactly the
       cross-component paths that hold one lock while taking another:
       autoscaler ticks (Autoscaler._lock -> ServeScheduler._lock via
       the pressure observer, -> FleetRouter._mlock via membership
       surgery), admissions whose capacity provider reads the ring
       under the scheduler lock (ServeScheduler._lock ->
       FleetRouter._mlock), and router health rounds. Contract: the
       sanitizer records cross-lock edges (the storm really exercised
       nesting) and ZERO violations — the shipped hierarchy is acyclic
       under real concurrency, not just under GL-LOCK-ORDER's static
       graph.

    2. SEEDED INVERSION: two fresh tracked locks driven through a
       deterministic two-thread A->B / B->A inversion — the threads
       run SEQUENTIALLY (start+join each), so the opposite-direction
       edge is already in the graph when the second thread inverts it
       and no real deadlock is ever risked. Contract: exactly the
       seeded violation is detected, naming both stacks. Proves the
       drill would catch a phase-1 regression rather than silently
       passing with a dead sanitizer.

    Returns (failures, payload); tests/test_torch_lockdep.py runs it
    under the ``chaos`` marker."""
    import threading
    import time

    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch import serve as serve_mod
    from adversarial_spec_tpu_torch.fleet.autoscale import Autoscaler
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine
    from adversarial_spec_tpu_torch.resilience import lockdep
    from adversarial_spec_tpu_torch.serve.sched import ServeScheduler

    def say(msg: str) -> None:
        if verbose:
            print(f"chaos_run --deadlock-hammer: {msg}", flush=True)

    failures: list[str] = []
    payload: dict = {}
    old_serve = serve_mod.snapshot()
    old_fleet = fleet_mod.config()
    serve_mod.reset_stats()
    serve_mod.configure(
        max_queue_depth=256,
        max_backlog_tokens=100_000,
        tenant_quota_tokens=0,
        drain_deadline_s=3.0,
    )
    fleet_mod.shutdown_fleet()
    fleet_mod.configure(
        enabled=True,
        replicas=2,
        transport="inproc",
        autoscale=True,
        min_replicas=1,
        max_replicas=3,
        scale_out_fraction=0.5,
        scale_in_fraction=0.1,
        scale_out_ticks=1,
        scale_in_ticks=2,
        scale_cooldown_s=0.0,
        scale_interval_s=0.01,
    )
    lockdep.configure(enabled=True, raise_on_violation=False)
    lockdep.reset()
    try:
        # -- phase 1: clean ordered storm over the real stack ---------
        say("phase 1: concurrent admission/tick/health storm")
        eng = FleetEngine(replicas=2)
        sched = ServeScheduler()
        sched.set_capacity_provider(
            lambda: len(eng.router.alive_ids())
        )
        scaler = Autoscaler(
            eng,
            pressure=sched.pressure_snapshot,
            sleep=lambda s: None,
        )
        stop_t = time.monotonic() + 2.0
        errors: list[str] = []

        def admit_loop() -> None:
            i = 0
            try:
                while time.monotonic() < stop_t:
                    i += 1
                    deb = f"hammer-{threading.get_ident()}-{i}"
                    shed = sched.try_admit(
                        "tenant-a",
                        "interactive",
                        deb,
                        est_tokens=200,
                        models=["mock://critic", "mock://agree"],
                    )
                    if shed is None:
                        sched.pressure_snapshot()
                        sched.finish_debate(deb)
            except Exception as exc:  # noqa: BLE001 - drill boundary
                errors.append(f"admit_loop: {exc!r}")

        def tick_loop() -> None:
            try:
                while time.monotonic() < stop_t:
                    scaler.tick()
            except Exception as exc:  # noqa: BLE001 - drill boundary
                errors.append(f"tick_loop: {exc!r}")

        def health_loop() -> None:
            try:
                while time.monotonic() < stop_t:
                    eng.router.health_check()
                    eng.router.check_invariants()
            except Exception as exc:  # noqa: BLE001 - drill boundary
                errors.append(f"health_loop: {exc!r}")

        threads = [
            threading.Thread(target=admit_loop, name="hammer-admit-1"),
            threading.Thread(target=admit_loop, name="hammer-admit-2"),
            threading.Thread(target=tick_loop, name="hammer-tick"),
            threading.Thread(target=health_loop, name="hammer-health"),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        if any(t.is_alive() for t in threads):
            failures.append("storm thread wedged (possible deadlock)")
        failures.extend(errors)
        edges = lockdep.order_edges()
        cross = {
            (a, b) for a, bs in edges.items() for b in bs if a != b
        }
        payload["edges"] = sorted(f"{a}->{b}" for a, b in cross)
        say(f"storm recorded {len(cross)} cross-lock edge(s)")
        if not cross:
            failures.append(
                "storm recorded no cross-lock edges — the drill did "
                "not exercise nested acquisition (dead hammer)"
            )
        storm_violations = lockdep.violations()
        if storm_violations:
            failures.append(
                "lock-order violation(s) in the real stack:\n"
                + "\n\n".join(str(v) for v in storm_violations)
            )
        eng.shutdown()
        sched.stop()

        # -- phase 2: seeded deterministic inversion ------------------
        say("phase 2: seeded two-thread A->B / B->A inversion")
        lockdep.reset()
        a = lockdep.TrackedLock("hammer.A", metrics=False)
        b = lockdep.TrackedLock("hammer.B", metrics=False)

        def forward() -> None:
            with a:
                with b:
                    pass

        def backward() -> None:
            with b:
                with a:
                    pass

        for fn in (forward, backward):  # sequential: no real deadlock
            t = threading.Thread(target=fn, name=f"hammer-{fn.__name__}")
            t.start()
            t.join(timeout=10.0)
        seeded = lockdep.violations()
        payload["seeded_violations"] = len(seeded)
        if len(seeded) != 1:
            failures.append(
                f"seeded inversion produced {len(seeded)} violation(s), "
                "expected exactly 1"
            )
        else:
            v = seeded[0]
            if v.edge != ("hammer.B", "hammer.A"):
                failures.append(f"seeded violation edge {v.edge}")
            msg = str(v)
            if "this acquisition" not in msg or "opposite edge" not in msg:
                failures.append(
                    f"seeded violation does not name both stacks: "
                    f"{msg[:200]!r}"
                )
    finally:
        lockdep.reset()
        lockdep.configure(
            enabled=lockdep.env_enabled(), raise_on_violation=False
        )
        serve_mod.configure(
            max_queue_depth=old_serve["max_queue_depth"],
            max_backlog_tokens=old_serve["max_backlog_tokens"],
            tenant_quota_tokens=old_serve["tenant_quota_tokens"],
            drain_deadline_s=old_serve["drain_deadline_s"],
        )
        serve_mod.reset_stats()
        fleet_mod.shutdown_fleet()
        fleet_mod.configure(
            enabled=old_fleet.enabled,
            replicas=old_fleet.replicas,
            transport=old_fleet.transport,
            autoscale=old_fleet.autoscale,
            min_replicas=old_fleet.min_replicas,
            max_replicas=old_fleet.max_replicas,
            scale_out_fraction=old_fleet.scale_out_fraction,
            scale_in_fraction=old_fleet.scale_in_fraction,
            scale_out_ticks=old_fleet.scale_out_ticks,
            scale_in_ticks=old_fleet.scale_in_ticks,
            scale_cooldown_s=old_fleet.scale_cooldown_s,
            scale_interval_s=old_fleet.scale_interval_s,
        )
        fleet_mod.reset_stats()
    return failures, payload


def deadlock_hammer_drill(verbose: bool = True) -> int:
    failures, _ = run_deadlock_hammer(verbose)
    if failures:
        print("\n".join(f"FAIL: {f}" for f in failures), file=sys.stderr)
        return 1
    if verbose:
        print(
            "chaos_run --deadlock-hammer: acyclic order under real "
            "concurrency + seeded inversion detected with both stacks",
            flush=True,
        )
    return 0


def port_test_files() -> list[str]:
    """The port's test files (``tests/test_torch_*.py``): the marked suite
    runs these only, never the reference package's."""
    return sorted(
        str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_*.py")
    )


def _pytest(
    extra: list[str], env_overrides: dict[str, str], files: list[str] | None = None
) -> int:
    env = dict(os.environ)
    # The port's tests hold it against the JAX package on the CPU.
    env.setdefault("JAX_PLATFORMS", "cpu")
    env.update(env_overrides)
    return subprocess.run(
        [
            sys.executable,
            "-m",
            "pytest",
            "-q",
            "-p",
            "no:cacheprovider",
            "-m",
            "chaos",
            *(port_test_files() if files is None else files),
            *extra,
        ],
        cwd=REPO,
        env=env,
    ).returncode


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--sweep",
        type=int,
        default=0,
        metavar="N",
        help="after the marked suite, re-run the scheduler chaos fuzz "
        "under N extra ADVSPEC_CHAOS_FUZZ_SEED values",
    )
    ap.add_argument(
        "--crash",
        action="store_true",
        help="kill-chaos recovery drill: SIGKILL a real subprocess round "
        "mid-journal, resume, assert no duplicated opponent work and "
        "byte-identical journal-served transcripts",
    )
    ap.add_argument(
        "--replica-kill",
        action="store_true",
        help="fleet replica-loss drill: SIGKILL one of 2 worker replicas "
        "mid-round, assert the round completes on the survivor with "
        "byte-identical transcripts, zero duplicated opponent attempts, "
        "shared-store rehydration, and clean survivor invariants",
    )
    ap.add_argument(
        "--handoff-kill",
        action="store_true",
        help="prefill-loss handoff drill: SIGKILL the prefill replica of "
        "a 1+1 disagg worker fleet after its published KV blocks are "
        "durable but before the decode replica promotes them; assert "
        "store-rehydrated adoption, clean degradation on a partial "
        "publication, byte-identical transcripts, zero duplicated "
        "completions, and clean survivor invariants",
    )
    ap.add_argument(
        "--overload",
        action="store_true",
        help="serve overload storm drill: open-loop burst at several "
        "times the daemon's backlog cap; assert typed sheds with "
        "retry-after, zero accepted-request loss, interactive p99 TTFT "
        "within SLO with the batch tier paused first (brownout), and "
        "clean allocator/tier invariants",
    )
    ap.add_argument(
        "--weight-swap",
        action="store_true",
        help="weight-residency fault drill (on the CUDA card): inject a "
        "fault mid-promotion of host-demoted model shards; assert only the waiting admission "
        "degrades, the residency ledger stays conservation-clean, the "
        "JSONL autodump reconstructs the failed swap, and the retry "
        "promotes byte-identically",
    )
    ap.add_argument(
        "--scale-storm",
        action="store_true",
        help="elastic-fleet load-step drill: open-loop demand step "
        "against an autoscaled fleet (floor 1, ceiling 3); assert "
        "scale-out engages before any shed, zero accepted-request "
        "loss, ~1/N affinity-key movement per membership change, "
        "lose-nothing scale-in with zero duplicated completions, and "
        "clean allocator/tier invariants",
    )
    ap.add_argument(
        "--deadlock-hammer",
        action="store_true",
        help="lock-discipline drill: concurrent admission/autoscale/"
        "health storm over the real scheduler+fleet with the lockdep "
        "sanitizer armed (assert cross-lock edges recorded and zero "
        "order violations), then a seeded sequential two-thread "
        "inversion (assert exactly one violation naming both stacks)",
    )
    ap.add_argument(
        "--drain",
        action="store_true",
        help="serve SIGTERM drain drill: a real subprocess daemon is "
        "SIGTERMed mid-burst; assert typed draining sheds, every "
        "accepted debate resolved, exit 0 with a clean drain report, "
        "and drained sessions journal-resumable on a fresh daemon "
        "with byte-identical transcripts",
    )
    args, extra = ap.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]

    if args.crash:
        return crash_drill()
    if args.replica_kill:
        return replica_kill_drill()
    if args.handoff_kill:
        return handoff_kill_drill()
    if args.overload:
        return overload_drill()
    if args.scale_storm:
        return scale_storm_drill()
    if args.deadlock_hammer:
        return deadlock_hammer_drill()
    if args.drain:
        return drain_drill()
    if args.weight_swap:
        return weight_swap_drill()

    rc = _pytest(extra, {})
    if rc != 0:
        return rc
    for seed in range(3, 3 + args.sweep):  # tier-1 already pins 0..2
        print(f"\n=== chaos sweep seed {seed} ===", flush=True)
        rc = _pytest(
            ["-k", "ChaosFuzz"],
            {"ADVSPEC_CHAOS_FUZZ_SEED": str(seed)},
            files=["tests/test_torch_chaos.py"],
        )
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
