"""CLI front-end — the L4 layer (the PyTorch port's copy of
``adversarial_spec_tpu/cli.py``).

Run it as ``python -m adversarial_spec_tpu_torch.cli``. It keeps the
reference's actions, flags, exit codes and ``--json`` schema, and serves
``mock://`` ids through the port's ``MockEngine`` and ``tpu://`` ids
through ``GpuEngine`` on the GPU. Sessions, checkpoints, the round
journal, profiles and the registry live at the reference's paths, so a
session one package started, the other resumes.

A knob of a subsystem the port does not have yet exits 2 with "not yet
ported" (``_unported_knobs``): ``--pipeline-depth 2`` and its env var.
Every registry mesh alias (dp, tp, sp and their products) runs its round
on ``GpuEngine``, as the reference's runs on ``TpuEngine``.
The ``serve`` action runs the port's daemon (``serve/``), and the fleet
(``--fleet*``, ``--scale-*``, their ``ADVSPEC_FLEET*`` env vars, the
``replica`` chaos seam; ``perf.fleet``) is the reference's, over
replicas of the port's engines (``fleet/``). The KV tiers
are the reference's (``--kv-tier``/``--no-kv-tier``, ``--kv-host-mb``,
``--kv-store-dir``, ``--kv-flush-blocks`` and their env vars;
``perf.kv_tier``), and so are
``--no-interleave`` (the batcher's legacy loop) and the chaos seams
``generate``, ``scheduler_chunk``, ``kv_alloc`` and ``kv_swap``. Of the
subsystems the reference arms by default, ``perf.interleave`` shows
pipeline depth 1. Weight residency is the
reference's: ``--weight-res``/``--no-weight-res``, ``--weight-host-mb``
and their env vars arm ``GpuEngine``'s ledger (on, 2048 MiB of host by
default), and ``perf.weights`` reports it. A ``tpu://`` id whose
``tokenizer.json`` the port's reader refuses exits 2 with the
component's name. A ``tpu://`` id with no GPU present exits 2 with
"no CUDA device is available"; the CLI never runs a model on the CPU
(tests put a CPU engine into ``engine/dispatch.py`` themselves).

The reference's description of this layer:

Behavioral parity with reference scripts/debate.py: same action set
(``critique, providers, send-final, diff, export-tasks, focus-areas,
personas, profiles, save-profile, sessions`` — reference :397-413), with the
reference's ``bedrock`` gateway action replaced by the TPU-native analog
``registry`` (local model registry management, SURVEY §2.3). Same exit-code
contract (0 ok / 1 runtime error / 2 validation failure, reference :39-43),
same stderr-human/stdout-JSON split, and the same JSON output schema
(reference :909-941) so the L5 agent protocol can drive either
implementation unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from adversarial_spec_tpu_torch.debate import journal as journal_mod
from adversarial_spec_tpu_torch.debate import prompts
from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
from adversarial_spec_tpu_torch.debate.parsing import extract_tasks, generate_diff
from adversarial_spec_tpu_torch.debate.profiles import (
    apply_profile,
    list_profiles,
    load_profile,
    save_profile,
)
from adversarial_spec_tpu_torch.debate.session import (
    CorruptSessionState,
    InvalidSessionId,
    SessionState,
    save_checkpoint,
)
from adversarial_spec_tpu_torch.debate.usage import CostTracker
from adversarial_spec_tpu_torch.engine import registry as model_registry
from adversarial_spec_tpu_torch.engine import dispatch
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_VALIDATION = 2

ACTIONS = [
    "critique",
    "providers",
    "send-final",
    "diff",
    "export-tasks",
    "focus-areas",
    "personas",
    "profiles",
    "save-profile",
    "sessions",
    "registry",
    "serve",
]

DEFAULT_MODELS = ["mock://critic?agree_after=3"]

# Bigger models make better critics; used to rank registry entries when
# auto-picking a default opponent (reference analog: priority-ordered
# default-model detection, providers.py:394-415).
_SIZE_RANK = {"70b": 6, "9b": 5, "8b": 4, "7b": 3, "3b": 2, "1b": 1, "tiny": 0}


def get_default_models() -> list[str]:
    """Best servable opponent: a registry alias with a real, resolvable
    checkpoint (largest first); else the mock critic so the loop always
    runs."""
    reg = model_registry.load_registry()
    real = [
        (spec, alias)
        for alias, spec in reg.items()
        if spec.checkpoint != "random"
        and model_registry.validate_tpu_model(f"tpu://{alias}", registry=reg)
        is None
    ]
    if real:
        real.sort(key=lambda e: _SIZE_RANK.get(e[0].size, -1), reverse=True)
        return [f"tpu://{real[0][1]}"]
    return list(DEFAULT_MODELS)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)


def create_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="debate",
        description="TPU-native adversarial spec debate engine",
    )
    parser.add_argument("action", choices=ACTIONS, help="Command to run")

    g = parser.add_argument_group("debate")
    g.add_argument(
        "--models",
        "-m",
        help="Comma-separated model ids (mock://... or tpu://alias)",
    )
    g.add_argument(
        "--doc-type",
        choices=["prd", "tech", "generic"],
        default=None,
        help="Document type (default: generic)",
    )
    g.add_argument("--round", type=int, default=1, help="Debate round number")
    g.add_argument("--focus", help="Focus area (see focus-areas action)")
    g.add_argument("--persona", help="Persona key or freeform persona text")
    g.add_argument(
        "--preserve-intent",
        action="store_true",
        help="Constrain critique to preserve the author's intent",
    )
    g.add_argument(
        "--press",
        action="store_true",
        help="Press round: force models to re-justify quick agreement",
    )
    g.add_argument(
        "--context",
        action="append",
        default=None,
        help="Context file injected into prompts (repeatable)",
    )

    s = parser.add_argument_group("session")
    s.add_argument("--session", help="Session id to create/update")
    s.add_argument("--resume", help="Resume a previous session by id")
    s.add_argument("--profile", help="Load settings from a saved profile")
    s.add_argument("--name", help="Profile name (for save-profile)")
    s.add_argument(
        "--journal",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_JOURNAL (default on)
        help="Crash-safe round journal for sessions: every opponent "
        "completion is fsync'd to <session>.journal.jsonl the moment "
        "it resolves, and --resume after a crash serves completed "
        "opponents from the journal byte-identically instead of "
        "re-decoding them (--no-journal disables; ADVSPEC_JOURNAL=0 "
        "sets the process default)",
    )

    o = parser.add_argument_group("output")
    o.add_argument("--json", "-j", action="store_true", help="JSON output")
    o.add_argument(
        "--show-cost", action="store_true", help="Print cost/usage summary"
    )
    o.add_argument("--previous", help="Previous spec file (diff action)")
    o.add_argument("--current", help="Current spec file (diff action)")
    o.add_argument(
        "--notify",
        action="store_true",
        help="Send round summary to Telegram and poll for feedback",
    )
    o.add_argument(
        "--feedback-timeout",
        type=int,
        default=0,
        help="Seconds to wait for Telegram feedback (0 = don't poll)",
    )
    o.add_argument(
        "--profile-dir",
        help="Write a torch.profiler trace (Chrome trace format) of the round "
        "into this directory",
    )

    b = parser.add_argument_group("observability")
    b.add_argument(
        "--metrics-out",
        help="Write the round's metrics registry to this file in "
        "Prometheus text exposition format",
    )
    b.add_argument(
        "--events-out",
        help="Write the flight recorder's event ring to this file as "
        "JSONL at end of round; fault/timeout evictions auto-dump the "
        "ring to a sibling <stem>.<trigger>.jsonl the moment they "
        "happen",
    )
    b.add_argument(
        "--flight-recorder-size",
        type=int,
        default=None,
        help="Events the flight recorder ring retains (default 512; "
        "ADVSPEC_FLIGHT_RECORDER_SIZE sets the process default)",
    )
    b.add_argument(
        "--obs",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_OBS (default on)
        help="Observability subsystem: metrics registry + flight "
        "recorder + retrace watch (--no-obs disables every emit; "
        "ADVSPEC_OBS=0 sets the process default)",
    )
    b.add_argument(
        "--slo-ttft-ms",
        type=float,
        default=None,  # None = inherit ADVSPEC_SLO_TTFT_MS (default off)
        help="Per-request TTFT SLO budget in milliseconds: a request "
        "whose own prefill wall breaches it arms ONE flight-recorder "
        "dump scoped to its trace (sibling <stem>.slo_ttft.jsonl of "
        "--events-out, the fault-dump discipline). 0 disables; "
        "ADVSPEC_SLO_TTFT_MS sets the process default",
    )
    b.add_argument(
        "--slo-round-s",
        type=float,
        default=None,  # None = inherit ADVSPEC_SLO_ROUND_S (default off)
        help="Per-request service SLO budget in seconds (prefill + "
        "decode, the per-opponent round latency): a breaching request "
        "self-captures once to <stem>.slo_round.jsonl. 0 disables; "
        "ADVSPEC_SLO_ROUND_S sets the process default",
    )

    d = parser.add_argument_group("decode")
    d.add_argument(
        "--max-new-tokens",
        type=int,
        default=None,
        help="Response token cap (default 1024)",
    )
    d.add_argument(
        "--temperature", type=float, default=None, help="Sampling temperature"
    )
    d.add_argument(
        "--greedy", action="store_true", help="Greedy (argmax) decoding"
    )
    d.add_argument("--seed", type=int, default=None, help="Sampling PRNG seed")
    d.add_argument(
        "--timeout",
        type=float,
        default=None,
        help="Per-round wall-clock budget in seconds (default 600)",
    )
    d.add_argument(
        "--request-deadline-s",
        type=float,
        default=None,  # None = inherit ADVSPEC_REQUEST_DEADLINE_S (off)
        help="Per-REQUEST watchdog deadline in seconds: a single "
        "hung/slow opponent request is evicted as a TIMEOUT fault at "
        "this deadline (partial text kept, co-residents unaffected) "
        "and re-admitted ONCE on a tightened budget, where --timeout "
        "would have expired the whole round at once. 0 disables; "
        "ADVSPEC_REQUEST_DEADLINE_S sets the process default",
    )
    d.add_argument(
        "--prefix-cache",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="Cross-round prefix KV cache: shared spec/transcript "
        "prefixes prefill once and are reused via ref-counted page "
        "sharing (--no-prefix-cache disables)",
    )
    d.add_argument(
        "--prefix-cache-pages",
        type=int,
        default=0,
        help="Cap on KV pages the prefix cache may retain "
        "(0 = bounded only by the pool, evicting LRU under pressure)",
    )
    d.add_argument(
        "--kv-tier",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_KV_TIER (default on)
        help="Tiered KV cache: LRU-evicted prefix blocks demote to "
        "host RAM and promote back instead of re-prefilling; with "
        "--kv-store-dir they also persist to a content-addressed disk "
        "store a restarted server rehydrates from (--no-kv-tier "
        "disables; ADVSPEC_KV_TIER=0 sets the process default)",
    )
    d.add_argument(
        "--kv-host-mb",
        type=int,
        default=None,  # None = inherit ADVSPEC_KV_HOST_MB (default 256)
        help="Host-RAM KV tier budget in MiB (0 disables tier 1; "
        "default 256, ADVSPEC_KV_HOST_MB sets the process default)",
    )
    d.add_argument(
        "--kv-store-dir",
        default=None,  # None = inherit ADVSPEC_KV_STORE_DIR (default off)
        help="Root directory of the persistent content-addressed KV "
        "block store (tier 2); entries are namespaced by a "
        "model/config fingerprint, written atomically, and corrupt "
        "entries quarantine instead of serving (unset disables; "
        "ADVSPEC_KV_STORE_DIR sets the process default)",
    )
    d.add_argument(
        "--kv-flush-blocks",
        type=int,
        default=None,  # None = inherit ADVSPEC_KV_FLUSH_BLOCKS (default 0)
        help="Write-through flush threshold for the disk KV store: "
        "flush pending demoted blocks every N enqueued blocks instead "
        "of only at settle, bounding the publish window a crash can "
        "lose (0 = settle-only, the default; "
        "ADVSPEC_KV_FLUSH_BLOCKS sets the process default)",
    )
    d.add_argument(
        "--weight-res",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_WEIGHT_RES (default on)
        help="Weight residency paging: an opponent model evicted from "
        "HBM demotes its (quantized) shards to host RAM and promotes "
        "back with one committed device_put on its next turn, instead "
        "of paying a full checkpoint re-materialization per swap "
        "(--no-weight-res restores naive evict-reload; "
        "ADVSPEC_WEIGHT_RES=0 sets the process default)",
    )
    d.add_argument(
        "--weight-host-mb",
        type=int,
        default=None,  # None = inherit ADVSPEC_WEIGHT_HOST_MB
        help="Host-RAM budget in MiB for demoted model weights "
        "(LRU overflow frees; 0 disables paging; default 2048, "
        "ADVSPEC_WEIGHT_HOST_MB sets the process default)",
    )
    d.add_argument(
        "--interleave",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_INTERLEAVE (default on)
        help="Fused prefill+decode steps and the two-deep pipelined "
        "scheduler drive loop (default on; --no-interleave restores "
        "the legacy serialized loop, ADVSPEC_INTERLEAVE=0 sets the "
        "process default)",
    )
    d.add_argument(
        "--pipeline-depth",
        type=int,
        default=None,
        help="Scheduler steps kept in flight (1-2; default 2; 1 = fused "
        "but synchronous)",
    )
    d.add_argument(
        "--speculative",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_SPECULATIVE (default on)
        help="Per-slot prompt-lookup speculative decoding in the "
        "continuous batcher: draft up to γ tokens per row from its own "
        "context, verify in one multi-position forward (default on; "
        "greedy output is byte-identical either way; "
        "ADVSPEC_SPECULATIVE=0 sets the process default)",
    )
    d.add_argument(
        "--gamma",
        type=int,
        default=None,  # None = inherit ADVSPEC_GAMMA (default 8)
        help="Draft length per speculative step (>= 1; default 8, "
        "ADVSPEC_GAMMA sets the process default; the tpu_ladder gamma "
        "sweep measures the on-chip crossover)",
    )

    d.add_argument(
        "--stream",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_STREAM (default on)
        help="Stream tokens per request from the serving path to a "
        "host-side consumer at the drive loop's existing fetch points "
        "(default on; --no-stream restores the blocking path, "
        "byte-identical end to end; ADVSPEC_STREAM=0 sets the process "
        "default)",
    )
    d.add_argument(
        "--early-cancel",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_EARLY_CANCEL (default on)
        help="Cancel an opponent's request mid-decode the moment its "
        "verdict marker ([AGREE]) appears in the stream: the slot and "
        "pages free immediately and queued requests admit into them "
        "(default on; needs --stream; transcripts stay byte-identical "
        "up to each cancellation point; ADVSPEC_EARLY_CANCEL=0 sets "
        "the process default)",
    )

    z = parser.add_argument_group("resilience")
    z.add_argument(
        "--chaos",
        help=(
            "Arm fault injection: kind@seam[:p=F][:after=N][:times=N]"
            "[:slot=K], comma-separated (kinds: oom, device_lost, "
            "preempted, timeout, shed, bug; seams: generate, scheduler_chunk, "
            "kv_alloc, kv_swap, checkpoint_load, crash, replica). Also "
            "via ADVSPEC_CHAOS"
        ),
    )
    z.add_argument(
        "--chaos-seed",
        type=int,
        default=None,
        help="Seed for probabilistic chaos rules (reproducible runs)",
    )
    z.add_argument(
        "--breaker-threshold",
        type=int,
        default=None,
        help="Consecutive failures before a model's circuit opens (default 3)",
    )
    z.add_argument(
        "--breaker-cooldown",
        type=float,
        default=None,
        help="Seconds an open circuit waits before a half-open probe "
        "(default 30)",
    )
    z.add_argument(
        "--no-breaker",
        action="store_true",
        help="Disable circuit breakers (always query every model)",
    )
    z.add_argument(
        "--fleet",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_FLEET (default off)
        help="Route requests across N replicated engines with "
        "prefix-affinity placement (one replica per debate via "
        "consistent hashing over --session), per-(replica, model) "
        "breaker-aware failover, and shared-store KV recovery "
        "(docs/fleet.md; ADVSPEC_FLEET=1 sets the process default)",
    )
    z.add_argument(
        "--fleet-replicas",
        type=int,
        default=None,  # None = inherit ADVSPEC_FLEET_REPLICAS (default 2)
        help="Engine replicas behind the fleet router (>= 2 to route; "
        "ADVSPEC_FLEET_REPLICAS sets the process default)",
    )
    z.add_argument(
        "--fleet-transport",
        choices=["inproc", "worker"],
        default=None,  # None = inherit ADVSPEC_FLEET_TRANSPORT (inproc)
        help="Replica transport: fresh in-process engines (inproc) or "
        "one subprocess per replica (worker — the SIGKILL-able "
        "topology tools/chaos_run.py --replica-kill drills)",
    )
    z.add_argument(
        "--fleet-autoscale",
        action=argparse.BooleanOptionalAction,
        default=None,  # None = inherit ADVSPEC_FLEET_AUTOSCALE (off)
        help="Elastic fleet: a backlog-driven control loop grows and "
        "shrinks membership between --fleet-min and --fleet-max — "
        "warm-before-ring scale-out, lose-nothing drain on scale-in "
        "(docs/fleet.md; ADVSPEC_FLEET_AUTOSCALE=1 sets the default)",
    )
    z.add_argument(
        "--fleet-min",
        type=int,
        default=None,  # None = inherit ADVSPEC_FLEET_MIN (default 1)
        help="Autoscaler replica floor (ADVSPEC_FLEET_MIN)",
    )
    z.add_argument(
        "--fleet-max",
        type=int,
        default=None,  # None = inherit ADVSPEC_FLEET_MAX (default 4)
        help="Autoscaler replica ceiling (ADVSPEC_FLEET_MAX)",
    )
    z.add_argument(
        "--fleet-prefill-replicas",
        type=int,
        default=None,  # None = inherit ADVSPEC_FLEET_PREFILL_REPLICAS
        help="Disaggregated serving: founders carrying the prefill "
        "role — large admissions prefill there and ship their KV "
        "blocks to a decode replica through the shared store "
        "(docs/fleet.md; 0 = symmetric fleet, the default; "
        "ADVSPEC_FLEET_PREFILL_REPLICAS sets the process default)",
    )
    z.add_argument(
        "--scale-cooldown-s",
        type=float,
        default=None,  # None = inherit ADVSPEC_FLEET_SCALE_COOLDOWN_S
        help="Minimum seconds between membership changes — the flap "
        "damper, and the scale-in drain budget "
        "(ADVSPEC_FLEET_SCALE_COOLDOWN_S, default 5.0)",
    )
    z.add_argument(
        "--scale-interval-s",
        type=float,
        default=None,  # None = inherit ADVSPEC_FLEET_SCALE_INTERVAL_S
        help="Autoscaler decision-tick period "
        "(ADVSPEC_FLEET_SCALE_INTERVAL_S, default 0.25)",
    )

    v = parser.add_argument_group("serve")
    v.add_argument(
        "--socket",
        default=None,  # None = inherit ADVSPEC_SERVE_SOCKET
        help="Unix socket path the serve daemon listens on (default "
        "./advspec-serve.sock; ADVSPEC_SERVE_SOCKET sets the process "
        "default). Transport: line-delimited JSON request/stream "
        "(docs/serving.md)",
    )
    v.add_argument(
        "--serve-queue-depth",
        type=int,
        default=None,  # None = inherit ADVSPEC_SERVE_QUEUE_DEPTH
        help="Per-tenant outstanding-debate cap: admissions past it "
        "shed with a typed queue_full refusal (default 8; "
        "ADVSPEC_SERVE_QUEUE_DEPTH sets the process default)",
    )
    v.add_argument(
        "--serve-backlog-tokens",
        type=int,
        default=None,  # None = inherit ADVSPEC_SERVE_BACKLOG_TOKENS
        help="Estimated-token-backlog cap: admissions that would cross "
        "it shed with a typed backlog refusal carrying retry_after_s "
        "(default 65536; ADVSPEC_SERVE_BACKLOG_TOKENS sets the process "
        "default). Brownout enters at 75%% of this cap",
    )
    v.add_argument(
        "--serve-quota-tokens",
        type=int,
        default=None,  # None = inherit ADVSPEC_SERVE_QUOTA_TOKENS
        help="Per-tenant token quota, debited with actual Usage tokens "
        "on completion and refillable via the refill op (0 = unlimited, "
        "the default; ADVSPEC_SERVE_QUOTA_TOKENS sets the process "
        "default)",
    )
    v.add_argument(
        "--serve-drain-deadline-s",
        type=float,
        default=None,  # None = inherit ADVSPEC_SERVE_DRAIN_DEADLINE_S
        help="Seconds SIGTERM waits for in-flight debates before "
        "shedding the queue (typed, journal-resumable) and cancelling "
        "running units (default 5; ADVSPEC_SERVE_DRAIN_DEADLINE_S sets "
        "the process default)",
    )
    v.add_argument(
        "--serve-ttft-slo-ms",
        type=float,
        default=None,  # None = inherit ADVSPEC_SERVE_TTFT_SLO_MS
        help="Interactive-tier TTFT SLO budget in milliseconds — the "
        "batch-preemption policy's trigger (preempt at half the "
        "budget; 0 = preempt the moment interactive work waits; "
        "ADVSPEC_SERVE_TTFT_SLO_MS sets the process default)",
    )
    v.add_argument(
        "--drain-report",
        default=None,
        help="Also write the SIGTERM drain report to this file "
        "(atomic tmp+rename; the report always prints to stdout)",
    )

    r = parser.add_argument_group("registry")
    r.add_argument("--checkpoint", help="HF checkpoint dir (registry add-model)")
    r.add_argument(
        "--family",
        choices=["llama", "mistral", "gemma2", "qwen2"],
        default="llama",
    )
    r.add_argument("--size", default="tiny", help="Named size config")
    r.add_argument("--tokenizer", default="", help="Tokenizer path")
    r.add_argument("--dtype", default=None, help="Param dtype (bfloat16)")
    r.add_argument("--tp", type=int, default=0, help="Tensor-parallel degree")
    r.add_argument(
        "--quant",
        choices=list(model_registry.QUANT_FORMATS),
        default="",
        help="Weight-only quantization for this model (int4 packs two "
        "weights per byte — docs/weight_residency.md)",
    )
    r.add_argument(
        "--kv",
        choices=["dense", "paged"],
        default="dense",
        help="KV-cache layout for decode",
    )
    r.add_argument(
        "--kv-dtype",
        choices=["", "int8"],
        default="",
        help="KV-cache storage dtype (int8 halves cache HBM)",
    )
    return parser


def parse_models(args: argparse.Namespace) -> list[str]:
    """Comma-separated ids, or the default opponent when unset.

    Parity: reference parse_models + default-model auto-detection
    (debate.py:553-611, providers.py:394-415) — here "available" means mock
    (always) plus any registry alias whose checkpoint resolves.
    """
    if args.models:
        return [m.strip() for m in args.models.split(",") if m.strip()]
    models = get_default_models()
    _err(f"no --models given; defaulting to {','.join(models)}")
    return models


def validate_models_before_run(models: list[str]) -> list[str]:
    """Collect actionable validation errors (exit code 2 when non-empty).

    Parity: reference validate_models_before_run (debate.py:976-1022) →
    credential preflight; here it is provider-prefix + registry/checkpoint
    validation via each engine's ``validate``.

    The port also reads each ``tpu://`` alias's ``tokenizer.json``, so
    one whose components the port's reader does not implement exits 2
    naming the component; and a ``tpu://`` id with no GPU present exits 2
    with the port's "no CUDA device is available" message. Every mesh
    alias runs its round, as in the reference (one whose tp does not
    divide the model's KV heads answers each opponent with the
    reference's ``ValueError``).
    """
    from adversarial_spec_tpu_torch.engine.tokenizer import load_tokenizer
    from adversarial_spec_tpu_torch.engine.tokenizer_json import (
        UnsupportedTokenizer,
    )

    errors = []
    reg = None
    for m in models:
        if m.startswith("tpu://"):
            if reg is None:
                reg = model_registry.load_registry()
            err = model_registry.validate_tpu_model(m, registry=reg)
            if err is None:
                try:
                    load_tokenizer(reg[model_registry.parse_tpu_model_id(m)].tokenizer)
                except UnsupportedTokenizer as e:
                    err = str(e)
                except Exception:
                    pass  # a missing or unreadable file: the engine reports it per model
            if err is None:
                try:
                    dispatch.get_engine(m)
                except (ValueError, RuntimeError) as e:
                    err = str(e)
        else:
            try:
                err = dispatch.get_engine(m).validate(m)
            except ValueError as e:
                err = str(e)
        if err:
            errors.append(f"{m}: {err}")
    return errors


def _read_spec_stdin() -> str:
    spec = sys.stdin.read().strip()
    if not spec:
        _err("error: no spec provided on stdin")
        raise SystemExit(EXIT_VALIDATION)
    return spec


def _env_request_deadline() -> float:
    try:
        return max(
            0.0, float(os.environ.get("ADVSPEC_REQUEST_DEADLINE_S", "0") or "0")
        )
    except ValueError:
        return 0.0


def _sampling_from_args(args: argparse.Namespace) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=args.max_new_tokens or 1024,
        temperature=0.7 if args.temperature is None else args.temperature,
        greedy=bool(args.greedy),
        seed=args.seed,
        timeout_s=max(0.0, float(600.0 if args.timeout is None else args.timeout)),
        # Flag-else-env-default each invocation, like the obs knobs.
        request_deadline_s=max(
            0.0,
            float(
                _env_request_deadline()
                if getattr(args, "request_deadline_s", None) is None
                else args.request_deadline_s
            ),
        ),
    )


def load_or_resume_session(
    args: argparse.Namespace,
) -> tuple[str, SessionState | None]:
    """Returns (spec, session_state). Resume restores args wholesale
    (parity: reference debate.py:739-795)."""
    if args.resume:
        state = SessionState.load(args.resume)
        args.round = state.round
        args.doc_type = state.doc_type
        if state.models:
            args.models = ",".join(state.models)
        args.focus = state.focus
        args.persona = state.persona
        args.preserve_intent = state.preserve_intent
        args.session = state.session_id
        return state.spec, state
    spec = _read_spec_stdin()
    if args.session:
        state = SessionState(
            session_id=args.session,
            spec=spec,
            round=args.round,
            doc_type=args.doc_type or "generic",
        )
        return spec, state
    return spec, None


def _configure_resilience(args: argparse.Namespace):
    """Arm chaos injection and tune the breaker registry from flags.

    Returns the breaker registry so the report can snapshot its states.
    """
    from adversarial_spec_tpu_torch.resilience import breaker, faults, injector

    if args.chaos:
        injector.install(
            injector.FaultInjector(
                injector.parse_chaos_spec(args.chaos), seed=args.chaos_seed
            )
        )
        _err(f"chaos armed: {args.chaos}")
    else:
        # Materialize (and thereby validate) any ADVSPEC_CHAOS env spec
        # NOW: a typo'd spec must fail loudly at startup, not surface as
        # a swallowed per-model BUG when the first seam hook fires.
        injector.active()
    breakers = breaker.default_registry()
    breakers.configure(
        threshold=args.breaker_threshold,
        cooldown_s=args.breaker_cooldown,
        enabled=not args.no_breaker,
    )
    faults.reset()  # per-round counts in the report
    return breakers


def _configure_prefix_cache(args: argparse.Namespace):
    """Arm the prefix cache from flags; returns the module for reporting.

    One CLI invocation is one round: stats reset here so the JSON
    ``perf.prefix_cache`` block accounts exactly this round's prefills,
    while the cache CONTENT itself persists wherever the engine lives.
    """
    from adversarial_spec_tpu_torch.engine import prefix_cache

    prefix_cache.configure(
        enabled=args.prefix_cache, max_pages=args.prefix_cache_pages
    )
    prefix_cache.reset_stats()
    return prefix_cache


def _configure_interleave(args: argparse.Namespace):
    """Arm the fused/pipelined drive loop from flags; returns the module
    for reporting. Stats reset per invocation (one invocation = one
    round) so ``perf.interleave`` accounts exactly this round's steps;
    the batcher itself persists on the engine across rounds."""
    from adversarial_spec_tpu_torch.engine import interleave

    interleave.configure(enabled=args.interleave)
    interleave.reset_stats()
    return interleave


def _configure_kv_tier(args: argparse.Namespace):
    """Arm the tiered KV cache from flags; returns the module for
    reporting. Flag-else-env-default each invocation (one invocation =
    one round), like obs/spec: one round's --no-kv-tier or store dir
    must not leak into the next. Stats reset per invocation so
    ``perf.kv_tier`` accounts exactly this round's swaps; the tiers
    themselves live on the engine's persistent batcher (rebuilt when
    these knobs change — the batcher key covers them)."""
    from adversarial_spec_tpu_torch.engine import kvtier

    kvtier.configure(
        enabled=(
            args.kv_tier if args.kv_tier is not None else kvtier.env_enabled()
        ),
        host_mb=(
            args.kv_host_mb
            if args.kv_host_mb is not None
            else kvtier.env_host_mb()
        ),
        store_dir=(
            args.kv_store_dir
            if args.kv_store_dir is not None
            else kvtier.env_store_dir()
        ),
        flush_blocks=(
            args.kv_flush_blocks
            if args.kv_flush_blocks is not None
            else kvtier.env_flush_blocks()
        ),
    )
    kvtier.reset_stats()
    return kvtier


def _configure_weightres(args: argparse.Namespace):
    """Arm weight-residency paging from flags; returns the module for
    reporting. Flag-else-env-default each invocation (one invocation =
    one round): one round's --no-weight-res or host budget must not leak
    into the next. Stats reset per invocation so ``perf.weights``
    accounts exactly this round's loads and swaps; the ledger itself
    lives on the engine and persists round to round."""
    from adversarial_spec_tpu_torch.engine import weightres

    weightres.configure(
        enabled=(
            args.weight_res
            if args.weight_res is not None
            else weightres.env_enabled()
        ),
        host_mb=(
            args.weight_host_mb
            if args.weight_host_mb is not None
            else weightres.env_host_mb()
        ),
    )
    weightres.reset_stats()
    return weightres


def _configure_fleet(args: argparse.Namespace):
    """Arm the fleet layer from flags; returns the module for
    reporting. Flag-else-env-default each invocation (one invocation =
    one round), like obs/kvtier: one round's --fleet must not leak
    into the next. Stats reset per invocation so ``perf.fleet``
    accounts exactly this round's routing; the replicas themselves
    persist on the process fleet engine (rebuilt when the topology
    knobs change — fleet.fleet_engine keys on them)."""
    from adversarial_spec_tpu_torch import fleet

    fleet.configure(
        enabled=(
            args.fleet if args.fleet is not None else fleet.env_enabled()
        ),
        replicas=(
            args.fleet_replicas
            if args.fleet_replicas is not None
            else fleet.env_replicas()
        ),
        transport=(
            args.fleet_transport
            if args.fleet_transport is not None
            else fleet.env_transport()
        ),
        autoscale=(
            args.fleet_autoscale
            if getattr(args, "fleet_autoscale", None) is not None
            else fleet.env_autoscale()
        ),
        min_replicas=(
            args.fleet_min
            if getattr(args, "fleet_min", None) is not None
            else fleet.env_min_replicas()
        ),
        max_replicas=(
            args.fleet_max
            if getattr(args, "fleet_max", None) is not None
            else fleet.env_max_replicas()
        ),
        scale_cooldown_s=(
            args.scale_cooldown_s
            if getattr(args, "scale_cooldown_s", None) is not None
            else fleet.env_scale_cooldown_s()
        ),
        scale_interval_s=(
            args.scale_interval_s
            if getattr(args, "scale_interval_s", None) is not None
            else fleet.env_scale_interval_s()
        ),
        prefill_replicas=(
            args.fleet_prefill_replicas
            if getattr(args, "fleet_prefill_replicas", None) is not None
            else fleet.env_prefill_replicas()
        ),
        handoff_threshold_tokens=fleet.env_handoff_threshold_tokens(),
    )
    fleet.reset_stats()
    return fleet


def _configure_speculative(args: argparse.Namespace):
    """Apply speculation flags to the process config (one CLI invocation
    is one round) so ``perf.spec`` accounts exactly this round's verify
    steps; the engine's persistent batcher re-resolves the config at the
    next drain. Flag-else-env-default each invocation, like obs: one
    round's --no-speculative/--gamma must not leak into the next."""
    from adversarial_spec_tpu_torch.engine import spec

    spec.configure(
        enabled=(
            args.speculative
            if args.speculative is not None
            else spec.env_enabled()
        ),
        gamma=args.gamma if args.gamma is not None else spec.env_gamma(),
    )
    spec.reset_stats()
    return spec


def _configure_streaming(args: argparse.Namespace):
    """Arm token streaming + early cancellation from flags; returns the
    module for reporting. Flag-else-env-default each invocation (one
    invocation = one round), like obs/spec: one round's --no-stream or
    --no-early-cancel must not leak into the next. Stats reset per
    invocation so ``perf.stream`` accounts exactly this round's
    deliveries and cancels."""
    from adversarial_spec_tpu_torch.engine import streaming

    streaming.configure(
        enabled=(
            args.stream if args.stream is not None else streaming.env_enabled()
        ),
        early_cancel=(
            args.early_cancel
            if args.early_cancel is not None
            else streaming.env_early_cancel()
        ),
    )
    streaming.reset_stats()
    return streaming


def _configure_obs(args: argparse.Namespace):
    """Arm the observability subsystem from flags; returns the module
    for reporting. One CLI invocation is one round: metrics zero, the
    flight-recorder ring clears, and the retrace watch starts fresh, so
    ``perf.obs`` / ``--metrics-out`` / ``--events-out`` account exactly
    this round."""
    from adversarial_spec_tpu_torch import obs

    # Every knob re-resolves to flag-else-env-default each invocation:
    # one invocation's --no-obs / --flight-recorder-size / --events-out
    # must not leak into the next round's (one process can run several
    # invocations — tests, library callers).
    obs.configure(
        enabled=args.obs if args.obs is not None else obs.env_enabled(),
        recorder_size=(
            args.flight_recorder_size
            if args.flight_recorder_size is not None
            else obs.env_recorder_size()
        ),
        events_out=args.events_out or "",
        slo_ttft_ms=(
            args.slo_ttft_ms
            if getattr(args, "slo_ttft_ms", None) is not None
            else obs.env_slo_ttft_ms()
        ),
        slo_round_s=(
            args.slo_round_s
            if getattr(args, "slo_round_s", None) is not None
            else obs.env_slo_round_s()
        ),
    )
    obs.reset_stats()
    return obs


def _unported_knobs(args: argparse.Namespace) -> list[str]:
    """The knobs of unported subsystems this invocation sets, by flag or
    env var (``main`` exits 2 on any): a pipeline depth other than 1."""
    from adversarial_spec_tpu_torch.engine import interleave

    depth = (
        interleave.env_pipeline_depth()
        if args.pipeline_depth is None
        else interleave.clamp_depth(args.pipeline_depth)
    )
    if depth != interleave.SERVED_PIPELINE_DEPTH:
        return [f"pipeline depth {depth} (--pipeline-depth, ADVSPEC_PIPELINE_DEPTH)"]
    return []


def handle_serve(args: argparse.Namespace) -> int:
    """``serve`` — the persistent multi-debate daemon
    (adversarial_spec_tpu_torch/serve). Unlike every other action, this
    one configures the process-wide subsystems ONCE and then serves until
    drained: the per-invocation reset cascade must never run mid-serve
    (concurrent debates would lose their counters and trace scopes)."""
    from adversarial_spec_tpu_torch import serve as serve_mod
    from adversarial_spec_tpu_torch.serve.daemon import run_daemon

    # One-time arming of the same knobs a critique round would arm.
    _configure_resilience(args)
    _configure_prefix_cache(args)
    _configure_interleave(args)
    _configure_speculative(args)
    _configure_kv_tier(args)
    _configure_weightres(args)
    _configure_streaming(args)
    _configure_fleet(args)
    _configure_obs(args)
    serve_mod.configure(
        max_queue_depth=(
            args.serve_queue_depth
            if args.serve_queue_depth is not None
            else serve_mod.env_queue_depth()
        ),
        max_backlog_tokens=(
            args.serve_backlog_tokens
            if args.serve_backlog_tokens is not None
            else serve_mod.env_backlog_tokens()
        ),
        tenant_quota_tokens=(
            args.serve_quota_tokens
            if args.serve_quota_tokens is not None
            else serve_mod.env_quota_tokens()
        ),
        drain_deadline_s=(
            args.serve_drain_deadline_s
            if args.serve_drain_deadline_s is not None
            else serve_mod.env_drain_deadline_s()
        ),
        interactive_ttft_slo_ms=(
            args.serve_ttft_slo_ms
            if args.serve_ttft_slo_ms is not None
            else serve_mod.env_ttft_slo_ms()
        ),
    )
    serve_mod.reset_stats()
    socket_path = (
        args.socket
        or os.environ.get("ADVSPEC_SERVE_SOCKET")
        or "./advspec-serve.sock"
    )
    cfg = serve_mod.config()
    _err(
        f"advspec serve: listening on {socket_path} "
        f"(queue depth {cfg.max_queue_depth}/tenant, backlog cap "
        f"{cfg.max_backlog_tokens} tokens, drain deadline "
        f"{cfg.drain_deadline_s}s); SIGTERM drains gracefully"
    )
    return run_daemon(socket_path, drain_report_path=args.drain_report)


def run_critique(args: argparse.Namespace) -> int:
    from adversarial_spec_tpu_torch.utils.tracing import Tracer, maybe_profile

    tracer = Tracer()
    breakers = _configure_resilience(args)
    prefix_cache = _configure_prefix_cache(args)
    interleave = _configure_interleave(args)
    spec_cfg = _configure_speculative(args)
    kv_tier = _configure_kv_tier(args)
    streaming = _configure_streaming(args)
    fleet = _configure_fleet(args)
    obs = _configure_obs(args)
    spec, session_state = load_or_resume_session(args)
    if session_state is not None and session_state.breakers:
        # One CLI invocation = one round: open circuits from earlier
        # rounds of this session must survive the process boundary.
        breakers.restore(session_state.breakers)
    models = parse_models(args)
    weightres = _configure_weightres(args)
    with tracer.span("validate"):
        errors = validate_models_before_run(models)
    if errors:
        for e in errors:
            _err(f"validation error: {e}")
        return EXIT_VALIDATION

    cfg = RoundConfig(
        doc_type=args.doc_type or "generic",
        focus=args.focus,
        persona=args.persona,
        preserve_intent=args.preserve_intent,
        press=args.press,
        context_files=args.context or [],
        sampling=_sampling_from_args(args),
        # Fleet placement identity: one key per SESSION, so every
        # round of a session's debate lands on the replica holding its
        # prefix KV (sessionless rounds fall back to the spec hash in
        # run_round).
        debate_id=(
            session_state.session_id if session_state is not None else ""
        ),
    )
    journal = None
    if session_state is not None:
        # Durability first (docs/resilience.md "Durability and
        # recovery"): persist the session BEFORE the round runs — a
        # crash mid-round must leave a resumable session file carrying
        # the spec and round the crashed process was serving (the
        # post-round save below then advances it). The journal rides
        # the same sessions dir; flag-else-env-default per invocation.
        use_journal = (
            args.journal
            if getattr(args, "journal", None) is not None
            else journal_mod.env_enabled()
        )
        session_state.models = models
        session_state.save()
        if use_journal:
            journal = journal_mod.RoundJournal(session_state.session_id)
            cfg.journal = journal
    _err(
        f"Round {args.round}: querying {len(models)} model(s): "
        + ", ".join(models)
    )
    with tracer.span("round"), maybe_profile(args.profile_dir):
        result = run_round(spec, models, round_num=args.round, cfg=cfg)

    for r in result.failed:
        _err(f"warning: {r.model} failed: {r.error}")

    tracker = CostTracker()
    for r in result.responses:
        tracker.add(r.model, r.usage)
    tracer.count("decode_tokens", result.total_usage.decode_tokens)
    tracer.spans["decode"] = result.total_usage.decode_time_s
    # Resilience telemetry: classified fault counts + breaker transitions
    # become tracer counters; the full snapshot rides on the JSON report.
    from adversarial_spec_tpu_torch.resilience import faults as faults_mod

    fault_counts = faults_mod.snapshot()
    tracer.count_many({f"fault.{k}": v for k, v in fault_counts.items()})
    tracer.count_many(breakers.counters())
    # Prefix-cache telemetry: hit/miss/evict/tokens-saved counters ride
    # the tracer (and the full snapshot lands on perf.prefix_cache).
    prefix_snap = prefix_cache.snapshot()
    tracer.count_many(
        {
            f"prefix_cache.{k}": float(v)
            for k, v in prefix_snap.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
    )
    # Per-opponent spans from the debate layer graft under "debate/" —
    # one report carries both layers' phase breakdowns (span_tree).
    tracer.merge(result.tracer, prefix="debate")
    perf = tracer.report()
    perf["decode_tokens_per_sec"] = round(tracer.rate("decode_tokens", "decode"), 1)
    perf["resilience"] = {
        "faults": fault_counts,
        "breakers": breakers.states(),
    }
    perf["prefix_cache"] = prefix_snap
    # Fused-step / pipeline telemetry: how much admission prefill hid
    # under resident decode vs genuinely stalled the batch (their sum IS
    # the round's prefill_time_s), plus step/sync counts.
    perf["interleave"] = interleave.snapshot()
    # Speculation telemetry: verify steps, acceptance rate, tokens/step,
    # rollback pages, draft/verify wall split (engine/spec.py).
    perf["spec"] = spec_cfg.snapshot()
    # Tiered-KV telemetry: demotions, promotions, rehydrations, swap
    # walls and hit rates (engine/kvtier.py).
    perf["kv_tier"] = kv_tier.snapshot()
    # Weight-residency telemetry: loads vs promotions (the reload the
    # host tier avoided), demote/promote walls, swap-overlap fraction,
    # coalesced groups/units (engine/weightres.py).
    perf["weights"] = weightres.snapshot()
    # Streaming telemetry: requests streamed, deliveries, cancels, and
    # the decode tokens early cancellation saved (engine/streaming.py).
    perf["stream"] = streaming.snapshot()
    # Fleet telemetry: routed/affinity-hit/failover counts, replica
    # lifecycle, reissued work across replica deaths (fleet/router.py).
    perf["fleet"] = fleet.snapshot()
    # Observability report: flight-recorder occupancy, event mix, host
    # syncs by reason, retrace watch (unexpected recompiles flagged).
    perf["obs"] = obs.snapshot()
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        _err(f"metrics written to {args.metrics_out}")
    if args.events_out:
        n = obs.dump_events(args.events_out)
        _err(f"{n} flight-recorder event(s) written to {args.events_out}")
    if perf["obs"]["retrace"]["unexpected_recompiles"]:
        _err(
            "warning: "
            f"{perf['obs']['retrace']['unexpected_recompiles']} unexpected "
            "jit recompile(s) detected — see perf.obs.retrace in --json"
        )
    if perf["obs"]["slo"]["breaches"]:
        breaches = perf["obs"]["slo"]["breaches"]
        where = (
            "trace-scoped flight-recorder capture(s) written next to "
            "--events-out (see tools/trace_view.py)"
            if args.events_out
            # No armed destination = counted but not captured; don't
            # send the operator hunting for files that don't exist.
            else "pass --events-out to capture trace-scoped dumps"
        )
        _err(
            "warning: SLO breach(es) "
            + ", ".join(f"{k}={v}" for k, v in breaches.items())
            + " — "
            + where
        )
    _err(
        f"perf: round {perf['spans'].get('round', 0):.2f}s, "
        f"decode {perf['decode_tokens_per_sec']} tok/s"
    )
    if prefix_snap["enabled"] and prefix_snap["lookups"]:
        _err(
            f"prefix cache: {prefix_snap['hits']}/{prefix_snap['lookups']} "
            f"hits, {prefix_snap['saved_tokens']} prefill tokens saved"
        )
    stream_snap = perf["stream"]
    if stream_snap["cancels"]:
        _err(
            f"early cancel: {stream_snap['cancels']} request(s) stopped "
            f"at their verdict marker, {stream_snap['tokens_saved']} "
            "decode token(s) saved"
        )
    fleet_snap = perf["fleet"]
    if fleet_snap["enabled"] and fleet_snap["routed_requests"]:
        _err(
            f"fleet: {fleet_snap['routed_requests']} request(s) routed "
            f"across {fleet_snap['replicas']} replica(s), affinity hit "
            f"rate {fleet_snap['affinity_hit_rate']:.0%}"
            + (
                f", {fleet_snap['reissued_requests']} reissued after "
                "replica loss"
                if fleet_snap["reissued_requests"]
                else ""
            )
        )
    tier_snap = perf["kv_tier"]
    if tier_snap["enabled"] and (
        tier_snap["promoted_tokens"] or tier_snap["rehydrated_tokens"]
    ):
        _err(
            f"kv tier: {tier_snap['promoted_tokens']} tokens promoted "
            f"from host RAM, {tier_snap['rehydrated_tokens']} rehydrated "
            "from the disk store"
        )
    if fault_counts:
        total_faults = sum(fault_counts.values())
        _err(
            f"resilience: {total_faults} fault(s) classified and "
            "contained; see the --json resilience section"
        )

    # The revised spec for the next round: last successful revision wins
    # (the L5 agent synthesizes across critiques; this is the raw material).
    revised = next(
        (r.revised_spec for r in reversed(result.successful) if r.revised_spec),
        None,
    )

    if session_state is not None:
        save_checkpoint(spec, args.round, session_state.session_id)
        session_state.spec = revised or spec
        session_state.round = args.round + 1
        session_state.models = models
        session_state.focus = args.focus
        session_state.persona = args.persona
        session_state.preserve_intent = args.preserve_intent
        session_state.history.append(
            {
                "round": args.round,
                "all_agreed": result.all_agreed,
                "models": {r.model: r.agreed for r in result.successful},
            }
        )
        session_state.breakers = breakers.snapshot_for_resume()
        session_state.save()
        if journal is not None:
            # Round-commit AFTER the advanced session state is durable:
            # a crash in the gap replays a committed round, which is
            # deterministic and therefore harmless; the reverse order
            # could lose the round.
            try:
                journal.log_round_commit(args.round, result.all_agreed)
            except Exception as e:
                _err(f"warning: round-journal commit failed: {e}")

    served = int(result.tracer.counters.get("journal.served", 0))
    if served:
        _err(
            f"recovery: {served} opponent(s) served from the round "
            "journal (no engine work re-paid)"
        )

    user_feedback = None
    if args.notify:
        user_feedback = _telegram_notify(args, result, tracker)

    output_results(
        args, result, models, tracker, session_state, user_feedback, perf
    )
    return EXIT_OK


def _telegram_notify(args, result, tracker) -> str | None:
    from adversarial_spec_tpu_torch.debate import telegram

    config = telegram.get_config()
    if config is None:
        _err(
            "warning: Telegram not configured "
            "(set TELEGRAM_BOT_TOKEN and TELEGRAM_CHAT_ID); skipping notify"
        )
        return None
    try:
        return telegram.notify_round(
            config,
            result,
            total_cost=tracker.total_cost,
            feedback_timeout=args.feedback_timeout,
        )
    except Exception as e:  # notify must never kill the round
        _err(f"warning: Telegram notify failed: {e}")
        return None


def output_results(
    args: argparse.Namespace,
    result,
    models: list[str],
    tracker: CostTracker,
    session_state: SessionState | None,
    user_feedback: str | None = None,
    perf: dict | None = None,
) -> None:
    """Emit round results. JSON schema parity: reference debate.py:909-941."""
    if args.json:
        out = {
            "all_agreed": result.all_agreed,
            "round": args.round,
            "doc_type": args.doc_type or "generic",
            # The round's causal trace id: every flight-recorder event
            # this round caused carries it (tools/trace_view.py joins
            # the events JSONL back to this report on it).
            "trace_id": getattr(result, "trace_id", ""),
            "models": models,
            "focus": args.focus,
            "persona": args.persona,
            "preserve_intent": bool(args.preserve_intent),
            "session": session_state.session_id if session_state else args.session,
            "results": [
                {
                    "model": r.model,
                    "agreed": r.agreed,
                    "response": r.critique,
                    "spec": r.revised_spec,
                    "error": r.error,
                    "span_id": r.span_id,
                    "input_tokens": r.usage.input_tokens,
                    "output_tokens": r.usage.output_tokens,
                    "cached_tokens": r.usage.cached_tokens,
                    "prefill_time_s": round(r.usage.prefill_time_s, 4),
                    "decode_time_s": round(r.usage.decode_time_s, 4),
                    "cost": round(r.usage.cost_for(r.model), 6),
                }
                for r in result.responses
            ],
            "cost": tracker.report(),
        }
        if perf is not None:
            out["perf"] = perf
        if user_feedback:
            out["user_feedback"] = user_feedback
        print(json.dumps(out, indent=2))
        return

    doc_name = prompts.get_doc_type_name(args.doc_type or "generic")
    print(f"\n=== Round {args.round} Results ({doc_name}) ===\n")
    for r in result.responses:
        print(f"--- {r.model} ---")
        if r.error:
            print(f"ERROR: {r.error}")
        elif r.agreed:
            print("[AGREE]")
        else:
            print(r.critique)
        print()
    if result.all_agreed:
        print("=== ALL MODELS AGREE ===")
    else:
        agreed = [r.model for r in result.successful if r.agreed]
        disagreed = [r.model for r in result.successful if not r.agreed]
        if agreed:
            print(f"Agreed: {', '.join(agreed)}")
        if disagreed:
            print(f"Critiqued: {', '.join(disagreed)}")
    if user_feedback:
        print("\n=== User Feedback ===")
        print(user_feedback)
    if args.show_cost:
        print()
        print(tracker.format_text())


def handle_export_tasks(args: argparse.Namespace) -> int:
    """Spec → structured task list via the first model.

    Parity: reference handle_export_tasks (debate.py:688-736) — stdin spec,
    EXPORT_TASKS_PROMPT, low temperature, ``extract_tasks``, ``--json``.
    """
    _configure_prefix_cache(args)
    _configure_interleave(args)
    _configure_speculative(args)
    _configure_kv_tier(args)
    _configure_streaming(args)
    obs = _configure_obs(args)
    spec = _read_spec_stdin()
    models = parse_models(args)
    _configure_weightres(args)
    errors = validate_models_before_run(models[:1])
    if errors:
        for e in errors:
            _err(f"validation error: {e}")
        return EXIT_VALIDATION
    model = models[0]
    req = ChatRequest(
        model=model, system="", user=prompts.EXPORT_TASKS_PROMPT.format(spec=spec)
    )
    params = SamplingParams(
        max_new_tokens=args.max_new_tokens or 2048,
        temperature=0.3 if args.temperature is None else args.temperature,
        seed=args.seed,
    )
    comp = dispatch.get_engine(model).chat([req], params)[0]
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
    if args.events_out:
        obs.dump_events(args.events_out)
    if not comp.ok:
        _err(f"error: {model} failed: {comp.error}")
        return EXIT_ERROR
    tasks = extract_tasks(comp.text)
    if args.json:
        print(json.dumps([t.to_dict() for t in tasks], indent=2))
    else:
        if not tasks:
            print("No [TASK] blocks found in model response.")
        for i, t in enumerate(tasks, 1):
            print(f"{i}. [{t.priority}] {t.title}")
            if t.description:
                print(f"   {t.description}")
            if t.dependencies:
                print(f"   depends on: {', '.join(t.dependencies)}")
            if t.estimate:
                print(f"   estimate: {t.estimate}")
    return EXIT_OK


def handle_diff(args: argparse.Namespace) -> int:
    if not args.previous or not args.current:
        _err("error: diff requires --previous and --current spec files")
        return EXIT_VALIDATION
    try:
        old = open(args.previous).read()
        new = open(args.current).read()
    except OSError as e:
        _err(f"error: {e}")
        return EXIT_VALIDATION
    diff = generate_diff(old, new)
    print(diff if diff else "No differences.")
    return EXIT_OK


def handle_providers(args: argparse.Namespace) -> int:
    """List servable models: mock behaviors + registry entries + devices.

    Parity: reference ``providers`` action (providers.py:247-333) listing
    providers with availability; here availability = checkpoint resolves.
    """
    reg = model_registry.load_registry()
    entries = []
    for alias, spec in sorted(reg.items()):
        err = model_registry.validate_tpu_model(f"tpu://{alias}", registry=reg)
        entries.append(
            {
                "model": f"tpu://{alias}",
                "family": spec.family,
                "size": spec.size,
                "checkpoint": spec.checkpoint,
                "available": err is None,
                "error": err,
            }
        )
    mock_models = [
        {"model": "mock://agree", "available": True},
        {"model": "mock://critic", "available": True},
        {"model": "mock://critic?agree_after=N", "available": True},
    ]
    if args.json:
        print(
            json.dumps(
                {"tpu": entries, "mock": mock_models, "devices": _device_info()},
                indent=2,
            )
        )
        return EXIT_OK
    print("TPU models (local registry):")
    for e in entries:
        status = "ok" if e["available"] else f"UNAVAILABLE: {e['error']}"
        print(f"  {e['model']:28s} {e['family']:8s} {e['size']:5s} [{status}]")
    print("Mock models (always available):")
    for e in mock_models:
        print(f"  {e['model']}")
    return EXIT_OK


def _device_info() -> dict:
    """The GPU the port would serve on (``torch.cuda``; the reference
    reads ``jax.devices()``)."""
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out = {"platform": "gpu" if n else "none", "device_count": n}
        if n:
            out["kind"] = torch.cuda.get_device_name(0)
        return out
    except Exception as e:
        return {"platform": "unavailable", "error": str(e)}


def handle_registry(args: argparse.Namespace, rest: list[str]) -> int:
    """Local model registry management — the Bedrock-mode analog.

    Subcommands mirror reference handle_bedrock_command
    (providers.py:489-656): status / list-models / add-model / remove-model.
    """
    sub = rest[0] if rest else "status"
    if sub in ("status", "list-models"):
        reg = model_registry.load_registry()
        if args.json:
            print(json.dumps({a: s.to_dict() for a, s in sorted(reg.items())}, indent=2))
        else:
            print(f"Registry: {model_registry.REGISTRY_PATH}")
            for alias, spec in sorted(reg.items()):
                print(
                    f"  {alias:24s} family={spec.family:8s} size={spec.size:5s} "
                    f"checkpoint={spec.checkpoint}"
                )
        return EXIT_OK
    if sub == "add-model":
        if len(rest) < 2:
            _err("usage: debate registry add-model <alias> --checkpoint DIR")
            return EXIT_VALIDATION
        alias = rest[1]
        spec = model_registry.ModelSpec(
            alias=alias,
            family=args.family,
            checkpoint=args.checkpoint or "random",
            tokenizer=args.tokenizer,
            size=args.size,
            dtype=args.dtype or "bfloat16",
            mesh={"tp": args.tp} if args.tp else {},
            quant=args.quant,
            kv=args.kv,
            kv_dtype=args.kv_dtype,
        )
        model_registry.save_registry_entry(spec)
        print(f"registered tpu://{alias}")
        return EXIT_OK
    if sub == "remove-model":
        if len(rest) < 2:
            _err("usage: debate registry remove-model <alias>")
            return EXIT_VALIDATION
        if model_registry.remove_registry_entry(rest[1]):
            print(f"removed {rest[1]}")
            return EXIT_OK
        _err(f"error: no registry entry named {rest[1]}")
        return EXIT_VALIDATION
    if sub == "alias":
        # Friendly-name aliasing (parity: reference bedrock `alias`
        # subcommand, providers.py:489-656). Snapshot semantics: the new
        # alias is an independent COPY of the existing entry's
        # configuration at this moment — later edits to the source do not
        # follow.
        if len(rest) < 3:
            _err("usage: debate registry alias <new-alias> <existing-alias>")
            return EXIT_VALIDATION
        new_alias, existing = rest[1], rest[2]
        reg = model_registry.load_registry()
        if existing not in reg:
            _err(f"error: no registry entry named {existing}")
            return EXIT_VALIDATION
        if new_alias in reg:
            # Guard against swapped arguments silently destroying an
            # existing model's configuration.
            _err(
                f"error: {new_alias} already exists; remove it first with "
                f"'registry remove-model {new_alias}'"
            )
            return EXIT_VALIDATION
        import dataclasses

        model_registry.save_registry_entry(
            dataclasses.replace(reg[existing], alias=new_alias)
        )
        print(
            f"registered tpu://{new_alias} as a copy of {existing}'s "
            "current configuration"
        )
        return EXIT_OK
    _err(f"error: unknown registry subcommand {sub!r}")
    return EXIT_VALIDATION


def handle_send_final(args: argparse.Namespace) -> int:
    """Send the final document to the configured Telegram chat.

    Parity: reference handle_send_final (debate.py:670-685).
    """
    from adversarial_spec_tpu_torch.debate import telegram

    doc = _read_spec_stdin()
    config = telegram.get_config()
    if config is None:
        _err("error: Telegram not configured (TELEGRAM_BOT_TOKEN/CHAT_ID)")
        return EXIT_VALIDATION
    telegram.send_long_message(config, "FINAL DOCUMENT\n\n" + doc)
    print("Final document sent.")
    return EXIT_OK


def handle_info_command(args: argparse.Namespace) -> int | None:
    if args.action == "focus-areas":
        payload = {
            k: v.strip().splitlines()[0] for k, v in prompts.FOCUS_AREAS.items()
        }
        if args.json:
            print(json.dumps(payload, indent=2))
        else:
            for k, first_line in payload.items():
                print(f"{k}: {first_line}")
        return EXIT_OK
    if args.action == "personas":
        if args.json:
            print(json.dumps(prompts.PERSONAS, indent=2))
        else:
            for k, v in prompts.PERSONAS.items():
                print(f"{k}: {v[:88]}...")
        return EXIT_OK
    if args.action == "profiles":
        profs = list_profiles()
        if args.json:
            print(json.dumps(profs, indent=2))
        elif not profs:
            print("No saved profiles.")
        else:
            for name, settings in profs.items():
                print(f"{name}: {json.dumps(settings)}")
        return EXIT_OK
    if args.action == "sessions":
        sessions = SessionState.list_sessions()
        if args.json:
            print(json.dumps(sessions, indent=2))
        elif not sessions:
            print("No saved sessions.")
        else:
            for s in sessions:
                print(
                    f"{s['session_id']}: round {s['round']}, "
                    f"{s['doc_type']}, models={','.join(s['models'])}"
                )
        return EXIT_OK
    if args.action == "providers":
        return handle_providers(args)
    return None


def handle_save_profile(args: argparse.Namespace) -> int:
    if not args.name:
        _err("error: save-profile requires --name")
        return EXIT_VALIDATION
    settings = {}
    if args.models:
        settings["models"] = [m.strip() for m in args.models.split(",")]
    if args.doc_type:
        settings["doc_type"] = args.doc_type
    if args.focus:
        settings["focus"] = args.focus
    if args.persona:
        settings["persona"] = args.persona
    if args.preserve_intent:
        settings["preserve_intent"] = True
    if args.max_new_tokens:
        settings["max_new_tokens"] = args.max_new_tokens
    if args.temperature is not None:
        settings["temperature"] = args.temperature
    save_profile(args.name, settings)
    print(f"Profile '{args.name}' saved.")
    return EXIT_OK


def main(argv: list[str] | None = None) -> int:
    parser = create_parser()
    args, rest = parser.parse_known_args(argv)

    try:
        if args.profile and args.action in ("critique", "export-tasks"):
            profile = load_profile(args.profile)
            # Profile "models" come back as a list; args wants a CSV string.
            if "models" in profile and not args.models:
                args.models = ",".join(profile.pop("models"))
            applied = apply_profile(args, profile)
            if applied:
                _err(f"profile '{args.profile}' applied: {', '.join(applied)}")

        info = handle_info_command(args)
        if info is not None:
            return info
        if args.action in ("critique", "export-tasks", "serve"):
            refused = _unported_knobs(args)
            if refused:
                for knob in refused:
                    _err(
                        f"error: {knob} is not yet ported to the "
                        "PyTorch/CUDA package"
                    )
                return EXIT_VALIDATION
        if args.action == "critique":
            return run_critique(args)
        if args.action == "serve":
            return handle_serve(args)
        if args.action == "export-tasks":
            return handle_export_tasks(args)
        if args.action == "diff":
            return handle_diff(args)
        if args.action == "registry":
            return handle_registry(args, rest)
        if args.action == "send-final":
            return handle_send_final(args)
        if args.action == "save-profile":
            return handle_save_profile(args)
        _err(f"error: unhandled action {args.action}")
        return EXIT_ERROR
    except SystemExit as e:
        return int(e.code or 0)
    except (FileNotFoundError, InvalidSessionId, CorruptSessionState) as e:
        _err(f"error: {e}")
        return EXIT_VALIDATION
    except Exception as e:
        _err(f"error: {type(e).__name__}: {e}")
        return EXIT_ERROR


if __name__ == "__main__":
    sys.exit(main())
