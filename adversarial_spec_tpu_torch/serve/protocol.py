"""Serve-daemon wire protocol: line-delimited JSON over a local socket.

Every message is ONE JSON object on ONE line (the journal's and fleet
worker's framing — a torn line is confined to itself). Clients write
request lines; the daemon answers each with one or more event lines
tagged with the request's client-assigned ``id``, terminating in
exactly one TERMINAL event. Requests may pipeline freely on one
connection (the overload drill's open-loop storm writes its whole
burst before reading a byte).

Request ops (``REQUEST_FIELDS`` is the schema contract, validated by
``validate_request`` before anything touches the scheduler):

- ``debate`` — run one critique round: tenant, tier, spec, models,
  round, optional session (arms the crash-safe round journal: a
  drain-interrupted debate is resumable by resubmitting the same
  session+spec+round), optional per-request stream flag and sampling
  overrides.
- ``ping`` / ``stats`` / ``check`` — liveness, the ``perf.serve``-
  shaped counters + scheduler state, and engine allocator/tier
  invariants (the chaos drill's clean-survivor probe).
- ``refill`` — add tokens to a tenant's quota (the admission ledger).
- ``drain`` — begin the graceful drain (the SIGTERM path, reachable
  over the wire for harnesses that cannot signal).

Response events (``RESPONSE_EVENTS``): ``accepted`` (admission took
the debate; carries the daemon-assigned debate id), ``shed`` (typed
refusal: a ``SHED_REASONS`` member + ``retry_after_s`` — the
load-shed contract: a storm is answered, never absorbed), ``stream``
(one opponent's text-so-far, when streaming was requested),
``result`` (terminal: the round payload), ``error`` (terminal:
malformed request), ``pong`` / ``stats`` / ``check`` / ``ok``
(terminal acks), ``draining`` (broadcast when drain begins).
"""

from __future__ import annotations

import json

PROTOCOL_VERSION = 1

REQUEST_OPS = ("debate", "ping", "stats", "check", "refill", "drain")

# Typed load-shed reasons (the admission contract docs/serving.md
# documents; every refusal names exactly one):
#
# - queue_full — the tenant's outstanding-debate queue is at cap;
# - backlog   — the estimated token backlog is at cap (global);
# - quota     — the tenant's token quota is exhausted;
# - brownout  — batch-tier admissions are paused during brownout;
# - draining  — the daemon is draining; no new admissions.
SHED_REASONS = ("queue_full", "backlog", "quota", "brownout", "draining")

TIERS = ("interactive", "batch")

RESPONSE_EVENTS = (
    "accepted",
    "shed",
    "stream",
    "result",
    "error",
    "pong",
    "stats",
    "check",
    "ok",
    "draining",
)

# Events that END a request's response stream: after one of these, no
# further event carries that request id.
TERMINAL_EVENTS = ("result", "shed", "error", "pong", "stats", "check", "ok")

# op -> {field: (types..., required?)}. ``op``/``id`` are common.
REQUEST_FIELDS: dict[str, dict[str, tuple]] = {
    "debate": {
        "tenant": (str, True),
        "tier": (str, False),  # default "interactive"
        "spec": (str, True),
        "models": (list, True),
        "round": (int, False),  # default 1
        "session": (str, False),  # arms the round journal
        "stream": (bool, False),  # per-opponent text-so-far events
        "max_new_tokens": (int, False),
        "greedy": (bool, False),
    },
    "ping": {},
    "stats": {},
    "check": {},
    "refill": {
        "tenant": (str, True),
        "tokens": (int, True),
    },
    "drain": {},
}


def encode(obj: dict) -> bytes:
    """One message, one line (compact separators — the framing)."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode("utf-8")


def decode(line: bytes | str) -> dict | None:
    """Parse one line; None when undecodable (the caller answers with
    a typed ``error`` event, never a crash)."""
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


def validate_request(obj: dict) -> list[str]:
    """Schema-check one decoded request line; returns human-readable
    problems (empty = valid). Malformed requests are answered with an
    ``error`` event carrying these — a bad client must never take the
    daemon down or wedge the scheduler."""
    if not isinstance(obj, dict):
        return [f"not an object: {obj!r}"]
    errors: list[str] = []
    op = obj.get("op")
    if op not in REQUEST_FIELDS:
        return [f"unknown op {op!r} (known: {', '.join(REQUEST_OPS)})"]
    if not isinstance(obj.get("id"), str) or not obj.get("id"):
        errors.append("missing/empty request 'id'")
    fields = REQUEST_FIELDS[op]
    for name, (py, required) in fields.items():
        if name not in obj:
            if required:
                errors.append(f"{op}: missing field {name!r}")
            continue
        v = obj[name]
        ok = isinstance(v, py) and not (
            py is int and isinstance(v, bool)
        )
        if not ok:
            errors.append(
                f"{op}: field {name!r} expected {py.__name__}, "
                f"got {type(v).__name__}"
            )
    for name in obj:
        if name not in fields and name not in ("op", "id"):
            errors.append(f"{op}: unknown field {name!r}")
    if op == "debate":
        tier = obj.get("tier", "interactive")
        if tier not in TIERS:
            errors.append(
                f"debate: unknown tier {tier!r} (known: {', '.join(TIERS)})"
            )
        models = obj.get("models")
        if isinstance(models, list) and (
            not models or not all(isinstance(m, str) and m for m in models)
        ):
            errors.append("debate: 'models' must be a non-empty str list")
    return errors


def shed_event(req_id: str, reason: str, retry_after_s: float, msg: str) -> dict:
    """The typed load-shed refusal — always carries WHEN to come back,
    so a well-behaved client backs off instead of hammering."""
    assert reason in SHED_REASONS, reason
    return {
        "id": req_id,
        "event": "shed",
        "reason": reason,
        "retry_after_s": round(max(0.0, retry_after_s), 3),
        "message": msg,
    }


def error_event(req_id: str, problems: list[str]) -> dict:
    return {
        "id": req_id or "",
        "event": "error",
        "message": "; ".join(problems) or "malformed request",
    }


def self_check() -> list[str]:
    """Protocol schema self-check (pinned by the serve tests): every op
    has a schema, the validator fires on the
    canonical breakages, and the shed vocabulary matches the obs event
    vocabulary (one source of drift less)."""
    problems: list[str] = []
    if set(REQUEST_FIELDS) != set(REQUEST_OPS):
        problems.append("REQUEST_FIELDS keys != REQUEST_OPS")
    good = {
        "op": "debate",
        "id": "c1",
        "tenant": "t0",
        "spec": "## spec",
        "models": ["mock://agree"],
    }
    if validate_request(good):
        problems.append("canonical debate request failed validation")
    for bad, why in (
        ({**good, "op": "nope"}, "unknown op"),
        ({k: v for k, v in good.items() if k != "id"}, "missing id"),
        ({**good, "models": []}, "empty models"),
        ({**good, "tier": "bulk"}, "unknown tier"),
        ({**good, "extra": 1}, "unknown field"),
        ({**good, "round": "one"}, "wrong field type"),
    ):
        if not validate_request(bad):
            problems.append(f"validator failed to fire on {why}")
    from adversarial_spec_tpu_torch.obs.events import SERVE_TIERS

    if tuple(TIERS) != tuple(SERVE_TIERS):
        problems.append("protocol TIERS != obs SERVE_TIERS")
    return problems
