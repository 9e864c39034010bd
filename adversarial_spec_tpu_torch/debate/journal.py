"""Crash-safe write-ahead journal for debate rounds.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/journal.py``.

``SessionState`` is saved only AFTER a round completes, so before this
module a crash mid-round lost the entire round: every opponent's decode
was re-paid on ``--resume`` even when the process died one opponent
short of synthesis. The journal closes that window with an append-only
per-session record stream (``<sessions_dir>/<session_id>.journal.jsonl``)
written at the three durability points of a round:

- ``round_start`` — the round number, a sha-256 of the spec, the model
  list and the round config, logged before the first engine call. The
  spec hash is the replay guard: records are only served back to a
  resume that is re-running the SAME round of the SAME spec.
- ``completion`` — one record per opponent, written (fsync'd) the
  moment its streamed request finishes or cancels: model, full text,
  cancelled flag, usage, latency, trace/span ids. Errored opponents
  get no completion record (a resume re-issues them — with the breaker
  snapshot on ``SessionState`` still skipping models whose circuit is
  open); a deadline/fault-evicted opponent's partial text is journaled
  as a ``partial`` record for diagnosis but never replayed.
- ``round_commit`` — the round synthesized and the session file
  advanced; the journal's job for this round is done.

``--resume`` replays the journal (``replay``): opponents with a durable
completion record are served from it byte-identically with ZERO engine
work — and with the content-addressed disk store rehydrating the
shared prefix KV, the re-issued remainder's prefill is mostly free too.
Only unfinished opponents re-enter the engine. ``tools/chaos_run.py
--crash`` and ``bench.py --mode recover`` drive the full
SIGKILL-mid-round → resume loop.

Durability mechanics: every append is a single JSON line written,
flushed and ``os.fsync``'d before the caller proceeds (the fsync wall
is the ``advspec_journal_fsync_seconds`` histogram). A crash mid-append
leaves at most one half-written line with no trailing newline; the
NEXT append heals it with a leading newline so the torn garbage is
confined to its own line, and the reader skips undecodable lines
ALONE — records appended after a crash stay replayable through a
second crash. Records with a foreign ``v`` (version) or failing the
field schema are likewise skipped and counted, never fatal. Journal
failures are contained
by the caller (debate/core.py): a round must survive its journal — the
chaos injector's ``crash`` seam fires before every append to prove it.

``ADVSPEC_JOURNAL_KILL_AFTER=N`` (the kill-chaos harness's
deterministic trigger) SIGKILLs the process the moment the N-th
completion record becomes durable — a REAL kill, after a REAL fsync,
at a reproducible point mid-round.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
from pathlib import Path

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.debate import session as session_mod
from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine.types import Completion
from adversarial_spec_tpu_torch.resilience import injector

JOURNAL_VERSION = 1

RECORD_TYPES = ("round_start", "completion", "partial", "round_commit")

# Record schema (the journal's analog of obs EVENT_FIELDS): type ->
# {field: python type}. ``v``/``type`` are common to every record.
# tools/lint_all.py runs ``self_check()`` against this table so the
# writer, the validator and the examples can never drift apart.
RECORD_FIELDS: dict[str, dict[str, type]] = {
    "round_start": {
        "round": int,
        "spec_sha": str,
        "models": list,
        "config": dict,
        "trace_id": str,
    },
    "completion": {
        "round": int,
        "index": int,
        "model": str,
        "text": str,
        "cancelled": bool,
        "latency_s": float,
        "usage": dict,
        "trace_id": str,
        "span_id": str,
    },
    "partial": {
        "round": int,
        "index": int,
        "model": str,
        "text": str,
        "error": str,
        "usage": dict,
        "trace_id": str,
        "span_id": str,
    },
    "round_commit": {
        "round": int,
        "all_agreed": bool,
    },
}

# Examples of every record type, used by ``self_check`` (each must pass
# ``validate_record`` after a JSON round-trip) and as documentation of
# the on-disk shape.
_EXAMPLES: dict[str, dict] = {
    "round_start": {
        "round": 1,
        "spec_sha": "0" * 64,
        "models": ["mock://critic"],
        "config": {"doc_type": "generic"},
        "trace_id": "tr-001-01",
    },
    "completion": {
        "round": 1,
        "index": 0,
        "model": "mock://critic",
        "text": "1. Critique...\n[SPEC]...[/SPEC]",
        "cancelled": False,
        "latency_s": 0.25,
        "usage": {"input_tokens": 10, "output_tokens": 20},
        "trace_id": "tr-001-01",
        "span_id": "tr-001-01/s00",
    },
    "partial": {
        "round": 1,
        "index": 1,
        "model": "mock://critic",
        "text": "1. Cri",
        "error": "DEADLINE_EXCEEDED: per-request watchdog deadline",
        "usage": {},
        "trace_id": "tr-001-01",
        "span_id": "tr-001-01/s01",
    },
    "round_commit": {"round": 1, "all_agreed": False},
}


def spec_sha(spec: str) -> str:
    """The replay guard: journal records bind to this exact spec."""
    return hashlib.sha256(spec.encode("utf-8")).hexdigest()


def env_enabled() -> bool:
    """The process default for ``--journal`` (``ADVSPEC_JOURNAL``)."""
    return os.environ.get("ADVSPEC_JOURNAL", "1") != "0"


def validate_record(obj) -> list[str]:
    """Schema-check one decoded journal line; returns human-readable
    problems (empty = valid). Unknown versions are a VALIDATION error
    here — the tolerant reader skips them before validation."""
    if not isinstance(obj, dict):
        return [f"not an object: {obj!r}"]
    errors: list[str] = []
    if obj.get("v") != JOURNAL_VERSION:
        errors.append(f"unknown journal version {obj.get('v')!r}")
    rtype = obj.get("type")
    if rtype not in RECORD_FIELDS:
        return errors + [f"unknown record type {rtype!r}"]
    fields = RECORD_FIELDS[rtype]
    for name, py in fields.items():
        if name not in obj:
            errors.append(f"{rtype}: missing field {name!r}")
            continue
        v = obj[name]
        if py is bool:
            ok = isinstance(v, bool)
        elif py is int:
            ok = isinstance(v, int) and not isinstance(v, bool)
        elif py is float:
            ok = isinstance(v, (int, float)) and not isinstance(v, bool)
        elif py is list:
            ok = isinstance(v, list)
        elif py is dict:
            ok = isinstance(v, dict)
        else:
            ok = isinstance(v, str)
        if not ok:
            errors.append(
                f"{rtype}: field {name!r} expected {py.__name__}, "
                f"got {type(v).__name__}"
            )
    for name in obj:
        if name not in fields and name not in ("v", "type"):
            errors.append(f"{rtype}: unknown field {name!r}")
    return errors


def self_check() -> list[str]:
    """Journal schema self-check (a tools/lint_all.py stage): every
    record type has a schema and an example, every example round-trips
    JSON and validates clean, and the validator actually FIRES on a
    broken record (a silently dead validator is worse than none)."""
    problems: list[str] = []
    if set(RECORD_FIELDS) != set(RECORD_TYPES):
        problems.append(
            f"RECORD_FIELDS types {sorted(RECORD_FIELDS)} != "
            f"RECORD_TYPES {sorted(RECORD_TYPES)}"
        )
    if set(_EXAMPLES) != set(RECORD_TYPES):
        problems.append("every record type needs an example")
    for rtype, example in _EXAMPLES.items():
        rec = {"v": JOURNAL_VERSION, "type": rtype, **example}
        rec = json.loads(json.dumps(rec))
        errs = validate_record(rec)
        if errs:
            problems.append(f"example {rtype!r} invalid: {errs}")
    # Must-fail fixtures: wrong version, unknown type, missing field,
    # wrong field type, unknown field.
    good = {"v": JOURNAL_VERSION, "type": "round_commit", "round": 1,
            "all_agreed": True}
    for bad, why in (
        ({**good, "v": JOURNAL_VERSION + 1}, "foreign version"),
        ({**good, "type": "nope"}, "unknown type"),
        ({"v": JOURNAL_VERSION, "type": "round_commit", "round": 1},
         "missing field"),
        ({**good, "round": "one"}, "wrong field type"),
        ({**good, "extra": 1}, "unknown field"),
    ):
        if not validate_record(bad):
            problems.append(f"validator failed to fire on {why}")
    return problems


def completion_from_record(rec: dict) -> tuple[Completion, float]:
    """Rebuild the engine-seam ``Completion`` a journal record captured
    — the replay path feeds it through the SAME ``_to_response`` the
    live path uses, so agreement/spec extraction on a byte-identical
    transcript is byte-identical too. Returns (completion, latency_s)."""
    u = rec.get("usage") or {}
    known = {f.name for f in dataclasses.fields(Usage)}
    usage = Usage(**{k: v for k, v in u.items() if k in known})
    return (
        Completion(
            text=rec.get("text", ""),
            cancelled=bool(rec.get("cancelled", False)),
            usage=usage,
        ),
        float(rec.get("latency_s", 0.0)),
    )


class RoundJournal:
    """Append-only per-session round journal (one file per session)."""

    def __init__(self, session_id: str, journal_dir: Path | None = None):
        session_mod._validate_session_id(session_id)
        self.session_id = session_id
        self._dir = journal_dir
        self._n_completions = 0
        # Stats of the most recent replay() read, for the caller's
        # RecoveryEvent: total readable records and lines discarded
        # (torn tail / foreign version / schema mismatch).
        self.replay_records = 0
        self.replay_skipped = 0
        kill = os.environ.get("ADVSPEC_JOURNAL_KILL_AFTER", "")
        try:
            self._kill_after = max(0, int(kill)) if kill else 0
        except ValueError:
            self._kill_after = 0

    @property
    def path(self) -> Path:
        # Resolved per access, not cached: tests patch
        # session.SESSIONS_DIR per-case (the module-constant fixture
        # pattern) and the journal must follow.
        directory = Path(self._dir or session_mod.SESSIONS_DIR)
        return directory / f"{self.session_id}.journal.jsonl"

    # -- durable writes ----------------------------------------------------

    def _write(self, rtype: str, payload: dict, *, fresh: bool = False) -> None:
        """Append one record durably (write + flush + fsync). ``fresh``
        rewrites the file to just this record (atomic tmp + replace —
        the round-boundary truncation that keeps the journal one round
        long; the committed previous round lives on in SessionState's
        history, not here)."""
        # The chaos seam: a fault here is a record that never became
        # durable. Callers contain it — the round must outlive its
        # journal (debate/core.py's _journal_safe).
        injector.fire("crash")
        record = {"v": JOURNAL_VERSION, "type": rtype, **payload}
        line = json.dumps(record, separators=(",", ":")) + "\n"
        path = self.path
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        if fresh:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(line)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        else:
            # Heal a torn tail before appending: a crash mid-append
            # leaves a half-written line with NO trailing newline, and
            # appending straight onto it would fuse this record into
            # the garbage — unreadable, and before the reader learned
            # to skip mid-stream garbage it cost every later record in
            # the round too. A leading newline confines the torn line
            # to itself; the reader skips it alone.
            heal = False
            try:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    heal = rf.read(1) != b"\n"
            except (OSError, ValueError):
                heal = False  # missing or empty file: nothing to heal
            with open(path, "a", encoding="utf-8") as f:
                if heal:
                    f.write("\n")
                f.write(line)
                f.flush()
                os.fsync(f.fileno())
        dt = time.monotonic() - t0
        if obs_mod.config().enabled:
            obs_mod.hot.journal_fsync.observe(dt)
            obs_mod.metrics.counter(
                "advspec_journal_records_total",
                help="durable round-journal appends by record type",
                type=rtype,
            ).inc()
            obs_mod.emit(
                obs_mod.JournalEvent(
                    op="append",
                    rtype=rtype,
                    round_num=int(payload.get("round", 0)),
                    index=int(payload.get("index", -1)),
                    fsync_s=dt,
                    trace_id=payload.get("trace_id", ""),
                    span_id=payload.get("span_id", ""),
                )
            )
        if rtype == "completion" and self._kill_after:
            # Kill-chaos trigger: die HARD right after this record
            # became durable — the harness's deterministic mid-round
            # SIGKILL (tools/chaos_run.py --crash).
            self._n_completions += 1
            if self._n_completions >= self._kill_after:
                os.kill(os.getpid(), signal.SIGKILL)

    def ensure_round_start(
        self,
        round_num: int,
        spec: str,
        models: list[str],
        config: dict,
        trace_id: str = "",
    ) -> bool:
        """Log the round-start marker once per (round, spec). A resume
        of an already-started round appends nothing (its completions
        must stay replayable); a NEW round truncates the journal to the
        fresh marker — the previous round committed into SessionState
        and its records are dead weight. Returns True when a marker was
        written."""
        records, _ = self.read()
        for rec in records:
            if (
                rec["type"] == "round_start"
                and rec["round"] == round_num
                and rec["spec_sha"] == spec_sha(spec)
            ):
                return False
        self._write(
            "round_start",
            {
                "round": round_num,
                "spec_sha": spec_sha(spec),
                "models": list(models),
                "config": dict(config),
                "trace_id": trace_id,
            },
            fresh=True,
        )
        return True

    def log_completion(
        self,
        round_num: int,
        index: int,
        model: str,
        comp: Completion,
        latency_s: float,
        trace_id: str = "",
        span_id: str = "",
    ) -> None:
        self._write(
            "completion",
            {
                "round": round_num,
                "index": index,
                "model": model,
                "text": comp.text,
                "cancelled": bool(comp.cancelled),
                "latency_s": round(float(latency_s), 6),
                "usage": dataclasses.asdict(comp.usage),
                "trace_id": trace_id,
                "span_id": span_id,
            },
        )

    def log_partial(
        self,
        round_num: int,
        index: int,
        model: str,
        comp: Completion,
        trace_id: str = "",
        span_id: str = "",
    ) -> None:
        """A deadline/fault-evicted opponent's salvaged partial text:
        journaled for diagnosis (what did the budget buy before the
        watchdog fired?), never replayed — a resume re-issues it."""
        self._write(
            "partial",
            {
                "round": round_num,
                "index": index,
                "model": model,
                "text": comp.text,
                "error": comp.error or "",
                "usage": dataclasses.asdict(comp.usage),
                "trace_id": trace_id,
                "span_id": span_id,
            },
        )

    def log_round_commit(self, round_num: int, all_agreed: bool) -> None:
        self._write(
            "round_commit",
            {"round": round_num, "all_agreed": bool(all_agreed)},
        )

    # -- tolerant reads + replay -------------------------------------------

    def read(self) -> tuple[list[dict], int]:
        """Every valid record, in order, plus the count of lines that
        were skipped. An UNDECODABLE line is a tear artifact — a crash
        mid-append (the one crash shape an fsync'd append-only file
        has) — and is skipped ALONE: the appender heals a newline-less
        torn tail before its next write, so every record after a tear
        sits on its own durably-appended line and stays replayable (a
        reader that discarded everything past the tear re-paid every
        post-crash opponent on the NEXT crash). Records are
        independently keyed (replay re-checks round/spec/model per
        record), so skipping garbage alone never resurrects unordered
        state. A decodable record that fails validation or carries a
        foreign version likewise skips alone — the append completed;
        the record just isn't ours to act on."""
        path = self.path
        if not path.is_file():
            return [], 0
        records: list[dict] = []
        skipped = 0
        lines = path.read_text(encoding="utf-8", errors="replace").splitlines()
        for line in lines:
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if validate_record(obj):
                skipped += 1
                continue
            records.append(obj)
        return records, skipped

    def replay(
        self, round_num: int, spec: str, models: list[str]
    ) -> dict[int, dict]:
        """The resume path: completion records for THIS round of THIS
        spec, keyed by opponent index — the opponents a restarted
        process serves from the journal instead of the engine. Guards:
        the last round_start for the round must hash-match the resumed
        spec (a revised spec invalidates every record); the resumed
        opponent POOL must be the journaled pool as a multiset (a
        changed model set refuses replay cleanly — every opponent
        re-issues); and each record serves THE MODEL IT NAMES — at its
        recorded index when the pool order held, re-homed to the
        model's new index when the pool was merely permuted (an
        unambiguous, single-occurrence model only; duplicate ids keep
        the strict per-index match)."""
        records, skipped = self.read()
        self.replay_records = len(records)
        self.replay_skipped = skipped
        start = None
        for rec in records:
            if rec["type"] == "round_start" and rec["round"] == round_num:
                start = rec
        if start is None or start["spec_sha"] != spec_sha(spec):
            return {}
        if sorted(start.get("models", [])) != sorted(models):
            # A changed model SET invalidates the round's records: a
            # completion for a model no longer (or newly) in the pool
            # must not be half-served. Clean refusal — re-issue all.
            return {}
        out: dict[int, dict] = {}
        rehome: list[dict] = []
        for rec in records:
            if rec["type"] != "completion" or rec["round"] != round_num:
                continue
            i = rec["index"]
            if 0 <= i < len(models) and rec["model"] == models[i]:
                out[i] = rec
            else:
                rehome.append(rec)
        # Permuted pool (same multiset, different order): serve each
        # leftover record at ITS model's new index — the per-index
        # model match still decides, just at the re-homed position.
        for rec in rehome:
            model = rec.get("model")
            if models.count(model) != 1:
                continue  # ambiguous under duplicates: re-issue
            j = models.index(model)
            if j not in out:
                out[j] = rec
        if skipped and obs_mod.config().enabled:
            obs_mod.metrics.counter(
                "advspec_journal_records_skipped_total",
                help="journal lines discarded on read (torn tail, "
                "foreign version, schema mismatch)",
            ).inc(skipped)
        return out
