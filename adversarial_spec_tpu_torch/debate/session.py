"""Session persistence and per-round spec checkpoints.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/session.py``.

Behavioral parity with reference scripts/session.py:
- ``SessionState`` serialized as JSON under a sessions dir, written after
  every round with ``round`` advanced and history appended
  (session.py:16-39, debate.py:865-878).
- ``--resume`` restores all debate arguments and the current spec
  (session.py:41-50, debate.py:753-773).
- Per-round spec snapshots under ``./.adversarial-spec-checkpoints/`` for
  manual rollback (session.py:74-82).
- Path-traversal guard on session ids (session.py:37-38, 45-46).

Durability (docs/resilience.md "Durability and recovery"): every write
here goes through ``obs.atomic_write_text`` (pid-suffixed tmp +
``os.replace``) — a crash mid-write leaves the previous complete file
intact, never a torn one, because ``--resume`` depends on this file. A
session file that is nonetheless corrupt on disk (torn by an older
writer, bad storage) is QUARANTINED to ``<name>.corrupt`` on load
(DiskStore's discipline, engine/kvtier.py) and surfaced as a clear
``CorruptSessionState`` naming the path and the recovery options,
instead of a raw ``JSONDecodeError`` with no context.

All directories are module-level constants precisely so tests can patch them
(the reference's patch-the-module-constant fixture pattern, SURVEY §4).
``ADVSPEC_SESSIONS_DIR`` overrides the sessions dir for subprocess
harnesses (tools/chaos_run.py --crash, bench.py --mode recover) that
must not touch the operator's real ``~/.config`` state.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field, asdict
from pathlib import Path

from adversarial_spec_tpu_torch.obs.events import atomic_write_text

SESSIONS_DIR = Path(
    os.environ.get("ADVSPEC_SESSIONS_DIR")
    or Path.home() / ".config" / "adversarial-spec-tpu" / "sessions"
)
CHECKPOINTS_DIR = Path(".adversarial-spec-checkpoints")

_SESSION_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


class InvalidSessionId(ValueError):
    pass


class CorruptSessionState(ValueError):
    """A session file failed to parse; it has been quarantined aside."""


def _validate_session_id(session_id: str) -> str:
    if not session_id or not _SESSION_ID_RE.match(session_id):
        raise InvalidSessionId(
            f"invalid session id {session_id!r}: only letters, digits, "
            "dot, underscore and dash are allowed"
        )
    return session_id


@dataclass
class SessionState:
    """Resumable debate state: spec + round + all debate arguments."""

    session_id: str
    spec: str = ""
    round: int = 1
    doc_type: str = "generic"
    models: list[str] = field(default_factory=list)
    focus: str | None = None
    persona: str | None = None
    preserve_intent: bool = False
    created_at: float = 0.0
    updated_at: float = 0.0
    # Per-round history: [{"round", "all_agreed", "models": {name: agreed}}].
    history: list[dict] = field(default_factory=list)
    # Circuit-breaker snapshot (resilience/breaker.py:snapshot_for_resume):
    # one CLI invocation is one round, so open circuits must ride the
    # session to skip persistently failing models on the NEXT round.
    breakers: dict = field(default_factory=dict)

    def save(self, sessions_dir: Path | None = None) -> Path:
        directory = Path(sessions_dir or SESSIONS_DIR)
        _validate_session_id(self.session_id)
        directory.mkdir(parents=True, exist_ok=True)
        now = time.time()
        if not self.created_at:
            self.created_at = now
        self.updated_at = now
        path = directory / f"{self.session_id}.json"
        # Atomic: a crash anywhere in this write leaves the previous
        # complete session file (the thing --resume replays) intact and
        # no orphan tmp behind — the same crash-window contract
        # --metrics-out and the events JSONL already honor.
        atomic_write_text(str(path), json.dumps(asdict(self), indent=2))
        return path

    @classmethod
    def load(
        cls, session_id: str, sessions_dir: Path | None = None
    ) -> "SessionState":
        directory = Path(sessions_dir or SESSIONS_DIR)
        _validate_session_id(session_id)
        path = directory / f"{session_id}.json"
        try:
            data = json.loads(path.read_text())
            if not isinstance(data, dict):
                raise ValueError(
                    f"top-level JSON is {type(data).__name__}, not an object"
                )
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            # Quarantine, then fail with the path and a way forward —
            # corruption in ANY shape (truncated JSON, non-UTF-8 bytes
            # from bad storage, a rewritten non-object) must not
            # present as a stack trace, and leaving the file in place
            # would make every retry hit the same wall (DiskStore's
            # corrupt-entry discipline).
            quarantine = path.with_name(path.name + ".corrupt")
            try:
                os.replace(path, quarantine)
                where = f"quarantined to {quarantine}"
            except OSError:
                where = "quarantine failed; file left in place"
            raise CorruptSessionState(
                f"session file {path} is corrupt ({e}); {where}. "
                f"Start over with --session {session_id}, or restore a "
                f"spec snapshot from {CHECKPOINTS_DIR}/"
            ) from e
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def list_sessions(cls, sessions_dir: Path | None = None) -> list[dict]:
        """Summaries of saved sessions, most recently updated first."""
        directory = Path(sessions_dir or SESSIONS_DIR)
        if not directory.is_dir():
            return []
        sessions = []
        for path in directory.glob("*.json"):
            try:
                data = json.loads(path.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            sessions.append(
                {
                    "session_id": data.get("session_id", path.stem),
                    "round": data.get("round", 1),
                    "doc_type": data.get("doc_type", "generic"),
                    "models": data.get("models", []),
                    "updated_at": data.get("updated_at", 0.0),
                }
            )
        sessions.sort(key=lambda s: s["updated_at"], reverse=True)
        return sessions


def save_checkpoint(
    spec: str,
    round_num: int,
    session_id: str | None = None,
    checkpoints_dir: Path | None = None,
) -> Path:
    """Snapshot the spec for this round to a rollback file."""
    directory = Path(checkpoints_dir or CHECKPOINTS_DIR)
    directory.mkdir(parents=True, exist_ok=True)
    prefix = f"{_validate_session_id(session_id)}-" if session_id else ""
    path = directory / f"{prefix}round-{round_num}.md"
    # Atomic like the session file: the checkpoint is the manual
    # rollback of last resort — a crash mid-write must not destroy it.
    atomic_write_text(str(path), spec)
    return path
