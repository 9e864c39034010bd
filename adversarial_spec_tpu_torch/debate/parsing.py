"""Parsers for the debate tag protocol.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/parsing.py``.

The wire protocol between the orchestrator and opponent models is plain text
with three markers (behavioral parity with reference scripts/models.py:149-247):

- ``[AGREE]`` anywhere in a response means the model approves the spec as-is.
- ``[SPEC] ... [/SPEC]`` brackets a full revised spec.
- ``[TASK] ... [/TASK]`` blocks carry structured implementation tasks, with
  ``field: value`` lines (title / description / priority / dependencies /
  estimate) used by export-tasks.
"""

from __future__ import annotations

import difflib
import re
from dataclasses import dataclass, field

AGREE_MARKER = "[AGREE]"
SPEC_OPEN, SPEC_CLOSE = "[SPEC]", "[/SPEC]"
TASK_RE = re.compile(r"\[TASK\](.*?)\[/TASK\]", re.DOTALL)

# Markers that make a STREAMED response's verdict decidable the moment
# they appear (the debate core's early-cancel consumer, docs/
# streaming.md): everything decoded past one of these is never read by
# the debate loop, so the request cancels mid-decode and the freed
# capacity serves queued work. Substring semantics deliberately mirror
# ``detect_agreement`` — a marker inside a code fence still counts —
# so the incremental verdict can NEVER diverge from the whole-text
# parse of the same prefix. This tuple also drives the summary cleanup
# below: a section marker added here is stripped from critique
# summaries by the same path, with no second list to forget.
EARLY_CANCEL_MARKERS: tuple[str, ...] = (AGREE_MARKER,)


class StreamScanner:
    """Incremental marker scanner over a growing text stream.

    ``feed`` receives the text decoded SO FAR (each call a superset of
    the last) and returns the earliest marker whose full text has
    appeared, or None while the verdict is undecidable. Only the
    unseen tail plus a ``max(len(marker)) - 1`` lookback window is
    rescanned, so a marker split across any chunking of the stream —
    token boundaries never align with marker boundaries — is caught
    exactly when its last character arrives, and feeding the whole
    text again stays O(stream length) overall. The verdict is sticky:
    once found, later feeds return it without rescanning (the consumer
    has already asked for cancellation; extra chunks may still arrive
    from steps in flight)."""

    def __init__(self, markers: tuple[str, ...] = EARLY_CANCEL_MARKERS):
        self.markers = tuple(markers)
        self._lookback = max(
            (len(m) for m in self.markers), default=1
        ) - 1
        self._pos = 0  # stream offset scanned so far
        self.found: str | None = None
        self.found_at: int = -1  # stream offset of the found marker

    def feed(self, text_so_far: str) -> str | None:
        if self.found is not None or not self.markers:
            return self.found
        start = max(self._pos - self._lookback, 0)
        window = text_so_far[start:]
        best: str | None = None
        best_at = -1
        for marker in self.markers:
            i = window.find(marker)
            if i != -1 and (best_at == -1 or i < best_at):
                best, best_at = marker, i
        self._pos = len(text_so_far)
        if best is not None:
            self.found = best
            self.found_at = start + best_at
        return self.found

_TASK_FIELDS = ("title", "description", "priority", "dependencies", "estimate")
_PRIORITIES = {"critical", "high", "medium", "low"}


def detect_agreement(response: str) -> bool:
    """True iff the response contains the [AGREE] marker.

    Parity: reference scripts/models.py:149-151 — a bare substring check, so
    agreement plus commentary still counts as agreement.
    """
    return AGREE_MARKER in response


def extract_spec(response: str) -> str | None:
    """Pull the revised spec out of [SPEC]...[/SPEC], or None.

    Deliberate departure from the reference (scripts/models.py:154-160,
    which takes the FIRST close tag): we take first open tag → LAST close
    tag. Models sometimes nest examples containing literal [/SPEC] tags;
    the widest span preserves them, where the reference would truncate the
    spec at the embedded tag. Outputs diverge only on multi-close-tag
    responses (pinned in tests/test_parsing.py).
    """
    start = response.find(SPEC_OPEN)
    if start == -1:
        return None
    end = response.rfind(SPEC_CLOSE)
    # start >= 0 here, so end < start also covers the not-found end == -1.
    if end < start:
        return None
    return response[start + len(SPEC_OPEN) : end].strip()


def has_malformed_spec(response: str) -> bool:
    """An open [SPEC] without a matching close — warn, don't crash.

    Parity: reference warns on malformed responses (scripts/models.py:633-637).
    """
    return SPEC_OPEN in response and extract_spec(response) is None


@dataclass
class Task:
    """One implementation task parsed from a [TASK] block."""

    title: str = ""
    description: str = ""
    priority: str = "medium"
    dependencies: list[str] = field(default_factory=list)
    estimate: str = ""

    def to_dict(self) -> dict:
        return {
            "title": self.title,
            "description": self.description,
            "priority": self.priority,
            "dependencies": self.dependencies,
            "estimate": self.estimate,
        }


def extract_tasks(response: str) -> list[Task]:
    """Parse every [TASK]...[/TASK] block into a structured Task.

    Parity: reference scripts/models.py:163-247. Lines are ``field: value``;
    unknown fields are ignored; a block with no recognized fields but
    non-empty text becomes a task whose title is the first line. Priority is
    normalized to one of critical/high/medium/low (default medium).
    Dependencies split on commas.
    """
    tasks: list[Task] = []
    for block in TASK_RE.findall(response):
        task = Task()
        saw_field = False
        for raw_line in block.strip().splitlines():
            line = raw_line.strip()
            if not line or ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip().lower().lstrip("-* ").strip()
            value = value.strip()
            if key not in _TASK_FIELDS or not value:
                continue
            saw_field = True
            if key == "priority":
                norm = value.lower().strip()
                task.priority = norm if norm in _PRIORITIES else "medium"
            elif key == "dependencies":
                task.dependencies = [
                    d.strip() for d in value.split(",") if d.strip()
                ]
            else:
                setattr(task, key, value)
        if not saw_field:
            text = block.strip()
            if not text:
                continue
            first, _, rest = text.partition("\n")
            task.title = first.strip()
            task.description = rest.strip()
        tasks.append(task)
    return tasks


def get_critique_summary(critique: str, max_chars: int = 200) -> str:
    """First-line-ish summary of a critique for progress display.

    Parity: reference scripts/models.py:250-260 — strip tags, take the first
    non-empty line, truncate with an ellipsis.
    """
    # Marker-list-driven cleanup: every verdict marker the streaming
    # path can cancel on (EARLY_CANCEL_MARKERS) is stripped here too —
    # one list, so a section marker added for early cancel can never
    # leak into summaries.
    cleaned = critique
    for marker in EARLY_CANCEL_MARKERS:
        cleaned = cleaned.replace(marker, "")
    cleaned = cleaned.strip()
    cleaned = re.sub(
        re.escape(SPEC_OPEN) + ".*?" + re.escape(SPEC_CLOSE),
        "",
        cleaned,
        flags=re.DOTALL,
    ).strip()
    for line in cleaned.splitlines():
        line = line.strip()
        if line:
            if len(line) > max_chars:
                return line[: max_chars - 3] + "..."
            return line
    return ""


def generate_diff(old_spec: str, new_spec: str, n_context: int = 3) -> str:
    """Unified diff between two spec versions.

    Parity: reference scripts/models.py:263-271 (difflib unified_diff with
    previous/revised labels).
    """
    diff = difflib.unified_diff(
        old_spec.splitlines(keepends=True),
        new_spec.splitlines(keepends=True),
        fromfile="previous_spec",
        tofile="revised_spec",
        n=n_context,
    )
    return "".join(diff)
