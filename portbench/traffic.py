"""The one traffic generator: critique rounds drawn from a mix file and a seed.

A mix (``traffic/<name>.json``) fixes the shape of every round: how many
opponents list the model, the spec's length in tokens, the tokens each
opponent may generate, the sampling temperature, the KV layout and
speculation, and which rounds decode greedily (``greedy_every``: every
such round is greedy, the rest sampled). The seed fixes the text: round
``r``'s spec document, its persona and its sampling seed come from
``(seed, r)``, so two seeds give rounds of the same sizes with other
words, and one seed gives the same rounds again.

``spec_document`` and ``PERSONAS`` are copies of the ones the chip smoke
(``chip_smoke.py``) serves, kept here so the yardstick does not move
with the program. The port's random checkpoints use its byte tokenizer,
so a spec of ``spec_tokens`` ASCII bytes is that many tokens.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

PERSONAS = [
    "You are a security engineer reviewing a product spec.",
    "You are an SRE focused on reliability and operability.",
    "You are a product manager checking scope and acceptance criteria.",
    "You are a staff engineer looking for design flaws and ambiguity.",
    "You are a privacy counsel checking data handling.",
    "You are a QA lead looking for untestable requirements.",
    "You are a database engineer reviewing storage and migrations.",
    "You are a frontend engineer checking API ergonomics.",
    "You are a cost analyst reviewing infrastructure spend.",
    "You are an accessibility specialist reviewing user flows.",
    "You are a support lead checking operability for on-call staff.",
    "You are a compliance auditor checking audit and retention rules.",
]

KEYS = ("opponents", "kv", "speculative", "doc_type", "spec_tokens",
        "max_new_tokens", "temperature", "greedy_every", "check_rows", "trace_rounds")


def spec_document(n_bytes: int, seed: int) -> str:
    """A spec-style markdown document of about ``n_bytes`` bytes."""
    topics = [
        "authentication", "rate limiting", "audit logging", "billing",
        "search indexing", "data retention", "webhooks", "notifications",
    ]
    parts = [f"# Product Spec {seed}: {topics[seed % len(topics)].title()}\n"]
    i = 0
    while sum(len(p) for p in parts) < n_bytes:
        t = topics[(seed + i) % len(topics)]
        parts.append(
            f"\n## {i + 1}. {t.title()}\n"
            f"- The service MUST expose {t} through a versioned API "
            f"(v{1 + i % 3}) with p99 latency under {50 + 10 * i} ms.\n"
            f"- Failures in {t} are retried with exponential backoff, at "
            f"most {3 + i % 4} attempts, and surfaced to the operator.\n"
            f"- Acceptance: an integration test covers {t} under load.\n"
        )
        i += 1
    return "".join(parts)[:n_bytes]


def derive(seed: int, tag: str, index: int) -> int:
    """A 62-bit number fixed by ``(seed, tag, index)``."""
    h = hashlib.sha256(f"{seed}:{tag}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def load_mix(name: str, root: Path = HERE) -> dict:
    """``traffic/<name>.json``, checked for every key the generator reads."""
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    if mix["kv"] not in ("dense", "paged"):
        raise ValueError(f"traffic {name}: kv {mix['kv']!r} is not dense or paged")
    return mix


@dataclass(frozen=True)
class Round:
    index: int
    spec: str
    persona: str
    greedy: bool
    sampling_seed: int


def is_greedy(mix: dict, index: int) -> bool:
    k = int(mix["greedy_every"])
    return k > 0 and index % k == k - 1


def round_at(mix: dict, seed: int, index: int, greedy: bool | None = None) -> Round:
    """Round ``index`` of the seed's stream (negative indices: warm-up)."""
    return Round(
        index=index,
        spec=spec_document(int(mix["spec_tokens"]), derive(seed, "spec", index)),
        persona=PERSONAS[derive(seed, "persona", index) % len(PERSONAS)],
        greedy=is_greedy(mix, index) if greedy is None else greedy,
        sampling_seed=derive(seed, "sample", index),
    )


def warmup_rounds(mix: dict, seed: int) -> list[Round]:
    """One round of each decode mode the window runs, at its own sizes.
    The greedy round runs its whole budget too: a shorter one leaves the
    batcher's sampled decode step to be captured anew in the window's
    first round."""
    modes = [False] + ([True] if int(mix["greedy_every"]) > 0 else [])
    return [round_at(mix, seed, -1 - i, greedy=g) for i, g in enumerate(modes)]
