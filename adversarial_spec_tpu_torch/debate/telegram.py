"""Telegram human-in-the-loop channel.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/telegram.py``.

Behavioral parity with reference scripts/telegram_bot.py: raw-urllib Bot API
client (api_call :47-75, 30 s timeout), message splitting at the 4096-char
Telegram limit preferring paragraph/line/space boundaries (:97-133),
send_long_message with inter-chunk pacing (:136-156), long-poll feedback
window sliced into ≤30 s getUpdates calls (:175-220), chat-id discovery
(:223-263), and a standalone CLI (setup/send/poll/notify :266-439).

Config comes from TELEGRAM_BOT_TOKEN / TELEGRAM_CHAT_ID env vars (:42-44).
Network errors never propagate into the debate round — callers treat this
channel as best-effort.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass

API_BASE = "https://api.telegram.org"
MAX_MESSAGE_LEN = 4096
API_TIMEOUT_S = 30
CHUNK_PACING_S = 0.5
POLL_SLICE_S = 25


@dataclass(frozen=True)
class TelegramConfig:
    token: str
    chat_id: str


def get_config() -> TelegramConfig | None:
    token = os.environ.get("TELEGRAM_BOT_TOKEN", "").strip()
    chat_id = os.environ.get("TELEGRAM_CHAT_ID", "").strip()
    if not token or not chat_id:
        return None
    return TelegramConfig(token=token, chat_id=chat_id)


def api_call(token: str, method: str, params: dict | None = None) -> dict:
    """POST one Bot API method; returns the decoded ``result`` payload."""
    url = f"{API_BASE}/bot{token}/{method}"
    data = urllib.parse.urlencode(params or {}).encode()
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=API_TIMEOUT_S) as resp:
        payload = json.loads(resp.read().decode())
    if not payload.get("ok"):
        raise RuntimeError(f"Telegram API {method} failed: {payload}")
    return payload.get("result", {})


def split_message(text: str, limit: int = MAX_MESSAGE_LEN) -> list[str]:
    """Split into ≤limit chunks, preferring paragraph > line > space breaks.

    Parity: reference telegram_bot.py:97-133 — a break point is only taken
    if it lands in the second half of the window so pathological inputs
    cannot degrade into tiny chunks.
    """
    if len(text) <= limit:
        return [text] if text else []
    chunks = []
    rest = text
    while len(rest) > limit:
        window = rest[:limit]
        cut = -1
        for sep in ("\n\n", "\n", " "):
            idx = window.rfind(sep)
            if idx > limit // 2:
                cut = idx + len(sep)
                break
        if cut == -1:
            cut = limit
        chunks.append(rest[:cut].rstrip("\n"))
        rest = rest[cut:]
    if rest:
        chunks.append(rest)
    return chunks


def send_message(config: TelegramConfig, text: str) -> None:
    api_call(
        config.token,
        "sendMessage",
        {"chat_id": config.chat_id, "text": text},
    )


def send_long_message(
    config: TelegramConfig, text: str, sleep=time.sleep
) -> int:
    """Send text in order as ≤4096-char chunks with pacing; returns count."""
    chunks = split_message(text)
    for i, chunk in enumerate(chunks):
        send_message(config, chunk)
        if i < len(chunks) - 1:
            sleep(CHUNK_PACING_S)
    return len(chunks)


def get_last_update_id(config: TelegramConfig) -> int:
    """Highest update id seen so far (so polling only sees new replies)."""
    updates = api_call(config.token, "getUpdates", {"timeout": 0})
    if not updates:
        return 0
    return max(u.get("update_id", 0) for u in updates)


def poll_for_reply(
    config: TelegramConfig,
    after_update_id: int,
    timeout_s: int,
    clock=time.monotonic,
) -> str | None:
    """Wait up to timeout_s for a text reply in the configured chat.

    Long-polls getUpdates in ≤POLL_SLICE_S slices (parity: reference
    :175-220); returns the first matching message text, or None on timeout.
    """
    deadline = clock() + timeout_s
    offset = after_update_id + 1
    while clock() < deadline:
        slice_s = min(POLL_SLICE_S, max(1, int(deadline - clock())))
        updates = api_call(
            config.token,
            "getUpdates",
            {"timeout": slice_s, "offset": offset},
        )
        for u in updates:
            offset = max(offset, u.get("update_id", 0) + 1)
            msg = u.get("message") or {}
            chat = str((msg.get("chat") or {}).get("id", ""))
            text = msg.get("text", "")
            if chat == str(config.chat_id) and text:
                return text
    return None


def discover_chat_id(token: str) -> str | None:
    """Find the chat id of the most recent message sent to the bot."""
    updates = api_call(token, "getUpdates", {"timeout": 0})
    for u in reversed(updates):
        msg = u.get("message") or {}
        chat = msg.get("chat") or {}
        if "id" in chat:
            return str(chat["id"])
    return None


def format_round_summary(result, total_cost: float = 0.0) -> str:
    """Human-readable per-round summary for the notification message."""
    from adversarial_spec_tpu_torch.debate.parsing import get_critique_summary

    lines = [f"Debate round {result.round_num}:"]
    for r in result.responses:
        if r.error:
            lines.append(f"  ✗ {r.model}: ERROR {r.error}")
        elif r.agreed:
            lines.append(f"  ✓ {r.model}: AGREE")
        else:
            lines.append(
                f"  … {r.model}: {get_critique_summary(r.critique, 120)}"
            )
    lines.append(
        "All models agree!" if result.all_agreed else "Debate continues."
    )
    if total_cost:
        lines.append(f"Cost so far: ${total_cost:.4f}")
    return "\n".join(lines)


def notify_round(
    config: TelegramConfig,
    result,
    total_cost: float = 0.0,
    feedback_timeout: int = 0,
) -> str | None:
    """Send the round summary; optionally poll for human feedback."""
    last_id = get_last_update_id(config) if feedback_timeout > 0 else 0
    send_long_message(config, format_round_summary(result, total_cost))
    if feedback_timeout > 0:
        send_message(
            config,
            f"Reply within {feedback_timeout}s to inject feedback into the "
            "next round.",
        )
        return poll_for_reply(config, last_id, feedback_timeout)
    return None


def _cli(argv: list[str]) -> int:
    """Standalone utility: setup | send | poll | notify (reference :266-439)."""
    if not argv:
        print("usage: telegram {setup|send|poll} ...", file=sys.stderr)
        return 2
    cmd = argv[0]
    if cmd == "setup":
        token = os.environ.get("TELEGRAM_BOT_TOKEN", "").strip()
        if not token:
            print("set TELEGRAM_BOT_TOKEN first", file=sys.stderr)
            return 2
        chat_id = discover_chat_id(token)
        if chat_id is None:
            print(
                "no messages found — send your bot a message, then rerun",
                file=sys.stderr,
            )
            return 1
        print(f"export TELEGRAM_CHAT_ID={chat_id}")
        return 0
    config = get_config()
    if config is None:
        print(
            "error: set TELEGRAM_BOT_TOKEN and TELEGRAM_CHAT_ID",
            file=sys.stderr,
        )
        return 2
    if cmd == "send":
        text = " ".join(argv[1:]) or sys.stdin.read()
        send_long_message(config, text)
        return 0
    if cmd == "poll":
        timeout_s = int(argv[1]) if len(argv) > 1 else 60
        reply = poll_for_reply(config, get_last_update_id(config), timeout_s)
        if reply is None:
            print("(no reply)", file=sys.stderr)
            return 1
        print(reply)
        return 0
    if cmd == "notify":
        # Send a message and (optionally) wait for a reply in one step —
        # the round-notification primitive as a standalone command.
        # First arg is the timeout if numeric; otherwise it's message text
        # and no reply is awaited (mirrors `send`'s calling convention).
        rest = argv[1:]
        timeout_s = 0
        if rest and rest[0].isdigit():
            timeout_s = int(rest[0])
            rest = rest[1:]
        text = " ".join(rest) or sys.stdin.read()
        last_id = get_last_update_id(config) if timeout_s > 0 else 0
        send_long_message(config, text)
        if timeout_s > 0:
            reply = poll_for_reply(config, last_id, timeout_s)
            if reply is None:
                print("(no reply)", file=sys.stderr)
                return 1
            print(reply)
        return 0
    print(f"unknown subcommand {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
