"""Blocking line-JSON client for the serve daemon — the harness half.

Tests and ``chip_smoke.py`` talk to the daemon through this (the
port's copy of the reference's client, which its overload drill and
serve bench use): one unix-socket
connection, requests pipelined freely (the open-loop storm writes its
whole burst before reading a byte), responses collected by request id
until each id's TERMINAL event arrives (serve/protocol.py).
"""

from __future__ import annotations

import socket
import time

from adversarial_spec_tpu_torch.serve import protocol


class ServeClient:
    """One connection to one daemon. Not thread-safe (one harness
    thread per client, like the fleet worker transport)."""

    def __init__(self, socket_path: str, timeout_s: float = 30.0) -> None:
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout_s)
        self.sock.connect(str(socket_path))
        self._buf = b""
        self._seq = 0
        # Events that arrived while waiting for a different id.
        self._pending: dict[str, list[dict]] = {}

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- framing -----------------------------------------------------------

    def send(self, obj: dict) -> str:
        """Write one request line; assigns an id when missing. Returns
        the request id."""
        if not obj.get("id"):
            self._seq += 1
            obj = {**obj, "id": f"c{self._seq:05d}"}
        self.sock.sendall(protocol.encode(obj))
        return obj["id"]

    def recv(self, timeout_s: float | None = None) -> dict | None:
        """Read one event line (None on clean EOF)."""
        if timeout_s is not None:
            self.sock.settimeout(timeout_s)
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return protocol.decode(line)

    # -- request/response --------------------------------------------------

    def collect(self, req_id: str, timeout_s: float = 30.0) -> list[dict]:
        """Every event for ``req_id`` through its terminal event.
        Events for OTHER ids seen along the way are buffered, so
        pipelined requests can be collected in any order."""
        got = self._pending.pop(req_id, [])
        if got and got[-1].get("event") in protocol.TERMINAL_EVENTS:
            return got
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no terminal event for {req_id!r} within {timeout_s}s"
                )
            ev = self.recv(timeout_s=remaining)
            if ev is None:
                raise ConnectionError(
                    f"daemon closed before {req_id!r} resolved"
                )
            eid = ev.get("id", "")
            if eid == req_id:
                got.append(ev)
                if ev.get("event") in protocol.TERMINAL_EVENTS:
                    return got
            else:
                self._pending.setdefault(eid, []).append(ev)

    def call(self, obj: dict, timeout_s: float = 30.0) -> dict:
        """One request, one terminal event (streams discarded into the
        returned list's tail callers can ignore)."""
        req_id = self.send(obj)
        return self.collect(req_id, timeout_s=timeout_s)[-1]

    # -- conveniences ------------------------------------------------------

    def ping(self) -> dict:
        return self.call({"op": "ping"})

    def stats(self) -> dict:
        return self.call({"op": "stats"})

    def check(self) -> dict:
        return self.call({"op": "check"})

    def drain(self) -> dict:
        return self.call({"op": "drain"})

    def refill(self, tenant: str, tokens: int) -> dict:
        return self.call({"op": "refill", "tenant": tenant, "tokens": tokens})

    def submit_debate(
        self,
        spec: str,
        models: list[str],
        *,
        tenant: str = "t0",
        tier: str = "interactive",
        round_num: int = 1,
        session: str | None = None,
        stream: bool = False,
        max_new_tokens: int | None = None,
    ) -> str:
        """Fire-and-forget submit (the open-loop storm's primitive);
        collect the outcome later with ``collect``."""
        obj: dict = {
            "op": "debate",
            "tenant": tenant,
            "tier": tier,
            "spec": spec,
            "models": models,
            "round": round_num,
        }
        if session:
            obj["session"] = session
        if stream:
            obj["stream"] = True
        if max_new_tokens is not None:
            obj["max_new_tokens"] = max_new_tokens
        return self.send(obj)
