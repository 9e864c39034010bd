"""The ``advspec serve`` daemon: asyncio front, threaded debate core.

Topology (one process):

- the **asyncio loop** owns the unix socket, connection framing,
  admission decisions (fast, never blocked by the engine), and event
  fan-out back to clients;
- each accepted debate runs ``serve.driver.run_debate`` on a bounded
  **worker-thread pool** (the round driver blocks on engine results by
  design — see serve/gate.py);
- the one **engine pump thread** executes fair-order unit batches on
  the real engine.

Graceful drain (the SIGTERM contract docs/serving.md documents):

1. SIGTERM (or the ``drain`` op) → admissions close; every new
   ``debate`` answers with a typed ``draining`` shed. Dispatch
   CONTINUES.
2. In-flight debates get ``drain_deadline_s`` to finish normally
   (their completions keep journal-committing as they resolve).
3. At the deadline, queued units shed (typed, journal-resumable) and
   running units cancel through the stream-consumer seam — the same
   ``_release_slot`` surgery as every other release, so nothing
   leaks.
4. The daemon writes a drain report (stdout line + optional
   ``--drain-report`` file via the atomic-write discipline) and exits
   0. The round journal makes even a post-deadline SIGKILL lossless
   for accepted work: completed opponents are durable the moment they
   resolve.

The port's copy of ``adversarial_spec_tpu/serve/daemon.py``.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.serve import driver, gate, protocol
from adversarial_spec_tpu_torch.serve.gate import EnginePump
from adversarial_spec_tpu_torch.serve.sched import ServeScheduler


# asyncio's default StreamReader limit is 64 KiB; a debate request
# carries its whole spec inline on one line, and real specs are bigger
# than that. 16 MiB bounds a hostile line without dropping good
# clients (reader overruns answer with a typed error, not a
# disconnect).
_LINE_LIMIT = 16 * 1024 * 1024

# Per-connection transport write-buffer high-water mark past which
# best-effort ``stream`` events are SKIPPED for a non-reading client.
# Lossless by construction: every delivery carries the text-so-far (a
# superset of all earlier ones), so the next delivery the client does
# read includes everything skipped — while results/sheds are never
# dropped. Without this, an open-loop storm with stream=True would
# buffer O(n^2) bytes per opponent in the daemon: collapse-by-OOM in
# exactly the overload regime the daemon exists to survive.
_STREAM_BUFFER_HIGH_WATER = 256 * 1024


class ServeDaemon:
    """One serving instance: socket, scheduler, pump, drain machine."""

    def __init__(
        self,
        socket_path: str,
        *,
        sessions_dir: str | None = None,
        drain_report_path: str | None = None,
        report_stdout: bool = False,
    ) -> None:
        self.socket_path = str(socket_path)
        self.sessions_dir = Path(sessions_dir) if sessions_dir else None
        self.drain_report_path = drain_report_path
        # The CLI daemon prints the drain report as its final stdout
        # line (the drills parse it); in-process harness daemons keep
        # stdout clean (bench prints exactly ONE JSON line) and read
        # ``drain_report`` directly.
        self.report_stdout = report_stdout
        self.sched = ServeScheduler()
        self.pump = EnginePump(self.sched)
        self.executor = ThreadPoolExecutor(
            max_workers=serve_mod.config().max_debates_in_flight,
            thread_name_prefix="advspec-serve-debate",
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._debate_seq = 0
        self._inflight: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()
        self._draining = False
        self._drain_reason = ""
        self._done = asyncio.Event()
        self._t_start = time.monotonic()
        self.drain_report: dict | None = None
        # Built in run() when the fleet is armed with autoscale on:
        # the elasticity control loop (fleet/autoscale.py).
        self.autoscaler = None

    # -- lifecycle ---------------------------------------------------------

    async def run(self, ready: threading.Event | None = None) -> int:
        """Serve until drained. Returns 0 on a clean drain (the CLI's
        exit code)."""
        self._loop = asyncio.get_running_loop()
        self._done = asyncio.Event()
        gate.install(self.sched)
        self.pump.start()
        if fleet_mod.armed() and fleet_mod.config().autoscale:
            from adversarial_spec_tpu_torch.fleet.autoscale import Autoscaler

            self.autoscaler = Autoscaler(fleet_mod.fleet_engine(), self.sched)
            # Couple admission capacity to LIVE membership: scale-out
            # stretches the backlog ceiling and brownout thresholds,
            # so the fleet grows BEFORE the scheduler sheds.
            self.sched.set_capacity_provider(self.autoscaler.capacity_factor)
            self.autoscaler.start()
        try:
            self._loop.add_signal_handler(
                signal.SIGTERM, self.begin_drain, "sigterm"
            )
            self._loop.add_signal_handler(
                signal.SIGINT, self.begin_drain, "sigint"
            )
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # non-main-thread loops (tests) drain via the op
        server = await asyncio.start_unix_server(
            self._on_connection, path=self.socket_path, limit=_LINE_LIMIT
        )
        if ready is not None:
            ready.set()
        try:
            await self._done.wait()
        finally:
            server.close()
            await server.wait_closed()
            # Shutdown ORDER matters (the drain drill's backlog case:
            # more accepted debates than worker threads). stop() first:
            # it force-drains the queues AND makes every later
            # submit_units resolve drained-on-arrival, so executor-
            # queued debates that start from here unwind immediately
            # instead of blocking forever on a queue nobody serves.
            # Only then wait the executor out, and uninstall the gate
            # LAST — a debate thread must never reach the raw
            # (single-threaded) engine ungated. The autoscaler stops
            # FIRST: no membership change may race the teardown (its
            # shutdown only touches mid-transition replicas; serving
            # founders belong to the fleet engine).
            if self.autoscaler is not None:
                self.autoscaler.shutdown()
            self.sched.stop()
            self.pump.join(timeout=5.0)
            self.executor.shutdown(wait=True)
            gate.uninstall()
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        self._write_drain_report()
        return 0

    def begin_drain(self, reason: str = "drain") -> None:
        """Stop admissions and schedule the deadline task (idempotent;
        callable from signal handlers and the ``drain`` op alike)."""
        if self._draining:
            return
        self._draining = True
        self._drain_reason = reason
        if self.autoscaler is not None:
            self.autoscaler.begin_drain()
        self.sched.begin_drain()
        for w in list(self._writers):
            self._send(w, {"id": "", "event": "draining", "reason": reason})
        assert self._loop is not None
        task = self._loop.create_task(self._drain_task())
        task.add_done_callback(lambda _t: None)

    async def _drain_task(self) -> None:
        cfg = serve_mod.config()
        deadline = time.monotonic() + cfg.drain_deadline_s
        while self._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        drained_units = 0
        if self._inflight:
            drained_units = self.sched.force_drain()
        # The forced errors resolve fast; give the debate threads a
        # bounded grace to unwind before reporting.
        hard = time.monotonic() + 5.0
        while self._inflight and time.monotonic() < hard:
            await asyncio.sleep(0.02)
        snap = serve_mod.snapshot()
        self.drain_report = {
            "event": "drain_report",
            "reason": self._drain_reason,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "drained_units_at_deadline": drained_units,
            "inflight_at_exit": len(self._inflight),
            "clean_exit": not self._inflight,
            "stats": snap,
            "scheduler": self.sched.state_snapshot(),
        }
        self._done.set()

    def _write_drain_report(self) -> None:
        report = self.drain_report or {
            "event": "drain_report",
            "reason": self._drain_reason or "stopped",
            "clean_exit": True,
            "stats": serve_mod.snapshot(),
        }
        line = json.dumps(report, separators=(",", ":"), sort_keys=True)
        if self.report_stdout:
            print(line, flush=True)
        if self.drain_report_path:
            obs_mod.atomic_write_text(self.drain_report_path, line + "\n")
        # The daemon's end-of-serve event dump (the critique action's
        # end-of-round discipline): when --events-out is armed, the
        # flight recorder's ring — serve lifecycle transitions, step
        # stream, spans — lands as JSONL (the reference's
        # tools/obs_dump.py reads the same schema).
        events_out = obs_mod.config().events_out
        if events_out:
            obs_mod.dump_events(events_out)

    # -- connection handling -----------------------------------------------

    def _send(self, writer: asyncio.StreamWriter, obj: dict) -> None:
        if writer.is_closing():
            return
        if obj.get("event") == "stream":
            # Best-effort deliveries are skipped for a client that is
            # not reading (see _STREAM_BUFFER_HIGH_WATER): each stream
            # event is the text-so-far, so the next one it reads
            # carries everything skipped. Terminal events always send.
            try:
                buffered = writer.transport.get_write_buffer_size()
            except (AttributeError, RuntimeError):
                buffered = 0
            if buffered > _STREAM_BUFFER_HIGH_WATER:
                return
        try:
            writer.write(protocol.encode(obj))
        except (ConnectionError, RuntimeError):
            pass

    def _send_threadsafe(self, writer: asyncio.StreamWriter, obj: dict) -> None:
        """Event fan-out from debate/pump threads: hop to the loop."""
        assert self._loop is not None
        try:
            self._loop.call_soon_threadsafe(self._send, writer, obj)
        except RuntimeError:
            pass  # loop already closed mid-drain

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    line = await reader.readline()
                except ConnectionError:
                    break
                except (ValueError, asyncio.LimitOverrunError):
                    # A line past _LINE_LIMIT (StreamReader surfaces
                    # the overrun as ValueError): answer typed, then
                    # close — the stream is mid-line and cannot be
                    # re-framed.
                    self._send(
                        writer,
                        protocol.error_event(
                            "",
                            [f"request line exceeds {_LINE_LIMIT} bytes"],
                        ),
                    )
                    break
                if not line:
                    break
                obj = protocol.decode(line)
                if obj is None:
                    self._send(
                        writer, protocol.error_event("", ["not JSON"])
                    )
                    continue
                problems = protocol.validate_request(obj)
                if problems:
                    self._send(
                        writer,
                        protocol.error_event(
                            str(obj.get("id") or ""), problems
                        ),
                    )
                    continue
                self._dispatch_op(obj, writer)
                await writer.drain()
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except RuntimeError:
                pass

    def _dispatch_op(self, obj: dict, writer: asyncio.StreamWriter) -> None:
        op, req_id = obj["op"], obj["id"]
        if op == "ping":
            self._send(
                writer,
                {
                    "id": req_id,
                    "event": "pong",
                    "draining": self._draining,
                    "protocol": protocol.PROTOCOL_VERSION,
                },
            )
        elif op == "stats":
            self._send(
                writer,
                {
                    "id": req_id,
                    "event": "stats",
                    "serve": serve_mod.snapshot(),
                    "scheduler": self.sched.state_snapshot(),
                    # The admission ledger's live view — backlog tokens,
                    # brownout, capacity — so external scrapers see the
                    # same pressure the scheduler sheds on.
                    "pressure": self.sched.pressure_snapshot(),
                    "uptime_s": round(time.monotonic() - self._t_start, 3),
                },
            )
        elif op == "check":
            self._send(writer, self._check_event(req_id))
        elif op == "refill":
            remaining = self.sched.refill_quota(
                obj["tenant"], int(obj["tokens"])
            )
            self._send(
                writer,
                {
                    "id": req_id,
                    "event": "ok",
                    "tenant": obj["tenant"],
                    "quota_remaining": remaining,
                },
            )
        elif op == "drain":
            self.begin_drain("drain_op")
            self._send(writer, {"id": req_id, "event": "ok"})
        elif op == "debate":
            self._handle_debate(obj, writer)

    def _check_event(self, req_id: str) -> dict:
        """Allocator/tier invariants across every live inner engine —
        the chaos drill's clean-survivor probe. ONE implementation of
        the walk, shared with the fleet worker's ``check`` op
        (fleet/replica.py check_engine_invariants) so the two probes
        can never drift."""
        from adversarial_spec_tpu_torch.engine import dispatch
        from adversarial_spec_tpu_torch.fleet.replica import check_engine_invariants

        problems: list[str] = []
        checked = 0
        for eng in dispatch.cached_engines():
            checked += 1
            try:
                check_engine_invariants(eng)
            except Exception as e:
                problems.append(f"{type(eng).__name__}: {e}")
        return {
            "id": req_id,
            "event": "check",
            "checked": checked,
            "ok": not problems,
            "problems": problems,
        }

    def _handle_debate(self, obj: dict, writer: asyncio.StreamWriter) -> None:
        req_id = obj["id"]
        self._debate_seq += 1
        debate_id = f"d{self._debate_seq:05d}"
        accept_t = time.monotonic()
        est = driver.estimate_debate_tokens(obj)
        shed = self.sched.try_admit(
            obj["tenant"],
            obj.get("tier", "interactive"),
            debate_id,
            est,
            models=obj.get("models") or (),
            prefill_tokens=driver.estimate_debate_prefill_tokens(obj),
            arrival_s=obs_mod.arrival_now(),
        )
        if shed is not None:
            self._send(
                writer,
                protocol.shed_event(
                    req_id, shed.reason, shed.retry_after_s, shed.message
                ),
            )
            return
        self._send(
            writer,
            {
                "id": req_id,
                "event": "accepted",
                "debate": debate_id,
                "est_tokens": est,
            },
        )
        on_stream = None
        if obj.get("stream"):
            def on_stream(index: int, text: str, _w=writer, _id=req_id):
                self._send_threadsafe(
                    _w,
                    {
                        "id": _id,
                        "event": "stream",
                        "index": index,
                        "text": text,
                    },
                )
        assert self._loop is not None
        task = self._loop.create_task(
            self._await_debate(
                req_id, debate_id, obj, writer, on_stream, accept_t
            )
        )
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _await_debate(
        self, req_id, debate_id, obj, writer, on_stream, accept_t
    ) -> None:
        assert self._loop is not None
        try:
            payload = await self._loop.run_in_executor(
                self.executor,
                lambda: driver.run_debate(
                    obj,
                    self.sched,
                    debate_id=debate_id,
                    journal_dir=self.sessions_dir,
                    on_stream=on_stream,
                    accept_t=accept_t,
                ),
            )
            payload = {"id": req_id, "event": "result", **payload}
        except Exception as e:  # a broken debate must not kill the daemon
            self.sched.finish_debate(debate_id)  # release the reservation
            payload = {
                "id": req_id,
                "event": "result",
                "error": f"{type(e).__name__}: {e}",
                "results": [],
            }
        self._send(writer, payload)
        try:
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass


def run_daemon(
    socket_path: str,
    *,
    sessions_dir: str | None = None,
    drain_report_path: str | None = None,
) -> int:
    """Blocking entry: serve on ``socket_path`` until drained."""
    daemon = ServeDaemon(
        socket_path,
        sessions_dir=sessions_dir,
        drain_report_path=drain_report_path,
        report_stdout=True,
    )
    return asyncio.run(daemon.run())
