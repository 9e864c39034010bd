"""Replica transports: one engine behind one id, in-process or worker.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/replica.py``.

The router (fleet/router.py) speaks to replicas through one tiny
surface — ``chat_batch`` (serve a request group, delivering each
completion the moment it resolves), ``ping`` (health probe),
``check`` (allocator/tier invariants, the chaos harness's survivor
assertion), ``stats`` (per-model serve counts + cache accounting) and
``close``. Two transports implement it:

- :class:`InProcessReplica` — a FRESH engine instance per replica
  (``engine.dispatch.new_engine``, the replica lifecycle seam: the
  process-wide engine cache is exactly what a fleet must NOT share,
  or every "replica" would be the same prefix cache). Deterministic,
  tier-1-testable, and the fleet bench's substrate.
- :class:`WorkerReplica` — one subprocess per replica (``python -m
  adversarial_spec_tpu_torch.fleet.worker``) over a line-delimited JSON
  pipe protocol. The worker serves requests ONE AT A TIME and writes
  each completion line as it finishes, so a SIGKILL mid-batch loses
  only the unserved remainder — the router keeps what already
  arrived and fails the rest over. This is the topology
  replica-kill drill SIGKILLs.

A dead transport raises :class:`ReplicaDead` carrying the completions
that resolved before death (``partial``) — the router's no-work-lost
contract starts here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import subprocess
import sys
import time
from pathlib import Path

from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.resilience.faults import FaultKind

_REPO = Path(__file__).resolve().parent.parent.parent


class ReplicaDead(RuntimeError):
    """The replica's transport died (process gone, pipe closed, or a
    request deadline expired with the worker silent). Carries the
    completions that resolved BEFORE death, keyed by the submitted
    batch's local index — the router keeps them and re-routes only the
    remainder."""

    def __init__(
        self, replica: str, why: str, partial: dict[int, Completion] | None = None
    ):
        super().__init__(f"UNAVAILABLE: replica {replica} {why}")
        self.fault_kind = FaultKind.DEVICE_LOST
        self.seam = "replica"
        self.replica = replica
        self.partial = dict(partial or {})


class SpawnFailed(RuntimeError):
    """Replica provisioning exhausted its bounded retry: every spawn
    attempt either failed outright or came up unable to answer a ping.
    Typed so the autoscaler can COUNT it (stats.spawn_failures) and
    enter cooldown instead of hot-looping on a broken spawn path; the
    replica never existed as far as the ring is concerned."""

    def __init__(self, replica: str, attempts: int, why: str):
        super().__init__(
            f"UNAVAILABLE: replica {replica} failed to spawn after "
            f"{attempts} attempt(s): {why}"
        )
        self.fault_kind = FaultKind.DEVICE_LOST
        self.seam = "replica"
        self.replica = replica
        self.attempts = attempts


# -- wire codec (worker protocol; also reused by the worker itself) --------


def request_to_wire(req: ChatRequest) -> dict:
    return dataclasses.asdict(req)


def request_from_wire(obj: dict) -> ChatRequest:
    known = {f.name for f in dataclasses.fields(ChatRequest)}
    return ChatRequest(**{k: v for k, v in obj.items() if k in known})


def params_to_wire(params: SamplingParams) -> dict:
    return dataclasses.asdict(params)


def params_from_wire(obj: dict) -> SamplingParams:
    known = {f.name for f in dataclasses.fields(SamplingParams)}
    return SamplingParams(**{k: v for k, v in obj.items() if k in known})


def completion_to_wire(comp: Completion) -> dict:
    return {
        "text": comp.text,
        "error": comp.error,
        "transient": bool(comp.transient),
        "cancelled": bool(comp.cancelled),
        "usage": dataclasses.asdict(comp.usage),
    }


def completion_from_wire(obj: dict) -> Completion:
    u = obj.get("usage") or {}
    known = {f.name for f in dataclasses.fields(Usage)}
    return Completion(
        text=obj.get("text", ""),
        error=obj.get("error"),
        transient=bool(obj.get("transient", False)),
        cancelled=bool(obj.get("cancelled", False)),
        usage=Usage(**{k: v for k, v in u.items() if k in known}),
    )


def check_engine_invariants(engine) -> None:
    """Allocator + tier ``check_invariants`` for one replica's engine
    (raises on drift). Duck-typed on the mock engine's accounting
    handles — the chaos topology's replicas are mock workers; a
    ``GpuEngine``'s batcher invariants are pinned by the scheduler
    suite. The serve daemon's ``check`` op walks its engines with this
    same function."""
    alloc = getattr(engine, "_allocator", None)
    if alloc is not None:
        alloc.check_invariants()
    prefix = getattr(engine, "_prefix", None)
    if prefix is not None and getattr(prefix, "tiers", None) is not None:
        prefix.tiers.check_invariants()
    # Weight-residency conservation (engine/weightres.py): both engines
    # expose ``ledger`` (the mock's is None until its simulation arms);
    # the real engine's stricter ledger↔engine mirror rides along.
    if getattr(engine, "ledger", None) is not None:
        if hasattr(engine, "check_residency_invariants"):
            engine.check_residency_invariants()
        else:
            engine.ledger.check_invariants()


class InProcessReplica:
    """A fresh engine instance (per provider) behind a replica id."""

    def __init__(self, replica_id: str, engine_factory=None, role: str = ""):
        self.id = replica_id
        # Disaggregation role ("prefill" / "decode"; "" = any) — the
        # hash ring tags this node with it so role-filtered preference
        # walks keep ordinary traffic off prefill replicas.
        self.role = role
        # The lifecycle seam: fresh engines, NOT dispatch's process-wide
        # cache — each replica must own its allocator/prefix cache.
        if engine_factory is None:
            from adversarial_spec_tpu_torch.engine.dispatch import new_engine

            engine_factory = new_engine
        self._engine_factory = engine_factory
        self._engines: dict[str, object] = {}
        self.served: dict[str, int] = {}  # model -> completions served
        self.busy_s: float = 0.0  # synthetic/real service seconds
        self.closed = False

    def _engine_for(self, model: str):
        key = model.partition("://")[0]
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = self._engine_factory(model)
        return eng

    def ping(self) -> bool:
        return not self.closed

    def warm(self, models: list[str]) -> int:
        """Pre-build the serving state for ``models`` BEFORE the router
        admits this replica to the ring (fleet/autoscale.py warm-before-
        ring contract): engine construction re-attaches the shared
        DiskStore (so prefix KV written by the rest of the fleet
        rehydrates instead of re-prefilling) and the weight-residency
        preload hint (engine/weightres.py) pre-touches the hottest
        models from the scheduler's model mix so the first routed
        request pays no cold load. Returns the models warmed."""
        if self.closed:
            raise ReplicaDead(self.id, "is closed")
        from adversarial_spec_tpu_torch.engine import weightres as weightres_mod

        for model in models:
            eng = self._engine_for(model)
            ledger = getattr(eng, "ledger", None)
            if ledger is not None:
                # Freshen LRU standing for an already-admitted alias;
                # actual admission happens on first serve (the ledger's
                # one admission surgery), which the hint accounts for.
                ledger.touch(model)
        weightres_mod.preload_hint(models)
        return len(models)

    def chat_batch(
        self, requests, params, consumer=None, on_completion=None
    ) -> list[Completion]:
        """Serve the group as ONE batched ``chat`` per provider — the
        engine's batch dimension is the whole design (N co-resident
        opponents are N rows of one sharded decode, engine/types.py),
        and an in-process replica cannot die mid-batch, so there is
        nothing to buy by serializing. Only the WORKER transport serves
        one request at a time: its crash contract needs each completion
        durable on the pipe before the next decodes. Completions are
        delivered through ``on_completion(local_index, completion)``
        after each provider group resolves."""
        if self.closed:
            raise ReplicaDead(self.id, "is closed")
        results: list[Completion | None] = [None] * len(requests)
        by_provider: dict[str, list[int]] = {}
        for j, req in enumerate(requests):
            by_provider.setdefault(
                req.model.partition("://")[0], []
            ).append(j)
        for idxs in by_provider.values():
            engine = self._engine_for(requests[idxs[0]].model)
            wrapped = None
            if consumer is not None:
                # The consumer speaks the ORIGINAL batch's indexing;
                # remap this provider sub-batch's rows back to it.
                wrapped = (
                    lambda row, text, idxs=idxs: consumer(idxs[row], text)
                )
            comps = engine.chat(
                [requests[j] for j in idxs], params, consumer=wrapped
            )
            for row, j in enumerate(idxs):
                comp = comps[row]
                results[j] = comp
                self.served[requests[j].model] = (
                    self.served.get(requests[j].model, 0) + 1
                )
                u = comp.usage
                # Synthetic service seconds on the mock's tokens/1024
                # scale (prefill actually computed + decode produced):
                # the fleet bench's per-replica busy clock.
                self.busy_s += (
                    max(u.input_tokens - u.cached_tokens, 0)
                    + u.output_tokens
                ) / 1024.0
                if on_completion is not None:
                    on_completion(j, comp)
        return results  # type: ignore[return-value]

    def prefill(self, requests, params) -> list[dict]:
        """Disaggregated prefill: run admission + prefill ONLY for the
        group (no decode), publish the produced KV blocks to the
        shared store, and return each request's chain hashes — the
        handoff hint the decode-side replica prefetches against. Per
        provider group, mirroring ``chat_batch``."""
        if self.closed:
            raise ReplicaDead(self.id, "is closed")
        results: list[dict | None] = [None] * len(requests)
        by_provider: dict[str, list[int]] = {}
        for j, req in enumerate(requests):
            by_provider.setdefault(
                req.model.partition("://")[0], []
            ).append(j)
        for idxs in by_provider.values():
            engine = self._engine_for(requests[idxs[0]].model)
            outs = engine.prefill([requests[j] for j in idxs], params)
            for row, j in enumerate(idxs):
                out = outs[row]
                results[j] = out
                # Prefill seconds on the same synthetic tokens/1024
                # clock chat_batch uses (no decode half).
                self.busy_s += max(int(out.get("new_tokens", 0)), 0) / 1024.0
        return results  # type: ignore[return-value]

    def prefetch(self, model: str, chains) -> int:
        """Decode-side handoff hint: probe the shared store for the
        shipped chains (promoting what it can ahead of the adopting
        request). Returns how many of ``chains`` are available."""
        if self.closed:
            raise ReplicaDead(self.id, "is closed")
        engine = self._engine_for(model)
        if hasattr(engine, "prefetch"):
            return int(engine.prefetch(chains))
        return 0

    def validate(self, model: str) -> str | None:
        try:
            return self._engine_for(model).validate(model)
        except ValueError as e:
            # An unknown provider id is a validation VERDICT here, not
            # a crash — the preflight wants the actionable message.
            return str(e)

    def check(self) -> None:
        for eng in self._engines.values():
            check_engine_invariants(eng)

    def stats(self) -> dict:
        return {
            "replica": self.id,
            "role": self.role,
            "served": dict(self.served),
            "busy_s": round(self.busy_s, 6),
        }

    def close(self) -> None:
        self.closed = True
        self._engines.clear()


class WorkerReplica:
    """One subprocess per replica over line-delimited JSON pipes."""

    def __init__(
        self,
        replica_id: str,
        request_timeout_s: float = 30.0,
        env: dict | None = None,
        log_dir: str | None = None,
        role: str = "",
    ):
        self.id = replica_id
        self.role = role
        self.request_timeout_s = float(request_timeout_s)
        self._env = dict(env) if env is not None else None
        self._log_dir = log_dir
        self.closed = False
        self._proc: subprocess.Popen | None = None
        self._log = None
        # Our own receive buffer over the RAW stdout fd. select() only
        # sees bytes still in the kernel pipe — a buffered reader that
        # slurped two back-to-back lines (a completion plus its done
        # marker) would leave the second one invisible to select and
        # stall a healthy replica into a false ReplicaDead, so all
        # reads go through os.read + this buffer, never readline().
        self._rbuf = bytearray()
        self._spawn()

    @property
    def pid(self) -> int | None:
        return self._proc.pid if self._proc is not None else None

    def _spawn(self) -> None:
        env = dict(os.environ if self._env is None else self._env)
        # A worker must never build its own fleet (infinite recursion);
        # it is one replica, full stop.
        env["ADVSPEC_FLEET"] = "0"
        env["PYTHONPATH"] = (
            f"{_REPO}{os.pathsep}{env['PYTHONPATH']}"
            if env.get("PYTHONPATH")
            else str(_REPO)
        )
        stderr = subprocess.DEVNULL
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            # The replica's stderr log: an OS-owned append stream for
            # post-mortems (the chaos drill reads it when a worker
            # misbehaves) — not a torn-write risk, sanctioned in
            # [tool.graftlint] atomic_funcs.
            self._log = open(
                os.path.join(self._log_dir, f"{self.id}.stderr.log"), "w"
            )
            stderr = self._log
        # Binary, unbuffered pipes: the reader below selects on the raw
        # fd and must never race a Python-level buffer (see _rbuf).
        argv = [
            sys.executable,
            "-m",
            "adversarial_spec_tpu_torch.fleet.worker",
            "--replica-id",
            self.id,
        ]
        if self.role:
            argv += ["--role", self.role]
        self._proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=stderr,
            bufsize=0,
            env=env,
        )

    # -- protocol ----------------------------------------------------------

    def _send(self, obj: dict) -> None:
        proc = self._proc
        if self.closed or proc is None or proc.poll() is not None:
            raise ReplicaDead(self.id, "process is gone")
        try:
            proc.stdin.write(
                (json.dumps(obj, separators=(",", ":")) + "\n").encode("utf-8")
            )
            proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ReplicaDead(self.id, f"pipe write failed ({e})") from e

    def _read_line(self, timeout_s: float) -> dict:
        proc = self._proc
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        while True:
            # Serve a complete line from the receive buffer FIRST: the
            # worker writes lines back to back, and bytes already read
            # off the pipe are invisible to select().
            nl = self._rbuf.find(b"\n")
            if nl >= 0:
                raw = bytes(self._rbuf[:nl]).strip()
                del self._rbuf[: nl + 1]
                if not raw:
                    continue
                try:
                    return json.loads(raw.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    raise ReplicaDead(
                        self.id, f"spoke garbage ({e})"
                    ) from e
            wait = (
                max(0.0, deadline - time.monotonic())
                if deadline is not None
                else 1.0
            )
            if deadline is not None and wait <= 0.0:
                raise ReplicaDead(
                    self.id,
                    f"silent past the {timeout_s:.1f}s request deadline",
                )
            ready, _, _ = select.select([proc.stdout], [], [], wait)
            if not ready:
                if proc.poll() is not None:
                    raise ReplicaDead(self.id, "process died mid-request")
                continue
            chunk = os.read(proc.stdout.fileno(), 1 << 16)
            if not chunk:
                raise ReplicaDead(self.id, "closed its pipe mid-request")
            self._rbuf += chunk

    def ping(self, timeout_s: float | None = None) -> bool:
        try:
            self._send({"op": "ping"})
            resp = self._read_line(
                timeout_s if timeout_s is not None else self.request_timeout_s
            )
            return bool(resp.get("pong"))
        except ReplicaDead:
            return False

    def chat_batch(
        self, requests, params, consumer=None, on_completion=None
    ) -> list[Completion]:
        """Serve the group through the worker. The consumer seam does
        not cross the process boundary (per-token callbacks over a
        pipe would serialize the decode) — worker replicas serve the
        blocking path; completions still stream back one line each, so
        a mid-batch death loses only the unserved remainder."""
        self._send(
            {
                "op": "chat",
                "requests": [request_to_wire(r) for r in requests],
                "params": params_to_wire(params),
            }
        )
        got: dict[int, Completion] = {}
        try:
            while len(got) < len(requests):
                obj = self._read_line(self.request_timeout_s)
                if obj.get("done"):
                    break
                j = int(obj.get("i", -1))
                if not 0 <= j < len(requests) or j in got:
                    raise ReplicaDead(
                        self.id, f"answered out of protocol (i={j})", got
                    )
                comp = completion_from_wire(obj.get("completion") or {})
                got[j] = comp
                if on_completion is not None:
                    on_completion(j, comp)
            if len(got) == len(requests):
                # Drain the done marker so the pipe stays aligned.
                obj = self._read_line(self.request_timeout_s)
                if not obj.get("done"):
                    raise ReplicaDead(
                        self.id, "missed its done marker", got
                    )
            else:
                raise ReplicaDead(
                    self.id,
                    f"finished early ({len(got)}/{len(requests)})",
                    got,
                )
        except ReplicaDead as e:
            if not e.partial:
                e.partial = dict(got)
            raise
        return [got[j] for j in range(len(requests))]

    def prefill(self, requests, params) -> list[dict]:
        """Disaggregated prefill through the worker (``prefill`` op).
        The worker settles each request's blocks to the shared store
        BEFORE flushing its result line, so every result that arrives
        here is durable — a SIGKILL mid-publish loses only the
        unflushed remainder, which the ReplicaDead ``partial`` carries
        back for the partial-publish degradation decision."""
        self._send(
            {
                "op": "prefill",
                "requests": [request_to_wire(r) for r in requests],
                "params": params_to_wire(params),
            }
        )
        got: dict[int, dict] = {}
        try:
            while len(got) < len(requests):
                obj = self._read_line(self.request_timeout_s)
                if obj.get("done"):
                    break
                j = int(obj.get("i", -1))
                if not 0 <= j < len(requests) or j in got:
                    raise ReplicaDead(
                        self.id, f"answered out of protocol (i={j})", got
                    )
                got[j] = dict(obj.get("result") or {})
            if len(got) == len(requests):
                obj = self._read_line(self.request_timeout_s)
                if not obj.get("done"):
                    raise ReplicaDead(
                        self.id, "missed its done marker", got
                    )
            else:
                raise ReplicaDead(
                    self.id,
                    f"finished early ({len(got)}/{len(requests)})",
                    got,
                )
        except ReplicaDead as e:
            if not e.partial:
                e.partial = dict(got)
            raise
        return [got[j] for j in range(len(requests))]

    def prefetch(self, model: str, chains) -> int:
        """Decode-side handoff hint through the worker (``prefetch``
        op): how many shipped chains its shared store can serve."""
        self._send(
            {"op": "prefetch", "model": model, "chains": list(chains)}
        )
        resp = self._read_line(self.request_timeout_s)
        return int(resp.get("found", 0))

    def warm(self, models: list[str]) -> int:
        """Worker-side warm (fleet/worker.py ``warm`` op): the worker
        builds its engines for ``models`` — shared-store re-attach plus
        the weight-residency preload hint — before this replica is ever
        routable. Raises ReplicaDead if the worker dies mid-warm; the
        autoscaler decommissions it without it ever entering the ring."""
        self._send({"op": "warm", "models": list(models)})
        resp = self._read_line(self.request_timeout_s)
        return int(resp.get("warmed", 0))

    def validate(self, model: str) -> str | None:
        self._send({"op": "validate", "model": model})
        resp = self._read_line(self.request_timeout_s)
        return resp.get("error")

    def check(self) -> None:
        self._send({"op": "check"})
        resp = self._read_line(self.request_timeout_s)
        if not resp.get("ok"):
            raise RuntimeError(
                f"replica {self.id} invariants violated: {resp.get('error')}"
            )

    def stats(self) -> dict:
        self._send({"op": "stats"})
        return self._read_line(self.request_timeout_s)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        proc = self._proc
        if proc is not None:
            try:
                if proc.poll() is None:
                    proc.stdin.write(b'{"op":"shutdown"}\n')
                    proc.stdin.flush()
                    proc.wait(timeout=2.0)
            except (BrokenPipeError, OSError, ValueError, subprocess.TimeoutExpired):
                pass
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5.0)
            for stream in (proc.stdin, proc.stdout):
                try:
                    if stream is not None:
                        stream.close()
                except OSError:
                    pass
        if self._log is not None:
            self._log.close()
            self._log = None


def spawn_replica(
    replica_id: str,
    transport: str = "inproc",
    *,
    retries: int = 3,
    backoff_base_s: float = 0.05,
    sleep=time.sleep,
    rng=None,
    engine_factory=None,
    request_timeout_s: float = 30.0,
    worker_env: dict | None = None,
    log_dir: str | None = None,
    role: str = "",
):
    """Provision one replica with BOUNDED retry: each attempt spawns
    the transport and requires a ping answer; a failed attempt is torn
    down and retried after a jittered exponential backoff
    (``backoff_base_s * 2^k * (0.5 + U[0,1))`` — the jitter keeps N
    autoscalers from stampeding a recovering host). After ``retries``
    extra attempts the typed :class:`SpawnFailed` propagates — the
    caller counts it and enters cooldown; this helper NEVER loops
    unbounded. ``sleep``/``rng`` are injectable for deterministic
    tests."""
    if rng is None:
        import random

        rng = random.random
    last_why = "never attempted"
    attempts = max(1, int(retries) + 1)
    for attempt in range(attempts):
        if attempt:
            sleep(backoff_base_s * (2 ** (attempt - 1)) * (0.5 + rng()))
        rep = None
        try:
            if transport == "worker":
                rep = WorkerReplica(
                    replica_id,
                    request_timeout_s=request_timeout_s,
                    env=worker_env,
                    log_dir=log_dir,
                    role=role,
                )
            else:
                rep = InProcessReplica(
                    replica_id, engine_factory=engine_factory, role=role
                )
            if not rep.ping():
                raise ReplicaDead(replica_id, "never answered its ping")
            return rep
        except (ReplicaDead, OSError) as e:
            last_why = str(e)
            if rep is not None:
                try:
                    rep.close()
                except Exception:
                    pass
    raise SpawnFailed(replica_id, attempts, last_why)
