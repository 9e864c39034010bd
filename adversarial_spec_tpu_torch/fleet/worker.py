"""Fleet worker: one engine replica as a subprocess.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/worker.py``.

``python -m adversarial_spec_tpu_torch.fleet.worker --replica-id r0`` serves
the line-delimited JSON protocol :class:`fleet.replica.WorkerReplica`
speaks over stdin/stdout:

- ``{"op": "chat", "requests": [...], "params": {...}}`` — serve the
  group ONE REQUEST AT A TIME, writing ``{"i": <n>, "completion":
  {...}}`` the moment each resolves, then ``{"done": true, "served":
  <n>}``. Incremental delivery is the crash contract: a SIGKILL
  mid-batch loses only the unserved remainder, and the router keeps
  every line that landed.
- ``{"op": "ping"}`` → ``{"pong": true}`` — the heartbeat probe.
- ``{"op": "warm", "models": [...]}`` → ``{"warmed": <n>}`` — build
  the engines for the given models (shared-store re-attach + weight-
  residency preload hint) BEFORE the autoscaler admits this replica
  to the ring, so no request ever routes to a cold worker.
- ``{"op": "check"}`` → allocator + tier ``check_invariants`` on the
  worker's engines (the chaos harness's clean-survivor assertion).
- ``{"op": "stats"}`` → per-model serve counts plus the worker's
  prefix-cache / kv-tier accounting (the store-coherent-recovery
  assertion reads ``rehydrated_tokens`` here).
- ``{"op": "validate", "model": ...}`` / ``{"op": "shutdown"}``.

Trace ids ride the wire inside each request (``trace_id``/``span_id``
fields), so every event this process emits resolves back to the round
and opponent that caused it — the replica hop is invisible to causal
tracing.

Disaggregation ops (``--role prefill`` workers are the shipping end
of a cross-replica KV handoff):

- ``{"op": "prefill", "requests": [...], "params": {...}}`` — run
  admission + prefill ONLY, settle the produced blocks to the shared
  store, then write ``{"i": <n>, "result": {"chains": [...],
  "blocks": <b>, ...}}`` per request and a done marker. Each result
  line flushes only AFTER its blocks are durable, so a SIGKILL
  mid-publish loses exactly the unflushed remainder — the
  partial-publish degradation the router handles.
- ``{"op": "prefetch", "model": ..., "chains": [...]}`` →
  ``{"found": <n>}`` — the decode-side hint probe.
- ``{"op": "role"}`` → ``{"role": ...}``.

``ADVSPEC_REPLICA_KILL_AFTER`` is the chaos trigger (mirroring the
journal's ``ADVSPEC_JOURNAL_KILL_AFTER``): ``N`` or
``<replica-id>:N`` SIGKILLs THIS process the instant its N-th
completion line is flushed — a real kill at a deterministic
mid-round point (the replica-kill drill).
``ADVSPEC_PREFILL_KILL_AFTER`` is the same trigger counted on PREFILL
result lines instead (the handoff-kill drill: the
prefill replica dies after its blocks are durable but before the
decode side promotes them).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import traceback

from adversarial_spec_tpu_torch.engine.dispatch import new_engine
from adversarial_spec_tpu_torch.fleet.replica import (
    check_engine_invariants,
    completion_to_wire,
    params_from_wire,
    request_from_wire,
)


def _kill_after(replica_id: str, var: str = "ADVSPEC_REPLICA_KILL_AFTER") -> int:
    """Parse a kill trigger (``N`` arms every worker, ``<id>:N`` arms
    only the named replica). 0 = disarmed."""
    raw = os.environ.get(var, "")
    if not raw:
        return 0
    target, sep, n = raw.rpartition(":")
    if sep and target and target != replica_id:
        return 0
    try:
        return max(0, int(n))
    except ValueError:
        return 0


class _Worker:
    def __init__(self, replica_id: str, out, role: str = "") -> None:
        self.replica_id = replica_id
        self.role = role
        self.out = out
        self._engines: dict[str, object] = {}
        self.served: dict[str, int] = {}
        self._n_served = 0
        self._n_prefilled = 0
        self._kill_after = _kill_after(replica_id)
        self._prefill_kill_after = _kill_after(
            replica_id, "ADVSPEC_PREFILL_KILL_AFTER"
        )

    def _engine_for(self, model: str):
        key = model.partition("://")[0]
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = new_engine(model)
        return eng

    def _write(self, obj: dict) -> None:
        self.out.write(json.dumps(obj, separators=(",", ":")) + "\n")
        self.out.flush()

    def _chat(self, msg: dict) -> None:
        requests = [request_from_wire(r) for r in msg.get("requests", [])]
        params = params_from_wire(msg.get("params") or {})
        for j, req in enumerate(requests):
            try:
                comp = self._engine_for(req.model).chat([req], params)[0]
            except Exception as e:  # a request must not kill the worker
                from adversarial_spec_tpu_torch.engine.types import Completion
                from adversarial_spec_tpu_torch.resilience import faults

                comp = Completion(
                    error=f"{type(e).__name__}: {e}",
                    transient=faults.is_transient(e),
                )
            self.served[req.model] = self.served.get(req.model, 0) + 1
            self._write({"i": j, "completion": completion_to_wire(comp)})
            self._n_served += 1
            if self._kill_after and self._n_served >= self._kill_after:
                # The chaos trigger: die HARD the instant this
                # completion line is durable on the pipe — a real
                # SIGKILL at a reproducible mid-round point.
                os.kill(os.getpid(), signal.SIGKILL)
        self._write({"done": True, "served": self._n_served})

    def _prefill(self, msg: dict) -> None:
        """The handoff's shipping end: prefill each request, settle
        its blocks to the shared store, and only THEN flush the result
        line — every line the other end reads is durable, so the kill
        trigger below produces exactly the durable-then-dead window
        the ``--handoff-kill`` drill needs."""
        requests = [request_from_wire(r) for r in msg.get("requests", [])]
        params = params_from_wire(msg.get("params") or {})
        for j, req in enumerate(requests):
            try:
                out = self._engine_for(req.model).prefill([req], params)[0]
            except Exception as e:  # a request must not kill the worker
                out = {"error": f"{type(e).__name__}: {e}", "chains": []}
            self._write({"i": j, "result": out})
            self._n_prefilled += 1
            if (
                self._prefill_kill_after
                and self._n_prefilled >= self._prefill_kill_after
            ):
                # The handoff chaos trigger: die HARD with this
                # request's blocks durable in the shared store and its
                # result line flushed, before any decode-side adoption.
                os.kill(os.getpid(), signal.SIGKILL)
        self._write({"done": True, "prefilled": self._n_prefilled})

    def _stats(self) -> dict:
        from adversarial_spec_tpu_torch.engine import kvtier, prefix_cache

        return {
            "replica": self.replica_id,
            "role": self.role,
            "pid": os.getpid(),
            "served": dict(self.served),
            "prefix_cache": prefix_cache.snapshot(),
            "kv_tier": kvtier.snapshot(),
        }

    def serve(self, lines) -> int:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                op = msg.get("op")
                if op == "chat":
                    self._chat(msg)
                elif op == "prefill":
                    self._prefill(msg)
                elif op == "prefetch":
                    model = msg.get("model", "")
                    chains = [str(c) for c in msg.get("chains") or []]
                    eng = self._engine_for(model)
                    found = (
                        int(eng.prefetch(chains))
                        if hasattr(eng, "prefetch")
                        else 0
                    )
                    self._write({"found": found})
                elif op == "role":
                    self._write({"role": self.role})
                elif op == "ping":
                    self._write({"pong": True, "replica": self.replica_id})
                elif op == "warm":
                    from adversarial_spec_tpu_torch.engine import weightres

                    models = [str(m) for m in msg.get("models") or []]
                    for model in models:
                        eng = self._engine_for(model)
                        ledger = getattr(eng, "ledger", None)
                        if ledger is not None:
                            ledger.touch(model)
                    weightres.preload_hint(models)
                    self._write({"warmed": len(models)})
                elif op == "validate":
                    model = msg.get("model", "")
                    try:
                        err = self._engine_for(model).validate(model)
                    except ValueError as e:
                        # Unknown provider: a verdict, not a crash.
                        err = str(e)
                    self._write({"error": err})
                elif op == "check":
                    try:
                        for eng in self._engines.values():
                            check_engine_invariants(eng)
                        self._write({"ok": True})
                    except Exception as e:
                        self._write({"ok": False, "error": str(e)})
                elif op == "stats":
                    self._write(self._stats())
                elif op == "shutdown":
                    self._write({"bye": True})
                    return 0
                else:
                    self._write({"error": f"unknown op {op!r}"})
            except BrokenPipeError:
                return 1
            except Exception:
                # Protocol-level failure: report on stderr (the router
                # treats a garbled line as replica death) and keep
                # serving — a worker only exits on shutdown or EOF.
                traceback.print_exc(file=sys.stderr)
                self._write({"error": "internal worker error"})
        return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replica-id", default="r0")
    ap.add_argument(
        "--role",
        default="",
        choices=("", "prefill", "decode"),
        help="disaggregation role this replica serves",
    )
    args = ap.parse_args(argv)
    worker = _Worker(args.replica_id, sys.stdout, role=args.role)
    return worker.serve(sys.stdin)


if __name__ == "__main__":
    sys.exit(main())
