"""Fleet router: prefix-affinity placement + breaker-aware failover.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/router.py``.

The router owns the fleet's three contracts:

- **Placement.** Each request's affinity key (stamped by the debate
  layer: one stable id per debate) consistent-hashes onto a replica
  (fleet/hashring.py), so every round of one debate lands where its
  prefix KV already lives and a membership change moves only ~1/N of
  the keyspace. ``affinity=False`` (the bench's control arm) routes
  round-robin instead.
- **Failover.** Before dispatch the router consults the
  per-(replica, model) circuit breaker
  (``resilience.breaker.replica_key``) — a pair that keeps faulting is
  skipped without a probe until its cooldown. A replica whose
  TRANSPORT dies (:class:`fleet.replica.ReplicaDead`) is retired
  through the one shared surgery (``_retire_replica``: out of the
  ring, transport closed, telemetry) and every unresolved request
  re-routes to the next replica in ring order. Completions that
  arrived before the death are kept — a replica loss re-pays only the
  in-flight remainder.
- **Recovery.** Replicas share the content-addressed disk store
  (engine/kvtier.py), so a failed-over request's prefix rehydrates on
  its new replica instead of re-prefilling; the round journal
  (debate/journal.py) keeps opponents that already COMPLETED from
  ever re-issuing. Both are pinned end to end by the replica-kill
  drill (two worker replicas, one SIGKILLed mid-round).

The chaos injector's ``replica`` seam fires before every group
dispatch: an injected fault there exercises the breaker-skip path
(the replica stays alive; its (replica, model) pairs absorb the
failure) without killing any process.

**Disaggregation** (``prefill_replicas > 0``): the fleet splits into a
PREFILL pool and a DECODE pool (role tags on the hash ring). Ordinary
chat traffic routes decode-side only; an admission whose estimated
prefill tokens clear ``handoff_threshold_tokens`` first runs
admission + prefill on a prefill-role replica, which publishes the
produced KV blocks to the shared disk store and returns the chain
hashes. The decode replica — chosen at the SAME time — receives a
prefetch hint (the chain list) so engine/kvtier.py promotes the
shipped blocks overlapped with the tail of the remote prefill; its
first step starts from a tier hit. A handoff that loses the race
(store miss, partial publish, prefill-replica death) degrades to a
local prefill with byte-identical transcripts — the lifecycle ledger
(fleet/handoff.py) pins every path to exactly one outcome.
"""

from __future__ import annotations

import threading

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.fleet.handoff import HandoffLedger
from adversarial_spec_tpu_torch.fleet.hashring import HashRing
from adversarial_spec_tpu_torch.fleet.replica import (
    InProcessReplica,
    ReplicaDead,
    WorkerReplica,
    spawn_replica,
)
from adversarial_spec_tpu_torch.resilience import breaker as breaker_mod
from adversarial_spec_tpu_torch.resilience import faults as faults_mod
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod
from adversarial_spec_tpu_torch.resilience import injector


class FleetRouter:
    """Routes request groups across replicas; owns the replica
    lifecycle state machine (alive → retired, one-way, through
    ``_retire_replica`` only)."""

    def __init__(
        self,
        replicas,
        *,
        breakers: breaker_mod.BreakerRegistry | None = None,
        affinity: bool = True,
        stats=None,
    ):
        self._replicas = {r.id: r for r in replicas}
        self._ring = HashRing()
        for r in replicas:
            self._ring.add(r.id, getattr(r, "role", ""))
        # Role every ORDINARY chat routes under (None = any replica;
        # "decode" when the fleet is disaggregated — prefill replicas
        # then only ever see the explicit handoff hop).
        self.route_role: str | None = None
        # Retired replicas and why — the lifecycle surgery's ledger,
        # written ONLY by _retire_replica (GL-LIFECYCLE pins this).
        self._dead: dict[str, str] = {}
        # Membership lock: the autoscaler mutates ring membership from
        # its own thread while daemon debate threads walk preference
        # orders mid-submit — ring reads and membership writes both
        # take it (RLock: a locked path may re-enter through the
        # retirement surgery).
        self._mlock = lockdep_mod.make_rlock("FleetRouter._mlock")
        # Per-replica in-flight request counts (submit increments
        # around each dispatch): the scale-in drain watches this reach
        # zero before retiring the victim.
        self._inflight: dict[str, int] = {}
        self._affinity = bool(affinity)
        self._rr = 0  # round-robin cursor (affinity=False control arm)
        self._breakers = (
            breakers if breakers is not None else breaker_mod.default_registry()
        )
        self.stats = stats if stats is not None else fleet_mod.stats
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_replicas_alive.set(len(self._ring))

    # -- membership --------------------------------------------------------

    def alive_ids(self, role: str | None = None) -> list[str]:
        with self._mlock:
            nodes = (
                self._ring.nodes
                if role is None
                else self._ring.role_nodes(role)
            )
            return sorted(nodes)

    def replica(self, rid: str):
        return self._replicas.get(rid)

    def retired_reason(self, rid: str) -> str | None:
        """Why a replica left service (``None`` while alive) — the
        autoscaler's reconciliation reads this when the router retires
        a member behind its back."""
        with self._mlock:
            return self._dead.get(rid)

    def admit_replica(self, rep) -> bool:
        """Ring-change hook for scale-OUT (fleet/autoscale.py): admit
        a replica to the hash ring, making it routable. The caller
        MUST have spawned, pinged, and WARMED it first — between spawn
        and this call the replica is invisible to every routing path
        (the warm-before-ring contract the elasticity tests pin), so
        no request can ever land on a cold replica. Returns False for
        a retired or already-ringed id (idempotent)."""
        rid = rep.id
        with self._mlock:
            if rid in self._dead or rid in self._ring.nodes:
                return False
            self._replicas[rid] = rep
            self._ring.add(rid, getattr(rep, "role", ""))
            alive = len(self._ring)
        if obs_mod.config().enabled:
            obs_mod.hot.replica_op("ready").inc()
            obs_mod.hot.fleet_replicas_alive.set(alive)
        obs_mod.emit(
            obs_mod.ReplicaEvent(replica=rid, op="ready", alive=alive)
        )
        return True

    def drain_replica(self, rid: str) -> bool:
        """Ring-change hook for scale-IN (fleet/autoscale.py): take a
        replica OUT of the ring while its transport stays open — new
        requests route to survivors (and the shared store lets their
        prefixes rehydrate there), in-flight units keep completing on
        the victim. NOT a lifecycle exit: the replica is alive until
        the autoscaler's drain wait finishes and ``_retire_replica``
        runs; a victim that stalls past the drain deadline is retired
        mid-batch and the ReplicaDead-remainder machinery re-routes
        the rest — the planned-handoff half of the drain contract."""
        with self._mlock:
            if rid in self._dead or rid not in self._ring.nodes:
                return False
            self._ring.remove(rid)
            alive = len(self._ring)
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_replicas_alive.set(alive)
        return True

    def inflight(self, rid: str) -> int:
        """Requests currently dispatched to ``rid`` (the scale-in
        drain's wait condition)."""
        with self._mlock:
            return self._inflight.get(rid, 0)

    def affinity_load(self, keys) -> dict[str, int]:
        """How many of the given affinity keys each ROUTABLE replica
        primarily owns — the least-affine victim picker's input (the
        replica owning the fewest active keys loses the least warm
        prefix KV when it leaves the ring)."""
        with self._mlock:
            out: dict[str, int] = {rid: 0 for rid in self._ring.nodes}
            if not out:
                return out
            for key in keys:
                rid = self._ring.primary(str(key))
                if rid in out:
                    out[rid] += 1
            return out

    def _retire_replica(self, rid: str, reason: str) -> None:
        """THE lifecycle surgery: every path that removes a replica
        from service funnels here (transport failure, heartbeat miss,
        planned scale-in, orderly shutdown) — ring membership, the
        dead-ledger, the transport close, and the telemetry stay in
        one place."""
        with self._mlock:
            if rid in self._dead or rid not in self._replicas:
                return
            self._dead[rid] = reason
            self._ring.remove(rid)
            alive = len(self._ring)
        try:
            self._replicas[rid].close()
        except Exception:
            pass  # a dead transport may fail its own close
        self.stats.replicas_retired += 1
        if obs_mod.config().enabled:
            obs_mod.hot.replica_op("retire").inc()
            obs_mod.hot.fleet_replicas_alive.set(alive)
        obs_mod.emit(
            obs_mod.ReplicaEvent(
                replica=rid, op="retire", reason=reason, alive=alive
            )
        )

    def _on_replica_fault(self, rid: str, exc: BaseException) -> None:
        """A replica's transport died mid-service: classify, count,
        retire."""
        faults_mod.record(faults_mod.classify(exc), "replica")
        self._retire_replica(rid, "dead")

    def _heartbeat_failure(self, rid: str) -> None:
        self._retire_replica(rid, "heartbeat")

    def shutdown(self) -> None:
        for rid in self.alive_ids():
            self._retire_replica(rid, "shutdown")
        obs_mod.emit(obs_mod.ReplicaEvent(op="shutdown", alive=0))
        if obs_mod.config().enabled:
            obs_mod.hot.replica_op("shutdown").inc()

    def health_check(self) -> None:
        """One heartbeat round: ping every routable replica; a miss
        drains it (retire + re-route of anything later submitted)."""
        for rid in self.alive_ids():
            rep = self._replicas[rid]
            self.stats.heartbeats += 1
            ok = False
            try:
                ok = rep.ping()
            except Exception:
                ok = False
            if not ok:
                self.stats.heartbeat_failures += 1
                if obs_mod.config().enabled:
                    obs_mod.hot.replica_op("heartbeat_miss").inc()
                obs_mod.emit(
                    obs_mod.ReplicaEvent(
                        replica=rid,
                        op="heartbeat_miss",
                        alive=len(self.alive_ids()),
                    )
                )
                self._heartbeat_failure(rid)

    def check_invariants(self) -> None:
        """Allocator/tier invariants on every routable replica."""
        for rid in self.alive_ids():
            self._replicas[rid].check()

    def replica_stats(self) -> list[dict]:
        return [self._replicas[rid].stats() for rid in self.alive_ids()]

    # -- routing -----------------------------------------------------------

    @staticmethod
    def affinity_key(req: ChatRequest) -> str:
        return req.affinity_key or req.model

    def _choose(
        self, req: ChatRequest, excluded: set[str]
    ) -> tuple[str | None, str, bool]:
        """Pick the replica for one request: (replica id | None,
        route reason, is-affinity-primary). Walks the ring's
        deterministic preference order (or round-robin with affinity
        off), skipping excluded replicas (prior failover hops this
        submit) and open (replica, model) breakers."""
        key = self.affinity_key(req)
        if self._affinity:
            # Under the membership lock: the autoscaler inserts/removes
            # vnode points from its own thread, and a preference walk
            # racing an insort would misread the ring.
            with self._mlock:
                order = self._ring.preference(key, role=self.route_role)
                if not order and self.route_role is not None:
                    # The routed role's pool emptied (every decode
                    # replica died): spill to the other pool rather
                    # than fail — availability beats specialization.
                    order = self._ring.preference(key)
            reason = "affinity"
        else:
            alive = self.alive_ids(role=self.route_role) or self.alive_ids()
            with self._mlock:
                self._rr += 1
                cut = self._rr % len(alive) if alive else 0
            order = alive[cut:] + alive[:cut]
            reason = "random"
        primary = order[0] if order else None
        for rid in order:
            if rid in excluded:
                reason = "failover"
                continue
            if not self._breakers.allow(
                breaker_mod.replica_key(rid, req.model)
            ):
                self.stats.breaker_skips += 1
                reason = "breaker_open"
                continue
            return rid, reason, rid == primary and self._affinity
        return None, reason, False

    def handoff_pair(self, key: str) -> tuple[str | None, str | None]:
        """The (prefill, decode) replica pair ``key`` hashes to — both
        chosen at the SAME time, from the same ring walk, so the
        prefetch hint can race ahead of the remote prefill. ``None``
        entries mean that role's pool is empty."""
        with self._mlock:
            pre = self._ring.preference(key, limit=1, role="prefill")
            dec = self._ring.preference(key, limit=1, role="decode")
        return (pre[0] if pre else None, dec[0] if dec else None)

    def _record_route(
        self, i: int, req: ChatRequest, rid: str, hop: int, reason: str,
        is_primary: bool,
    ) -> None:
        self.stats.routed_requests += 1
        if is_primary:
            self.stats.affinity_hits += 1
        if hop > 0:
            self.stats.failover_hops += 1
        if obs_mod.config().enabled:
            obs_mod.hot.route(reason).inc()
            obs_mod.hot.fleet_affinity_ratio.set(
                round(
                    self.stats.affinity_hits / self.stats.routed_requests, 6
                )
            )
        obs_mod.emit(
            obs_mod.RouteEvent(
                replica=rid,
                req_id=i,
                key=self.affinity_key(req),
                model=req.model,
                hop=hop,
                reason=reason,
                trace_id=req.trace_id,
                span_id=req.span_id,
            )
        )

    def _resolve(
        self, rid: str, i: int, req: ChatRequest, comp: Completion, results
    ) -> None:
        """Finalize one request's completion — exactly once. A second
        completion for an already-resolved request (a zombie replica
        answering after its retirement) is counted and DROPPED: the
        zero-duplicates invariant the chaos harness pins."""
        if results[i] is not None:
            self.stats.duplicated_completions += 1
            return
        results[i] = comp
        self.stats.completed_requests += 1
        pair = breaker_mod.replica_key(rid, req.model)
        if comp.ok:
            self._breakers.record(pair, ok=True)
        else:
            self._breakers.record(
                pair,
                ok=False,
                kind=faults_mod.classify_message(comp.error or ""),
            )

    def submit(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        """Serve one request group across the fleet. Requests sharing
        an affinity primary dispatch as one batch to it; a replica
        death mid-group keeps the completions that landed and re-routes
        only the remainder (hop+1), until every request resolves or no
        routable replica remains."""
        n = len(requests)
        results: list[Completion | None] = [None] * n
        hops = [0] * n
        excluded: list[set[str]] = [set() for _ in range(n)]
        pending = list(range(n))
        while pending:
            assign: dict[str, list[int]] = {}
            for i in pending:
                rid, reason, is_primary = self._choose(
                    requests[i], excluded[i]
                )
                if rid is None:
                    results[i] = Completion(
                        error=(
                            "UNAVAILABLE: fleet has no routable replica "
                            f"for {requests[i].model} "
                            f"({len(self._dead)} retired, "  # graftlint: disable=GL-LOCK-GUARD -- diagnostic count in an error string; a stale read is harmless
                            f"{self.stats.breaker_skips} breaker skip(s))"
                        ),
                        transient=False,
                    )
                    continue
                self._record_route(
                    i, requests[i], rid, hops[i], reason, is_primary
                )
                assign.setdefault(rid, []).append(i)
            pending = []
            for rid, idxs in assign.items():
                rep = self._replicas[rid]
                batch = [requests[i] for i in idxs]
                got: dict[int, Completion] = {}
                wrapped = None
                if consumer is not None:
                    # The consumer speaks the fleet batch's indexing;
                    # remap each sub-batch row back to it.
                    wrapped = (
                        lambda j, text, idxs=idxs: consumer(idxs[j], text)
                    )
                with self._mlock:
                    self._inflight[rid] = (
                        self._inflight.get(rid, 0) + len(idxs)
                    )
                try:
                    # The replica chaos seam: an injected fault here is
                    # a replica-level failure the breakers absorb — the
                    # process stays up, the pair opens, routing drains.
                    injector.fire("replica")
                    rep.chat_batch(
                        batch,
                        params,
                        consumer=wrapped,
                        on_completion=lambda j, c: got.__setitem__(j, c),
                    )
                except ReplicaDead as e:
                    for j, comp in e.partial.items():
                        got.setdefault(j, comp)
                    for j, comp in sorted(got.items()):
                        self._resolve(rid, idxs[j], batch[j], comp, results)
                    self._on_replica_fault(rid, e)
                    for i in idxs:
                        if results[i] is None:
                            excluded[i].add(rid)
                            hops[i] += 1
                            self.stats.reissued_requests += 1
                            pending.append(i)
                    continue
                except injector.InjectedFault as e:
                    kind = faults_mod.classify(e)
                    faults_mod.record(kind, "replica")
                    for i in idxs:
                        self._breakers.record(
                            breaker_mod.replica_key(rid, requests[i].model),
                            ok=False,
                            kind=kind,
                        )
                        excluded[i].add(rid)
                        hops[i] += 1
                        pending.append(i)
                    continue
                finally:
                    with self._mlock:
                        self._inflight[rid] = max(
                            0, self._inflight.get(rid, 0) - len(idxs)
                        )
                for j, comp in sorted(got.items()):
                    self._resolve(rid, idxs[j], batch[j], comp, results)
                for i in idxs:
                    if results[i] is None:
                        # The transport returned without this request's
                        # completion: treat as a failover hop.
                        excluded[i].add(rid)
                        hops[i] += 1
                        self.stats.reissued_requests += 1
                        pending.append(i)
        return results  # type: ignore[return-value]


class FleetEngine:
    """The Engine-protocol face of a replica fleet: ``chat`` routes
    through the fleet router; the debate layer cannot tell it from a
    single engine (grouping, retries, breakers, journaling all work
    unchanged — that is the point)."""

    def __init__(
        self,
        replicas: int = 2,
        transport: str = "inproc",
        request_timeout_s: float = 30.0,
        *,
        engine_factory=None,
        breakers: breaker_mod.BreakerRegistry | None = None,
        affinity: bool = True,
        worker_env: dict | None = None,
        log_dir: str | None = None,
        stats=None,
        prefill_replicas: int = 0,
        handoff_threshold_tokens: int | None = None,
    ):
        n = max(1, int(replicas))
        # Disaggregation: the first P founders take the prefill role,
        # the rest decode; at least one decode replica always remains
        # (P is clamped), and P=0 keeps every node untagged — the
        # symmetric fleet, byte-identical to the pre-disagg topology.
        p = max(0, min(int(prefill_replicas), n - 1))
        built = []
        for k in range(n):
            rid = f"r{k}"
            role = ("prefill" if k < p else "decode") if p else ""
            if transport == "worker":
                rep = WorkerReplica(
                    rid,
                    request_timeout_s=request_timeout_s,
                    env=worker_env,
                    log_dir=log_dir,
                    role=role,
                )
            else:
                rep = InProcessReplica(
                    rid, engine_factory=engine_factory, role=role
                )
            built.append(rep)
            (stats if stats is not None else fleet_mod.stats).replicas_spawned += 1
            if obs_mod.config().enabled:
                obs_mod.hot.replica_op("spawn").inc()
            obs_mod.emit(
                obs_mod.ReplicaEvent(replica=rid, op="spawn", alive=k + 1)
            )
        # Topology parameters kept for elastic growth: the autoscaler's
        # spawn_replica() must build replicas indistinguishable from
        # the founders (same transport, factory, env, timeout).
        self.transport = transport
        self.request_timeout_s = request_timeout_s
        self._engine_factory = engine_factory
        self._worker_env = worker_env
        self._log_dir = log_dir
        self._stats = stats if stats is not None else fleet_mod.stats
        self._next_rid = n
        self.prefill_replicas = p
        self.handoff_threshold_tokens = (
            fleet_mod.config().handoff_threshold_tokens
            if handoff_threshold_tokens is None
            else max(0, int(handoff_threshold_tokens))
        )
        self.handoff = HandoffLedger(stats=stats)
        self.router = FleetRouter(
            built, breakers=breakers, affinity=affinity, stats=stats
        )
        if p:
            # Ordinary chat traffic never lands on a prefill replica.
            self.router.route_role = "decode"

    def reserve_replica_id(self) -> str:
        """Mint the next replica id WITHOUT spawning — the autoscaler
        declares the provisioning state (and emits its ScaleEvent)
        before the first spawn attempt runs."""
        rid = f"r{self._next_rid}"
        self._next_rid += 1
        return rid

    def spawn_replica(
        self,
        rid: str | None = None,
        *,
        role: str = "",
        retries: int = 3,
        backoff_base_s: float = 0.05,
        sleep=None,
        rng=None,
    ):
        """Provision one NEW replica matching this fleet's topology,
        through the bounded-retry spawn hardening
        (:func:`fleet.replica.spawn_replica` — a typed ``SpawnFailed``
        propagates after the retries exhaust). The returned handle is
        NOT routable: the caller must warm it and then admit it via
        ``router.admit_replica`` (the warm-before-ring contract)."""
        import time as _time

        if rid is None:
            rid = self.reserve_replica_id()
        rep = spawn_replica(
            rid,
            self.transport,
            retries=retries,
            backoff_base_s=backoff_base_s,
            sleep=sleep if sleep is not None else _time.sleep,
            rng=rng,
            engine_factory=self._engine_factory,
            request_timeout_s=self.request_timeout_s,
            worker_env=self._worker_env,
            log_dir=self._log_dir,
            role=role,
        )
        self._stats.replicas_spawned += 1
        if obs_mod.config().enabled:
            obs_mod.hot.replica_op("spawn").inc()
        obs_mod.emit(
            obs_mod.ReplicaEvent(
                replica=rid, op="spawn", alive=len(self.router.alive_ids())
            )
        )
        return rep

    # -- disaggregated prefill/decode handoff ------------------------------

    @staticmethod
    def estimate_prefill_tokens(req: ChatRequest) -> int:
        """Estimated prefill tokens for one request — the admission
        threshold's input, on the mock tokenizer's 4-chars-per-token
        scale (system + separator + user)."""
        return (len(req.system) + 1 + len(req.user)) // 4

    def disagg_armed(self) -> bool:
        """Whether a handoff can run right now: the fleet was built
        disaggregated AND both role pools still have routable
        members (a dead prefill pool silently disarms — every
        admission just prefills locally, the degradation contract)."""
        return bool(
            self.prefill_replicas
            and self.router.alive_ids("prefill")
            and self.router.alive_ids("decode")
        )

    def _run_handoff(self, key, batch, req_ids, params, pre_rid, dec_rid):
        """Drive ONE handoff through its lifecycle: remote prefill on
        ``pre_rid`` → publish to the shared store → prefetch hint to
        ``dec_rid``. Every path lands in exactly one ledger exit; a
        lost race degrades (the decode side prefills locally with
        byte-identical output) rather than erroring."""
        self.handoff.begin(key, pre_rid, dec_rid)
        for i, req in zip(req_ids, batch):
            if obs_mod.config().enabled:
                obs_mod.hot.route("prefill").inc()
            obs_mod.emit(
                obs_mod.RouteEvent(
                    replica=pre_rid,
                    req_id=i,
                    key=key,
                    model=req.model,
                    hop=0,
                    reason="prefill",
                    trace_id=req.trace_id,
                    span_id=req.span_id,
                )
            )
        self.handoff.note_prefilling(key)
        rep = self.router.replica(pre_rid)
        try:
            outs = rep.prefill(batch, params)
        except ReplicaDead as e:
            # The prefill replica died mid-publish. Results that hit
            # the wire before death are DURABLE (the worker settles
            # the store before flushing each line): a complete partial
            # set still ships; anything less degrades to local prefill.
            self.router._on_replica_fault(pre_rid, e)
            outs = [e.partial.get(j) for j in range(len(batch))]
            if any(o is None for o in outs):
                self.handoff._degrade(key, "partial_publish")
                return
        except Exception:
            self.handoff._degrade(key, "prefill_error")
            return
        chains: list[str] = []
        seen: set[str] = set()
        blocks = 0
        for o in outs:
            for c in o.get("chains", ()):
                if c not in seen:
                    seen.add(c)
                    chains.append(c)
            blocks += int(o.get("blocks", 0))
        if not chains:
            # Nothing page-aligned to ship (prompt below one KV page).
            self.handoff._abandon(key, "no_blocks")
            return
        self.handoff.note_published(key, chains, blocks)
        dec = self.router.replica(dec_rid)
        try:
            found = dec.prefetch(batch[0].model, chains)
        except ReplicaDead as e:
            self.router._on_replica_fault(dec_rid, e)
            self.handoff._degrade(key, "decode_dead")
            return
        except Exception:
            found = 0
        if found >= len(chains):
            self.handoff._finish_adopt(key)
        else:
            self.handoff._degrade(key, "store_miss")

    def _maybe_handoff(self, requests, params) -> None:
        """The routing split: admissions whose estimated prefill
        clears the threshold run their prefill on a prefill-role
        replica first. Grouped per affinity key — one handoff per
        debate; later rounds ride the shipped prefix through the
        ordinary tier path and never re-handoff."""
        threshold = self.handoff_threshold_tokens
        groups: dict[str, list[int]] = {}
        for i, req in enumerate(requests):
            groups.setdefault(self.router.affinity_key(req), []).append(i)
        for key, idxs in groups.items():
            if self.handoff.seen(key):
                continue
            est = max(
                self.estimate_prefill_tokens(requests[i]) for i in idxs
            )
            if est < threshold:
                continue
            pre_rid, dec_rid = self.router.handoff_pair(key)
            if pre_rid is None or dec_rid is None or pre_rid == dec_rid:
                continue
            self._run_handoff(
                key, [requests[i] for i in idxs], idxs, params,
                pre_rid, dec_rid,
            )

    def chat(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        self.router.health_check()
        if self.disagg_armed():
            self._maybe_handoff(requests, params)
        return self.router.submit(requests, params, consumer=consumer)

    def validate(self, model: str) -> str | None:
        last = f"fleet has no routable replica to validate {model!r}"
        for rid in self.router.alive_ids():
            try:
                return self.router.replica(rid).validate(model)
            except ReplicaDead as e:
                last = str(e)
                continue
        return last

    def shutdown(self) -> None:
        self.router.shutdown()
