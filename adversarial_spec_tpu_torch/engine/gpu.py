"""The ``tpu://`` provider served by PyTorch on one GPU, or on a mesh of
them: ``GpuEngine``.

Counterpart of ``adversarial_spec_tpu/engine/tpu.py:TpuEngine``: requests
are grouped by model alias, each group's prompts are templated, encoded
and trimmed, and the group is served by one of two paths, as the
reference routes them:

- dense specs (the registry default): the rows of one ``generate()``
  call;
- single-device ``kv="paged"`` specs: the continuous batcher
  (``engine/scheduler.py``) through ``_chat_continuous`` — opponent pools
  larger than the slot count, early-EOS rows freeing their pages
  mid-round, the cross-round prefix cache (the model keeps its batcher, so
  round R+1 adopts round R's blocks) and streaming consumers with early
  cancel.

Per-row ``Usage`` is attributed exactly as the reference does. Failures
are captured into ``Completion.error`` per group, never raised.

Weight-quantized specs (``quant="int8"`` / ``"int4"``) are served on both
paths: the weights are quantized at load (``engine/loader.py``) and every
projection and the head run the dequant-matmul kernels B5/B6
(``ops/quant_matmul.py``). An int8 KV cache (``kv_dtype="int8"``, with or
without ``quant``) is served on both paths too: ``generate()``'s dense
cache and the batcher's page pool store int8 K/V with per-(token, head)
scales, read by the int8-KV variants of B1-B4.

Weights come from ``_materialize``, as the reference's do: a
``random`` checkpoint is a synthetic init; an HF safetensors directory is
read from the port's native cache (``engine/checkpoint.py``) when one
matches, else converted (``engine/loader.py``) and then cached. The
``checkpoint_load`` chaos seam fires there.

Models stay resident under a byte budget of the device's memory
(``hbm_budget_bytes``), as the reference's do: an evicted model demotes
its weights to pinned host memory (``engine/weightres.py``'s ledger,
``--weight-res``/``--weight-host-mb``) and promotes back with one
host→device copy; groups whose weights are resident serve first; and
the next group's weights load or promote on a background thread (a side
CUDA stream, joined by an event) while the current group decodes. Each
resident model keeps its own batcher and prefix cache; a demoted model's
batcher is freed with its KV pool. An HF alias's ``tokenizer.json`` is
read by the port's own reader (``engine/tokenizer_json.py``), which
refuses by name a component it does not implement, before any weights
load.

The batcher contains faults as the reference's does: a fault at one
slot (an injected chaos fault, an out-of-memory error, a per-request
deadline, ``SamplingParams.request_deadline_s``) evicts that row only,
which comes back as its own errored (and, when transient, retryable)
completion; only a fault the batcher cannot isolate (a CUDA error that
poisons the context) drops the model's batcher and fails the group. The
``generate`` chaos seam fires after the load, before the group is
served. Paged specs carry the reference's KV tiers (``engine/kvtier.py``)
on their batcher.

A spec's mesh is built over the engine's device list (``devices``,
default every visible card, the counterpart of ``jax.devices()``; a
device may repeat, a virtual mesh) by the reference's rules
(``parallel/mesh.py``): ``{"tp": 2}`` on 8 devices is dp=4 × tp=2, and
``{"sp": 4}`` on 4 devices one sp group of four. A multi-device mesh
places each leaf in its shards as it is read (``parallel/sharding.py``;
weights are replicated over sp, one copy per physical device), counts
one device's shard against the byte budget, demotes and promotes every
shard (restoring the layout), and is served by ``generate(mesh=...)`` —
a paged spec too, never the batcher, as the reference routes it: an sp
axis prefills through the ring (``parallel/sp.py``). A tp that does not
divide the model's KV heads fails as the reference's ``TpuEngine``
fails it: the weights load, and the dense cache's placement raises a
``ValueError`` ("implies that array axis 2 is partitioned ..."; a paged
spec warns first and falls back to the dense cache), which every row of
the group carries. A ``kv_dtype`` other than ``""`` or ``"int8"`` is an
error.

Every failure is classified as the reference's ``TpuEngine`` classifies
it (``resilience.faults.classify``): the kind sets
``Completion.transient`` and is counted at the injected fault's own seam,
else at ``generate``.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import torch

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine import checkpoint as ckpt_mod
from adversarial_spec_tpu_torch.engine import interleave as interleave_mod
from adversarial_spec_tpu_torch.engine import kvtier as kvtier_mod
from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine import registry as registry_mod
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine import weightres as weightres_mod
from adversarial_spec_tpu_torch.engine.generate import (
    MIN_BUCKET,
    bucket_length,
    generate,
)
from adversarial_spec_tpu_torch.engine.loader import materialize_params
from adversarial_spec_tpu_torch.engine.registry import ModelSpec
from adversarial_spec_tpu_torch.engine.scheduler import (
    ContinuousBatcher,
    SchedRequest,
)
from adversarial_spec_tpu_torch.engine.tokenizer import (
    apply_chat_template,
    load_tokenizer,
)
from adversarial_spec_tpu_torch.engine.types import (
    ChatRequest,
    Completion,
    SamplingParams,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig, get_config
from adversarial_spec_tpu_torch.models.transformer import (
    check_kv_dtype,
    leaves,
    map_params,
)
from adversarial_spec_tpu_torch.parallel import mesh as mesh_mod
from adversarial_spec_tpu_torch.parallel import sharding as sharding_mod
from adversarial_spec_tpu_torch.parallel.mesh import Mesh
from adversarial_spec_tpu_torch.resilience import faults, injector
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod
from adversarial_spec_tpu_torch.utils.device import resolve_device

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}
_GIB = 1 << 30


def _trim_prompt(ids: list[int], limit: int) -> list[int]:
    """Trim to ``limit`` tokens keeping the first token (BOS/template
    head) and the most recent tail."""
    if limit > 0 and len(ids) > limit:
        return ids[:1] + ids[len(ids) - (limit - 1) :]
    return ids


def fits_batcher(cfg: ModelConfig, max_new_tokens: int) -> bool:
    """True when a bucketed prompt still fits beside the budget — the
    reference's gate for serving a paged spec through the batcher."""
    return cfg.max_seq_len - max_new_tokens >= MIN_BUCKET


def hbm_budget_bytes(device: torch.device | None = None) -> int:
    """Byte budget for resident model weights on the device.

    Residency is budgeted in bytes, not models: two 8B bf16 models are
    ~32 GB, and a pool of mixed families must fit beside its KV caches.
    The budget is the device's total memory (16 GiB where there is no
    CUDA device, e.g. the CPU) times a 0.75 headroom factor, the reserve
    covering KV caches, activations and the transient peak of a swap.
    ``ADVSPEC_HBM_BUDGET_BYTES`` overrides it (read per decision, so
    tests and operators can retune a live engine)."""
    env = os.environ.get("ADVSPEC_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    limit = 0
    if device is not None and device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    return int((limit or 16 * _GIB) * 0.75)


def param_bytes(params) -> int:
    """Bytes the params occupy (quantized leaves at their stored size);
    on a mesh, every distinct shard's."""
    return sum(t.numel() * t.element_size() for t in leaves(params))


def estimate_param_bytes(spec: ModelSpec, mesh: Mesh | None = None) -> int:
    """Bytes ``spec``'s params WILL occupy on one device, before loading:
    the layout the loader builds (quantized leaves, the transposed head of
    tied embeddings); on ``mesh``, the most any one device will hold of
    the shards the rules give it (``sharding.per_chip_bytes``: the
    reference's per-chip estimate on distinct cards, every shard on a
    virtual mesh's shared device) — no memory is touched."""
    cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
    t_head = cfg.tied_embeddings and (
        spec.checkpoint == "random" or ckpt_mod.transposed_head_flag()
    )
    lay = ckpt_mod.layout(
        cfg, _DTYPES.get(spec.dtype, torch.bfloat16), spec.quant, t_head
    )
    if mesh is not None and mesh.size > 1:
        return sharding_mod.per_chip_bytes(
            ((tuple(name.split(".")), shape, dt.itemsize) for name, (dt, shape) in lay.items()),
            mesh,
        )
    return sum(math.prod(shape) * dt.itemsize for dt, shape in lay.values())


class HostArena:
    """One flat host buffer that holds a demoted model's leaves, page-locked
    with ``cudaHostRegister`` when they come from the GPU. It is the
    model's size (the caching host allocator rounds each block up to a
    power of two), its pages are faulted in by a parallel zero-fill before
    they are locked, and the engine reuses it for later demotions: a fresh
    buffer gets pages only as fast as the host frees memory. If the
    registration fails the buffer stays pageable: copies are then
    synchronous, and still right."""

    ALIGN = 256

    def __init__(self, nbytes: int, pin: bool):
        self.buf = torch.zeros(nbytes, dtype=torch.uint8)
        self.pinned = False
        if pin and nbytes:
            err = torch.cuda.cudart().cudaHostRegister(self.buf.data_ptr(), nbytes, 0)
            self.pinned = int(err) == 0
        self._used = 0

    @property
    def nbytes(self) -> int:
        return self.buf.numel()

    def reset(self) -> None:
        """Reuse the buffer for another model (its old views are dead)."""
        self._used = 0

    @classmethod
    def size_of(cls, t: torch.Tensor) -> int:
        n = t.numel() * t.element_size()
        return -(-n // cls.ALIGN) * cls.ALIGN

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """A view of the buffer shaped and typed as ``t``."""
        n = t.numel() * t.element_size()
        view = self.buf[self._used : self._used + n].view(t.dtype).view(t.shape)
        self._used += self.size_of(t)
        return view

    def __del__(self) -> None:
        if self.pinned:
            try:
                torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            except Exception:
                pass  # interpreter teardown: the process frees it


@dataclass
class HostWeights:
    """A demoted model's weights in host memory (views of one
    ``HostArena``) and what re-activates it: the weight ledger's opaque
    payload (``engine/weightres.py``). Quantized leaves stay quantized."""

    spec: ModelSpec
    cfg: ModelConfig
    tokenizer: object
    host_params: dict  # MeshParams on a mesh: its shards' layout kept
    bytes_device: int
    arena: HostArena
    mesh: Mesh | None = None


@dataclass
class LoadedModel:
    spec: ModelSpec
    cfg: ModelConfig
    params: dict
    tokenizer: object
    last_used: float = 0.0
    bytes_per_chip: int = 0
    mesh: Mesh | None = None  # the spec's mesh (size 1: plain params)
    prefetched: bool = False  # loaded ahead of use by _maybe_prefetch
    # Recorded after a prefetch's host→device copies on the side stream;
    # the serving stream waits on it before the first use.
    ready: object = None
    # The paged path's persistent batcher and the knobs it was built
    # with: round R+1 reuses round R's (and its warm prefix cache) while
    # the key matches. Dropped with the weights on demotion.
    batcher: ContinuousBatcher | None = None
    batcher_key: tuple | None = None


class GpuEngine:
    """Serves ``tpu://`` aliases on ``device`` (default ``cuda``), and
    mesh aliases over ``devices`` (default every visible card; with
    ``devices`` given and no ``device``, the first of them). A spec that
    names no mesh axis above 1 stays on ``device`` unless ``devices`` is
    given, when the reference's rules spread it over them (dp).

    Loaded models stay resident under a byte budget
    (:func:`hbm_budget_bytes`), least recently used first out. An evicted
    model demotes to pinned host memory (``engine/weightres.py``'s
    ledger) and promotes back with one host→device copy instead of a
    reload; a heterogeneous round serves resident models first and
    prefetches the next group's weights on a side CUDA stream while the
    current group decodes."""

    def __init__(
        self,
        device: str | torch.device | None = None,
        devices: list | None = None,
    ) -> None:
        if device is None and devices:
            device = devices[0]
        self.device = resolve_device(device)
        self.devices_given = bool(devices)
        if devices:
            self.devices = [torch.device(d) for d in devices]
        elif self.device.type == "cuda":
            self.devices = mesh_mod.default_devices()
        else:
            self.devices = [self.device]
        self._models: dict[str, LoadedModel] = {}
        self._lock = lockdep_mod.make_lock("GpuEngine._lock")
        self._inflight: dict[str, Future] = {}
        # Estimated bytes of loads materializing now (foreground or
        # prefetch): counted with _models in every budget sum, so two
        # concurrent loads cannot each conclude they fit alone.
        self._loading: dict[str, int] = {}
        # Resident / host / freed bookkeeping, eviction pins (a model
        # mid-decode is never a victim) and the host payloads.
        self.ledger = weightres_mod.WeightLedger()
        # Demotions whose device→host copy is in flight: the victim is
        # out of _models but not yet in the host tier. A load of THAT
        # alias waits for the commit (then promotes).
        self._demoting: dict[str, threading.Event] = {}
        self.prefetch_hits = 0  # prefetched loads actually consumed
        self._side_stream = None  # prefetch copies (CUDA only)
        # Host arenas of promoted models, kept for the next demotion: its
        # pages are already faulted in and page-locked, which is most of
        # a demotion's cost on a host whose memory is in use.
        self._spare_arenas: list[HostArena] = []

    def _committed_bytes_locked(self) -> int:
        """Resident + materializing bytes. Caller holds self._lock."""
        return sum(m.bytes_per_chip for m in self._models.values()) + sum(
            self._loading.values()
        )

    def validate(self, model: str) -> str | None:
        return registry_mod.validate_tpu_model(model)

    def install(self, alias: str, params: dict) -> None:
        """Serve ``alias`` with these (already placed) params — e.g.
        weights bridged from the reference (``loader.params_from_jax``),
        or ``MeshParams`` placed on a mesh (``parallel/sharding.py``)."""
        spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
        cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
        lm = LoadedModel(
            spec, cfg, params, load_tokenizer(spec.tokenizer),
            last_used=time.monotonic(),
            bytes_per_chip=sharding_mod.per_chip_param_bytes(params),
            mesh=params.mesh if isinstance(params, sharding_mod.MeshParams) else None,
        )
        with self._lock:
            self._models[alias] = lm
        self.ledger.admit_load(alias, lm.bytes_per_chip)

    # -- model residency ---------------------------------------------------

    def _ready(self, lm: LoadedModel, prefetched: bool) -> LoadedModel:
        """Hand a loaded model to the serving thread: join a prefetch's
        side-stream copies, count the prefetch hit, stamp its use."""
        if lm.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(lm.ready)
            lm.ready = None
        if prefetched:
            self.prefetch_hits += 1
            lm.prefetched = False
        lm.last_used = time.monotonic()
        return lm

    def _load(self, alias: str) -> LoadedModel:
        with self._lock:
            lm = self._models.get(alias)
            if lm is not None:
                # A finished prefetch pops its own marker under the lock
                # that publishes the model; clear it on every hit anyway.
                self._inflight.pop(alias, None)
            fut = self._inflight.get(alias)
        if lm is not None:
            return self._ready(lm, lm.prefetched)
        if fut is not None:
            try:
                lm = fut.result()
            except Exception:
                lm = None  # the prefetch died: load on this thread
            with self._lock:
                self._inflight.pop(alias, None)
            if lm is not None:
                return self._ready(lm, True)
        self._wait_demoting(alias)
        if self.ledger.is_host(alias):
            return self._promote_sync(alias)
        return self._load_sync(alias)

    def _load_sync(
        self,
        alias: str,
        prefetched: bool = False,
        estimate: int | None = None,
        evict: bool = True,
        reserved: bool = False,  # the caller put alias in _loading
    ) -> LoadedModel:
        spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
        mesh_mod.maybe_initialize_distributed()
        mesh = self.mesh_for(spec)
        # Make room BEFORE materializing, or both weight sets coexist on
        # the device during the swap. A prefetch passes evict=False (it
        # fit-checked and never evicts on another group's behalf).
        if estimate is None:
            estimate = estimate_param_bytes(spec, mesh)
        if evict:
            self._evict_for(estimate, reserve_as=alias)
        elif not reserved:
            with self._lock:
                self._loading[alias] = estimate
        try:
            t_load = time.monotonic()
            params, cfg = self._materialize(
                spec, _DTYPES.get(spec.dtype, torch.bfloat16), mesh
            )
            tokenizer = load_tokenizer(spec.tokenizer)
            if obs_mod.config().enabled:
                obs_mod.metrics.counter(
                    "advspec_model_loads_total",
                    help="model materializations (foreground + prefetch)",
                ).inc()
                obs_mod.metrics.histogram(
                    "advspec_model_load_seconds",
                    help="checkpoint materialization + tokenizer wall",
                ).observe(time.monotonic() - t_load)
            lm = LoadedModel(
                spec, cfg, params, tokenizer,
                last_used=time.monotonic(),
                bytes_per_chip=sharding_mod.per_chip_param_bytes(params) or estimate,
                prefetched=prefetched,
                mesh=mesh if mesh.size > 1 else None,
            )
            with self._lock:
                # Publish and retire the in-flight marker atomically.
                self._models[alias] = lm
                self._inflight.pop(alias, None)
            self.ledger.admit_load(
                alias, lm.bytes_per_chip, time.monotonic() - t_load
            )
            return lm
        finally:
            with self._lock:
                self._loading.pop(alias, None)

    def _evict_for(self, needed_bytes: int, reserve_as: str | None = None) -> None:
        """Evict LRU models until ``needed_bytes`` fits the budget.

        Pinned aliases (mid-decode) are never victims. When nothing
        evictable is left and it still does not fit, the load proceeds
        and a device OOM surfaces as a transient error (the debate core
        retries after backoff)."""
        budget = hbm_budget_bytes(self.device)
        while True:
            with self._lock:
                resident = self._committed_bytes_locked()
                if not self._models or resident + needed_bytes <= budget:
                    break
                victims = [a for a in self._models if not self.ledger.pinned(a)]
                if not victims:
                    break
                oldest = min(victims, key=lambda a: self._models[a].last_used)
                lm, ev = self._pop_for_demotion_locked(oldest)
            # The device→host copy runs outside the engine lock; the
            # _demoting event makes a racing load of the victim wait.
            self._demote_popped(oldest, lm, ev)
        with self._lock:
            resident = self._committed_bytes_locked()
            if reserve_as is not None:
                # Reserve with the final fit check, under one lock hold.
                self._loading[reserve_as] = needed_bytes
        if resident + needed_bytes > budget:
            print(
                f"warning: model needs {needed_bytes >> 20} MiB with "
                f"{resident >> 20} MiB pinned-resident, budget "
                f"{budget >> 20} MiB — loading anyway (OOM will retry "
                "as transient)",
                file=sys.stderr,
            )

    def _pop_for_demotion_locked(self, alias: str) -> tuple[LoadedModel, threading.Event]:
        """Take one model out of the loaded dict for demotion, with its
        batcher (page pool, prefix cache): a demoted model holds no
        device memory. Caller holds ``self._lock``; the event is
        registered under the same hold."""
        lm = self._models.pop(alias)
        lm.batcher = None
        lm.batcher_key = None
        ev = threading.Event()
        self._demoting[alias] = ev
        return lm, ev

    def _demote_popped(self, alias: str, lm: LoadedModel, ev: threading.Event) -> None:
        """Finish one eviction outside the engine lock: the weights copy
        to pinned host memory (every leaf's copy started before any is
        waited on), quantized leaves as they are; with paging off, or an
        entry larger than the whole host budget, the model is freed."""
        try:
            host_budget = weightres_mod.config().host_mb << 20
            if not weightres_mod.paging_armed() or lm.bytes_per_chip > host_budget:
                self.ledger.free_model(alias)
                return
            t0 = time.monotonic()
            try:
                host, arena = self._to_host(lm.params)
            except BaseException:
                self.ledger.free_model(alias)  # its weights go with lm
                raise
            holder = HostWeights(
                lm.spec, lm.cfg, lm.tokenizer, host, lm.bytes_per_chip, arena,
                mesh=lm.mesh,
            )
            self.ledger.demote_model(
                alias, holder, param_bytes(host), time.monotonic() - t0
            )
        finally:
            lm.params = {}
            with self._lock:
                self._demoting.pop(alias, None)
            ev.set()

    def _arena_for(self, nbytes: int) -> HostArena:
        """The smallest spare arena that holds ``nbytes``, else a new one.
        Spares and host-tier weights together stay within the host budget:
        the largest spares are dropped first to make room."""
        with self._lock:
            fits = [a for a in self._spare_arenas if a.nbytes >= nbytes]
            if fits:
                arena = min(fits, key=lambda a: a.nbytes)
                self._spare_arenas.remove(arena)
                arena.reset()
                return arena
            budget = weightres_mod.config().host_mb << 20
            while self._spare_arenas and (
                self.ledger.host_bytes + sum(a.nbytes for a in self._spare_arenas)
                + nbytes > budget
            ):
                self._spare_arenas.remove(max(self._spare_arenas, key=lambda a: a.nbytes))
        return HostArena(nbytes, pin=self.device.type == "cuda")

    def _to_host(self, params: dict) -> tuple[dict, HostArena]:
        """The params copied into one host arena (every copy started
        before any is waited on), and the arena."""
        cuda = self.device.type == "cuda"
        arena = self._arena_for(sum(HostArena.size_of(t) for t in leaves(params)))

        def copy(t: torch.Tensor) -> torch.Tensor:
            return arena.take(t).copy_(t, non_blocking=arena.pinned)

        host = map_params(copy, params)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return host, arena

    def _wait_demoting(self, alias: str) -> None:
        """Block until an in-flight demotion of ``alias`` (if any) commits
        to the ledger. Never blocks for other aliases."""
        with self._lock:
            ev = self._demoting.get(alias)
        if ev is not None:
            ev.wait()

    def _promote_sync(
        self,
        alias: str,
        prefetched: bool = False,
        evict: bool = True,
        reserved: bool = False,
    ) -> LoadedModel:
        """Re-activate a host-demoted model with one host→device copy per
        leaf. A prefetch copies on a side CUDA stream, records an event
        the serving stream waits on, and overlaps the current group's
        decode. A fault mid-swap (the ``weight_swap`` chaos seam fires
        here) leaves the host entry untouched: only the admission waiting
        on it degrades, and the swap is declared (``swap_fault``)."""
        holder = self.ledger.peek_host(alias)
        if holder is None or not isinstance(holder.payload, HostWeights):
            return self._load_sync(alias, prefetched=prefetched, reserved=reserved)
        hw: HostWeights = holder.payload
        try:
            injector.fire("weight_swap")
            if evict:
                self._evict_for(hw.bytes_device, reserve_as=alias)
            elif not reserved:
                with self._lock:
                    self._loading[alias] = hw.bytes_device
            t0 = time.monotonic()
            params, ready = self._to_device(hw.host_params, side=prefetched)
            lm = LoadedModel(
                hw.spec, hw.cfg, params, hw.tokenizer,
                last_used=time.monotonic(), bytes_per_chip=hw.bytes_device,
                prefetched=prefetched, ready=ready, mesh=hw.mesh,
            )
            with self._lock:
                self._models[alias] = lm
                self._inflight.pop(alias, None)
            self.ledger.promote_model(
                alias, hw.bytes_device, time.monotonic() - t0, overlapped=prefetched
            )
            with self._lock:  # the copies are done: the arena is free
                self._spare_arenas.append(hw.arena)
            return lm
        except BaseException:
            # Conservation: the host entry was never consumed.
            self.ledger.note_swap_fault(alias)
            raise
        finally:
            with self._lock:
                self._loading.pop(alias, None)

    def _to_device(self, host: dict, side: bool) -> tuple[dict, object]:
        """The host params on the device, and the event their copies end
        with (None unless copied on the side stream). The copy is
        complete when this returns, so the wall it took is the swap's.
        ``MeshParams`` go back to each shard's own device, shards that
        shared a tensor sharing its copy: the layout they left with."""
        if isinstance(host, sharding_mod.MeshParams):
            params = sharding_mod.map_shards(
                lambda h, dev: h.clone() if dev.type != "cuda"
                else h.to(dev, non_blocking=True), host,
            )
            for dev in {d for d in host.mesh.devices.flat if d.type == "cuda"}:
                torch.cuda.current_stream(dev).synchronize()
            return params, None
        if self.device.type != "cuda":
            return map_params(torch.clone, host), None
        if not side:
            params = map_params(lambda h: h.to(self.device, non_blocking=True), host)
            torch.cuda.current_stream(self.device).synchronize()
            return params, None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        serving = torch.cuda.default_stream(self.device)
        with torch.cuda.stream(self._side_stream):
            params = map_params(lambda h: h.to(self.device, non_blocking=True), host)
            ready = torch.cuda.Event()
            ready.record(self._side_stream)
        for t in leaves(params):
            # Freed later, the block must wait for the serving stream's
            # uses before the side stream's allocator reuses it.
            t.record_stream(serving)
        ready.synchronize()
        return params, ready

    def check_residency_invariants(self) -> None:
        """Ledger conservation plus the ledger↔engine mirror: the ledger's
        resident set is exactly the loaded models, and no demoted model
        holds a batcher."""
        with self._lock:
            pending = list(self._demoting.values())
        for ev in pending:
            ev.wait()
        self.ledger.check_invariants()
        with self._lock:
            resident = set(self.ledger.resident_aliases())
            loaded = set(self._models)
        if resident != loaded:
            raise RuntimeError(
                f"weight ledger/engine drift: ledger resident "
                f"{sorted(resident)} != loaded models {sorted(loaded)}"
            )

    def _maybe_prefetch(self, alias: str) -> None:
        """Queue a background load of ``alias`` (non-blocking). All the
        work (estimate, fit check, the load or promotion) runs on a
        daemon thread, so a prefetch wedged on a dead device cannot hang
        the process at exit."""
        with self._lock:
            if alias in self._models or alias in self._inflight:
                return
            fut: Future = Future()
            self._inflight[alias] = fut

        def _work() -> None:
            try:
                fut.set_result(self._prefetch_task(alias))
            except BaseException as e:  # the future owns error delivery
                fut.set_exception(e)

        try:
            threading.Thread(
                target=_work, daemon=True, name=f"advspec-prefetch-{alias}"
            ).start()
        except BaseException as e:
            with self._lock:
                self._inflight.pop(alias, None)
            fut.set_exception(e)

    def _prefetch_task(self, alias: str) -> LoadedModel | None:
        """Background half of _maybe_prefetch. It never evicts: if the
        alias does not fit beside everything resident, it gives up and
        the load happens at use time. Exceptions stay in the future; the
        foreground _load falls back to a load of its own."""
        try:
            self._wait_demoting(alias)
            host_entry = self.ledger.peek_host(alias)
            if host_entry is not None and isinstance(host_entry.payload, HostWeights):
                estimate = host_entry.payload.bytes_device
            else:
                host_entry = None
                spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
                estimate = estimate_param_bytes(spec, self.mesh_for(spec))
            with self._lock:
                fits = (
                    self._committed_bytes_locked() + estimate
                    <= hbm_budget_bytes(self.device)
                )
                if fits:
                    self._loading[alias] = estimate
            if fits and host_entry is not None:
                return self._promote_sync(alias, prefetched=True, evict=False, reserved=True)
            if fits:
                return self._load_sync(
                    alias, prefetched=True, estimate=estimate, evict=False, reserved=True
                )
            return None
        finally:
            with self._lock:
                if not isinstance(self._models.get(alias), LoadedModel):
                    self._inflight.pop(alias, None)
                    self._loading.pop(alias, None)

    def _stage_next(self, alias: str) -> None:
        """Make the NEXT group's swap overlap this group's decode: when
        the next model is host-demoted and the budget is full, demote the
        LRU resident now (the current group's model is pinned), so the
        background promotion fits. Cold loads keep the fit-check-only
        prefetch."""
        entry = self.ledger.peek_host(alias)
        if entry is not None and isinstance(entry.payload, HostWeights):
            needed = entry.payload.bytes_device
            with self._lock:
                fits = (
                    self._committed_bytes_locked() + needed
                    <= hbm_budget_bytes(self.device)
                )
            if not fits:
                self._evict_for(needed)
        self._maybe_prefetch(alias)

    def mesh_for(self, spec: ModelSpec) -> Mesh:
        """``spec``'s mesh over the engine's devices (the reference's
        ``make_mesh(spec.mesh)``); raises the reference's ``ValueError``
        when it does not fit them. A spec naming no axis above 1 gets the
        one-device mesh of ``self.device`` unless the caller gave
        ``devices``: every card visible by default must not turn each
        single-device alias into a dp replica set (and a paged one out of
        its batcher)."""
        if not self.devices_given and all(int(n) <= 1 for n in spec.mesh.values()):
            return mesh_mod.make_mesh({}, [self.device])
        return mesh_mod.make_mesh(spec.mesh, self.devices)

    def _materialize(
        self, spec: ModelSpec, dtype: torch.dtype, mesh: Mesh | None = None
    ) -> tuple[dict, ModelConfig]:
        """Params via the fastest available source: the native cache
        (converted once, read straight onto the device) → HF safetensors
        conversion (then cached) → synthetic init. On a multi-device
        ``mesh`` each leaf is placed into its shards as it is read (the
        loader's ``device_put`` hook) and the params are ``MeshParams``;
        such a load reads a native cache but does not write one (the cache
        holds the unsharded layout)."""
        if mesh is not None and mesh.size > 1:
            put = sharding_mod.make_device_put(mesh, dtype)
            params, cfg = self._materialize_tree(spec, dtype, put)
            return sharding_mod.assemble(mesh, params), cfg
        return self._materialize_tree(spec, dtype, None)

    def _materialize_tree(self, spec: ModelSpec, dtype: torch.dtype, put) -> tuple[dict, ModelConfig]:
        injector.fire("checkpoint_load")
        cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
        cache_path = None
        if spec.checkpoint != "random":
            cache_path = ckpt_mod.cache_dir_for(
                spec.checkpoint,
                spec.family,
                spec.size,
                spec.dtype,
                spec.quant,
                tied_embeddings=cfg.tied_embeddings,
            )
        if cache_path is not None and ckpt_mod.has_native(cache_path):
            # The cache is an optimization in BOTH directions: a corrupt
            # or layout-incompatible cache falls back to HF conversion
            # instead of permanently breaking the model.
            try:
                params = ckpt_mod.load_native(
                    cache_path, cfg, dtype, spec.quant, self.device,
                    device_put=put,
                )
                return params, cfg
            except Exception as e:
                print(
                    f"warning: native checkpoint cache unreadable "
                    f"({e}); reconverting from HF",
                    file=sys.stderr,
                )
                shutil.rmtree(cache_path, ignore_errors=True)
        params, cfg = materialize_params(
            spec.checkpoint,
            spec.family,
            spec.size,
            dtype=dtype,
            max_seq_len=spec.max_seq_len,
            quant=spec.quant,
            device=self.device,
            device_put=put,
        )
        if cache_path is not None and put is None:
            try:  # the write side is best-effort too
                ckpt_mod.save_native(params, cache_path)
            except Exception as e:
                print(
                    f"warning: native checkpoint cache write failed: {e}",
                    file=sys.stderr,
                )
        return params, cfg

    def chat(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        """Complete every request (one completion per request, in order).
        ``consumer(row, text_so_far)`` streams each request's text and may
        cancel it by returning False — a batcher feature: the dense path
        serves the blocking result only, as the reference's does."""
        groups: dict[str, list[int]] = {}
        out: list[Completion | None] = [None] * len(requests)
        for i, req in enumerate(requests):
            try:
                alias = registry_mod.parse_tpu_model_id(req.model)
            except ValueError as e:
                out[i] = Completion(error=f"ValueError: {e}")
                continue
            groups.setdefault(alias, []).append(i)
        # Resident-first: groups whose weights are resident serve before
        # any group that forces a swap, so a pool larger than the budget
        # pays at most (pool - resident) swaps per round. Groups decode
        # independently: the order changes no row's greedy tokens.
        aliases = self.ledger.resident_first(list(groups))
        refusals = {a: self._refusal(a, params) for a in aliases}
        servable = [a for a in aliases if refusals[a] is None]
        for alias in aliases:
            indices = groups[alias]
            batch = [requests[i] for i in indices]
            # The caller's consumer indexes rows of ITS batch; re-map each
            # group's row back through the group's indices.
            group_consumer = None
            if consumer is not None:

                def group_consumer(row, text, _c=consumer, _ix=tuple(indices)):
                    return _c(_ix[row], text)

            try:
                if refusals[alias] is not None:
                    raise refusals[alias]
                k = servable.index(alias)
                completions = self._chat_one_model(
                    alias,
                    batch,
                    params,
                    # The next group's weights load (or promote) while
                    # this group decodes.
                    prefetch_next=servable[k + 1] if k + 1 < len(servable) else None,
                    consumer=group_consumer,
                )
            except Exception as e:  # degrade, never raise (parity: ref)
                msg = f"{type(e).__name__}: {e}"
                kind = faults.classify(e)
                # Injected faults know their seam; real ones are counted
                # where caught.
                faults.record(kind, getattr(e, "seam", "generate"))
                obs_mod.emit(
                    obs_mod.FaultEvent(
                        seam=getattr(e, "seam", "generate"),
                        kind=kind.value,
                        error=msg,
                        trace_id=batch[0].trace_id if batch else "",
                    )
                )
                obs_mod.autodump("fault")
                completions = [
                    Completion(error=msg, transient=kind.transient)
                    for _ in batch
                ]
            for i, comp in zip(indices, completions):
                out[i] = comp
        return [c for c in out if c is not None]

    def _refusal(self, alias: str, params: SamplingParams) -> Exception | None:
        """Why ``alias`` cannot be served this round, checked before any
        weights load: an unknown alias, a KV dtype the port does not
        serve, or a ``tokenizer.json`` its reader refuses."""
        try:
            spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
            check_kv_dtype(spec.kv_dtype)
            load_tokenizer(spec.tokenizer)
        except Exception as e:
            return e
        return None

    def _chat_one_model(
        self,
        alias: str,
        batch: list[ChatRequest],
        params: SamplingParams,
        prefetch_next: str | None = None,
        consumer=None,
    ) -> list[Completion]:
        # Pin BEFORE loading: from the moment the model can be resident
        # it is no victim of a concurrent background load.
        self.ledger.acquire_weights(alias)
        try:
            lm = self._load(alias)
            if prefetch_next is not None:
                self._stage_next(prefetch_next)
            injector.fire("generate")
            return self._chat_loaded(lm, batch, params, consumer)
        finally:
            self.ledger.release_weights(alias)

    def _chat_loaded(
        self,
        lm: LoadedModel,
        batch: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        tok = lm.tokenizer
        instruct = lm.spec.checkpoint != "random"
        prompts = []
        for req in batch:
            text = apply_chat_template(
                lm.spec.family, req.system, req.user, instruct
            )
            prompts.append(
                _trim_prompt(
                    tok.encode(text),
                    lm.cfg.max_seq_len - params.max_new_tokens,
                )
            )

        # Paged single-device specs serve through the continuous batcher,
        # unless the budget leaves no room for a bucketed prompt: that
        # corner takes the round-synchronous generate(paged=True), as the
        # dense path takes generate(), and so does a paged spec on a mesh
        # (its pool laid out per dp slice), as the reference routes them.
        # Neither streams: their consumers are served the blocking result
        # only, as the reference's are.
        if (
            lm.spec.kv == "paged"
            and lm.mesh is None
            and fits_batcher(lm.cfg, params.max_new_tokens)
        ):
            return self._chat_continuous(lm, prompts, params, batch, consumer)

        t0 = time.monotonic()
        result = generate(
            lm.params,
            lm.cfg,
            prompts,
            max_new_tokens=params.max_new_tokens,
            eos_ids=list(tok.eos_ids),
            pad_id=tok.pad_id,
            greedy=params.greedy,
            temperature=params.temperature,
            top_k=params.top_k,
            top_p=params.top_p,
            seed=params.seed,
            timeout_s=params.timeout_s,
            device=self.device,
            paged=lm.spec.kv == "paged",
            kv_dtype=lm.spec.kv_dtype,
            mesh=lm.mesh,
        )
        total_time = time.monotonic() - t0

        # Per-row attribution (reference: engine/tpu.py _chat_loaded):
        # decode time in proportion to each row's decoded tokens, the
        # prefill/overhead remainder split evenly; rows sum to the totals.
        tok_total = float(result.n_generated.sum())
        prefill_share = (total_time - result.decode_time_s) / len(batch)
        completions = []
        for row in range(len(batch)):
            n = int(result.n_generated[row])
            frac = (n / tok_total) if tok_total > 0 else 1.0 / len(batch)
            decode_share = result.decode_time_s * frac
            completions.append(
                Completion(
                    text=tok.decode(result.tokens[row, :n]),
                    usage=Usage(
                        input_tokens=len(prompts[row]),
                        output_tokens=n,
                        device_time_s=prefill_share + decode_share,
                        decode_tokens=n,
                        decode_time_s=decode_share,
                        prefill_time_s=result.prefill_time_s / len(batch),
                    ),
                )
            )
        return completions

    def _chat_continuous(
        self,
        lm: LoadedModel,
        prompts: list[list[int]],
        params: SamplingParams,
        batch: list[ChatRequest] | None = None,
        consumer=None,
    ) -> list[Completion]:
        """Serve one model's requests through the ContinuousBatcher.
        ``batch`` carries the callers' requests, whose causal-trace ids
        each ``SchedRequest`` inherits.

        Pool capacity covers CONCURRENT residency (the max_batch largest
        requests, bucketed to a power of two so repeat rounds of similar
        size keep the same batcher), not the whole queue: finished rows
        free their pages and queued requests admit into them.
        """
        tok = lm.tokenizer
        # The batcher checks bucket_length(prompt) + budget against the
        # model context; re-trim against the bucketed length.
        max_prompt = lm.cfg.max_seq_len - params.max_new_tokens
        while max_prompt > 1 and bucket_length(max_prompt) > max_prompt:
            nxt = bucket_length(max_prompt) // 2
            if nxt >= max_prompt:  # at the minimum bucket already
                break
            max_prompt = nxt
        prompts = [_trim_prompt(p, max_prompt) for p in prompts]
        n_slots = min(len(prompts), 8)
        per_req = sorted(
            (bucket_length(len(p)) + params.max_new_tokens for p in prompts),
            reverse=True,
        )
        need = sum(per_req[:n_slots])
        capacity = 2048
        while capacity < need:
            capacity *= 2
        seed = (
            params.seed
            if params.seed is not None
            # None means fresh entropy: unseeded rounds must vary.
            else int.from_bytes(os.urandom(4), "little")
        )
        batcher_key = (
            n_slots,
            capacity,
            params.max_new_tokens,
            lm.spec.kv_dtype,
            prefix_mod.config().enabled,
            prefix_mod.config().max_pages,
            # The batcher takes the drive loop and its depth at
            # construction: flipping either between rounds rebuilds it.
            interleave_mod.config().enabled,
            interleave_mod.config().pipeline_depth,
            # The tiers are built with the batcher: flipping --no-kv-tier,
            # the host budget or the store dir between rounds rebuilds it.
            kvtier_mod.config().enabled,
            kvtier_mod.config().host_mb,
            kvtier_mod.config().store_dir,
        )
        t0 = time.monotonic()
        try:
            results, decode_time = self._run_batcher(
                lm, batcher_key, prompts, params, seed, batch, consumer
            )
        except BaseException:
            # The batcher contains every fault it can isolate; one that
            # escapes (a CUDA error that poisons the context) leaves it
            # mid-drain (stale results, occupied slots): drop it.
            lm.batcher = None
            lm.batcher_key = None
            raise
        total_time = time.monotonic() - t0

        # The dense path's attribution: decode time splits by decoded
        # tokens, the prefill/overhead remainder evenly.
        tok_total = float(sum(r.n_generated for r in results)) or 1.0
        overhead = total_time - decode_time
        completions = []
        for r in results:  # sorted by req_id == prompt order
            decode_share = decode_time * r.n_generated / tok_total
            completions.append(
                Completion(
                    # Fault-evicted rows keep their partial decode and
                    # carry the error (transient faults are retryable).
                    text=tok.decode(r.tokens[: r.n_generated]),
                    error=r.error,
                    cancelled=r.cancelled,
                    transient=(
                        r.fault_kind is not None
                        and faults.FaultKind(r.fault_kind).transient
                    ),
                    usage=Usage(
                        input_tokens=len(prompts[r.req_id]),
                        output_tokens=r.n_generated,
                        device_time_s=overhead / len(results) + decode_share,
                        decode_tokens=r.n_generated,
                        decode_time_s=decode_share,
                        cached_tokens=r.cached_tokens,
                        prefill_time_s=r.prefill_time_s,
                    ),
                )
            )
        return completions

    @staticmethod
    def _make_stream_callback(tok, consumer, row):
        """Incremental detokenization for one request: the batcher hands
        ALL emitted ids so far; decode the full prefix each delivery (a
        partial multi-byte token decodes differently once its
        continuation arrives, so suffix-diffing could hand the consumer
        text the blocking path never produces). Returning False asks the
        batcher to cancel the request."""

        def on_tokens(token_ids) -> bool:
            return bool(consumer(row, tok.decode(token_ids)))

        return on_tokens

    def _run_batcher(
        self, lm, batcher_key, prompts, params, seed, batch=None, consumer=None
    ):
        """Reuse (or build) the model's persistent batcher and drain this
        call's requests through it. Returns ``(results, decode_time_s)``,
        the decode time being THIS call's delta on the batcher's
        cumulative counter."""
        tok = lm.tokenizer
        n_slots, capacity = batcher_key[0], batcher_key[1]
        if lm.batcher is not None and lm.batcher_key == batcher_key:
            # Round R+1 reuses round R's batcher and its warm prefix cache.
            batcher = lm.batcher
            batcher.reconfigure_sampling(
                greedy=params.greedy,
                temperature=params.temperature,
                top_k=params.top_k,
                top_p=params.top_p,
                seed=seed,
            )
            # Speculation re-resolves from the process config every drain;
            # the batcher is idle here (run_all drains fully).
            sp = spec_mod.config()
            batcher.reconfigure_speculative(enabled=sp.enabled, gamma=sp.gamma)
        else:
            lm.batcher = None  # free the old pool before the new one
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            batcher = ContinuousBatcher(
                lm.params,
                lm.cfg,
                max_batch=n_slots,
                capacity_tokens=capacity,
                max_new_cap=params.max_new_tokens,
                eos_ids=list(tok.eos_ids),
                greedy=params.greedy,
                temperature=params.temperature,
                top_k=params.top_k,
                top_p=params.top_p,
                seed=seed,
                kv_dtype=lm.spec.kv_dtype,
            )
            lm.batcher = batcher
            lm.batcher_key = batcher_key
        decode_t0 = batcher.decode_time_s
        stream_on = consumer is not None and stream_mod.config().enabled
        for i, ids in enumerate(prompts):
            src = batch[i] if batch is not None else None
            batcher.submit(
                SchedRequest(
                    req_id=i,
                    prompt_ids=ids,
                    max_new_tokens=params.max_new_tokens,
                    # Per-request watchdog: a slow request is evicted as
                    # TIMEOUT at this deadline while co-residents keep
                    # decoding (0 = disabled).
                    deadline_s=params.request_deadline_s,
                    trace_id=src.trace_id if src is not None else "",
                    span_id=src.span_id if src is not None else "",
                    on_tokens=(
                        self._make_stream_callback(tok, consumer, i)
                        if stream_on
                        else None
                    ),
                )
            )
        results = batcher.run_all(timeout_s=params.timeout_s)
        return results, batcher.decode_time_s - decode_t0
