"""Device mesh construction for the port.

Counterpart of ``adversarial_spec_tpu/parallel/mesh.py``, with the same
axis convention:

- ``dp`` — data parallel: the rows of a round (its opponents) split
  across mesh slices;
- ``tp`` — tensor parallel: attention heads and FFN columns
  (Megatron-style; the all-reduces are ``parallel/collectives.py``'s);
- ``sp`` — sequence parallel: the prompt's blocks over the ring
  prefill (``parallel/sp.py``, ``parallel/ring.py``); decode is
  replicated over it, as the reference's, and each process runs it at
  its *decode rank* (below).

A ``Mesh`` is a ``[dp, sp, tp]`` array of ``torch.device``s; a sharded
tensor is one tensor per shard on its shard's device
(``parallel/sharding.py``), and the collectives run between those
tensors. A device may repeat: a *virtual mesh* (every shard on
``cuda:0``, or on the CPU in the tests) runs the same program as a mesh of
distinct cards, the counterpart of the reference's
``--xla_force_host_platform_device_count``.

One process drives the devices it holds. Launched one process per host
(``maybe_initialize_distributed``: the reference's env contract, brought
up through ``torch.distributed``), every process contributes its own
devices, the lists are exchanged once and ordered by rank (the
counterpart of ``jax.devices()`` spanning every process), and each
process runs the same program over the shards it holds: the round's
state is replicated on every process, each process computes its own
shards, and a collective whose group spans processes takes the ``dist``
way (``parallel/collectives.py``).

An sp group may span processes: the ring's hop between them is a
send/receive (``collectives.ring_shift``). Decode is the same on every
sp rank (the reference replicates its cache over sp), so each process
decodes at its *decode rank*, the lowest sp rank it holds, on its own
shards there: ``device(d, t)``, ``is_local``, ``local_shards`` and the
decode collectives (``span``, ``tp_span``, ``members``, ``row_owner``,
``rows_everywhere``) read that rank unless given another, and a decode
collective spans only the processes that decode at the same rank. One
process decodes at rank 0, on the sp-rank-0 devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

DP, TP, SP = "dp", "tp", "sp"
MeshAxes = (DP, TP, SP)

# The reference's launch contract (one process per host). The names are
# strings, so a launch script means the same to both packages.
COORDINATOR = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES = "JAX_NUM_PROCESSES"
PROCESS_ID = "JAX_PROCESS_ID"
# Managed clusters whose launcher sets each process's rank and size: the
# two of jax's cluster detectors that apply to GPU hosts.
CLUSTERS = (
    ("Slurm", "SLURM_PROCID", "SLURM_NTASKS"),
    ("Open MPI", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
)
# How long the rendezvous and every collective wait for a peer before
# failing (a missing or dead peer fails the run instead of hanging it).
DIST_TIMEOUT_S = float(os.environ.get("ADVSPEC_DIST_TIMEOUT_S", "300"))


class Mesh:
    """A ``[dp, sp, tp]`` array of devices and its axis sizes.

    ``shape`` is the reference's ``mesh.shape`` dict and ``size`` the
    device count; ``device(d, t, s)`` is shard ``(d, s, t)``'s device
    (sp rank ``s``; by default this process's decode rank: the decode
    program's devices).

    ``ranks`` (same shape) is the process that holds each entry and
    ``cards`` names each entry's physical device (host and card), so two
    processes sharing a card are told from two cards; ``rank`` is this
    process. ``decode_ranks`` maps each process to its decode rank, the
    lowest sp rank it holds, and ``decode_rank`` is this process's. A
    single-process mesh holds every entry and decodes at sp rank 0."""

    axis_names = (DP, SP, TP)

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None,
                 cards: np.ndarray | None = None, rank: int = 0):
        if devices.ndim != 3:
            raise ValueError(f"mesh devices must be [dp, sp, tp], got {devices.shape}")
        self.devices = devices
        dp, sp, tp = devices.shape
        self.shape = {DP: dp, SP: sp, TP: tp}
        self.size = int(devices.size)
        self.rank = rank
        self.ranks = np.full(devices.shape, rank) if ranks is None else ranks
        if cards is None:
            cards = np.empty(devices.shape, dtype=object)
            cards.flat[:] = [str(d) for d in devices.flat]
        self.cards = cards
        self.decode_ranks = {
            int(r): min(s for s in range(sp) if (self.ranks[:, s, :] == r).any())
            for r in sorted({int(r) for r in self.ranks.flat})
        }
        self.decode_rank = self.decode_ranks.get(rank, 0)
        self.multiprocess = bool((self.ranks != rank).any())
        if self.multiprocess:
            self._check_processes()

    def _sp(self, s: int | None) -> int:
        return self.decode_rank if s is None else s

    def device(self, d: int, t: int, s: int | None = None) -> torch.device:
        return self.devices[d, self._sp(s), t]

    def is_local(self, d: int, t: int, s: int | None = None) -> bool:
        """True when this process holds shard ``(d, s, t)``."""
        return int(self.ranks[d, self._sp(s), t]) == self.rank

    def local_shards(self) -> list[tuple[int, int]]:
        """The decode shards ``(d, t)`` (at the decode rank) this process
        holds, in grid order: every shard of a single-process mesh."""
        return [(d, t) for d in range(self.shape[DP]) for t in range(self.shape[TP])
                if self.is_local(d, t)]

    @property
    def controller(self) -> torch.device:
        """Where the round's global state lives (tokens, sampling): this
        process's first decode device, as the reference's host fetches
        land there. Every process holds its own replica of that state."""
        d, t = self.local_shards()[0]
        return self.device(d, t)

    @property
    def distinct(self) -> bool:
        """True when no card repeats (a mesh of distinct cards)."""
        return len(set(self.cards.flat)) == self.size

    def card_shards(self, d: int, t: int) -> int:
        """The decode shards at this process's decode rank, of every
        process that decodes there, on shard ``(d, t)``'s card: the
        sharded kernels plan their splits for all that work (two
        processes sharing a card launch side by side). The processes that
        decode at another sp rank run the same program, planned the same
        way, so every replica decodes as one process's virtual mesh does,
        bit for bit."""
        s = self.decode_rank
        return int((self.cards[:, s, :] == self.cards[d, s, t]).sum())

    def span(self, keys) -> "Span | None":
        """The processes that hold the shards ``keys`` (``(d, t)`` at the
        decode rank, or ``(d, t, s)``), for a collective among them; None
        when this process holds them all (the single-process ways)."""
        at = [(k[0], self._sp(k[2] if len(k) > 2 else None), k[1]) for k in keys]  # [dp, sp, tp]
        ranks = [int(self.ranks[i]) for i in at]
        if all(r == self.rank for r in ranks):
            return None
        members = tuple(sorted(set(ranks)))
        holders: dict = {}
        for i, r in zip(at, ranks):
            holders.setdefault(self.cards[i], set()).add(r)
        nccl = (all(self.devices[i].type == "cuda" for i in at)
                and all(len(h) == 1 for h in holders.values()))
        return Span(members, tuple(ranks.count(r) for r in members),
                    process_group(members), nccl)

    def tp_span(self, d: int, s: int | None = None) -> "Span | None":
        """``span`` of dp slice ``d``'s tp group at sp rank ``s``."""
        return self.span([(d, t, self._sp(s)) for t in range(self.shape[TP])])

    def sp_span(self, d: int, t: int) -> "Span | None":
        """``span`` of shard ``(d, t)``'s sp group: the ring's processes,
        each holding consecutive sp ranks in process order."""
        return self.span([(d, t, s) for s in range(self.shape[SP])])

    def row_owner(self, d: int, s: int | None = None) -> int:
        """The first process holding a shard of dp slice ``d`` (at sp rank
        ``s``): the one that hands the slice's rows to the others."""
        return int(self.ranks[d, self._sp(s)].min())

    def rows_everywhere(self, s: int | None = None, everyone: bool = False) -> bool:
        """True when every process that holds a shard at sp rank ``s``
        (``everyone``: every process of the mesh) holds a shard of every
        dp slice there."""
        s = self._sp(s)
        members = set((self.ranks if everyone else self.ranks[:, s]).flat)
        return all(set(self.ranks[d, s].flat) == members for d in range(self.shape[DP]))

    def members(self, owners=(), everyone: bool = False, s: int | None = None) -> "Span | None":
        """``span`` of every shard at sp rank ``s`` (the processes that
        decode there), or with ``everyone`` of every entry (all the
        mesh's processes), for an exchange among them in which each sends
        the items it owns (``owners``: each item's owning rank); None when
        this process is alone there."""
        dp, sp, tp = self.devices.shape
        sps = range(sp) if everyone else [self._sp(s)]
        span = self.span([(d, t, x) for d in range(dp) for t in range(tp) for x in sps])
        if span is None:
            return None
        return dataclasses.replace(span, counts=tuple(list(owners).count(r) for r in span.ranks))

    def _check_processes(self) -> None:
        """Refuse what a mesh across processes cannot run, naming the mesh
        and the ranks: a process holding no device of the mesh (it would
        have no device to hold the round on); a decode rank whose shards
        are not all held by the processes that decode there (a process
        decoding at a lower rank holds one of them); and a process holding
        sp blocks of a ``(d, t)`` it does not decode (its weights and the
        reshard's gather land on the decode rank's shards)."""
        dp, sp, tp = self.devices.shape
        missing = sorted(set(range(process_count())) - set(self.decode_ranks))
        if missing:
            raise ValueError(
                f"mesh {self.shape} holds no device of process(es) {missing}: every "
                "process of a multi-process launch runs the round on devices of its own"
            )
        for s in sorted(set(self.decode_ranks.values())):
            decoders = sorted(r for r, x in self.decode_ranks.items() if x == s)
            strays = sorted({int(r) for r in self.ranks[:, s, :].flat} - set(decoders))
            if strays:
                held = int(np.isin(self.ranks[:, s, :], decoders).sum())
                raise ValueError(
                    f"mesh {self.shape} across processes: process(es) {decoders} decode at sp "
                    f"rank {s} but hold {held} of its {dp * tp} (dp, tp) shards; process(es) "
                    f"{strays} hold the rest and decode at sp rank(s) "
                    f"{sorted({self.decode_ranks[r] for r in strays})}: every shard of a "
                    "decode rank must be held by a process that decodes there"
                )
        for r, x in self.decode_ranks.items():
            undecoded = sorted({(d, t) for d in range(dp) for t in range(tp) for s in range(sp)
                                if self.ranks[d, s, t] == r and self.ranks[d, x, t] != r})
            if undecoded:
                raise ValueError(
                    f"mesh {self.shape} across processes: process {r} holds sp blocks of the "
                    f"(dp, tp) shard(s) {undecoded} but does not decode them at its decode rank "
                    f"{x}: a process decodes every (dp, tp) shard whose sp blocks it holds"
                )
        # Every process makes the same groups in the same order: the tp
        # groups at every sp rank, the sp groups (the ring, the reshard),
        # the decode ranks' members and every process.
        for s in range(sp):
            for d in range(dp):
                self.tp_span(d, s)
        for d in range(dp):
            for t in range(tp):
                self.sp_span(d, t)
        for s in sorted(set(self.decode_ranks.values())):
            self.members(s=s)
        self.members(everyone=True)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        extra = (f", processes={sorted(self.decode_ranks)}, decode_ranks={self.decode_ranks}"
                 if self.multiprocess else "")
        return f"Mesh({self.shape}, devices={devs}{extra})"


@dataclasses.dataclass(frozen=True)
class Span:
    """A collective's processes: ``ranks`` in order, the parts each holds
    (``counts``), their process group (None: the default group) and
    whether the parts may go over NCCL (every part on a card that no
    other member holds)."""

    ranks: tuple
    counts: tuple
    group: object
    nccl: bool


_GROUPS: dict = {}


def process_group(ranks: tuple):
    """The process group of ``ranks`` (None for the whole world), made
    once: every process asks for the same groups in the same order, as
    ``torch.distributed.new_group`` needs."""
    if ranks == tuple(range(process_count())):
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def default_devices() -> list[torch.device]:
    """Every visible card, the counterpart of ``jax.devices()`` on one
    process; raises when there is none (no silent CPU mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[...] (e.g. "
            "['cpu'] * 8) to build a mesh elsewhere"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 unless launched
    one process per host."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (``jax.process_count()``)."""
    return dist.get_world_size() if _initialized() else 1


def maybe_initialize_distributed() -> None:
    """Bring up the multi-process runtime when launched as one process per
    host. Safe no-op otherwise.

    Launch contract (one process per host), the reference's:

        JAX_COORDINATOR_ADDRESS=host0:1234   # process 0's address
        JAX_NUM_PROCESSES=N
        JAX_PROCESS_ID=i                     # 0..N-1, unique per process

    A coordinator with neither count nor id is a managed cluster's launch:
    the rank and size come from Slurm's or Open MPI's variables. The
    process group is gloo for CPU tensors, with NCCL registered for CUDA
    tensors where the build has it; its ``timeout`` (``DIST_TIMEOUT_S``)
    makes a missing peer fail the rendezvous instead of hanging it.
    Idempotent."""
    coordinator = os.environ.get(COORDINATOR)
    if not coordinator:
        if os.environ.get(NUM_PROCESSES) or os.environ.get(PROCESS_ID):
            # Half a launch contract: this host would silently run
            # single-process while its peers block at the rendezvous.
            raise RuntimeError(
                "multi-host launch: JAX_NUM_PROCESSES/JAX_PROCESS_ID are "
                "set but JAX_COORDINATOR_ADDRESS is not; set all three"
            )
        return
    if _initialized():
        return
    num = os.environ.get(NUM_PROCESSES)
    pid = os.environ.get(PROCESS_ID)
    if (num is None) != (pid is None):
        missing = "JAX_PROCESS_ID" if pid is None else "JAX_NUM_PROCESSES"
        raise RuntimeError(
            f"multi-host launch: JAX_COORDINATOR_ADDRESS is set but "
            f"{missing} is not; set both JAX_NUM_PROCESSES and "
            f"JAX_PROCESS_ID (or neither, for managed clusters)"
        )
    if num is not None:
        try:
            world, rank = int(num), int(pid)
        except ValueError:
            raise RuntimeError(
                f"multi-host launch: JAX_NUM_PROCESSES={num!r} / "
                f"JAX_PROCESS_ID={pid!r} must be integers"
            ) from None
    else:
        rank, world = _managed_cluster()
    backend = "gloo"
    if torch.cuda.is_available() and dist.is_nccl_available():
        backend = "cpu:gloo,cuda:nccl"
    address = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=address, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
    )


def _managed_cluster() -> tuple[int, int]:
    """(rank, size) from the first managed cluster whose variables are
    set; raises, naming what is missing, when none is."""
    for name, rank_var, size_var in CLUSTERS:
        rank, size = os.environ.get(rank_var), os.environ.get(size_var)
        if rank is None and size is None:
            continue
        if rank is None or size is None:
            raise RuntimeError(
                f"multi-host launch: {name}'s {size_var if size is None else rank_var} "
                f"is not set beside {rank_var if size is None else size_var}"
            )
        try:
            return int(rank), int(size)
        except ValueError:
            raise RuntimeError(
                f"multi-host launch: {rank_var}={rank!r} / {size_var}={size!r} must be "
                "integers"
            ) from None
    names = "; ".join(f"{n}: {r}/{s}" for n, r, s in CLUSTERS)
    raise RuntimeError(
        "multi-host launch: JAX_COORDINATOR_ADDRESS is set but neither "
        "JAX_NUM_PROCESSES/JAX_PROCESS_ID nor a managed cluster's rank and size "
        f"({names}) are; set JAX_NUM_PROCESSES and JAX_PROCESS_ID"
    )


def card_id(device: torch.device) -> str:
    """The physical device behind ``device``: its host, and for a card
    its UUID (two processes on one card name the same card)."""
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}:{device.type}"
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return f"{host}:{uuid if uuid is not None else f'cuda:{index}'}"


_GLOBAL: dict = {}


def global_devices(local: list) -> tuple[list, list, list]:
    """``(devices, ranks, cards)`` of every process's devices, ordered by
    rank: the counterpart of ``jax.devices()``. Each process contributes
    ``local``; the lists are exchanged once (a collective: every process
    asks at the same point of the program). One process: ``local``."""
    local = [torch.device(d) for d in local]
    if process_count() == 1:
        return local, [0] * len(local), [str(d) for d in local]
    key = tuple(str(d) for d in local)
    if key not in _GLOBAL:
        mine = json.dumps([[str(d), card_id(d)] for d in local])
        devices, ranks, cards = [], [], []
        for r, text in enumerate(_all_gather_text(mine)):
            for dev, card in json.loads(text):
                devices.append(torch.device(dev))
                ranks.append(r)
                cards.append(card)
        _GLOBAL[key] = (devices, ranks, cards)
    return _GLOBAL[key]


def _all_gather_text(text: str) -> list[str]:
    """Every process's ``text``, by rank, over CPU tensors (gloo)."""
    data = torch.frombuffer(bytearray(text.encode()), dtype=torch.uint8)
    n = process_count()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([data.numel()], dtype=torch.int64))
    width = int(max(s.item() for s in sizes))
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[: data.numel()] = data
    bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [bytes(b[: int(s.item())].tolist()).decode() for b, s in zip(bufs, sizes)]


def mesh_shape_from_spec(
    mesh_spec: dict[str, int] | None, n_devices: int | None = None
) -> dict[str, int]:
    """Normalize a registry mesh spec {axis: size} to a full {dp, tp, sp}.

    The reference's rules: unspecified axes default to 1; leftover devices
    go to dp, so {"tp": 2} on 8 devices is dp=4, tp=2, sp=1. A spec that
    pins dp explicitly may describe a submesh on the leading devices."""
    n = n_devices if n_devices is not None else len(default_devices())
    spec = dict(mesh_spec or {})
    unknown = set(spec) - set(MeshAxes)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; use {MeshAxes}")
    tp = int(spec.get(TP, 1))
    sp = int(spec.get(SP, 1))
    if DP not in spec and n % (tp * sp) != 0:
        raise ValueError(f"mesh tp={tp} sp={sp} does not divide device count {n}")
    dp = int(spec.get(DP, n // (tp * sp)))
    total = dp * tp * sp
    if total > n or (DP not in spec and total != n):
        raise ValueError(f"mesh dp*tp*sp = {total} != device count {n}")
    return {DP: dp, TP: tp, SP: sp}


def make_mesh(
    mesh_spec: dict[str, int] | None = None,
    devices: list | None = None,
) -> Mesh:
    """The {dp, tp, sp} mesh over ``devices`` (default: every visible
    card). tp varies fastest, as in the reference, so a tp group sits on
    adjacent cards. Launched one process per host, ``devices`` are this
    process's own and the mesh is built over every process's
    (``global_devices``)."""
    local = devices if devices is not None else default_devices()
    devs, ranks, cards = global_devices(local)
    shape = mesh_shape_from_spec(mesh_spec, n_devices=len(devs))
    total = shape[DP] * shape[SP] * shape[TP]
    grid = (shape[DP], shape[SP], shape[TP])
    arrays = []
    for xs in (devs, ranks, cards):
        arr = np.empty(total, dtype=object)
        arr[:] = xs[:total]
        arrays.append(arr.reshape(grid))
    return Mesh(arrays[0], arrays[1].astype(int), arrays[2], rank=process_index())


def device_ctx(device: torch.device):
    """Make ``device`` current for the launches inside (a CUDA kernel
    launches on the current device); a no-op off CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def device_groups(mesh: Mesh) -> list[tuple[torch.device, list[tuple[int, int]]]]:
    """The decode shards ``(d, t)`` (at the decode rank) each distinct
    device of this process holds, devices in order of first appearance and shards
    in grid order: one group of every shard on a virtual mesh, one shard
    a group on a mesh of distinct cards. The sharded kernels launch once
    for a group."""
    groups: dict[torch.device, list[tuple[int, int]]] = {}
    for d, t in mesh.local_shards():
        groups.setdefault(torch.device(mesh.device(d, t)), []).append((d, t))
    return list(groups.items())


def group_map(fn, mesh: Mesh, *grids):
    """The port's ``shard_map``, by device group: ``fn(shards, *operands)``
    runs once for each group of ``device_groups`` with that device
    current, each operand the list of the group's shards' values (each
    grid a ``[dp][tp]`` nested list of shard-local values, see
    ``parallel/sharding.py``; None for a grid that is None), and its list
    of per-shard results comes back as a ``[dp][tp]`` grid (None where
    another process holds the shard). The sharded kernels' wrappers
    (W1-W3) launch once a group this way. The sp ranks are not mapped
    here: a ring hop needs every rank's block at once, so the sp prefill
    (``parallel/sp.py``) steps its ranks itself, and decode is replicated
    over sp (each process maps its shards at its decode rank)."""
    out = [[None] * mesh.shape[TP] for _ in range(mesh.shape[DP])]
    for dev, shards in device_groups(mesh):
        with device_ctx(dev):
            res = fn(shards, *(None if g is None else [g[d][t] for d, t in shards]
                               for g in grids))
        for (d, t), o in zip(shards, res):
            out[d][t] = o
    return out
