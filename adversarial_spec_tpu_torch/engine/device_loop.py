"""The decode chunks' loops on the device: masked steps, CUDA graphs.

Counterpart of the reference's ``jax.lax.while_loop`` chunk bodies
(``engine/generate.py`` ``decode_chunk_steps``, ``engine/speculative.py``
``speculative_decode_steps`` and ``rowwise_decode_steps``,
``engine/scheduler.py`` ``_decode_chunk_impl``). The reference runs a
chunk as one device program with one host boundary a chunk; here a
chunk's loop state lives on the device as the while_loop's carry does,
and each step is a *masked* body: it computes the loop's condition on
the device (``done``: the reference would have left), and a step taken
after that changes no output — every counter advances by the step's
``run`` flag, every buffer write keeps its old value, and the K/V a
dense step writes is masked too (a paged step's inactive rows already
write the trash page).

``Loop.run`` launches a chunk's steps in sub-chunks of
``SUB_CHUNK``. After each it copies ``done`` to the host (on a card into
pinned memory behind a CUDA event, as the batcher's drive loop fetches
its flags) and stops launching once a copy says the reference has left;
on a card it reads a sub-chunk's copy only after the next sub-chunk is
launched, so the card never waits on the host. At most two sub-chunks
of steps run past the reference's exit; they are counted on the device
(``snapshot()["past_exit_steps"]``). The chunk's one blocking read is
its caller's, at the chunk's end, as in the reference.

On one card (a single device, or a virtual mesh whose shards the card
holds, in one process) each loop's step is captured once per static
shape key as a ``torch.cuda.CUDAGraph`` and replayed (:class:`Graphs`):
the first step of a key runs eagerly (it builds the kernels and warms
the libraries), the key's graph is captured right after it, and every
later step replays it. A capture or a replay that fails raises: nothing
quietly runs the eager body on a card. The eager body is what the CPU
runs, what a mesh across processes or cards runs (their collectives
cannot be captured), and what :func:`eager` asks for (the chip smoke
holds the graphs' tokens to it).

The kernel wrappers count their launches per Python call, which a
replay does not make: a capture's calls are taken back out of the
counters and each replay adds them again, so every counter reads
launches made. The CUDA-graph conditional while-node, which would give
the exact exit on the device, has no public PyTorch API.
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import Counter, deque

import torch

# Steps launched between two exit polls: at most two sub-chunks run past
# the reference's exit on a card (one on the CPU, which polls each at once).
SUB_CHUNK = 4

_force_eager = False


@contextlib.contextmanager
def eager():
    """Run every decode loop's eager body, on a card too (the chip smoke's
    reference for the graphs)."""
    global _force_eager
    old, _force_eager = _force_eager, True
    try:
        yield
    finally:
        _force_eager = old


class _Stats:
    """Process-wide loop counters (host ints); steps past the exit are
    counted on the device, per device, and read by ``snapshot``."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.chunks = 0
        self.pool_bytes: dict = {}
        for acc in _past_exit.values():
            acc.zero_()


# Each device's steps-past-the-exit accumulator (one int64, updated in
# place by every step, captured ones included).
_past_exit: dict[str, torch.Tensor] = {}
stats = _Stats()


def reset_stats() -> None:
    stats.reset()


def snapshot() -> dict:
    """Captures, replays, eager steps, chunks, steps past the reference's
    exit (a device read), the graph pools' bytes after their last capture
    and the sub-chunk size."""
    return {
        "captures": stats.captures,
        "replays": stats.replays,
        "eager_steps": stats.eager_steps,
        "chunks": stats.chunks,
        "past_exit_steps": sum(int(t) for t in _past_exit.values()),
        "pool_bytes": sum(stats.pool_bytes.values()),
        "sub_chunk": SUB_CHUNK,
    }


def counters() -> list[dict]:
    """Every launch counter a decode step moves."""
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm
    from adversarial_spec_tpu_torch.parallel import collectives

    return [da.launches, da.mesh_launches, da.mesh_shards, pa.launches,
            pa.mesh_launches, pa.mesh_shards, qm.launches, collectives.counts]


def graphable(device: torch.device, mesh=None) -> bool:
    """True where the decode steps run as graphs: a CUDA device, or a mesh
    of one process whose every shard sits on one card."""
    if _force_eager or device.type != "cuda":
        return False
    if mesh is None or mesh.size == 1:
        return True
    return not mesh.multiprocess and len({str(d) for d in mesh.devices.flat}) == 1


def graph_pool():
    """A model's graph memory pool. The object keeps the pool alive, so
    graphs captured and dropped at different times (a batcher's, each
    ``generate`` call's) share it, and it goes with the model."""
    return torch.cuda.MemPool()


def _pool_bytes(pool_id) -> int:
    """Bytes of the allocator's segments in the graph pool ``pool_id``."""
    want = tuple(pool_id)
    return sum(
        seg["total_size"]
        for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == want
    )


class Graphs:
    """The captured steps of one owner's loops (a batcher, or one
    ``generate`` call: a graph holds its buffers' addresses, so it lives
    as long as they do), keyed by each loop's static shape key, in the
    model's graph memory pool ``pool`` (``graph_pool``; None: one of
    their own). Every graph writes its results into the loops' own
    buffers: what it allocates is scratch, so graphs of one pool may
    replay in any order on one stream."""

    def __init__(self, pool=None):
        self.pool = pool if pool is not None else graph_pool()
        self._graphs: dict = {}
        self.captures = Counter()  # by program: the retrace watch's probe

    def step(self, key: tuple, step, generators=(), program: str = "") -> None:
        """One step of ``key``: replay its graph, or run it eagerly and
        capture it (a key's first step)."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, per_replay = entry
            graph.replay()
            for counts, delta in zip(counters(), per_replay):
                for name, n in delta.items():
                    counts[name] += n
            stats.replays += 1
            return
        step()
        stats.eager_steps += 1
        moved = counters()
        before = [dict(c) for c in moved]
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if gen is not None:
                graph.register_generator_state(gen)
        # Another thread's copies (a weight prefetch) may run beside a
        # capture: only this thread's calls are checked.
        with torch.cuda.graph(graph, pool=self.pool.id, capture_error_mode="thread_local"):
            step()
        per_replay = []
        for counts, was in zip(moved, before):
            per_replay.append({k: counts[k] - was[k] for k in counts if counts[k] != was[k]})
            counts.update(was)
        self._graphs[key] = (graph, per_replay)
        self.captures[program] += 1
        stats.captures += 1
        stats.pool_bytes[self.pool.id] = _pool_bytes(self.pool.id)

    def probe(self, program: str):
        """The retrace watch's cache-size probe for ``program``: the graphs
        captured during its dispatches."""
        return _Probe(self, program)


class _Probe:
    def __init__(self, graphs: Graphs, program: str):
        self._graphs, self._program = graphs, program

    def _cache_size(self) -> int:
        return self._graphs.captures[self._program]


class _Poll:
    """A host copy of a loop's ``done`` flag as of now in stream order."""

    def __init__(self, done: torch.Tensor):
        cuda = done.is_cuda
        self.host = torch.empty((), dtype=torch.bool, pin_memory=cuda)
        self.host.copy_(done, non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(done.device))

    def exited(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(ctypes.c_bool.from_address(self.host.data_ptr()).value)


class Loop:
    """One decode loop's device carry and where its steps run: ``done``
    (the reference has left), the buffers ``carry`` keeps across the
    loop's chunks (a graph reads fixed addresses), and ``graphs`` (None:
    the eager body). ``program`` names its captures for the retrace
    watch."""

    def __init__(self, device: torch.device, graphs: Graphs | None = None,
                 program: str = ""):
        self.graphs = graphs
        self.program = program
        self.done = torch.ones((), dtype=torch.bool, device=device)
        if str(device) not in _past_exit:
            _past_exit[str(device)] = torch.zeros((), dtype=torch.int64, device=device)
        self._past_exit = _past_exit[str(device)]
        self._bufs: dict[str, torch.Tensor] = {}

    def carry(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """The loop's buffer ``name`` holding a copy of ``value`` (made on
        first use, and anew should its shape or dtype change: the
        buffers' addresses are part of every key)."""
        buf = self._bufs.get(name)
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            buf = self._bufs[name] = value.clone()
        elif buf is not value:
            buf.copy_(value)
        return buf

    def begin(self) -> torch.Tensor:
        """A step's ``run`` flag ([] bool): False past the reference's exit,
        where the step is counted as such."""
        self._past_exit.add_(self.done.long())
        return ~self.done

    def end(self, cond: torch.Tensor) -> None:
        """Set ``done`` from the reference's loop condition after a step."""
        self.done.copy_(~cond)

    def run(self, step, n_max: int, key: tuple, generators=()) -> int:
        """Launch up to ``n_max`` steps of ``step`` (a masked body that
        updates the loop's device state in place and sets ``done``), in
        sub-chunks of ``SUB_CHUNK``, until a sub-chunk's copy of ``done``
        says the reference has left. With ``graphs``, each step replays
        the graph of ``key`` and the carry's addresses (``generators``:
        the non-default CUDA generators it draws from). Returns the steps
        launched."""
        key = key + ptrs(self.done, *self._bufs.values())
        launched = 0
        polls: deque[_Poll] = deque()
        depth = 2 if self.done.is_cuda else 1
        while launched < n_max:
            n = min(SUB_CHUNK, n_max - launched)
            for _ in range(n):
                if self.graphs is None:
                    step()
                    stats.eager_steps += 1
                else:
                    self.graphs.step(key, step, generators, self.program)
            launched += n
            polls.append(_Poll(self.done))
            if len(polls) >= depth and polls.popleft().exited():
                break
        stats.chunks += 1
        return launched


def ptrs(*tensors) -> tuple:
    """The addresses of the tensors (or a mesh's ``Sharded``: its first
    part) a step reads: part of a graph's key, so a step over re-made
    buffers is captured anew instead of reading freed memory."""
    return tuple(getattr(t, "first", t).data_ptr() for t in tensors)
