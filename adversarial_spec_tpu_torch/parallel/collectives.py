"""The collectives between shards: all-reduce, all-gather, ring shift.

Counterpart of the psums and all-gathers GSPMD inserts around the
reference's sharded matmuls (``adversarial_spec_tpu/parallel/sharding.py``):
an all-reduce after the row-parallel ``wo`` / ``w_down``, and an
all-gather of the vocab-sharded logits before sampling. The sequence
axis adds two (``parallel/sp.py``, ``parallel/ring.py``): the ring
attention's ``ppermute`` of a K/V block to the next sp rank
(``ring_shift``), and the gather of the prefill cache's sequence blocks
when it is resharded for decode (``all_gather`` over sp). The
reference's third, the psum over sp of last-position logits zeroed off
the last sp block, is that block's logits: the port computes the head
on the last block only and takes them from there.

Each takes one tensor per shard of the group that this process holds,
in tp order, and gives one back per shard, on that shard's device. Three
ways run them, chosen by the mesh's devices and ranks and never by a
failure:

- ``nccl``: the shards sit on distinct cards, so NCCL's single-process
  multi-GPU entry points (``torch.cuda.nccl``) reduce or gather them in
  place on the cards;
- ``local``: a virtual mesh (a device repeated) or the CPU. The shards
  are summed in rank order on the first shard's device (or concatenated
  there) and the result is copied to every other device.

- ``dist``: the group spans processes (a launch one process per host,
  ``parallel/mesh.py``; the caller passes the group's ``Span``). The
  parts are summed in rank order, the ``local`` way's order: each
  process adds its parts to the running sum of the processes before it
  and broadcasts the result to the group, the last process's sum being
  the total; a gather exchanges every process's parts. Where two
  members share a card, or the parts sit on the CPU, NCCL cannot join
  them (it refuses two ranks on one device): they are staged through
  host memory over gloo. Where every member's parts sit on cards of its
  own, the CUDA tensors go over NCCL.

All are exact reductions of the same partials, in the same order: a
round across processes is bit-identical to the single-process virtual
mesh's. A ring shift moves each
block to the next rank's device: ``peer`` when the ranks sit on distinct
cards (a device-to-device copy, ``Tensor.to(next, non_blocking=True)``,
ordered by the stream), ``local`` when they share one (a virtual mesh or
the CPU: a hand-off, no copy), ``dist`` when the ring spans processes: a
block whose next rank another process holds is sent there and one
arrives from the previous rank's process, a send/receive pair posted at
once (over NCCL between cards of their own, else staged through host
memory over gloo). ``counts`` says which way ran, one per call.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from adversarial_spec_tpu_torch.parallel.mesh import DIST_TIMEOUT_S, Span, process_count

counts = {"nccl": 0, "local": 0, "peer": 0, "dist": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _nccl(parts: list[torch.Tensor]) -> bool:
    """True when the parts sit on distinct cards NCCL can join."""
    if len(parts) < 2 or not all(p.is_cuda for p in parts):
        return False
    if len({p.device for p in parts}) != len(parts):
        return False
    return torch.cuda.nccl.is_available(parts)


def all_reduce(parts: list[torch.Tensor], span: Span | None = None) -> list[torch.Tensor]:
    """The sum of ``parts`` on each part's device. The parts are consumed:
    on the ``nccl`` way they are reduced in place. ``span``: the group
    spans processes (``Mesh.span``), ``parts`` are this process's."""
    if span is not None:
        return _dist_all_reduce(parts, span)
    if len(parts) == 1:
        return parts
    if _nccl(parts):
        parts = [p.contiguous() for p in parts]
        torch.cuda.nccl.all_reduce(parts)
        counts["nccl"] += 1
        return parts
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    counts["local"] += 1
    return [total if p.device == dev else total.to(p.device) for p in parts]


def all_gather(parts: list[torch.Tensor], dim: int = -1, span: Span | None = None) -> torch.Tensor:
    """``parts`` concatenated along ``dim``, on the first part's device
    (the one shard that samples). ``span``: the group spans processes,
    ``parts`` are this process's; every member gets the whole."""
    if span is not None:
        dim = dim % parts[0].dim()
        return torch.cat(exchange(parts, span), dim=dim)
    if len(parts) == 1:
        return parts[0]
    dim = dim % parts[0].dim()
    if _nccl(parts):
        parts = [p.contiguous() for p in parts]
        n = len(parts)
        outs = [
            torch.empty((n,) + tuple(p.shape), dtype=p.dtype, device=p.device)
            for p in parts
        ]
        torch.cuda.nccl.all_gather(parts, outs)
        counts["nccl"] += 1
        # [n, ...] stacked shards → concatenated along dim.
        return torch.cat(list(outs[0].unbind(0)), dim=dim)
    dev = parts[0].device
    counts["local"] += 1
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def ring_shift(parts: list[torch.Tensor], ranks: list[int] | None = None,
               span: Span | None = None) -> list[torch.Tensor]:
    """The ring hop: rank ``i``'s block becomes rank ``i + 1``'s (mod the
    ring's size), on that rank's device. ``parts`` are every rank's
    blocks in rank order; with ``span`` (the ring spans processes,
    ``Mesh.sp_span``) they are this process's, ``ranks`` their global sp
    ranks."""
    if span is not None:
        return _dist_ring_shift(parts, ranks, span)
    n = len(parts)
    if n == 1:
        return parts
    devs = [p.device for p in parts]
    out = [parts[(i - 1) % n] for i in range(n)]
    if all(dv == devs[0] for dv in devs):
        counts["local"] += 1
        return out
    counts["peer"] += 1
    return [x if x.device == devs[i] else x.to(devs[i], non_blocking=True)
            for i, x in enumerate(out)]


# -- the dist way ---------------------------------------------------------------


def _broadcast(x: torch.Tensor | None, src: int, span: Span, like: torch.Tensor) -> torch.Tensor:
    """Process ``src``'s ``x`` on every member, on ``like``'s device (a
    receiver passes None and gets a tensor shaped as ``like``)."""
    mine = dist.get_rank() == src
    if span.nccl:
        buf = x.contiguous() if mine else torch.empty_like(like)
        dist.broadcast(buf, src, group=span.group)
        return buf
    host = (x.detach().to("cpu").contiguous() if mine
            else torch.empty(like.shape, dtype=like.dtype))
    dist.broadcast(_wire(host, span), src, group=span.group)
    return host.to(like.device)


def _wire(x: torch.Tensor, span: Span) -> torch.Tensor:
    """What goes over the wire: the tensor itself over NCCL, its bytes
    over gloo (every dtype, bf16 included, as uint8)."""
    return x if span.nccl else x.reshape(-1).view(torch.uint8)


def _dist_ring_shift(parts: list[torch.Tensor], ranks: list[int], span: Span) -> list[torch.Tensor]:
    """The hop across processes. ``span.counts`` consecutive sp ranks sit
    on each of ``span.ranks`` in turn (the mesh is laid out by process),
    so a block whose next rank is held here is handed on, and every
    other one goes to the next rank's process. The receives and sends
    are posted together (``batch_isend_irecv``): no process waits on its
    own send, and each waits at most ``DIST_TIMEOUT_S`` for a peer."""
    n = sum(span.counts)
    owner = [r for r, c in zip(span.ranks, span.counts) for _ in range(c)]
    here = {i: j for j, i in enumerate(ranks)}
    out: list = [None] * len(parts)
    ops, landing = [], []
    for j, i in enumerate(ranks):
        prev = (i - 1) % n
        if prev in here:
            x = parts[here[prev]]
            out[j] = x if x.device == parts[j].device else x.to(parts[j].device, non_blocking=True)
            continue
        buf = (torch.empty_like(parts[j]) if span.nccl
               else torch.empty(parts[j].shape, dtype=parts[j].dtype))
        ops.append(dist.P2POp(dist.irecv, _wire(buf, span), owner[prev], group=span.group, tag=i))
        landing.append((j, buf))
    for j, i in enumerate(ranks):
        nxt = (i + 1) % n
        if nxt not in here:
            x = parts[j].contiguous() if span.nccl else parts[j].detach().to("cpu").contiguous()
            ops.append(dist.P2POp(dist.isend, _wire(x, span), owner[nxt], group=span.group,
                                  tag=nxt))
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    for req in dist.batch_isend_irecv(ops):
        req.wait(timeout)
    for j, buf in landing:
        out[j] = buf if span.nccl else buf.to(parts[j].device)
    counts["dist"] += 1
    return out


def _dist_all_reduce(parts: list[torch.Tensor], span: Span) -> list[torch.Tensor]:
    """The ``dist`` all-reduce: the ``local`` way's left fold in rank
    order, carried from process to process by one broadcast each."""
    me = dist.get_rank()
    dev = parts[0].device
    total = None
    for r in span.ranks:
        if r == me:
            for p in parts:
                total = p if total is None else total + p.to(dev)
            total = _broadcast(total, r, span, parts[0])
        else:
            total = _broadcast(None, r, span, parts[0])
    counts["dist"] += 1
    return [total if p.device == dev else total.to(p.device) for p in parts]


def exchange(parts: list[torch.Tensor], span: Span, like: torch.Tensor | None = None) -> list[torch.Tensor]:
    """Every member's parts, in rank order (each member's in its own
    order), on the first part's (or ``like``'s) device: the ``dist``
    all-gather. ``span.counts`` gives each member's number of parts;
    every part has one shape and dtype (``like``'s, for a member that
    holds none)."""
    like = parts[0] if parts else like
    dev = like.device
    width = max(span.counts)
    stack = torch.zeros((width,) + tuple(like.shape), dtype=like.dtype, device=dev)
    for i, p in enumerate(parts):
        stack[i].copy_(p)
    if span.nccl:
        bufs = [torch.empty_like(stack) for _ in span.ranks]
        dist.all_gather(bufs, stack, group=span.group)
    else:
        host = stack.to("cpu")
        bufs = [torch.empty_like(host) for _ in span.ranks]
        dist.all_gather([_wire(b, span) for b in bufs], _wire(host, span), group=span.group)
    counts["dist"] += 1
    return [b[i].to(dev) for b, n in zip(bufs, span.counts) for i in range(n)]


def agree_any(flag: bool) -> bool:
    """True when ``flag`` is true on any process: a host decision that
    reads a clock (a deadline) taken by every process alike. One process:
    ``flag``."""
    if process_count() == 1:
        return flag
    x = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


def agree_int(value: int, src: int = 0) -> int:
    """Process ``src``'s ``value`` on every process (a seed drawn from
    entropy). One process: ``value``."""
    if process_count() == 1:
        return value
    x = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(x, src)
    return int(x.item())
