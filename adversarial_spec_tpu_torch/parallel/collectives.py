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

Each takes one tensor per shard of the group, in tp order, and gives one
back per shard, on that shard's device. Two ways run them, chosen by the
mesh's devices and never by a failure:

- ``nccl``: the shards sit on distinct cards, so NCCL's single-process
  multi-GPU entry points (``torch.cuda.nccl``) reduce or gather them in
  place on the cards;
- ``local``: a virtual mesh (a device repeated) or the CPU. The shards
  are summed in rank order on the first shard's device (or concatenated
  there) and the result is copied to every other device.

Both are exact reductions of the same partials. A ring shift moves each
block to the next rank's device: ``peer`` when the ranks sit on distinct
cards (a device-to-device copy, ``Tensor.to(next, non_blocking=True)``,
ordered by the stream), ``local`` when they share one (a virtual mesh or
the CPU: a hand-off, no copy). ``counts`` says which way ran, one per
call.
"""

from __future__ import annotations

import torch

counts = {"nccl": 0, "local": 0, "peer": 0}


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


def all_reduce(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of ``parts`` on each part's device. The parts are consumed:
    on the ``nccl`` way they are reduced in place."""
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


def all_gather(parts: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """``parts`` concatenated along ``dim``, on the first part's device
    (the one shard that samples)."""
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


def ring_shift(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ring hop: rank ``i``'s block becomes rank ``i + 1``'s (mod the
    ring's size), on that rank's device."""
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
