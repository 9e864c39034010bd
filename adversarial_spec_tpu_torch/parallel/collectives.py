"""The collectives of a tp group: all-reduce and all-gather across shards.

Counterpart of the psums and all-gathers GSPMD inserts around the
reference's sharded matmuls (``adversarial_spec_tpu/parallel/sharding.py``):
an all-reduce after the row-parallel ``wo`` / ``w_down``, and an
all-gather of the vocab-sharded logits before sampling.

Each takes one tensor per shard of the group, in tp order, and gives one
back per shard, on that shard's device. Two ways run them, chosen by the
mesh's devices and never by a failure:

- ``nccl``: the shards sit on distinct cards, so NCCL's single-process
  multi-GPU entry points (``torch.cuda.nccl``) reduce or gather them in
  place on the cards;
- ``local``: a virtual mesh (a device repeated) or the CPU. The shards
  are summed in rank order on the first shard's device (or concatenated
  there) and the result is copied to every other device.

Both are exact reductions of the same partials. ``counts`` says which ran,
one per call.
"""

from __future__ import annotations

import torch

counts = {"nccl": 0, "local": 0}


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
