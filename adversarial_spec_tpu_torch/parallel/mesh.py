"""Device mesh construction for the port.

Counterpart of ``adversarial_spec_tpu/parallel/mesh.py``, with the same
axis convention:

- ``dp`` — data parallel: the rows of a round (its opponents) split
  across mesh slices;
- ``tp`` — tensor parallel: attention heads and FFN columns
  (Megatron-style; the all-reduces are ``parallel/collectives.py``'s);
- ``sp`` — sequence parallel: the prompt's blocks over the ring
  prefill (``parallel/sp.py``, ``parallel/ring.py``); decode leaves it
  idle and runs on the sp-rank-0 devices.

The reference runs a single controller: one Python process drives every
device of the mesh and GSPMD inserts the collectives. The port keeps that
model. A ``Mesh`` is a ``[dp, sp, tp]`` array of ``torch.device``s held
by one process; a sharded tensor is one tensor per shard on its shard's
device (``parallel/sharding.py``), and the collectives run between those
tensors. A device may repeat: a *virtual mesh* (every shard on
``cuda:0``, or on the CPU in the tests) runs the same program as a mesh of
distinct cards, the counterpart of the reference's
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

DP, TP, SP = "dp", "tp", "sp"
MeshAxes = (DP, TP, SP)


class Mesh:
    """A ``[dp, sp, tp]`` array of devices and its axis sizes.

    ``shape`` is the reference's ``mesh.shape`` dict and ``size`` the
    device count; ``device(d, t, s)`` is shard ``(d, s, t)``'s device
    (sp rank ``s``, 0 by default: the decode program's devices)."""

    axis_names = (DP, SP, TP)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"mesh devices must be [dp, sp, tp], got {devices.shape}")
        self.devices = devices
        dp, sp, tp = devices.shape
        self.shape = {DP: dp, SP: sp, TP: tp}
        self.size = int(devices.size)

    def device(self, d: int, t: int, s: int = 0) -> torch.device:
        return self.devices[d, s, t]

    @property
    def controller(self) -> torch.device:
        """Where the round's global state lives (tokens, sampling): the
        first device, as the reference's host fetches land there."""
        return self.devices[0, 0, 0]

    @property
    def distinct(self) -> bool:
        """True when no device repeats (a mesh of distinct cards)."""
        return len(set(self.devices.flat)) == self.size

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def default_devices() -> list[torch.device]:
    """Every visible card, the counterpart of ``jax.devices()``; raises
    when there is none (no silent CPU mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[...] (e.g. "
            "['cpu'] * 8) to build a mesh elsewhere"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def maybe_initialize_distributed() -> None:
    """The reference brings up its multi-host runtime here when launched
    one process per host (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). The port has no multi-host launch (one process
    drives every device of its mesh): with any of those variables set
    this raises instead of running a single-host mesh while the peers
    wait."""
    names = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
    set_ = [n for n in names if os.environ.get(n)]
    if set_:
        raise NotImplementedError(
            f"a multi-host launch ({', '.join(set_)} set) is not supported "
            "by the PyTorch/CUDA package: one process drives every device"
        )


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
    adjacent cards."""
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    shape = mesh_shape_from_spec(mesh_spec, n_devices=len(devs))
    total = shape[DP] * shape[SP] * shape[TP]
    arr = np.empty(total, dtype=object)
    arr[:] = devs[:total]
    return Mesh(arr.reshape(shape[DP], shape[SP], shape[TP]))


def device_ctx(device: torch.device):
    """Make ``device`` current for the launches inside (a CUDA kernel
    launches on the current device); a no-op off CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def device_groups(mesh: Mesh) -> list[tuple[torch.device, list[tuple[int, int]]]]:
    """The decode shards ``(d, t)`` (sp rank 0) each distinct device holds,
    devices in order of first appearance and shards in grid order: one
    group of every shard on a virtual mesh, one shard a group on a mesh
    of distinct cards. The sharded kernels launch once for a group."""
    groups: dict[torch.device, list[tuple[int, int]]] = {}
    for d in range(mesh.shape[DP]):
        for t in range(mesh.shape[TP]):
            groups.setdefault(torch.device(mesh.device(d, t)), []).append((d, t))
    return list(groups.items())


def group_map(fn, mesh: Mesh, *grids):
    """The port's ``shard_map``, by device group: ``fn(shards, *operands)``
    runs once for each group of ``device_groups`` with that device
    current, each operand the list of the group's shards' values (each
    grid a ``[dp][tp]`` nested list of shard-local values, see
    ``parallel/sharding.py``; None for a grid that is None), and its list
    of per-shard results comes back as a ``[dp][tp]`` grid. The sharded
    kernels' wrappers (W1-W3) launch once a group this way. The sp ranks
    are not mapped here: a ring hop needs every rank's block at once, so
    the sp prefill (``parallel/sp.py``) steps its ranks itself, and
    decode leaves sp idle."""
    out = [[None] * mesh.shape[TP] for _ in range(mesh.shape[DP])]
    for dev, shards in device_groups(mesh):
        with device_ctx(dev):
            res = fn(shards, *(None if g is None else [g[d][t] for d, t in shards]
                               for g in grids))
        for (d, t), o in zip(shards, res):
            out[d][t] = o
    return out
