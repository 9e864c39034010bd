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


def compat_shard_map(fn, mesh: Mesh, *grids):
    """The port's ``shard_map``: ``fn`` on each shard's local operands.

    Each grid is a ``[dp][tp]`` nested list of shard-local values (see
    ``parallel/sharding.py``); ``fn(*locals)`` runs once per shard with
    that shard's device current, and the results come back as a grid.
    The sp ranks are not mapped here: a ring hop needs every rank's block
    at once, so the sp prefill (``parallel/sp.py``) steps its ranks
    itself, and decode leaves sp idle."""
    dp, tp = mesh.shape[DP], mesh.shape[TP]
    out = []
    for d in range(dp):
        row = []
        for t in range(tp):
            with device_ctx(mesh.device(d, t)):
                row.append(fn(*(g[d][t] for g in grids)))
        out.append(row)
    return out
