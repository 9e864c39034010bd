"""Parallelism: the mesh, the sharding rules and the collectives.

Counterpart of ``adversarial_spec_tpu/parallel/`` for dp, tp and sp meshes
and their products: a process drives the devices it holds, a sharded
tensor is one tensor per shard on its shard's device, and
``collectives.py`` reduces, gathers and shifts between them. Launched one
process per host (``mesh.maybe_initialize_distributed``), a mesh spans
every process's devices and each process runs its own shards; an sp
group may span processes (the ring's hop is then a send/receive). The sp
axis is the ring prefill (``parallel/sp.py``, ``parallel/ring.py``).
"""

from adversarial_spec_tpu_torch.parallel.mesh import (
    MeshAxes,
    make_mesh,
    maybe_initialize_distributed,
    mesh_shape_from_spec,
)
from adversarial_spec_tpu_torch.parallel.sharding import (
    cache_sharding,
    param_sharding_rules,
    shard_params,
)

__all__ = [
    "MeshAxes",
    "make_mesh",
    "maybe_initialize_distributed",
    "mesh_shape_from_spec",
    "param_sharding_rules",
    "shard_params",
    "cache_sharding",
]
