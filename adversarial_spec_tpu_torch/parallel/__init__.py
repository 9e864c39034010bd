"""Parallelism: the mesh, the sharding rules and the collectives.

Counterpart of ``adversarial_spec_tpu/parallel/`` for dp, tp and sp meshes
and their products on one host: one process drives every device of the
mesh (the reference's single controller), a sharded tensor is one tensor
per shard on its shard's device, and ``collectives.py`` reduces, gathers
and shifts between them. The sp axis is the ring prefill
(``parallel/sp.py``, ``parallel/ring.py``). The multi-host launch is not
ported yet.
"""

from adversarial_spec_tpu_torch.parallel.mesh import (
    MeshAxes,
    make_mesh,
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
    "mesh_shape_from_spec",
    "param_sharding_rules",
    "shard_params",
    "cache_sharding",
]
