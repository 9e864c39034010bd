"""Parameter and cache sharding rules (Megatron-style tp), per shard.

Counterpart of ``adversarial_spec_tpu/parallel/sharding.py``, with its
rules:

- ``wq/wk/wv``, ``w_gate/w_up`` and the qkv biases are column-sharded over
  ``tp`` (each shard owns a slice of heads / FFN columns);
- ``wo`` and ``w_down`` are row-sharded over ``tp``: their products are
  partial sums, all-reduced after the matmul (``parallel/collectives.py``);
- the KV cache shards its rows over ``dp`` and its heads over ``tp``;
- embeddings and norms are replicated; the head is column-sharded, so the
  logits are vocab-sharded until the all-gather before sampling.

Where the reference annotates one global array with a ``NamedSharding``
and lets GSPMD partition the program, the port holds the shards
themselves: a spec is a tuple naming, per dimension, the mesh axis it is
split over (``DP``, ``TP`` or None; missing trailing entries are None),
and ``split`` turns a tensor into a ``[dp][tp]`` grid of shard-local
tensors, each on its shard's device. A leaf replicated over dp is one
tensor per device: on a virtual mesh (a device repeated) the replicas
are the same tensor.

The port's params keep per-layer dicts (no leading layer axis), so each
rule here is the reference's with its layer axis dropped.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from adversarial_spec_tpu_torch.parallel.mesh import DP, TP, Mesh

# Leaf name → spec over the port's per-layer shapes ([in, out] weights).
_PARAM_RULES: dict[str, tuple] = {
    "embed": (),
    "final_norm": (),
    "lm_head": (None, TP),
    "lm_head_t": (None, TP),
    "attn_norm": (),
    "ffn_norm": (),
    "post_attn_norm": (),
    "post_ffn_norm": (),
    "wq": (None, TP),
    "wk": (None, TP),
    "wv": (None, TP),
    "bq": (TP,),
    "bk": (TP,),
    "bv": (TP,),
    "wo": (TP, None),
    "w_gate": (None, TP),
    "w_up": (None, TP),
    "w_down": (TP, None),
}


def param_sharding_rules(path) -> tuple:
    """The spec of the leaf at ``path`` (a tuple of names; layer indices
    and other non-rule names are skipped).

    Quantized weights are dict leaves under the weight's name
    (``ops/quant.py``): int8 ``{"q", "scale"}``, int4 ``{"q4", "scale"}``.
    ``q`` and ``q4`` shard like the weight (int4 packs pairs of
    contraction rows, so a row-sharded ``w_down`` needs an even number of
    rows per shard); ``scale`` (``[1, out]``) keeps only the output-axis
    split."""
    names = [str(p) for p in path]
    if not names:
        raise ValueError(f"cannot name path {path}")
    name = names[-1]
    if name in ("q", "q4", "scale") and len(names) >= 2:
        parent = _PARAM_RULES.get(names[-2])
        if parent is not None:
            if name in ("q", "q4"):
                return parent
            spec = list(parent)
            spec[-2] = None
            return tuple(spec)
    if name not in _PARAM_RULES:
        raise KeyError(f"no sharding rule for param {name!r}")
    return _PARAM_RULES[name]


def cache_sharding(mesh: Mesh) -> tuple:
    """KV cache ``[L, B, Hkv, T, D]``: rows over dp, heads over tp."""
    return (None, DP, TP, None, None)


def _index(shape, spec, mesh: Mesh, d: int, t: int) -> tuple:
    """Shard ``(d, t)``'s slice of a tensor of ``shape`` under ``spec``."""
    idx = []
    for ax, n in enumerate(shape):
        axis = spec[ax] if ax < len(spec) else None
        if axis is None:
            idx.append(slice(None))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"dim {ax} of {tuple(shape)} does not split {parts} ways over {axis}")
        i = d if axis == DP else t
        idx.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return tuple(idx)


def split(x: torch.Tensor, mesh: Mesh, spec: tuple) -> list[list[torch.Tensor]]:
    """``x`` as a ``[dp][tp]`` grid of contiguous shard-local tensors, each
    on its shard's device. Shards with the same slice on the same device
    (dp replicas on a virtual mesh) are one tensor; every shard owns its
    memory, so ``x`` can be freed."""
    memo: dict = {}
    grid = []
    for d in range(mesh.shape[DP]):
        row = []
        for t in range(mesh.shape[TP]):
            idx = _index(x.shape, spec, mesh, d, t)
            dev = mesh.device(d, t)
            key = (tuple((s.start, s.stop) for s in idx), str(dev))
            if key not in memo:
                part = x[idx]
                memo[key] = torch.empty(part.shape, dtype=x.dtype, device=dev).copy_(part)
            row.append(memo[key])
        grid.append(row)
    return grid


def gather(grid, mesh: Mesh, spec: tuple, device: torch.device | None = None) -> torch.Tensor:
    """Inverse of :func:`split`: the global tensor on ``device`` (default
    the mesh's controller). Replicated axes take shard 0's copy."""
    device = device if device is not None else mesh.controller
    dp_ax = spec.index(DP) if DP in spec else None
    tp_ax = spec.index(TP) if TP in spec else None
    rows = []
    for d in range(mesh.shape[DP] if dp_ax is not None else 1):
        parts = [p.to(device) for p in grid[d]]
        rows.append(torch.cat(parts, dim=tp_ax) if tp_ax is not None else parts[0])
    return torch.cat(rows, dim=dp_ax) if dp_ax is not None else rows[0]


class Sharded:
    """One logical tensor laid out on a mesh: ``parts[d][t]`` on
    ``mesh.device(d, t)``, split as ``spec`` says. ``shape`` is the global
    shape, so code that only reads a cache's or pool's extents (``T``, the
    page size) reads a ``Sharded`` as it reads a tensor."""

    def __init__(self, mesh: Mesh, spec: tuple, parts: list[list[torch.Tensor]]):
        self.mesh, self.spec, self.parts = mesh, spec, parts
        shape = list(parts[0][0].shape)
        for ax, axis in enumerate(spec):
            if axis is not None:
                shape[ax] *= mesh.shape[axis]
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype


def local(tree: dict, d: int, t: int) -> dict:
    """Shard ``(d, t)``'s view of a dict of ``Sharded`` (a cache or pool)."""
    return {k: v.parts[d][t] for k, v in tree.items()}


@dataclass
class MeshParams:
    """A model's params on a mesh: ``parts[d][t]`` is shard ``(d, t)``'s
    own params dict, in the single-device layout with its slice of every
    tp-sharded leaf (so each shard is a model of ``local_config``'s
    widths whose row-parallel products are partial sums)."""

    mesh: Mesh
    parts: list[list[dict]]

    def shard(self, d: int = 0, t: int = 0) -> dict:
        return self.parts[d][t]


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def map_shards(fn, params: MeshParams) -> MeshParams:
    """``fn(tensor, device)`` on every leaf of every shard (``device`` the
    shard's), once per (tensor, device): a tensor shared by shards on one
    device (dp replicas on a virtual mesh) maps to one shared result, so
    the layout survives a round trip (demotion to host and back)."""
    memo: dict = {}

    def once(dev):
        def f(x):
            key = (id(x), str(dev))
            if key not in memo:
                memo[key] = (x, fn(x, dev))  # x kept alive: its id stays unique
            return memo[key][1]
        return f

    mesh = params.mesh
    return MeshParams(mesh, [
        [_tree_map(once(mesh.device(d, t)), p) for t, p in enumerate(row)]
        for d, row in enumerate(params.parts)
    ])


def per_chip_param_bytes(params) -> int:
    """The most bytes the params hold on one physical device, each tensor
    a device holds counted once: on a mesh of distinct cards one shard
    (the reference's per-chip count), on a virtual mesh every distinct
    shard on the shared device (dp replicas there are one tensor)."""
    if not isinstance(params, MeshParams):
        return sum(x.numel() * x.element_size() for x in _leaves(params))
    seen: set = set()
    per_dev: dict = {}
    for d, row in enumerate(params.parts):
        for t, shard in enumerate(row):
            dev = str(params.mesh.device(d, t))
            for x in _leaves(shard):
                if id(x) not in seen:
                    seen.add(id(x))
                    per_dev[dev] = per_dev.get(dev, 0) + x.numel() * x.element_size()
    return max(per_dev.values())


def per_chip_bytes(layout, mesh: Mesh) -> int:
    """``per_chip_param_bytes`` of params not made yet: ``layout`` yields
    each leaf's (path, shape, itemsize); each leaf counts its shard once
    per distinct slice a device holds."""
    per_dev: dict = {}
    for path, shape, itemsize in layout:
        spec = param_sharding_rules(path)
        size = math.prod(shard_shape(shape, spec, mesh)) * itemsize
        held = {
            (str(mesh.device(d, t)), d if DP in spec else 0, t if TP in spec else 0)
            for d in range(mesh.shape[DP]) for t in range(mesh.shape[TP])
        }
        for dev, _, _ in held:
            per_dev[dev] = per_dev.get(dev, 0) + size
    return max(per_dev.values())


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def local_config(cfg, tp: int):
    """The config one tp shard computes with: its heads and FFN columns."""
    if tp == 1:
        return cfg
    for what, n in (("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads),
                    ("ffn_dim", cfg.ffn_dim)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {what}={n}")
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        ffn_dim=cfg.ffn_dim // tp,
    )


class _Grid:
    """A leaf's shard grid inside a params tree (tells it from ``layers``)."""

    __slots__ = ("grid",)

    def __init__(self, grid):
        self.grid = grid


def make_device_put(mesh: Mesh, dtype: torch.dtype | None = None):
    """Loader hook: split each tensor onto the mesh as it is read, so the
    full tensor can be freed before the next one (bounded staging).
    ``put(path_names, tensor)`` returns the leaf's ``[dp][tp]`` grid; a
    floating leaf other than a quantization scale is cast to ``dtype``.
    A tree of such leaves becomes ``MeshParams`` through ``assemble``."""

    def put(path_names: tuple, x: torch.Tensor):
        spec = param_sharding_rules(path_names)
        if (dtype is not None and x.is_floating_point() and x.dtype != dtype
                and path_names[-1] != "scale"):
            x = x.to(dtype)
        return _Grid(split(x, mesh, spec))

    return put


def place_tree(put, tree, path: tuple = (), consume: bool = False):
    """``put(path, leaf)`` on every leaf of ``tree`` (dicts and lists; a
    quantized leaf's parts are leaves). ``consume``: drop each of
    ``tree``'s leaves once placed, so about one layer's full leaves are
    held beside the shards."""
    if not isinstance(tree, (dict, list)):
        return put(path, tree)
    keys = list(tree) if isinstance(tree, dict) else list(range(len(tree)))
    out = []
    for k in keys:
        out.append(place_tree(put, tree[k], path + (k,), consume))
        if consume:
            tree[k] = None
    return dict(zip(keys, out)) if isinstance(tree, dict) else out


def shard_params(mesh: Mesh, params, consume: bool = False) -> MeshParams:
    """Place a single-device params tree onto the mesh per the rules
    (``consume``: see ``place_tree``)."""
    return assemble(mesh, place_tree(make_device_put(mesh), params, consume=consume))


def assemble(mesh: Mesh, tree) -> MeshParams:
    """A tree whose leaves are ``[dp][tp]`` grids → per-shard trees."""

    def pick(node, d, t):
        if isinstance(node, _Grid):
            return node.grid[d][t]
        if isinstance(node, dict):
            return {k: pick(v, d, t) for k, v in node.items()}
        if isinstance(node, list):
            return [pick(v, d, t) for v in node]
        return node

    parts = [
        [pick(tree, d, t) for t in range(mesh.shape[TP])]
        for d in range(mesh.shape[DP])
    ]
    return MeshParams(mesh, parts)


def shard_shape(shape, spec: tuple, mesh: Mesh) -> tuple:
    """One shard's shape of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for ax, axis in enumerate(spec):
        if axis is not None:
            out[ax] = math.ceil(out[ax] / mesh.shape[axis])
    return tuple(out)
