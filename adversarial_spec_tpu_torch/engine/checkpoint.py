"""Native checkpoint cache: converted params saved as safetensors files.

Counterpart of ``adversarial_spec_tpu/engine/checkpoint.py``, whose Orbax
cache becomes a cache in the port's own layout: an HF checkpoint is
converted once (``engine/loader.py``: transposed to ``[in, out]``, cast,
quantized) and every later load reads the converted leaves straight onto
the device, with no transpose, cast or quantization.

Cache location: ``<checkpoint_dir>/.native-cache-torch/<fingerprint>``.
The reference keeps its Orbax cache under ``.native-cache/``: each package
fails to read the other's format and would delete it and reconvert, so
the two caches live apart and a checkpoint directory can serve both. The
fingerprint covers family/size/dtype/quant, the source files' stats and,
for configs that tie their embeddings, the transposed-head flag (it adds
the ``lm_head_t`` leaf).

Layout: each leaf under a flat name — ``embed``, ``final_norm``,
``lm_head`` or ``lm_head_t``, ``layers.{i}.{key}``; a quantized leaf as
``<name>.q`` (int8) or ``<name>.q4`` (packed int4) beside ``<name>.scale``
(f32) — in files of at most ``FILE_BYTES`` each.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from pathlib import Path

import torch

from adversarial_spec_tpu_torch.models.config import ModelConfig
from adversarial_spec_tpu_torch.models.transformer import Params
from adversarial_spec_tpu_torch.ops.quant import QUANTIZABLE
from adversarial_spec_tpu_torch.utils import safetensors

CACHE_DIRNAME = ".native-cache-torch"
FORMAT = "adversarial_spec_tpu_torch/safetensors-1"
FILE_BYTES = 4 << 30


def _source_stat(checkpoint: str) -> list:
    """Cheap identity of the source weights: (name, size, mtime_ns) of
    every safetensors/index file — no content read. Replacing the weights
    in place (fine-tune update) therefore changes the fingerprint."""
    ckpt = Path(checkpoint)
    entries = []
    for pattern in ("*.safetensors", "*.safetensors.index.json"):
        for f in sorted(ckpt.glob(pattern)):
            st = f.stat()
            entries.append([f.name, st.st_size, st.st_mtime_ns])
    return entries


def transposed_head_flag() -> bool:
    """ONE reading of ADVSPEC_TRANSPOSED_HEAD (default on) — the cache
    fingerprint, the cache's expected layout and the HF loader must all
    parse it identically or caches thrash."""
    return os.environ.get("ADVSPEC_TRANSPOSED_HEAD", "1") != "0"


def cache_dir_for(
    checkpoint: str,
    family: str,
    size: str,
    dtype: str,
    quant: str = "",
    tied_embeddings: bool = False,
) -> Path:
    # The flag changes the layout of tied configs only (an lm_head_t
    # leaf): untied configs keep one fingerprint under both values.
    t_head = tied_embeddings and transposed_head_flag()
    fingerprint = hashlib.sha1(
        json.dumps(
            [FORMAT, family, size, dtype, quant, int(t_head), _source_stat(checkpoint)]
        ).encode()
    ).hexdigest()[:12]
    return Path(checkpoint) / CACHE_DIRNAME / fingerprint


def _sweep_stale_tmp(cache_parent: Path, max_age_s: float = 86400.0) -> None:
    """Remove abandoned writer tmp dirs (``*.tmp-<pid>-<hex>``) older than
    a day: a writer killed mid-save never runs its cleanup, and no live
    writer holds one that long. Best-effort; errors never block a save."""
    try:
        now = time.time()
        for entry in cache_parent.iterdir():
            if ".tmp-" in entry.name and entry.is_dir():
                try:
                    if now - entry.stat().st_mtime > max_age_s:
                        shutil.rmtree(entry, ignore_errors=True)
                except OSError:
                    pass
    except OSError:
        pass


def layer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Each per-layer leaf's full-precision shape (``[in, out]`` for the
    matmul weights), in the order the loader reads them."""
    D, F = cfg.dim, cfg.ffn_dim
    QD, KD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {
        "attn_norm": (D,), "wq": (D, QD), "wk": (D, KD), "wv": (D, KD),
        "wo": (QD, D), "ffn_norm": (D,), "w_gate": (D, F), "w_up": (D, F),
        "w_down": (F, D),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(QD,), bk=(KD,), bv=(KD,))
    if cfg.post_norms:
        shapes.update(post_attn_norm=(D,), post_ffn_norm=(D,))
    return shapes


def layout(
    cfg: ModelConfig, dtype: torch.dtype, quant: str, transposed_head: bool
) -> dict[str, tuple[torch.dtype, tuple[int, ...]]]:
    """Flat name → (dtype, shape) of every leaf the params hold."""
    D, V = cfg.dim, cfg.vocab_size
    out: dict[str, tuple[torch.dtype, tuple[int, ...]]] = {}

    def leaf(name: str, key: str, shape: tuple[int, ...]) -> None:
        if not quant or key not in QUANTIZABLE:
            out[name] = (dtype, shape)
            return
        k, n = shape
        q = "q" if quant == "int8" else "q4"
        out[f"{name}.{q}"] = (torch.int8, (k if q == "q" else (k + 1) // 2, n))
        out[f"{name}.scale"] = (torch.float32, (1, n))

    leaf("embed", "embed", (V, D))
    for i in range(cfg.n_layers):
        for key, shape in layer_shapes(cfg).items():
            leaf(f"layers.{i}.{key}", key, shape)
    leaf("final_norm", "final_norm", (D,))
    if not cfg.tied_embeddings:
        leaf("lm_head", "lm_head", (D, V))
    elif transposed_head:
        leaf("lm_head_t", "lm_head_t", (D, V))
    return out


def flatten(params: Params) -> dict[str, torch.Tensor]:
    """Params → {flat name: tensor}, in the cache's order."""
    flat: dict[str, torch.Tensor] = {}

    def put(name: str, leaf) -> None:
        if isinstance(leaf, dict):  # a quantized leaf
            for k, v in leaf.items():
                flat[f"{name}.{k}"] = v
        else:
            flat[name] = leaf

    put("embed", params["embed"])
    for i, lp in enumerate(params["layers"]):
        for key, leaf in lp.items():
            put(f"layers.{i}.{key}", leaf)
    for name in ("final_norm", "lm_head", "lm_head_t"):
        if name in params:
            put(name, params[name])
    return flat


def unflatten(flat: dict[str, torch.Tensor], n_layers: int) -> Params:
    """Inverse of :func:`flatten`."""
    params: Params = {"layers": [{} for _ in range(n_layers)]}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            node, parts = params["layers"][int(parts[1])], parts[2:]
        else:
            node = params
        if len(parts) == 2:  # a quantized leaf's part
            node = node.setdefault(parts[0], {})
        node[parts[-1]] = t
    return params


def save_native(params: Params, cache_dir: Path) -> None:
    """Write the converted params atomically.

    Per-writer unique tmp dir + rename: concurrent cold-cache processes
    never see each other's partial writes, and whichever rename lands
    first wins. Leaves go to the host one at a time (``save_file``)."""
    cache_dir = Path(cache_dir)
    cache_dir.parent.mkdir(parents=True, exist_ok=True)
    _sweep_stale_tmp(cache_dir.parent)
    tmp = cache_dir.with_name(
        f"{cache_dir.name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    )
    tmp.mkdir()
    try:
        files: list[dict[str, torch.Tensor]] = [{}]
        used = 0
        for name, t in flatten(params).items():
            n = t.numel() * t.element_size()
            if files[-1] and used + n > FILE_BYTES:
                files.append({})
                used = 0
            files[-1][name] = t
            used += n
        for k, chunk in enumerate(files, 1):
            safetensors.save_file(
                chunk,
                tmp / f"params-{k:05d}-of-{len(files):05d}.safetensors",
                metadata={"format": FORMAT},
            )
        try:
            tmp.rename(cache_dir)
        except OSError:
            if not cache_dir.exists():
                raise
            # another writer won the race — fine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_native(
    cache_dir: Path,
    cfg: ModelConfig,
    dtype: torch.dtype,
    quant: str,
    device: torch.device,
    transposed_head: bool | None = None,
    device_put=None,
) -> Params:
    """The cached params on ``device``. Raises ``ValueError`` (a
    ``SafetensorsError`` for a malformed file) unless the cache holds
    exactly the leaves ``layout`` expects, each of its dtype and shape;
    every header is checked before any tensor is read. ``device_put``
    (the mesh placement hook, ``parallel/sharding.py``) places each
    tensor as it is read, before the next is."""
    if transposed_head is None:
        transposed_head = transposed_head_flag()
    want = layout(cfg, dtype, quant, transposed_head)
    files = sorted(Path(cache_dir).glob("*.safetensors"))
    headers = [(f, safetensors.read_header(f)) for f in files]
    seen: dict[str, tuple[Path, safetensors.Header]] = {}
    for f, header in headers:
        if (header.metadata or {}).get("format") != FORMAT:
            raise ValueError(f"{f}: not a {FORMAT} cache file")
        for name, info in header.tensors.items():
            if name not in want or name in seen:
                raise ValueError(f"{f}: unexpected or repeated leaf {name!r}")
            w_dtype, w_shape = want[name]
            got = (safetensors.DTYPES[info.dtype], info.shape)
            if got != (w_dtype, w_shape):
                raise ValueError(
                    f"{f}: leaf {name!r} is {got}, the layout needs {(w_dtype, w_shape)}"
                )
            seen[name] = (f, header)
    missing = sorted(set(want) - set(seen))
    if missing:
        raise ValueError(f"{cache_dir}: cache lacks {len(missing)} leaves, e.g. {missing[:3]}")
    put = device_put or (lambda path, t: t)
    flat = {
        name: put(tuple(name.split(".")), safetensors.read_tensor(f, name, header).to(device))
        for name, (f, header) in seen.items()
    }
    return unflatten(flat, cfg.n_layers)


def has_native(cache_dir: Path) -> bool:
    return Path(cache_dir).is_dir()
