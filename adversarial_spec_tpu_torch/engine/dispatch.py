"""Provider dispatch: model-id prefix → engine instance.

Counterpart of ``adversarial_spec_tpu/engine/dispatch.py`` for this slice:
``tpu://`` ids map to one cached ``GpuEngine`` (all ``tpu://`` models share
it, so same-model opponents batch). ``mock://`` comes with the
debate-layer slice.
"""

from __future__ import annotations

import threading

from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

_ENGINE_CACHE: dict[str, GpuEngine] = {}
_CACHE_LOCK = threading.Lock()


def _provider_key(model: str) -> str:
    if model.startswith("tpu://"):
        return "tpu"
    raise ValueError(
        f"unknown provider for model {model!r}: the PyTorch port serves "
        "'tpu://' ids ('mock://' is not ported yet)"
    )


def new_engine(model: str, device=None) -> GpuEngine:
    """A fresh engine for this model's provider."""
    _provider_key(model)
    return GpuEngine(device=device)


def get_engine(model: str, device=None) -> GpuEngine:
    """The cached engine that serves this model id."""
    key = _provider_key(model)
    with _CACHE_LOCK:
        if key not in _ENGINE_CACHE:
            _ENGINE_CACHE[key] = new_engine(model, device=device)
        return _ENGINE_CACHE[key]


def clear_engine_cache() -> None:
    """Drop cached engines (and their loaded weights)."""
    with _CACHE_LOCK:
        _ENGINE_CACHE.clear()
