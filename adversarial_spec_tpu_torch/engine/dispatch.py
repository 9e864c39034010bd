"""Provider dispatch: model-id prefix → engine instance.

Counterpart of ``adversarial_spec_tpu/engine/dispatch.py``: ``mock://`` ids
map to one cached ``MockEngine`` and ``tpu://`` ids to one cached
``GpuEngine`` (all ``tpu://`` models share it, so same-model opponents
batch). The fleet and the serve daemon's scheduler gate, which the
reference wraps around the cached engine, are not ported: the engine is
returned as it is.

``install_engine`` puts a caller-built engine into the cache, e.g. a
``GpuEngine(device="cpu")`` holding weights bridged from the reference,
so that the CLI serves through it without a flag of its own.
"""

from __future__ import annotations

from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod

_ENGINE_CACHE: dict[str, object] = {}
# Engines are resolved from the debate layer; double-building a
# provider's engine (two weight sets) must not be a race outcome.
_CACHE_LOCK = lockdep_mod.make_lock("dispatch._CACHE_LOCK")


def _provider_key(model: str) -> str:
    if model.startswith("mock://"):
        return "mock"
    if model.startswith("tpu://"):
        return "tpu"
    raise ValueError(
        f"unknown provider for model {model!r}: expected a 'mock://' or "
        "'tpu://' id (remote HTTP providers are intentionally not part "
        "of this framework — register a local checkpoint instead)"
    )


def new_engine(model: str, device=None):
    """A fresh engine for this model's provider. A ``tpu://`` engine
    runs on the GPU unless ``device`` names another; with no GPU it
    raises ``RuntimeError`` (utils/device.py)."""
    if _provider_key(model) == "mock":
        from adversarial_spec_tpu_torch.engine.mock import MockEngine

        return MockEngine()
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

    return GpuEngine(device=device)


def get_engine(model: str, device=None):
    """The cached engine that serves this model id."""
    key = _provider_key(model)
    with _CACHE_LOCK:
        if key not in _ENGINE_CACHE:
            _ENGINE_CACHE[key] = new_engine(model, device=device)
        return _ENGINE_CACHE[key]


def install_engine(model: str, engine) -> None:
    """Serve every id of ``model``'s provider through ``engine``."""
    key = _provider_key(model)
    with _CACHE_LOCK:
        _ENGINE_CACHE[key] = engine


def cached_engines() -> list:
    """The process's live engines."""
    with _CACHE_LOCK:
        return list(_ENGINE_CACHE.values())


def clear_engine_cache() -> None:
    """Drop cached engines (and their loaded weights)."""
    with _CACHE_LOCK:
        _ENGINE_CACHE.clear()
