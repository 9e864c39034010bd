"""Provider dispatch: model-id prefix → engine instance.

Counterpart of ``adversarial_spec_tpu/engine/dispatch.py``: ``mock://`` ids
map to one cached ``MockEngine`` and ``tpu://`` ids to one cached
``GpuEngine`` (all ``tpu://`` models share it, so same-model opponents
batch). When the fleet is armed (``fleet.armed()``), ``get_engine``
hands out the process ``FleetEngine`` instead, whose replicas build their
own engines through ``new_engine``. While the serve daemon is up, the
engine comes behind the daemon's scheduler gate (serve/gate.py), as the
reference's does; otherwise the engine itself.

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
    """A FRESH engine instance for this model's provider — the replica
    lifecycle seam (fleet/replica.py): each fleet replica must own its
    engine (allocator, prefix cache, batchers), so replicas build here
    instead of sharing the process cache below. A ``tpu://`` engine
    runs on the GPU unless ``device`` names another; with no GPU it
    raises ``RuntimeError`` (utils/device.py)."""
    if _provider_key(model) == "mock":
        from adversarial_spec_tpu_torch.engine.mock import MockEngine

        return MockEngine()
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

    return GpuEngine(device=device)


def get_engine(model: str, device=None):
    """The engine that serves this model id: the process fleet (one
    FleetEngine over N replicas) when the fleet is armed, else the
    cached engine of its provider. While the serve daemon is up it comes
    wrapped by the scheduler gate: same ``chat``, but its calls
    interleave fair-share with every other debate's, and only the
    daemon's pump thread reaches the engine."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.serve import gate as serve_gate

    key = _provider_key(model)  # validate the id either way
    if fleet_mod.armed():
        return serve_gate.wrap(fleet_mod.fleet_engine())
    with _CACHE_LOCK:
        if key not in _ENGINE_CACHE:
            _ENGINE_CACHE[key] = new_engine(model, device=device)
        engine = _ENGINE_CACHE[key]
    return serve_gate.wrap(engine)


def install_engine(model: str, engine) -> None:
    """Serve every id of ``model``'s provider through ``engine``."""
    key = _provider_key(model)
    with _CACHE_LOCK:
        _ENGINE_CACHE[key] = engine


def cached_engines() -> list:
    """The process's live inner engines (no gate wrappers) — the serve
    daemon's ``check`` op walks these for allocator/tier invariants."""
    with _CACHE_LOCK:
        return list(_ENGINE_CACHE.values())


def clear_engine_cache() -> None:
    """Drop cached engines (and their loaded weights) and tear down the
    process fleet."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod

    with _CACHE_LOCK:
        _ENGINE_CACHE.clear()
    fleet_mod.shutdown_fleet()
