"""The check comes out false for a lower-precision program and for the
faults a served cell can have, each planted under a run at tiny widths on
the CPU (the harness's look for a card skipped: ``run_cell`` directly)."""

from __future__ import annotations

import pytest

from conftest import make_root
from portbench import control, harness


def _run(root, cell, seed=31):
    return harness.run_cell(cell, seed, 1.0, False, device="cpu", root=root / "portbench")


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_lower_precision_control_fails_the_check(tmp_path, kv):
    """The program with its int8 weight path on, the control that
    ``control.py`` reads at each cell's own size on the card, fails the
    check that its sound runs pass."""
    root, cells = make_root(tmp_path, max_new_tokens=48)
    got = [control.reading(cells[kv], s, "int8", "cpu", root / "portbench") for s in (1, 2, 3)]
    assert all(r["program"]["correct"] and r["program"]["served_gap"] <= 1e-4 for r in got)
    assert not any(r["control"]["correct"] for r in got)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_an_altered_token_fails_the_check(tiny_root, kv, monkeypatch):
    """Each greedy token shifted by one where it is sampled."""
    import adversarial_spec_tpu_torch.engine.sampling as sampling

    root, cells = tiny_root
    real = sampling.sample_tokens

    def shifted(logits, generator, **kw):
        out = real(logits, generator, **kw)
        return (out + 1) % logits.shape[-1] if kw.get("greedy") else out

    import sys

    for name, mod in list(sys.modules.items()):
        if name.startswith("adversarial_spec_tpu_torch.") and getattr(mod, "sample_tokens", None) is real:
            monkeypatch.setattr(mod, "sample_tokens", shifted)
    out = _run(root, cells[kv])
    assert out["failed"] == 0 and out["correct"] is False
    assert out["checks"]["served_gap"]["value"] > out["checks"]["served_gap"]["limit"]


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_a_cache_left_unchanged_fails_the_check(tiny_root, kv, monkeypatch):
    """The step's state unchanged: no key or value is ever stored, so
    every step attends over zeros."""
    import adversarial_spec_tpu_torch.engine.scheduler as sched
    import adversarial_spec_tpu_torch.models.transformer as tf

    root, cells = tiny_root
    monkeypatch.setattr(tf, "_write_kv", lambda pairs, cache_index, keep=None: None)
    monkeypatch.setattr(tf, "_paged_store", lambda pool, layer_id, *a: (
        pool["k"][layer_id], pool["v"][layer_id], {}))
    monkeypatch.setattr(sched, "write_tokens", lambda pool, *a, **k: None)
    out = _run(root, cells[kv])
    assert out["correct"] is False


def test_half_the_rows_left_out_fails_the_check(tiny_root, monkeypatch):
    """The engine serves the first half of a round's rows and leaves the
    rest unanswered."""
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import Completion

    root, cells = tiny_root
    real = GpuEngine._chat_loaded

    def half(self, lm, batch, params, consumer=None):
        k = len(batch) // 2 or 1
        served = real(self, lm, batch[:k], params, consumer)
        return served + [Completion(error="left out") for _ in batch[k:]]

    monkeypatch.setattr(GpuEngine, "_chat_loaded", half)
    out = _run(root, cells["dense"])
    assert out["failed"] > 0 and out["correct"] is False


def test_gpu_cell_runs_on_the_card(card, tiny_root):
    """On a card: one short run of a tiny dense cell through the kernels."""
    root, cells = tiny_root
    out = harness.run_cell(cells["dense"], 41, 2.0, True, device="cuda", root=root / "portbench")
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
