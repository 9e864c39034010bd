"""The port's GpuEngine against the reference's TpuEngine, on the same
(bridged) weights.

``tpu://random-tiny`` is registered here in f32 on a one-device mesh (a
user registry entry, which both packages read from the same file and
which wins over the built-in): f32 is where the two attention paths agree
closely enough for greedy text to be byte-identical.
"""

import jax
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import registry as jax_registry
from adversarial_spec_tpu.engine import spec as jax_spec
from adversarial_spec_tpu.engine.tpu import TpuEngine
from adversarial_spec_tpu.engine.types import ChatRequest as JaxChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as JaxParams
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams

USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially."),
    ("You are a PM.", "# Spec\nAcceptance: an integration test. " * 3),
]


@pytest.fixture
def shared_registry(tmp_path, monkeypatch):
    """One registry file for both packages, with tiny f32 entries."""
    path = tmp_path / "registry.json"
    monkeypatch.setattr(jax_registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    for spec in (
        registry.ModelSpec(
            alias="random-tiny", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1},
        ),
        registry.ModelSpec(alias="paged-tiny", kv="paged"),
        registry.ModelSpec(alias="int8-tiny", quant="int8"),
    ):
        registry.save_registry_entry(spec, path)
    return path


@pytest.mark.parametrize("speculative", [True, False], ids=["spec", "nospec"])
def test_chat_text_and_usage_match_reference(shared_registry, speculative, monkeypatch):
    monkeypatch.setattr(jax_spec.config(), "enabled", speculative)
    monkeypatch.setenv("ADVSPEC_SPECULATIVE", "1" if speculative else "0")
    from adversarial_spec_tpu_torch.engine import spec as port_spec

    monkeypatch.setattr(port_spec.config(), "enabled", speculative)
    ref_engine = TpuEngine()
    lm = ref_engine._load("random-tiny")
    np_params = jax.tree.map(np.asarray, lm.params)
    ref = ref_engine.chat(
        [JaxChatRequest("tpu://random-tiny", s, u) for s, u in USERS],
        JaxParams(max_new_tokens=32, greedy=True),
    )

    port = GpuEngine(device="cpu")
    port.install(
        "random-tiny",
        params_from_jax(np_params, lm.cfg, "cpu", torch.float32),
    )
    got = port.chat(
        [ChatRequest("tpu://random-tiny", s, u) for s, u in USERS],
        SamplingParams(max_new_tokens=32, greedy=True),
    )
    assert [c.ok for c in got] == [True] * len(USERS)
    for r, g in zip(ref, got):
        assert g.text == r.text
        assert g.text.encode() == r.text.encode()
        for field in ("input_tokens", "output_tokens", "decode_tokens"):
            assert getattr(g.usage, field) == getattr(r.usage, field)
        assert g.usage.device_time_s > 0 and g.usage.decode_time_s >= 0
    # Row attribution sums to the call totals (decode by tokens).
    total_decode = sum(c.usage.decode_time_s for c in got)
    total_prefill = sum(c.usage.prefill_time_s for c in got)
    assert total_decode >= 0 and total_prefill > 0
    assert sum(c.usage.device_time_s for c in got) >= total_decode


@pytest.mark.parametrize("alias", ["paged-tiny", "int8-tiny"])
def test_unported_specs_get_not_yet_ported_error(shared_registry, alias):
    port = GpuEngine(device="cpu")
    comps = port.chat(
        [ChatRequest(f"tpu://{alias}", "s", "u")] * 2,
        SamplingParams(max_new_tokens=4, greedy=True),
    )
    assert len(comps) == 2
    for c in comps:
        assert not c.ok and "not yet ported" in c.error
        assert c.text == ""


def test_unknown_alias_and_validate(shared_registry):
    port = GpuEngine(device="cpu")
    assert port.validate("tpu://random-tiny") is None
    assert "unknown tpu model alias" in port.validate("tpu://nope")
    comp = port.chat(
        [ChatRequest("tpu://nope", "s", "u")],
        SamplingParams(max_new_tokens=4, greedy=True),
    )[0]
    assert not comp.ok and "nope" in comp.error


def test_chat_serves_random_alias_on_cpu(shared_registry):
    """Loading path: the port materializes its own synthetic weights."""
    port = GpuEngine(device="cpu")
    comps = port.chat(
        [ChatRequest("tpu://random-gemma-tiny", "s", "hello")] * 2,
        SamplingParams(max_new_tokens=8, greedy=True),
    )
    assert all(c.ok for c in comps)
    assert comps[0].text == comps[1].text  # identical prompts, greedy
    assert comps[0].usage.output_tokens == 8


def test_engine_requires_device_or_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuEngine()
