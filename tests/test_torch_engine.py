"""The port's GpuEngine against the reference's TpuEngine, on the same
(bridged) weights.

``tpu://random-tiny`` (dense) and ``tpu://paged-f32`` (``kv="paged"``, the
continuous batcher) are registered here in f32 on a one-device mesh (user
registry entries, which both packages read from the same file): f32 is
where the two attention paths agree closely enough for greedy text to be
byte-identical. So are the int8 KV cache's specs (``kv_dtype="int8"``),
dense and paged, alone and beside quantized weights.
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
        registry.ModelSpec(
            alias="paged-f32", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1}, kv="paged",
        ),
        # A paged spec whose context leaves no room for a bucketed prompt
        # beside the budget: the reference's round-synchronous
        # generate(paged=True) corner, served with the reference's text.
        registry.ModelSpec(
            alias="paged-tiny", family="llama", size="tiny", dtype="float32",
            mesh={"dp": 1}, kv="paged", max_seq_len=130,
        ),
        # A paged alias on a mesh the port does not serve yet (an sp
        # axis; dp, tp and dp×tp meshes are served, tests/test_torch_parallel.py).
        registry.ModelSpec(alias="paged-mesh", kv="paged", mesh={"tp": 2, "sp": 2}),
        # An HF checkpoint alias whose directory holds no weights: served
        # now, so both engines answer it with the same error.
        registry.ModelSpec(alias="paged-hf", kv="paged", checkpoint="/no/such/dir"),
        # The int8 KV cache, dense and paged, alone and beside quantized
        # weights: served, with the reference's text.
        *(
            registry.ModelSpec(
                alias=alias, family="llama", size="tiny", dtype="float32",
                mesh={"dp": 1}, kv=kv, quant=quant, kv_dtype="int8",
            )
            for alias, kv, quant in (
                ("int8-tiny", "dense", "int8"),
                ("dense-int8kv", "dense", ""),
                ("paged-int8kv", "paged", ""),
                ("paged-int8kv-int4", "paged", "int4"),
            )
        ),
        # The paged budget corner with the int8 KV cache: int8 pages
        # through generate(paged=True).
        registry.ModelSpec(
            alias="paged-tiny-int8kv", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1}, kv="paged", max_seq_len=130,
            kv_dtype="int8",
        ),
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


def _chat_matches_reference(alias: str) -> GpuEngine:
    """One chat() of USERS on ``alias`` through both engines, on the same
    (bridged) weights: every row ok, text byte-identical, usage tokens
    equal. Returns the port's engine."""
    ref_engine, port = _bridged_engines(alias)
    sp = dict(max_new_tokens=24, greedy=True)
    ref = ref_engine.chat(
        [JaxChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], JaxParams(**sp)
    )
    got = port.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], SamplingParams(**sp))
    assert [c.ok for c in got] == [True] * len(USERS), [c.error for c in got]
    for r, g in zip(ref, got):
        assert g.text.encode() == r.text.encode()
        for field in ("input_tokens", "output_tokens", "cached_tokens"):
            assert getattr(g.usage, field) == getattr(r.usage, field)
    return port


# Refused until the int8 KV cache (and, for paged-tiny, the
# round-synchronous generate(paged=True)) was ported; served now.
SERVED_NOW = ("int8-tiny", "paged-int8kv", "paged-tiny")


@pytest.mark.parametrize(
    "alias", ["paged-tiny", "int8-tiny", "paged-int8kv", "paged-mesh", "paged-hf"]
)
def test_unported_specs_get_not_yet_ported_error(shared_registry, serving_defaults, alias):
    """Each row of a spec the port cannot serve yet gets a "not yet
    ported" error. The int8 KV cache's cases and the paged budget corner
    (``SERVED_NOW``) are served instead, with the reference's text; the
    corner builds no batcher. An HF checkpoint (``paged-hf``) is
    served too: its directory holds no weights, so both engines answer
    every row with an error of the same fault kind."""
    if alias in SERVED_NOW:
        port = _chat_matches_reference(alias)
        if alias == "paged-tiny":
            assert port._models[alias].batcher is None
            return
        cache = port._models[alias].batcher.pool if alias.startswith("paged") else None
        assert cache is None or cache["k"].dtype == torch.int8
        return
    if alias == "paged-hf":
        from adversarial_spec_tpu.resilience.faults import classify_message as ref_classify
        from adversarial_spec_tpu_torch.resilience.faults import classify_message

        sp = dict(max_new_tokens=4, greedy=True)
        ref = TpuEngine().chat([JaxChatRequest("tpu://paged-hf", "s", "u")] * 2, JaxParams(**sp))
        got = GpuEngine(device="cpu").chat(
            [ChatRequest("tpu://paged-hf", "s", "u")] * 2, SamplingParams(**sp)
        )
        assert [c.ok for c in ref + got] == [False] * 4
        assert [c.error for c in got] == [c.error for c in ref]
        assert "no *.safetensors under /no/such/dir" in got[0].error
        assert "not yet ported" not in got[0].error
        assert classify_message(got[0].error).value == ref_classify(ref[0].error).value
        assert [c.transient for c in got] == [c.transient for c in ref]
        return
    port = GpuEngine(device="cpu")
    comps = port.chat(
        [ChatRequest(f"tpu://{alias}", "s", "u")] * 2,
        SamplingParams(max_new_tokens=4, greedy=True),
    )
    assert len(comps) == 2
    for c in comps:
        assert not c.ok and "not yet ported" in c.error
        assert c.text == ""


@pytest.mark.parametrize(
    "alias", ["dense-int8kv", "paged-int8kv-int4", "paged-tiny-int8kv"]
)
def test_int8kv_chat_text_matches_reference(shared_registry, serving_defaults, alias):
    """The int8 KV cache on the dense path with full-precision weights, on
    the paged path beside int4 weights (B6 with the int8-KV B3/B4), and
    in the paged budget corner (int8 pages through generate(paged=True),
    no batcher)."""
    port = _chat_matches_reference(alias)
    lm = port._models[alias]
    assert lm.spec.kv_dtype == "int8"
    if alias == "paged-tiny-int8kv":
        assert lm.batcher is None
    if lm.batcher is not None:
        assert lm.batcher.pool["ks"].dtype == torch.float32
        lm.batcher.allocator.check_invariants()


def _bridged_engines(alias):
    ref_engine = TpuEngine()
    lm = ref_engine._load(alias)
    np_params = jax.tree.map(np.asarray, lm.params)
    port = GpuEngine(device="cpu")
    port.install(alias, params_from_jax(np_params, lm.cfg, "cpu", torch.float32))
    return ref_engine, port


@pytest.fixture
def serving_defaults(monkeypatch):
    """Both engines' batchers read process-wide knobs (γ, prefix-cache
    cap, KV tiers, drive loop, streaming) that other test files of the
    same worker may have moved: pin the defaults for one test."""
    from adversarial_spec_tpu.engine import interleave, kvtier, prefix_cache, streaming
    from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
    from adversarial_spec_tpu_torch.engine import spec as port_spec

    for cfg, values in (
        (jax_spec.config(), {"gamma": 8}),
        (port_spec.config(), {"gamma": 8}),
        (prefix_cache.config(), {"enabled": True, "max_pages": 0}),
        (kvtier.config(), {"enabled": False}),
        (port_kvtier.config(), {"enabled": False}),
        (interleave.config(), {"enabled": True, "pipeline_depth": 2}),
        (streaming.config(), {"enabled": True}),
    ):
        for name, value in values.items():
            monkeypatch.setattr(cfg, name, value)


@pytest.mark.parametrize("speculative", [True, False], ids=["spec", "nospec"])
def test_paged_chat_text_matches_reference(
    shared_registry, serving_defaults, speculative, monkeypatch
):
    """Two rounds through both engines' continuous batchers: four
    requests through min(4, 8) slots, the second round on the SAME
    batcher hitting the prefix cache. Text byte-identical, usage tokens
    and cached tokens equal."""
    from adversarial_spec_tpu_torch.engine import spec as port_spec

    monkeypatch.setattr(jax_spec.config(), "enabled", speculative)
    monkeypatch.setattr(port_spec.config(), "enabled", speculative)
    ref_engine, port = _bridged_engines("paged-f32")
    users = USERS + [("You are a DBA.", "# Spec\nMigrations are reversible. " * 4)]
    for rnd in range(2):
        ref = ref_engine.chat(
            [JaxChatRequest("tpu://paged-f32", s, u) for s, u in users],
            JaxParams(max_new_tokens=24, greedy=True),
        )
        got = port.chat(
            [ChatRequest("tpu://paged-f32", s, u) for s, u in users],
            SamplingParams(max_new_tokens=24, greedy=True),
        )
        assert [c.ok for c in got] == [True] * len(users), [c.error for c in got]
        for r, g in zip(ref, got):
            assert g.text.encode() == r.text.encode()
            for field in ("input_tokens", "output_tokens", "cached_tokens"):
                assert getattr(g.usage, field) == getattr(r.usage, field)
        if rnd == 1:
            assert sum(c.usage.cached_tokens for c in got) > 0
    batcher = port._models["paged-f32"].batcher
    assert batcher is not None and batcher.speculative == speculative
    batcher.allocator.check_invariants()


def test_paged_chat_streams_and_cancels(shared_registry, serving_defaults):
    """A consumer that cancels request 1 after its first delivery: that
    completion is cancelled and its text is a prefix of the blocking run's;
    the other rows are untouched."""
    _, port = _bridged_engines("paged-f32")
    reqs = [ChatRequest("tpu://paged-f32", s, u) for s, u in USERS]
    sp = SamplingParams(max_new_tokens=24, greedy=True)
    blocking = port.chat(reqs, sp)
    seen = []

    def consumer(row, text):
        seen.append((row, text))
        return row != 1

    streamed = port.chat(reqs, sp, consumer=consumer)
    assert streamed[1].cancelled and blocking[1].text.startswith(streamed[1].text)
    assert streamed[1].usage.output_tokens < 24
    assert [c.text for i, c in enumerate(streamed) if i != 1] == [
        c.text for i, c in enumerate(blocking) if i != 1
    ]
    assert {row for row, _ in seen} == {0, 1, 2}


def test_paged_request_deadline_gets_not_yet_ported_error(shared_registry, serving_defaults):
    """A paged request with ``request_deadline_s > 0`` was refused with
    "not yet ported" until the batcher's per-request watchdog was ported
    (C.1). It is served now: with a deadline the requests meet, the
    completions equal the untimed ones, on the paged path and the dense
    path (whose ``generate()`` reads no such field, as the reference's)."""
    port = GpuEngine(device="cpu")
    timed = SamplingParams(max_new_tokens=4, greedy=True, request_deadline_s=300.0)
    untimed = SamplingParams(max_new_tokens=4, greedy=True)
    for alias in ("paged-f32", "random-tiny"):
        reqs = [ChatRequest(f"tpu://{alias}", "s", "u")] * 2
        got = port.chat(reqs, timed)
        assert [c.ok for c in got] == [True, True], [c.error for c in got]
        assert "not yet ported" not in "".join(c.error or "" for c in got)
        assert [c.text for c in got] == [c.text for c in port.chat(reqs, untimed)]
        assert [c.usage.output_tokens for c in got] == [4, 4]


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
