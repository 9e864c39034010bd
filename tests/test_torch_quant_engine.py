"""The port's weight-quantized serving against the reference's, on the same
(bridged) quantized weights.

- ``forward`` logits of the tiny f32 llama and gemma2 (tied head, so
  ``lm_head_t`` is quantized), int8 and int4, through a left-padded
  prefill chunk, an S=1 step and a 9-position verify span, against the
  reference's ``forward(use_pallas_matmul=True, pallas_interpret=True)``
  (the Pallas B5/B6 kernels in interpret mode): atol/rtol 1e-4 (f32; the
  two sum in different orders).
- Greedy ``generate()`` tokens IDENTICAL to the reference's
  ``generate(use_pallas_matmul=True)``, speculation on and off.
- Greedy paged-batcher tokens IDENTICAL to the reference batcher's with
  ``use_pallas_matmul=True``.
- ``GpuEngine(device="cpu").chat`` text byte-identical to ``TpuEngine``
  for f32 ``quant="int8"`` / ``"int4"`` specs, dense and paged (the
  reference engine off the TPU takes its XLA dequant path, which in f32
  is the kernels' arithmetic).

f32 throughout: there the port's plain versions and the reference agree
to ~1e-6, far from any argmax near-tie of these models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.engine import interleave as jax_interleave
from adversarial_spec_tpu.engine import kvtier as jax_kvtier
from adversarial_spec_tpu.engine import prefix_cache as jax_prefix
from adversarial_spec_tpu.engine import registry as jax_registry
from adversarial_spec_tpu.engine import scheduler as jax_sched
from adversarial_spec_tpu.engine import spec as jax_spec
from adversarial_spec_tpu.engine.tpu import TpuEngine
from adversarial_spec_tpu.engine.types import ChatRequest as JaxChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as JaxParams
from adversarial_spec_tpu.models import config as jax_config
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.ops import quant as jax_quant
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import scheduler as sched
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models import transformer as tf
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.ops import quant

F32_TOL = dict(rtol=1e-4, atol=1e-4)
FMTS = ["int8", "int4"]


def _bridged(family: str, fmt: str):
    """The reference's tiny f32 params quantized by the reference, and the
    same quantized leaves bridged into the port."""
    cfg = jax_config.get_config(family, "tiny")
    jp = jax_quant.quantize_params(
        jax_tf.init_params(jax.random.key(0), cfg, jnp.float32), fmt=fmt
    )
    tp = params_from_jax(
        jax.tree.map(np.asarray, jp), get_config(family, "tiny"), "cpu", torch.float32
    )
    return cfg, jp, tp


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(family, fmt):
        if (family, fmt) not in cache:
            cache[family, fmt] = _bridged(family, fmt)
        return cache[family, fmt]

    return get


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_forward_logits_match_reference_kernels(models, family, fmt):
    cfg, jp, tp = models(family, fmt)
    pcfg = get_config(family, "tiny")
    assert all(quant.is_quantized(lp[k]) or quant.is_quantized_int4(lp[k])
               for lp in tp["layers"] for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    head = "lm_head_t" if cfg.tied_embeddings else "lm_head"
    assert quant.is_quantized(tp[head]) or quant.is_quantized_int4(tp[head])
    B, S, T = 2, 40, 64
    rng = np.random.default_rng(5)
    pads = np.asarray([0, 7], np.int32)
    slots = np.arange(T)[None, :]
    kv_base = slots >= pads[:, None]
    jcache = jax_tf.init_cache(cfg, B, T, dtype=jnp.float32)
    tcache = tf.init_cache(pcfg, B, T, device="cpu", dtype=torch.float32)

    def step(tokens, positions, cache_index, kv_valid):
        nonlocal jcache
        jl, jcache = jax_tf.forward(
            jp, cfg, jnp.asarray(tokens), jnp.asarray(positions), jcache,
            jnp.asarray(cache_index), jnp.asarray(kv_valid),
            use_pallas_matmul=True, pallas_interpret=True,
        )
        ci = (
            torch.from_numpy(np.asarray(cache_index, np.int64))
            if np.ndim(cache_index) else int(cache_index)
        )
        tl = tf.forward(
            tp, pcfg, torch.from_numpy(tokens),
            torch.from_numpy(np.asarray(positions, np.int64)), tcache, ci,
            torch.from_numpy(kv_valid), use_kernels=False,
        )
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)

    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    step(toks, np.maximum(np.arange(S)[None, :] - pads[:, None], 0), 0, kv_base)
    nxt = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
    step(nxt, (S - pads)[:, None], S, kv_base & (slots <= S))
    ci = np.asarray([S + 1, S + 3], np.int32)
    span = rng.integers(3, cfg.vocab_size, (B, 9)).astype(np.int32)
    step(span, ci[:, None] + np.arange(9) - pads[:, None], ci, kv_base)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **F32_TOL)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        base = rng.integers(3, vocab, 12).tolist()
        out.append([1] + (base * (n // 12 + 1))[:n])  # repetitive: real drafts
    return out


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
@pytest.mark.parametrize("fmt", FMTS)
def test_greedy_generate_identical_to_reference(models, fmt, spec, monkeypatch):
    cfg, jp, tp = models("llama", fmt)
    monkeypatch.setattr(jax_spec.config(), "gamma", 8)
    prompts = _prompts(cfg.vocab_size, [40, 97, 13])
    ref = jax_gen.generate(
        jp, cfg, prompts, max_new_tokens=32, eos_ids=[2], greedy=True,
        speculative=spec, use_pallas_matmul=True,
    )
    got = gen.generate(
        tp, get_config("llama", "tiny"), prompts, max_new_tokens=32, eos_ids=[2],
        greedy=True, speculative=spec, device="cpu",
    )
    np.testing.assert_array_equal(got.n_generated, ref.n_generated)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.decode_tokens == ref.decode_tokens


@pytest.fixture
def batcher_defaults(monkeypatch):
    """The reference batcher reads process-wide knobs at construction that
    other test files of the same worker may have moved: pin the defaults."""
    for cfg, values in (
        (jax_prefix.config(), {"enabled": True, "max_pages": 0}),
        (jax_kvtier.config(), {"enabled": False}),
        (jax_interleave.config(), {"enabled": True, "pipeline_depth": 2}),
    ):
        for name, value in values.items():
            monkeypatch.setattr(cfg, name, value)


@pytest.mark.parametrize("fmt", FMTS)
def test_paged_batcher_identical_to_reference(models, fmt, batcher_defaults):
    """Five requests through two slots (queueing, slot reuse), speculation
    on, the reference's batcher running B5/B6 in interpret mode."""
    cfg, jp, tp = models("llama", fmt)
    rng = np.random.default_rng(0)
    lens, budgets = [3, 70, 150, 9, 33], [8, 20, 12, 30, 17]
    prompts = [[int(t) for t in rng.integers(3, 500, size=n)] for n in lens]
    kw = dict(
        max_batch=2, page_size=16, capacity_tokens=2048, max_new_cap=32,
        eos_ids=[], speculative=True, gamma=8, prefix_cache=True, chunk=32,
    )
    out = {}
    for name, mod, p, c, extra in (
        ("jax", jax_sched, jp, cfg, {"use_pallas_matmul": True}),
        ("port", sched, tp, get_config("llama", "tiny"), {}),
    ):
        b = mod.ContinuousBatcher(p, c, **kw, **extra)
        for i, (pr, n) in enumerate(zip(prompts, budgets)):
            b.submit(mod.SchedRequest(req_id=i, prompt_ids=pr, max_new_tokens=n))
        out[name] = b.run_all()
    for r, g in zip(out["jax"], out["port"]):
        assert g.req_id == r.req_id and g.n_generated == r.n_generated
        np.testing.assert_array_equal(
            g.tokens[: g.n_generated], np.asarray(r.tokens)[: r.n_generated]
        )
    assert [g.n_generated for g in out["port"]] == budgets


USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially."),
    ("You are a PM.", "# Spec\nAcceptance: an integration test. " * 3),
]


@pytest.fixture
def quant_registry(tmp_path, monkeypatch):
    """One registry file for both packages: tiny f32 quantized entries."""
    path = tmp_path / "registry.json"
    monkeypatch.setattr(jax_registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    for fmt in FMTS:
        for kv in ("dense", "paged"):
            registry.save_registry_entry(
                registry.ModelSpec(
                    alias=f"{fmt}-{kv}", family="llama", size="tiny",
                    dtype="float32", mesh={"dp": 1}, quant=fmt, kv=kv,
                ),
                path,
            )
    return path


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("fmt", FMTS)
def test_chat_text_matches_reference(quant_registry, batcher_defaults, fmt, kv, monkeypatch):
    monkeypatch.setattr(jax_spec.config(), "gamma", 8)
    monkeypatch.setattr(port_spec.config(), "gamma", 8)
    alias = f"{fmt}-{kv}"
    ref_engine = TpuEngine()
    lm = ref_engine._load(alias)
    assert jax_quant.has_quantized_weights(lm.params)
    sp = dict(max_new_tokens=24, greedy=True)
    ref = ref_engine.chat([JaxChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], JaxParams(**sp))
    port = GpuEngine(device="cpu")
    port.install(
        alias, params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32)
    )
    got = port.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], SamplingParams(**sp))
    assert [c.ok for c in got] == [True] * len(USERS), [c.error for c in got]
    for r, g in zip(ref, got):
        assert g.text.encode() == r.text.encode()
        assert (g.usage.input_tokens, g.usage.output_tokens) == (
            r.usage.input_tokens, r.usage.output_tokens,
        )


def test_chat_materializes_quantized_spec(quant_registry):
    """The port's own load path quantizes at materialization: a quant spec
    is served, its params carry quantized leaves, nothing full-precision
    is left among the matmul weights."""
    port = GpuEngine(device="cpu")
    comps = port.chat(
        [ChatRequest("tpu://int4-dense", "s", "hello")] * 2,
        SamplingParams(max_new_tokens=8, greedy=True),
    )
    assert all(c.ok for c in comps), [c.error for c in comps]
    assert comps[0].text == comps[1].text and comps[0].usage.output_tokens == 8
    params = port._resident.params
    assert quant.is_quantized_int4(params["lm_head"])
    assert all(quant.is_quantized_int4(lp[n]) for lp in params["layers"] for n in ("wq", "w_down"))
