"""The port's sampling, speculative helpers and generate() against the
reference's, on the same (bridged) weights.

- ``filtered_logits``: equal to the reference for top-k, top-p and
  temperature 0 (the -inf pattern exactly, finite values to 1e-6).
- Greedy ``generate()``: tokens IDENTICAL to the reference's in f32, with
  speculation on and off, unequal prompts, identical prompts (the shared
  prefix path) and an EOS early exit. f32 because there the reference's
  CPU attention (plain XLA) and the port's plain kernel versions agree to
  ~1e-6, far from any argmax near-tie of these models.
- The clamp cases: reference ``dynamic_slice``/``dynamic_update_slice``
  clamp a start index so the slice fits; the port mirrors that.
- Sampled decoding cannot match the reference's random bits (threefry vs
  torch's generator), so it is checked by distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.engine import sampling as jax_sampling
from adversarial_spec_tpu.engine import spec as jax_spec
from adversarial_spec_tpu.engine import speculative as jax_specdec
from adversarial_spec_tpu.models import config as jax_config
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import sampling
from adversarial_spec_tpu_torch.engine import speculative as specdec
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models.config import get_config


@pytest.mark.parametrize(
    "kw",
    [
        dict(top_k=5, temperature=0.7, top_p=1.0, use_top_p=False),
        dict(top_k=0, temperature=1.3, top_p=0.9, use_top_p=True),
        dict(top_k=20, temperature=0.5, top_p=0.8, use_top_p=True),
        dict(top_k=0, temperature=0.0, top_p=1.0, use_top_p=False),
    ],
    ids=["top_k", "top_p", "top_k_top_p", "temperature_0"],
)
def test_filtered_logits_matches_reference(kw):
    logits = np.random.default_rng(0).standard_normal((3, 2, 256)) * 3
    logits = logits.astype(np.float32)
    ref = np.asarray(
        jax_sampling.filtered_logits(
            jnp.asarray(logits), greedy=False, top_k=kw["top_k"],
            temperature=jnp.float32(kw["temperature"]),
            top_p=jnp.float32(kw["top_p"]), use_top_p=kw["use_top_p"],
        )
    )
    got = sampling.filtered_logits(
        torch.from_numpy(logits), greedy=False, top_k=kw["top_k"],
        temperature=kw["temperature"], top_p=kw["top_p"],
        use_top_p=kw["use_top_p"],
    ).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_sampling_distribution_matches_filtered_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5]])
    filt = sampling.filtered_logits(
        logits, greedy=False, top_k=3, temperature=0.8, top_p=1.0,
        use_top_p=False,
    )
    want = torch.softmax(filt, -1)[0].numpy()
    g = torch.Generator().manual_seed(0)
    n = 20000
    draws = sampling.sample_tokens(
        logits.expand(n, 5), g, greedy=False, top_k=3, temperature=0.8,
        top_p=1.0, use_top_p=False,
    )
    freq = np.bincount(draws.numpy(), minlength=5) / n
    np.testing.assert_allclose(freq, want, atol=0.015)


def _bridged(family):
    cfg = jax_config.get_config(family, "tiny")
    jp = jax_tf.init_params(jax.random.key(0), cfg, jnp.float32)
    np_p = jax.tree.map(np.asarray, jp)
    return cfg, jp, params_from_jax(np_p, get_config(family, "tiny"), "cpu", torch.float32)


@pytest.fixture(scope="module")
def llama():
    return _bridged("llama")


@pytest.fixture(scope="module")
def gemma():
    return _bridged("gemma2")


def _prompts(vocab, lens, seed=0, repeat=True):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        base = rng.integers(3, vocab, 12).tolist()
        # Repetitive text gives prompt lookup real draft matches.
        body = (base * (n // 12 + 1))[:n] if repeat else rng.integers(
            3, vocab, n
        ).tolist()
        out.append([1] + body)
    return out


def _both(model, prompts, monkeypatch, eos=(2,), spec=True, max_new=40):
    cfg, jp, tp = model
    monkeypatch.setattr(jax_spec.config(), "gamma", 8)
    ref = jax_gen.generate(
        jp, cfg, prompts, max_new_tokens=max_new, eos_ids=list(eos),
        greedy=True, speculative=spec,
    )
    got = gen.generate(
        tp, get_config(cfg_family(cfg), "tiny"), prompts,
        max_new_tokens=max_new, eos_ids=list(eos), greedy=True,
        speculative=spec, device="cpu",
    )
    return ref, got


def cfg_family(cfg):
    return "gemma2" if cfg.post_norms else "llama"


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.n_generated, ref.n_generated)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.decode_tokens == ref.decode_tokens


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_greedy_generate_identical_to_reference(family, spec, request, monkeypatch):
    model = request.getfixturevalue(family)
    prompts = _prompts(512, [40, 97, 13])
    ref, got = _both(model, prompts, monkeypatch, spec=spec)
    _assert_same(ref, got)


def test_greedy_identical_prompts_shared_prefix(llama, monkeypatch):
    prompts = _prompts(512, [50], seed=1) * 3
    ref, got = _both(llama, prompts, monkeypatch, spec=False, max_new=20)
    _assert_same(ref, got)
    assert (got.tokens[0] == got.tokens[1]).all()


def test_greedy_eos_early_exit(llama, monkeypatch):
    prompts = _prompts(512, [30, 61], seed=2)
    ref, _ = _both(llama, prompts, monkeypatch, spec=False, max_new=24)
    eos = int(ref.tokens[0, 5])  # a token row 0 emits early
    ref, got = _both(llama, prompts, monkeypatch, eos=(eos,), max_new=24)
    _assert_same(ref, got)
    assert got.n_generated[0] <= 6


def test_generate_requires_device_or_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_config("llama", "tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.generate({}, cfg, [[1, 2]], max_new_tokens=4, eos_ids=[2])


# -- clamp cases (reference: dynamic_slice / dynamic_update_slice) ----------


def test_rowwise_slice_and_write_clamp_like_reference():
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 100, (3, 12)).astype(np.int32)
    vals = rng.integers(100, 200, (3, 5)).astype(np.int32)
    starts = np.asarray([0, 9, 12], np.int32)  # the last two run past N
    want_s = jax_specdec._rowwise_slice(jnp.asarray(buf), jnp.asarray(starts), 5)
    got_s = specdec._rowwise_slice(
        torch.from_numpy(buf).long(), torch.from_numpy(starts).long(), 5
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    want_w = jax_specdec._rowwise_write(
        jnp.asarray(buf), jnp.asarray(vals), jnp.asarray(starts)
    )
    got_w = specdec._rowwise_write(
        torch.from_numpy(buf).long(), torch.from_numpy(vals).long(),
        torch.from_numpy(starts).long(),
    )
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_draft_clips_at_context_end_like_reference():
    """A match whose draft would run past the context (``N - gamma``
    clip) and rows without a match, against the reference's _draft."""
    ctx = np.asarray(
        [
            [5, 6, 7, 8, 9, 5, 6, 1, 2, 3, 4, 5, 6],  # late match: clipped
            [1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2, 3, 4],  # early match
            [9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9],  # no [prev, cur] match
        ],
        np.int32,
    )
    prev = np.asarray([5, 1, 3], np.int32)
    cur = np.asarray([6, 2, 4], np.int32)
    limits = np.asarray([13, 13, 13], np.int32)
    want = jax_specdec._draft(
        jnp.asarray(ctx), jnp.asarray(prev), jnp.asarray(cur),
        jnp.asarray(limits), 4,
    )
    got = specdec._draft(
        torch.from_numpy(ctx).long(), torch.from_numpy(prev).long(),
        torch.from_numpy(cur).long(), torch.from_numpy(limits).long(), 4,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accept_spans_greedy_matches_reference():
    rng = np.random.default_rng(1)
    V, gamma = 16, 4
    logits = rng.standard_normal((3, gamma + 1, V)).astype(np.float32)
    am = logits.argmax(-1)
    draft = np.stack([am[0, :4], [am[1, 0], am[1, 1], 0, 0], [0, 0, 0, 0]])
    draft = draft.astype(np.int32)
    onehot = np.where(np.arange(V) == am[..., None], 0.0, -np.inf)
    probs = np.exp(onehot).astype(np.float32)
    k = jax.random.key(0)
    want = jax_specdec.accept_spans(
        jnp.asarray(probs), jnp.asarray(draft), jnp.full((3,), gamma),
        k, k, greedy=True,
    )
    got = specdec.accept_spans(
        torch.from_numpy(probs), torch.from_numpy(draft).long(),
        torch.full((3,), gamma), None, greedy=True,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_step_clamps_output_slot():
    out = torch.zeros((2, 4), dtype=torch.int64)
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 1.0]])
    finished = torch.tensor([False, True])
    nxt, fin = gen._sample_step(
        logits, None, finished, out, 9, torch.tensor([1]), greedy=True,
        top_k=0, temperature=0.0, top_p=1.0,
    )
    # Step 9 is past the 4-wide buffer: the write lands in the last slot.
    assert out[:, 3].tolist() == [1, 0]
    assert nxt.tolist() == [1, 0] and fin.tolist() == [True, True]


# -- generate(paged=True): the round-synchronous paged path -------------------


def _both_paged(model, prompts, eos=(2,), max_new=24, spec=None, **kw):
    cfg, jp, tp = model
    ref = jax_gen.generate(
        jp, cfg, prompts, max_new_tokens=max_new, eos_ids=list(eos),
        greedy=True, paged=True, speculative=spec, **kw,
    )
    got = gen.generate(
        tp, get_config(cfg_family(cfg), "tiny"), prompts,
        max_new_tokens=max_new, eos_ids=list(eos), greedy=True, paged=True,
        speculative=spec, device="cpu", **kw,
    )
    return ref, got


@pytest.mark.parametrize(
    "case",
    [
        # Unequal prompts: one table row of pages each.
        dict(lens=[40, 97, 13], copies=1, page_size=128, kv_dtype=""),
        # Identical prompts, page | S: one physical copy of the prompt pages.
        dict(lens=[50], copies=3, page_size=128, kv_dtype=""),
        # Identical prompts, page ∤ S: the cache tiles, pages per row.
        dict(lens=[50], copies=3, page_size=48, kv_dtype=""),
        # The int8 KV cache: int8 pages with f32 scale pages.
        dict(lens=[40, 97, 13], copies=1, page_size=16, kv_dtype="int8"),
        dict(lens=[50], copies=2, page_size=64, kv_dtype="int8"),
    ],
    ids=["unshared", "shared_pages", "tiled", "int8kv", "int8kv_shared"],
)
def test_paged_generate_identical_to_reference(llama, case):
    prompts = _prompts(512, case["lens"], seed=3) * case["copies"]
    ref, got = _both_paged(
        llama, prompts, page_size=case["page_size"], kv_dtype=case["kv_dtype"]
    )
    _assert_same(ref, got)
    assert got.n_generated.min() > 0


def test_paged_generate_eos_early_exit(llama):
    prompts = _prompts(512, [30, 61], seed=2)
    ref, _ = _both_paged(llama, prompts)
    eos = int(ref.tokens[0, 5])  # a token row 0 emits early
    ref, got = _both_paged(llama, prompts, eos=(eos,))
    _assert_same(ref, got)
    assert got.n_generated[0] <= 6


def test_paged_generate_matches_dense(llama):
    """The paged decode chunk and the dense decode loop agree in f32."""
    cfg, _, tp = llama
    prompts = _prompts(512, [40, 97, 13], seed=4)
    kw = dict(max_new_tokens=20, eos_ids=[2], greedy=True, device="cpu",
              speculative=False)
    dense = gen.generate(tp, get_config("llama", "tiny"), prompts, **kw)
    paged = gen.generate(
        tp, get_config("llama", "tiny"), prompts, paged=True, page_size=32, **kw
    )
    _assert_same(dense, paged)


def test_paged_generate_ignores_speculation_with_one_warning(
    llama, monkeypatch, capsys
):
    """An explicit speculative=True is ignored on the paged path, with the
    reference's one-time warning; an inherited default-on config warns
    nothing. Tokens stay the reference's either way."""
    monkeypatch.setattr(jax_gen, "_PAGED_SPEC_WARNED", False)
    monkeypatch.setattr(gen, "_PAGED_SPEC_WARNED", False)
    monkeypatch.setattr(jax_spec.config(), "enabled", True)
    from adversarial_spec_tpu_torch.engine import spec as port_spec

    monkeypatch.setattr(port_spec.config(), "enabled", True)
    prompts = _prompts(512, [40, 13], seed=5)
    capsys.readouterr()
    ref, got = _both_paged(llama, prompts, spec=None)
    _assert_same(ref, got)
    assert "warning" not in capsys.readouterr().err
    for _ in range(2):
        ref, got = _both_paged(llama, prompts, spec=True)
        _assert_same(ref, got)
    err = capsys.readouterr().err
    port_lines = [l for l in err.splitlines() if "GpuEngine" in l]
    ref_lines = [l for l in err.splitlines() if "TpuEngine" in l]
    assert len(port_lines) == len(ref_lines) == 1
    assert port_lines[0] == ref_lines[0].replace("TpuEngine", "GpuEngine")
