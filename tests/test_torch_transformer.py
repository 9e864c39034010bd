"""The port's transformer against the reference's, on the same weights.

Weights come from the reference's ``init_params`` (numpy-seeded extras for
the qkv biases and norms, so those paths carry signal) and cross into the
port through ``engine/loader.py:params_from_jax``. Tiny configs of all
four families run in f32 through a left-padded prefill chunk, S=1 decode
steps and a 9-position verify span with a per-row cache index; logits
agree to atol/rtol 1e-4 (f32; the two packages sum in different orders)
and the caches match. One bf16 case has its own tolerance (below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.models import config as jax_config
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.ops import rope as jax_rope
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models import transformer as tf
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.ops import rope

F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: both packages round every activation to bf16 but in different
# places (matmul accumulation order, the kernel path's f32 PV product vs
# the reference's bf16 probabilities), so logits of O(1) drift by a few
# bf16 ulps through two layers.
BF16_TOL = dict(rtol=0.05, atol=0.05)
FAMILIES = ["llama", "mistral", "gemma2", "qwen2"]


def _weights(family, dtype):
    cfg = jax_config.get_config(family, "tiny")
    p = jax_tf.init_params(jax.random.key(0), cfg, dtype)
    np_p = jax.tree.map(lambda x: np.asarray(x, np.float32), p)
    rng = np.random.default_rng(7)
    for name, leaf in np_p["layers"].items():
        if name.startswith("b") or name.endswith("norm"):
            np_p["layers"][name] = (
                0.1 * rng.standard_normal(leaf.shape)
            ).astype(np.float32) + (0.0 if cfg.norm_scale_plus_one or
                                    name.startswith("b") else 1.0)
    return cfg, np_p


def _jax_params(np_p, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), np_p)


def _run_both(family, jdtype, tdtype, use_pallas):
    """Prefill, two decode steps and a verify span through both packages;
    returns [(jax logits, port logits)] and both final caches."""
    cfg, np_p = _weights(family, jdtype)
    jp = _jax_params(np_p, jdtype)
    tp = params_from_jax(np_p, get_config(family, "tiny"), "cpu", tdtype)
    B, S, T = 2, 144, 160  # T > the tiny window (128): windows bite
    rng = np.random.default_rng(11)
    pads = np.asarray([0, 9], np.int32)
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jax_tf.init_cache(cfg, B, T, dtype=jdtype)
    tcache = tf.init_cache(
        get_config(family, "tiny"), B, T, device="cpu", dtype=tdtype
    )
    pairs = []

    def step(tokens, positions, cache_index, kv_valid):
        nonlocal jcache
        jl, jcache = jax_tf.forward(
            jp, cfg, jnp.asarray(tokens), jnp.asarray(positions), jcache,
            jnp.asarray(cache_index), jnp.asarray(kv_valid),
            use_pallas_decode=use_pallas, pallas_interpret=use_pallas,
        )
        ci = (
            torch.from_numpy(np.asarray(cache_index, np.int64))
            if np.ndim(cache_index) else int(cache_index)
        )
        tl = tf.forward(
            tp, get_config(family, "tiny"), torch.from_numpy(tokens),
            torch.from_numpy(np.asarray(positions, np.int64)), tcache, ci,
            torch.from_numpy(kv_valid), use_kernels=use_pallas,
        )
        pairs.append((np.asarray(jl, np.float32), tl.float().numpy()))

    slots = np.arange(T)[None, :]
    kv_base = slots >= pads[:, None]
    step(toks, np.maximum(np.arange(S)[None, :] - pads[:, None], 0), 0, kv_base)
    for i in range(2):  # S=1 decode steps at a shared slot
        ci = S + i
        nxt = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        step(nxt, (ci - pads)[:, None], ci, kv_base & (slots <= ci))
    # Verify span of γ+1 = 9 at per-row slots (rows desynchronized).
    ci = np.asarray([S + 2, S + 5], np.int32)
    span = rng.integers(3, cfg.vocab_size, (B, 9)).astype(np.int32)
    step(span, ci[:, None] + np.arange(9) - pads[:, None], ci, kv_base)
    return pairs, jcache, tcache


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_forward_matches_reference_f32(family, kernels):
    pairs, jcache, tcache = _run_both(
        family, jnp.float32, torch.float32, kernels
    )
    for jl, tl in pairs:
        assert jl.shape == tl.shape
        np.testing.assert_allclose(tl, jl, **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[name].numpy(), np.asarray(jcache[name]), **F32_TOL
        )


def test_forward_matches_reference_bf16():
    pairs, _, _ = _run_both("llama", jnp.bfloat16, torch.bfloat16, False)
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, **BF16_TOL)


def test_params_bridge_layout():
    cfg, np_p = _weights("gemma2", jnp.float32)
    tp = params_from_jax(np_p, get_config("gemma2", "tiny"), "cpu", torch.float32)
    assert len(tp["layers"]) == cfg.n_layers
    assert "lm_head_t" in tp and "lm_head" not in tp
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == set(np_p["layers"])
        np.testing.assert_array_equal(
            lp["post_ffn_norm"].numpy(), np_p["layers"]["post_ffn_norm"][i]
        )
    _, qp = _weights("qwen2", jnp.float32)
    tq = params_from_jax(qp, get_config("qwen2", "tiny"), "cpu", torch.float32)
    np.testing.assert_array_equal(tq["layers"][1]["bk"].numpy(), qp["layers"]["bk"][1])
    assert "lm_head" in tq


def test_rope_llama3_scaling_matches_reference():
    pos = np.arange(0, 20000, 37, dtype=np.int32)[None, :]
    scaling = (32.0, 1.0, 4.0, 8192.0)
    jc, js = jax_rope.rope_angles(jnp.asarray(pos), 128, 500000.0, scaling)
    tc, ts = rope.rope_angles(torch.from_numpy(pos), 128, 500000.0, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    x = np.random.default_rng(0).standard_normal((1, pos.shape[1], 2, 128))
    x = x.astype(np.float32)
    jr = jax_rope.apply_rope(jnp.asarray(x), jc, js)
    tr = rope.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)


def test_write_kv_clamps_like_dynamic_update_slice():
    """A span that would run past the buffer lands shifted back to fit,
    as jax.lax.dynamic_update_slice clamps (rows at budget rely on it);
    an int8 cache's scale buffer ([..., 1]) written in the same call lands
    at the same slots."""
    rng = np.random.default_rng(3)
    for D in (4, 1):
        buf = rng.standard_normal((2, 1, 12, D)).astype(np.float32)
        val = rng.standard_normal((2, 5, 1, D)).astype(np.float32)
        for ci in (10, np.asarray([10, 3]), np.asarray([0, 11])):
            jv = jnp.swapaxes(jnp.asarray(val), 1, 2)
            if np.ndim(ci):
                want = jax.vmap(
                    lambda b, v_, i: jax.lax.dynamic_update_slice(b, v_, (0, i, 0))
                )(jnp.asarray(buf), jv, jnp.asarray(ci))
                idx = torch.from_numpy(ci.astype(np.int64))
            else:
                want = jax.lax.dynamic_update_slice(
                    jnp.asarray(buf), jv, (0, 0, ci, 0)
                )
                idx = ci
            got, twin = torch.from_numpy(buf.copy()), torch.from_numpy(buf.copy())
            tf._write_kv(((got, torch.from_numpy(val)), (twin, torch.from_numpy(val))), idx)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(twin.numpy(), np.asarray(want))
