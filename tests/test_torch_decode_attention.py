"""The port's decode-attention functions against the reference's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them).

On the CPU each wrapper of adversarial_spec_tpu_torch/ops/decode_attention.py
runs its plain PyTorch version; these tests hold that version to the
reference in f32 at atol/rtol 2e-5 (the reference's own kernel tolerance),
and check that a CPU tensor never counts a kernel launch. The CUDA kernel
itself is held against the plain version by tests/test_torch_kernels_gpu.py
(marker ``gpu``) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.ops import pallas_decode
from adversarial_spec_tpu_torch.ops import decode_attention as da

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(seed, B, Hq, Hkv, T, D, S=None):
    rng = np.random.default_rng(seed)
    qshape = (B, Hq, D) if S is None else (B, S, Hq, D)
    q = rng.standard_normal(qshape, dtype=np.float32)
    k = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


B1_CASES = {
    # name: (Hq, Hkv, D, T, bounds, softcap)
    "left_pad_gqa_d64": (8, 2, 64, 256, [[0, 100], [37, 212], [5, 6]], 0.0),
    "softcap": (8, 2, 64, 256, [[0, 256], [0, 128], [10, 200]], 50.0),
    "mha": (4, 4, 64, 256, [[0, 256], [0, 10], [100, 256]], 0.0),
    "gqa_d128": (8, 2, 128, 128, [[3, 128], [64, 65], [0, 77]], 0.0),
}


@pytest.mark.parametrize("case", sorted(B1_CASES))
def test_b1_matches_reference_kernel(case):
    Hq, Hkv, D, T, bounds, cap = B1_CASES[case]
    q, k, v = _rand(1, len(bounds), Hq, Hkv, T, D)
    bnd = np.asarray(bounds, np.int32)
    ref = pallas_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bnd),
        attn_softcap=cap, interpret=True,
    )
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(bnd), attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_b1_single_slot_returns_v_and_empty_window_zeros():
    q, k, v = _rand(2, 3, 8, 2, 128, 64)
    bnd = np.asarray([[40, 41], [7, 7], [0, 128]], np.int32)
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(bnd)).numpy()
    # One valid slot: softmax over one key returns exactly v (per group).
    np.testing.assert_array_equal(got[0], np.repeat(v[0, :, 40], 4, axis=0))
    # Empty window: exact zeros, never NaN.
    assert (got[1] == 0.0).all()
    ref = pallas_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bnd),
        interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


B2_CASES = {
    # name: (Hq, Hkv, D, T, S, softcap, broadcast_starts)
    "per_query_gqa_d64": (8, 2, 64, 256, 9, 0.0, False),
    "softcap": (8, 2, 64, 256, 5, 50.0, False),
    "mha": (4, 4, 64, 128, 3, 0.0, False),
    "broadcast_starts_d128": (8, 2, 128, 256, 9, 0.0, True),
}


@pytest.mark.parametrize("case", sorted(B2_CASES))
def test_b2_matches_reference_kernel(case):
    Hq, Hkv, D, T, S, cap, bcast = B2_CASES[case]
    q, k, v = _rand(3, 3, Hq, Hkv, T, D, S=S)
    ci = np.asarray([T - S - 5, T // 2, 20], np.int32)
    pads = np.asarray([0, 31, 7], np.int32)
    ends = ci[:, None] + np.arange(S, dtype=np.int32) + 1
    starts = pads[:, None] if bcast else np.repeat(pads[:, None], S, axis=1)
    ref = pallas_decode.decode_attention_mq(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(starts), jnp.asarray(ends),
        attn_softcap=cap, interpret=True,
    )
    got = da.decode_attention_mq(
        _t(q), _t(k), _t(v), _t(starts), _t(ends), attn_softcap=cap
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_b2_empty_windows_give_exact_zeros():
    q, k, v = _rand(4, 2, 8, 2, 128, 64, S=4)
    ends = np.asarray([[50, 51, 52, 53], [10, 11, 12, 13]], np.int32)
    starts = np.asarray([[0, 0, 0, 0], [10, 11, 5, 13]], np.int32)
    got = da.decode_attention_mq(
        _t(q), _t(k), _t(v), _t(starts), _t(ends)
    ).numpy()
    assert (got[1, [0, 1, 3]] == 0.0).all()
    assert np.isfinite(got).all()
    ref = pallas_decode.decode_attention_mq(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(starts), jnp.asarray(ends), interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("span", [1, 9])
def test_ragged_cache_length_matches_reference_attention(span):
    """T=300 is no multiple of any tile: the reference kernel refuses it
    (_pick_block_t), the port does not — hold it to the reference's plain
    masked attention instead."""
    T = 300
    q, k, v = _rand(5, 2, 8, 2, T, 64, S=span)
    ci = np.asarray([T - span, 150], np.int32)
    pads = np.asarray([3, 90], np.int32)
    q_pos = ci[:, None] + np.arange(span)
    slot = np.arange(T)[None, None, :]
    mask = (slot >= pads[:, None, None]) & (slot <= q_pos[:, :, None])
    ref = jax_tf.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        attn_softcap=30.0,
    )
    ends = (q_pos + 1).astype(np.int32)
    starts = np.repeat(pads[:, None], span, axis=1)
    if span == 1:
        bnd = np.stack([pads, ends[:, 0]], axis=1).astype(np.int32)
        got = da.decode_attention(
            _t(q[:, 0]), _t(k), _t(v), _t(bnd), attn_softcap=30.0
        )[:, None]
    else:
        got = da.decode_attention_mq(
            _t(q), _t(k), _t(v), _t(starts), _t(ends), attn_softcap=30.0
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_never_count_a_launch():
    da.reset_launches()
    q, k, v = _rand(6, 2, 8, 2, 64, 64, S=3)
    bnd = torch.tensor([[0, 64], [3, 40]], dtype=torch.int32)
    da.decode_attention(_t(q[:, 0]), _t(k), _t(v), bnd)
    se = torch.tensor([[0, 0, 0], [3, 3, 3]], dtype=torch.int32)
    da.decode_attention_mq(_t(q), _t(k), _t(v), se, se + 30)
    ks = torch.ones((2, 2, 64, 1))
    k8 = _t(k).clamp(-1, 1).to(torch.int8)
    da.decode_attention_mq(_t(q), k8, k8, se, se + 30, k_scale=ks, v_scale=ks)
    assert da.launches == {
        "decode_attention": 0,
        "decode_attention_mq": 0,
        "decode_attention_int8kv": 0,
        "decode_attention_mq_int8kv": 0,
    }

