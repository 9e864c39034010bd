"""The port's weight quantization and its B5/B6 plain versions against the
reference's, on the same inputs.

- Quantization (``quantize_int8``, ``quantize_int4``, ``pack_int4``,
  ``quantize_params``) is BIT-identical to the reference's on f32 and bf16
  weights: the same f32 divisions, and both rounds go half to even.
- ``unpack_int4`` equals the reference's on all 256 byte values (the
  int8 shifts sign-extend and wrap alike); ``dequantize(rows=)`` slices
  an odd width's zero pad row.
- ``matmul_int8_plain`` matches ``pallas_quant.matmul_int8`` in interpret
  mode within 1e-5 x max|ref| (f32; summation order only) and
  ``matmul_int4_plain`` matches ``matmul_int4`` within 2e-4 x max|ref| (the
  reference kernel sums the even and odd rows apart, a reassociated sum:
  the tolerance ``tests/test_pallas.py`` allows), for even and odd K, 2-D
  and 3-D x, and f32 output from bf16 x.
- The numpy float64 oracle fuzz of ``tests/test_quant.py`` repeated
  against the port's wrappers (their plain versions on the CPU).

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.models import config as jax_config
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.ops import pallas_quant as jax_pq
from adversarial_spec_tpu.ops import quant as jax_quant
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models import transformer as tf
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.ops import quant
from adversarial_spec_tpu_torch.ops import quant_matmul as qm

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _pair(w: np.ndarray, name: str):
    """The same weights in both packages (bf16: both round f32 → bf16
    to nearest even)."""
    jd, td = DTYPES[name]
    return jnp.asarray(w, jd), torch.from_numpy(w).to(td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 48), (33, 7), (3, 17, 5)], ids=["even", "odd", "stacked"])
def test_quantize_bit_identical_to_reference(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    w[..., 0, 0] = 0.0
    if shape[-1] > 2:
        w[..., :, 2] = 0.0  # an all-zero column: the 1e-8 scale floor
    jw, tw = _pair(w, dtype)
    r8, t8 = jax_quant.quantize_int8(jw), quant.quantize_int8(tw)
    assert t8["q"].dtype == torch.int8 and t8["scale"].dtype == torch.float32
    np.testing.assert_array_equal(t8["q"].numpy(), _np(r8["q"]))
    np.testing.assert_array_equal(t8["scale"].numpy(), _np(r8["scale"]))
    r4, t4 = jax_quant.quantize_int4(jw), quant.quantize_int4(tw)
    assert t4["q4"].shape == r4["q4"].shape == (*shape[:-2], -(-shape[-2] // 2), shape[-1])
    np.testing.assert_array_equal(t4["q4"].numpy(), _np(r4["q4"]))
    np.testing.assert_array_equal(t4["scale"].numpy(), _np(r4["scale"]))
    assert tw.dtype == DTYPES[dtype][1]  # the input is left as it was
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw, np.float32))


def test_pack_and_unpack_int4_match_reference_on_all_bytes():
    # Every int8 value through pack (hi << 4 wraps within int8 as
    # jnp.left_shift(...).astype(int8) does), and every byte through unpack.
    vals = np.arange(-128, 128, dtype=np.int8)
    q = np.stack([vals, vals[::-1], np.roll(vals, 7)], axis=1)  # [256, 3]
    np.testing.assert_array_equal(
        quant.pack_int4(torch.from_numpy(q)).numpy(), _np(jax_quant.pack_int4(jnp.asarray(q)))
    )
    packed = vals.reshape(128, 2)
    for rows in (256, 255):
        np.testing.assert_array_equal(
            quant.unpack_int4(torch.from_numpy(packed), rows).numpy(),
            _np(jax_quant.unpack_int4(jnp.asarray(packed), rows)),
        )
    # In range [-8, 7] the round trip is exact, odd row counts included.
    small = np.random.default_rng(0).integers(-8, 8, (3, 9, 4)).astype(np.int8)
    back = quant.unpack_int4(quant.pack_int4(torch.from_numpy(small)), 9)
    np.testing.assert_array_equal(back.numpy(), small)


def test_dequantize_rows_odd_width_edge():
    w = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    j4, t4 = jax_quant.quantize_int4(jnp.asarray(w)), quant.quantize_int4(torch.from_numpy(w))
    exact = quant.dequantize(t4, rows=7)
    assert exact.shape == (7, 5)
    np.testing.assert_array_equal(exact.numpy(), _np(jax_quant.dequantize(j4, rows=7)))
    padded = quant.dequantize(t4)  # no width given: the zero pad row stays
    assert padded.shape == (8, 5) and (padded[7] == 0).all()
    np.testing.assert_array_equal(padded.numpy(), _np(jax_quant.dequantize(j4)))
    t8 = quant.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(
        quant.dequantize(t8, torch.float32).numpy(),
        _np(jax_quant.dequantize(jax_quant.quantize_int8(jnp.asarray(w)))),
    )
    assert torch.equal(quant.dequantize(torch.ones(2)), torch.ones(2))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize(
    "family,dtype", [("llama", "f32"), ("gemma2", "f32"), ("llama", "bf16")]
)
def test_quantize_params_bit_identical_to_reference(family, dtype, fmt):
    """The reference quantizes its layer-stacked pytree; the port its
    per-layer lists, in place. Every leaf agrees bit for bit, including
    the tied head's transposed copy (gemma2: lm_head_t)."""
    jd, td = DTYPES[dtype]
    cfg = jax_config.get_config(family, "tiny")
    jp = jax_tf.init_params(jax.random.key(3), cfg, jd)
    np_p = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)  # bf16 → f32 exactly
    ref = jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a),
        jax_quant.quantize_params(jp, fmt=fmt),
    )
    tp = params_from_jax(np_p, get_config(family, "tiny"), "cpu", td)
    assert quant.quantize_params(tp, fmt=fmt) is tp  # in place
    key = "q" if fmt == "int8" else "q4"
    head = "lm_head_t" if cfg.tied_embeddings else "lm_head"
    assert set(tp[head]) == {key, "scale"}
    np.testing.assert_array_equal(tp[head][key].numpy(), ref[head][key])
    np.testing.assert_array_equal(tp["embed"].float().numpy(), ref["embed"])  # not quantized
    for i, lp in enumerate(tp["layers"]):
        for name, leaf in lp.items():
            if name in quant.QUANTIZABLE:
                for part in (key, "scale"):
                    np.testing.assert_array_equal(
                        leaf[part].numpy(), ref["layers"][name][part][i]
                    )
            else:
                assert isinstance(leaf, torch.Tensor)
    quant.quantize_params(tp, fmt=fmt)  # already quantized: left as is
    np.testing.assert_array_equal(tp[head][key].numpy(), ref[head][key])
    with pytest.raises(ValueError, match="int8, int4"):
        quant.quantize_params(tp, fmt="fp8")


def test_bridge_keeps_quantized_leaf_types():
    cfg = jax_config.get_config("llama", "tiny")
    jp = jax_quant.quantize_params(
        jax_tf.init_params(jax.random.key(0), cfg, jnp.bfloat16), fmt="int4"
    )
    tp = params_from_jax(jax.tree.map(np.asarray, jp), get_config("llama", "tiny"), "cpu")
    wq = tp["layers"][1]["wq"]
    assert wq["q4"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    assert wq["q4"].shape == (cfg.dim // 2, cfg.n_heads * cfg.head_dim)
    assert wq["scale"].shape == (1, cfg.n_heads * cfg.head_dim)
    np.testing.assert_array_equal(wq["q4"].numpy(), np.asarray(jp["layers"]["wq"]["q4"][1]))
    assert tp["lm_head"]["q4"].dtype == torch.int8
    assert tp["layers"][0]["attn_norm"].dtype == torch.bfloat16


def test_params_helpers_walk_quantized_leaves():
    params = tf.init_params(get_config("llama", "tiny"), device="cpu", dtype=torch.float32)
    n = tf.count_params(params)
    assert all(isinstance(v, torch.Tensor) for lp in params["layers"] for v in lp.values())
    quant.quantize_params(params, fmt="int8")
    cfg = get_config("llama", "tiny")
    # Each quantized [K, N] weight adds its N scales to the stored count:
    # wq, wk, wv, wo, w_gate, w_up, w_down per layer, and the head.
    extra = cfg.n_layers * (
        cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
        + 2 * cfg.dim + 2 * cfg.ffn_dim
    ) + cfg.vocab_size
    scales = sum(
        leaf["scale"].numel()
        for leaf in [params["lm_head"]] + [v for lp in params["layers"] for v in lp.values()]
        if isinstance(leaf, dict)
    )
    assert scales == extra
    assert tf.count_params(params) == n + scales
    doubled = tf.map_params(lambda t: t.clone(), params)
    assert doubled["layers"][0]["wq"]["q"] is not params["layers"][0]["wq"]["q"]
    assert torch.equal(doubled["layers"][0]["wq"]["q"], params["layers"][0]["wq"]["q"])
    assert [t.dtype for t in tf.leaves(doubled)] == [t.dtype for t in tf.leaves(params)]


def _ref_kernel(fmt, x, w, out_dtype=None):
    leaf = (jax_quant.quantize_int8 if fmt == "int8" else jax_quant.quantize_int4)(jnp.asarray(w))
    key = "q" if fmt == "int8" else "q4"
    fn = jax_pq.matmul_int8 if fmt == "int8" else jax_pq.matmul_int4
    ref = fn(jnp.asarray(x), leaf[key], leaf["scale"],
             preferred_element_type=out_dtype, interpret=True)
    return np.asarray(ref, np.float32), {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}


@pytest.mark.parametrize("fmt,rel", [("int8", 1e-5), ("int4", 2e-4)])
@pytest.mark.parametrize(
    "K,xshape", [(64, (6, 64)), (33, (2, 3, 33))], ids=["even-2d", "odd-3d"]
)
def test_plain_versions_match_pallas_interpret(fmt, rel, K, xshape):
    rng = np.random.default_rng(K)
    w = rng.standard_normal((K, 40)).astype(np.float32)
    x = rng.standard_normal(xshape).astype(np.float32)
    ref, leaf = _ref_kernel(fmt, x, w)
    got = quant.matmul(torch.from_numpy(x), leaf)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= rel * np.max(np.abs(ref))
    # bf16 x with f32 output (the head): the same f32 accumulation of
    # exact products, no bf16 rounding on the way.
    xb = x.astype(jnp.bfloat16)
    ref, _ = _ref_kernel(fmt, xb, w, jnp.float32)
    got = quant.matmul(torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16), leaf,
                       torch.float32)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= rel * np.max(np.abs(ref))


def _np_unpack_int4(packed: np.ndarray, rows: int) -> np.ndarray:
    """An independent numpy unpack (int arithmetic, not shifts)."""
    u = packed.astype(np.int16) & 0xFF
    lo, hi = u & 0x0F, u >> 4
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    out = np.empty((packed.shape[0] * 2, packed.shape[1]), np.int16)
    out[0::2], out[1::2] = lo, hi
    return out[:rows]


def test_fuzz_wrappers_vs_numpy_oracle():
    """K 1-97, N 1-40, M 1-20, weight magnitudes 1e-12..1e12, 2-D and 3-D
    x: the wrappers (plain versions on the CPU) against a float64 numpy
    oracle within 2e-4 x max|ref|, as the reference's own fuzz."""
    rng = np.random.default_rng(11)
    for case in range(12):
        K = int(rng.integers(1, 98))
        N = int(rng.integers(1, 41))
        M = int(rng.integers(1, 21))
        xshape = (M, K) if case % 2 else (2, M, K)
        mag = 10.0 ** float(rng.integers(-12, 13))
        w = (rng.standard_normal((K, N)) * mag).astype(np.float32)
        x = rng.standard_normal(xshape).astype(np.float32)
        w8 = quant.quantize_int8(torch.from_numpy(w))
        ref8 = x.astype(np.float64) @ (w8["q"].numpy().astype(np.float64)
                                       * w8["scale"].numpy().astype(np.float64))
        got8 = qm.matmul_int8(torch.from_numpy(x), w8["q"], w8["scale"]).numpy()
        assert np.max(np.abs(got8 - ref8)) <= 2e-4 * (np.max(np.abs(ref8)) + 1e-30), (case, K)
        w4 = quant.quantize_int4(torch.from_numpy(w))
        deq = _np_unpack_int4(w4["q4"].numpy(), K).astype(np.float64) * w4["scale"].numpy()
        np.testing.assert_array_equal(quant.dequantize(w4, rows=K).numpy(), deq.astype(np.float32))
        ref4 = x.astype(np.float64) @ deq
        got4 = qm.matmul_int4(torch.from_numpy(x), w4["q4"], w4["scale"]).numpy()
        assert np.max(np.abs(got4 - ref4)) <= 2e-4 * (np.max(np.abs(ref4)) + 1e-30), (case, K)


def test_matmul_dispatch_and_cpu_launch_counts():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    qm.reset_launches()
    assert torch.equal(quant.matmul(x, w), x @ w)
    assert quant.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16), torch.float32).dtype == torch.float32
    for leaf, plain in (
        (quant.quantize_int8(w), lambda t, l: qm.matmul_int8_plain(t, l["q"], l["scale"])),
        (quant.quantize_int4(w), lambda t, l: qm.matmul_int4_plain(t, l["q4"], l["scale"])),
    ):
        assert torch.equal(quant.matmul(x, leaf), plain(x, leaf))
        bf = quant.matmul(x.to(torch.bfloat16), leaf)
        assert bf.dtype == torch.bfloat16 and bf.shape == (3, 8)
    # CPU tensors run the plain versions, which never count as launches.
    assert qm.launches == {"matmul_int8": 0, "matmul_int4": 0}
    with pytest.raises(TypeError, match="float32 or None"):
        quant.matmul(x, w, torch.bfloat16)
