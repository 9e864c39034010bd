"""The port's int8 KV cache (``kv_dtype="int8"``) against the reference's.

- ``_quantize_kv`` is bit-identical to the reference's (int8 bytes and f32
  scales), f32 and bf16 inputs, all-zero rows and ties at .5 included.
- The int8 modes of the decode-attention kernels' plain versions (B1-B4)
  against the reference's Pallas kernels in interpret mode, f32, within
  2e-5 (summation order only: both dequantize ``float(k8) * ks`` in f32
  and accumulate in f32): left pads, an empty window, softcap, S=9 with
  ``[B, 1]`` and ``[B, S]`` bounds; scattered pages, -1 padding, a trash
  page inside a window, a NaN-poisoned trash page and trash scale page,
  and B4 at S=1 equal to B3.
- Caches and pools: int8 structure equal to the reference's, ``write_tokens``
  refusing a quantized pool without scales, ``read_tokens`` round-tripping
  the scales, and the prefilled int8 dense cache equal to the reference's
  byte for byte.
- Greedy transcripts: ``generate(kv_dtype="int8")`` and the batcher
  (two rounds, the second on the prefix cache) give the reference's
  tokens, speculation on and off (the engine-level ``chat()`` text is in
  tests/test_torch_engine.py).

f32 throughout: there the port's plain versions and the reference agree to
~1e-6, far from any argmax near-tie of these models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.engine import interleave as jax_interleave
from adversarial_spec_tpu.engine import kvcache as jax_kvcache
from adversarial_spec_tpu.engine import kvtier as jax_kvtier
from adversarial_spec_tpu.engine import prefix_cache as jax_prefix
from adversarial_spec_tpu.engine import scheduler as jax_sched
from adversarial_spec_tpu.engine import spec as jax_spec
from adversarial_spec_tpu.models import config as jax_config
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.ops import pallas_decode, pallas_paged
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import kvcache
from adversarial_spec_tpu_torch.engine import scheduler as sched
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models import transformer as tf
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quantized(rng, shape):
    """Random f32 values quantized by the reference: (int8, f32 scales)."""
    kq, ks = jax_tf._quantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    return np.array(kq), np.array(ks)


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_reference(dtype):
    """Against the reference's quantization as its caches get it, compiled:
    XLA turns ``/ 127.0`` into a product with f32(1/127) there (the eager
    op divides, and differs in the last bit of some scales)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 64)) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero row: scale 1e-8 / 127, values 0
    # amax 127 gives scale 1.0 exactly: these are ties at .5 (half to even).
    x[1, 0, 0, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    x[1, 0, 0, 8:] = 0.25
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, js = jax.jit(jax_tf._quantize_kv)(jnp.asarray(x).astype(jdt))
    tq, ts = tf._quantize_kv(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 5, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert tq[1, 0, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert (tq[0, 1, 2] == 0).all() and float(ts[0, 1, 2]) == np.float32(1e-8) * (np.float32(1) / np.float32(127))


# -- kernels' plain versions against the Pallas kernels (interpret mode) ------


B1_CASES = {
    # name: (bounds, softcap); B=3, Hq=8, Hkv=2, D=64, T=256
    "left_pads": ([[0, 200], [37, 212], [5, 6]], 0.0),
    "empty_window": ([[0, 256], [9, 9], [100, 256]], 0.0),
    "softcap": ([[0, 256], [0, 128], [10, 200]], 50.0),
}


@pytest.mark.parametrize("case", sorted(B1_CASES))
def test_b1_int8_matches_reference_kernel(case):
    bounds, cap = B1_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((3, 8, 64)).astype(np.float32)
    k8, ks = _quantized(rng, (3, 2, 256, 64))
    v8, vs = _quantized(rng, (3, 2, 256, 64))
    bnd = np.asarray(bounds, np.int32)
    ref = pallas_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bnd),
        attn_softcap=cap, interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    )
    got = da.decode_attention(
        _t(q), _t(k8), _t(v8), _t(bnd), attn_softcap=cap, k_scale=_t(ks), v_scale=_t(vs)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if case == "empty_window":
        assert (got[1] == 0).all()


@pytest.mark.parametrize("bcast", [False, True], ids=["per_query", "broadcast_starts"])
def test_b2_int8_matches_reference_kernel(bcast):
    S, T = 9, 256
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, S, 8, 64)).astype(np.float32)
    k8, ks = _quantized(rng, (3, 2, T, 64))
    v8, vs = _quantized(rng, (3, 2, T, 64))
    ci = np.asarray([T - S - 5, T // 2, 20], np.int32)
    pads = np.asarray([0, 31, 7], np.int32)
    ends = ci[:, None] + np.arange(S, dtype=np.int32) + 1
    starts = pads[:, None] if bcast else np.repeat(pads[:, None], S, axis=1)
    if not bcast:
        starts[2, 3:6] = ends[2, 3:6]  # empty windows on three positions
    ref = pallas_decode.decode_attention_mq(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(starts),
        jnp.asarray(ends), attn_softcap=30.0, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    )
    got = da.decode_attention_mq(
        _t(q), _t(k8), _t(v8), _t(starts), _t(ends), attn_softcap=30.0,
        k_scale=_t(ks), v_scale=_t(vs),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if not bcast:
        assert (got[2, 3:6] == 0).all()


def _paged_int8(rng, n_pages, page=8, Hkv=2, D=64, poison=True):
    """An int8 pool [n_pages, Hkv, page, D] with its scale pages; the trash
    page 0 and its scale page hold NaN (int8 cannot: its values are
    extreme instead)."""
    k8, ks = _quantized(rng, (n_pages, Hkv, page, D))
    v8, vs = _quantized(rng, (n_pages, Hkv, page, D))
    if poison:
        k8[0] = v8[0] = -128
        ks[0] = vs[0] = np.nan
    return k8, ks, v8, vs


PAGED_TABLE = np.asarray([[3, 0, 5, -1], [7, 2, 9, 11], [4, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["plain", "softcap"])
def test_b3_int8_matches_reference_kernel(cap):
    """Scattered pages, -1 padding, the (poisoned) trash page inside row
    0's window, an empty row."""
    rng = np.random.default_rng(7)
    k8, ks, v8, vs = _paged_int8(rng, 12)
    q = rng.standard_normal((3, 8, 64)).astype(np.float32)
    bnd = np.asarray([[1, 24], [0, 32], [5, 5]], np.int32)
    ref = np.asarray(pallas_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(PAGED_TABLE),
        jnp.asarray(bnd), attn_softcap=cap, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    ))
    got = pa.paged_decode_attention(
        _t(q), _t(k8), _t(v8), _t(PAGED_TABLE), _t(bnd), attn_softcap=cap,
        k_scale=_t(ks), v_scale=_t(vs),
    )
    assert np.isfinite(ref).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("bcast", [False, True], ids=["per_position", "broadcast_starts"])
def test_b4_int8_matches_reference_kernel(bcast):
    S = 9
    rng = np.random.default_rng(8)
    k8, ks, v8, vs = _paged_int8(rng, 12)
    q = rng.standard_normal((3, S, 8, 64)).astype(np.float32)
    ends = np.stack([np.arange(S) + e for e in (15, 20, 1)]).astype(np.int32)
    starts = np.asarray([[1], [4], [1]], np.int32)
    if not bcast:
        starts = np.repeat(starts, S, axis=1)
        starts[2] = ends[2]  # row 2: empty windows
    ref = np.asarray(pallas_paged.paged_decode_attention_mq(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(PAGED_TABLE),
        jnp.asarray(starts), jnp.asarray(ends), interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    ))
    got = pa.paged_decode_attention_mq(
        _t(q), _t(k8), _t(v8), _t(PAGED_TABLE), _t(starts), _t(ends),
        k_scale=_t(ks), v_scale=_t(vs),
    )
    assert np.isfinite(ref).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if not bcast:
        assert (got[2] == 0).all()


def test_b4_int8_at_one_position_equals_b3_int8():
    rng = np.random.default_rng(9)
    k8, ks, v8, vs = (_t(a) for a in _paged_int8(rng, 12))
    q = _t(rng.standard_normal((3, 1, 8, 64)).astype(np.float32))
    bnd = torch.tensor([[1, 24], [0, 32], [3, 9]], dtype=torch.int32)
    kw = dict(k_scale=ks, v_scale=vs)
    mq = pa.paged_decode_attention_mq(q, k8, v8, _t(PAGED_TABLE), bnd[:, :1], bnd[:, 1:], **kw)
    sq = pa.paged_decode_attention(q[:, 0], k8, v8, _t(PAGED_TABLE), bnd, **kw)
    torch.testing.assert_close(mq[:, 0], sq, rtol=0, atol=0)


def test_wrappers_refuse_half_a_scale_pair():
    q = torch.zeros((1, 4, 64))
    k8 = torch.zeros((1, 2, 16, 64), dtype=torch.int8)
    ks = torch.zeros((1, 2, 16, 1))
    bnd = torch.tensor([[0, 16]], dtype=torch.int32)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        da.decode_attention(q, k8, k8, bnd, k_scale=ks)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pa.paged_decode_attention(q, k8, k8, bnd, bnd, v_scale=ks)


# -- caches and pools ---------------------------------------------------------


def _layout():
    return dict(n_pages=9, page_size=8, n_layers=2, n_kv_heads=2, head_dim=64)


def test_int8_cache_and_pool_structure_match_reference():
    cfg = jax_config.get_config("llama", "tiny")
    ref = jax_tf.init_cache(cfg, 3, 40, kv_dtype="int8")
    got = tf.init_cache(get_config("llama", "tiny"), 3, 40, device="cpu", kv_dtype="int8")
    ref_pool = jax_kvcache.init_page_pool(jax_kvcache.PagedCacheLayout(**_layout()), kv_dtype="int8")
    pool = kvcache.init_page_pool(kvcache.PagedCacheLayout(**_layout()), device="cpu", kv_dtype="int8")
    for r, g in ((ref, got), (ref_pool, pool)):
        assert sorted(g) == sorted(r) == ["k", "ks", "v", "vs"]
        for name in g:
            assert tuple(g[name].shape) == r[name].shape
            assert str(g[name].dtype).split(".")[1] == str(r[name].dtype)
            assert not bool(g[name].any())
        assert g["ks"].shape[-1] == 1 and g["ks"].shape[:-1] == g["k"].shape[:-1]
    with pytest.raises(ValueError, match="kv_dtype"):
        tf.init_cache(get_config("llama", "tiny"), 1, 8, device="cpu", kv_dtype="fp8")


def test_int8_pool_write_refuses_missing_scales_and_read_round_trips():
    rng = np.random.default_rng(4)
    pool = kvcache.init_page_pool(kvcache.PagedCacheLayout(**_layout()), device="cpu", kv_dtype="int8")
    ref = jax_kvcache.init_page_pool(jax_kvcache.PagedCacheLayout(**_layout()), kv_dtype="int8")
    shape = (2, 2, 2, 5, 64)  # [L, B, Hkv, S, D]
    k8, ks = _quantized(rng, shape)
    v8, vs = _quantized(rng, shape)
    pids = np.asarray([[1, 1, 2, 2, 2], [5, 5, 5, 7, 7]])
    offs = np.asarray([[6, 7, 0, 1, 2], [3, 4, 5, 0, 1]])
    with pytest.raises(ValueError, match="scale slices"):
        kvcache.write_tokens(pool, _t(k8), _t(v8), pids, offs)
    kvcache.write_tokens(pool, _t(k8), _t(v8), pids, offs, ks_new=_t(ks), vs_new=_t(vs))
    ref = jax_kvcache.write_tokens(
        ref, *(jnp.asarray(a) for a in (k8, v8)), pids, offs,
        ks_new=jnp.asarray(ks), vs_new=jnp.asarray(vs),
    )
    back = kvcache.read_tokens(pool, pids, offs)
    for name, want in (("k", k8), ("v", v8), ("ks", ks), ("vs", vs)):
        np.testing.assert_array_equal(back[name].numpy(), want)
        np.testing.assert_array_equal(pool[name].numpy(), np.asarray(ref[name]))


def test_prefilled_int8_cache_equals_reference_bytes(monkeypatch):
    """A left-padded prefill chunk, then an S=1 step and a 9-position
    verify through the kernels' plain versions: the int8 K/V and the
    scales equal the reference's byte for byte, the logits to 1e-4.

    Both packages' QKV projection returns the same f32 q/k/v here (the
    same for every layer): XLA's and torch's matmuls round differently
    in the last bit, which would move the scales by an ulp. What is held
    byte for byte is everything downstream of the projection: the
    quantization, the slots written, the clamp of the start."""
    cfg = jax_config.get_config("llama", "tiny")
    jp = jax_tf.init_params(jax.random.key(0), cfg, jnp.float32)
    pcfg = get_config("llama", "tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu", torch.float32)
    B, S, T = 2, 40, 64
    rng = np.random.default_rng(5)
    qkv = {}  # span length -> (q, k, v) [B, S, H, D] f32

    def fixed(lib, B_, S_):
        if S_ not in qkv:
            qkv[S_] = tuple(
                (rng.standard_normal((B_, S_, h, cfg.head_dim)) * 2).astype(np.float32)
                for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
            )
        return tuple(lib(a) for a in qkv[S_])

    monkeypatch.setattr(
        jax_tf, "_project_qkv", lambda lp, c, h, B_, S_, *a, **k: fixed(jnp.asarray, B_, S_)
    )
    monkeypatch.setattr(
        tf, "_project_qkv", lambda lp, c, h, B_, S_, *a, **k: fixed(_t, B_, S_)
    )
    pads = np.asarray([0, 7], np.int32)
    slots = np.arange(T)[None, :]
    kv_base = slots >= pads[:, None]
    jcache = jax_tf.init_cache(cfg, B, T, kv_dtype="int8")
    tcache = tf.init_cache(pcfg, B, T, device="cpu", kv_dtype="int8")

    def step(tokens, positions, cache_index, kv_valid, kernels):
        nonlocal jcache
        jl, jcache = jax_tf.forward(
            jp, cfg, jnp.asarray(tokens), jnp.asarray(positions), jcache,
            jnp.asarray(cache_index), jnp.asarray(kv_valid),
            use_pallas_decode=kernels, pallas_interpret=True,
        )
        ci = _t(np.asarray(cache_index, np.int64)) if np.ndim(cache_index) else int(cache_index)
        tl = tf.forward(
            tp, pcfg, _t(tokens), _t(np.asarray(positions, np.int64)), tcache, ci,
            _t(kv_valid), use_kernels=kernels,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for name in ("k", "v", "ks", "vs"):
            np.testing.assert_array_equal(
                tcache[name].numpy().view(np.uint8), np.asarray(jcache[name]).view(np.uint8)
            )

    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    step(toks, np.maximum(np.arange(S)[None, :] - pads[:, None], 0), 0, kv_base, False)
    assert tcache["k"].dtype == torch.int8 and bool(tcache["ks"][:, :, :, :S].all())
    nxt = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
    step(nxt, (S - pads)[:, None], S, kv_base & (slots <= S), True)
    ci = np.asarray([S + 1, S + 3], np.int32)
    span = rng.integers(3, cfg.vocab_size, (B, 9)).astype(np.int32)
    step(span, ci[:, None] + np.arange(9) - pads[:, None], ci, kv_base, True)
    assert not bool(tcache["ks"][:, :, :, S + 12 :].any())  # never written: 0


# -- greedy transcripts -------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    cfg = jax_config.get_config("llama", "tiny")
    jp = jax_tf.init_params(jax.random.key(0), cfg, jnp.float32)
    pcfg = get_config("llama", "tiny")
    return cfg, jp, pcfg, params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu", torch.float32)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        base = rng.integers(3, vocab, 12).tolist()
        out.append([1] + (base * (n // 12 + 1))[:n])  # repetitive: real drafts
    return out


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
def test_greedy_generate_int8_cache_identical_to_reference(llama, spec, monkeypatch):
    cfg, jp, pcfg, tp = llama
    monkeypatch.setattr(jax_spec.config(), "gamma", 8)
    prompts = _prompts(cfg.vocab_size, [40, 97, 13])
    kw = dict(max_new_tokens=32, eos_ids=[2], greedy=True, speculative=spec, kv_dtype="int8")
    ref = jax_gen.generate(jp, cfg, prompts, **kw)
    got = gen.generate(tp, pcfg, prompts, device="cpu", **kw)
    np.testing.assert_array_equal(got.n_generated, ref.n_generated)
    np.testing.assert_array_equal(got.tokens, ref.tokens)


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


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "nospec"])
def test_batcher_int8_pool_identical_to_reference(llama, spec, batcher_defaults):
    """Four requests through two slots, then a second round on the same
    batcher whose prompts extend the first's: the same tokens and the same
    prefix-cache hits (adopted int8 pages and scale pages)."""
    cfg, jp, pcfg, tp = llama
    rng = np.random.default_rng(0)
    lens, budgets = [3, 70, 9, 33], [8, 20, 24, 17]
    r1 = [[int(t) for t in rng.integers(3, 500, size=n)] for n in lens]
    r2 = [p + [int(t) for t in rng.integers(3, 500, size=21)] for p in r1]
    kw = dict(
        max_batch=2, page_size=16, capacity_tokens=2048, max_new_cap=32,
        eos_ids=[], speculative=spec, gamma=8, prefix_cache=True, chunk=32,
        kv_dtype="int8",
    )
    out = {}
    for name, mod, p, c in (("jax", jax_sched, jp, cfg), ("port", sched, tp, pcfg)):
        b = mod.ContinuousBatcher(p, c, **kw)
        rounds = []
        for prompts in (r1, r2):
            for i, (pr, n) in enumerate(zip(prompts, budgets)):
                b.submit(mod.SchedRequest(req_id=i, prompt_ids=pr, max_new_tokens=n))
            rounds.append(b.run_all())
        out[name] = rounds
    assert out["port"][0][0].tokens is not None and b.pool["ks"].dtype == torch.float32
    for ref_round, got_round in zip(out["jax"], out["port"]):
        for r, g in zip(ref_round, got_round):
            assert (g.req_id, g.n_generated, g.cached_tokens) == (r.req_id, r.n_generated, r.cached_tokens)
            np.testing.assert_array_equal(g.tokens[: g.n_generated], np.asarray(r.tokens)[: r.n_generated])
    assert sum(g.cached_tokens for g in out["port"][1]) > 0
    b.allocator.check_invariants()
