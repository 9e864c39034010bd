"""The port's sequence-parallel axis against the reference's, on the CPU.

``parallel/ring.py`` and ``parallel/sp.py`` of the port run on
``devices=["cpu"] * 8`` meshes; the reference's on its 8 virtual host
devices (``tests/conftest.py``), on the same weights (the reference's
init bridged with ``params_from_jax``):

- ring attention against the reference's ``ring_attention`` (sp 2, 4, 8;
  causal and not; left pads, a softcap, a static window) at the
  reference's own 3e-5; a fully masked row is exact zeros; the hop table
  and the windowed early-out;
- ``sp_prefill``'s logits and cache against the reference's at 2e-4, on
  llama (sp=4, sp=2×tp=2) and on the windowed families; its refusal of a
  tp that does not divide the heads, in the reference's words;
- ``reshard_cache_for_decode`` on the reference's own prefill cache:
  float equal, int8 values and scales bit-identical;
- ``generate`` on sp meshes (dense, speculation, int8 KV, paged on the
  W3 and W2 paths, and an sp that does not split the padded length):
  greedy tokens and ``n_generated`` equal to the port's single-device
  run, which the port's own tests hold to the reference's single-device
  run, as the reference's tests hold its sp runs to its single-device
  run. Two cases also run the reference's mesh ``generate``.

On the CPU the decode wrappers take their kernels' plain versions; the
ring is plain PyTorch everywhere (the reference's is plain XLA).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_get_config
from adversarial_spec_tpu.parallel import ring as jax_ring
from adversarial_spec_tpu.parallel import sp as jax_sp
from adversarial_spec_tpu.parallel.mesh import compat_shard_map as jax_shard_map
from adversarial_spec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from adversarial_spec_tpu.parallel.sharding import shard_params as jax_shard_params
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.parallel import collectives, ring, sp
from adversarial_spec_tpu_torch.parallel.mesh import make_mesh
from adversarial_spec_tpu_torch.parallel.sharding import (
    cache_sharding,
    gather,
    shard_params,
    split,
    Sharded,
)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _needs_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("requires 8 virtual devices (see conftest XLA_FLAGS)")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny shapes gain nothing from a team of
    every core, which on a loaded host costs them far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS: dict = {}


def _model(family: str = "llama", window: int = 0):
    """(reference params, reference cfg, port params, port cfg) of the
    tiny f32 model; ``window`` shrinks the sliding window so it truncates
    across ring blocks."""
    key = (family, window)
    if key not in _MODELS:
        jcfg, cfg = jax_get_config(family, "tiny"), get_config(family, "tiny")
        if window:
            jcfg, cfg = replace(jcfg, sliding_window=window), replace(cfg, sliding_window=window)
        jp = jax_tf.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
        _MODELS[key] = (jp, jcfg, pp, cfg)
    return _MODELS[key]


# -- ring attention -----------------------------------------------------------


def _qkv(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _ref_ring_windowed(q, k, v, sp_n, window):
    """The reference's per-device body under its own shard_map, with a
    static window (its global wrapper takes none)."""
    from jax.sharding import PartitionSpec as P

    spec = P(None, "sp", None, None)

    def local(qb, kb, vb):
        return jax_ring.ring_attention_local(qb, kb, vb, sp_n, causal=True, window=window)

    mesh = jax_make_mesh({"sp": sp_n})
    return jax_shard_map(local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(
        *(jnp.asarray(a) for a in (q, k, v))
    )


RING_CASES = {
    "sp2": dict(sp=2),
    "sp4": dict(sp=4),
    "sp8": dict(sp=8),
    "noncausal": dict(sp=4, causal=False),
    "kv_start": dict(sp=4, kv_start=[5, 0]),
    "softcap": dict(sp=4, attn_softcap=2.0),
    "window": dict(sp=4, window=7, S=64),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_reference(case):
    c = dict(RING_CASES[case])
    sp_n, S = c.pop("sp"), c.pop("S", 32)
    q, k, v = _qkv(sorted(RING_CASES).index(case), 2, S, 4, 2, 16)
    if "window" in c:
        want = _ref_ring_windowed(q, k, v, sp_n, c["window"])
        mesh = make_mesh({"sp": sp_n}, CPU8)
        devs = [mesh.device(0, 0, s) for s in range(sp_n)]
        n = S // sp_n

        def blocks(x):
            return [torch.tensor(x[:, s * n : (s + 1) * n]).to(dev) for s, dev in enumerate(devs)]

        got = torch.cat(ring.ring_attention_local(
            blocks(q), blocks(k), blocks(v), sp_n, causal=True, window=c["window"]
        ), dim=1)
    else:
        ks = c.pop("kv_start", None)
        want = jax_ring.ring_attention(
            *(jnp.asarray(a) for a in (q, k, v)), jax_make_mesh({"sp": sp_n}),
            kv_start=None if ks is None else jnp.asarray(ks, jnp.int32), **c,
        )
        got = ring.ring_attention(
            *(torch.tensor(a) for a in (q, k, v)), make_mesh({"sp": sp_n}, CPU8),
            kv_start=None if ks is None else torch.tensor(ks), **c,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_fully_masked_row_is_exact_zeros():
    """A row whose every key slot is a left pad attends to nothing: its
    output is 0.0 exactly, never NaN."""
    q, k, v = _qkv(3, 2, 32, 4, 2, 16)
    out = ring.ring_attention(
        *(torch.tensor(a) for a in (q, k, v)), make_mesh({"sp": 4}, CPU8),
        kv_start=torch.tensor([32, 0]),
    )
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all() and out[1].abs().sum() > 0


def test_indivisible_sequence_raises():
    x = torch.zeros((1, 30, 2, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring.ring_attention(x, x, x, make_mesh({"sp": 4}, CPU8))


def test_hop_bound_formula():
    assert ring.ring_hops(8, 512, 0, True) == 8
    assert ring.ring_hops(8, 512, 64, False) == 8
    assert ring.ring_hops(8, 512, 8, True) == 2
    assert ring.ring_hops(8, 512, 512, True) == 2
    assert ring.ring_hops(8, 512, 513, True) == 2
    assert ring.ring_hops(8, 512, 514, True) == 3
    assert ring.ring_hops(4, 512, 10**6, True) == 4
    assert ring.ring_hops(8, 512, torch.tensor(8), True) == 2
    assert ring.ring_hops(8, 512, torch.tensor(0), True) == 8
    for case in ((8, 512, 514, True), (4, 512, 10**6, True), (8, 512, 64, False)):
        assert ring.ring_hops(*case) == jax_ring.ring_hops(*case)


def test_windowed_early_out_equals_every_hop(monkeypatch):
    """Leaving the ring after ``ring_hops`` hops changes nothing: the same
    ring forced through every hop, the window a mask alone, gives the same
    output."""
    q, k, v = _qkv(21, 2, 64, 4, 2, 16)
    n = 16

    def run():
        ring.reset_counts()
        blocks = [[torch.tensor(x[:, s * n : (s + 1) * n]) for s in range(4)] for x in (q, k, v)]
        out = torch.cat(ring.ring_attention_local(*blocks, 4, causal=True, window=7), dim=1)
        return out, ring.counts["hops"]

    early, hops = run()
    assert hops == 2
    monkeypatch.setattr(ring, "ring_hops", lambda sp_n, b, w, c: sp_n)
    full, hops = run()
    assert hops == 4
    np.testing.assert_allclose(early.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


def test_ring_shift_counts_its_way():
    collectives.reset_counts()
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert [p[0].item() for p in collectives.ring_shift(parts)] == [3.0, 0.0, 1.0, 2.0]
    assert collectives.counts == {"nccl": 0, "local": 1, "peer": 0, "dist": 0}


# -- the sequence-parallel prefill -------------------------------------------


def _prompt(seed, vocab, B=2, S=32, pads=(3, 0)):
    tokens = np.asarray(jax.random.randint(jax.random.key(seed), (B, S), 0, vocab), np.int32)
    pads = np.asarray(pads, np.int32)
    return np.where(np.arange(S)[None, :] < pads[:, None], 0, tokens), pads


_REF_PREFILL: dict = {}


def _ref_sp_prefill(case):
    """The reference's ``sp_prefill`` of a case, computed once."""
    if case not in _REF_PREFILL:
        family, window, mesh_spec, seed, pads = PREFILL_CASES[case]
        jp, jcfg, _, cfg = _model(family, window)
        tokens, pads = _prompt(seed, cfg.vocab_size, pads=pads)
        jmesh = jax_make_mesh(mesh_spec)
        with jmesh:
            logits, cache = jax_sp.sp_prefill(
                jax_shard_params(jmesh, jp), jcfg, jnp.asarray(tokens), jnp.asarray(pads), jmesh
            )
        _REF_PREFILL[case] = (tokens, pads, np.asarray(logits),
                              {k: np.asarray(v) for k, v in cache.items()})
    return _REF_PREFILL[case]


PREFILL_CASES = {
    # (family, window, mesh, prompt seed, pads)
    "llama-sp4": ("llama", 0, {"sp": 4}, 5, (3, 0)),
    "llama-sp2-tp2": ("llama", 0, {"sp": 2, "tp": 2, "dp": 1}, 7, (5, 0)),
    "mistral-sp4-window8": ("mistral", 8, {"sp": 4}, 9, (3, 0)),
    "gemma2-sp4-window8": ("gemma2", 8, {"sp": 4}, 9, (3, 0)),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_sp_prefill_matches_reference(case):
    family, window, mesh_spec, _, _ = PREFILL_CASES[case]
    tokens, pads, want_logits, want_cache = _ref_sp_prefill(case)
    _, _, pp, cfg = _model(family, window)
    mesh = make_mesh(mesh_spec, CPU8)
    sp.reset_counts()
    ring.reset_counts()
    logits, cache = sp.sp_prefill(
        shard_params(mesh, pp), cfg, torch.tensor(tokens, dtype=torch.int64),
        torch.tensor(pads, dtype=torch.int64), mesh,
    )
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-4, atol=2e-4)
    for name in ("k", "v"):
        assert cache[name].spec == cache_sharding(mesh, prefill=True)
        assert cache[name].shape == want_cache[name].shape
        got = gather(cache[name].parts, mesh, cache[name].spec)
        np.testing.assert_allclose(got.numpy(), want_cache[name], rtol=2e-4, atol=2e-4)
    # One ring per (dp, tp) group and layer, each of ring_hops hops.
    groups = mesh.shape["dp"] * mesh.shape["tp"] * cfg.n_layers
    n = tokens.shape[1] // mesh.shape["sp"]
    want_hops = sum(
        ring.ring_hops(mesh.shape["sp"], n, sp._layer_window(cfg, layer), True)
        for layer in range(cfg.n_layers)
    ) * mesh.shape["dp"] * mesh.shape["tp"]
    assert sp.counts["prefills"] == 1 and ring.counts["calls"] == groups
    assert ring.counts["hops"] == want_hops


def test_tp_not_dividing_the_heads_raises_the_reference_error():
    jp, jcfg, pp, cfg = _model()
    tokens = np.zeros((1, 32), np.int32)
    with pytest.raises(ValueError, match="must divide") as want:
        jax_sp.sp_prefill(jp, jcfg, jnp.asarray(tokens), jnp.zeros((1,), jnp.int32),
                          jax_make_mesh({"sp": 2, "tp": 4}))
    mesh = make_mesh({"sp": 2, "tp": 4}, CPU8)
    with pytest.raises(ValueError, match="must divide") as got:
        sp.sp_prefill(None, cfg, torch.zeros((1, 32), dtype=torch.int64),
                      torch.zeros((1,), dtype=torch.int64), mesh)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["float", "int8"])
def test_reshard_is_the_references_on_its_cache(kv_dtype):
    """The reference's own prefill cache, resharded by both packages: the
    float cache equal, the int8 values and scales bit-identical."""
    _, _, _, cache_np = _ref_sp_prefill("llama-sp4")
    S, total = cache_np["k"].shape[3], cache_np["k"].shape[3] + 8
    jmesh = jax_make_mesh({"sp": 4})
    with jmesh:
        want = jax_sp.reshard_cache_for_decode(
            {k: jnp.asarray(v) for k, v in cache_np.items()}, jmesh, total, kv_dtype=kv_dtype
        )
    mesh = make_mesh({"sp": 4}, CPU8)
    spec = cache_sharding(mesh, prefill=True)
    cache = {k: Sharded(mesh, spec, split(torch.tensor(v), mesh, spec)) for k, v in cache_np.items()}
    got = sp.reshard_cache_for_decode(cache, mesh, total, kv_dtype=kv_dtype)
    assert sorted(got) == sorted(want)
    for name, arr in got.items():
        assert arr.spec == cache_sharding(mesh)
        full = gather(arr.parts, mesh, arr.spec).numpy()
        np.testing.assert_array_equal(full, np.asarray(want[name]))
    assert got["k"].shape[3] == total and S < total


# -- generate on sp meshes ---------------------------------------------------


P2 = [[1, 5, 9, 3, 7, 2], [4, 4, 8]]
P4 = [[1, 5, 9, 3, 7, 2], [4, 4, 8], [6, 1, 1, 2], [9, 9]]
BASE = [3, 7, 11, 5] * 4
SPEC_P = [BASE + [9], BASE + [13]]

GEN_CASES = {
    # (mesh spec, device count, prompts, generate kwargs)
    "sp4-dp2": ({"sp": 4, "dp": 2}, 8, P2, {}),
    "sp2-tp2": ({"sp": 2, "tp": 2}, 8, P2, {}),
    "dp2-sp2-tp2": ({"sp": 2, "tp": 2, "dp": 2}, 8, P4, dict(max_new_tokens=4)),
    "spec-sp4-dp2": ({"sp": 4, "dp": 2}, 8, SPEC_P, dict(speculative=True, max_new_tokens=24)),
    "spec-sp2-tp2-dp2": ({"sp": 2, "tp": 2, "dp": 2}, 8, SPEC_P,
                         dict(speculative=True, max_new_tokens=20)),
    "int8kv-sp4-dp2": ({"sp": 4, "dp": 2}, 8, P2, dict(kv_dtype="int8")),
    "paged-sp2": ({"sp": 2, "tp": 1}, 2, P4, dict(paged=True, max_new_tokens=8)),
    "paged-sp2-tp2-int8": ({"sp": 2, "tp": 2}, 4, P2, dict(paged=True, kv_dtype="int8")),
    "paged-dp2-sp2": ({"dp": 2, "sp": 2, "tp": 1}, 8, P4, dict(paged=True, max_new_tokens=8)),
    # 128 slots do not split 3 ways: the chunked prefill on the mesh.
    "chunked-dp2-sp3": ({"dp": 2, "sp": 3}, 8, P2, {}),
}
# The cases that also run the reference's mesh generate.
WITH_REFERENCE = ("sp2-tp2", "paged-dp2-sp2")

_SINGLE: dict = {}


def _gen_kw(extra):
    kw = dict(max_new_tokens=6, eos_ids=[], greedy=True, speculative=False, share_prefix=False)
    if extra.get("paged"):
        kw["page_size"] = 16
    kw.update(extra)
    return kw


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_on_sp_meshes(case):
    mesh_spec, n_dev, prompts, extra = GEN_CASES[case]
    kw = _gen_kw(extra)
    jp, jcfg, pp, cfg = _model()
    # The single-device run takes the same knobs, speculation off: greedy
    # speculation is bit-identical to plain decode.
    single_kw = dict(kw, speculative=False)
    key = repr((prompts, sorted(single_kw.items())))
    if key not in _SINGLE:
        _SINGLE[key] = gen.generate(pp, cfg, prompts, device="cpu", **single_kw)
    single = _SINGLE[key]
    mesh = make_mesh(mesh_spec, CPU8[:n_dev])
    sp.reset_counts()
    ring.reset_counts()
    collectives.reset_counts()
    out = gen.generate(shard_params(mesh, pp), cfg, prompts, mesh=mesh, **kw)
    np.testing.assert_array_equal(out.tokens, single.tokens)
    np.testing.assert_array_equal(out.n_generated, single.n_generated)
    splits = 128 % mesh.shape["sp"] == 0
    assert sp.counts == ({"prefills": 1, "reshards": 1} if splits else {"prefills": 0, "reshards": 0})
    assert (ring.counts["calls"] > 0) == splits
    assert collectives.counts["nccl"] == collectives.counts["peer"] == 0
    if case in WITH_REFERENCE:
        jmesh = jax_make_mesh(mesh_spec, devices=jax.devices()[:n_dev])
        with jmesh:
            ref = jax_gen.generate(jax_shard_params(jmesh, jp), jcfg, prompts, mesh=jmesh, **kw)
        np.testing.assert_array_equal(out.tokens, np.asarray(ref.tokens))
        np.testing.assert_array_equal(out.n_generated, np.asarray(ref.n_generated))


@pytest.mark.slow
def test_sp_prefill_matches_chunked_at_16k():
    """The sp prefill at a real 16384-token sequence (a one-layer thin
    model keeps the S² attention tractable on the CPU) against the port's
    chunked prefill, which its other tests hold to the reference's."""
    S = 16384
    cfg = replace(get_config("llama", "tiny"), n_layers=1, n_heads=2, n_kv_heads=2,
                  dim=128, ffn_dim=256, max_seq_len=S + 64)
    from adversarial_spec_tpu_torch.models.transformer import init_cache, init_params

    pp = init_params(cfg, device=torch.device("cpu"), dtype=torch.float32)
    tokens = torch.tensor(np.random.default_rng(5).integers(3, cfg.vocab_size, (1, S)))
    pads = torch.zeros((1,), dtype=torch.int64)
    mesh = make_mesh({"sp": 4}, CPU8[:4])
    logits, _ = sp.sp_prefill(shard_params(mesh, pp), cfg, tokens, pads, mesh)
    cache = init_cache(cfg, 1, S, device=torch.device("cpu"), dtype=torch.float32)
    for ci in range(0, S, 1024):
        last = gen.prefill_chunk(pp, cfg, tokens[:, ci : ci + 1024], pads, cache, ci)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=3e-4, atol=3e-4)
