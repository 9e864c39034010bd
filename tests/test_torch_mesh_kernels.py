"""The port's mesh wrappers W1-W3 against the reference's, on the CPU.

W1 ``decode_attention_tp``, W3 ``paged_decode_attention_tp`` and W2
``paged_decode_attention_dp_tp`` are the reference's ``shard_map``s of its
Pallas kernels B1 / B3 (``ops/pallas_decode.py``, ``ops/pallas_paged.py``),
run here in interpret mode on the reference's 8 virtual host devices. The
port's are per-shard splits around B1 / B3: on CPU tensors each shard runs
the kernel's plain version. The same numpy inputs (seeded) go through
both; the port's are split onto a mesh of ``["cpu"] * 8`` with
``parallel/sharding.py``'s ``split`` under the reference's in-specs, and
its output grid is gathered back under the out-spec.

Cases: float and int8 K/V, left pads, an empty window, softcap; W3 and
W2 with the trash page inside a window and -1 padding; W2 with a
NaN-poisoned trash page in every dp slice (int8: -128 beside NaN scales),
on dp×tp and on a dp-only mesh (tp=1). Tolerance: f32 within 2e-5, as B1-B4 are held (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.ops import pallas_decode as jax_pd
from adversarial_spec_tpu.ops import pallas_paged as jax_pp
from adversarial_spec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa
from adversarial_spec_tpu_torch.parallel.mesh import DP, TP, make_mesh
from adversarial_spec_tpu_torch.parallel.sharding import gather, split

TOL = dict(rtol=2e-5, atol=2e-5)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _needs_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("requires 8 virtual devices (see conftest XLA_FLAGS)")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny models and their shards here gain
    nothing from a team of every core, which on a loaded host costs them
    far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8(x):
    """The cache's per-(slot, head) symmetric int8 (numpy)."""
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(x / s), -127, 127).astype(np.int8), s.astype(np.float32)


def _kv(rng, shape, kv):
    """(k, v, scales) as numpy: f32, or int8 beside f32 scales."""
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kv != "int8":
        return k, v, {}
    (k8, ks), (v8, vs) = _int8(k), _int8(v)
    return k8, v8, {"k_scale": ks, "v_scale": vs}


def _port(mesh, arrays_specs):
    return [split(torch.from_numpy(np.ascontiguousarray(a)), mesh, spec)
            for a, spec in arrays_specs]


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("mesh_spec", [{"dp": 4, "tp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_w1_matches_reference(mesh_spec, kv, softcap):
    rng = np.random.default_rng(7)
    B, Hq, Hkv, D, T = 4, 8, 2, 64, 256
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k, v, sc = _kv(rng, (B, Hkv, T, D), kv)
    # Full, left-padded, tail-only and empty windows.
    bounds = np.array([[0, 256], [3, 100], [100, 256], [17, 17]], np.int32)
    jmesh = jax_make_mesh(mesh_spec)
    with jmesh:
        ref = jax_pd.decode_attention_tp(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bounds),
            jmesh, attn_softcap=softcap, interpret=True,
            **{n: jnp.asarray(s) for n, s in sc.items()},
        )
    mesh = make_mesh(mesh_spec, CPU8)
    kv_spec = (DP, TP, None, None)
    gq, gk, gv, gb = _port(mesh, [(q, (DP, TP, None)), (k, kv_spec), (v, kv_spec), (bounds, (DP,))])
    gsc = {n: _port(mesh, [(s, kv_spec)])[0] for n, s in sc.items()}
    da.reset_launches()
    out = da.decode_attention_tp(gq, gk, gv, gb, mesh, attn_softcap=softcap, **gsc)
    got = gather(out, mesh, (DP, TP, None))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = gather(da.decode_attention_tp_plain(gq, gk, gv, gb, mesh, attn_softcap=softcap, **gsc),
                   mesh, (DP, TP, None))
    torch.testing.assert_close(plain, got, rtol=0, atol=0)
    # Plain runs on CPU tensors never count as launches.
    assert da.mesh_launches == {"decode_attention_tp": 0}
    assert not any(da.launches.values())


def _paged_inputs(rng, kv, dp, pages_per_slice=6, page=16, Hkv=2, D=64):
    """A per-dp-slice pool (slice d: global pages [d·Lp, (d+1)·Lp), local
    page 0 its NaN-poisoned trash page) and two rows per slice: row 0 maps
    the trash page (global 0) inside its window, row 1 ends in -1
    padding; slice 0's row 1 has an empty window."""
    n_pages = dp * pages_per_slice
    k, v, sc = _kv(rng, (n_pages, Hkv, page, D), kv)
    for d in range(dp):
        trash = d * pages_per_slice
        if kv == "int8":
            k[trash] = v[trash] = -128
            sc["k_scale"][trash] = sc["v_scale"][trash] = np.nan
        else:
            k[trash] = v[trash] = np.nan
    rows, bounds = [], []
    for d in range(dp):
        base = d * pages_per_slice
        rows.append([base + 1, 0, base + 3, base + 2])
        rows.append([base + 5, base + 4, -1, -1])
        bounds += [[5, 4 * page - 3], [0 if d else 7, 2 * page - 1 if d else 7]]
    return (k, v, sc, np.asarray(rows, np.int32), np.asarray(bounds, np.int32))


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_w2_matches_reference(kv, softcap):
    _check_w2({"dp": 2, "tp": 2}, kv, softcap)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_w2_on_a_dp_only_mesh_matches_reference(kv):
    """tp=1: the step a paged alias on a dp-only mesh runs."""
    _check_w2({"dp": 2}, kv, 0.0)


def _check_w2(mesh_spec, kv, softcap):
    rng = np.random.default_rng(11)
    k, v, sc, table, bounds = _paged_inputs(rng, kv, dp=2)
    B, Hq, D = table.shape[0], 8, k.shape[-1]
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    jmesh = jax_make_mesh(mesh_spec)
    with jmesh:
        ref = jax_pp.paged_decode_attention_dp_tp(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(bounds), jmesh, attn_softcap=softcap, interpret=True,
            **{n: jnp.asarray(s) for n, s in sc.items()},
        )
    ref = np.asarray(ref)
    assert np.isfinite(ref).all()
    mesh = make_mesh(mesh_spec, CPU8)
    page_spec = (DP, TP, None, None)
    gq, gk, gv, gt, gb = _port(mesh, [(q, (DP, TP, None)), (k, page_spec), (v, page_spec),
                                      (table, (DP,)), (bounds, (DP,))])
    gsc = {n: _port(mesh, [(s, page_spec)])[0] for n, s in sc.items()}
    pa.reset_launches()
    got = gather(pa.paged_decode_attention_dp_tp(gq, gk, gv, gt, gb, mesh,
                                                 attn_softcap=softcap, **gsc),
                 mesh, (DP, TP, None))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = gather(pa.paged_decode_attention_dp_tp_plain(gq, gk, gv, gt, gb, mesh,
                                                         attn_softcap=softcap, **gsc),
                   mesh, (DP, TP, None))
    torch.testing.assert_close(plain, got, rtol=0, atol=0)
    assert not any(pa.mesh_launches.values())


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_w3_matches_reference(kv, softcap):
    rng = np.random.default_rng(13)
    mesh_spec = {"tp": 2}
    k, v, sc, table, bounds = _paged_inputs(rng, kv, dp=1)
    B, Hq, D = table.shape[0], 8, k.shape[-1]
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    jmesh = jax_make_mesh(mesh_spec)
    with jmesh:
        ref = np.asarray(jax_pp.paged_decode_attention_tp(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(bounds), jmesh, attn_softcap=softcap, interpret=True,
            **{n: jnp.asarray(s) for n, s in sc.items()},
        ))
    # The reference's tp-only mesh is dp=4 × tp=2 over 8 devices; the
    # wrapper replicates over dp, so the port's runs on the same mesh.
    mesh = make_mesh(mesh_spec, CPU8)
    page_spec = (None, TP, None, None)
    gq, gk, gv, gt, gb = _port(mesh, [(q, (None, TP, None)), (k, page_spec), (v, page_spec),
                                      (table, ()), (bounds, ())])
    gsc = {n: _port(mesh, [(s, page_spec)])[0] for n, s in sc.items()}
    got = gather(pa.paged_decode_attention_tp(gq, gk, gv, gt, gb, mesh,
                                              attn_softcap=softcap, **gsc),
                 mesh, (None, TP, None))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = gather(pa.paged_decode_attention_tp_plain(gq, gk, gv, gt, gb, mesh,
                                                      attn_softcap=softcap, **gsc),
                   mesh, (None, TP, None))
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_wrappers_need_the_cards_kernels_on_cuda_tensors_only():
    """A CPU shard never counts a launch, and every wrapper's per-shard
    output keeps the shard's own query heads."""
    mesh = make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 64)).astype(np.float32)
    k, v, _ = _kv(rng, (2, 2, 32, 64), "float")
    b = np.array([[0, 32], [4, 9]], np.int32)
    gq, gk, gv, gb = _port(mesh, [(q, (DP, TP, None)), (k, (DP, TP, None, None)),
                                  (v, (DP, TP, None, None)), (b, (DP,))])
    out = da.decode_attention_tp(gq, gk, gv, gb, mesh)
    assert [[tuple(o.shape) for o in row] for row in out] == [[(1, 2, 64)] * 2] * 2
    assert da.mesh_launches["decode_attention_tp"] == 0
