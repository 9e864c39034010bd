"""The port's mesh wrappers W1-W3 against the reference's, on the CPU.

W1 ``decode_attention_tp``, W3 ``paged_decode_attention_tp`` and W2
``paged_decode_attention_dp_tp`` are the reference's ``shard_map``s of its
Pallas kernels B1 / B3 (``ops/pallas_decode.py``, ``ops/pallas_paged.py``),
run here in interpret mode on the reference's 8 virtual host devices. The
port's run the shards one device holds as one sharded launch
(``decode_attention_sharded``, ``paged_decode_attention_sharded``); on
CPU tensors that is B1's / B3's plain version on each shard (W2's tables
rebased by each shard's base ``d·Lp``), the same as the plain wrappers
(``*_tp_plain``, ``*_dp_tp_plain``). The same numpy inputs (seeded) go
through both; the port's are split onto a mesh of ``["cpu"] * 8`` (one
device group) with ``parallel/sharding.py``'s ``split`` under the
reference's in-specs, and its output grid is gathered back under the
out-spec.

Cases: float and int8 K/V, left pads, an empty window, softcap; W3 and
W2 with the trash page inside a window and -1 padding; W2 with a
NaN-poisoned trash page in every dp slice (int8: -128 beside NaN scales),
on dp×tp and on a dp-only mesh (tp=1). Tolerance: f32 within 2e-5, as B1-B4 are held (summation order only).
The sharded entries' grouping (``device_groups``) and argument builder
(``sharded_args``: the cut at the cap, the page bases, the layout check)
are checked on CPU tensors and device lists that never touch a card.
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
from adversarial_spec_tpu_torch.ops import split_kv
from adversarial_spec_tpu_torch.parallel.mesh import DP, TP, device_groups, make_mesh
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


def _one_group(mesh, *grids):
    """The mesh's one device group (every shard on the CPU) and each
    grid's values in its order (None stays None)."""
    ((_, shards),) = device_groups(mesh)
    return shards, [None if g is None else [g[d][t] for d, t in shards] for g in grids]


def _no_launches(*mods):
    for mod in mods:
        assert not any(mod.launches.values())
        assert not any(mod.mesh_launches.values())
        assert not any(mod.mesh_shards.values())


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize(
    "mesh_spec", [{"dp": 4, "tp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 2}]
)
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
    assert da.mesh_launches == {"decode_attention_tp": 0, "decode_attention_tp_int8kv": 0}
    _no_launches(da)


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
@pytest.mark.parametrize("mesh_spec", [{"dp": 2, "tp": 2}, {"dp": 4, "tp": 2}])
def test_w2_matches_reference(kv, softcap, mesh_spec):
    _check_w2(mesh_spec, kv, softcap)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_w2_on_a_dp_only_mesh_matches_reference(kv, softcap):
    """tp=1: the step a paged alias on a dp-only mesh runs."""
    _check_w2({"dp": 2}, kv, softcap)


def _check_w2(mesh_spec, kv, softcap):
    rng = np.random.default_rng(11)
    k, v, sc, table, bounds = _paged_inputs(rng, kv, dp=mesh_spec["dp"])
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
    # Each shard's base is its dp slice's first global page id, d·Lp.
    shards, ops = _one_group(mesh, gq, gk)
    lp = k.shape[0] // mesh.shape[DP]
    assert pa.page_bases(shards, ops[1], True) == [d * lp for d, _ in shards]
    _no_launches(pa)


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
    shards, ops = _one_group(mesh, gq, gk)
    assert pa.page_bases(shards, ops[1], False) == [0] * len(shards)
    _no_launches(pa)


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
    da.reset_launches()
    out = da.decode_attention_tp(gq, gk, gv, gb, mesh)
    assert [[tuple(o.shape) for o in row] for row in out] == [[(1, 2, 64)] * 2] * 2
    assert da.mesh_launches["decode_attention_tp"] == 0
    _no_launches(da)


CUDA = [torch.device("cuda", i) for i in range(8)]


@pytest.mark.parametrize("devices, spec, want", [
    # A virtual mesh: one group, every shard in grid order.
    ([CUDA[0]] * 8, {"dp": 4, "tp": 2},
     [(CUDA[0], [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)])]),
    # Distinct cards: one shard a group.
    (CUDA, {"dp": 2, "tp": 4}, [(CUDA[d * 4 + t], [(d, t)]) for d in range(2) for t in range(4)]),
    # Two cards, each holding a tp pair's shard of every dp slice.
    ([CUDA[i % 2] for i in range(8)], {"dp": 4, "tp": 2},
     [(CUDA[0], [(0, 0), (1, 0), (2, 0), (3, 0)]), (CUDA[1], [(0, 1), (1, 1), (2, 1), (3, 1)])]),
    # An sp mesh: decode runs on the sp-rank-0 devices only.
    (CUDA[:4], {"sp": 2, "tp": 2}, [(CUDA[0], [(0, 0)]), (CUDA[1], [(0, 1)])]),
    ([torch.device("cpu")] * 4, {"tp": 4},
     [(torch.device("cpu"), [(0, 0), (0, 1), (0, 2), (0, 3)])]),
])
def test_device_groups(devices, spec, want):
    """Groups by distinct device, in order of first appearance, shards in
    grid order; torch.device objects only, no card touched."""
    assert device_groups(make_mesh(spec, devices)) == want


def test_sharded_args_cut_at_the_cap_carry_bases_and_refuse_mixed_layouts():
    """W2's argument builder on CPU tensors: a group of 8 shards at cap 3
    is three launches of 3, 3 and 2 shards, each with the stacked rows'
    output, n_split and workspace, and each shard's pointers and base
    d·Lp in its table; a shard whose pool has other strides is refused."""
    rng = np.random.default_rng(5)
    mesh = make_mesh({"dp": 4, "tp": 2}, CPU8)
    k, v, sc, table, bounds = _paged_inputs(rng, "int8", dp=4)
    q = rng.standard_normal((table.shape[0], 8, k.shape[-1])).astype(np.float32)
    page_spec = (DP, TP, None, None)
    gq, gk, gv, gt, gb = _port(mesh, [(q, (DP, TP, None)), (k, page_spec), (v, page_spec),
                                      (table, (DP,)), (bounds, (DP,))])
    gks, gvs = (_port(mesh, [(sc[n], page_spec)])[0] for n in ("k_scale", "v_scale"))
    shards, (qs, ks, vs, ts, bs, kss, vss) = _one_group(mesh, gq, gk, gv, gt, gb, gks, gvs)
    bases = pa.page_bases(shards, ks, True)
    lp = k.shape[0] // 4
    assert bases == [d * lp for d, _ in shards] and max(bases) == 3 * lp
    runs = da.sharded_args(qs, ks, vs, bs, kss, vss, 30.0, None, tables=ts, bases=bases, cap=3)
    assert [n for *_, n in runs] == [3, 3, 2]
    B, Hq, D = qs[0].shape
    Hkv, page = ks[0].shape[1], ks[0].shape[2]
    first = 0
    for out, ws, args, n in runs:
        assert out.shape == (n, B, Hq, D)
        table_fields = list(args[0])
        assert args[1] == n and len(table_fields) == n * da.SHARD_FIELDS
        for j in range(n):
            i = first + j
            f = table_fields[j * da.SHARD_FIELDS:(j + 1) * da.SHARD_FIELDS]
            assert f == [qs[i].data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
                         kss[i].data_ptr(), vss[i].data_ptr(), ts[i].data_ptr(),
                         bs[i].data_ptr(), bases[i]]
        n_split = split_kv.decode_splits(n * B, Hkv, Hq // Hkv, ts[0].shape[1] * page, D, 1)
        assert n_split in args and (ws is None) == (n_split == 1)
        if ws is not None:
            assert ws.numel() == n_split * n * B * Hkv * (Hq // Hkv) * (D + 2)
        first += n
    # A pool with another layout (a slice of wider pages) is refused.
    odd = torch.cat([ks[4], ks[4]], dim=2)[:, :, :page]
    assert odd.shape == ks[4].shape and odd.stride() != ks[4].stride()
    with pytest.raises(ValueError, match="one layout"):
        da.sharded_args(qs, ks[:4] + [odd] + ks[5:], vs, bs, kss, vss, 0.0, None,
                        tables=ts, bases=bases, cap=3)
    # W1's builder: one launch of the whole group under the card's cap.
    caches = [torch.zeros((B, Hkv, 16, D)) for _ in qs]
    (out, _, args, n), = da.sharded_args(qs, caches, caches, bs, None, None, 0.0, None)
    assert n == 8 and out.shape == (8, B, Hq, D)
    fields = list(args[0])
    assert fields[1::da.SHARD_FIELDS] == [c.data_ptr() for c in caches]
    for f in (3, 4, 5, 7):  # no scales, no table, base 0
        assert not any(fields[f::da.SHARD_FIELDS])
