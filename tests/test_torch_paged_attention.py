"""The port's paged decode attention (B3, B4) against the reference's
Pallas kernels run in interpret mode on the CPU.

Same inputs (numpy, seeded) through ``adversarial_spec_tpu/ops/
pallas_paged.py`` (``interpret=True``) and the port's wrappers, which take
their plain PyTorch versions for CPU tensors. Cases follow the reference's
own pins (``tests/test_pallas.py``): scattered pages with -1 padding,
unmapped table slots after the first page, the trash page 0 masked even
where the window covers it, a poisoned pool, pad rows (S·g not a multiple
of the TPU's 8 sublanes), ``[B, 1]`` bounds, softcap, and B4 at S=1 equal
to B3.

Tolerances: f32 at 2e-5 (summation order only: both accumulate in f32);
bf16 at rtol 1.6e-2 (one bf16 rounding of an f32 result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.ops.pallas_paged import (
    paged_decode_attention as jax_b3,
)
from adversarial_spec_tpu.ops.pallas_paged import (
    paged_decode_attention_mq as jax_b4,
)
from adversarial_spec_tpu_torch.ops import paged_attention as pa

TOL = {
    "float32": dict(rtol=2e-5, atol=2e-5),
    "bfloat16": dict(rtol=1.6e-2, atol=1e-5),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pool(rng, n_pages, Hkv, page, D):
    kp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, page, D)).astype(np.float32)
    return kp, vp


def _both(arrays, dtype):
    """numpy → (jnp list, torch list) in ``dtype`` (ints stay int32)."""
    jd, td = DTYPES[dtype]
    js, ts = [], []
    for a in arrays:
        if a.dtype.kind == "i":
            js.append(jnp.asarray(a, jnp.int32))
            ts.append(torch.from_numpy(a.astype(np.int32)))
        else:
            js.append(jnp.asarray(a).astype(jd))
            ts.append(torch.from_numpy(a).to(td))
    return js, ts


def _close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])


B3_CASES = {
    # Scattered pages, -1 padding, a left-padded window and a short row.
    "gathered": dict(
        B=2, Hq=8, Hkv=2, D=64, page=16, n_pages=32,
        table=[[3, 7, 1] + [-1] * 5, [5] + [-1] * 7],
        bounds=[[2, 40], [0, 9]],
    ),
    # One mapped page, -1 after it, window exactly the page.
    "unmapped_after_first": dict(
        B=1, Hq=4, Hkv=2, D=64, page=8, n_pages=4,
        table=[[2] + [-1] * 7], bounds=[[0, 8]],
    ),
    # Logical page 1 → physical 0 (trash): masked although bounds cover it.
    "trash_page_zero": dict(
        B=1, Hq=4, Hkv=2, D=64, page=8, n_pages=4,
        table=[[2, 0, 0, 0]], bounds=[[0, 16]],
    ),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(B3_CASES))
@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
def test_b3_plain_matches_pallas(case, dtype, softcap):
    c = B3_CASES[case]
    rng = np.random.default_rng(len(case))
    kp, vp = _pool(rng, c["n_pages"], c["Hkv"], c["page"], c["D"])
    q = rng.standard_normal((c["B"], c["Hq"], c["D"])).astype(np.float32)
    table = np.asarray(c["table"], np.int32)
    bounds = np.asarray(c["bounds"], np.int32)
    (jq, jk, jv, jt, jb), (tq, tk, tv, tt, tb) = _both(
        [q, kp, vp, table, bounds], dtype
    )
    ref = jax_b3(jq, jk, jv, jt, jb, attn_softcap=softcap, interpret=True)
    got = pa.paged_decode_attention(tq, tk, tv, tt, tb, attn_softcap=softcap)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    _close(got, ref, dtype)


def test_b3_nan_poisoned_pool_outside_mapped_windows():
    """The trash page and every page no row maps hold NaN: neither the
    reference nor the port may let it reach the output."""
    rng = np.random.default_rng(7)
    kp, vp = _pool(rng, 12, 2, 8, 64)
    table = np.array([[3, 0, 5, -1], [0, 7, 0, 9]], np.int32)
    unused = [p for p in range(12) if p not in (3, 5, 7, 9)]
    kp[unused] = np.nan
    vp[unused] = np.nan
    q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    bounds = np.array([[1, 24], [0, 32]], np.int32)
    (jq, jk, jv, jt, jb), (tq, tk, tv, tt, tb) = _both(
        [q, kp, vp, table, bounds], "float32"
    )
    ref = np.asarray(jax_b3(jq, jk, jv, jt, jb, interpret=True))
    got = pa.paged_decode_attention(tq, tk, tv, tt, tb)
    assert np.isfinite(ref).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL["float32"])


def _b4_inputs(rng, B, S, Hq, Hkv, D, page, P, poison=None):
    n_pages = 1 + B * P  # physical page 0 = trash
    kp, vp = _pool(rng, n_pages, Hkv, page, D)
    if poison is not None:
        kp[0] = poison
        vp[0] = poison
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, kp, vp


B4_CASES = {
    # Per-position causal ends, one windowed (start > 0) row.
    "per_position": dict(
        B=2, S=5, Hq=8, Hkv=2, D=64, page=16, P=6,
        table=[[1, 2, 3, 4, -1, -1], [7, 8, 9, -1, -1, -1]],
        starts=[[3] * 5, [0] * 5],
        ends=[[51 + j for j in range(5)], [34 + j for j in range(5)]],
    ),
    # A 0 (trash, poisoned with 1e9) entry mid-table inside the windows.
    "trash_mid_table": dict(
        B=1, S=3, Hq=4, Hkv=2, D=64, page=8, P=4, poison=1e9,
        table=[[1, 0, 2, -1]], starts=[[0] * 3], ends=[[20, 21, 22]],
    ),
    # S·g = 6 rows: the reference pads them to 8 with [T, 0) windows.
    "pad_rows": dict(
        B=2, S=3, Hq=4, Hkv=2, D=64, page=16, P=4,
        table=[[1, 2, 3, 4], [5, 6, 7, 8]],
        starts=[[0] * 3] * 2, ends=[[40, 41, 42]] * 2,
    ),
    # [B, 1] starts broadcast over the span; row 1's window is empty.
    "broadcast_and_empty": dict(
        B=2, S=4, Hq=8, Hkv=2, D=64, page=8, P=5,
        table=[[1, 2, 3, -1, -1], [6, 7, -1, -1, -1]],
        starts=[[2], [16]], ends=[[20, 21, 22, 23], [16, 16, 16, 16]],
    ),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(B4_CASES))
@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
def test_b4_plain_matches_pallas(case, dtype, softcap):
    c = B4_CASES[case]
    rng = np.random.default_rng(100 + len(case))
    q, kp, vp = _b4_inputs(
        rng, c["B"], c["S"], c["Hq"], c["Hkv"], c["D"], c["page"], c["P"],
        poison=c.get("poison"),
    )
    arrays = [q, kp, vp] + [
        np.asarray(c[k], np.int32) for k in ("table", "starts", "ends")
    ]
    (jq, jk, jv, jt, js, je), (tq, tk, tv, tt, ts, te) = _both(arrays, dtype)
    ref = jax_b4(jq, jk, jv, jt, js, je, attn_softcap=softcap, interpret=True)
    got = pa.paged_decode_attention_mq(tq, tk, tv, tt, ts, te, attn_softcap=softcap)
    assert got.shape == tq.shape and torch.isfinite(got).all()
    _close(got, ref, dtype)
    if case == "broadcast_and_empty":
        assert (got[1] == 0).all()  # empty windows: exact zeros


def test_b4_at_one_position_equals_b3():
    rng = np.random.default_rng(25)
    q, kp, vp = _b4_inputs(rng, 2, 1, 8, 2, 64, 16, 6)
    table = torch.from_numpy(1 + np.arange(12, dtype=np.int32).reshape(2, 6))
    bounds = torch.tensor([[2, 40], [0, 90]], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    mq = pa.paged_decode_attention_mq(tq, tk, tv, table, bounds[:, :1], bounds[:, 1:])
    sq = pa.paged_decode_attention(tq[:, 0], tk, tv, table, bounds)
    torch.testing.assert_close(mq[:, 0], sq, rtol=0, atol=0)


def test_cpu_wrappers_never_count_launches():
    pa.reset_launches()
    rng = np.random.default_rng(3)
    q, kp, vp = _b4_inputs(rng, 1, 2, 4, 2, 64, 8, 2)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    e = torch.tensor([[5, 6]], dtype=torch.int32)
    pa.paged_decode_attention_mq(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        table, torch.zeros_like(e), e,
    )
    assert pa.launches == {
        "paged_decode_attention": 0,
        "paged_decode_attention_mq": 0,
        "paged_decode_attention_int8kv": 0,
        "paged_decode_attention_mq_int8kv": 0,
    }
