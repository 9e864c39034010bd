"""The port's CUDA kernels — decode attention (dense B1, paged B3), the
split-KV verify attention (dense B2, paged B4) and the dequant-matmuls (B5
int8, B6 int4) — against their plain versions.

These need a CUDA card (a CUDA kernel has no CPU mode): each test is
marked ``gpu`` and skips without one. The file imports no jax, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerances: f32 at atol/rtol 2e-5 (summation order only); bf16 at
rtol 1.6e-2 (one bf16 rounding of the output, the plain version
accumulating in f32 like the kernel). B5/B6: |got - want| <= rtol |want|
+ 2e-5 max|want|, rtol 0 for an f32 output and 1e-2 for a bf16 one (both
accumulate in f32; TF32 is off for the plain version's product).
"""

import pytest
import torch

from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa
from adversarial_spec_tpu_torch.ops import quant
from adversarial_spec_tpu_torch.ops import quant_matmul as qm

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cache(gen, dev, dtype, B, Hkv, T, D):
    """A layer's slice of a two-layer cache: strided, head_dim contiguous."""
    k = torch.randn((2, B, Hkv, T, D), generator=gen, device=dev)[1]
    v = torch.randn((2, B, Hkv, T, D), generator=gen, device=dev)[1]
    return k.to(dtype), v.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    """Ragged T, softcap, a single slot, an empty window; one launch
    counted per call."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(0)
    k, v = _cache(gen, cuda, dtype, 3, 2, 300, 128)
    q = torch.randn((3, 9, 8, 128), generator=gen, device=cuda).to(dtype)
    bnd = torch.tensor([[0, 300], [17, 18], [40, 40]], dtype=torch.int32, device=cuda)
    da.reset_launches()
    got = da.decode_attention(q[:, 0], k, v, bnd, attn_softcap=50.0)
    want = da.decode_attention_plain(q[:, 0], k, v, bnd, attn_softcap=50.0)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got[1], v[1, :, 17].repeat_interleave(4, 0))
    assert (got[2] == 0).all()
    ends = torch.tensor(
        [[280 + j for j in range(1, 10)]] * 3, dtype=torch.int32, device=cuda
    )
    starts = torch.tensor([[0], [5], [300]], dtype=torch.int32, device=cuda)
    got = da.decode_attention_mq(q, k, v, starts, ends)
    want = da.decode_attention_mq_plain(q, k, v, starts, ends)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[2] == 0).all()
    assert da.launches == {
        "decode_attention": 1, "decode_attention_mq": 1,
        "decode_attention_int8kv": 0, "decode_attention_mq_int8kv": 0,
    }


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 256])
def test_cuda_kernels_other_head_dims(cuda, D):
    gen = torch.Generator(device=cuda).manual_seed(D)
    k, v = _cache(gen, cuda, torch.float32, 2, 4, 257, D)
    q = torch.randn((2, 5, 4, D), generator=gen, device=cuda)
    ends = torch.tensor([[253 + j for j in range(5)], [100 + j for j in range(5)]],
                        dtype=torch.int32, device=cuda)
    starts = torch.tensor([[2] * 5, [60, 61, 62, 63, 64]], dtype=torch.int32, device=cuda)
    got = da.decode_attention_mq(q, k, v, starts, ends, scale=0.3)
    want = da.decode_attention_mq_plain(q, k, v, starts, ends, scale=0.3)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    k = torch.zeros((1, 2, 16, 96), device=cuda)
    q = torch.zeros((1, 4, 96), device=cuda)
    bnd = torch.tensor([[0, 16]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q, k, k, bnd)
    k = torch.zeros((1, 2, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        da.decode_attention(k[:, :, 0].repeat(1, 2, 1), k, k, bnd)
    k = torch.zeros((1, 2, 16, 64), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention(k[:, :, 0], k, k, bnd.long())
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(k[:, :, 0], k.transpose(2, 3).contiguous().transpose(2, 3), k, bnd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_paged_kernels_match_plain_versions(cuda, dtype):
    """Scattered pages, -1 padding, a trash (0) entry inside a window, a
    NaN-poisoned trash page, an empty row; one launch counted per call."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, 12, 2, 16, 128)  # [L, n_pages, Hkv, page, D], layer 1 used
    k = torch.randn(shape, generator=gen, device=cuda).to(dtype)[1]
    v = torch.randn(shape, generator=gen, device=cuda).to(dtype)[1]
    k[0] = float("nan")
    v[0] = float("nan")
    table = torch.tensor(
        [[3, 0, 5, -1], [7, 2, 9, 11], [4, -1, -1, -1]], dtype=torch.int32, device=cuda
    )
    q = torch.randn((3, 5, 8, 128), generator=gen, device=cuda).to(dtype)
    bnd = torch.tensor([[1, 40], [0, 64], [9, 9]], dtype=torch.int32, device=cuda)
    pa.reset_launches()
    got = pa.paged_decode_attention(q[:, 0], k, v, table, bnd, attn_softcap=30.0)
    want = pa.paged_decode_attention_plain(q[:, 0], k, v, table, bnd, attn_softcap=30.0)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[2] == 0).all()
    ends = torch.tensor(
        [[36 + j for j in range(5)], [59 + j for j in range(5)], [9] * 5],
        dtype=torch.int32, device=cuda,
    )
    starts = torch.tensor([[0], [5], [9]], dtype=torch.int32, device=cuda)
    got = pa.paged_decode_attention_mq(q, k, v, table, starts, ends)
    want = pa.paged_decode_attention_mq_plain(q, k, v, table, starts, ends)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[2] == 0).all()
    assert pa.launches == {
        "paged_decode_attention": 1, "paged_decode_attention_mq": 1,
        "paged_decode_attention_int8kv": 0, "paged_decode_attention_mq_int8kv": 0,
    }


def _int8(x):
    """Symmetric per-(slot, head) int8 of ``x`` [..., D]: (int8, f32 [..., 1])."""
    s = x.float().abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8), s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_int8kv_kernels_match_plain_versions(cuda, dtype):
    """The int8-KV variants of B1-B4: strided layer slices of int8 caches
    and pools with their f32 scales, softcap, an empty window, a trash page
    whose values and scale page are poisoned; each call counts under its
    own ``_int8kv`` name and never under the float kernel's."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(3)
    kf, vf = _cache(gen, cuda, torch.float32, 3, 2, 300, 128)
    (k8, ks), (v8, vs) = _int8(kf), _int8(vf)
    q = torch.randn((3, 9, 8, 128), generator=gen, device=cuda).to(dtype)
    sc = dict(k_scale=ks, v_scale=vs)
    da.reset_launches()
    pa.reset_launches()
    bnd = torch.tensor([[0, 300], [17, 90], [40, 40]], dtype=torch.int32, device=cuda)
    got = da.decode_attention(q[:, 0], k8, v8, bnd, attn_softcap=50.0, **sc)
    want = da.decode_attention_plain(q[:, 0], k8, v8, bnd, attn_softcap=50.0, **sc)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[2] == 0).all()
    ends = torch.tensor([[280 + j for j in range(1, 10)]] * 3, dtype=torch.int32, device=cuda)
    starts = torch.tensor([[0], [5], [300]], dtype=torch.int32, device=cuda)
    got = da.decode_attention_mq(q, k8, v8, starts, ends, **sc)
    want = da.decode_attention_mq_plain(q, k8, v8, starts, ends, **sc)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[2] == 0).all()

    shape = (2, 12, 2, 16, 128)  # [L, n_pages, Hkv, page, D], layer 1 used
    (kp, ksp), (vp, vsp) = (_int8(torch.randn(shape, generator=gen, device=cuda)) for _ in "kv")
    kp, ksp, vp, vsp = kp[1], ksp[1], vp[1], vsp[1]
    kp[0] = vp[0] = -128
    ksp[0] = vsp[0] = float("nan")
    table = torch.tensor(
        [[3, 0, 5, -1], [7, 2, 9, 11], [4, -1, -1, -1]], dtype=torch.int32, device=cuda
    )
    sc = dict(k_scale=ksp, v_scale=vsp)
    bnd = torch.tensor([[1, 40], [0, 64], [9, 9]], dtype=torch.int32, device=cuda)
    got = pa.paged_decode_attention(q[:, 0], kp, vp, table, bnd, attn_softcap=30.0, **sc)
    want = pa.paged_decode_attention_plain(q[:, 0], kp, vp, table, bnd, attn_softcap=30.0, **sc)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    ends = torch.tensor(
        [[36 + j for j in range(9)], [55 + j for j in range(9)], [9] * 9],
        dtype=torch.int32, device=cuda,
    )
    starts = torch.tensor([[0], [5], [9]], dtype=torch.int32, device=cuda)
    got = pa.paged_decode_attention_mq(q, kp, vp, table, starts, ends, **sc)
    want = pa.paged_decode_attention_mq_plain(q, kp, vp, table, starts, ends, **sc)
    assert torch.isfinite(got).all() and (got[2] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert da.launches == {
        "decode_attention": 0, "decode_attention_mq": 0,
        "decode_attention_int8kv": 1, "decode_attention_mq_int8kv": 1,
    }
    assert pa.launches == {
        "paged_decode_attention": 0, "paged_decode_attention_mq": 0,
        "paged_decode_attention_int8kv": 1, "paged_decode_attention_mq_int8kv": 1,
    }


def _kv_pair(kf, vf, dtype, kv):
    """K/V in ``dtype`` (a float cache) or int8 with f32 scales."""
    if kv == "int8":
        (k, ks), (v, vs) = _int8(kf), _int8(vf)
        return k, v, dict(k_scale=ks, v_scale=vs)
    return kf.to(dtype), vf.to(dtype), {}


def _assert_verify_close(got, want, tol, empty_row=None):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if empty_row is not None:
        assert (got[empty_row] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_verify_kernels_edge_cases(cuda, dtype, kv, D):
    """The split-KV verify kernels (B2, B4) against their plain versions:
    a ragged tail past T, a one-tile union shorter than n_split, an empty
    row, [B, 1] starts, softcap, 64 query rows per KV head, unaligned
    strides; pages of 16 and 64 slots with a trash entry, -1 padding and
    a NaN-poisoned trash page; B4 over one position against B3."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(D)
    da.reset_launches()
    pa.reset_launches()
    kf, vf = _cache(gen, cuda, torch.float32, 3, 2, 300, D)
    k, v, sc = _kv_pair(kf, vf, dtype, kv)
    q = torch.randn((3, 16, 8, D), generator=gen, device=cuda).to(dtype)
    ends = torch.tensor([[291 + j for j in range(9)], [71 + j for j in range(9)], [300] * 9],
                        dtype=torch.int32, device=cuda)
    starts = torch.tensor([[0] * 9, [70] * 9, [300] * 9], dtype=torch.int32, device=cuda)
    for cap in (0.0, 50.0):
        got = da.decode_attention_mq(q[:, :9], k, v, starts, ends, attn_softcap=cap, **sc)
        want = da.decode_attention_mq_plain(q[:, :9], k, v, starts, ends, attn_softcap=cap, **sc)
        _assert_verify_close(got, want, tol, empty_row=2)
    b1 = starts[:, :1].clone()
    b1[2] = 0  # row 2 no longer empty
    got = da.decode_attention_mq(q[:, :9], k, v, b1, ends, **sc)
    _assert_verify_close(got, da.decode_attention_mq_plain(q[:, :9], k, v, b1, ends, **sc), tol)
    # 16 positions: 64 query rows per KV head (the most bf16 takes at D=256).
    e16 = torch.tensor([[280 + j for j in range(16)]] * 3, dtype=torch.int32, device=cuda)
    s16 = torch.tensor([[5], [100], [250]], dtype=torch.int32, device=cuda)
    got = da.decode_attention_mq(q, k, v, s16, e16, **sc)
    _assert_verify_close(got, da.decode_attention_mq_plain(q, k, v, s16, e16, **sc), tol)
    # Rows whose stride is no multiple of 16 bytes: staged element by element.
    if kv == "float":
        buf = torch.randn((3, 2, 300, D + 1), generator=gen, device=cuda).to(dtype)
        ku, vu = buf[..., :D], buf[..., 1:]
        got = da.decode_attention_mq(q[:, :9], ku, vu, starts, ends)
        _assert_verify_close(got, da.decode_attention_mq_plain(q[:, :9], ku, vu, starts, ends),
                             tol, empty_row=2)

    for page in (16, 64):
        P, n_pages = 8, 24
        shape = (2, n_pages, 2, page, D)  # [L, n_pages, Hkv, page, D], layer 1 used
        kf = torch.randn(shape, generator=gen, device=cuda)[1]
        vf = torch.randn(shape, generator=gen, device=cuda)[1]
        kp, vp, psc = _kv_pair(kf, vf, dtype, kv)
        table = torch.tensor([[3, 0, 5, 6, 7, 8, 9, 10], [11, 12, 13, -1, -1, -1, -1, -1],
                              [14, -1, -1, -1, -1, -1, -1, -1]], dtype=torch.int32, device=cuda)
        unused = [0] + [p for p in range(n_pages) if p not in set(table.flatten().tolist())]
        if kv == "int8":
            kp[unused] = vp[unused] = -128
            psc["k_scale"][unused] = psc["v_scale"][unused] = float("nan")
        else:
            kp[unused] = vp[unused] = float("nan")
        last = P * page - 9
        ends = torch.tensor([[last + j for j in range(1, 10)], [2 * page + j for j in range(9)],
                             [page // 2] * 9], dtype=torch.int32, device=cuda)
        starts = torch.tensor([[1], [page + 3], [page // 2]], dtype=torch.int32, device=cuda)
        for cap in (0.0, 30.0):
            got = pa.paged_decode_attention_mq(q[:, :9], kp, vp, table, starts, ends,
                                               attn_softcap=cap, **psc)
            want = pa.paged_decode_attention_mq_plain(q[:, :9], kp, vp, table, starts, ends,
                                                      attn_softcap=cap, **psc)
            _assert_verify_close(got, want, tol, empty_row=2)
        bnd = torch.tensor([[1, last], [page + 3, 2 * page], [0, 5]], dtype=torch.int32,
                           device=cuda)
        one = pa.paged_decode_attention_mq(q[:, :1], kp, vp, table, bnd[:, :1], bnd[:, 1:],
                                           **psc)[:, 0]
        b3 = pa.paged_decode_attention(q[:, 0], kp, vp, table, bnd, **psc)
        _assert_verify_close(one, b3, tol)
        want = pa.paged_decode_attention_plain(q[:, 0], kp, vp, table, bnd, **psc)
        _assert_verify_close(one, want, tol)
    suffix = "_int8kv" if kv == "int8" else ""
    assert da.launches["decode_attention_mq" + suffix] == (5 if kv == "float" else 4)
    assert pa.launches["paged_decode_attention_mq" + suffix] == 6
    assert pa.launches["paged_decode_attention" + suffix] == 2


def _assert_qmm_close(got, want):
    rtol = 1e-2 if got.dtype == torch.bfloat16 else 0.0
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= rtol * w.abs() + 2e-5 * w.abs().max()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_matmul_matches_plain_versions(cuda, fmt, dtype, monkeypatch):
    """One row, odd K (int4's zero pad row), N no tile multiple, the
    one-block decode tiles (M <= 80) and the 128-row tiles with a ragged
    edge, a 3-D x, an f32 output; one launch counted per call."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(3)
    qz = quant.quantize_int8 if fmt == "int8" else quant.quantize_int4
    key = "q" if fmt == "int8" else "q4"
    fn = qm.matmul_int8 if fmt == "int8" else qm.matmul_int4
    plain = qm.matmul_int8_plain if fmt == "int8" else qm.matmul_int4_plain
    cases = [((1, 64), 48), ((5, 255), 40), ((72, 512), 1000), ((130, 300), 96),
             ((2, 3, 256), 64)]
    qm.reset_launches()
    for xshape, N in cases:
        K = xshape[-1]
        leaf = qz(torch.randn((K, N), generator=gen, device=cuda).to(dtype))
        x = torch.randn(xshape, generator=gen, device=cuda).to(dtype)
        for out_dtype in (None, torch.float32):
            got = fn(x, leaf[key], leaf["scale"], out_dtype=out_dtype)
            want = plain(x, leaf[key], leaf["scale"], out_dtype=out_dtype)
            assert got.shape == (*xshape[:-1], N) and got.dtype == want.dtype
            _assert_qmm_close(got, want)
    assert qm.launches[f"matmul_{fmt}"] == 2 * len(cases)


@pytest.mark.gpu
def test_cuda_quant_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    leaf = quant.quantize_int8(torch.randn((64, 32), device=cuda))
    x = torch.randn((4, 64), device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        qm.matmul_int8(x, leaf["q"].cpu(), leaf["scale"])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qm.matmul_int8(x.half(), leaf["q"], leaf["scale"])
    with pytest.raises(TypeError, match="int8"):
        qm.matmul_int8(x, leaf["q"].to(torch.int16), leaf["scale"])
    with pytest.raises(TypeError, match="scale must be float32"):
        qm.matmul_int8(x, leaf["q"], leaf["scale"].double())
    with pytest.raises(ValueError, match="contraction width"):
        qm.matmul_int8(x[:, :63], leaf["q"], leaf["scale"])
    with pytest.raises(ValueError, match="contiguous"):
        qm.matmul_int8(x, leaf["q"].t().contiguous().t(), leaf["scale"])
    with pytest.raises(TypeError, match="output"):
        qm.matmul_int8(x, leaf["q"], leaf["scale"], out_dtype=torch.bfloat16)
    q4 = quant.quantize_int4(torch.randn((65, 32), device=cuda))
    with pytest.raises(ValueError, match="contraction width"):
        qm.matmul_int4(x, q4["q4"], q4["scale"])  # 33 packed rows; K=64 needs 32
