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
from adversarial_spec_tpu_torch.ops import split_kv
from adversarial_spec_tpu_torch.ops.kv_inputs import int8_kv, kv_pair, poisoned_pages

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
    (k8, ks), (v8, vs) = int8_kv(kf), int8_kv(vf)
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
    (kp, ksp), (vp, vsp) = (int8_kv(torch.randn(shape, generator=gen, device=cuda)) for _ in "kv")
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
    k, v, sc = kv_pair(kf, vf, dtype, kv)
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
        kp, vp, psc = kv_pair(kf, vf, dtype, kv)
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


def _qmm_case(gen, dev, fmt, dtype, M, K, N, x_stride=None):
    """A quantized weight [K, N] and x [M, K] (rows ``x_stride`` apart)."""
    qz = quant.quantize_int8 if fmt == "int8" else quant.quantize_int4
    leaf = qz(torch.randn((K, N), generator=gen, device=dev).to(dtype))
    x = torch.randn((M, x_stride or K), generator=gen, device=dev).to(dtype)[:, :K]
    w = leaf["q" if fmt == "int8" else "q4"]
    fn = qm.matmul_int8 if fmt == "int8" else qm.matmul_int4
    plain = qm.matmul_int8_plain if fmt == "int8" else qm.matmul_int4_plain
    return x, w, leaf["scale"], fn, plain


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_matmul_every_split_count(cuda, fmt, monkeypatch):
    """The decode weight stream at every column width (32, 64, 128) and K
    split (1-8 blocks in a cluster) the plan can give, against the plain
    version: odd K (int4's zero row in the last split), N no width
    multiple, 36 rows; and the plan's own choice at Llama-3-8B's wk/wv."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(17)
    for M, K, N in ((36, 1999, 200), (4, 4096, 1024)):
        x, w, sc, fn, plain = _qmm_case(gen, cuda, fmt, torch.bfloat16, M, K, N)
        want = plain(x, w, sc, out_dtype=torch.float32)
        for bn in qm.DECODE_WIDTHS:
            for ks in range(1, qm.MAX_CLUSTER + 1):
                monkeypatch.setattr(qm, "planned", lambda *a, bn=bn, ks=ks: (bn, ks))
                _assert_qmm_close(fn(x, w, sc, out_dtype=torch.float32), want)
        monkeypatch.undo()
        _assert_qmm_close(fn(x, w, sc, out_dtype=torch.float32), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_matmul_rows_around_the_path_threshold(cuda, fmt, dtype, monkeypatch):
    """M from 1 to 1024 across the decode stream (8-row tiles, 128 rows a
    block) and the prefill tile (above 128 rows): K no stage multiple, N
    three 128-column tiles and a ragged fourth."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for M in (1, 2, 4, 7, 8, 9, 16, 17, 36, 63, 64, 65, 72, 80, 81, 127, 128, 129, 200,
              255, 256, 300, 512, 1024):
        x, w, sc, fn, plain = _qmm_case(gen, cuda, fmt, dtype, M, 320, 400)
        for out_dtype in (None, torch.float32):
            got = fn(x, w, sc, out_dtype=out_dtype)
            want = plain(x, w, sc, out_dtype=out_dtype)
            assert got.shape == want.shape and got.dtype == want.dtype
            _assert_qmm_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_matmul_odd_shapes_and_strides(cuda, fmt, dtype, monkeypatch):
    """Odd K at decode and prefill rows, an x row stride no multiple of 8
    (scalar loads, also above 128 rows), N no multiple of 16 (scalar
    weight loads) and N a multiple of 16 but not of the 128-column tile."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(11)
    for M, K, N, *stride in ((5, 255, 40), (200, 255, 144), (36, 4096, 1024, 4099),
                             (300, 512, 256, 515), (72, 130, 136), (300, 130, 136),
                             (257, 1024, 144)):
        x, w, sc, fn, plain = _qmm_case(gen, cuda, fmt, dtype, M, K, N, *stride)
        _assert_qmm_close(fn(x, w, sc), plain(x, w, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_matmul_is_deterministic_and_graph_capturable(cuda, fmt):
    """Two calls on the same inputs are bit-identical (a fixed summation
    order, no atomics), decode rows with a K split and prefill rows alike;
    a call captured in a CUDA graph and replayed gives the eager result."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    for M in (4, 72, 300):
        x, w, sc, fn, _ = _qmm_case(gen, cuda, fmt, torch.bfloat16, M, 4096, 1024)
        first = fn(x, w, sc)
        assert torch.equal(first, fn(x, w, sc))
        static = fn(x, w, sc)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn(x, w, sc)
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, first)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_s1_kernels_edge_cases(cuda, dtype, kv, D):
    """The split-KV S=1 kernels (B1, B3) against their plain versions: a
    ragged tail past T, left pads, a single slot (exactly v), an empty
    window (exact zeros), softcap, groups of 4, 1 and 7 query heads per KV
    head, unaligned strides; pages of 1, 8, 24 and 64 slots with a trash
    entry, -1 padding and a NaN-poisoned trash page; B4 at S=1 against
    B3."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(D + 1)
    da.reset_launches()
    pa.reset_launches()
    kf, vf = _cache(gen, cuda, torch.float32, 4, 2, 300, D)
    k, v, sc = kv_pair(kf, vf, dtype, kv)
    bnd = torch.tensor([[0, 300], [37, 250], [100, 101], [80, 80]], dtype=torch.int32,
                       device=cuda)
    for Hq in (8, 2, 14):
        q = torch.randn((4, Hq, D), generator=gen, device=cuda).to(dtype)
        for cap in (0.0, 50.0):
            got = da.decode_attention(q, k, v, bnd, attn_softcap=cap, **sc)
            want = da.decode_attention_plain(q, k, v, bnd, attn_softcap=cap, **sc)
            _assert_verify_close(got, want, tol, empty_row=3)
        one = v[2, :, 100].float()
        if kv == "int8":
            one = one * sc["v_scale"][2, :, 100]
        assert torch.equal(got[2], one.to(dtype).repeat_interleave(Hq // 2, 0))
    if kv == "float":  # rows (D + 1) elements apart: staged element by element
        buf = torch.randn((4, 2, 300, D + 1), generator=gen, device=cuda).to(dtype)
        ku, vu = buf[..., :D], buf[..., 1:]
        _assert_verify_close(da.decode_attention(q, ku, vu, bnd),
                             da.decode_attention_plain(q, ku, vu, bnd), tol, empty_row=3)
    q = q[:3, :8]
    for page in (1, 8, 24, 64):
        kp, vp, psc, table, pb = poisoned_pages(gen, cuda, page, D, dtype, kv)
        for cap in (0.0, 30.0):
            got = pa.paged_decode_attention(q, kp, vp, table, pb, attn_softcap=cap, **psc)
            want = pa.paged_decode_attention_plain(q, kp, vp, table, pb, attn_softcap=cap, **psc)
            _assert_verify_close(got, want, tol, empty_row=2)
        one = pa.paged_decode_attention_mq(q[:, None], kp, vp, table, pb[:, :1], pb[:, 1:],
                                           **psc)[:, 0]
        _assert_verify_close(one, pa.paged_decode_attention(q, kp, vp, table, pb, **psc), tol,
                             empty_row=2)
    suffix = "_int8kv" if kv == "int8" else ""
    assert da.launches["decode_attention" + suffix] == (7 if kv == "float" else 6)
    assert pa.launches["paged_decode_attention" + suffix] == 12
    assert da.launches["decode_attention" + ("" if suffix else "_int8kv")] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_s1_kernels_every_split_count(cuda, dtype, kv, monkeypatch):
    """B1 and B3 with n_split forced from 1 to past the tile count: runs
    shorter than a tile, empty runs and the combine agree with the plain
    version."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(11)
    kf, vf = _cache(gen, cuda, torch.float32, 4, 2, 300, 128)
    k, v, sc = kv_pair(kf, vf, dtype, kv)
    q = torch.randn((4, 8, 128), generator=gen, device=cuda).to(dtype)
    bnd = torch.tensor([[0, 300], [37, 250], [100, 101], [80, 80]], dtype=torch.int32,
                       device=cuda)
    kp, vp, psc, table, pb = poisoned_pages(gen, cuda, 24, 128, dtype, kv)
    want = da.decode_attention_plain(q, k, v, bnd, **sc)
    want_p = pa.paged_decode_attention_plain(q[:3], kp, vp, table, pb, **psc)
    for n in (1, 2, 3, 5, 9, 17, 40):
        monkeypatch.setattr(split_kv, "plan_splits", lambda *a, n=n, **kw: n)
        _assert_verify_close(da.decode_attention(q, k, v, bnd, **sc), want, tol, empty_row=3)
        _assert_verify_close(pa.paged_decode_attention(q[:3], kp, vp, table, pb, **psc), want_p,
                             tol, empty_row=2)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_verify_kernels_odd_pages_and_long_spans(cuda, dtype, kv):
    """B4 on pages of 8 and 24 slots (staged into 16-slot multiples whose
    pad slots are zero-filled and masked), and B2/B4 over a span of S = 33
    positions at g = 4 (132 query rows per KV head: bf16 q takes two
    launches, runs of 32 and 1 positions; f32 q as many as the kernel's
    own row limit gives), against their plain versions. f32 q keeps its
    rows in shared memory: 132 rows beside 64-slot f32 pages are served
    with the page staged in smaller tiles; so is D = 256 with 128-slot
    pages (K + V of one page, 256 KB, exceed a block's shared memory), at
    S = 9 and over the 33-position span in runs."""
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gen = torch.Generator(device=cuda).manual_seed(24)
    da.reset_launches()
    pa.reset_launches()
    S = 9
    q = torch.randn((3, 33, 8, 128), generator=gen, device=cuda).to(dtype)
    for page in (8, 24):
        kp, vp, psc, table, pb = poisoned_pages(gen, cuda, page, 128, dtype, kv)
        ends = (pb[:, 1:] - S + 1 + torch.arange(S, device=cuda)).int()
        ends[2] = 0
        starts = pb[:, :1]
        for cap in (0.0, 30.0):
            got = pa.paged_decode_attention_mq(q[:, :S], kp, vp, table, starts, ends,
                                               attn_softcap=cap, **psc)
            want = pa.paged_decode_attention_mq_plain(q[:, :S], kp, vp, table, starts, ends,
                                                      attn_softcap=cap, **psc)
            _assert_verify_close(got, want, tol, empty_row=2)
    # The long span, dense and paged (page 64).
    kf, vf = _cache(gen, cuda, torch.float32, 3, 2, 300, 128)
    k, v, sc = kv_pair(kf, vf, dtype, kv)
    ends = torch.tensor([[250 + j for j in range(1, 34)], [100 + j for j in range(33)],
                         [60] * 33], dtype=torch.int32, device=cuda)
    starts = torch.tensor([[0], [40], [60]], dtype=torch.int32, device=cuda)
    got = da.decode_attention_mq(q, k, v, starts, ends, **sc)
    _assert_verify_close(got, da.decode_attention_mq_plain(q, k, v, starts, ends, **sc), tol,
                         empty_row=2)
    kp, vp, psc, table, _ = poisoned_pages(gen, cuda, 64, 128, dtype, kv)
    got = pa.paged_decode_attention_mq(q, kp, vp, table, starts, ends, **psc)
    want = pa.paged_decode_attention_mq_plain(q, kp, vp, table, starts, ends, **psc)
    _assert_verify_close(got, want, tol, empty_row=2)
    # D = 256 over 128-slot pages, at S = 9 and over the long span.
    q256 = torch.randn((3, 33, 8, 256), generator=gen, device=cuda).to(dtype)
    kp, vp, psc, table, _ = poisoned_pages(gen, cuda, 128, 256, dtype, kv)
    for S in (9, 33):
        got = pa.paged_decode_attention_mq(q256[:, :S], kp, vp, table, starts, ends[:, :S],
                                           **psc)
        want = pa.paged_decode_attention_mq_plain(q256[:, :S], kp, vp, table, starts,
                                                  ends[:, :S], **psc)
        _assert_verify_close(got, want, tol, empty_row=2)

    def runs(S, D, page):
        rows = None
        if dtype == torch.float32:
            rows = da.f32_max_rows(D, k.element_size(), page)
        return len(split_kv.span_runs(S, 4, D, dtype, rows))

    suffix = "_int8kv" if kv == "int8" else ""
    assert da.launches["decode_attention_mq" + suffix] == runs(33, 128, None)
    assert pa.launches["paged_decode_attention_mq" + suffix] == (
        4 + runs(33, 128, 64) + runs(9, 256, 128) + runs(33, 256, 128)
    )
