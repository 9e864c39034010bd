"""The port's CUDA decode-attention kernels (dense B1/B2, paged B3/B4)
against their plain versions.

These need a CUDA card (a CUDA kernel has no CPU mode): each test is
marked ``gpu`` and skips without one. The file imports no jax, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerances: f32 at atol/rtol 2e-5 (summation order only); bf16 at
rtol 1.6e-2 (one bf16 rounding of the output, the plain version
accumulating in f32 like the kernel).
"""

import pytest
import torch

from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa

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
    assert da.launches == {"decode_attention": 1, "decode_attention_mq": 1}


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
    assert pa.launches == {"paged_decode_attention": 1, "paged_decode_attention_mq": 1}
