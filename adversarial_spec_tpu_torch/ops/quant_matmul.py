"""Weight-only quantized matrix products: CUDA kernels + plain versions.

Counterpart of ``adversarial_spec_tpu/ops/pallas_quant.py``:

- ``matmul_int8`` (B5): ``x @ (q * scale)`` over an int8 weight
  ``q [K, N]``. Replaces the Pallas ``_qmm_int8_kernel``.
- ``matmul_int4`` (B6): the same over nibble-packed int4,
  ``q4 [ceil(K/2), N]`` (``ops/quant.py:pack_int4``). Replaces the Pallas
  ``_qmm_int4_kernel``.

Both compute what the Pallas kernels compute: an f32 accumulator over the
whole of K, the per-column f32 scale applied once to the accumulator, then
one cast to the output type (``out_dtype``, default x's; the head asks for
f32 logits). The reference's XLA fallback for a bf16 ``x``
(``adversarial_spec_tpu/ops/quant.py:matmul`` without ``use_pallas``)
rounds ``x @ q`` to bf16 before it multiplies by a bf16 scale: a second
rounding the TPU kernel does not make. The port follows the kernel, so in
bf16 it agrees with the reference's kernel path, not its fallback; the
tests compare the two packages in f32, where they agree.

Each wrapper launches the hand-written Hopper kernel
(``csrc/quant_matmul.cu``, built by ``ops/_build.py``) for CUDA tensors and
counts the launch in ``launches``; for CPU tensors it runs the plain
PyTorch version beside it (``*_plain``), which the tests and the chip
smoke also use as the reference. A CUDA tensor never takes the plain
version: the wrapper launches the kernel or raises. Every shape is the
kernel's (any M, N, K, odd K for int4), so there is no fallback for
unsupported shapes.
"""

from __future__ import annotations

import ctypes

import torch

from adversarial_spec_tpu_torch.ops import _build

SOURCE = "quant_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper (the chip smoke zeroes and reads these to
# show the main path really went through the kernels). Plain runs on CPU
# tensors never count.
launches = {"matmul_int8": 0, "matmul_int4": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_advspec_bound", False):
        for fn in (lib.advspec_matmul_int8, lib.advspec_matmul_int4):
            fn.argtypes = [_P, _L, _P, _P, _P, _L] + [_I] * 5 + [_P]
            fn.restype = _I
        lib._advspec_bound = True
    return lib


# -- plain PyTorch versions ---------------------------------------------------


def _plain(x: torch.Tensor, w: torch.Tensor, scale, out_dtype) -> torch.Tensor:
    """f32 accumulation of ``x @ w`` (``w`` the unpacked integer weight,
    exact in f32), the scale once on the accumulator, one cast."""
    K, N = w.shape
    acc = x.reshape(-1, K).to(torch.float32) @ w.to(torch.float32)
    out = acc * scale.reshape(1, N).to(torch.float32)
    return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def matmul_int8_plain(
    x: torch.Tensor,  # [..., K]
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [1, N] f32
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain B5. Returns [..., N] in ``out_dtype`` (default x's)."""
    return _plain(x, q, scale, out_dtype)


def matmul_int4_plain(
    x: torch.Tensor,  # [..., K] (K = the true contraction width)
    q4: torch.Tensor,  # [ceil(K/2), N] int8, nibble-packed
    scale: torch.Tensor,  # [1, N] f32
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain B6: the packed weight unpacked to [K, N] (an odd K drops the
    zero pad row), then plain B5's arithmetic."""
    from adversarial_spec_tpu_torch.ops.quant import unpack_int4

    return _plain(x, unpack_int4(q4, x.shape[-1]), scale, out_dtype)


# -- kernel wrappers ----------------------------------------------------------


def _launch(name: str, x, w, scale, out_dtype, w_rows: int) -> torch.Tensor:
    """Validate what the kernel takes, allocate the output, launch."""
    dev = x.device
    for t in (w, scale):
        if t.device != dev:
            raise ValueError(f"{name} operands on {t.device} and {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name}: output {out_dtype} for {x.dtype} x")
    if w.dtype != torch.int8:
        raise TypeError(f"{name} weight must be int8, got {w.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name} scale must be float32, got {scale.dtype}")
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != w_rows:
        raise ValueError(
            f"{name}: weight {tuple(w.shape)} for contraction width {K}"
        )
    N = w.shape[1]
    if scale.numel() != N or scale.shape[-1] != N:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for {N} columns")
    if not (w.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: weight and scale must be contiguous")
    x2 = x.reshape(-1, K)
    if K > 0 and x2.stride(-1) != 1:
        raise ValueError(f"{name}: x's last axis must be contiguous")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out.reshape(*x.shape[:-1], N)
    if K == 0:
        raise ValueError(f"{name}: empty contraction axis")
    rc = getattr(_lib(), f"advspec_{name}")(
        x2.data_ptr(), x2.stride(0),
        w.data_ptr(), scale.data_ptr(),
        out.data_ptr(), out.stride(0),
        M, N, K, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return out.reshape(*x.shape[:-1], N)


def matmul_int8(
    x: torch.Tensor,  # [..., K] f32 or bf16
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [1, N] f32
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """B5: ``x @ (q * scale)``, the weight streamed as int8 and widened
    in-kernel. Returns [..., N] in ``out_dtype`` (default x's)."""
    if not x.is_cuda:
        return matmul_int8_plain(x, q, scale, out_dtype)
    return _launch("matmul_int8", x, q, scale, out_dtype, x.shape[-1])


def matmul_int4(
    x: torch.Tensor,  # [..., K] f32 or bf16
    q4: torch.Tensor,  # [ceil(K/2), N] int8, nibble-packed
    scale: torch.Tensor,  # [1, N] f32
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """B6: ``x @ dequant(q4)``, the packed weight streamed as-is and
    unpacked in-kernel by shifts. Returns [..., N]."""
    if not x.is_cuda:
        return matmul_int4_plain(x, q4, scale, out_dtype)
    return _launch("matmul_int4", x, q4, scale, out_dtype, (x.shape[-1] + 1) // 2)
