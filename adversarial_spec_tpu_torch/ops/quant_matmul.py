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

``plan`` picks the kernel's column width and K split (the cluster of
blocks that share a column strip) from shapes, alignment and the card's
cluster occupancy, never from data, so a call can be captured in a CUDA
graph: a weight stream split along K for decode rows, 256-row tiles split
only while they leave SMs idle above ``DECODE_MAX_ROWS`` rows.
``k_runs`` and ``split_fold_plain`` mirror the split's arithmetic for the
tests (``tests/test_torch_quant_plan.py``).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable

import torch

from adversarial_spec_tpu_torch.ops import _build, split_kv

SOURCE = "quant_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper (the chip smoke zeroes and reads these to
# show the main path really went through the kernels). Plain runs on CPU
# tensors never count.
launches = {"matmul_int8": 0, "matmul_int4": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# The kernel (csrc/quant_matmul.cu qmm_stream_kernel): a warpgroup per 64
# weight columns, a block of DECODE_WIDTHS columns, at most DECODE_MAX_ROWS
# token rows a block; a stage holds STAGE_ROWS stored weight rows (int8: k
# rows; int4: packed rows of two k each), and a K split is a thread-block
# cluster of at most
# MAX_CLUSTER blocks (beyond the portable 8, which wk/wv's 16 strips of 64
# columns need to fill the card).
DECODE_WIDTHS = (128, 64)
DECODE_MAX_ROWS = 128
PREFILL_ROWS = 256  # token rows of a prefill block (above DECODE_MAX_ROWS)
STAGE_ROWS = 64
MAX_CLUSTER = 16
# Resident blocks the plan fills: two on each SM for decode rows (the
# kernel's ring takes at most ~110 KB of shared memory and its launch bound
# leaves registers for two), each keeping up to 7 stages of loads in
# flight; one for the 128- and 256-row tiles.
SLOTS = 2 * split_kv.SMS
# What TMA takes (``stream_ok`` in the source): at least one 64-k x box.
TMA_MIN_K = 64


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_advspec_bound", False):
        for fn in (lib.advspec_matmul_int8, lib.advspec_matmul_int4):
            fn.argtypes = [_P, _L, _P, _P, _P, _L] + [_I] * 7 + [_P]
            fn.restype = _I
        lib._advspec_bound = True
    return lib


# -- the plan -----------------------------------------------------------------


def stage_k(int4: bool) -> int:
    """K one stage of the kernel holds (its split unit)."""
    return 2 * STAGE_ROWS if int4 else STAGE_ROWS


def slot_clusters(bn: int, ks: int, M: int = 1) -> int:
    """Clusters of ``ks`` blocks that fit the resident blocks: ``SLOTS``
    up to 96 rows, one block an SM for the 128- and 256-row tiles."""
    return (SLOTS if M <= 96 else split_kv.SMS) // ks


def plan(
    M: int,
    N: int,
    K: int,
    int4: bool,
    tma_ok: bool,
    clusters: Callable[[int, int], int] | None = None,
) -> tuple[int, int]:
    """``(bn, ksplit)`` of a bf16 call: the kernel's columns per block and
    blocks per K split: the largest split (at most ``MAX_CLUSTER``, and
    one per K stage) whose clusters, one per column strip and block of
    rows, all run at once (``clusters(bn, ks)``: how many the card holds;
    on the card the runtime's occupancy calculator), at the widest ``bn``
    whose blocks then fill at least three quarters of the one-block
    clusters it holds; the narrowest where none does. Past one wave of
    strips the split is 1. Blocks hold 128 rows (``DECODE_MAX_ROWS``), or
    ``PREFILL_ROWS`` above that when TMA takes the operands (``tma_ok``),
    at 128 columns."""
    if clusters is None:
        clusters = functools.partial(slot_clusters, M=M)
    prefill = tma_ok and M > DECODE_MAX_ROWS
    n_kt = -(-K // stage_k(int4))
    chunks = -(-M // (PREFILL_ROWS if prefill else DECODE_MAX_ROWS))
    widths = DECODE_WIDTHS[:1] if prefill else DECODE_WIDTHS
    for bn in widths:
        strips = -(-N // bn) * chunks
        ks = next(
            (k for k in range(min(MAX_CLUSTER, n_kt), 1, -1) if strips <= clusters(bn, k)), 1
        )
        if 4 * strips * ks >= 3 * clusters(bn, 1) or bn == widths[-1]:
            return bn, ks
    raise AssertionError("unreachable")


@functools.lru_cache(maxsize=None)
def device_clusters(M: int, int4: bool, bn: int, ks: int) -> int:
    """How many clusters of ``ks`` blocks of the kernel at ``M`` rows and
    ``bn`` columns the card runs at once (``advspec_qmm_clusters``); the
    ``SLOTS`` estimate where the runtime cannot tell."""
    fn = _build.entry(SOURCE, "advspec_qmm_clusters", [_I] * 4)
    n = fn(M, bn, ks, int(int4))
    if n < 0:
        raise ValueError(f"no stream kernel for M={M}, bn={bn}, ksplit={ks}")
    return n or slot_clusters(bn, ks, M)


def k_runs(K: int, int4: bool, ksplit: int) -> list[tuple[int, int]]:
    """Each split's run ``[k0, k1)`` of K, as the kernel cuts it: the
    ``ceil(K / stage_k)`` stages into ``ksplit`` contiguous runs whose
    lengths differ by at most one stage, the last clipped to K."""
    bk = stage_k(int4)
    n_kt = -(-K // bk)
    return [
        (min(r * n_kt // ksplit * bk, K), min((r + 1) * n_kt // ksplit * bk, K))
        for r in range(ksplit)
    ]


def split_fold_plain(
    x: torch.Tensor, w: torch.Tensor, scale, out_dtype, runs
) -> torch.Tensor:
    """The decode kernel's arithmetic in plain PyTorch: each split's f32
    partial over its run of K (``w`` the unpacked integer weight), the
    partials summed in split order, then the scale once, one cast."""
    K, N = w.shape
    x2 = x.reshape(-1, K).to(torch.float32)
    acc = torch.zeros((x2.shape[0], N), dtype=torch.float32)
    for k0, k1 in runs:
        acc = acc + x2[:, k0:k1] @ w[k0:k1].to(torch.float32)
    out = acc * scale.reshape(1, N).to(torch.float32)
    return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


@functools.lru_cache(maxsize=None)
def planned(M: int, N: int, K: int, int4: bool, tma_ok: bool) -> tuple[int, int]:
    """The wrappers' plan of a CUDA call, once per shape: ``plan`` with the
    card's own cluster capacity where the TMA kernel runs."""
    held = functools.partial(device_clusters, M, int4) if tma_ok else None
    return plan(M, N, K, int4, tma_ok, held)


def _tma_ok(x2: torch.Tensor, w: torch.Tensor) -> bool:
    """What the kernel's TMA loads take (``stream_ok`` in the source):
    16-byte aligned bf16 x rows and weight rows, and at least one 64-k x
    box; other operands take the general kernel."""
    N, K = w.shape[1], x2.shape[1]
    return (
        x2.dtype == torch.bfloat16
        and x2.stride(0) % 8 == 0
        and x2.data_ptr() % 16 == 0
        and w.data_ptr() % 16 == 0
        and N % 16 == 0
        and K >= TMA_MIN_K
    )


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
    bn, ksplit = planned(M, N, K, name == "matmul_int4", _tma_ok(x2, w))
    rc = getattr(_lib(), f"advspec_{name}")(
        x2.data_ptr(), x2.stride(0),
        w.data_ptr(), scale.data_ptr(),
        out.data_ptr(), out.stride(0),
        M, N, K, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], bn, ksplit,
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
