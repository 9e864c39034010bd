"""Weight-only quantization: int8 and packed int4.

Counterpart of ``adversarial_spec_tpu/ops/quant.py``. Decode re-reads every
matmul weight per generated token, so storing the weights int8
(per-output-channel symmetric scales) halves the bytes it reads against
bf16, and int4 (two weights a byte, packed along the contraction axis)
halves them again — the format that keeps a multi-model opponent pool
resident on one card.

Representation (the reference's): a quantized matmul weight is a dict
leaf — int8 ``{"q": int8 [in, out], "scale": f32 [1, out]}``, int4
``{"q4": int8 [ceil(in/2), out], "scale": f32 [1, out]}``; each ``q4``
byte packs row ``2k`` in its low nibble and ``2k+1`` in its high nibble,
and an odd contraction width pads one zero row. Quantization is
bit-identical to the reference's on the same f32 or bf16 weights: the
same f32 divisions, and ``torch.round`` rounds half to even as
``jnp.round`` does.

Only matmul weights quantize (wq/wk/wv/wo/w_gate/w_up/w_down, lm_head and
the tied head's transposed copy lm_head_t); embeddings and norms stay in
the model dtype. ``matmul`` is the one seam the transformer's projections
and head go through: a quantized leaf takes the B5/B6 wrappers of
``ops/quant_matmul.py`` (the CUDA kernel on the card, its plain version on
the CPU), a plain tensor a plain ``torch`` product.
"""

from __future__ import annotations

import torch

from adversarial_spec_tpu_torch.ops import quant_matmul

QUANTIZABLE = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head", "lm_head_t"}
)


def _absmax_scale(w: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(w in f32, its per-column scale ``max(amax, 1e-8) / qmax``) over the
    contraction (-2) axis; the f32 copy is the caller's to reuse in place."""
    wf = w.to(torch.float32, copy=True)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    return wf, torch.clamp(amax, min=1e-8) / qmax


def quantize_int8(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over the contraction (-2) axis."""
    wf, scale = _absmax_scale(w, 127.0)
    q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two per byte along the contraction (-2)
    axis: row ``2k`` in the low nibble, ``2k+1`` in the high. An odd row
    count pads one zero row (``unpack_int4`` slices it back off against
    the caller's true width)."""
    if q.shape[-2] % 2:
        q = torch.cat([q, torch.zeros_like(q[..., :1, :])], dim=-2)
    lo = q[..., 0::2, :]
    hi = q[..., 1::2, :]
    # Two's-complement nibbles: lo keeps its low four bits, hi shifts into
    # the high four (int8 shifts wrap, as jnp.left_shift(...).astype(int8)).
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: the int8 values back out of the
    nibbles (``rows`` = the true contraction width; a padded zero row is
    sliced off). Pure shifts on int8: the low nibble sign-extends by a
    shift up and an arithmetic shift back, the high one by the arithmetic
    shift alone."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    q = torch.stack([lo, hi], dim=-2)  # [..., R/2, 2, out]
    q = q.reshape(*q.shape[:-3], q.shape[-3] * 2, q.shape[-1])
    return q[..., :rows, :]


def quantize_int4(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel packed int4 over the contraction (-2)
    axis (range [-7, 7]: symmetric, so dequant is one multiply)."""
    wf, scale = _absmax_scale(w, 7.0)
    q = wf.div_(scale).round_().clamp_(-7, 7).to(torch.int8)
    return {"q4": pack_int4(q), "scale": scale}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def is_quantized_int4(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q4", "scale"}


def dequantize(leaf, dtype=torch.float32, rows: int | None = None) -> torch.Tensor:
    """A quantized dict leaf back as a dense tensor (tests and oracles;
    the serving path never calls this — its dequant happens inside the
    B5/B6 kernels). ``rows`` is the true contraction width of an int4
    leaf (an odd width padded one zero row at pack time); without it an
    odd-width leaf dequantizes to the padded shape."""
    if is_quantized(leaf):
        return leaf["q"].to(dtype) * leaf["scale"].to(dtype)
    if is_quantized_int4(leaf):
        if rows is None:
            rows = leaf["q4"].shape[-2] * 2
        return unpack_int4(leaf["q4"], rows).to(dtype) * leaf["scale"].to(dtype)
    return leaf.to(dtype)


def matmul(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` for plain, int8- or int4-quantized weights.

    A quantized leaf goes to B5 or B6 (``ops/quant_matmul.py``): the CUDA
    kernel for a CUDA tensor, its plain version for a CPU one. A plain
    weight stays a plain product, as the reference leaves it to XLA; with
    ``out_dtype=float32`` (the head's logits) a half-precision product on
    the card keeps its f32 accumulator instead of rounding to bf16.
    """
    if is_quantized(w):
        return quant_matmul.matmul_int8(x, w["q"], w["scale"], out_dtype)
    if is_quantized_int4(w):
        return quant_matmul.matmul_int4(x, w["q4"], w["scale"], out_dtype)
    if out_dtype is None:
        return x @ w
    if out_dtype != torch.float32:
        raise TypeError(f"plain matmul output {out_dtype}: float32 or None")
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


def quantize_params(params: dict, fmt: str = "int8") -> dict:
    """Quantize the matmul weights of the port's params IN PLACE (and
    return them).

    ``fmt`` is ``"int8"`` or ``"int4"``. ``params["layers"]`` is a list of
    per-layer dicts; each ``QUANTIZABLE`` leaf is replaced as the walk reaches it, so
    a layer's full-precision weight is freed before the next is quantized
    and the peak stays near the full-precision model plus one weight's f32
    copy (the reference builds a new pytree instead).
    """
    if fmt not in ("int8", "int4"):
        raise ValueError(
            f"unknown weight quantization format {fmt!r}; known: int8, int4"
        )
    one = quantize_int8 if fmt == "int8" else quantize_int4

    def walk(node) -> None:
        keys = list(node) if isinstance(node, dict) else range(len(node))
        for k in keys:
            v = node[k]
            if k in QUANTIZABLE and isinstance(v, torch.Tensor):
                del v
                node[k] = one(node[k])
            elif isinstance(v, list) or (
                isinstance(v, dict) and not (is_quantized(v) or is_quantized_int4(v))
            ):
                walk(v)

    walk(params)
    return params
