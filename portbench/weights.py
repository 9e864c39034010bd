"""Random weights for one configuration, drawn on the device from the seed.

One ``normal_`` call fills one flat buffer in the served dtype; a few
in-place scalings, one per kind of leaf, give each kind its spread; the
leaves are views of the buffer in the port's parameter layout (matrices
``[in, out]``):

    {"embed": [V, D], "layers": [{"attn_norm", "wq", "wk", "wv", "wo",
     "ffn_norm", "w_gate", "w_up", "w_down"[, "bq", "bk", "bv"]}, ...],
     "final_norm": [D], "lm_head": [D, V] (untied heads)}

The blocks' matrices are normal draws with sparse outliers: an entry drawn beyond
``OUTLIER_AT`` standard deviations (about one in 2,100) is made
``OUTLIER_GAIN`` times larger, and the matrix is scaled to a variance of
1/fan_in. Trained weights carry such outliers (Dettmers et al.,
"LLM.int8()", 2022), and they set the per-channel scale of an int8 or
int4 weight: a plain Gaussian draw has none, and its int8 copy loses no
more than the program's bf16 activations do, so a lower precision could
not be told from the one the configuration states. The head is
N(0, 1/D) with no outliers: outlier columns there would give a few ids a
lead that no rounding could overturn, and greedy rows would settle on
them. Norm weights are
1 + N(0, 0.1^2) and biases N(0, 0.1^2), so a program that skipped a
norm's weight or a bias would compute something else. The embedding is N(0, 1): a token's own row then
stays as large in the residual stream as the blocks' outputs, and greedy
rows follow their context instead of settling on one token whose lead no
rounding could overturn (the check sees a lower precision only where the
served tokens depend on it). The port and the plain reference read the
same tensors.
"""

from __future__ import annotations

import math

import torch

EMBED_SPREAD = 1.0
NORM_SPREAD = 0.1
BIAS_SPREAD = 0.1
OUTLIER_AT = 3.5
OUTLIER_GAIN = 8.0
_CHUNK = 1 << 26  # elements a step of the outlier pass: its temporaries stay small


def _matrix_variance() -> float:
    """Variance of a standard normal draw after the outlier gain."""
    a = OUTLIER_AT
    tail = 2 * (a * math.exp(-a * a / 2) / math.sqrt(2 * math.pi) + math.erfc(a / math.sqrt(2)) / 2)
    return 1.0 + (OUTLIER_GAIN ** 2 - 1) * tail


def _add_outliers(seg: torch.Tensor) -> None:
    """Scale, in place, the entries of a standard normal draw beyond
    ``OUTLIER_AT`` by ``OUTLIER_GAIN``."""
    for part in seg.split(_CHUNK):
        part.mul_((part.abs() > OUTLIER_AT).to(part.dtype).mul_(OUTLIER_GAIN - 1).add_(1))


def dims(cfg: dict) -> dict:
    """The widths a configuration file states, under short names."""
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // heads
    return {
        "D": cfg["hidden_size"], "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
        "L": cfg["num_hidden_layers"], "H": heads, "Hkv": kv_heads, "hd": head_dim,
        "bias": bool(cfg.get("attention_bias", False)),
        "tied": bool(cfg.get("tie_word_embeddings", False)),
    }


def leaves(cfg: dict) -> list[tuple[tuple, tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; kind is ``embed``, ``w<fan_in>``
    (the blocks' matrices), ``head<fan_in>``, ``norm`` or ``bias``."""
    d = dims(cfg)
    D, F, V = d["D"], d["F"], d["V"]
    QD, KD = d["H"] * d["hd"], d["Hkv"] * d["hd"]
    out = [(("embed",), (V, D), "embed")]
    for i in range(d["L"]):
        lay = ("layers", i)
        out += [
            (lay + ("attn_norm",), (D,), "norm"),
            (lay + ("wq",), (D, QD), f"w{D}"),
            (lay + ("wk",), (D, KD), f"w{D}"),
            (lay + ("wv",), (D, KD), f"w{D}"),
            (lay + ("wo",), (QD, D), f"w{QD}"),
            (lay + ("ffn_norm",), (D,), "norm"),
            (lay + ("w_gate",), (D, F), f"w{D}"),
            (lay + ("w_up",), (D, F), f"w{D}"),
            (lay + ("w_down",), (F, D), f"w{F}"),
        ]
        if d["bias"]:
            out += [(lay + ("bq",), (QD,), "bias"), (lay + ("bk",), (KD,), "bias"),
                    (lay + ("bv",), (KD,), "bias")]
    out.append((("final_norm",), (D,), "norm"))
    if not d["tied"]:
        out.append((("lm_head",), (D, V), f"head{D}"))
    return out


def count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in leaves(cfg))


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The seed's weights for ``cfg`` on ``device``, in the port's layout."""
    items = leaves(cfg)
    kinds = sorted({k for _, _, k in items})
    flat = torch.empty(count(cfg), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat.normal_(generator=gen)
    params: dict = {"layers": [{} for _ in range(dims(cfg)["L"])]}
    start = 0
    for kind in kinds:  # leaves of one kind lie together: one scaling each
        group = [(p, s) for p, s, k in items if k == kind]
        n = sum(math.prod(s) for _, s in group)
        seg = flat[start:start + n]
        if kind == "embed":
            seg.mul_(EMBED_SPREAD)
        elif kind == "norm":
            seg.mul_(NORM_SPREAD).add_(1.0)
        elif kind == "bias":
            seg.mul_(BIAS_SPREAD)
        elif kind.startswith("head"):
            seg.mul_(1.0 / math.sqrt(int(kind[4:])))
        else:
            _add_outliers(seg)
            seg.mul_(1.0 / math.sqrt(int(kind[1:]) * _matrix_variance()))
        off = start
        for path, shape in group:
            view = flat[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
            if path[0] == "layers":
                params["layers"][path[1]][path[2]] = view
            else:
                params[path[0]] = view
        start += n
    return params
