"""The roofline and FLOP functions against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline

CFG = {"hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
       "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 32768}


def test_bound_is_the_larger_of_bytes_and_ops():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_attention_launch_by_hand():
    # Two rows over 100 and 50 slots, 8 KV heads of 128, bf16, one query.
    b, ops = roofline.attn_launch(150, [100, 50], 1, 32, 8, 128)
    assert b == 150 * 8 * 128 * 2 * 2 + 2 * 1 * 32 * 128 * 2 * 2
    assert ops == 150 * 32 * 128 * 4


def test_matrix_params_of_mistral_7b():
    # 7,241,732,096 parameters published: layers' projections, norms,
    # the embedding and the head.
    layers = roofline.matrix_params(CFG) * 32 + 2 * 4096 * 32
    assert layers + 2 * 32768 * 4096 + 4096 == 7_248_023_552


def test_flops_by_hand():
    per_layer = roofline.matrix_params(CFG)
    one = roofline.token_flops(CFG, 10, head=False)
    assert one == 2 * per_layer * 32 + 4 * 32 * 32 * 128 * 10
    assert roofline.token_flops(CFG, 10, head=True) - one == 2 * 4096 * 32768
    # A prefill of 3 tokens: contexts 1, 2, 3 and the head once.
    assert roofline.prompt_flops(CFG, 3) == pytest.approx(
        sum(roofline.token_flops(CFG, c, False) for c in (1, 2, 3)) + 2 * 4096 * 32768)
    # Positions 2.. of a 5-token prompt whose first two were cached.
    assert roofline.prompt_flops(CFG, 5, cached=2) == pytest.approx(
        sum(roofline.token_flops(CFG, c, False) for c in (3, 4, 5)) + 2 * 4096 * 32768)
    assert roofline.decode_flops(CFG, 100, 3) == pytest.approx(
        roofline.token_flops(CFG, 101, True) + roofline.token_flops(CFG, 102, True))


def test_dense_bound_counts_each_rows_window():
    rows = [{"input_tokens": 1000, "output_tokens": 4, "cached_tokens": 0}] * 2
    # Two single-token steps make tokens 2 and 3 over 1002 and 1003 slots.
    b = roofline.dense_attention_bound_s(CFG, rows, s1=2, s2=0, gamma=8)
    want = sum(roofline.bound_s(*roofline.attn_launch(2 * (1000 + j), [1000 + j] * 2, 1, 32, 8, 128))
               for j in (2, 3))
    assert b == pytest.approx(32 * want)


def test_paged_bound_reads_shared_pages_once():
    rows = [{"input_tokens": 640, "output_tokens": 3, "cached_tokens": c} for c in (64, 576, 576)]
    b = roofline.paged_attention_bound_s(CFG, rows, s3=2, s4=0, gamma=8)
    # Tokens 1 and 2 of each row; the prefix every row adopted (64) once
    # a step; each row's own slots beside it.
    kv = 2 * 64 + sum(640 - c + j for c in (64, 576, 576) for j in (1, 2))
    att = [640 + j for _ in range(3) for j in (1, 2)]
    assert b == pytest.approx(32 * roofline.bound_s(*roofline.attn_launch(kv, att, 1, 32, 8, 128)))


@pytest.mark.parametrize("name,kind", [
    ("void decode_attn_kernel<__nv_bfloat16, __nv_bfloat16, false, 128, 1>(Launch<1>)", "dense"),
    ("void decode_attn_kernel<__nv_bfloat16, __nv_bfloat16, true, 128, 1>(Launch<1>)", "paged"),
    ("void verify_tc_kernel<__nv_bfloat16, false, 128, 3>(Args)", "dense"),
    ("void verify_f32_kernel<float, true, 2>(Args)", "paged"),
    ("void combine_kernel(Partials)", "combine"),
    ("ampere_bf16_s16816gemm_bf16_128x64", None),
])
def test_kernel_names(name, kind):
    assert roofline.attention_kind(name) == kind
