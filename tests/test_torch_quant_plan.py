"""The B5/B6 kernels' plan on the CPU (``ops/quant_matmul.py``): the path,
column width and K split the wrappers hand to ``csrc/quant_matmul.cu``,
and a plain mirror of the decode kernel's split-K arithmetic against the
reference's Pallas kernels in interpret mode.

- ``plan`` takes whole-K 128-column tiles only above ``DECODE_MAX_ROWS``
  rows and only when TMA takes the operands; otherwise the decode stream's widest
  column width whose strips, with the largest split of at most
  ``MAX_CLUSTER`` blocks that stays within one wave of ``SLOTS`` resident
  blocks, fill at least three quarters of it, at each of Llama-3-8B's five
  weight shapes and the path's decode rows (4, 36, 72).
- ``k_runs``: the splits' runs of K cover it exactly once, in order, on
  stage boundaries; an int4 split starts on an even K row (no nibble pair
  is cut) and an odd K ends in the last split.
- ``split_fold_plain``: partials summed in split order, then the scale,
  then the cast, matches ``pallas_quant.matmul_int8`` / ``matmul_int4`` in
  interpret mode within 1e-5 / 2e-4 x max|ref| (f32; the tolerances of
  ``test_torch_quant.py::test_plain_versions_match_pallas_interpret``),
  at every split count.

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.ops import pallas_quant as jax_pq
from adversarial_spec_tpu.ops import quant as jax_quant
from adversarial_spec_tpu_torch.ops import quant
from adversarial_spec_tpu_torch.ops import quant_matmul as qm
from adversarial_spec_tpu_torch.ops import split_kv

# Llama-3-8B's matmul weights (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, head.
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [4, 36, 72])
@pytest.mark.parametrize("K,N", SHAPES_8B)
def test_plan_fills_the_card_at_the_8b_shapes(K, N, M, int4):
    bn, ks = qm.plan(M, N, K, int4, True)
    assert bn in qm.DECODE_WIDTHS and 1 <= ks <= qm.MAX_CLUSTER
    blocks = -(-N // bn) * -(-M // qm.DECODE_MAX_ROWS)
    # At least three quarters of the resident slots, within one wave unless
    # the strips alone exceed it (the head: 1002 strips, no split).
    assert 4 * blocks * ks >= 3 * qm.SLOTS
    assert blocks * ks <= qm.SLOTS or ks == 1
    # The largest split within the wave, at the widest width that fills.
    assert ks == qm.MAX_CLUSTER or blocks * (ks + 1) > qm.SLOTS
    for wider in qm.DECODE_WIDTHS[: qm.DECODE_WIDTHS.index(bn)]:
        strips = -(-N // wider)
        assert 4 * strips * max(1, min(qm.SLOTS // strips, qm.MAX_CLUSTER)) < 3 * qm.SLOTS


def test_plan_keeps_every_cluster_resident():
    """On a card whose GPCs hold fewer clusters of 8 than the 32 column
    strips of wq/wo (clusters must sit within one GPC), the plan takes the
    largest split whose clusters all run at once."""

    def held(bn, ks):
        return {8: 28, 7: 36}.get(ks, qm.SLOTS // ks)

    assert qm.plan(4, 4096, 4096, False, True, held) == (128, 7)
    assert qm.plan(4, 4096, 4096, False, True) == (128, 8)
    # More strips than any split keeps resident: no split (the head).
    assert qm.plan(4, 128256, 4096, True, True, held) == (128, 1)


@pytest.mark.parametrize("M", [129, 512, 1024, 4096])
def test_plan_of_prefill_rows(M):
    """Above DECODE_MAX_ROWS rows (operands TMA takes) the blocks hold 256
    rows and 128 columns, one an SM: a split only while the blocks
    (strips x 256-row chunks) leave SMs idle; without TMA, 128-row blocks
    of the general kernel."""
    bn, ks = qm.plan(M, 4096, 4096, False, True)
    blocks = -(-4096 // 128) * -(-M // qm.PREFILL_ROWS)
    assert bn == 128
    assert (ks == 1) == (blocks * 2 > split_kv.SMS)
    assert blocks * ks <= split_kv.SMS or ks == 1
    bn, ks = qm.plan(M, 4096, 4096, False, False)
    assert ks == 1 or -(-4096 // bn) * -(-M // qm.DECODE_MAX_ROWS) * ks <= split_kv.SMS


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("K", [1, 63, 64, 65, 127, 255, 1999, 4096, 14336])
def test_k_runs_cover_k_once_in_order_on_stage_boundaries(K, int4):
    bk = qm.stage_k(int4)
    for ks in range(1, qm.MAX_CLUSTER + 1):
        runs = qm.k_runs(K, int4, ks)
        assert len(runs) == ks
        covered = [k for k0, k1 in runs for k in range(k0, k1)]
        assert covered == list(range(K))
        for k0, k1 in runs:
            assert k0 <= k1
            assert k0 % bk == 0 or k0 == K
            assert k1 % bk == 0 or k1 == K
            if int4:
                assert k0 % 2 == 0 or k0 == K  # no nibble pair is cut
        if K % 2:
            assert runs[-1][1] == K and runs[-1][0] < K  # the odd row ends in the last split


def _ref_kernel(fmt: str, x: np.ndarray, w: np.ndarray):
    """The reference's Pallas kernel in interpret mode, and the same
    quantized leaf as torch tensors."""
    leaf = (jax_quant.quantize_int8 if fmt == "int8" else jax_quant.quantize_int4)(jnp.asarray(w))
    key = "q" if fmt == "int8" else "q4"
    fn = jax_pq.matmul_int8 if fmt == "int8" else jax_pq.matmul_int4
    ref = fn(jnp.asarray(x), leaf[key], leaf["scale"], interpret=True)
    return np.asarray(ref, np.float32), {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}


@pytest.mark.parametrize("fmt,rel", [("int8", 1e-5), ("int4", 2e-4)])
@pytest.mark.parametrize("K,xshape", [(300, (6, 300)), (517, (2, 3, 517))], ids=["even", "odd"])
def test_split_fold_matches_pallas_interpret_at_every_split(fmt, rel, K, xshape):
    rng = np.random.default_rng(K)
    w = rng.standard_normal((K, 40)).astype(np.float32)
    x = rng.standard_normal(xshape).astype(np.float32)
    ref, leaf = _ref_kernel(fmt, x, w)
    int4 = fmt == "int4"
    wq = quant.unpack_int4(leaf["q4"], K) if int4 else leaf["q"]
    xt = torch.from_numpy(x)
    unsplit = qm.split_fold_plain(xt, wq, leaf["scale"], None, [(0, K)])
    want = (qm.matmul_int4_plain(xt, leaf["q4"], leaf["scale"]) if int4
            else qm.matmul_int8_plain(xt, leaf["q"], leaf["scale"]))
    assert torch.equal(unsplit, want)  # one split is the plain version itself
    for ks in range(1, qm.MAX_CLUSTER + 1):
        got = qm.split_fold_plain(xt, wq, leaf["scale"], None, qm.k_runs(K, int4, ks))
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert np.max(np.abs(got.numpy() - ref)) <= rel * np.max(np.abs(ref)), ks
    # A bf16 output: the scale on the f32 sum, then one cast.
    got = qm.split_fold_plain(xt, wq, leaf["scale"], torch.bfloat16, qm.k_runs(K, int4, 3))
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.float().numpy() - ref)) <= 1e-2 * np.max(np.abs(ref))
