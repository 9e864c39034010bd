"""The plain reference against the port on the same seeded weights."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import weights
from portbench.reference import model as ref_model
from conftest import DATA


def _cfg(**over):
    cfg = json.loads((DATA / "qwen2-tiny.json").read_text())
    cfg.update(over)
    return cfg


def _port_logits(cfg, params, ids):
    from adversarial_spec_tpu_torch.models.config import get_config
    from adversarial_spec_tpu_torch.models.transformer import forward, init_cache

    pc = get_config(cfg["port"]["family"], cfg["port"]["size"])
    tok = torch.tensor([ids])
    cache = init_cache(pc, 1, len(ids), device=torch.device("cpu"), dtype=torch.float32)
    pos = torch.arange(len(ids))[None, :]
    valid = torch.ones((1, len(ids)), dtype=torch.bool)
    return forward(params, pc, tok, pos, cache, 0, valid, use_kernels=False)[0]


@pytest.mark.parametrize("bias", [True, False])
def test_reference_matches_the_port(bias):
    cfg = _cfg()
    params = weights.draw(cfg, 2**31 + 5, torch.device("cpu"), torch.float32)
    if not bias:  # the port's zero biases: the reference must then skip them alike
        for lp in params["layers"]:
            for k in ("bq", "bk", "bv"):
                lp[k].zero_()
    ids = torch.randint(0, cfg["vocab_size"], (70,), generator=torch.Generator().manual_seed(3)).tolist()
    want = _port_logits(cfg, params, ids)
    got = ref_model.logits(params, cfg, ids, 0)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_sees_each_part():
    """Dropping a bias, a norm's weight or a RoPE theta moves the logits."""
    cfg = _cfg()
    params = weights.draw(cfg, 9, torch.device("cpu"), torch.float32)
    ids = list(range(3, 60))
    base = ref_model.logits(params, cfg, ids, 0)
    assert not torch.allclose(base, ref_model.logits(params, _cfg(rope_theta=1e4), ids, 0), atol=1e-3)
    assert not torch.allclose(base, ref_model.logits(params, _cfg(attention_bias=False), ids, 0), atol=1e-3)
    params["layers"][0]["attn_norm"].fill_(1.0)
    assert not torch.allclose(base, ref_model.logits(params, cfg, ids, 0), atol=1e-3)


def test_weights_follow_the_seed():
    cfg = _cfg()
    a = weights.draw(cfg, 123, torch.device("cpu"), torch.float32)
    b = weights.draw(cfg, 123, torch.device("cpu"), torch.float32)
    c = weights.draw(cfg, 124, torch.device("cpu"), torch.float32)
    assert torch.equal(a["layers"][1]["w_down"], b["layers"][1]["w_down"])
    assert not torch.equal(a["layers"][1]["w_down"], c["layers"][1]["w_down"])
    w = a["layers"][0]["wq"]
    assert w.shape == (256, 256) and abs(w.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(a["final_norm"].mean().item() - 1.0) < 0.05
    assert weights.count(cfg) == sum(t.numel() for t in _leaves(a))


def _leaves(p):
    if isinstance(p, dict):
        for v in p.values():
            yield from _leaves(v)
    elif isinstance(p, list):
        for v in p:
            yield from _leaves(v)
    else:
        yield p


def test_served_gaps_are_zero_for_the_reference_argmax():
    cfg = _cfg()
    params = weights.draw(cfg, 17, torch.device("cpu"), torch.float32)
    prompt = list(range(3, 40))
    ids = list(prompt)
    for _ in range(8):
        ids.append(int(ref_model.logits(params, cfg, ids, len(ids) - 1)[-1].argmax()))
    served = ids[len(prompt):]
    assert float(ref_model.served_gaps(params, cfg, prompt, served).max()) == 0.0
    served[3] = (served[3] + 1) % cfg["vocab_size"]
    assert float(ref_model.served_gaps(params, cfg, prompt, served)[3]) > 0.0


def test_block_matrices_carry_outliers_and_the_head_none():
    """The blocks' int8 scales are set by sparse outliers, as in trained
    weights; the head's draw has none."""
    cfg = _cfg()
    p = weights.draw(cfg, 2**31 + 9, torch.device("cpu"), torch.float32)
    unit = (256 * weights._matrix_variance()) ** -0.5  # one standard deviation of the draw
    w = torch.cat([p["layers"][i][k].flatten() for i in range(2) for k in ("wq", "w_up", "w_down")])
    far = (w.abs() > weights.OUTLIER_AT * unit).float().mean().item()
    assert 2e-4 < far < 1e-3 and w.abs().max().item() > 20 * unit
    assert p["lm_head"].abs().max().item() < 6 * 256 ** -0.5


def test_reference_takes_a_departure_at_the_value_run():
    cfg = _cfg()
    params = weights.draw(cfg, 4, torch.device("cpu"), torch.float32)
    ids = list(range(3, 30))
    base = ref_model.logits(params, cfg, ids, 0)
    moved = ref_model.logits(params, _cfg(departures={"rms_norm_eps": 0.5}), ids, 0)
    same = ref_model.logits(params, _cfg(departures={"rms_norm_eps": cfg["rms_norm_eps"]}), ids, 0)
    assert not torch.allclose(base, moved, atol=1e-3) and torch.equal(base, same)


@pytest.mark.parametrize("cut, whole", [(8, 1), (5, 0), ("eos", 1)])
def test_a_row_cut_short_without_a_stop_fails_the_check(cut, whole):
    """A row is whole at its budget or where it ends on an end-of-sequence
    id (whose gap is compared with the rest); one cut anywhere else is not."""
    from portbench import harness

    cfg = _cfg()
    params = weights.draw(cfg, 23, torch.device("cpu"), torch.float32)
    prompt = list(range(3, 40))
    ids = list(prompt)
    for _ in range(8):
        ids.append(int(ref_model.logits(params, cfg, ids, len(ids) - 1)[-1].argmax()))
    served = ids[len(prompt):]
    eos = {served[4]} if cut == "eos" else {-1}
    row = served[:5] if cut == "eos" else served[:cut]
    checks, tokens = harness.check(params, cfg, {"max_new_tokens": 8, "check_rows": 1},
                                   [(prompt, row)], eos, {"served_gap": {"limit": 1e-3}}, 0, 1)
    assert tokens == len(row) and checks["whole_rows_checked"] == {"value": whole, "limit": 1}
    assert checks["served_gap"]["value"] == 0.0 and harness.is_correct(checks) is bool(whole)
