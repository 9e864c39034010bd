"""A pool of HF checkpoint aliases, each with its own ``tokenizer.json``,
through the reference (``TpuEngine``, ``tokenizers``) and the port
(``GpuEngine`` on the CPU, its own reader): byte-identical greedy text.

One tiny Llama HF checkpoint (``tests/torch_hf_support.py``) serves four
aliases, each with a tokenizer in one family's published layout
(``tests/torch_tokenizer_support.py``, at a vocabulary below the tiny
model's 512 rows): ``pool-llama3`` dense, ``pool-mistral`` paged,
``pool-gemma2`` dense with int4 weights, ``pool-qwen2`` paged. Each
alias's ``chat()`` matches the reference's, and so does a two-round
``critique --json`` over the whole pool through both CLIs — at the
natural budget and under a budget that forces demotions and promotions,
where both packages' ``perf.weights`` agree too. A tokenizer the reader
does not implement is refused before any weights load.
"""

import json
from dataclasses import replace

import pytest
import torch

from adversarial_spec_tpu.engine import registry as ref_registry
from adversarial_spec_tpu.engine import spec as ref_spec
from adversarial_spec_tpu.engine.tpu import TpuEngine
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine, estimate_param_bytes
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams

from tests import torch_cli_support as sup
from tests import torch_hf_support as hf
from tests import torch_tokenizer_support as toks

POOL = {
    "pool-llama3": ("llama3", dict()),
    "pool-mistral": ("mistral", dict(kv="paged")),
    "pool-gemma2": ("gemma2", dict(quant="int4")),
    "pool-qwen2": ("qwen2", dict(kv="paged")),
}
USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially, 3 times."),
]
SPEC = (
    "# Rate Limiter\n\nThe API MUST rate-limit each tenant to 100 requests "
    "per second.\n\n## Errors\nOver-limit requests get HTTP 429 — café, naïve.\n"
)


@pytest.fixture(scope="module")
def pool_files(tmp_path_factory):
    """(checkpoint dir, {layout: tokenizer dir}), written once."""
    root = tmp_path_factory.mktemp("pool")
    ckpt = hf.write_checkpoint(hf.hf_model("llama"), root / "ckpt", "f32")
    dirs = {}
    for layout in toks.LAYOUTS:
        d = root / layout
        d.mkdir()
        (d / "tokenizer.json").write_text(toks.build_fixture(layout, 480))
        dirs[layout] = d
    return str(ckpt), dirs


@pytest.fixture
def pool(pool_files, tmp_path, monkeypatch):
    """The pool's aliases in one registry file both packages read, their
    context cut to 512 tokens (the debate prompt is trimmed alike by both
    engines). The port runs on one intra-op thread: a prefetch thread's
    torch ops beside the serving thread's would each spin up a team of
    every core."""
    gen = sup.isolate_port(tmp_path, monkeypatch)
    next(gen)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("ADVSPEC_HBM_BUDGET_BYTES", raising=False)
    path = tmp_path / "registry.json"
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    ckpt, dirs = pool_files
    for alias, (layout, extra) in POOL.items():
        registry.save_registry_entry(
            registry.ModelSpec(
                alias=alias, family="llama", size="tiny", dtype="float32",
                mesh={"dp": 1}, checkpoint=ckpt, tokenizer=str(dirs[layout]),
                max_seq_len=512, **extra,
            )
        )
    for cfg in (ref_spec.config(), port_spec.config()):
        monkeypatch.setattr(cfg, "gamma", 8)
    yield pool_files
    torch.set_num_threads(threads)
    next(gen, None)


@pytest.mark.parametrize("alias", sorted(POOL))
def test_chat_on_pool_alias_matches_reference(pool, alias):
    sp = dict(max_new_tokens=16, greedy=True)
    ref = TpuEngine().chat([RefChatRequest(f"tpu://{alias}", s, u) for s, u in USERS],
                           RefParams(**sp))
    got = GpuEngine(device="cpu").chat(
        [ChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], SamplingParams(**sp)
    )
    assert [c.ok for c in ref] == [True] * len(USERS), [c.error for c in ref]
    assert [c.ok for c in got] == [True] * len(USERS), [c.error for c in got]
    for r, g in zip(ref, got):
        assert g.text.encode() == r.text.encode()
        for field in ("input_tokens", "output_tokens", "cached_tokens"):
            assert getattr(g.usage, field) == getattr(r.usage, field)
    assert any(g.text for g in got)


WALLS = ("load_s", "demote_s", "promote_s", "weight_load_wall_s")


@pytest.mark.parametrize("budget", ["natural", "forced"])
def test_pool_critique_matches_reference(pool, budget, tmp_path, monkeypatch, capsys):
    """Two rounds over the whole pool through both CLIs: the same
    responses and the same residency ledger. Under the forced budget
    (two of the four models fit) round 1 demotes and round 2 promotes."""
    if budget == "forced":
        sizes = sorted(
            estimate_param_bytes(registry.resolve_model_spec(f"tpu://{a}")) for a in POOL
        )
        monkeypatch.setenv("ADVSPEC_HBM_BUDGET_BYTES", str(sizes[-1] + sizes[-2] + 1024))
    models = ",".join(f"tpu://{a}" for a in POOL)
    common = ["--greedy", "--max-new-tokens", "16", "--json", "--weight-host-mb", "64"]
    rounds = [
        (["critique", "--models", models, "--session", "pool", *common], SPEC),
        (["critique", "--resume", "pool", *common], None),
    ]
    weights = []
    for argv, stdin in rounds:
        (rc, rout, rerr), (pc, pout, perr) = sup.both_cli(argv, tmp_path, monkeypatch,
                                                          capsys, stdin)
        assert rc == pc == 0, (rerr, perr)
        ref_doc, port_doc = (
            sup.without_walls(sup.normalize_report(json.loads(o), pkg))
            for o, pkg in ((rout, "ref"), (pout, "port"))
        )
        assert [r["error"] for r in port_doc["results"]] == [None] * len(POOL)
        assert port_doc["results"] == ref_doc["results"]
        for key in ("round", "all_agreed", "trace_id"):
            assert port_doc[key] == ref_doc[key], key
        assert port_doc["perf"]["weights"] == ref_doc["perf"]["weights"]
        weights.append(port_doc["perf"]["weights"])
    if budget == "natural":
        assert weights[0]["loads"] == len(POOL) and weights[0]["demotions"] == 0
        assert weights[1]["loads"] == 0 and weights[1]["promotions"] == 0
    else:
        assert weights[0]["demotions"] > 0
        assert weights[1]["promotions"] > 0 and weights[1]["loads"] == 0


def test_unsupported_tokenizer_is_refused_before_weights_load(pool, tmp_path, monkeypatch,
                                                                capsys):
    _, dirs = pool
    doc = json.loads((dirs["llama3"] / "tokenizer.json").read_text())
    doc["pre_tokenizer"] = {"type": "BertPreTokenizer"}
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "tokenizer.json").write_text(json.dumps(doc))
    spec = registry.resolve_model_spec("tpu://pool-llama3")
    registry.save_registry_entry(replace(spec, alias="pool-bad", tokenizer=str(bad)))
    eng = GpuEngine(device="cpu")
    (c,) = eng.chat([ChatRequest("tpu://pool-bad", "s", "u")], SamplingParams(max_new_tokens=4))
    assert not c.ok and not c.transient
    assert "BertPreTokenizer" in c.error and "UnsupportedTokenizer" in c.error
    assert eng.ledger.resident_models == 0 and not eng._models
    code, out, err = sup.run_cli(
        port_cli, ["critique", "--models", "tpu://pool-bad", "--json"], monkeypatch, capsys, SPEC
    )
    assert code == 2 and out == ""
    assert "validation error: tpu://pool-bad:" in err and "BertPreTokenizer" in err


def test_committed_fixtures_are_rebuilt_identically():
    """The four files under ``tests/torch_tokenizers/`` are what
    ``build_fixture`` trains from this repository's text."""
    for layout in toks.LAYOUTS:
        committed = (toks.FIXTURES / layout / "tokenizer.json").read_text()
        assert committed == toks.build_fixture(layout), layout
