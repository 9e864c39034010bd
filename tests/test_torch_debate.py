"""The port's debate round on ``tpu://`` against the reference's, and the
classification of the port's refusals (fault C.5).

Both CLIs run the same ``critique`` argv over ``tpu://`` aliases in f32
on a one-device mesh (user registry entries both packages read): the
reference on JAX-CPU, the port through a ``GpuEngine(device="cpu")``
put into its dispatch cache, holding the reference's weights bridged
with ``params_from_jax``. Greedy responses must be byte-identical, and
the per-opponent token counts and the ``perf.spec`` / ``perf.prefix_cache``
counts equal: dense with speculation on and off, and a ``kv="paged"``
entry over two rounds of one session, the second served from the prefix
cache.

A paged round with a per-request deadline is served as the reference
serves it. Every "not yet ported" refusal of ``GpuEngine`` must classify
as ``BUG``
(never TIMEOUT, which would count against the model's breaker as a
watchdog expiry and hedge the request), and ``GpuEngine.chat`` must set
``Completion.transient`` from the fault's class, as the reference does.
"""

import json

import jax
import numpy as np
import pytest
import torch

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu.engine import dispatch as ref_dispatch
from adversarial_spec_tpu.resilience.faults import FaultKind as RefFaultKind
from adversarial_spec_tpu.resilience.faults import (
    classify_message as ref_classify_message,
)
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch.engine import dispatch as port_dispatch
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine, unported_reason
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.resilience import faults
from adversarial_spec_tpu_torch.resilience.faults import FaultKind

from tests import torch_cli_support as sup

SPEC = (
    "# Rate Limiter\n\nThe API MUST rate-limit each tenant to 100 requests "
    "per second.\n\n## Errors\nOver-limit requests get HTTP 429.\n"
)
SPEC_COUNTS = (
    "spec_steps", "drafted_tokens", "accepted_tokens", "emitted_tokens",
    "rolled_back_pages", "acceptance_rate", "tokens_per_step", "enabled",
    "gamma",
)
PREFIX_COUNTS = (
    "lookups", "hits", "misses", "cached_tokens", "prefilled_tokens",
    "saved_tokens", "inserted_blocks", "evicted_blocks", "evicted_pages",
)
USAGE_COUNTS = ("input_tokens", "output_tokens", "cached_tokens")


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def tiny_registry(tmp_path):
    """f32, one-device entries in the registry file both packages read
    (``isolate_port`` points them at the same ``tmp_path`` file)."""
    for spec in (
        registry.ModelSpec(
            alias="random-tiny", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1},
        ),
        registry.ModelSpec(
            alias="paged-f32", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1}, kv="paged",
        ),
    ):
        registry.save_registry_entry(spec)


def _bridge(alias: str) -> None:
    """Load ``alias`` in the reference's engine (its dispatch cache, so
    its CLI reuses it) and serve the same weights from a CPU GpuEngine
    in the port's dispatch cache."""
    ref_engine = ref_dispatch.get_engine(f"tpu://{alias}")
    lm = ref_engine._load(alias)
    port = GpuEngine(device="cpu")
    port.install(
        alias,
        params_from_jax(
            jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32
        ),
    )
    port_dispatch.install_engine(f"tpu://{alias}", port)


def _both(argv, tmp_path, monkeypatch, capsys, stdin=None):
    """One invocation through each CLI, each with its own sessions, both
    reading the one registry file of ``tiny_registry``."""
    docs = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        sup.point_state(
            monkeypatch, pkg, tmp_path / pkg, tmp_path / "registry.json"
        )
        code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, stdin)
        assert code == 0, err
        docs.append(json.loads(out))
    return docs


def _assert_round_matches(ref, got):
    assert [r["error"] for r in got["results"]] == [None] * len(got["results"])
    for r, g in zip(ref["results"], got["results"]):
        assert g["model"] == r["model"]
        assert g["response"].encode() == r["response"].encode()
        assert g["agreed"] == r["agreed"]
        for k in USAGE_COUNTS:
            assert g[k] == r[k], k
    for k in SPEC_COUNTS:
        assert got["perf"]["spec"][k] == ref["perf"]["spec"][k], k
    for k in PREFIX_COUNTS:
        assert got["perf"]["prefix_cache"][k] == ref["perf"]["prefix_cache"][k], k
    assert got["all_agreed"] == ref["all_agreed"]
    assert got["trace_id"] == ref["trace_id"]
    # Weight residency is the reference's: the same ledger report.
    assert got["perf"]["weights"]["enabled"] is True
    walls = ("load_s", "demote_s", "promote_s", "weight_load_wall_s")
    assert {k: v for k, v in got["perf"]["weights"].items() if k not in walls} == {
        k: v for k, v in ref["perf"]["weights"].items() if k not in walls
    }


@pytest.mark.parametrize("speculative", [True, False], ids=["spec", "nospec"])
def test_dense_round_matches_reference(
    speculative, tiny_registry, tmp_path, monkeypatch, capsys
):
    _bridge("random-tiny")
    argv = [
        "critique", "--models", ",".join(["tpu://random-tiny"] * 3),
        "--greedy", "--max-new-tokens", "24", "--json",
        "--speculative" if speculative else "--no-speculative",
    ]
    ref, got = _both(argv, tmp_path, monkeypatch, capsys, SPEC)
    _assert_round_matches(ref, got)
    # The dense generate() records no speculation steps (as in the
    # reference); the three identical prompts prefill once.
    assert got["perf"]["spec"]["spec_steps"] == 0
    assert got["perf"]["prefix_cache"]["saved_tokens"] > 0
    assert got["results"][0]["output_tokens"] > 0


def test_paged_session_matches_reference_and_hits_the_prefix_cache(
    tiny_registry, tmp_path, monkeypatch, capsys
):
    """Two rounds of one session on a kv="paged" entry: round 1 with
    speculation (the batcher records verify steps), round 2 without,
    served partly from round 1's prefix cache."""
    _bridge("paged-f32")
    models = ",".join(["tpu://paged-f32"] * 3)
    r1 = _both(
        ["critique", "--models", models, "--greedy", "--max-new-tokens",
         "24", "--session", "pg", "--json"],
        tmp_path, monkeypatch, capsys, SPEC,
    )
    _assert_round_matches(*r1)
    assert r1[1]["perf"]["spec"]["spec_steps"] > 0
    r2 = _both(
        ["critique", "--resume", "pg", "--greedy", "--max-new-tokens", "24",
         "--no-speculative", "--json"],
        tmp_path, monkeypatch, capsys,
    )
    _assert_round_matches(*r2)
    assert r2[1]["round"] == 2
    assert r2[1]["perf"]["spec"]["spec_steps"] == 0
    assert r2[1]["perf"]["prefix_cache"]["hits"] > 0
    assert sum(r["cached_tokens"] for r in r2[1]["results"]) > 0


def _refusal_specs():
    """The specs still refused: an sp mesh axis, and a tp that does not
    divide the model's KV heads (the tiny llama has 2). dp, tp and dp×tp
    meshes are served (``test_mesh_specs_are_served``)."""
    return {
        "mesh": registry.ModelSpec(alias="m", mesh={"sp": 2}),
        # The paged corner with no room for a bucketed prompt is served
        # (generate(paged=True)), on a dp mesh too; with an sp axis it is
        # still refused.
        "paged_budget": registry.ModelSpec(
            alias="p", kv="paged", max_seq_len=130, mesh={"dp": 2, "sp": 2}
        ),
        "mesh_dp_tp": registry.ModelSpec(alias="d", mesh={"dp": 2, "tp": 4}),
    }


@pytest.mark.parametrize(
    "mesh", [{"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 2}, {"tp": 2, "dp": 1}],
    ids=["tp2", "dp2tp2", "dp2", "tp2dp1"],
)
def test_mesh_specs_are_served(mesh):
    """dp, tp and dp×tp meshes whose tp divides the KV heads are served:
    ``unported_reason`` has no refusal for them, dense or paged."""
    for kv in ("dense", "paged"):
        spec = registry.ModelSpec(alias="m", mesh=mesh, kv=kv)
        assert unported_reason(spec) is None


@pytest.mark.parametrize("case", sorted(_refusal_specs()))
def test_every_refusal_classifies_as_bug(case):
    """The refusal text as ``GpuEngine.chat`` words it classifies as BUG
    under the port's and the reference's ``classify_message``."""
    spec = _refusal_specs()[case]
    reason = unported_reason(spec)
    assert reason is not None
    msg = (
        f"NotImplementedError: tpu://{spec.alias} needs {reason}, which is "
        "not yet ported to the PyTorch/CUDA package"
    )
    assert faults.classify_message(msg) is FaultKind.BUG
    assert ref_classify_message(msg) is RefFaultKind.BUG
    assert not FaultKind.BUG.transient


def test_hf_checkpoint_alias_is_not_refused():
    """An HF checkpoint alias is served (dense and paged, every weight
    format): ``unported_reason`` has no refusal for it."""
    for extra in ({}, {"kv": "paged"}, {"quant": "int4", "kv": "paged"}, {"quant": "int8"}):
        spec = registry.ModelSpec(alias="h", checkpoint="/some/hf/dir", **extra)
        assert unported_reason(spec) is None


def test_paged_budget_corner_is_not_refused():
    """A one-device paged alias whose budget leaves no room for a
    bucketed prompt is served by the round-synchronous
    ``generate(paged=True)``: ``unported_reason`` has no refusal for it."""
    for kv_dtype in ("", "int8"):
        spec = registry.ModelSpec(
            alias="p", kv="paged", max_seq_len=130, kv_dtype=kv_dtype
        )
        assert unported_reason(spec) is None


def test_refused_chat_is_a_counted_permanent_bug(tmp_path):
    registry.save_registry_entry(registry.ModelSpec(alias="d", mesh={"tp": 2, "sp": 2}))
    eng = GpuEngine(device="cpu")
    (c,) = eng.chat(
        [ChatRequest("tpu://d", "sys", "hi")],
        SamplingParams(max_new_tokens=8, request_deadline_s=5.0),
    )
    assert not c.ok and "not yet ported" in c.error
    assert c.transient is False
    assert faults.classify_message(c.error) is FaultKind.BUG
    assert faults.snapshot() == {"generate.bug": 1}


def test_device_oom_is_transient_and_counted(monkeypatch):
    """A CUDA OOM classifies as OOM (transient: the debate layer
    retries it) and is counted at seam ``generate``."""
    eng = GpuEngine(device="cpu")

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(eng, "_chat_loaded", oom)
    monkeypatch.setattr(eng, "_load", lambda alias: None)
    (c,) = eng.chat(
        [ChatRequest("tpu://random-tiny", "sys", "hi")],
        SamplingParams(max_new_tokens=8),
    )
    assert not c.ok and c.transient is True
    assert faults.snapshot() == {"generate.oom": 1}


def test_paged_deadline_round_is_one_failed_attempt_without_hedge(
    tiny_registry, tmp_path, monkeypatch, capsys
):
    """A paged round with ``--request-deadline-s`` through both CLIs:
    the batcher's per-request watchdog is armed (C.1 repaired: the
    request is served, not refused) and, with a deadline the round
    meets, the round is the reference's — one attempt, no hedge, no
    fault."""
    _bridge("paged-f32")
    argv = [
        "critique", "--models", "tpu://paged-f32,tpu://paged-f32", "--json",
        "--greedy", "--request-deadline-s", "300", "--max-new-tokens", "24",
    ]
    ref, got = _both(argv, tmp_path, monkeypatch, capsys, SPEC)
    _assert_round_matches(ref, got)
    counters = got["perf"]["counters"]
    assert counters["debate/attempts.tpu://paged-f32"] == 2
    assert not [k for k in counters if k.startswith("debate/hedge.")]
    assert got["perf"]["resilience"]["faults"] == {}
    assert got["perf"]["resilience"] == ref["perf"]["resilience"]
