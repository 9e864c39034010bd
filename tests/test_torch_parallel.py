"""The port's mesh, sharding rules, collectives and mesh-serving engine
against the reference's, on the CPU.

- ``mesh_shape_from_spec``: the reference's dict, or its error, on the
  cases of ``tests/test_parallel.py``.
- Sharding: every leaf of a bridged tiny model (biases, the tied head's
  transposed copy, int8 and int4 leaves included), each port shard
  bit-identical to the reference's ``shard_params`` shard on the device
  at the same mesh position; the per-chip byte estimate equal to the
  reference's count of one device's shard on distinct devices, and to
  every shard's on a virtual mesh (one shared device).
- The loader's ``device_put`` hook places a synthetic init by the rules,
  one layer at a time, with the weights of the unplaced init.
- Collectives: the ``local`` way on a virtual mesh, counted.
- ``GpuEngine(devices=["cpu"] * 8)`` on a tp=2 alias: ``chat`` text equal
  to the reference ``TpuEngine``'s, ``critique --json`` equal through
  both CLIs, and ``perf.weights`` equal under a budget that demotes a
  tp=2 model and promotes it back; a virtual mesh's budget counts every
  shard on its shared device; single-device aliases stay on the engine's
  device when the device list is the default.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu.engine import dispatch as ref_dispatch
from adversarial_spec_tpu.engine import weightres as ref_weightres
from adversarial_spec_tpu.engine.tpu import TpuEngine, per_chip_param_bytes
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_get_config
from adversarial_spec_tpu.ops.quant import quantize_params as jax_quantize
from adversarial_spec_tpu.parallel import mesh as jax_mesh
from adversarial_spec_tpu.parallel.sharding import param_shardings as jax_param_shardings
from adversarial_spec_tpu.parallel.sharding import shard_params as jax_shard_params
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch.engine import dispatch as port_dispatch
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import weightres
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine, estimate_param_bytes
from adversarial_spec_tpu_torch.engine.loader import materialize_params, params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.parallel import collectives
from adversarial_spec_tpu_torch.parallel import mesh as port_mesh
from adversarial_spec_tpu_torch.parallel.sharding import (
    assemble,
    cache_sharding,
    make_device_put,
    param_sharding_rules,
    per_chip_param_bytes as port_per_chip,
    place_tree,
    shard_params,
)

from tests import torch_cli_support as sup

CPU8 = ["cpu"] * 8
# Eight distinct device names: a mesh of distinct cards, for the byte
# estimates only (a CPU tensor has no device index).
CARDS8 = [f"cpu:{i}" for i in range(8)]


@pytest.fixture(scope="module", autouse=True)
def _needs_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("requires 8 virtual devices (see conftest XLA_FLAGS)")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny models and their shards here gain
    nothing from a team of every core, which on a loaded host costs them
    far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "spec",
    [{"tp": 2}, {}, {"dp": 2, "tp": 2, "sp": 2}, {"tp": 3}, {"dp": 8, "tp": 2},
     {"pp": 2}, {"dp": 2}, {"dp": 2, "tp": 2}, {"tp": 8}],
    ids=lambda s: json.dumps(s),
)
def test_mesh_shape_matches_reference(spec):
    def run(mod):
        try:
            return mod.mesh_shape_from_spec(spec, 8)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(port_mesh) == run(jax_mesh)


def test_make_mesh_places_tp_fastest():
    mesh = port_mesh.make_mesh({"tp": 2}, [f"cpu:{i}" for i in range(8)])
    ref = jax_mesh.make_mesh({"tp": 2})
    assert mesh.shape == dict(ref.shape)
    assert mesh.devices.shape == ref.devices.shape == (4, 1, 2)
    assert [[str(mesh.device(d, t)) for t in range(2)] for d in range(4)] == [
        [f"cpu:{2 * d + t}" for t in range(2)] for d in range(4)
    ]
    assert not port_mesh.make_mesh({"tp": 2}, CPU8).distinct
    assert mesh.distinct


def _bridged(family: str, quant: str):
    jcfg = jax_get_config(family, "tiny")
    jp = jax_tf.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    if quant:
        jp = jax_quantize(jp, fmt=quant)
    cfg = get_config(family, "tiny")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)


@pytest.mark.parametrize("mesh_spec", [{"tp": 2}, {"dp": 2, "tp": 2}], ids=["tp2", "dp2tp2"])
@pytest.mark.parametrize(
    "family,quant", [("llama", ""), ("qwen2", ""), ("gemma2", ""), ("llama", "int8"),
                     ("llama", "int4")],
)
def test_every_shard_is_bit_identical_to_the_reference(family, quant, mesh_spec):
    jp, pp = _bridged(family, quant)
    jmesh = jax_mesh.make_mesh(mesh_spec)
    ref = jax_shard_params(jmesh, jp)
    mesh = port_mesh.make_mesh(mesh_spec, CPU8)
    got = shard_params(mesh, pp)
    position = {dev: (d, t) for (d, _, t), dev in np.ndenumerate(jmesh.devices)}
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        names = [str(p.key) for p in path]
        for shard in leaf.addressable_shards:
            if shard.device not in position:
                continue  # a submesh leaves devices out
            d, t = position[shard.device]
            node = got.parts[d][t]
            data = np.asarray(shard.data)
            if names[0] == "layers":
                node = node["layers"]
                for layer in range(data.shape[0]):
                    part = node[layer]
                    for k in names[1:]:
                        part = part[k]
                    np.testing.assert_array_equal(part.numpy(), data[layer])
                    n += 1
                continue
            for k in names:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), data)
            n += 1
    assert n > 0
    # Every shard sits on the one CPU device: the budget counts them all,
    # each distinct tensor once (the whole model), where the reference's
    # 8 devices hold one shard each.
    assert port_per_chip(got) == port_per_chip(pp) > per_chip_param_bytes(ref)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_per_chip_estimate_counts_one_devices_shard(quant):
    spec = registry.ModelSpec(alias="x", dtype="float32", quant=quant, mesh={"tp": 2})
    jp, _ = _bridged("llama", quant)
    jmesh = jax_mesh.make_mesh({"tp": 2})
    mesh = port_mesh.make_mesh({"tp": 2}, CARDS8)
    assert estimate_param_bytes(spec, mesh) == per_chip_param_bytes(jax_shard_params(jmesh, jp))
    assert estimate_param_bytes(spec, mesh) < estimate_param_bytes(spec)
    virtual = port_mesh.make_mesh({"tp": 2}, CPU8)
    assert estimate_param_bytes(spec, virtual) == estimate_param_bytes(spec)


def test_device_put_hook_places_a_synthetic_init_by_the_rules():
    mesh = port_mesh.make_mesh({"tp": 2}, CPU8)
    tree, cfg = materialize_params(
        "random", "llama", "tiny", dtype=torch.float32, device="cpu",
        quant="int4", device_put=make_device_put(mesh, torch.float32),
    )
    params = assemble(mesh, tree)
    lp = params.parts[0][1]["layers"][0]
    D, QD, F = cfg.dim, cfg.n_heads * cfg.head_dim, cfg.ffn_dim
    assert tuple(lp["wq"]["q4"].shape) == (D // 2, QD // 2)
    assert tuple(lp["wo"]["q4"].shape) == (QD // 4, D)
    assert tuple(lp["w_down"]["scale"].shape) == (1, D)
    assert tuple(lp["w_up"]["scale"].shape) == (1, F // 2)
    assert tuple(params.parts[3][0]["lm_head"]["q4"].shape) == (D // 2, cfg.vocab_size // 2)
    # dp replicas on one device are one tensor.
    assert params.parts[0][1]["embed"] is params.parts[3][1]["embed"]


@pytest.mark.parametrize("quant", ["", "int4"])
def test_device_put_hook_keeps_the_weights_of_the_unplaced_init(quant):
    """Placing layer by layer draws the same weights: every shard equals
    the matching slice of the init made without the hook."""
    mesh = port_mesh.make_mesh({"dp": 2, "tp": 2}, CPU8)
    kw = dict(dtype=torch.float32, device="cpu", quant=quant)
    whole, _ = materialize_params("random", "llama", "tiny", **kw)
    tree, _ = materialize_params("random", "llama", "tiny",
                                 device_put=make_device_put(mesh, torch.float32), **kw)
    want = shard_params(mesh, whole)
    got = assemble(mesh, tree)
    for d in range(2):
        for t in range(2):
            flat_a, flat_b = [], []
            place_tree(lambda path, x: flat_a.append((path, x)), got.parts[d][t])
            place_tree(lambda path, x: flat_b.append((path, x)), want.parts[d][t])
            assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
            for (path, x), (_, y) in zip(flat_a, flat_b):
                assert torch.equal(x, y), path


def test_mesh_init_holds_one_layer_at_a_time(monkeypatch):
    """A synthetic init on a mesh hands each layer to the placement hook
    before it draws the next: the full-size leaves drawn and not yet
    placed never exceed one layer's (the whole model was drawn first,
    which on a tp=8 70B put 141 GB on the first card)."""
    mesh = port_mesh.make_mesh({"tp": 2}, CPU8)
    cfg = get_config("llama", "tiny")
    pending = {"bytes": 0, "peak": 0}
    draw = torch.nn.init.trunc_normal_

    def counted_draw(w, *args, **kw):
        pending["bytes"] += w.numel() * 4  # f32 here, as the test's dtype
        pending["peak"] = max(pending["peak"], pending["bytes"])
        return draw(w, *args, **kw)

    put = make_device_put(mesh, torch.float32)

    def counted_put(path, x):
        pending["bytes"] -= x.numel() * x.element_size()
        return put(path, x)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", counted_draw)
    tree, _ = materialize_params("random", "llama", "tiny", dtype=torch.float32,
                                 device="cpu", device_put=counted_put)
    D, QD, KD, F = cfg.dim, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.ffn_dim
    layer = 4 * (2 * D * QD + 2 * D * KD + 3 * D * F)
    assert cfg.n_layers >= 2
    assert 0 < pending["peak"] <= max(layer, 4 * D * cfg.vocab_size)
    assert len(assemble(mesh, tree).shard()["layers"]) == cfg.n_layers


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma2"])
def test_sharding_rules_name_every_leaf_as_the_reference_does(family):
    """``param_sharding_rules`` names every leaf's spec as the
    reference's ``param_shardings`` does, its stacked layer axis dropped."""
    jp, pp = _bridged(family, "int4")
    mesh = port_mesh.make_mesh({"tp": 2}, CPU8)
    specs = place_tree(lambda path, _: param_sharding_rules(path), pp)
    ref = jax_param_shardings(jax_mesh.make_mesh({"tp": 2}), jp)
    for path, sh in jax.tree_util.tree_flatten_with_path(ref)[0]:
        names = [str(p.key) for p in path]
        spec = tuple(sh.spec)
        if names[0] == "layers":
            node, spec = specs["layers"][0], spec[1:]
            names = names[1:]
        else:
            node = specs
        for k in names:
            node = node[k]
        want = tuple(spec) + (None,) * (len(node) - len(spec))
        assert node + (None,) * (len(want) - len(node)) == want, names
    assert cache_sharding(mesh) == (None, "dp", "tp", None, None)


def test_collectives_local_way_sums_and_gathers_in_rank_order():
    collectives.reset_counts()
    parts = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    summed = collectives.all_reduce(parts)
    assert all(torch.equal(s, torch.full((2, 3), 10.0)) for s in summed)
    gathered = collectives.all_gather([torch.full((2, 1), float(i)) for i in range(3)])
    assert gathered.tolist() == [[0.0, 1.0, 2.0]] * 2
    assert collectives.counts == {"nccl": 0, "local": 2, "peer": 0}
    assert collectives.all_reduce(parts[:1]) == parts[:1]  # tp=1: no collective
    assert collectives.counts["local"] == 2


def test_multi_host_launch_is_refused(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(NotImplementedError, match="multi-host launch .* not supported"):
        port_mesh.maybe_initialize_distributed()


# -- the engine and both CLIs on a tp=2 alias ---------------------------------


@pytest.fixture
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def mesh_registry(_port_state):
    for spec in (
        registry.ModelSpec(alias="tp-tiny", family="llama", size="tiny",
                           dtype="float32", mesh={"tp": 2}),
        registry.ModelSpec(alias="dptp-paged", family="llama", size="tiny",
                           dtype="float32", mesh={"dp": 2, "tp": 2}, kv="paged",
                           max_seq_len=512),
        registry.ModelSpec(alias="one-tiny", family="llama", size="tiny",
                           dtype="float32", mesh={"dp": 1}),
    ):
        registry.save_registry_entry(spec)


USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially."),
    ("You are a PM.", "# Spec\nAcceptance: an integration test. " * 3),
]


def _bridge(alias: str) -> GpuEngine:
    """Load ``alias`` in the reference's engine (its dispatch cache) and
    serve the same weights, sharded on the same mesh, from a CPU
    GpuEngine over 8 devices in the port's dispatch cache."""
    ref_engine = ref_dispatch.get_engine(f"tpu://{alias}")
    lm = ref_engine._load(alias)
    port = GpuEngine(device="cpu", devices=CPU8)
    spec = registry.resolve_model_spec(f"tpu://{alias}")
    params = params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32)
    port.install(alias, shard_params(port.mesh_for(spec), params))
    port_dispatch.install_engine(f"tpu://{alias}", port)
    return port


@pytest.mark.parametrize("alias", ["tp-tiny", "dptp-paged"])
def test_chat_on_a_mesh_matches_reference(mesh_registry, alias):
    port = _bridge(alias)
    ref_engine = ref_dispatch.get_engine(f"tpu://{alias}")
    sp = dict(max_new_tokens=24, greedy=True)
    ref = ref_engine.chat([RefChatRequest(f"tpu://{alias}", s, u) for s, u in USERS],
                          RefParams(**sp))
    got = port.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in USERS],
                    SamplingParams(**sp))
    assert [c.error for c in got] == [None] * len(USERS)
    for r, g in zip(ref, got):
        assert g.text.encode() == r.text.encode()
        assert (g.usage.input_tokens, g.usage.output_tokens) == (
            r.usage.input_tokens, r.usage.output_tokens)
    lm = port._models[alias]
    assert lm.mesh.shape == dict(ref_engine._models[alias].mesh.shape)
    assert lm.batcher is None  # a paged alias on a mesh runs generate(paged=True)


def test_critique_on_a_tp2_alias_matches_through_both_clis(mesh_registry, tmp_path,
                                                           monkeypatch, capsys):
    _bridge("tp-tiny")
    spec = "# Rate Limiter\n\nThe API MUST rate-limit each tenant.\n"
    argv = ["critique", "--models", "tpu://tp-tiny,tpu://tp-tiny", "--greedy",
            "--max-new-tokens", "16", "--json"]
    docs = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg, tmp_path / "registry.json")
        code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, spec)
        assert code == 0, err
        docs.append(json.loads(out))
    ref, got = docs
    assert [r["error"] for r in got["results"]] == [None, None]
    for r, g in zip(ref["results"], got["results"]):
        assert g["response"].encode() == r["response"].encode()
        assert (g["input_tokens"], g["output_tokens"]) == (r["input_tokens"], r["output_tokens"])
    walls = ("load_s", "demote_s", "promote_s", "weight_load_wall_s")
    assert {k: v for k, v in got["perf"]["weights"].items() if k not in walls} == {
        k: v for k, v in ref["perf"]["weights"].items() if k not in walls
    }


def test_weights_report_matches_under_a_demoting_budget(mesh_registry, monkeypatch):
    """A budget that holds one model: serving the tp=2 model, a second
    model, then the tp=2 model again demotes it and promotes it back,
    every shard restored (the round's text is unchanged), and the
    ledger's report is the reference's."""
    ref_engine = TpuEngine()
    port = GpuEngine(device="cpu", devices=CPU8)
    tp_spec = registry.resolve_model_spec("tpu://tp-tiny")
    # The reference counts one device's shard of the tp=2 model (its
    # devices are distinct), the port's virtual mesh every shard: a
    # budget of one whole model plus half a shard demotes in both.
    whole = estimate_param_bytes(registry.resolve_model_spec("tpu://one-tiny"))
    shard = estimate_param_bytes(tp_spec, port_mesh.make_mesh(tp_spec.mesh, CARDS8))
    assert estimate_param_bytes(tp_spec, port.mesh_for(tp_spec)) == whole
    monkeypatch.setenv("ADVSPEC_HBM_BUDGET_BYTES", str(whole + shard // 2))
    sp = dict(max_new_tokens=8, greedy=True)
    reports, texts = [], []
    for eng, req, params, res in ((ref_engine, RefChatRequest, RefParams, ref_weightres),
                                  (port, ChatRequest, SamplingParams, weightres)):
        res.reset_stats()
        out = []
        for alias in ("tp-tiny", "one-tiny", "tp-tiny"):
            (c,) = eng.chat([req(f"tpu://{alias}", "s", "u")], params(**sp))
            assert c.ok, c.error
            out.append(c.text)
        texts.append(out)
        reports.append({k: v for k, v in res.snapshot().items() if not k.endswith("_s")})
    assert reports[1] == reports[0]
    assert reports[1]["demotions"] >= 1 and reports[1]["promotions"] >= 1
    assert texts[1][0] == texts[1][2]
    port.check_residency_invariants()


def test_virtual_mesh_budget_counts_every_shard_on_the_shared_device(mesh_registry,
                                                                    monkeypatch):
    """On ``devices=["cpu"] * 2`` a tp=2 model's shards all sit on one
    device: its estimate and its resident bytes are the whole model's,
    so a budget that holds the shard plus another model, but not two
    whole models, demotes it when the other model loads."""
    port = GpuEngine(device="cpu", devices=["cpu"] * 2)
    tp_spec = registry.resolve_model_spec("tpu://tp-tiny")
    whole = estimate_param_bytes(registry.resolve_model_spec("tpu://one-tiny"))
    shard = estimate_param_bytes(tp_spec, port_mesh.make_mesh(tp_spec.mesh, CARDS8[:2]))
    assert shard < whole
    assert estimate_param_bytes(tp_spec, port.mesh_for(tp_spec)) == whole
    monkeypatch.setenv("ADVSPEC_HBM_BUDGET_BYTES", str((shard + 3 * whole) // 2))
    weightres.reset_stats()
    sp = SamplingParams(max_new_tokens=4, greedy=True)
    (c,) = port.chat([ChatRequest("tpu://tp-tiny", "s", "u")], sp)
    assert c.ok, c.error
    lm = port._models["tp-tiny"]
    assert lm.mesh.shape == {"dp": 1, "sp": 1, "tp": 2}
    assert lm.bytes_per_chip == whole
    (c,) = port.chat([ChatRequest("tpu://one-tiny", "s", "u")], sp)
    assert c.ok, c.error
    assert "tp-tiny" not in port._models
    assert weightres.snapshot()["demotions"] == 1
    port.check_residency_invariants()


def test_single_device_aliases_stay_off_the_default_device_list(mesh_registry):
    """With two cards visible and no ``devices`` given, an alias that
    names no mesh axis above 1 stays on the engine's device (a paged one
    on its batcher); a tp=2 alias spreads over both; and with ``devices``
    given, the reference's rules spread even ``{}`` over them (dp=2)."""
    registry.save_registry_entry(registry.ModelSpec(
        alias="paged-tiny", family="llama", size="tiny", dtype="float32", kv="paged"))
    port = GpuEngine(device="cpu")
    port.devices = [torch.device("cpu")] * 2  # the default list of a 2-card host
    for alias in ("paged-tiny", "one-tiny"):
        assert port.mesh_for(registry.resolve_model_spec(f"tpu://{alias}")).size == 1
    tp = port.mesh_for(registry.resolve_model_spec("tpu://tp-tiny"))
    assert tp.shape == {"dp": 1, "sp": 1, "tp": 2}
    sp = SamplingParams(max_new_tokens=4, greedy=True)
    (c,) = port.chat([ChatRequest("tpu://paged-tiny", "s", "u")], sp)
    assert c.ok, c.error
    lm = port._models["paged-tiny"]
    assert lm.mesh is None and lm.batcher is not None
    given = GpuEngine(device="cpu", devices=["cpu"] * 2)
    assert given.mesh_for(registry.resolve_model_spec("tpu://paged-tiny")).shape == {
        "dp": 2, "sp": 1, "tp": 1}
