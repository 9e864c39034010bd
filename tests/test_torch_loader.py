"""The port's HF checkpoint loader against the reference's.

Tiny checkpoints written locally by ``transformers`` (``torch_hf_support``)
go through ``adversarial_spec_tpu.engine.loader.load_hf_checkpoint`` and
the port's ``load_hf_checkpoint``:

- params bit-identical leaf by leaf, for the llama, mistral, qwen2 and
  gemma2 tiny configs and a tied llama, from f32, f16 and bf16 sources,
  one file or sharded with an index, into bf16 and f32; tied configs with
  ``ADVSPEC_TRANSPOSED_HEAD`` on and off; int8 and int4 weights;
- ``preflight_config``: the reference's matrix through both packages, the
  same accept or reject and the same message;
- shard discovery and its errors, as the reference words them;
- host staging bounded by one tensor (the reader's own count), not by the
  checkpoint;
- serving: ``GpuEngine(device="cpu").chat`` on an HF alias gives the
  reference ``TpuEngine``'s text byte for byte, dense and paged, full
  precision and int4; ``critique --json`` through both CLIs matches; the
  ``checkpoint_load`` chaos seam counts and recovers as the reference's.
"""

import json
import random
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import loader as ref_loader
from adversarial_spec_tpu.engine import registry as ref_registry
from adversarial_spec_tpu.engine import spec as ref_spec
from adversarial_spec_tpu.engine.tpu import TpuEngine
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu.models.config import get_config as ref_get_config
from adversarial_spec_tpu.ops.quant import quantize_params as ref_quantize
from adversarial_spec_tpu_torch.engine import loader
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.ops.quant import quantize_params
from adversarial_spec_tpu_torch.utils import safetensors

from tests import torch_cli_support as sup
from tests import torch_hf_support as hf

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``get(case, dtype, sharded)`` → a checkpoint dir, written once per
    module from one seeded model per case."""
    root = tmp_path_factory.mktemp("hf")
    models, dirs = {}, {}

    def get(case: str, dtype: str = "f32", sharded: bool = False):
        key = (case, dtype, sharded)
        if key not in dirs:
            if case not in models:
                models[case] = hf.hf_model(case)
            path = root / f"{case}-{dtype}-{'sharded' if sharded else 'single'}"
            dirs[key] = hf.write_checkpoint(models[case], path, dtype, sharded)
        return dirs[key]

    return get


def _load_both(path, case, dtype, quant="", transposed_head=None):
    cfg, ref_cfg = hf.configs(case)
    family = hf.family_of(case)
    port_dtype, ref_dtype = DTYPES[dtype]
    port = loader.load_hf_checkpoint(
        path, cfg, family, dtype=port_dtype, device="cpu",
        transposed_head=transposed_head, quant=quant,
    )
    ref = ref_loader.load_hf_checkpoint(
        path, ref_cfg, family, dtype=ref_dtype, transposed_head=transposed_head
    )
    if quant:
        ref = ref_quantize(ref, fmt=quant)
    return port, jax.tree.map(np.asarray, ref), cfg


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("source", sorted(hf.SOURCE_DTYPES))
@pytest.mark.parametrize("case", hf.CASES)
def test_params_bit_identical_to_reference(checkpoints, case, source, sharded):
    path = checkpoints(case, source, sharded)
    assert (path / "model.safetensors.index.json").is_file() == sharded
    for dtype in DTYPES:
        port, ref, cfg = _load_both(path, case, dtype)
        assert hf.assert_bit_identical(port, ref, cfg.n_layers) > 9 * cfg.n_layers


@pytest.mark.parametrize("flag", ["1", "0"], ids=["t_head_on", "t_head_off"])
@pytest.mark.parametrize("case", ["llama_tied", "gemma2"])
def test_tied_head_follows_the_flag(checkpoints, monkeypatch, case, flag):
    """``ADVSPEC_TRANSPOSED_HEAD`` decides the ``lm_head_t`` leaf of a tied
    config in both packages alike (None reads the env var)."""
    monkeypatch.setenv("ADVSPEC_TRANSPOSED_HEAD", flag)
    port, ref, cfg = _load_both(checkpoints(case, "bf16"), case, "bf16")
    assert ("lm_head_t" in port) == (flag == "1") == ("lm_head_t" in ref)
    assert "lm_head" not in port
    hf.assert_bit_identical(port, ref, cfg.n_layers)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("case", hf.CASES)
def test_quantized_params_bit_identical(checkpoints, case, fmt):
    """Quantized as each layer lands: bit-identical to the reference's
    ``quantize_params`` over its loaded pytree, and to the port's own
    ``quantize_params`` over the whole full-precision load."""
    path = checkpoints(case, "f16", sharded=True)
    port, ref, cfg = _load_both(path, case, "bf16", quant=fmt)
    hf.assert_bit_identical(port, ref, cfg.n_layers)
    whole = quantize_params(
        loader.load_hf_checkpoint(path, cfg, hf.family_of(case), device="cpu"), fmt=fmt
    )
    hf.assert_bit_identical(whole, ref, cfg.n_layers)


def test_materialize_params_reads_the_checkpoint(checkpoints):
    path = checkpoints("qwen2", "f32")
    params, cfg = loader.materialize_params(
        str(path), "qwen2", "tiny", dtype=torch.float32, device="cpu", quant="int8"
    )
    assert cfg == get_config("qwen2", "tiny")
    ref, _ = ref_loader.materialize_params(
        str(path), "qwen2", "tiny", dtype=jnp.float32, quant="int8"
    )
    hf.assert_bit_identical(params, jax.tree.map(np.asarray, ref), cfg.n_layers)


def test_materialize_params_requires_device_or_gpu_for_a_checkpoint(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.materialize_params(str(checkpoints("llama")), "llama", "tiny")


# -- preflight ---------------------------------------------------------------


def _hf_config_json(cfg, family="llama", **overrides):
    """The config.json an HF export of ``cfg`` would carry."""
    d = {
        "model_type": family,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.ffn_dim,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tied_embeddings,
    }
    d.update(overrides)
    return d


_LLAMA3_SCALING = {
    "rope_type": "llama3",
    "factor": 32.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}
TINY = get_config("llama", "tiny")
ONE_B = get_config("llama", "1b")
# name → (registered family, size, config.json text or None, accepted)
PREFLIGHT = {
    "matching": ("llama", "tiny", _hf_config_json(TINY), True),
    "absent": ("llama", "tiny", None, True),
    "misregistered_size": ("llama", "tiny", _hf_config_json(ONE_B), False),
    "wrong_model_type": ("llama", "tiny", _hf_config_json(TINY, family="mistral"), False),
    "rope_theta": ("llama", "tiny", _hf_config_json(TINY, rope_theta=10000.0), False),
    "unregistered_rope_scaling": (
        "llama", "tiny",
        _hf_config_json(TINY, rope_scaling=dict(_LLAMA3_SCALING, factor=8.0)), False,
    ),
    "matching_rope_scaling": (
        "llama", "1b", _hf_config_json(ONE_B, rope_scaling=_LLAMA3_SCALING), True,
    ),
    "rope_scaling_factor_differs": (
        "llama", "1b",
        _hf_config_json(ONE_B, rope_scaling=dict(_LLAMA3_SCALING, factor=8.0)), False,
    ),
    "rope_scaling_missing": ("llama", "1b", _hf_config_json(ONE_B), False),
    "rope_scaling_not_object": (
        "llama", "tiny", _hf_config_json(TINY, rope_scaling="llama3"), False,
    ),
    "tied_embeddings_mismatch": (
        "llama", "tiny", _hf_config_json(TINY, tie_word_embeddings=True), False,
    ),
    "inert_sliding_window": (
        "qwen2", "tiny",
        _hf_config_json(
            get_config("qwen2", "tiny"), family="qwen2",
            sliding_window=131072, use_sliding_window=False,
        ),
        True,
    ),
    "active_sliding_window": (
        "llama", "tiny", _hf_config_json(TINY, sliding_window=4096), False,
    ),
    "corrupt_json": ("llama", "tiny", "{not json", False),
}


def _preflight_both(path, family, size):
    """Each package's preflight outcome: None, or its error message."""
    out = []
    for preflight, get, error in (
        (loader.preflight_config, get_config, loader.CheckpointConfigError),
        (ref_loader.preflight_config, ref_get_config, ref_loader.CheckpointConfigError),
    ):
        try:
            preflight(path, get(family, size), family)
            out.append(None)
        except error as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("name", sorted(PREFLIGHT))
def test_preflight_matches_reference(tmp_path, name):
    family, size, conf, accepted = PREFLIGHT[name]
    if conf is not None:
        text = conf if isinstance(conf, str) else json.dumps(conf)
        (tmp_path / "config.json").write_text(text)
    port, ref = _preflight_both(tmp_path, family, size)
    assert port == ref
    assert (port is None) == accepted, port
    if not accepted and name != "corrupt_json":
        assert "re-register" in port


def test_preflight_weird_values_match_reference(tmp_path):
    """Arbitrary JSON values (strings where numbers belong, objects,
    lists) are reported, never raised as TypeError, and both packages word
    every report alike."""
    rng = random.Random(0)
    weird = ["x", None, [], [1], {"a": 1}, "12abc", True, -3.5, 1e99]
    keys = [
        "hidden_size", "num_hidden_layers", "num_attention_heads",
        "num_key_value_heads", "intermediate_size", "vocab_size",
        "head_dim", "sliding_window", "tie_word_embeddings",
        "rope_theta", "rope_scaling", "model_type",
    ]
    rejected = 0
    for _ in range(50):
        conf = {k: rng.choice(weird) for k in rng.sample(keys, 5)}
        (tmp_path / "config.json").write_text(json.dumps(conf))
        port, ref = _preflight_both(tmp_path, "llama", "tiny")
        assert port == ref, conf
        rejected += port is not None
    assert rejected > 25


def test_preflight_runs_before_any_tensor_is_read(tmp_path, monkeypatch):
    """A mis-registered alias fails on config.json alone: the directory
    has no tensors, and the reader is never called."""
    (tmp_path / "config.json").write_text(json.dumps(_hf_config_json(ONE_B)))
    monkeypatch.setattr(safetensors, "read_tensor", None)
    with pytest.raises(loader.CheckpointConfigError, match="hidden_size"):
        loader.load_hf_checkpoint(tmp_path, TINY, "llama", device="cpu")


# -- shards ------------------------------------------------------------------


def test_index_resolves_every_shard(checkpoints):
    path = checkpoints("llama", "f32", sharded=True)
    files = loader._open_safetensors(path)
    assert files == ref_loader._open_safetensors(path)
    assert len(set(files.values())) > 2


def test_shards_without_index_are_all_read(checkpoints, tmp_path):
    """No index: every ``*.safetensors`` of the directory is a shard."""
    src = checkpoints("mistral", "f32", sharded=True)
    for f in src.glob("*.safetensors"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    assert loader._open_safetensors(tmp_path) == ref_loader._open_safetensors(tmp_path)
    port, ref, cfg = _load_both(tmp_path, "mistral", "f32")
    hf.assert_bit_identical(port, ref, cfg.n_layers)


@pytest.mark.parametrize("broken", ["missing_tensor", "empty_dir"])
def test_shard_errors_match_reference(checkpoints, tmp_path, broken):
    if broken == "missing_tensor":
        src = checkpoints("llama", "f32", sharded=True)
        for f in src.glob("*.safetensors"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
        (tmp_path / "model.safetensors.index.json").write_text(
            json.dumps({"weight_map": {}})
        )
    errors = []
    for load, cfg in (
        (lambda c: loader.load_hf_checkpoint(tmp_path, c, "llama", device="cpu"), TINY),
        (lambda c: ref_loader.load_hf_checkpoint(tmp_path, c, "llama"),
         ref_get_config("llama", "tiny")),
    ):
        with pytest.raises((KeyError, FileNotFoundError)) as ei:
            load(cfg)
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]
    assert ("missing from checkpoint" if broken == "missing_tensor" else "no *.safetensors") in errors[0][1]


def test_malformed_shard_raises_naming_the_file(checkpoints, tmp_path):
    src = checkpoints("llama", "f32")
    data = (src / "model.safetensors").read_bytes()
    (tmp_path / "model.safetensors").write_bytes(data[: len(data) // 2])
    with pytest.raises(safetensors.SafetensorsError, match="model.safetensors"):
        loader.load_hf_checkpoint(tmp_path, TINY, "llama", device="cpu")


# -- host staging --------------------------------------------------------------


def test_host_staging_is_one_tensor_not_the_checkpoint(tmp_path):
    """The counterpart of the reference's ``TestHostRamBound``: the port
    stages ONE tensor on the host at a time (it stacks nothing), counted by
    the reader itself (read buffers alive at once; torch's allocations are
    invisible to tracemalloc). Loading an f32 checkpoint into bf16 on the
    CPU, no param is a read buffer, so every buffer alive is staging."""
    from tests.test_loader import _write_sharded_checkpoint

    cfg = replace(get_config("llama", "tiny"), n_layers=8, vocab_size=8192)
    tensors = _write_sharded_checkpoint(tmp_path, cfg)
    total = sum(t.nbytes for t in tensors.values())
    largest = max(t.nbytes for t in tensors.values())
    safetensors.reset_stats()
    params = loader.load_hf_checkpoint(
        tmp_path, cfg, "llama", dtype=torch.bfloat16, device="cpu"
    )
    stats = safetensors.stats
    assert params["layers"][7]["w_gate"].shape == (cfg.dim, cfg.ffn_dim)
    assert stats.bytes_read == total and stats.tensors_read == len(tensors)
    assert stats.max_read_bytes == largest
    assert stats.peak_live_bytes == largest  # one tensor, never two
    assert stats.live_bytes == 0
    assert largest < total / 4  # the regime where the bound matters


# -- serving -------------------------------------------------------------------

USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially."),
    ("You are a PM.", "# Spec\nAcceptance: an integration test. " * 3),
]
SPEC = (
    "# Rate Limiter\n\nThe API MUST rate-limit each tenant to 100 requests "
    "per second.\n\n## Errors\nOver-limit requests get HTTP 429.\n"
)
HF_ALIASES = {
    "hf-dense": dict(),
    "hf-paged": dict(kv="paged"),
    "hf-int4": dict(quant="int4"),
    "hf-paged-int4": dict(kv="paged", quant="int4"),
}


@pytest.fixture
def hf_registry(checkpoints, tmp_path, monkeypatch):
    """The HF aliases in one registry file both packages read: llama
    tiny, f32, one device, on a bf16 checkpoint (so every leaf is cast)."""
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def hf_aliases(checkpoints, tmp_path, monkeypatch, hf_registry):
    path = tmp_path / "registry.json"
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    ckpt = str(checkpoints("llama", "bf16", sharded=True))
    for alias, extra in HF_ALIASES.items():
        registry.save_registry_entry(
            registry.ModelSpec(
                alias=alias, family="llama", size="tiny", dtype="float32",
                mesh={"dp": 1}, checkpoint=ckpt, **extra,
            )
        )
    for cfg in (ref_spec.config(), port_spec.config()):
        monkeypatch.setattr(cfg, "gamma", 8)
    return ckpt


@pytest.mark.parametrize("alias", sorted(HF_ALIASES))
def test_chat_on_hf_alias_matches_reference(hf_aliases, alias):
    sp = dict(max_new_tokens=24, greedy=True)
    ref = TpuEngine().chat(
        [RefChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], RefParams(**sp)
    )
    port = GpuEngine(device="cpu")
    got = port.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in USERS], SamplingParams(**sp))
    assert [c.ok for c in ref] == [True] * len(USERS), [c.error for c in ref]
    assert [c.ok for c in got] == [True] * len(USERS), [c.error for c in got]
    for r, g in zip(ref, got):
        assert g.text.encode() == r.text.encode()
        for field in ("input_tokens", "output_tokens", "cached_tokens"):
            assert getattr(g.usage, field) == getattr(r.usage, field)
    assert sum(c.usage.output_tokens for c in got) > 0
    lm = port._models[alias]
    assert lm.spec.checkpoint == hf_aliases
    assert (lm.batcher is not None) == (lm.spec.kv == "paged")
    wq = lm.params["layers"][0]["wq"]
    assert set(wq) == {"q4", "scale"} if "int4" in alias else wq.dtype == torch.float32


@pytest.mark.parametrize("alias", ["hf-dense", "hf-paged"])
def test_critique_on_hf_alias_matches_reference(hf_aliases, alias, tmp_path, monkeypatch, capsys):
    argv = ["critique", "--models", ",".join([f"tpu://{alias}"] * 2), "--greedy",
            "--max-new-tokens", "24", "--json"]
    (rc, rout, rerr), (pc, pout, perr) = sup.both_cli(argv, tmp_path, monkeypatch, capsys, SPEC)
    assert rc == pc == 0, (rerr, perr)
    ref_doc, port_doc = (
        sup.without_walls(sup.normalize_report(json.loads(o), pkg))
        for o, pkg in ((rout, "ref"), (pout, "port"))
    )
    assert [r["error"] for r in port_doc["results"]] == [None, None]
    assert port_doc["results"] == ref_doc["results"]
    for key in ("round", "all_agreed", "trace_id"):
        assert port_doc[key] == ref_doc[key], key
    for key in ("spec", "prefix_cache", "resilience"):
        assert port_doc["perf"][key] == ref_doc["perf"][key], key
    # Weight residency is the reference's: the same ledger report.
    assert port_doc["perf"]["weights"]["enabled"] is True
    assert port_doc["perf"]["weights"] == ref_doc["perf"]["weights"]


def test_checkpoint_load_chaos_matches_reference(hf_aliases, tmp_path, monkeypatch, capsys):
    """``bug@checkpoint_load:times=1``: the load fails once in both
    packages (same exit code, per-model errors and fault counts), and the
    next round serves."""
    argv = ["critique", "--models", "tpu://hf-dense", "--greedy", "--max-new-tokens",
            "8", "--json", "--chaos", "bug@checkpoint_load:times=1"]
    (rc, rout, rerr), (pc, pout, perr) = sup.both_cli(argv, tmp_path, monkeypatch, capsys, SPEC)
    assert pc == rc, (rerr, perr)
    ref_doc, port_doc = json.loads(rout), json.loads(pout)
    assert [r["error"] for r in port_doc["results"]] == [r["error"] for r in ref_doc["results"]]
    assert "checkpoint_load" in port_doc["results"][0]["error"]
    faults = port_doc["perf"]["resilience"]["faults"]
    assert faults == ref_doc["perf"]["resilience"]["faults"]
    assert faults == {"checkpoint_load.bug": 1}
    argv = argv[:-2]
    (rc, rout, rerr), (pc, pout, perr) = sup.both_cli(argv, tmp_path, monkeypatch, capsys, SPEC)
    assert rc == pc == 0, (rerr, perr)
    ref_doc, port_doc = json.loads(rout), json.loads(pout)
    assert [r["error"] for r in port_doc["results"]] == [None]
    assert port_doc["results"][0]["response"] == ref_doc["results"][0]["response"]
