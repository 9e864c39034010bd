"""The port's safetensors reader and writer, and its native checkpoint
cache.

Reader (``utils/safetensors.py``) against the ``safetensors`` package,
the yardstick (the port itself never imports it): every dtype code an HF
checkpoint uses, ``__metadata__``, tensors at offsets misaligned for their
dtype; files the port writes read back through ``safe_open``; each
malformed file refused, by both, with the port naming the file and the
tensor.

Cache (``engine/checkpoint.py``): the fingerprint (its own directory
beside the reference's ``.native-cache``; the transposed-head flag counts
for tied configs only; replaced weights change it), a round trip
bit-identical for full-precision, int8 and int4 params over several
files, layout checks, atomic saves; and through ``GpuEngine``: a second
load reads no HF tensor and is bit-identical, a truncated cache gives the
reference's warning and a reconversion, a failed write is a warning, and
one checkpoint directory serves both packages, each from its own cache.
"""

import json
import os
import struct
import time

import jax
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import checkpoint as ref_ckpt
from adversarial_spec_tpu.engine import loader as ref_loader
from adversarial_spec_tpu.engine import registry as ref_registry
from adversarial_spec_tpu.engine.tpu import TpuEngine
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu_torch.engine import checkpoint as ckpt_mod
from adversarial_spec_tpu_torch.engine import loader
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.models.transformer import init_params
from adversarial_spec_tpu_torch.ops.quant import quantize_params
from adversarial_spec_tpu_torch.resilience import faults, injector
from adversarial_spec_tpu_torch.utils import safetensors

from tests import torch_cli_support as sup
from tests import torch_hf_support as hf

safe = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file as ref_save_file  # noqa: E402

ALL_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _sample(dtype: torch.dtype, shape=(3, 5)) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 100).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g).to(dtype)


# -- reader and writer -----------------------------------------------------------


@pytest.mark.parametrize("code", sorted(ALL_DTYPES))
def test_reader_matches_safe_open(tmp_path, code):
    dtype = ALL_DTYPES[code]
    tensors = {"a": _sample(dtype), "scalar": _sample(dtype, ()), "empty": _sample(dtype, (0, 4))}
    path = tmp_path / "x.safetensors"
    ref_save_file(tensors, str(path), metadata={"format": "pt", "note": "x"})
    header = safetensors.read_header(path)
    assert {n: i.dtype for n, i in header.tensors.items()} == dict.fromkeys(tensors, code)
    with safe_open(str(path), framework="pt") as f:
        assert header.metadata == f.metadata()
        assert set(header.tensors) == set(f.keys())
        for name in f.keys():
            got = safetensors.read_tensor(path, name)
            want = f.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), name


@pytest.mark.parametrize("code", sorted(ALL_DTYPES))
def test_save_file_reads_back_through_safe_open(tmp_path, code):
    dtype = ALL_DTYPES[code]
    tensors = {
        "w": _sample(dtype, (4, 6)),
        "w_t": _sample(dtype, (6, 4)).t(),  # a strided view is written as laid out
        "scalar": _sample(dtype, ()),
        "empty": _sample(dtype, (0,)),
    }
    path = tmp_path / "y.safetensors"
    safetensors.save_file(tensors, path, metadata={"format": "pt"})
    (n,) = struct.unpack("<Q", path.read_bytes()[:8])
    assert n % 8 == 0  # the header is padded with spaces to 8 bytes
    with safe_open(str(path), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        for name, t in tensors.items():
            assert torch.equal(f.get_tensor(name), t.contiguous()), name
    for name, t in tensors.items():
        assert torch.equal(safetensors.read_tensor(path, name), t), name


def _write_raw(path, header: dict, data: bytes, pad: bytes = b"") -> None:
    raw = json.dumps(header).encode() + pad
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


def test_misaligned_offsets_read_as_safe_open_reads_them(tmp_path):
    """Tensors at offsets that are not a multiple of their element size
    (a U8 of 3 bytes first) are copied out, not viewed in place."""
    u8 = np.arange(3, dtype=np.uint8)
    f32 = np.array([1.5, -2.25, 3e-5], dtype=np.float32)
    f64 = np.array([np.pi, -np.e], dtype=np.float64)
    bf16 = torch.tensor([1.0, -3.5, 7.25], dtype=torch.bfloat16)
    blobs = [u8.tobytes(), f32.tobytes(), f64.tobytes(), bf16.view(torch.int16).numpy().tobytes()]
    names = [("u", "U8", [3]), ("f", "F32", [3]), ("d", "F64", [2]), ("b", "BF16", [3])]
    header, off = {"__metadata__": {"k": "v"}}, 0
    for (name, code, shape), blob in zip(names, blobs):
        header[name] = {"dtype": code, "shape": shape, "data_offsets": [off, off + len(blob)]}
        off += len(blob)
    path = tmp_path / "m.safetensors"
    _write_raw(path, header, b"".join(blobs), pad=b"   ")
    with safe_open(str(path), framework="pt") as f:
        for name, *_ in names:
            got = safetensors.read_tensor(path, name)
            assert torch.equal(got, f.get_tensor(name)), name
    assert torch.equal(safetensors.read_tensor(path, "b"), bf16)
    assert safetensors.read_header(path).metadata == {"k": "v"}


def _malformed(tmp_path, case: str):
    """A file broken in one way, and the words the port's error uses."""
    path = tmp_path / f"{case}.safetensors"
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}
    data = bytes(16)
    if case == "header_too_long":
        path.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
        return path, None, "exceeds the file"
    if case == "outside":
        _write_raw(path, {"a": a, "b": dict(b, data_offsets=[8, 24])}, data)
        return path, "b", "outside the data"
    if case == "overlap":
        _write_raw(path, {"a": a, "b": dict(b, data_offsets=[4, 12])}, data[:12])
        return path, "b", "overlaps"
    if case == "hole":
        _write_raw(path, {"a": a, "b": dict(b, data_offsets=[12, 20])}, bytes(20))
        return path, "b", "hole"
    if case == "bad_byte_count":
        _write_raw(path, {"a": a, "b": dict(b, shape=[3])}, data)
        return path, "b", "needs 12 bytes"
    if case == "unknown_dtype":
        _write_raw(path, {"a": a, "b": dict(b, dtype="F7")}, data)
        return path, "b", "unknown dtype"
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case", ["header_too_long", "outside", "overlap", "hole", "bad_byte_count", "unknown_dtype"]
)
def test_malformed_file_is_refused_naming_file_and_tensor(tmp_path, case):
    path, tensor, words = _malformed(tmp_path, case)
    with pytest.raises(safetensors.SafetensorsError) as ei:
        safetensors.read_header(path)
    msg = str(ei.value)
    assert str(path) in msg and words in msg, msg
    if tensor is not None:
        assert repr(tensor) in msg
    with pytest.raises(safetensors.SafetensorsError):
        safetensors.read_tensor(path, "a")
    with pytest.raises(Exception):  # the yardstick refuses it as well
        with safe_open(str(path), framework="pt") as f:
            [f.get_tensor(k) for k in f.keys()]


def test_reader_counts_host_staging(tmp_path):
    path = tmp_path / "s.safetensors"
    safetensors.save_file({"a": torch.zeros(100), "b": torch.zeros(10)}, path)
    safetensors.reset_stats()
    a = safetensors.read_tensor(path, "a")
    b = safetensors.read_tensor(path, "b")
    s = safetensors.stats
    assert (s.bytes_read, s.tensors_read, s.max_read_bytes) == (440, 2, 400)
    assert s.live_bytes == s.peak_live_bytes == 440
    del a
    assert s.live_bytes == 40
    del b
    assert s.live_bytes == 0 and s.peak_live_bytes == 440


# -- the cache -------------------------------------------------------------------


def test_cache_lives_apart_from_the_reference_cache():
    port = ckpt_mod.cache_dir_for("/x", "llama", "8b", "bfloat16")
    ref = ref_ckpt.cache_dir_for("/x", "llama", "8b", "bfloat16")
    assert port.parent.name == ".native-cache-torch"
    assert ref.parent.name == ".native-cache"
    assert port.parent.parent == ref.parent.parent


def test_fingerprint_distinguishes_configs():
    a = ckpt_mod.cache_dir_for("/x", "llama", "8b", "bfloat16")
    b = ckpt_mod.cache_dir_for("/x", "llama", "8b", "bfloat16", "int8")
    c = ckpt_mod.cache_dir_for("/x", "llama", "70b", "bfloat16")
    d = ckpt_mod.cache_dir_for("/x", "llama", "8b", "float32")
    assert len({a.name, b.name, c.name, d.name}) == 4
    assert a.parent == b.parent == c.parent == d.parent


def test_fingerprint_follows_the_transposed_head_flag_for_tied_configs(monkeypatch):
    kw = dict(dtype="bfloat16", tied_embeddings=True)
    monkeypatch.setenv("ADVSPEC_TRANSPOSED_HEAD", "1")
    tied_on = ckpt_mod.cache_dir_for("/x", "llama", "1b", **kw)
    untied_on = ckpt_mod.cache_dir_for("/x", "llama", "1b", "bfloat16")
    monkeypatch.setenv("ADVSPEC_TRANSPOSED_HEAD", "0")
    tied_off = ckpt_mod.cache_dir_for("/x", "llama", "1b", **kw)
    untied_off = ckpt_mod.cache_dir_for("/x", "llama", "1b", "bfloat16")
    assert tied_on.name != tied_off.name  # layout differs → new dir
    assert untied_on.name == untied_off.name  # same layout → same dir
    assert tied_off.name == untied_off.name  # both lack lm_head_t


def test_fingerprint_changes_when_weights_replaced(tmp_path):
    f = tmp_path / "model.safetensors"
    f.write_bytes(b"v1-weights")
    a = ckpt_mod.cache_dir_for(str(tmp_path), "llama", "8b", "bfloat16")
    f.write_bytes(b"v2-weights-longer")  # in-place update
    b = ckpt_mod.cache_dir_for(str(tmp_path), "llama", "8b", "bfloat16")
    assert a.name != b.name


def _params(family, quant, dtype=torch.float32):
    cfg = get_config(family, "tiny")
    p = init_params(cfg, device=torch.device("cpu"), dtype=dtype, seed=3)
    return (quantize_params(p, fmt=quant) if quant else p), cfg


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma2"])
def test_cache_round_trip_is_bit_identical(tmp_path, monkeypatch, family, quant):
    """Several files (a small file cap), each leaf back with its type: the
    model dtype, int8 q/q4 and f32 scales."""
    monkeypatch.setattr(ckpt_mod, "FILE_BYTES", 256 << 10)
    params, cfg = _params(family, quant, torch.bfloat16)
    cache = tmp_path / "n" / "fp"
    ckpt_mod.save_native(params, cache)
    assert ckpt_mod.has_native(cache)
    assert len(list(cache.glob("*.safetensors"))) > 1
    assert not [p for p in cache.parent.iterdir() if ".tmp-" in p.name]
    got = ckpt_mod.load_native(cache, cfg, torch.bfloat16, quant, torch.device("cpu"))
    want, have = ckpt_mod.flatten(params), ckpt_mod.flatten(got)
    assert list(have) == list(want)
    assert set(ckpt_mod.layout(cfg, torch.bfloat16, quant, True)) == set(want)
    for name, t in want.items():
        assert have[name].dtype == t.dtype and torch.equal(have[name], t), name


@pytest.mark.parametrize("mismatch", ["quant", "dtype", "t_head", "foreign_file"])
def test_cache_of_another_layout_is_refused(tmp_path, mismatch):
    params, cfg = _params("gemma2", "")
    cache = tmp_path / "fp"
    ckpt_mod.save_native(params, cache)
    kw = dict(dtype=torch.float32, quant="", transposed_head=True)
    if mismatch == "quant":
        kw["quant"] = "int8"
    elif mismatch == "dtype":
        kw["dtype"] = torch.bfloat16
    elif mismatch == "t_head":
        kw["transposed_head"] = False
    else:
        safetensors.save_file({"x": torch.zeros(2)}, cache / "zz.safetensors")
    with pytest.raises(ValueError):
        ckpt_mod.load_native(cache, cfg, kw["dtype"], kw["quant"], torch.device("cpu"),
                             transposed_head=kw["transposed_head"])


def test_save_sweeps_stale_abandoned_tmp(tmp_path):
    """A writer killed mid-save leaves its tmp dir; the next save removes
    day-old orphans but never a fresh sibling (a live writer's)."""
    parent = tmp_path / "n"
    parent.mkdir()
    stale, fresh = parent / "fp.tmp-999-aaaaaa", parent / "fp.tmp-998-bbbbbb"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 2 * 86400
    os.utime(stale, (old, old))
    ckpt_mod.save_native(_params("llama", "")[0], parent / "fp")
    assert not stale.exists() and fresh.exists()


def test_losing_the_rename_race_is_fine(tmp_path):
    params, cfg = _params("llama", "int4")
    cache = tmp_path / "fp"
    ckpt_mod.save_native(params, cache)
    ckpt_mod.save_native(params, cache)  # the directory exists: this writer lost
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fp"]
    ckpt_mod.load_native(cache, cfg, torch.float32, "int4", torch.device("cpu"))


# -- through the engines -----------------------------------------------------------


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def hf_ckpt(tmp_path, monkeypatch):
    """A tiny llama HF checkpoint (f32, sharded), and the registry file
    both packages read holding ``hf-tiny`` and ``hf-tiny-int4`` on it (f32,
    one device)."""
    reg = tmp_path / "registry.json"
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", reg)
    monkeypatch.setattr(registry, "REGISTRY_PATH", reg)
    ckpt = hf.write_checkpoint(hf.hf_model("llama"), tmp_path / "hf", "f32", sharded=True)
    for alias, quant in (("hf-tiny", ""), ("hf-tiny-int4", "int4")):
        registry.save_registry_entry(registry.ModelSpec(
            alias=alias, family="llama", size="tiny", checkpoint=str(ckpt),
            dtype="float32", mesh={"dp": 1}, quant=quant,
        ))
    return ckpt


def _chat(engine, alias="hf-tiny"):
    (c,) = engine.chat(
        [ChatRequest(f"tpu://{alias}", "s", "Review this spec.")],
        SamplingParams(max_new_tokens=8, greedy=True),
    )
    return c


def _cache(ckpt, quant=""):
    return ckpt_mod.cache_dir_for(str(ckpt), "llama", "tiny", "float32", quant)


@pytest.mark.parametrize("quant", ["", "int4"])
def test_second_load_reads_no_hf_tensor(hf_ckpt, monkeypatch, quant):
    alias = "hf-tiny-int4" if quant else "hf-tiny"
    eng = GpuEngine(device="cpu")
    first = _chat(eng, alias)
    assert first.ok, first.error
    cache = _cache(hf_ckpt, quant)
    assert ckpt_mod.has_native(cache)
    params1 = ckpt_mod.flatten(eng._models[alias].params)
    read = []
    real = safetensors.read_tensor
    monkeypatch.setattr(
        safetensors, "read_tensor", lambda path, *a, **k: read.append(path) or real(path, *a, **k)
    )
    eng2 = GpuEngine(device="cpu")
    second = _chat(eng2, alias)
    assert second.ok, second.error
    assert read and all(cache in p.parents for p in read)  # the cache only
    assert second.text == first.text
    params2 = ckpt_mod.flatten(eng2._models[alias].params)
    assert list(params2) == list(params1)
    for name, t in params1.items():
        assert params2[name].dtype == t.dtype and torch.equal(params2[name], t), name


def test_truncated_cache_warns_and_reconverts(hf_ckpt, capsys):
    first = _chat(GpuEngine(device="cpu"))
    cache = _cache(hf_ckpt)
    f = sorted(cache.glob("*.safetensors"))[0]
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])
    capsys.readouterr()
    again = _chat(GpuEngine(device="cpu"))
    assert again.ok and again.text == first.text
    err = capsys.readouterr().err
    assert "warning: native checkpoint cache unreadable" in err
    assert "reconverting from HF" in err and str(f) in err
    ckpt_mod.load_native(cache, get_config("llama", "tiny"), torch.float32, "",
                         torch.device("cpu"))  # rewritten whole
    assert not [p for p in cache.parent.iterdir() if ".tmp-" in p.name]


def test_failed_cache_write_is_a_warning(hf_ckpt, monkeypatch, capsys):
    def boom(params, cache_dir):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_native", boom)
    c = _chat(GpuEngine(device="cpu"))
    assert c.ok, c.error
    assert "warning: native checkpoint cache write failed: disk full" in capsys.readouterr().err
    assert not ckpt_mod.has_native(_cache(hf_ckpt))


def test_checkpoint_load_seam_fails_once_then_serves(hf_ckpt):
    injector.install(injector.FaultInjector(injector.parse_chaos_spec("bug@checkpoint_load:times=1")))
    eng = GpuEngine(device="cpu")
    c = _chat(eng)
    assert not c.ok and "checkpoint_load" in c.error and c.transient is False
    assert faults.snapshot() == {"checkpoint_load.bug": 1}
    assert _chat(eng).ok


def test_both_packages_keep_their_own_cache(hf_ckpt, monkeypatch):
    """One checkpoint directory served by both packages: each writes its
    own cache, neither touches the other's, and each reloads from its own
    without reading the HF files again."""
    req = dict(max_new_tokens=8, greedy=True)
    ref1 = TpuEngine().chat([RefChatRequest("tpu://hf-tiny", "s", "Review this spec.")],
                            RefParams(**req))[0]
    port1 = _chat(GpuEngine(device="cpu"))
    assert ref1.ok and port1.ok and port1.text == ref1.text
    ref_cache = ref_ckpt.cache_dir_for(str(hf_ckpt), "llama", "tiny", "float32", "")
    port_cache = _cache(hf_ckpt)
    assert ref_ckpt.has_native(ref_cache) and ckpt_mod.has_native(port_cache)
    before = {p: p.stat().st_mtime_ns for p in port_cache.rglob("*")}

    def boom(*a, **k):
        raise AssertionError("HF conversion ran despite the native cache")

    monkeypatch.setattr(ref_loader, "load_hf_checkpoint", boom)
    monkeypatch.setattr(loader, "load_hf_checkpoint", boom)
    ref2 = TpuEngine().chat([RefChatRequest("tpu://hf-tiny", "s", "Review this spec.")],
                            RefParams(**req))[0]
    port2 = _chat(GpuEngine(device="cpu"))
    assert ref2.ok and port2.ok, (ref2.error, port2.error)
    assert ref2.text == ref1.text and port2.text == port1.text
    assert ref_ckpt.has_native(ref_cache)
    assert {p: p.stat().st_mtime_ns for p in port_cache.rglob("*")} == before


def test_hf_params_equal_the_reference_through_the_engines(hf_ckpt):
    """The params ``GpuEngine`` serves from an HF alias are the
    reference's ``load_hf_checkpoint`` output, bit for bit."""
    assert _chat(GpuEngine(device="cpu")).ok
    eng = GpuEngine(device="cpu")
    eng._load("hf-tiny")  # from the cache now
    cfg, ref_cfg = hf.configs("llama")
    import jax.numpy as jnp

    ref = ref_loader.load_hf_checkpoint(hf_ckpt, ref_cfg, "llama", dtype=jnp.float32)
    hf.assert_bit_identical(eng._models["hf-tiny"].params, jax.tree.map(np.asarray, ref), cfg.n_layers)
