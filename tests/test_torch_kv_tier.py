"""The port's tiered KV cache against the reference's.

- The tier unit cases of ``tests/test_kv_tier.py`` (chain hashing, the
  host tier's LRU and conservation, the disk store's round trip,
  quarantine, concurrent writers and fuzz, the allocator's swap pins)
  run on both packages' ``kvtier`` as cases of one parametrised test.
- A disk-store entry is byte-identical across packages for f32 and bf16
  payloads (the port writes bf16 without ``ml_dtypes``), and each
  package reads the other's file.
- The paged batcher with tiers on and a small prefix-cache cap (host
  demotion, promotion), with a disk store on a fresh batcher
  (rehydration), under int8 KV, with a host entry lost between lookup
  and promotion, and with a ``kv_swap`` chaos fault: the same greedy
  tokens, ``cached_tokens``, prefill counts and ``kvtier`` counters as
  the reference's batcher on the same (bridged) f32 weights, and the
  same outcome for the faulted request. The port also rehydrates from a
  store the reference wrote (the two fingerprint a model the same way).
- The mock engine's tier accounting equals the reference mock's.

All tolerances are exact: tokens, counters and bytes.
"""

import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from adversarial_spec_tpu import obs as ref_obs
from adversarial_spec_tpu.engine import interleave as ref_interleave
from adversarial_spec_tpu.engine import kvcache as ref_kvcache
from adversarial_spec_tpu.engine import kvtier as ref_kvtier
from adversarial_spec_tpu.engine import mock as ref_mock
from adversarial_spec_tpu.engine import prefix_cache as ref_prefix
from adversarial_spec_tpu.engine import scheduler as ref_sched
from adversarial_spec_tpu.engine import spec as ref_spec
from adversarial_spec_tpu.engine.types import ChatRequest as RefChatRequest
from adversarial_spec_tpu.engine.types import SamplingParams as RefParams
from adversarial_spec_tpu.models import transformer as ref_tf
from adversarial_spec_tpu.models.config import get_config as ref_config
from adversarial_spec_tpu.obs.events import validate_event
from adversarial_spec_tpu.resilience import injector as ref_injector
from adversarial_spec_tpu_torch import obs as port_obs
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvcache as port_kvcache
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import mock as port_mock
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import scheduler as port_sched
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.resilience import injector as port_injector

SEQ = 1024
REPO = Path(__file__).resolve().parent.parent
KVTIER = {"ref": ref_kvtier, "port": port_kvtier}
KVCACHE = {"ref": ref_kvcache, "port": port_kvcache}
PKG = {
    "ref": (ref_kvtier, ref_prefix, ref_sched, ref_injector),
    "port": (port_kvtier, port_prefix, port_sched, port_injector),
}
PROMPT = [((i * 7) % 400) + 3 for i in range(96)]
WALLS = ("swap_in_s", "swap_out_s")


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Every knob these tests move, in both packages, restored after each
    test; speculation off as in the reference's tier tests."""
    for cfg, fields in (
        (ref_kvtier.config(), ("enabled", "host_mb", "store_dir", "flush_blocks")),
        (port_kvtier.config(), ("enabled", "host_mb", "store_dir", "flush_blocks")),
        (ref_prefix.config(), ("enabled", "max_pages")),
        (port_prefix.config(), ("enabled", "max_pages")),
        (ref_spec.config(), ("enabled",)),
        (port_spec.config(), ("enabled",)),
        (ref_interleave.config(), ("enabled", "pipeline_depth")),
        (port_interleave.config(), ("enabled",)),
    ):
        for f in fields:
            monkeypatch.setattr(cfg, f, getattr(cfg, f))
    ref_spec.configure(enabled=False)
    port_spec.configure(enabled=False)
    ref_interleave.configure(enabled=True, pipeline_depth=2)
    port_interleave.configure(enabled=True)
    for kv in KVTIER.values():
        kv.reset_stats()
    yield
    for inj in (ref_injector, port_injector):
        inj.install(None)


@pytest.fixture(params=["ref", "port"])
def kv(request):
    return KVTIER[request.param]


def _np(x) -> np.ndarray:
    """A payload array as numpy (a bf16 tensor through f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(x.dtype)


# -- unit cases, both packages ---------------------------------------------


def test_chain_hash_deterministic_parent_sensitive_and_shared(kv):
    a = kv.chain_hash("", (1, 2, 3))
    assert a == kv.chain_hash("", (1, 2, 3))
    assert a != kv.chain_hash("", (1, 2, 4))
    assert kv.chain_hash(a, (9,)) != kv.chain_hash("", (9,))
    # The mock's 4-char-chunk tokens address the same way, and both
    # packages give every chain the same address (the store's key).
    assert kv.chain_hash("", ("abcd", "efgh")) == ref_kvtier.chain_hash(
        "", ("abcd", "efgh")
    )
    assert kv.fingerprint("m", 16) == ref_kvtier.fingerprint("m", 16)


def test_host_tier_lru_eviction_and_conservation(kv):
    h = kv.HostTier(capacity_bytes=300, block_bytes=100)
    assert h.put("a", (1,), None) == []
    assert h.put("b", (2,), None) == []
    h.get("a")  # refresh: b becomes LRU
    assert h.put("c", (3,), None) == []
    evicted = h.put("d", (4,), None)
    assert [b.chain for b in evicted] == ["b"]
    h.note_freed(len(evicted))
    h.check_invariants()


def test_host_tier_take_promoted_is_terminal(kv):
    h = kv.HostTier(capacity_bytes=1000, block_bytes=100)
    h.put("a", (1, 2), None)
    assert h.take_promoted("a").chain == "a"
    assert h.get("a") is None
    assert h.take_promoted("a") is None  # idempotent miss
    h.check_invariants()


def test_host_tier_conservation_violation_detected(kv):
    h = kv.HostTier(capacity_bytes=1000, block_bytes=100)
    h.put("a", (1,), None)
    del h._blocks["a"]  # corrupt: vanished without a terminal state
    with pytest.raises(RuntimeError, match="conservation"):
        h.check_invariants()


def test_single_block_over_budget_demotes_without_crash(kv):
    tiers = kv.TieredStore(kv.HostTier(capacity_bytes=10, block_bytes=100), None)
    tiers.demote("a", (1, 2), lambda: {"k": np.zeros(2)})  # must not raise
    assert tiers.host_resident == 0
    assert kv.stats.host_freed_blocks == 1
    tiers.check_invariants()


def test_lazy_payload_materializes_once(kv):
    calls = []

    def lazy():
        calls.append(1)
        return {"k": np.zeros(2)}

    h = kv.HostTier(capacity_bytes=1000, block_bytes=100)
    h.put("a", (1,), lazy)
    b = h.get("a")
    assert kv.HostTier.materialize(b) is kv.HostTier.materialize(b)
    assert calls == [1]


def _store(kv, tmp_path, fp="fp-a"):
    return kv.DiskStore(str(tmp_path / "store"), fp)


def test_disk_roundtrip_preserves_dtype_and_shape(kv, tmp_path):
    s = _store(kv, tmp_path)
    payload = {
        "k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "v": np.ones((2, 2), np.int8),
    }
    chain = kv.chain_hash("", (5, 6))
    assert s.put(chain, (5, 6), payload)
    assert not s.put(chain, (5, 6), payload)  # idempotent
    toks, got = s.get(chain, (5, 6))
    assert toks == (5, 6)
    assert _dtype_name(got["k"]) == "float32" and tuple(got["k"].shape) == (2, 3, 4)
    assert np.array_equal(_np(got["k"]), payload["k"])
    assert _dtype_name(got["v"]) == "int8"


def test_disk_no_tmp_orphan_after_put(kv, tmp_path):
    s = _store(kv, tmp_path)
    s.put(kv.chain_hash("", (1,)), (1,), None)
    assert [p for p in (tmp_path / "store").rglob("*") if ".tmp" in p.name] == []


def test_disk_fingerprint_namespaces(kv, tmp_path):
    a = _store(kv, tmp_path, "fp-a")
    chain = kv.chain_hash("", (1,))
    a.put(chain, (1,), None)
    assert not _store(kv, tmp_path, "fp-b").has(chain)


def test_disk_token_mismatch_quarantines(kv, tmp_path):
    s = _store(kv, tmp_path)
    chain = kv.chain_hash("", (1, 2))
    s.put(chain, (1, 2), None)
    kv.reset_stats()
    assert s.get(chain, (9, 9)) is None
    assert kv.stats.store_corrupt == 1
    assert s.resident_entries == 0 and not s.has(chain)
    assert list((tmp_path / "store").rglob("quarantine/*.kvb"))


def test_disk_corrupt_payload_quarantines_and_store_survives(kv, tmp_path):
    s = _store(kv, tmp_path)
    c1, c2 = kv.chain_hash("", (1,)), kv.chain_hash("", (2,))
    s.put(c1, (1,), {"k": np.arange(8, dtype=np.float32)})
    s.put(c2, (2,), {"k": np.arange(8, dtype=np.float32)})
    path = s._path(c1)
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF  # flip a payload byte: sha must catch it
    open(path, "wb").write(bytes(raw))
    kv.reset_stats()
    assert s.get(c1, (1,)) is None
    assert kv.stats.store_corrupt == 1
    assert s.get(c2, (2,)) is not None
    assert s.resident_entries == 1


def test_disk_restart_rescan_counts_entries(kv, tmp_path):
    s = _store(kv, tmp_path)
    for i in range(3):
        s.put(kv.chain_hash("", (i,)), (i,), None)
    assert _store(kv, tmp_path).resident_entries == 3


def _race(kv, stores, n_threads, payload):
    chain = kv.chain_hash("", (7, 8, 9))
    barrier = threading.Barrier(n_threads)
    errors: list[BaseException] = []

    def write(store):
        try:
            barrier.wait(timeout=10)
            for _ in range(5):
                store.put(chain, (7, 8, 9), payload)
        except BaseException as e:  # pragma: no cover - fail loudly
            errors.append(e)

    threads = [
        threading.Thread(target=write, args=(stores[i % len(stores)],))
        for i in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errors == []
    return chain


def _check_one_valid_entry(kv, tmp_path, stores, chain, payload):
    kv.reset_stats()
    root = tmp_path / "store"
    entries = [p for p in root.rglob("*.kvb") if "quarantine" not in p.parts]
    assert len(entries) == 1
    assert not list(root.rglob("quarantine/*"))
    assert not [p for p in root.rglob("*") if ".tmp" in p.name]
    for s in stores:
        toks, got = s.get(chain, (7, 8, 9))
        assert toks == (7, 8, 9)
        assert np.array_equal(_np(got["k"]), payload["k"])
        assert s.resident_entries <= s._scan() == 1
    assert kv.stats.store_corrupt == 0


@pytest.mark.parametrize("writers", ["threads", "instances", "processes"])
def test_disk_concurrent_writers_leave_one_valid_entry(kv, tmp_path, writers):
    """Writers racing one chain — threads of one store, two instances over
    one directory, or two processes — end with exactly one valid entry."""
    payload = {"k": np.arange(64, dtype=np.float32)}
    if writers == "processes":
        script = (
            "import sys, os, time\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import numpy as np\n"
            f"from {kv.__name__.rsplit('.', 1)[0]} import kvtier\n"
            "root, ready, go = sys.argv[2], sys.argv[3], sys.argv[4]\n"
            "store = kvtier.DiskStore(root, 'fp-a')\n"
            "chain = kvtier.chain_hash('', (7, 8, 9))\n"
            "open(ready, 'w').close()\n"
            "deadline = time.time() + 60\n"
            "while not os.path.exists(go):\n"
            "    if time.time() > deadline:\n"
            "        sys.exit(3)\n"
            "    time.sleep(0.001)\n"
            "for _ in range(5):\n"
            "    store.put(chain, (7, 8, 9), {'k': np.arange(64, dtype=np.float32)})\n"
        )
        go, procs, readies = tmp_path / "go", [], []
        for i in range(2):
            ready = tmp_path / f"ready-{i}"
            readies.append(ready)
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-c", script, str(REPO),
                     str(tmp_path / "store"), str(ready), str(go)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
            )
        deadline = time.time() + 60
        while not all(r.exists() for r in readies):
            assert time.time() < deadline, "children never reached rendezvous"
            assert all(p.poll() is None for p in procs), procs[0].communicate()
            time.sleep(0.005)
        go.touch()
        outs = [p.communicate(timeout=60) for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        stores = [_store(kv, tmp_path)]
        chain = kv.chain_hash("", (7, 8, 9))
    else:
        n = 1 if writers == "threads" else 2
        stores = [_store(kv, tmp_path) for _ in range(n)]
        chain = _race(kv, stores, n_threads=8, payload=payload)
    _check_one_valid_entry(kv, tmp_path, stores, chain, payload)
    if writers == "threads":
        assert stores[0].resident_entries == 1  # counted exactly once


def test_disk_fuzz_against_oracle(kv, tmp_path):
    """Random writes, rehydrations and corruptions agree with an oracle
    dict at every step: a corrupted entry reads as a miss, never data."""
    rng = random.Random(0)
    s = kv.DiskStore(str(tmp_path / "store"), "fuzz")
    oracle: dict[str, tuple] = {}
    for step in range(200):
        op = rng.random()
        if op < 0.5 or not oracle:
            toks = tuple(rng.randrange(100) for _ in range(4))
            chain = kv.chain_hash("", toks + (step,))
            payload = (
                {"k": np.full((2, 2), step, np.float32)} if rng.random() < 0.5 else None
            )
            s.put(chain, toks, payload)
            oracle[chain] = (toks, None if payload is None else payload["k"].copy())
        elif op < 0.85:
            chain = rng.choice(list(oracle))
            toks, want = oracle[chain]
            got = s.get(chain, toks)
            assert got is not None and got[0] == toks
            if want is None:
                assert got[1] is None
            else:
                assert np.array_equal(_np(got[1]["k"]), want)
        else:
            chain = rng.choice(list(oracle))
            raw = bytearray(open(s._path(chain), "rb").read())
            raw[rng.randrange(len(raw))] ^= 0xFF
            open(s._path(chain), "wb").write(bytes(raw))
            del oracle[chain]
            assert s.get(chain, None) is None
        assert s.resident_entries == len(oracle)
    assert kv.stats.store_corrupt > 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", ["unallocated", "free_under_pin", "unpin", "freed"])
def test_allocator_swap_pins(pkg, case):
    a = KVCACHE[pkg].PageAllocator(4, 4)
    if case == "unallocated":
        with pytest.raises(ValueError, match="unallocated"):
            a.swap_pin(0)
        return
    a.new_sequence(0)
    [p] = a.extend(0, 4)
    if case == "free_under_pin":
        a.swap_pin(p)
        with pytest.raises(RuntimeError, match="swap in flight"):
            a.free_sequence(0)
        a.swap_unpin(p)
        a.check_invariants()
    elif case == "unpin":
        with pytest.raises(RuntimeError, match="without pin"):
            a.swap_unpin(p)
    else:
        # Corrupt: the page freed while a swap pin is outstanding.
        a._swap_pins[p] = 1
        a._tables[0] = []
        a._lengths[0] = 0
        a._refs.pop(p)
        a._free.append(p)
        with pytest.raises(RuntimeError, match="swap-pinned"):
            a.check_invariants()


# -- the on-disk entry across packages --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_entry_byte_identical_and_cross_readable(tmp_path, dtype):
    """The same chain, tokens and payload (int8 K/V pages beside f32 scale
    pages, or bf16 pages) make byte-identical entry files in both
    packages, and each package reads the other's file back exactly."""
    rng = np.random.default_rng(0)
    shape = (2, 1, 2, 16, 8)
    if dtype == "float32":
        ref_payload = {
            "k": rng.integers(-127, 128, size=shape).astype(np.int8),
            "v": rng.integers(-127, 128, size=shape).astype(np.int8),
            "ks": rng.random(shape[:-1] + (1,)).astype(np.float32),
            "vs": rng.random(shape[:-1] + (1,)).astype(np.float32),
        }
        port_payload = {k: torch.from_numpy(v.copy()) for k, v in ref_payload.items()}
    else:
        bits = {k: rng.integers(0, 1 << 16, size=shape).astype(np.uint16) for k in "kv"}
        # Finite bf16 values only (exponent below all-ones).
        bits = {k: b & np.uint16(0xBF7F) for k, b in bits.items()}
        ref_payload = {k: b.view(ml_dtypes.bfloat16) for k, b in bits.items()}
        port_payload = {
            k: torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
            for k, b in bits.items()
        }
    tokens = tuple(range(16))
    chain = ref_kvtier.chain_hash(ref_kvtier.chain_hash("", tokens), tokens)
    ref_store = ref_kvtier.DiskStore(str(tmp_path / "ref"), "fp")
    port_store = port_kvtier.DiskStore(str(tmp_path / "port"), "fp")
    assert ref_store.put(chain, tokens, ref_payload)
    assert port_store.put(chain, tokens, port_payload)
    ref_file, port_file = Path(ref_store._path(chain)), Path(port_store._path(chain))
    assert port_file.read_bytes() == ref_file.read_bytes()
    # Each package reads the other's store.
    toks, got_ref = ref_kvtier.DiskStore(str(tmp_path / "port"), "fp").get(chain, tokens)
    toks2, got_port = port_kvtier.DiskStore(str(tmp_path / "ref"), "fp").get(chain, tokens)
    assert toks == toks2 == tokens
    for k in ref_payload:
        r = np.asarray(got_ref[k])
        if dtype == "bfloat16":
            assert r.dtype == ml_dtypes.bfloat16
            assert got_port[k].dtype == torch.bfloat16
            assert np.array_equal(r.view(np.uint16), bits[k])
            assert np.array_equal(got_port[k].view(torch.int16).numpy().view(np.uint16), bits[k])
        else:
            assert np.array_equal(r, ref_payload[k]) and r.dtype == ref_payload[k].dtype
            assert torch.equal(got_port[k], port_payload[k])


def test_port_store_reads_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` (and jax) cannot be imported, the
    port writes and reads back a bf16 entry."""
    script = (
        "import sys\n"
        "for m in ('jax', 'ml_dtypes', 'adversarial_spec_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import torch\n"
        "from adversarial_spec_tpu_torch.engine import kvtier\n"
        "s = kvtier.DiskStore(sys.argv[1], 'fp')\n"
        "x = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)\n"
        "c = kvtier.chain_hash('', (1, 2))\n"
        "assert s.put(c, (1, 2), {'k': x})\n"
        "toks, got = s.get(c, (1, 2))\n"
        "assert toks == (1, 2) and got['k'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['k'], x)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "s")],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- the batcher with tiers, against the reference --------------------------


@pytest.fixture(scope="module")
def llama():
    # A 1024-token context: the batchers' page tables (and the CPU gather
    # path's dense windows) are sized by it; every prompt here fits.
    cfg = ref_config("llama", "tiny", max_seq_len=SEQ)
    params = ref_tf.init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    pcfg = get_config("llama", "tiny", max_seq_len=SEQ)
    tp = params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu", torch.float32)
    return {"ref": (params, cfg), "port": (tp, pcfg)}


def _batcher(pkg, llama, **kw):
    params, cfg = llama[pkg]
    kw.setdefault("max_batch", 2)
    return PKG[pkg][2].ContinuousBatcher(
        params, cfg, max_new_cap=8, page_size=16, prefix_cache=True, **kw
    )


def _drain(pkg, b, prompts):
    sched = PKG[pkg][2]
    for i, p in enumerate(prompts):
        b.submit(sched.SchedRequest(req_id=i, prompt_ids=list(p), max_new_tokens=8))
    return b.run_all()


def _rounds(pkg, llama, *, rounds, cap_pages, kv_dtype="", batcher=None):
    """A growing-prompt workload (two requests per round) through one
    batcher: per-round tokens, cached tokens and prefilled tokens."""
    kvtier, prefix = PKG[pkg][0], PKG[pkg][1]
    prefix.configure(enabled=True, max_pages=cap_pages)
    b = batcher or _batcher(pkg, llama, kv_dtype=kv_dtype)
    doc, out = list(PROMPT), []
    for r in range(rounds):
        before = prefix.stats.prefilled_tokens
        res = _drain(pkg, b, [doc, doc])
        out.append(
            (
                [x.tokens.tolist() for x in res],
                [x.cached_tokens for x in res],
                prefix.stats.prefilled_tokens - before,
            )
        )
        doc = doc + [((r * 13 + k) % 400) + 3 for k in range(16)]
        b.allocator.check_invariants()
        if b.tiers is not None:
            b.tiers.check_invariants()
    return out, b


def _snap(pkg) -> dict:
    snap = PKG[pkg][0].snapshot()
    for f in WALLS + ("store_dir",):
        snap.pop(f)
    return snap


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8kv"])
def test_host_tier_round_matches_reference(llama, kv_dtype):
    """Page-cap pressure over two rounds: the evicted prefix blocks demote
    to host RAM and promote back. Tokens, cached tokens, prefilled tokens
    and the tier counters equal the reference's; tokens equal a tier-off
    run of the port, which re-prefills more."""
    got = {}
    for pkg in ("ref", "port"):
        PKG[pkg][0].configure(enabled=True, host_mb=16, store_dir="")
        got[pkg] = _rounds(pkg, llama, rounds=2, cap_pages=3, kv_dtype=kv_dtype)[0]
    assert got["port"] == got["ref"]
    assert _snap("port") == _snap("ref")
    snap = _snap("port")
    assert snap["demoted_blocks"] > 0 and snap["promoted_tokens"] > 0
    assert snap["host_hit_rate"] > 0
    port_kvtier.configure(enabled=False)
    off, _ = _rounds("port", llama, rounds=2, cap_pages=3, kv_dtype=kv_dtype)
    assert [r[0] for r in off] == [r[0] for r in got["port"]]
    assert sum(r[2] for r in got["port"]) < sum(r[2] for r in off)


def test_demoted_payload_layout_matches_the_pool(llama):
    """A demoted block's payload is an independent copy of its page in the
    reference's layout ([L, 1, Hkv, page, D] per pool key, int8 scales
    included): rewriting the pool afterwards leaves it unchanged."""
    port_kvtier.configure(enabled=True, host_mb=16, store_dir="")
    port_prefix.configure(enabled=True, max_pages=0)
    b = _batcher("port", llama, kv_dtype="int8")
    _drain("port", b, [PROMPT])
    page = next(iter(b.prefix_cache._by_page))
    fetch = b._fetch_page_kv(page, 16)
    want = {k: v[:, page + 1, :, :16].unsqueeze(1).clone() for k, v in b.pool.items()}
    for v in b.pool.values():
        v[:, page + 1] = 0
    got = fetch()
    assert set(got) == {"k", "v", "ks", "vs"}
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_disk_rehydration_in_a_fresh_batcher_matches_reference(llama, tmp_path):
    """Round 1 writes the prompt's blocks through to each package's store;
    a FRESH batcher over the same store rehydrates them. Both packages
    give the reference's tokens, cached tokens and counters; the fresh
    port batcher also rehydrates from the store the REFERENCE wrote, with
    the same tokens."""
    got = {}
    for pkg in ("ref", "port"):
        kvtier = PKG[pkg][0]
        kvtier.configure(enabled=True, host_mb=16, store_dir=str(tmp_path / pkg))
        _rounds(pkg, llama, rounds=1, cap_pages=0)
        kvtier.reset_stats()
        got[pkg] = _rounds(pkg, llama, rounds=1, cap_pages=0)[0]
    assert got["port"] == got["ref"]
    assert _snap("port") == _snap("ref")
    assert _snap("port")["rehydrated_tokens"] > 0
    port_kvtier.configure(enabled=True, host_mb=16, store_dir=str(tmp_path / "ref"))
    port_kvtier.reset_stats()
    cross = _rounds("port", llama, rounds=1, cap_pages=0)[0]
    assert cross == got["ref"]
    assert port_kvtier.stats.rehydrated_tokens == ref_kvtier.stats.rehydrated_tokens


def test_lost_race_degrades_to_prefill_as_reference(llama):
    """A host entry evicted between lookup and promotion falls back to
    prefill with the tokens unchanged, in both packages alike."""
    out = {}
    for pkg in ("ref", "port"):
        kvtier, prefix = PKG[pkg][0], PKG[pkg][1]
        kvtier.configure(enabled=True, host_mb=16, store_dir="")
        prefix.configure(enabled=True, max_pages=3)
        b = _batcher(pkg, llama)
        first = _drain(pkg, b, [PROMPT])
        assert b.tiers.host_resident > 0
        b.tiers.host.clear()  # the race: entries vanish after lookups saw them
        again = _drain(pkg, b, [PROMPT])
        assert again[0].tokens.tolist() == first[0].tokens.tolist()
        b.allocator.check_invariants()
        b.tiers.check_invariants()
        out[pkg] = (first[0].tokens.tolist(), again[0].cached_tokens)
    assert out["port"] == out["ref"]
    assert _snap("port") == _snap("ref")


def test_chaos_kv_swap_fails_only_the_waiting_request(llama, tmp_path):
    """``kv_swap`` injected mid-promotion (after one block promoted): one
    request faults (``bug``, no requeue) at seam ``kv_swap``, its
    co-resident finishes with the reference's tokens, both tiers stay
    invariant-clean, and the fault's auto-dump holds the swap and fault
    events, schema-valid."""
    res = {}
    for pkg in ("ref", "port"):
        kvtier, prefix, _, injector = PKG[pkg]
        kvtier.configure(enabled=True, host_mb=16, store_dir="")
        prefix.configure(enabled=True, max_pages=3)
        b = _batcher(pkg, llama)
        _drain(pkg, b, [PROMPT])
        assert b.tiers.host_resident > 0
        injector.install(
            injector.FaultInjector(injector.parse_chaos_spec("bug@kv_swap:after=1:times=1"))
        )
        obs = port_obs if pkg == "port" else ref_obs
        saved = obs.config().events_out
        (tmp_path / pkg).mkdir()
        obs.configure(events_out=str(tmp_path / pkg / "ev.jsonl"))
        try:
            out = _drain(pkg, b, [PROMPT, PROMPT])
        finally:
            injector.install(None)
            obs.configure(events_out=saved)
        b.allocator.check_invariants()
        b.tiers.check_invariants()
        res[pkg] = [(r.req_id, r.fault_kind, r.tokens.tolist()) for r in out]
        faulted = [r for r in out if r.error]
        assert len(faulted) == 1 and faulted[0].fault_kind == "bug"
        assert "kv_swap" in faulted[0].error
        events = [
            json.loads(line)
            for line in (tmp_path / pkg / "ev.fault.jsonl").read_text().splitlines()
        ]
        assert all(validate_event(e) == [] for e in events)
        assert any(e["type"] == "swap" for e in events)
        assert any(e["type"] == "fault" and e["seam"] == "kv_swap" for e in events)
    assert res["port"] == res["ref"]


# -- the mock engine's tier accounting ---------------------------------------

DOC = (
    "The allocator SHALL bound page reuse by refcount. "
    "Demoted blocks MUST reach exactly one terminal state. "
) * 40


def _mock_round(pkg, eng, rnd):
    req, params = (RefChatRequest, RefParams) if pkg == "ref" else (ChatRequest, SamplingParams)
    user = f"--- DOCUMENT ---\n{DOC}\n--- END DOCUMENT ---\nDebate round {rnd}"
    return eng.chat(
        [req(model="mock://critic", system="You are a critic.", user=user)] * 2,
        params(),
    )


@pytest.mark.parametrize("store", [False, True], ids=["host", "host+disk"])
def test_mock_tier_accounting_matches_reference(tmp_path, store):
    """Two rounds on one mock engine under a page cap (demote, promote),
    then a fresh engine over the same store (rehydrate): the same texts,
    cached tokens and tier counters as the reference mock."""
    got = {}
    for pkg, mod in (("ref", ref_mock), ("port", port_mock)):
        kvtier, prefix = PKG[pkg][0], PKG[pkg][1]
        kvtier.configure(
            enabled=True, host_mb=16, store_dir=str(tmp_path / pkg) if store else ""
        )
        prefix.configure(enabled=True, max_pages=16)
        prefix.reset_stats()
        kvtier.reset_stats()
        rounds = []
        for eng in (mod.MockEngine(), mod.MockEngine()):
            for rnd in (1, 2):
                rounds.append(
                    [(c.text, c.usage.cached_tokens) for c in _mock_round(pkg, eng, rnd)]
                )
            eng._prefix.tiers.check_invariants()
        got[pkg] = (rounds, _snap(pkg))
    assert got["port"] == got["ref"]
    snap = got["port"][1]
    assert snap["demoted_blocks"] > 0 and snap["promoted_tokens"] > 0
    if store:
        assert snap["rehydrated_tokens"] > 0 and snap["store_writes"] > 0
