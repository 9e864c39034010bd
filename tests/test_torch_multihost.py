"""The port's multi-process launch against the reference's, on the CPU.

The launch contract: the reference's five cases run on both packages'
``maybe_initialize_distributed``, and the same environment must give the
same exception type and message; the managed-cluster branch (a
coordinator with neither count nor id) reads Slurm's or Open MPI's rank
and size, and names what it lacks; a missing peer fails the rendezvous
within the process group's timeout.

Then one pair of processes (``tests/torch_multihost_support.py``, the
reference's env contract, gloo on the CPU) runs every two-process case
once and writes its results to a JSON file:

- a psum over a dp=4 mesh of two CPU devices a process (sum 6.0), and a
  split tensor gathered back across processes;
- speculative greedy ``generate`` on that dp=4 mesh, on the reference's
  tiny f32 llama (``init_params(jax.random.key(0))``, passed as an
  ``.npz``; the children import no jax): tokens and ``n_generated`` equal
  the reference's single-device run and its in-process dp=4 mesh run;
- tp across processes (one CPU device a process): ``{"tp": 2}`` dense
  and paged, and ``{"dp": 2, "tp": 2}`` paged (two devices a process),
  each bit-identical to the port's single-process virtual mesh on the
  same params;
- the sp axis across processes, the ring's hop a send/receive and decode
  replicated over sp (each process at its decode rank): ``{"sp": 2}``
  dense with speculation, ``{"sp": 2, "tp": 2}`` dense, ``{"sp": 4}``
  dense (two sp ranks a process), ``{"sp": 2}`` paged and ``{"sp": 2,
  "tp": 2}`` paged on an int8 cache, each bit-identical to the
  single-process virtual mesh, and ``{"sp": 2, "tp": 2}`` also to the
  reference's in-process mesh; a layout whose decode rank lacks shards,
  refused by name;
- ``GpuEngine.chat`` on a spec with no mesh axis (dp=2 over the two
  processes, as the reference resolves it over ``jax.devices()``) and on
  a ``{"tp": 2}`` alias, equal to a single-process engine's over two
  devices;
- ``critique --json`` through ``cli.main`` on ``tpu://random-tiny``
  (dp=2 over the processes; the reference's weights), each process with
  its own HOME and sessions: both reports equal the reference CLI's,
  walls and trace ids masked.

Every case must take the ``dist`` way on both ranks and give both ranks
the same result. The mesh's layout rules (decode ranks, the refusals,
the split plans' shard counts) are also checked in one process.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import dispatch as ref_dispatch
from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.engine.speculative import GAMMA
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_get_config
from adversarial_spec_tpu.parallel import mesh as ref_mesh
from adversarial_spec_tpu.parallel.sharding import shard_params as jax_shard_params
from adversarial_spec_tpu_torch.engine import dispatch as port_dispatch
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.parallel import mesh as port_mesh
from adversarial_spec_tpu_torch.parallel.sharding import shard_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_cli_support as cli_sup  # noqa: E402
import torch_multihost_support as sup  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONTRACT = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
CLUSTER_VARS = tuple(v for _, r, s in port_mesh.CLUSTERS for v in (r, s))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the launch contract --------------------------------------------------------

# The reference's cases (tests/test_multihost.py): env → what it raises.
LAUNCH_CASES = {
    "no_contract": ({}, None),
    "pieces_without_coordinator": ({"JAX_NUM_PROCESSES": "2"}, "JAX_COORDINATOR_ADDRESS"),
    "coordinator_without_pid": (
        {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2"},
        "JAX_PROCESS_ID is not",
    ),
    "coordinator_without_num": (
        {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_PROCESS_ID": "0"},
        "JAX_NUM_PROCESSES is not",
    ),
    "non_integer_contract": (
        {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "two",
         "JAX_PROCESS_ID": "0"},
        "must be integers",
    ),
}


def _launch(package, monkeypatch, env: dict):
    """(exception type name, message) the package's
    ``maybe_initialize_distributed`` raises under ``env``, or None."""
    for k in CONTRACT + CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        package.maybe_initialize_distributed()
    except Exception as e:  # noqa: BLE001 - the outcome is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_launch_contract(package, case, monkeypatch):
    env, match = LAUNCH_CASES[case]
    got = _launch(ref_mesh if package == "reference" else port_mesh, monkeypatch, env)
    if match is None:
        assert got is None
    else:
        assert got is not None and got[0] == "RuntimeError" and match in got[1], got
    if package == "port":
        assert got == _launch(ref_mesh, monkeypatch, env)
    assert not port_mesh._initialized()


@pytest.mark.parametrize("cluster", ["slurm", "openmpi", "neither", "slurm_half"])
def test_managed_cluster_launch(cluster, monkeypatch):
    """A coordinator with neither count nor id: the rank and size of the
    managed cluster's launcher, or a RuntimeError naming what is
    lacking (the process group itself is not brought up here)."""
    env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"}
    env.update({
        "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "4"},
        "openmpi": {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"},
        "neither": {},
        "slurm_half": {"SLURM_PROCID": "3"},
    }[cluster])
    calls = []
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    got = _launch(port_mesh, monkeypatch, env)
    if cluster in ("slurm", "openmpi"):
        assert got is None
        [(backend, kw)] = calls
        assert backend == "gloo"  # no CUDA here: gloo only
        assert kw["init_method"] == "tcp://10.0.0.1:1234"
        assert (kw["rank"], kw["world_size"]) == ((3, 4) if cluster == "slurm" else (1, 2))
        assert kw["timeout"].total_seconds() == port_mesh.DIST_TIMEOUT_S
    elif cluster == "neither":
        assert got[0] == "RuntimeError" and not calls
        for name in ("JAX_NUM_PROCESSES", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"):
            assert name in got[1]
    else:
        assert got == ("RuntimeError",
                       "multi-host launch: Slurm's SLURM_NTASKS is not set beside SLURM_PROCID")


def test_missing_peer_fails_instead_of_hanging(tmp_path):
    """A whole contract for two processes with only one started: the
    rendezvous fails within the process group's timeout."""
    env = dict(os.environ, PYTHONPATH=str(REPO), ADVSPEC_DIST_TIMEOUT_S="3",
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="0")
    code = ("import sys\nsys.modules['jax'] = None\n"
            "from adversarial_spec_tpu_torch.parallel import mesh\n"
            "mesh.maybe_initialize_distributed()\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "timeout" in r.stderr.lower() or "timed out" in r.stderr.lower(), r.stderr[-2000:]


# -- two processes --------------------------------------------------------------


def _reference_params():
    jcfg = jax_get_config("llama", "tiny")
    jp = jax_tf.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    return jp, jcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# The f32 random-tiny with no mesh axis that the critique case serves
# (the reference's init weights in both packages).
CLI_TINY = registry.ModelSpec(alias="random-tiny", family="llama", size="tiny",
                              dtype="float32")


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """Both ranks' results (one launch of the pair for the whole file),
    the reference's params and rank 0's registry path (each rank's HOME
    holds the same registry)."""
    tmp = tmp_path_factory.mktemp("multihost")
    jp, _ = _reference_params()
    npz = tmp / "params.npz"
    np.savez(npz, **_flat(jax.tree.map(np.asarray, jp)))
    cli_registry = registry.save_registry_entry(CLI_TINY, tmp / "cli-registry.json")
    port = _free_port()
    procs, regs = [], []
    for rank in range(2):
        regs.append(registry.save_registry_entry(
            registry.ModelSpec(alias="mh-tp2", family="llama", size="tiny", dtype="float32",
                               mesh={"tp": 2}),
            tmp / f"home{rank}" / ".config" / "adversarial-spec-tpu" / "registry.json",
        ))
        cwd = tmp / f"rank{rank}"
        cwd.mkdir()
        env = dict(os.environ)
        for k in CLUSTER_VARS:
            env.pop(k, None)
        env.update(
            PYTHONPATH=str(REPO), HOME=str(tmp / f"home{rank}"), JAX_PLATFORMS="cpu",
            ADVSPEC_SESSIONS_DIR=str(tmp / f"sessions{rank}"),
            OMP_NUM_THREADS="1", ADVSPEC_DIST_TIMEOUT_S="120", ADVSPEC_KV_TIER="0",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_multihost_support.py"),
             str(tmp / f"rank{rank}.json"), str(npz), str(cli_registry)],
            env=env, cwd=str(cwd), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    results = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return results, jp, regs[0]


def test_two_process_distributed_psum(two_process):
    results, _, _ = two_process
    for rank, res in enumerate(results):
        assert (res["rank"], res["count"]) == (rank, 2)
        got = res["psum"]
        assert got["mesh"] == {"dp": 4, "sp": 1, "tp": 1}
        assert got["ranks"] == [0, 0, 1, 1]
        assert got["local_shards"] == [[2 * rank, 0], [2 * rank + 1, 0]]
        assert got["remote_cells_none"] == [rank == 1, rank == 1, rank == 0, rank == 0]
        assert got["sums"] == [6.0, 6.0]
        assert got["gathered"] == np.arange(24, dtype=np.float32).reshape(4, 6).tolist()
        assert got["dist"] > 0


def test_two_process_speculative_parity(two_process):
    """The reference's two-process shape: speculation on a dp=4 mesh
    across processes gives the reference's single-device tokens and its
    in-process dp=4 mesh's."""
    results, jp, _ = two_process
    _, jcfg = _reference_params()
    kw = dict(max_new_tokens=2 * GAMMA + 8, eos_ids=[], greedy=True)
    ref = jax_gen.generate(jp, jcfg, sup.SPEC_PROMPTS, speculative=False, **kw)
    jmesh = ref_mesh.make_mesh({"dp": 4})
    with jmesh:
        ref_mesh_out = jax_gen.generate(jax_shard_params(jmesh, jp), jcfg, sup.SPEC_PROMPTS,
                                        mesh=jmesh, speculative=True, **kw)
    np.testing.assert_array_equal(ref.tokens, ref_mesh_out.tokens)
    for res in results:
        got = res["spec dp4"]
        np.testing.assert_array_equal(np.asarray(got["tokens"]), ref.tokens)
        assert got["n_generated"] == ref.n_generated.tolist()
        assert got["n_generated"] == np.asarray(ref_mesh_out.n_generated).tolist()
        assert got["dist"] > 0


# The sp case that tests/test_torch_sp.py also holds to the reference's
# in-process mesh.
WITH_REFERENCE = ("sp2tp2 dense",)


@pytest.mark.parametrize("case", [c[0] for c in sup.CASES])
def test_two_process_mesh_equals_the_virtual_mesh(two_process, case):
    """tp across processes, dense and paged (W3's path), and dp=2×tp=2
    paged (W2's); the sp meshes across processes (B2's, W1's, W3's and
    W3-i8's paths, the ring's hops crossing): bit-identical to the
    single-process virtual mesh of as many CPU devices, and both ranks
    identical. Each sp rank decodes: a process that holds only sp
    rank 1 decodes there."""
    results, jp, _ = two_process
    _, spec, local, prompts, kw = next(c for c in sup.CASES if c[0] == case)
    torch.set_num_threads(1)
    cfg = get_config("llama", "tiny")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    mesh = port_mesh.make_mesh(spec, local * 2)
    want = gen.generate(shard_params(mesh, pp), cfg, prompts, mesh=mesh, page_size=16, **kw)
    for rank, res in enumerate(results):
        got = res[case]
        assert got["mesh"] == dict(mesh.shape)
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want.tokens)
        assert got["n_generated"] == want.n_generated.tolist()
        assert got["dist"] > 0
        if mesh.shape["sp"] > 1:
            assert got["decode_rank"] == rank * mesh.shape["sp"] // 2
            assert got["ring"]["calls"] > 0 and got["ring"]["crossed"] > 0
    if case in WITH_REFERENCE:
        jmesh = ref_mesh.make_mesh(spec, devices=jax.devices()[:mesh.size])
        jkw = {k: v for k, v in kw.items() if k != "paged"}
        with jmesh:
            ref = jax_gen.generate(jax_shard_params(jmesh, jp), _reference_params()[1], prompts,
                                   mesh=jmesh, **jkw)
        np.testing.assert_array_equal(want.tokens, np.asarray(ref.tokens))
        np.testing.assert_array_equal(want.n_generated, np.asarray(ref.n_generated))


@pytest.mark.parametrize("alias", sup.CHAT_ALIASES)
def test_two_process_chat_equals_one_process(two_process, alias, monkeypatch, tmp_path):
    """``GpuEngine.chat`` launched on two processes answers as one
    process's engine over two devices: the same mesh, the same text."""
    results, _, reg = two_process
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(registry, "REGISTRY_PATH", reg)
    torch.set_num_threads(1)
    engine = GpuEngine(device="cpu", devices=["cpu", "cpu"])
    want = engine.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in sup.CHAT_USERS],
                       SamplingParams(max_new_tokens=sup.CHAT_MAX_NEW, greedy=True))
    assert [c.error for c in want] == [None] * len(sup.CHAT_USERS)
    for res in results:
        got = res[f"chat {alias}"]
        assert got["errors"] == [None] * len(sup.CHAT_USERS)
        assert got["mesh"] == dict(engine._models[alias].mesh.shape)
        assert got["texts"] == [c.text for c in want]
        assert got["output_tokens"] == [c.usage.output_tokens for c in want]
        assert got["dist"] > 0


def test_undecodable_layout_is_refused(two_process):
    """{"sp": 3, "tp": 2} over two processes of three devices: process 1
    decodes at sp rank 1, where process 0 holds the tp=0 shard. Both
    ranks raise the same ValueError, naming the mesh and the ranks."""
    results, _, _ = two_process
    want = ("mesh {'dp': 1, 'sp': 3, 'tp': 2} across processes: process(es) [1] decode at "
            "sp rank 1 but hold 1 of its 2 (dp, tp) shards; process(es) [0] hold the rest "
            "and decode at sp rank(s) [0]")
    for res in results:
        assert res["layout refusal"] is not None
        assert res["layout refusal"].startswith(want), res["layout refusal"]


def _masked(doc, pkg):
    """A critique report without walls and trace ids."""
    doc = cli_sup.without_walls(cli_sup.normalize_report(doc, pkg))

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in ("trace_id", "span_id")}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(doc)


def test_two_process_critique_equals_the_reference_cli(two_process, tmp_path, monkeypatch,
                                                        capsys):
    """``critique --json`` launched one process a host (dp=2 over the
    processes, the debate layer in lockstep) reports on each process
    what the reference CLI reports for the same argv, walls and trace
    ids masked; the port's single-process CLI on a dp=2 virtual mesh
    too. The children run with the suite's KV tiers off, as the
    reference's CLI here does."""
    results, _, _ = two_process
    gen_iter = cli_sup.isolate_port(tmp_path, monkeypatch)
    next(gen_iter)
    try:
        registry.save_registry_entry(CLI_TINY, tmp_path / "registry.json")
        cli_sup.point_state(monkeypatch, "ref", tmp_path / "ref", tmp_path / "registry.json")
        lm = ref_dispatch.get_engine("tpu://random-tiny")._load("random-tiny")
        cfg = get_config("llama", "tiny")
        port = GpuEngine(device="cpu", devices=["cpu", "cpu"])
        port.install("random-tiny", shard_params(
            port.mesh_for(registry.resolve_model_spec("tpu://random-tiny")),
            params_from_jax(jax.tree.map(np.asarray, lm.params), cfg, "cpu", torch.float32)))
        port_dispatch.install_engine("tpu://random-tiny", port)
        (rc, rout, rerr), (pc, pout, perr) = cli_sup.both_cli(
            sup.CLI_ARGV, tmp_path, monkeypatch, capsys, sup.CLI_SPEC)
        assert rc == pc == 0, (rerr, perr)
        want = _masked(json.loads(rout), "ref")
        assert _masked(json.loads(pout), "port") == want
        assert [r["error"] for r in want["results"]] == [None, None]
        for res in results:
            got = res["critique"]
            assert got["code"] == 0
            assert got["mesh"] == {"dp": 2, "sp": 1, "tp": 1}
            assert got["dist"] > 0
            assert _masked(json.loads(got["stdout"]), "port") == want
    finally:
        next(gen_iter, None)


# -- the layout rules, in one process ------------------------------------------

# (mesh spec, devices of each process) → each process's decode rank and
# the decode shards a shared card plans for; or the refusal's words and
# the processes that raise it.
LAYOUTS = {
    "dp2": ({"dp": 2}, [1, 1], {0: 0, 1: 0}, 2),
    "sp2": ({"sp": 2}, [1, 1], {0: 0, 1: 1}, 1),
    "sp4 two a process": ({"sp": 4}, [2, 2], {0: 0, 1: 2}, 1),
    "sp2 tp8": ({"sp": 2, "tp": 8}, [8, 8], {0: 0, 1: 1}, 8),
    "dp2 sp2 four processes": ({"dp": 2, "sp": 2}, [1, 1, 1, 1], {0: 0, 1: 1, 2: 0, 3: 1}, 2),
    "sp3 tp2 refused": ({"sp": 3, "tp": 2}, [3, 3],
                        "mesh {'dp': 1, 'sp': 3, 'tp': 2} across processes: process(es) [1] "
                        "decode at sp rank 1 but hold 1 of its 2 (dp, tp) shards; process(es) "
                        "[0] hold the rest", (0, 1)),
    "undecoded blocks refused": ({"dp": 2, "sp": 2, "tp": 3}, [4, 4, 4],
                                 "mesh {'dp': 2, 'sp': 2, 'tp': 3} across processes: process 1 "
                                 "holds sp blocks of the (dp, tp) shard(s) [(0, 1), (0, 2)] but "
                                 "does not decode them", (0, 1, 2)),
    "uneven hosts refused": ({"dp": 2, "sp": 2}, [1, 3],
                             "mesh {'dp': 2, 'sp': 2, 'tp': 1} across processes: process 1 holds "
                             "sp blocks of the (dp, tp) shard(s) [(0, 0)]", (0, 1)),
    "a process without a device refused": ({"dp": 1}, [1, 1],
                                           "mesh {'dp': 1, 'sp': 1, 'tp': 1} holds no device of "
                                           "process(es) [1]", (1,)),
}


def _layout(spec, per_process, rank):
    """The mesh process ``rank`` builds when each process contributes
    ``per_process[i]`` devices (all on one host: one shared card). Its
    own are the CPU, every other process's the meta device, so a shard
    placed on another process's device shows."""
    n = sum(per_process)
    shape = port_mesh.mesh_shape_from_spec(spec, n)
    grid = (shape["dp"], shape["sp"], shape["tp"])
    total = grid[0] * grid[1] * grid[2]
    ranks = np.array([r for r, k in enumerate(per_process) for _ in range(k)][:total])
    devices = np.empty(total, dtype=object)
    devices[:] = [torch.device("cpu" if r == rank else "meta") for r in ranks]
    cards = np.full(total, "host:cpu", dtype=object)
    return port_mesh.Mesh(devices.reshape(grid), ranks.reshape(grid), cards.reshape(grid),
                          rank=rank)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_ranks_and_refusals(layout, monkeypatch):
    """Each process decodes at its lowest sp rank, on its own devices
    (its weights and a head's shard too); the decode collectives span
    the processes decoding at the same rank; a shared card plans for the
    decode shards at that rank (one process's virtual mesh's count); the
    layouts no process set can decode are refused by name, on every rank
    alike."""
    spec, per_process, *want = LAYOUTS[layout]
    monkeypatch.setattr(port_mesh, "process_group", lambda ranks: None)
    monkeypatch.setattr(port_mesh, "process_count", lambda: len(per_process))
    if isinstance(want[0], str):
        words, raising = want
        for rank in raising:
            with pytest.raises(ValueError, match="^" + re.escape(words)):
                _layout(spec, per_process, rank)
        return
    decode_ranks, card = want
    for rank in range(len(per_process)):
        mesh = _layout(spec, per_process, rank)
        assert mesh.decode_ranks == decode_ranks
        assert mesh.decode_rank == decode_ranks[rank]
        assert mesh.local_shards() and all(mesh.is_local(d, t) for d, t in mesh.local_shards())
        assert mesh.card_shards(*mesh.local_shards()[0]) == card
        peers = tuple(r for r, s in decode_ranks.items() if s == decode_ranks[rank])
        span = mesh.members()
        assert (None if span is None else span.ranks) == (peers if len(peers) > 1 else None)
        assert f"decode_ranks={decode_ranks}" in repr(mesh)
        params = shard_params(mesh, {"embed": torch.ones(4, 2), "lm_head": torch.ones(2, 8)})
        for d, t in mesh.local_shards():
            assert mesh.device(d, t).type == "cpu"
            assert {x.device.type for x in params.shard(d, t).values()} == {"cpu"}
        assert {x.device.type for x in params.shard().values()} == {"cpu"}


def test_ring_hop_to_a_silent_peer_fails_instead_of_hanging(tmp_path):
    """Two processes on an sp=2 mesh, one CPU device each: process 1
    joins the launch but never posts its hop. Process 0's ring shift
    fails within ``ADVSPEC_DIST_TIMEOUT_S`` instead of waiting forever."""
    port = _free_port()
    code = (
        "import sys, time\nsys.modules['jax'] = None\nimport torch\n"
        "from adversarial_spec_tpu_torch.parallel import collectives, mesh\n"
        "mesh.maybe_initialize_distributed()\n"
        "m = mesh.make_mesh({'sp': 2}, ['cpu'])\n"
        "if mesh.process_index() == 1:\n"
        "    time.sleep(60)\n"
        "else:\n"
        "    t = time.monotonic()\n"
        "    try:\n"
        "        collectives.ring_shift([torch.ones(4)], [0], m.sp_span(0, 0))\n"
        "    except Exception as e:\n"
        "        print('failed after', round(time.monotonic() - t, 1), type(e).__name__)\n"
        "        sys.stdout.flush()\n"
        "        import os\n"
        "        os._exit(3)\n"
    )
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), ADVSPEC_DIST_TIMEOUT_S="3",
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        for k in CLUSTER_VARS:
            env.pop(k, None)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        out = procs[0].communicate(timeout=90)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert procs[0].returncode == 3, out[-3000:]
    seconds = float(out.split("failed after")[1].split()[0])
    assert seconds < 30, out[-3000:]
