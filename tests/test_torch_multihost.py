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
- ``GpuEngine.chat`` on a spec with no mesh axis (dp=2 over the two
  processes, as the reference resolves it over ``jax.devices()``) and on
  a ``{"tp": 2}`` alias, equal to a single-process engine's over two
  devices;
- an sp axis across processes, refused by name.

Every case must take the ``dist`` way on both ranks and give both ranks
the same result.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.engine.speculative import GAMMA
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_get_config
from adversarial_spec_tpu.parallel import mesh as ref_mesh
from adversarial_spec_tpu.parallel.sharding import shard_params as jax_shard_params
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine import registry
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.parallel import mesh as port_mesh
from adversarial_spec_tpu_torch.parallel.sharding import shard_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
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


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """Both ranks' results (one launch of the pair for the whole file),
    the reference's params and the shared HOME's registry path."""
    tmp = tmp_path_factory.mktemp("multihost")
    jp, _ = _reference_params()
    npz = tmp / "params.npz"
    np.savez(npz, **_flat(jax.tree.map(np.asarray, jp)))
    home = tmp / "home"
    reg = registry.save_registry_entry(
        registry.ModelSpec(alias="mh-tp2", family="llama", size="tiny", dtype="float32",
                           mesh={"tp": 2}),
        home / ".config" / "adversarial-spec-tpu" / "registry.json",
    )
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        for k in CLUSTER_VARS:
            env.pop(k, None)
        env.update(
            PYTHONPATH=str(REPO), HOME=str(home), JAX_PLATFORMS="cpu",
            OMP_NUM_THREADS="1", ADVSPEC_DIST_TIMEOUT_S="120",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_multihost_support.py"),
             str(tmp / f"rank{rank}.json"), str(npz)],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
    return results, jp, reg


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


@pytest.mark.parametrize("case", [c[0] for c in sup.CASES])
def test_two_process_mesh_equals_the_virtual_mesh(two_process, case):
    """tp across processes, dense and paged (W3's path), and dp=2×tp=2
    paged (W2's): bit-identical to the single-process virtual mesh of as
    many CPU devices, and both ranks identical."""
    results, jp, _ = two_process
    _, spec, local, paged = next(c for c in sup.CASES if c[0] == case)
    torch.set_num_threads(1)
    cfg = get_config("llama", "tiny")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    mesh = port_mesh.make_mesh(spec, local * 2)
    want = gen.generate(shard_params(mesh, pp), cfg, sup.TP_PROMPTS, mesh=mesh, paged=paged,
                        page_size=16, speculative=False, **sup.GEN_KW)
    for res in results:
        got = res[case]
        assert got["mesh"] == dict(mesh.shape)
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want.tokens)
        assert got["n_generated"] == want.n_generated.tolist()
        assert got["dist"] > 0


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


def test_sp_across_processes_is_refused(two_process):
    results, _, _ = two_process
    for res in results:
        assert res["sp refusal"] is not None
        assert "mesh axis 'sp' spans processes [0, 1]" in res["sp refusal"]
