"""One process of the port's two-process CPU launch.

``tests/test_torch_multihost.py`` starts two of these with the
reference's launch contract (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); each brings up
``torch.distributed`` through the port's ``maybe_initialize_distributed``,
runs every case below over meshes that span both processes, and writes
what it got to ``OUT`` (a JSON file). It imports no jax: the reference's
tiny llama comes in as ``PARAMS`` (an ``.npz`` of the reference's params
pytree, ``/``-joined keys), bridged with ``params_from_jax``. The last
case runs ``cli.main(CLI_ARGV)`` on ``CLI_SPEC`` with the registry at
``CLI_REGISTRY`` (an f32 ``random-tiny`` entry with no mesh axis) served
by a CPU ``GpuEngine`` holding those params.

    python tests/torch_multihost_support.py OUT PARAMS CLI_REGISTRY

The parent holds the results to the reference's runs and to the port's
single-process virtual mesh (``CASES`` names the shared inputs).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

# Shared with the parent: the prompts and budgets of each generate case,
# and the chat round's requests.
SPEC_PROMPTS = [[5 + i, 7, 11 + i, 13] for i in range(4)]
TP_PROMPTS = [[1, 5, 9, 3, 1, 5, 9, 3], [2, 6], [8, 8, 8], [4, 4, 7, 4, 4, 7]]
GEN_KW = dict(max_new_tokens=20, eos_ids=[], greedy=True, speculative=False)
# The sp cases' prompts and knobs: tests/test_torch_sp.py's.
SP_PROMPTS = [[1, 5, 9, 3, 7, 2], [4, 4, 8]]
SP_PROMPTS4 = SP_PROMPTS + [[6, 1, 1, 2], [9, 9]]
SP_SPEC_PROMPTS = [[3, 7, 11, 5] * 4 + [9], [3, 7, 11, 5] * 4 + [13]]
SP_KW = dict(max_new_tokens=6, eos_ids=[], greedy=True, speculative=False, share_prefix=False)
# (case, mesh spec, this process's devices, prompts, generate kwargs)
CASES = [
    ("tp2 dense", {"tp": 2}, ["cpu"], TP_PROMPTS, GEN_KW),
    ("tp2 paged", {"tp": 2}, ["cpu"], TP_PROMPTS, dict(GEN_KW, paged=True)),
    ("dp2tp2 paged", {"dp": 2, "tp": 2}, ["cpu", "cpu"], TP_PROMPTS, dict(GEN_KW, paged=True)),
    # The sp axis across processes: B2's plain version (speculation), W1's
    # (tp), a ring crossing twice a hop (two sp ranks a process), W3's
    # and W3-i8's.
    ("sp2 dense spec", {"sp": 2}, ["cpu"], SP_SPEC_PROMPTS,
     dict(SP_KW, speculative=True, max_new_tokens=24)),
    ("sp2tp2 dense", {"sp": 2, "tp": 2}, ["cpu", "cpu"], SP_PROMPTS, SP_KW),
    ("sp4 dense", {"sp": 4}, ["cpu", "cpu"], SP_PROMPTS, SP_KW),
    ("sp2 paged", {"sp": 2}, ["cpu"], SP_PROMPTS4, dict(SP_KW, paged=True, max_new_tokens=8)),
    ("sp2tp2 paged int8", {"sp": 2, "tp": 2}, ["cpu", "cpu"], SP_PROMPTS,
     dict(SP_KW, paged=True, kv_dtype="int8")),
]
# A layout no process can decode: process 1's decode rank is sp rank 1,
# where process 0 holds the tp=0 shard and decodes at rank 0.
REFUSED = ({"sp": 3, "tp": 2}, ["cpu"] * 3)
CLI_SPEC = "# Rate Limiter\n\nThe API MUST rate-limit each tenant.\n"
CLI_ARGV = ["critique", "--models", "tpu://random-tiny,tpu://random-tiny", "--greedy",
            "--max-new-tokens", "16", "--json"]
CHAT_USERS = [
    ("You are a security reviewer.", "# Spec\nThe API MUST rate-limit. " * 6),
    ("You are an SRE.", "# Spec\nRetries back off exponentially."),
    ("You are a PM.", "# Spec\nAcceptance: an integration test. " * 3),
]
CHAT_ALIASES = ("random-tiny", "mh-tp2")  # dp=2 (no mesh axis) and {"tp": 2}
CHAT_MAX_NEW = 16


def load_params(path: str, cfg):
    """The reference's params from ``path`` as the port's (f32, CPU)."""
    from adversarial_spec_tpu_torch.engine.loader import params_from_jax

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_jax(tree, cfg, "cpu", torch.float32)


def result(r) -> dict:
    return {"tokens": r.tokens.tolist(), "n_generated": r.n_generated.tolist()}


def main(out_path: str, params_path: str, cli_registry: str) -> None:
    from adversarial_spec_tpu_torch import cli
    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.engine.generate import generate
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.spec import config as spec_config
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.models.config import get_config
    from adversarial_spec_tpu_torch.parallel import collectives, ring
    from adversarial_spec_tpu_torch.parallel import mesh as mesh_mod
    from adversarial_spec_tpu_torch.parallel.sharding import gather, shard_params, split

    torch.set_num_threads(1)
    mesh_mod.maybe_initialize_distributed()
    mesh_mod.maybe_initialize_distributed()  # idempotent
    out: dict = {"rank": mesh_mod.process_index(), "count": mesh_mod.process_count()}

    # A psum over dp=4: two CPU devices a process.
    mesh = mesh_mod.make_mesh({}, ["cpu", "cpu"])
    collectives.reset_counts()
    parts = [torch.tensor([float(d)]) for d, _ in mesh.local_shards()]
    summed = collectives.all_reduce(parts, span=mesh.span([(d, 0) for d in range(4)]))
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    grid = split(x, mesh, ("dp", None))
    out["psum"] = {
        "mesh": dict(mesh.shape),
        "ranks": mesh.ranks.reshape(-1).tolist(),
        "local_shards": mesh.local_shards(),
        "remote_cells_none": [grid[d][0] is None for d in range(4)],
        "sums": [float(s.item()) for s in summed],
        "gathered": gather(grid, mesh, ("dp", None)).tolist(),
        "dist": collectives.counts["dist"],
    }

    # Speculation on a dp=4 mesh across processes.
    cfg = get_config("llama", "tiny")
    params = load_params(params_path, cfg)
    collectives.reset_counts()
    r = generate(shard_params(mesh, params), cfg, SPEC_PROMPTS, mesh=mesh, speculative=True,
                 max_new_tokens=2 * spec_config().gamma + 8, eos_ids=[], greedy=True)
    out["spec dp4"] = {**result(r), "dist": collectives.counts["dist"]}

    # tp across processes (one CPU device a process), dense and paged;
    # dp=2 x tp=2 paged (two devices a process); the sp meshes.
    for name, spec, local, prompts, kw in CASES:
        m = mesh_mod.make_mesh(spec, local)
        collectives.reset_counts()
        ring.reset_counts()
        r = generate(shard_params(m, params), cfg, prompts, mesh=m, page_size=16, **kw)
        out[name] = {**result(r), "mesh": dict(m.shape), "dist": collectives.counts["dist"],
                     "decode_rank": m.decode_rank, "ring": dict(ring.counts)}

    # GpuEngine.chat: a spec with no mesh axis (dp over both processes) and
    # a {"tp": 2} alias from the registry under HOME.
    engine = GpuEngine(device="cpu", devices=["cpu"])
    sp = SamplingParams(max_new_tokens=CHAT_MAX_NEW, greedy=True)
    for alias in CHAT_ALIASES:
        collectives.reset_counts()
        got = engine.chat([ChatRequest(f"tpu://{alias}", s, u) for s, u in CHAT_USERS], sp)
        out[f"chat {alias}"] = {
            "errors": [c.error for c in got],
            "texts": [c.text for c in got],
            "output_tokens": [c.usage.output_tokens for c in got],
            "mesh": dict(engine._models[alias].mesh.shape),
            "dist": collectives.counts["dist"],
        }

    # The layout whose decode rank lacks shards.
    try:
        mesh_mod.make_mesh(*REFUSED)
        out["layout refusal"] = None
    except ValueError as e:
        out["layout refusal"] = str(e)

    # critique --json through the CLI, each process its own sessions
    # (HOME, ADVSPEC_SESSIONS_DIR, the working directory): random-tiny
    # resolves to dp=2 over both processes.
    registry.REGISTRY_PATH = Path(cli_registry)
    engine = GpuEngine(device="cpu", devices=["cpu"])
    engine.install("random-tiny", shard_params(
        engine.mesh_for(registry.resolve_model_spec("tpu://random-tiny")), params))
    dispatch.install_engine("tpu://random-tiny", engine)
    collectives.reset_counts()
    sys.stdin = io.StringIO(CLI_SPEC)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        code = cli.main(list(CLI_ARGV))
    out["critique"] = {"code": code, "stdout": stdout.getvalue(),
                       "mesh": dict(engine._models["random-tiny"].mesh.shape),
                       "dist": collectives.counts["dist"]}

    Path(out_path).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    for _blocked in ("jax", "jaxlib", "adversarial_spec_tpu"):
        sys.modules[_blocked] = None  # the port runs without them
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    try:
        main(sys.argv[1], sys.argv[2], sys.argv[3])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
