"""The port's ``generate(mesh=...)`` against the reference's, on the CPU.

The reference runs its mesh programs on its 8 virtual host devices; the
port runs the same mesh over ``devices=["cpu"] * 8`` (every shard on the
CPU, as the card runs a virtual mesh on ``cuda:0``). Both hold the same
tiny f32 llama (the reference's init, bridged with ``params_from_jax``),
each sharded by its own rules. Greedy tokens and ``n_generated`` must be
identical to the reference's mesh run AND to the port's single-device
run: dense on tp, dp×tp and dp meshes (3 rows on dp=4: padded and
unpadded), paged on dp-only and dp×tp (W2's path, float and int8 pools;
the reference's {"tp": 2} on 8 devices is dp=4 × tp=2) and tp-only (a
dp=1 submesh: W3's path), speculation on dp-only, tp and dp×tp meshes,
int8 weights and an int8 KV cache on tp=2, and the prefix-sharing switch
on a tp=2 paged run. Every mesh runs the one sharded program, where the
reference's dp-only mesh runs a per-device loop: greedy tokens agree.

On the CPU the wrappers take their kernels' plain versions, so these pin
the mesh programs (splits, collectives, the per-slice pool layout), not
the CUDA kernels (``chip_smoke.py`` phase ``mesh``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import generate as jax_gen
from adversarial_spec_tpu.models import transformer as jax_tf
from adversarial_spec_tpu.models.config import get_config as jax_get_config
from adversarial_spec_tpu.ops.quant import quantize_params as jax_quantize
from adversarial_spec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from adversarial_spec_tpu.parallel.sharding import shard_params as jax_shard_params
from adversarial_spec_tpu_torch.engine import generate as gen
from adversarial_spec_tpu_torch.engine.loader import params_from_jax
from adversarial_spec_tpu_torch.models.config import get_config
from adversarial_spec_tpu_torch.parallel import collectives
from adversarial_spec_tpu_torch.parallel.mesh import make_mesh
from adversarial_spec_tpu_torch.parallel.sharding import MeshParams, shard_params

CPU8 = ["cpu"] * 8
P4 = [[1, 5, 9, 3], [2, 6], [8, 8, 8], [4]]
P3 = [[1, 2], [3, 4, 5], [6]]
# Repetitive rows, so prompt-lookup drafts get accepted.
SPEC_P = [
    [((i * 13) % 500) + 3 for i in range(40)],
    [5, 9, 7, 5, 9, 7, 5, 9, 7, 5, 9, 7, 5, 9],
    [((i * 7) % 450) + 9 for i in range(25)],
    [9, 1, 9, 1, 9, 1, 9, 1, 9, 1],
]
SAME = [[((i * 7) % 400) + 3 for i in range(24)]] * 2

_MODELS: dict = {}


def _models(quant: str):
    """(reference params, port params, cfgs) of the tiny f32 llama."""
    if quant not in _MODELS:
        jcfg = jax_get_config("llama", "tiny")
        jp = jax_tf.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
        if quant:
            jp = jax_quantize(jp, fmt=quant)
        cfg = get_config("llama", "tiny")
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
        _MODELS[quant] = (jp, jcfg, pp, cfg)
    return _MODELS[quant]


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


CASES = {
    "dense-tp2": ({"tp": 2}, P4, {}),
    "dense-dp4-tp2": ({"dp": 4, "tp": 2}, P4, {}),
    "dense-dp8": ({"dp": 8}, P4, {}),
    "dense-dp4-tp2-3rows": ({"dp": 4, "tp": 2}, P3, dict(max_new_tokens=4)),
    "paged-dp4-3rows": ({"dp": 4}, P3, dict(paged=True)),
    "paged-dp4-4rows": ({"dp": 4}, P4, dict(paged=True)),
    # {"tp": 2} on 8 devices is dp=4 × tp=2 (the reference's rule); a
    # tp-only mesh (W3's path) pins dp=1, a submesh on 2 devices.
    "paged-tp2": ({"tp": 2}, P4[:2], dict(paged=True)),
    "paged-tp2-only": ({"dp": 1, "tp": 2}, P4[:2], dict(paged=True)),
    "paged-dp2-tp2": ({"dp": 2, "tp": 2}, P4, dict(paged=True)),
    "paged-dp2-tp2-int8kv": ({"dp": 2, "tp": 2}, P4, dict(paged=True, kv_dtype="int8")),
    "spec-dp4": ({"dp": 4}, SPEC_P, dict(speculative=True, max_new_tokens=24)),
    "spec-tp2": ({"tp": 2}, SPEC_P, dict(speculative=True, max_new_tokens=24)),
    "spec-dp2-tp2": ({"dp": 2, "tp": 2}, SPEC_P, dict(speculative=True, max_new_tokens=24)),
    "int8-weights-tp2": ({"tp": 2}, SPEC_P, dict(quant="int8", max_new_tokens=12)),
    "int4-weights-tp2": ({"tp": 2}, P4, dict(quant="int4", paged=True)),
    "int8kv-tp2": ({"tp": 2}, SPEC_P, dict(kv_dtype="int8", speculative=True,
                                           max_new_tokens=24)),
    "prefix-tp2": ({"dp": 1, "tp": 2}, SAME, dict(paged=True, share_prefix=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_generate_matches_reference_and_single_device(case):
    mesh_spec, prompts, extra = CASES[case]
    extra = dict(extra)
    quant = extra.pop("quant", "")
    kw = dict(max_new_tokens=6, eos_ids=[], greedy=True, speculative=False,
              share_prefix=False)
    if extra.get("paged"):
        kw["page_size"] = 16
    kw.update(extra)
    jp, jcfg, pp, cfg = _models(quant)
    jmesh = jax_make_mesh(mesh_spec)
    with jmesh:
        ref = jax_gen.generate(jax_shard_params(jmesh, jp), jcfg, prompts, mesh=jmesh, **kw)
    single = gen.generate(pp, cfg, prompts, device="cpu", **kw)
    mesh = make_mesh(mesh_spec, CPU8)
    collectives.reset_counts()
    out = gen.generate(shard_params(mesh, pp), cfg, prompts, mesh=mesh, **kw)
    assert out.tokens.shape[0] == len(prompts)
    np.testing.assert_array_equal(out.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated, np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.tokens, single.tokens)
    np.testing.assert_array_equal(out.n_generated, single.n_generated)
    # A virtual mesh sums its partials locally, never through NCCL; a
    # dp-only mesh has no tp collective at all.
    assert collectives.counts["nccl"] == 0
    assert (collectives.counts["local"] > 0) == ("tp" in mesh_spec)


def test_generate_refuses_what_is_not_ported():
    """An sp axis, or a tp that does not divide the KV heads: "not yet
    ported", before any work."""
    _, _, pp, cfg = _models("")
    for spec in ({"dp": 2, "sp": 2, "tp": 2}, {"tp": 4}):
        mesh = make_mesh(spec, CPU8)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            gen.generate(MeshParams(mesh, []), cfg, P4, mesh=mesh,
                         max_new_tokens=4, eos_ids=[])
