"""The runner at tiny widths on the CPU: its result line, cells and metrics
added by files alone, and the refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness
from conftest import make_root

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_run_cell_prints_the_result_line(tiny_root, kv):
    root, cells = tiny_root
    out = harness.run_cell(cells[kv], 3_000_000_019, 1.0, False, device="cpu",
                           root=root / "portbench")
    assert all(k in out for k in KEYS) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % (2 if kv == "dense" else 3) == 0
    assert set(out["metrics"]) == {"round_s", "setup_s"}
    assert out["metrics"]["round_s"]["value"] > 0 and out["metrics"]["round_s"]["unit"] == "s"
    rows = out["checks"]["whole_rows_checked"]
    assert rows["value"] >= rows["limit"] >= 1
    json.dumps(out)


def test_traced_run_reports_its_cell_metrics(tiny_root):
    root, cells = tiny_root
    out = harness.run_cell(cells["dense"], 77, 1.0, True, device="cpu", root=root / "portbench")
    names = set(out["metrics"])
    # The CPU runs no attention kernel and counts no launch: those
    # readers find nothing, and their metrics are left out.
    assert {"debate_overhead_ms", "dense_prefill_s", "mfu_pct", "idle_pct"} <= names
    assert not names & {"paged_prefill_s", "paged_step_ms", "paged_attn_roofline"}
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_metric_added_as_a_file_is_read(tiny_root):
    root, cells = tiny_root
    (root / "portbench" / "metrics" / "rounds_traced.py").write_text(
        "def read(run):\n    return float(sum(r['traced'] for r in run['rounds']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rounds_traced", "unit": "rounds", "better": "lower",
                               "source": "host_clock", "layer": "debate layer",
                               "moves": "round_s", "workloads": [cells["paged"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(cells["paged"], 5, 0.5, True, device="cpu", root=root / "portbench")
    assert out["metrics"]["rounds_traced"] == {"value": 1.0, "unit": "rounds"}


def test_same_seed_same_rounds(tiny_root):
    from portbench import traffic

    mix = dict(traffic.load_mix("round-dense"), greedy_every=6)
    a = [traffic.round_at(mix, 2**31 + 11, i) for i in range(7)]
    b = [traffic.round_at(mix, 2**31 + 11, i) for i in range(7)]
    c = [traffic.round_at(mix, 2**31 + 12, i) for i in range(7)]
    assert a == b and a != c
    assert {len(r.spec) for r in a + c} == {mix["spec_tokens"]}
    assert [r.greedy for r in a] == [r.greedy for r in c] == [False] * 5 + [True, False]


def test_window_meets_no_decode_step_that_setup_did_not(tmp_path, monkeypatch):
    """Every key of the batcher's decode loop (what a card captures as a
    CUDA graph: shapes, sampling and the buffers' addresses) that the
    window's rounds use was met in set-up, so nothing is captured inside
    the window."""
    from adversarial_spec_tpu_torch.engine import device_loop

    from portbench import traffic

    root, cells = make_root(tmp_path, max_new_tokens=48)
    _, cfg, mix, _ = harness.load_cell(cells["paged"], root / "portbench")
    seen, phase = {"setup": set(), "window": set()}, ["setup"]
    run = device_loop.Loop.run

    def recording(self, step, n_max, key, generators=()):
        seen[phase[0]].add(key + device_loop.ptrs(self.done, *self._bufs.values()))
        return run(self, step, n_max, key, generators)

    monkeypatch.setattr(device_loop.Loop, "run", recording)
    sess = harness.Session(cfg, mix, 2**31 + 77, "cpu")
    try:
        for rnd in traffic.warmup_rounds(mix, 2**31 + 77):
            sess.round(rnd, 1)
        phase[0] = "window"
        for r in range(2 * int(mix["greedy_every"])):
            sess.round(traffic.round_at(mix, 2**31 + 77, r), r + 1)
    finally:
        sess.close()
    assert seen["window"] and seen["window"] <= seen["setup"]


def test_run_py_refuses_without_a_card(tmp_path):
    """Where the cell's cards are missing, no result is printed."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mistral-7b.round-dense",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.HERE.parent, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ cannot run."""
    import shutil

    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mistral-7b.round-dense",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_jax_in_sys_modules_is_found(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "adversarial_spec_tpu.engine", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "adversarial_spec_tpu_torch_extra", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["adversarial_spec_tpu.engine", "jax.numpy"]


def test_per_layer_metrics_by_cell():
    dense = harness.per_layer_metrics("mistral-7b.round-dense")
    paged = harness.per_layer_metrics("qwen2-7b.round-paged")
    assert {"dense_prefill_s", "dense_step_ms", "dense_attn_roofline"} <= set(dense)
    assert not {"paged_prefill_s", "paged_step_ms", "paged_attn_roofline"} & set(dense)
    assert {"paged_prefill_s", "paged_step_ms", "paged_attn_roofline"} <= set(paged)
    for cell in (dense, paged):
        assert {"debate_overhead_ms", "mfu_pct", "idle_pct"} <= set(cell)
