"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory holding a copy of ``portbench/`` and a ``BENCHMARK.json`` with
cells of the port's tiny Qwen2 preset added by files alone."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DATA = Path(__file__).resolve().parent / "data"
TINY_LIMIT = 1e-3  # float32 program against the float32 reference


def add_tiny_cells(root: Path, max_new_tokens: int = 12) -> dict[str, str]:
    """Add the tiny configuration, two traffic mixes, their cells and their
    limits to the checkout at ``root`` as new files and new entries;
    returns kv layout -> cell name."""
    pb = root / "portbench"
    shutil.copy(DATA / "qwen2-tiny.json", pb / "configs" / "qwen2-tiny.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "qwen2-tiny", "source": "models/config.py",
                             "file": "portbench/configs/qwen2-tiny.json", "reduced": [],
                             "why": "CPU tests"})
    cells = {}
    for kv in ("dense", "paged"):
        mix = json.loads((pb / "traffic" / f"round-{kv}.json").read_text())
        mix.update(spec_tokens=160, max_new_tokens=max_new_tokens, greedy_every=3,
                   opponents=2 if kv == "dense" else 3, check_rows=2, trace_rounds=1)
        (pb / "traffic" / f"tiny-{kv}.json").write_text(json.dumps(mix))
        name = f"qwen2-tiny.tiny-{kv}"
        bench["workloads"].append({"name": name, "config": "qwen2-tiny",
                                   "traffic": f"tiny-{kv}", "chips": 1, "why": "CPU tests"})
        (pb / "cells" / f"{name}.json").write_text(json.dumps(
            {"served_gap": {"limit": TINY_LIMIT}}))
        for m in bench["per_layer"]:
            if kv in m["name"] and "workloads" in m:
                m["workloads"].append(name)
        cells[kv] = name
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cells


def make_root(path: Path, max_new_tokens: int = 12) -> tuple[Path, dict[str, str]]:
    """A copy of the checkout's benchmark at ``path`` with the tiny cells."""
    shutil.copytree(REPO / "portbench", path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", path / "BENCHMARK.json")
    return path, add_tiny_cells(path, max_new_tokens)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
