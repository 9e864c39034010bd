"""One run of one cell: set-up, the measured window, the check of what it
served, and the result line.

Nothing here names a cell, a configuration or a per-layer metric (the two
end-to-end metrics, ``round_s`` and ``setup_s``, are the benchmark's own
clock readings, taken here): the cell's entry
in ``BENCHMARK.json`` names its configuration file and its traffic mix,
``cells/<cell>.json`` holds the limits its check compares against, and
each per-layer metric is read by ``metrics/<name>.py``.

The program is driven only through its own entry points: the engine that
``engine/dispatch.py`` serves ``tpu://`` ids with is a ``GpuEngine``
holding the benchmark's weights (``GpuEngine.install``), under an alias
written to a registry file of the run's own, and each round is
``debate.core.run_round`` over the cell's opponents. Two thin wrappers
watch it: one around that engine's ``chat`` (its walls) and one around
the served model's tokenizer (the ids it encoded for each prompt and
decoded for each row: what was served).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import tracing
from portbench import traffic as traffic_mod
from portbench import weights as weights_mod
from portbench.reference import model as ref_model

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adversarial_spec_tpu")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def process_age_s() -> float:
    """Seconds since this process started (Linux: ``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def benchmark(root: Path = HERE) -> dict:
    """``BENCHMARK.json``, the file beside ``root``."""
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = HERE) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration file, traffic mix, cell limits) of a
    cell of ``BENCHMARK.json``."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root.parent / conf["file"]).read_text())
    mix = traffic_mod.load_mix(entry["traffic"], root)
    limits = json.loads((root / "cells" / f"{name}.json").read_text())
    return entry, cfg, mix, limits


def per_layer_metrics(name: str, root: Path = HERE) -> list[str]:
    """The per-layer metrics ``BENCHMARK.json`` gives this cell: those
    listing it, and those with no list that move an end-to-end metric it
    reports."""
    bench = benchmark(root)
    e2e = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


class Recorder:
    """The served model's tokenizer, with the ids the engine encodes and
    decodes kept (references only: streaming decodes of partial rows are
    dropped after each call)."""

    def __init__(self, tok):
        self.tok = tok
        self.encoded: list = []
        self.decoded: list = []

    def encode(self, text, *args, **kwargs):
        ids = self.tok.encode(text, *args, **kwargs)
        self.encoded.append(ids)
        return ids

    def decode(self, ids):
        self.decoded.append(ids)
        return self.tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self.tok, name)


class Session:
    """The program under test, set up for one cell."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, quant: str = "",
                 weights: dict | None = None, kv_dtype: str = ""):
        from adversarial_spec_tpu_torch.engine import dispatch, registry
        from adversarial_spec_tpu_torch.engine import spec as spec_mod
        from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        port = cfg["port"]
        self.alias = f"portbench-{cfg['name']}"
        self.model = f"tpu://{self.alias}"
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        self._registry = registry
        self._prev_registry = registry.REGISTRY_PATH
        registry.REGISTRY_PATH = Path(self._tmp.name) / "registry.json"
        registry.save_registry_entry(registry.ModelSpec(
            alias=self.alias, family=port["family"], size=port["size"], dtype=port["dtype"],
            max_seq_len=int(port.get("max_seq_len", 0)), kv=mix["kv"], quant=quant,
            kv_dtype=kv_dtype))
        spec_mod.configure(enabled=bool(mix["speculative"]))
        self.gamma = spec_mod.config().gamma
        self.engine = GpuEngine(device=self.device)
        dispatch.install_engine(self.model, self.engine)
        self.weights = weights or weights_mod.draw(cfg, seed, self.device, _DTYPES[port["dtype"]])
        params = self.weights
        if quant:
            from adversarial_spec_tpu_torch.ops.quant import quantize_params

            params = quantize_params(
                {k: ([dict(lp) for lp in v] if k == "layers" else v) for k, v in params.items()},
                fmt=quant)
        self.engine.install(self.alias, params)
        lm = self.engine._models[self.alias]
        self.eos_ids = frozenset(int(i) for i in lm.tokenizer.eos_ids)
        self.rec = Recorder(lm.tokenizer)
        lm.tokenizer = self.rec
        self.calls: list[dict] = []
        inner = self.engine.chat

        @functools.wraps(inner)
        def chat(requests, params, consumer=None):
            t0, m_enc, m_dec = time.perf_counter(), len(self.rec.encoded), len(self.rec.decoded)
            out = inner(requests, params, consumer)
            n = len(requests)
            done = self.rec.decoded[m_dec:]
            self.calls.append({
                "t0": t0, "t1": time.perf_counter(), "greedy": bool(params.greedy),
                "prompts": [list(map(int, p)) for p in self.rec.encoded[m_enc:m_enc + n]],
                "served": [list(map(int, ids)) for ids in done[-n:]] if len(done) >= n else None,
                "errors": [c.error for c in out],
            })
            del self.rec.decoded[m_dec:]
            del self.rec.encoded[m_enc:]
            return out

        self.engine.chat = chat

    def launches(self) -> dict:
        from adversarial_spec_tpu_torch.ops import decode_attention, paged_attention

        return {**decode_attention.launches, **paged_attention.launches}

    def round(self, rnd: traffic_mod.Round, round_num: int) -> dict:
        """One critique round through the debate layer, and its record."""
        from adversarial_spec_tpu_torch.debate import core
        from adversarial_spec_tpu_torch.debate.usage import Usage
        from adversarial_spec_tpu_torch.engine.types import SamplingParams

        mix = self.mix
        rcfg = core.RoundConfig(
            doc_type=mix["doc_type"], persona=rnd.persona,
            sampling=SamplingParams(max_new_tokens=int(mix["max_new_tokens"]),
                                    temperature=float(mix["temperature"]),
                                    greedy=rnd.greedy, seed=rnd.sampling_seed))
        before, n_calls = self.launches(), len(self.calls)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.round"):
            res = core.run_round(rnd.spec, [self.model] * int(mix["opponents"]), round_num, rcfg)
        t1 = time.perf_counter()
        after = self.launches()
        calls = self.calls[n_calls:]
        for c in calls:
            for p, r in zip(c["prompts"], res.responses):
                if r.usage is not None and r.ok and len(p) != r.usage.input_tokens:
                    raise RuntimeError("the engine trimmed a prompt: the traffic does not fit the model")
        rows = [{"input_tokens": u.input_tokens, "output_tokens": u.output_tokens,
                 "cached_tokens": u.cached_tokens, "prefill_s": u.prefill_time_s,
                 "decode_s": u.decode_time_s, "error": r.error}
                for r, u in ((r, r.usage or Usage()) for r in res.responses)]
        prompts: dict = {}
        for c in calls:
            for p, x in zip(c["prompts"], rows):
                key = tuple(p)
                prompts[key] = min(prompts.get(key, x["cached_tokens"]), x["cached_tokens"])
        return {
            "index": rnd.index, "greedy": rnd.greedy, "wall_s": t1 - t0, "t0": t0, "t1": t1,
            "chat_s": sum(c["t1"] - c["t0"] for c in calls), "rows": rows,
            "prompts": [(len(k), v) for k, v in prompts.items()],
            "launches": {k: after[k] - before.get(k, 0) for k in after},
            "calls": calls, "traced": False,
        }

    def close(self) -> None:
        """Free the program's state (the benchmark's weights stay)."""
        from adversarial_spec_tpu_torch.engine import dispatch

        dispatch.clear_engine_cache()
        self.engine = None
        self.calls = []
        self._registry.REGISTRY_PATH = self._prev_registry
        self._tmp.cleanup()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_window(sess: Session, mix: dict, seed: int, seconds: float,
               trace: bool) -> tuple[list, dict | None, float]:
    """Rounds back to back from the first round's start while less than
    ``seconds`` have passed (one client, a closed loop), and on to the end
    of a whole cycle of ``greedy_every`` rounds, so every window serves
    the mix's share of greedy rounds. With ``trace`` the profiler runs
    over the first ``trace_rounds`` rounds; the time it takes to stop is
    left out of the window's clock."""
    records, reduced, paused = [], None, 0.0
    tracer = tracing.DeviceTrace() if trace else None
    t_start = time.perf_counter()
    r, cycle = 0, max(1, int(mix["greedy_every"]))
    while r % cycle or r == 0 or time.perf_counter() - t_start - paused < seconds:
        rec = sess.round(traffic_mod.round_at(mix, seed, r), r + 1)
        rec["traced"] = tracer is not None
        records.append(rec)
        r += 1
        if tracer is not None and r >= int(mix["trace_rounds"]):
            t = time.perf_counter()
            reduced = tracer.stop()
            tracer = None
            paused += time.perf_counter() - t
    if tracer is not None:  # stopped after the window: nothing to leave out
        reduced = tracer.stop()
    return records, reduced, paused


def pick_rows(records: list, seed: int, n: int) -> list[tuple[list, list]]:
    """Distinct greedy (prompt, served) rows of the window: the longest,
    and ``n - 1`` more drawn with the seed."""
    rows, seen = [], set()
    for rec in records:
        for c in rec["calls"]:
            if not c["greedy"] or c["served"] is None:
                continue
            for p, s, e in zip(c["prompts"], c["served"], c["errors"]):
                key = (tuple(p), tuple(s))
                if e is None and s and key not in seen:
                    seen.add(key)
                    rows.append((p, s))
    if not rows:
        return []
    longest = max(range(len(rows)), key=lambda i: len(rows[i][1]))
    rest = [i for i in range(len(rows)) if i != longest]
    random.Random(traffic_mod.derive(seed, "check", 0)).shuffle(rest)
    return [rows[i] for i in [longest] + rest[: max(0, n - 1)]]


def check(weights: dict, cfg: dict, mix: dict, rows: list, eos_ids, limits: dict,
          failed: int, greedy_rounds: int) -> tuple[dict, int]:
    """Each number compared, beside its limit, and the served tokens
    compared. A row is whole where it ran to the mix's budget or ended on
    an end-of-sequence id: the served ids keep that stop, so its gap is
    compared with the rest. Every greedy round owes one whole row at the
    least (its rows share one prompt), up to the mix's ``check_rows``."""
    gap, tokens, whole = 0.0, 0, 0
    for prompt, served in rows:
        gap = max(gap, float(ref_model.served_gaps(weights, cfg, prompt, served).max()))
        tokens += len(served)
        whole += len(served) == int(mix["max_new_tokens"]) or served[-1] in eos_ids
    checks = {
        "failed": {"value": failed, "limit": 0},
        "whole_rows_checked": {"value": whole,
                               "limit": min(int(mix["check_rows"]), greedy_rounds)},
        "served_gap": {"value": gap, "limit": float(limits["served_gap"]["limit"])},
    }
    return checks, tokens


def is_correct(checks: dict) -> bool:
    return (checks["failed"]["value"] <= checks["failed"]["limit"]
            and checks["whole_rows_checked"]["value"] >= checks["whole_rows_checked"]["limit"]
            and checks["served_gap"]["value"] <= checks["served_gap"]["limit"])


def run_record(cell: str, cfg: dict, mix: dict, gamma: int, records: list, trace: dict | None) -> dict:
    """What the per-layer readers read."""
    return {"cell": cell, "config": cfg, "traffic": mix, "gamma": gamma,
            "rounds": records, "trace": trace}


def read_metrics(names: list[str], run: dict, root: Path = HERE) -> dict:
    """Each named metric's reader, ``metrics/<name>.py`` under ``root``."""
    out = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name}", root / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[name] = value
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = HERE, log=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``log``
    receives the lines printed before it."""
    log = log or (lambda line: None)
    entry, cfg, mix, limits = load_cell(cell, root)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sess = Session(cfg, mix, seed, device)
    for rnd in traffic_mod.warmup_rounds(mix, seed):
        sess.round(rnd, 1)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    records, reduced, paused = run_window(sess, mix, seed, seconds, trace)
    window_s = records[-1]["t1"] - records[0]["t0"] - paused
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = sum(len(r["rows"]) for r in records)
    failed = sum(1 for r in records for x in r["rows"] if x["error"])
    rows = pick_rows(records, seed, int(mix["check_rows"]))
    gamma = sess.gamma
    sess.close()
    checks, tokens_checked = check(sess.weights, cfg, mix, rows, sess.eos_ids, limits, failed,
                                   sum(r["greedy"] for r in records))
    log(json.dumps({"rounds": len(records), "window_s": window_s,
                    "served_tokens_checked": tokens_checked,
                    "tokens": [sum(x["output_tokens"] for x in r["rows"]) for r in records],
                    "greedy": [r["greedy"] for r in records],
                    "wall_s": [r["wall_s"] for r in records]}))
    if trace:
        run = run_record(cell, cfg, mix, gamma, records, reduced)
        units = {m["name"]: m["unit"] for m in benchmark(root)["per_layer"]}
        metrics = {n: {"value": v, "unit": units[n]}
                   for n, v in read_metrics(per_layer_metrics(cell, root), run, root).items()}
    else:
        metrics = {"round_s": {"value": window_s / len(records), "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": is_correct(checks), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and reduced:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": [[n[:tracing.NAME_CHARS], s] for n, s in reduced["device_ops"][:10]],
                            "idle_gaps": [[n, s] for n, s in reduced["idle_gaps"][:10]]}
    out["checks"] = checks
    return out


@contextlib.contextmanager
def quiet_stdout():
    """The program's own prints go to standard error: the last line of
    standard output is the result."""
    with contextlib.redirect_stdout(sys.stderr):
        yield
