"""The readings a cell's limits are set from: the served-token gap of sound
runs of the program, and of its control, over many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--control int8]

For each seed it draws the seed's weights once and serves the greedy
rounds of the seed's stream (the rounds a run's check samples) at the
cell's own sizes: through the program as the configuration states it,
then through the control, the program with its own lower-precision path
switched on (``--control int8``: int8 weights, kernel B5, the next
precision below the configuration's bf16; ``--control kv-int8``: its int8
KV cache; ``--control none`` reads the program alone). Each side's rows are sampled
and compared with the float32 reference as a run compares them. One JSON
line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def greedy_indices(mix: dict, n: int) -> list[int]:
    k = int(mix["greedy_every"])
    return [k * (i + 1) - 1 for i in range(n)]


def reading(cell: str, seed: int, control: str, device: str, root=None) -> dict:
    """The seed's served gap for the program and for its control."""
    import torch

    from portbench import harness
    from portbench import traffic as traffic_mod

    root = root or harness.HERE
    _, cfg, mix, limits = harness.load_cell(cell, root)
    # Identical prompts give identical greedy rows: a round gives one
    # distinct row at the least.
    n_rounds = int(mix["check_rows"])
    out = {"cell": cell, "seed": seed}
    weights = None
    sides = [("program", "")] + ([("control", control)] if control != "none" else [])
    for side, path in sides:
        quant, kv_dtype = ("", "int8") if path == "kv-int8" else (path, "")
        t = time.perf_counter()
        sess = harness.Session(cfg, mix, seed, device, quant=quant, weights=weights,
                               kv_dtype=kv_dtype)
        weights = sess.weights
        records = [sess.round(traffic_mod.round_at(mix, seed, i), i + 1)
                   for i in greedy_indices(mix, n_rounds)]
        failed = sum(1 for r in records for x in r["rows"] if x["error"])
        rows = harness.pick_rows(records, seed, int(mix["check_rows"]))
        sess.close()
        checks, tokens = harness.check(weights, cfg, mix, rows, sess.eos_ids, limits, failed,
                                       len(records))
        out[side] = {"served_gap": checks["served_gap"]["value"], "failed": failed,
                     "tokens": tokens, "whole_rows": checks["whole_rows_checked"]["value"],
                     "correct": harness.is_correct(checks), "s": time.perf_counter() - t}
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", default="int8",
                    help="the lower-precision path: int8 or int4 weights, kv-int8 (an int8 "
                         "KV cache), or none: the program alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        with harness.quiet_stdout():
            out = reading(args.workload, seed, args.control, "cuda")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
