"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the port (``adversarial_spec_tpu_torch``). It needs as
many CUDA cards as the cell asks for, and exits with another code than 0,
printing no result, where they are missing, on any error, or where JAX or
the JAX package were loaded. The last line of standard output is the
result, one JSON object; the numbers its check compared come last there,
and as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    try:
        entry = harness.load_cell(args.workload)[0]
    except (KeyError, OSError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    lines = []
    try:
        with harness.quiet_stdout():
            out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   log=lines.append)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
