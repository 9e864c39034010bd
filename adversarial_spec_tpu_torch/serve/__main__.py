"""``python -m adversarial_spec_tpu_torch.serve`` — the daemon entrypoint.

A thin alias for ``debate serve`` (adversarial_spec_tpu_torch/cli.py owns
the flag surface); the module form exists so harnesses can spawn the
daemon without depending on the console-script install.
"""

from __future__ import annotations

import sys

from adversarial_spec_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["serve", *sys.argv[1:]]))
