"""Device resolution shared by the port's entry points.

Entry points (``GpuEngine``, ``generate``, ``materialize_params``) run on
the GPU unless the caller names another device. With no device given and
no GPU present they raise: a silent CPU fallback would make every timing
and every kernel-launch count of a run meaningless.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is visible); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch paths on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
