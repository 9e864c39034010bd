"""Debate orchestration: rounds, parsing, convergence, usage, sessions.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/__init__.py``.
"""

from adversarial_spec_tpu_torch.debate.types import ModelResponse, RoundResult
from adversarial_spec_tpu_torch.debate.parsing import (
    detect_agreement,
    extract_spec,
    extract_tasks,
    get_critique_summary,
    generate_diff,
)
from adversarial_spec_tpu_torch.debate.usage import Usage, CostTracker

__all__ = [
    "ModelResponse",
    "RoundResult",
    "detect_agreement",
    "extract_spec",
    "extract_tasks",
    "get_critique_summary",
    "generate_diff",
    "Usage",
    "CostTracker",
]
