"""The ``tpu://`` provider served by PyTorch on one GPU: ``GpuEngine``.

Counterpart of ``adversarial_spec_tpu/engine/tpu.py:TpuEngine`` for the
dense serving path: requests are grouped by model alias, each group's
prompts are templated, encoded and trimmed, and the group decodes as the
rows of one ``generate()`` call; per-row ``Usage`` is attributed exactly as
the reference does. Failures are captured into ``Completion.error`` per
group, never raised.

This slice keeps one resident model at a time (loading another alias
drops the previous one). Specs the port cannot serve yet — ``kv="paged"``
(the continuous batcher), ``quant`` weights, an int8 KV cache, multi-device
meshes, HF checkpoints — get a "not yet ported" error; they are never
served silently through the dense path.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine import registry as registry_mod
from adversarial_spec_tpu_torch.engine.generate import generate
from adversarial_spec_tpu_torch.engine.loader import materialize_params
from adversarial_spec_tpu_torch.engine.registry import ModelSpec
from adversarial_spec_tpu_torch.engine.tokenizer import (
    apply_chat_template,
    load_tokenizer,
)
from adversarial_spec_tpu_torch.engine.types import (
    ChatRequest,
    Completion,
    SamplingParams,
)
from adversarial_spec_tpu_torch.models.config import ModelConfig, get_config
from adversarial_spec_tpu_torch.utils.device import resolve_device

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def _trim_prompt(ids: list[int], limit: int) -> list[int]:
    """Trim to ``limit`` tokens keeping the first token (BOS/template
    head) and the most recent tail."""
    if limit > 0 and len(ids) > limit:
        return ids[:1] + ids[len(ids) - (limit - 1) :]
    return ids


def unported_reason(spec: ModelSpec) -> str | None:
    """Why this slice cannot serve ``spec``, or None when it can."""
    if spec.kv == "paged":
        return "kv='paged' (the continuous batcher)"
    if spec.quant:
        return f"quant={spec.quant!r} weights"
    if spec.kv_dtype:
        return f"kv_dtype={spec.kv_dtype!r} (int8 KV cache)"
    if math.prod(spec.mesh.values()) > 1:
        return f"a multi-device mesh {spec.mesh}"
    if spec.checkpoint != "random":
        return "HF safetensors checkpoints"
    return None


@dataclass
class LoadedModel:
    spec: ModelSpec
    cfg: ModelConfig
    params: dict
    tokenizer: object


class GpuEngine:
    """Serves ``tpu://`` aliases on one device (default ``cuda``)."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self._resident: LoadedModel | None = None

    def validate(self, model: str) -> str | None:
        return registry_mod.validate_tpu_model(model)

    def install(self, alias: str, params: dict) -> None:
        """Serve ``alias`` with these (already placed) params — e.g.
        weights bridged from the reference (``loader.params_from_jax``)."""
        spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
        cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
        self._resident = LoadedModel(
            spec, cfg, params, load_tokenizer(spec.tokenizer)
        )

    def _load(self, alias: str) -> LoadedModel:
        lm = self._resident
        if lm is not None and lm.spec.alias == alias:
            return lm
        self._resident = None  # one resident model: free before loading
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
        params, cfg = materialize_params(
            spec.checkpoint,
            spec.family,
            spec.size,
            dtype=_DTYPES.get(spec.dtype, torch.bfloat16),
            max_seq_len=spec.max_seq_len,
            device=self.device,
        )
        self._resident = LoadedModel(
            spec, cfg, params, load_tokenizer(spec.tokenizer)
        )
        return self._resident

    def chat(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        """Complete every request (one completion per request, in order).
        ``consumer`` streaming is a batcher feature: the dense path serves
        the blocking result only, as the reference's does."""
        groups: dict[str, list[int]] = {}
        out: list[Completion | None] = [None] * len(requests)
        for i, req in enumerate(requests):
            try:
                alias = registry_mod.parse_tpu_model_id(req.model)
            except ValueError as e:
                out[i] = Completion(error=f"ValueError: {e}")
                continue
            groups.setdefault(alias, []).append(i)
        for alias, indices in groups.items():
            batch = [requests[i] for i in indices]
            try:
                spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
                reason = unported_reason(spec)
                if reason is not None:
                    raise NotImplementedError(
                        f"tpu://{alias} needs {reason}, which is not yet "
                        "ported to the PyTorch/CUDA package"
                    )
                completions = self._chat_loaded(self._load(alias), batch, params)
            except Exception as e:  # degrade, never raise (parity: ref)
                completions = [
                    Completion(
                        error=f"{type(e).__name__}: {e}",
                        transient=isinstance(e, torch.OutOfMemoryError),
                    )
                    for _ in batch
                ]
            for i, comp in zip(indices, completions):
                out[i] = comp
        return [c for c in out if c is not None]

    def _chat_loaded(
        self,
        lm: LoadedModel,
        batch: list[ChatRequest],
        params: SamplingParams,
    ) -> list[Completion]:
        tok = lm.tokenizer
        instruct = lm.spec.checkpoint != "random"
        prompts = []
        for req in batch:
            text = apply_chat_template(
                lm.spec.family, req.system, req.user, instruct
            )
            prompts.append(
                _trim_prompt(
                    tok.encode(text),
                    lm.cfg.max_seq_len - params.max_new_tokens,
                )
            )

        t0 = time.monotonic()
        result = generate(
            lm.params,
            lm.cfg,
            prompts,
            max_new_tokens=params.max_new_tokens,
            eos_ids=list(tok.eos_ids),
            pad_id=tok.pad_id,
            greedy=params.greedy,
            temperature=params.temperature,
            top_k=params.top_k,
            top_p=params.top_p,
            seed=params.seed,
            timeout_s=params.timeout_s,
            device=self.device,
        )
        total_time = time.monotonic() - t0

        # Per-row attribution (reference: engine/tpu.py _chat_loaded):
        # decode time in proportion to each row's decoded tokens, the
        # prefill/overhead remainder split evenly; rows sum to the totals.
        tok_total = float(result.n_generated.sum())
        prefill_share = (total_time - result.decode_time_s) / len(batch)
        completions = []
        for row in range(len(batch)):
            n = int(result.n_generated[row])
            frac = (n / tok_total) if tok_total > 0 else 1.0 / len(batch)
            decode_share = result.decode_time_s * frac
            completions.append(
                Completion(
                    text=tok.decode(result.tokens[row, :n]),
                    usage=Usage(
                        input_tokens=len(prompts[row]),
                        output_tokens=n,
                        device_time_s=prefill_share + decode_share,
                        decode_tokens=n,
                        decode_time_s=decode_share,
                        prefill_time_s=result.prefill_time_s / len(batch),
                    ),
                )
            )
        return completions
