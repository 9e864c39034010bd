"""The ``tpu://`` provider served by PyTorch on one GPU: ``GpuEngine``.

Counterpart of ``adversarial_spec_tpu/engine/tpu.py:TpuEngine``: requests
are grouped by model alias, each group's prompts are templated, encoded
and trimmed, and the group is served by one of two paths, as the
reference routes them:

- dense specs (the registry default): the rows of one ``generate()``
  call;
- single-device ``kv="paged"`` specs: the continuous batcher
  (``engine/scheduler.py``) through ``_chat_continuous`` — opponent pools
  larger than the slot count, early-EOS rows freeing their pages
  mid-round, the cross-round prefix cache (the model keeps its batcher, so
  round R+1 adopts round R's blocks) and streaming consumers with early
  cancel.

Per-row ``Usage`` is attributed exactly as the reference does. Failures
are captured into ``Completion.error`` per group, never raised.

Weight-quantized specs (``quant="int8"`` / ``"int4"``) are served on both
paths: the weights are quantized at load (``engine/loader.py``) and every
projection and the head run the dequant-matmul kernels B5/B6
(``ops/quant_matmul.py``). An int8 KV cache (``kv_dtype="int8"``, with or
without ``quant``) is served on both paths too: ``generate()``'s dense
cache and the batcher's page pool store int8 K/V with per-(token, head)
scales, read by the int8-KV variants of B1-B4.

Weights come from ``_materialize``, as the reference's do: a
``random`` checkpoint is a synthetic init; an HF safetensors directory is
read from the port's native cache (``engine/checkpoint.py``) when one
matches, else converted (``engine/loader.py``) and then cached. The
``checkpoint_load`` chaos seam fires there.

This slice keeps one resident model at a time (loading another alias
drops the previous one). Specs the port cannot serve yet — multi-device
meshes, a paged spec whose budget leaves no room for a bucketed prompt
(the reference's round-synchronous ``generate(paged=True)`` corner), and a paged request with ``request_deadline_s > 0`` (the
batcher's per-request deadline watchdog) — get a "not yet ported" error;
they are never served silently another way. A ``kv_dtype`` other than
``""`` or ``"int8"`` is an error.

Every failure is classified as the reference's ``TpuEngine`` classifies
it (``resilience.faults.classify``): the kind sets
``Completion.transient`` and is counted at the injected fault's own seam,
else at ``generate``. The refusals' wording names no fault marker, so
each one classifies as ``BUG``: a refusal is never retried, hedged, or
counted as a TIMEOUT.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import time
from dataclasses import dataclass

import torch

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine import checkpoint as ckpt_mod
from adversarial_spec_tpu_torch.engine import interleave as interleave_mod
from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine import registry as registry_mod
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine.generate import (
    MIN_BUCKET,
    bucket_length,
    generate,
)
from adversarial_spec_tpu_torch.engine.loader import materialize_params
from adversarial_spec_tpu_torch.engine.registry import ModelSpec
from adversarial_spec_tpu_torch.engine.scheduler import (
    ContinuousBatcher,
    SchedRequest,
)
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
from adversarial_spec_tpu_torch.models.transformer import check_kv_dtype
from adversarial_spec_tpu_torch.resilience import faults, injector
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


def fits_batcher(cfg: ModelConfig, max_new_tokens: int) -> bool:
    """True when a bucketed prompt still fits beside the budget — the
    reference's gate for serving a paged spec through the batcher."""
    return cfg.max_seq_len - max_new_tokens >= MIN_BUCKET


def unported_reason(
    spec: ModelSpec, max_new_tokens: int = 0, request_deadline_s: float = 0.0
) -> str | None:
    """Why the port cannot serve ``spec`` at this budget and per-request
    deadline yet, or None."""
    if math.prod(spec.mesh.values()) > 1:
        return f"a multi-device mesh {spec.mesh}"
    if spec.kv == "paged":
        cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
        if not fits_batcher(cfg, max_new_tokens):
            return (
                "kv='paged' with a budget that leaves no room for a "
                "bucketed prompt (the round-synchronous generate(paged=True))"
            )
        if request_deadline_s > 0:
            # The reference's batcher evicts an over-deadline slot;
            # serving the request to its budget instead would ignore the
            # deadline silently. The dense generate() reads no such
            # field, in the reference either. The wording avoids the
            # fault markers of resilience/faults.py: a refusal must
            # classify as BUG, never as the watchdog's own TIMEOUT.
            return (
                "the paged batcher's per-request deadline watchdog "
                "(request_deadline_s > 0)"
            )
    return None


@dataclass
class LoadedModel:
    spec: ModelSpec
    cfg: ModelConfig
    params: dict
    tokenizer: object
    # The paged path's persistent batcher and the knobs it was built
    # with: round R+1 reuses round R's (and its warm prefix cache) while
    # the key matches.
    batcher: ContinuousBatcher | None = None
    batcher_key: tuple | None = None


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
        params, cfg = self._materialize(spec, _DTYPES.get(spec.dtype, torch.bfloat16))
        self._resident = LoadedModel(
            spec, cfg, params, load_tokenizer(spec.tokenizer)
        )
        return self._resident

    def _materialize(self, spec: ModelSpec, dtype: torch.dtype) -> tuple[dict, ModelConfig]:
        """Params via the fastest available source: the native cache
        (converted once, read straight onto the device) → HF safetensors
        conversion (then cached) → synthetic init."""
        injector.fire("checkpoint_load")
        cfg = get_config(spec.family, spec.size, max_seq_len=spec.max_seq_len)
        cache_path = None
        if spec.checkpoint != "random":
            cache_path = ckpt_mod.cache_dir_for(
                spec.checkpoint,
                spec.family,
                spec.size,
                spec.dtype,
                spec.quant,
                tied_embeddings=cfg.tied_embeddings,
            )
        if cache_path is not None and ckpt_mod.has_native(cache_path):
            # The cache is an optimization in BOTH directions: a corrupt
            # or layout-incompatible cache falls back to HF conversion
            # instead of permanently breaking the model.
            try:
                params = ckpt_mod.load_native(
                    cache_path, cfg, dtype, spec.quant, self.device
                )
                return params, cfg
            except Exception as e:
                print(
                    f"warning: native checkpoint cache unreadable "
                    f"({e}); reconverting from HF",
                    file=sys.stderr,
                )
                shutil.rmtree(cache_path, ignore_errors=True)
        params, cfg = materialize_params(
            spec.checkpoint,
            spec.family,
            spec.size,
            dtype=dtype,
            max_seq_len=spec.max_seq_len,
            quant=spec.quant,
            device=self.device,
        )
        if cache_path is not None:
            try:  # the write side is best-effort too
                ckpt_mod.save_native(params, cache_path)
            except Exception as e:
                print(
                    f"warning: native checkpoint cache write failed: {e}",
                    file=sys.stderr,
                )
        return params, cfg

    def chat(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        """Complete every request (one completion per request, in order).
        ``consumer(row, text_so_far)`` streams each request's text and may
        cancel it by returning False — a batcher feature: the dense path
        serves the blocking result only, as the reference's does."""
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
            # The caller's consumer indexes rows of ITS batch; re-map each
            # group's row back through the group's indices.
            group_consumer = None
            if consumer is not None:

                def group_consumer(row, text, _c=consumer, _ix=tuple(indices)):
                    return _c(_ix[row], text)

            try:
                spec = registry_mod.resolve_model_spec(f"tpu://{alias}")
                check_kv_dtype(spec.kv_dtype)
                reason = unported_reason(
                    spec, params.max_new_tokens, params.request_deadline_s
                )
                if reason is not None:
                    raise NotImplementedError(
                        f"tpu://{alias} needs {reason}, which is not yet "
                        "ported to the PyTorch/CUDA package"
                    )
                completions = self._chat_loaded(
                    self._load(alias), batch, params, group_consumer
                )
            except Exception as e:  # degrade, never raise (parity: ref)
                msg = f"{type(e).__name__}: {e}"
                kind = faults.classify(e)
                # Injected faults know their seam; real ones are counted
                # where caught.
                faults.record(kind, getattr(e, "seam", "generate"))
                obs_mod.emit(
                    obs_mod.FaultEvent(
                        seam=getattr(e, "seam", "generate"),
                        kind=kind.value,
                        error=msg,
                        trace_id=batch[0].trace_id if batch else "",
                    )
                )
                obs_mod.autodump("fault")
                completions = [
                    Completion(error=msg, transient=kind.transient)
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
        consumer=None,
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

        if lm.spec.kv == "paged":
            return self._chat_continuous(lm, prompts, params, consumer)

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
            kv_dtype=lm.spec.kv_dtype,
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

    def _chat_continuous(
        self,
        lm: LoadedModel,
        prompts: list[list[int]],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        """Serve one model's requests through the ContinuousBatcher.

        Pool capacity covers CONCURRENT residency (the max_batch largest
        requests, bucketed to a power of two so repeat rounds of similar
        size keep the same batcher), not the whole queue: finished rows
        free their pages and queued requests admit into them.
        """
        tok = lm.tokenizer
        # The batcher checks bucket_length(prompt) + budget against the
        # model context; re-trim against the bucketed length.
        max_prompt = lm.cfg.max_seq_len - params.max_new_tokens
        while max_prompt > 1 and bucket_length(max_prompt) > max_prompt:
            nxt = bucket_length(max_prompt) // 2
            if nxt >= max_prompt:  # at the minimum bucket already
                break
            max_prompt = nxt
        prompts = [_trim_prompt(p, max_prompt) for p in prompts]
        n_slots = min(len(prompts), 8)
        per_req = sorted(
            (bucket_length(len(p)) + params.max_new_tokens for p in prompts),
            reverse=True,
        )
        need = sum(per_req[:n_slots])
        capacity = 2048
        while capacity < need:
            capacity *= 2
        seed = (
            params.seed
            if params.seed is not None
            # None means fresh entropy: unseeded rounds must vary.
            else int.from_bytes(os.urandom(4), "little")
        )
        batcher_key = (
            n_slots,
            capacity,
            params.max_new_tokens,
            lm.spec.kv_dtype,
            prefix_mod.config().enabled,
            prefix_mod.config().max_pages,
            interleave_mod.config().enabled,
        )
        t0 = time.monotonic()
        try:
            results, decode_time = self._run_batcher(
                lm, batcher_key, prompts, params, seed, consumer
            )
        except BaseException:
            # A batcher left mid-drain (stale results, occupied slots)
            # must not be reused next round: drop it.
            lm.batcher = None
            lm.batcher_key = None
            raise
        total_time = time.monotonic() - t0

        # The dense path's attribution: decode time splits by decoded
        # tokens, the prefill/overhead remainder evenly.
        tok_total = float(sum(r.n_generated for r in results)) or 1.0
        overhead = total_time - decode_time
        completions = []
        for r in results:  # sorted by req_id == prompt order
            decode_share = decode_time * r.n_generated / tok_total
            completions.append(
                Completion(
                    text=tok.decode(r.tokens[: r.n_generated]),
                    cancelled=r.cancelled,
                    usage=Usage(
                        input_tokens=len(prompts[r.req_id]),
                        output_tokens=r.n_generated,
                        device_time_s=overhead / len(results) + decode_share,
                        decode_tokens=r.n_generated,
                        decode_time_s=decode_share,
                        cached_tokens=r.cached_tokens,
                        prefill_time_s=r.prefill_time_s,
                    ),
                )
            )
        return completions

    @staticmethod
    def _make_stream_callback(tok, consumer, row):
        """Incremental detokenization for one request: the batcher hands
        ALL emitted ids so far; decode the full prefix each delivery (a
        partial multi-byte token decodes differently once its
        continuation arrives, so suffix-diffing could hand the consumer
        text the blocking path never produces). Returning False asks the
        batcher to cancel the request."""

        def on_tokens(token_ids) -> bool:
            return bool(consumer(row, tok.decode(token_ids)))

        return on_tokens

    def _run_batcher(self, lm, batcher_key, prompts, params, seed, consumer=None):
        """Reuse (or build) the model's persistent batcher and drain this
        call's requests through it. Returns ``(results, decode_time_s)``,
        the decode time being THIS call's delta on the batcher's
        cumulative counter."""
        tok = lm.tokenizer
        n_slots, capacity = batcher_key[0], batcher_key[1]
        if lm.batcher is not None and lm.batcher_key == batcher_key:
            # Round R+1 reuses round R's batcher and its warm prefix cache.
            batcher = lm.batcher
            batcher.reconfigure_sampling(
                greedy=params.greedy,
                temperature=params.temperature,
                top_k=params.top_k,
                top_p=params.top_p,
                seed=seed,
            )
            # Speculation re-resolves from the process config every drain;
            # the batcher is idle here (run_all drains fully).
            sp = spec_mod.config()
            batcher.reconfigure_speculative(enabled=sp.enabled, gamma=sp.gamma)
        else:
            lm.batcher = None  # free the old pool before the new one
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            batcher = ContinuousBatcher(
                lm.params,
                lm.cfg,
                max_batch=n_slots,
                capacity_tokens=capacity,
                max_new_cap=params.max_new_tokens,
                eos_ids=list(tok.eos_ids),
                greedy=params.greedy,
                temperature=params.temperature,
                top_k=params.top_k,
                top_p=params.top_p,
                seed=seed,
                kv_dtype=lm.spec.kv_dtype,
            )
            lm.batcher = batcher
            lm.batcher_key = batcher_key
        decode_t0 = batcher.decode_time_s
        stream_on = consumer is not None and stream_mod.config().enabled
        for i, ids in enumerate(prompts):
            batcher.submit(
                SchedRequest(
                    req_id=i,
                    prompt_ids=ids,
                    max_new_tokens=params.max_new_tokens,
                    on_tokens=(
                        self._make_stream_callback(tok, consumer, i)
                        if stream_on
                        else None
                    ),
                )
            )
        results = batcher.run_all(timeout_s=params.timeout_s)
        return results, batcher.decode_time_s - decode_t0
