#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # device, build and kernel phases only
    python3 chip_smoke.py --profile  # also profile one more chat call
    python3 chip_smoke.py --only paged,cli,batcher,pgen,serve,fleet,mesh,sp,agree
                                     # device, build and the named phases
                                     # only (no kernels or ok line)
    python3 chip_smoke.py --qmm-only # device, build and B5/B6 only: their checks
                                     # and device times (chiprun_out/chip_smoke_qmm.json);
                                     # run from another checkout's root, it times that
                                     # checkout's B5/B6 the same way

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card's name, and its name and power limit as nvidia-smi
   reports them (that line is printed raw as well);
2. build   — compiles every CUDA source of the port with nvcc (in
   parallel), from this checkout, into build/kernels, and prints each
   attention kernel's registers, spills and shared memory (``ptxas``);
3. kernels — each kernel at its main path's shapes against its plain
   PyTorch version on the card, with the tolerance stated, bf16 and f32:
   - dense B1/B2 (Llama-3-8B: B=4, Hq=32, Hkv=8, D=128, T=4224; S=9 for
     the verify) with left-pad windows, an empty window and softcap;
   - paged B3/B4 (the batcher's 8 slots, page 64, a 128-page table =
     8192/64; S=9) with scattered pages, -1 padding, a trash page inside
     a window, a NaN-poisoned trash page and unused pages, left pads, an
     empty row and [B, 1] starts;
   each timed on the device (CUDA graphs replayed between CUDA events, so
   the host's per-call work is left out; ``call_ms`` is the eager call,
   host included) with a cold L2, beside its plain version (eager),
   scaled_dot_product_attention over the same windows (a yardstick only —
   the port never calls it; for B3/B4 the pages are gathered dense
   beforehand, untimed; timed as the kernel is) and the least time the
   card could take; B2 and B4 also over a range of forced split counts;
   - the dequant-matmuls B5 (int8) and B6 (int4) at Llama-3-8B's weights
     (K, N) = (4096, 4096) wq/wo, (4096, 1024) wk/wv, (4096, 14336)
     w_gate/w_up, (14336, 4096) w_down and (4096, 128256) the head (f32
     out), at M = 4, 36, 72, 512, 1024 and 4096 rows (the head at the
     decode rows and at the 1 or 4 rows a prefill chunk ends), plus edge
     cases (M=1, int4 odd K=255 at decode and prefill rows, N=40 and
     N=144, ragged rows past 128, a 3-D x, unaligned x row strides,
     weight scales near 1e-12 and 1e12), each main case called twice and
     required bit-identical; bf16 device times by CUDA-graph replay
     (``ms``; ``call_ms`` the eager call) over enough weight copies to
     span twice the L2, beside the plain version, a bf16 cuBLAS product on
     the weight dequantized beforehand, timed the same way (the
     yardstick; the port never calls it), and the bound (packed weight +
     x + output bytes over 3.35 TB/s, or 2MKN over 989 TFLOP/s). The
     kernels line gives B5/B6 as one forward (224 layer products and the
     head; B5 at M=36, B6 at M=72); each case and the per-forward sums at
     every M are in chip_smoke.json, printed as "qmm" lines; the decode
     path's K split is swept over 1-16 blocks at the line's M, and the
     planned split is timed against whole-K tiles at 96-256 rows;
   - the int8-KV variants of B1-B4 (kv_dtype="int8": int8 K/V beside
     per-(slot, head) f32 scales) at the same shapes and windows, bf16 and
     f32 q, the pool's trash and unused pages holding int8 -128 and NaN
     scales, B4 over one position against B3 and the plain version within
     the tolerance; timed beside the plain version, SDPA over the cache
     dequantized to bf16 beforehand and the bound (int8 K/V and scale
     bytes in the windows, q and out);
   - the split-KV verify kernels B2/B4 (csrc/verify_attention.cu), float
     and int8 K/V, bf16 and f32 q, head_dim 64/128/256, on their edges: a
     ragged tail past T, a one-tile union shorter than n_split, an empty
     row, [B, 1] starts, softcap, 64 query rows per KV head, unaligned
     strides, pages of 16 and 64 slots with a trash entry, -1 padding and
     a NaN-poisoned trash page, B4 over one position against B3;
   - the split-KV S=1 kernels B1/B3 (csrc/decode_attention.cu), float and
     int8 K/V, bf16 and f32 q, head_dim 64/128/256, on their edges: a
     ragged tail past T, left pads, one slot (exactly v), an empty window,
     softcap, 4, 1 and 7 query heads per KV head, unaligned strides, pages
     of 1, 8, 24 and 64 slots with a trash entry, -1 padding and a
     poisoned trash page, B4 at S=1 against B3; then B4 on pages of 8 and
     24 slots, B2/B4 over a 33-position span (132 query rows per KV
     head: two launches in bf16; f32 runs from the kernel's own row limit)
     and B4 at D = 256 over 128-slot pages (S = 9 and 33); B1 and B3, like
     B2 and B4, are also timed over a range of forced split counts;
   - the mesh wrappers on a virtual mesh (every shard on the one card) at
     phase mesh's shapes, each one launch of a sharded entry (B1 / B3
     with a shard axis) for all the shards: W1 at Llama-3-70B's tp=8
     decode (64 query heads over 8 KV heads: one KV head a shard, B=4,
     T=4224), W3 and W2 at Llama-3-8B's paged decode on tp=2 and on
     dp=2 × tp=2 (128-slot pages, 33 a row, each dp slice's trash page
     NaN-poisoned, the global trash id inside a window); each against its
     plain version (B1's / B3's on each shard), float and int8 K/V,
     timed as B1/B3 (all shards of one call), beside SDPA on the
     unsharded tensors and the bound (the sum of the shards' bytes), with
     the launches one call made;
4. slice   — the dense path: GpuEngine.chat on tpu://random-8b (Llama-3-8B
   at full width, bf16, random weights from seed 0) for four opponent
   requests, greedy, 128 new tokens, speculation on, then the same round
   with speculation off (every decode step B1: its wall, decode seconds
   and launches); B1/B2 launch counters are zeroed just before each call
   and read just after, B2 must launch in the first and B1 in the second;
   with ``--profile``, one more chat call runs under torch.profiler
   (device time by kernel, idle share);
5. paged   — the paged path: GpuEngine.chat on a temporary registry entry
   random-8b with kv="paged" (the continuous batcher): twelve opponent
   requests through 8 slots, 128 new tokens, greedy; round 1 with
   speculation on, round 2 the same requests with it off, on the same
   batcher. Round 2 runs the pipelined drive loop at its default depth
   2 and prints a ``paged depth`` line: perf.interleave's depth, the
   fetches that found their step's copies landed against those the depth
   bound made wait, and the round's wall beside the card's name and power
   limit; rounds 3 and 4 (the first four requests, 32 new tokens,
   speculation off, a rebuilt batcher each) run at depth 1 and depth 2
   and must give the same texts. B3/B4 counters are zeroed before round 1 and read after round
   4; B4 must launch in round 1, B3 in rounds 2-4, and round 2 must hit
   the prefix cache; with ``--profile``, one more round (speculation on,
   warm cache) runs under torch.profiler;
6. quant   — weight-quantized serving on temporary registry entries:
   (a) random-8b with quant="int8" on the dense path (the slice's four
   requests), (b) random-8b with quant="int4" and kv="paged" (the paged
   slice's twelve requests through 8 slots, one round); speculation on,
   128 new tokens each, greedy. Every counter is zeroed just before each
   chat() and read just after: B5 and B2 must launch in (a), B6 and B4 in
   (b). Reports walls, prefill/decode seconds, tokens/s, resident weight
   bytes beside the bf16 model's, and peak memory; with ``--profile``,
   one more chat() of each runs under torch.profiler;
7. kv8     — the int8 KV cache on temporary registry entries: (a)
   random-8b with kv_dtype="int8" on the dense path (the slice's four
   requests, speculation on); (b) random-8b with kv="paged",
   kv_dtype="int8" and quant="int4" (the paged slice's twelve requests
   through 8 slots, round 1 speculation on, round 2 off, one batcher).
   Counters zeroed just before each chat() and read just after: B2-i8 must
   launch in (a), B1-i8 in (a) repeated with speculation off, B4-i8 and B6
   in (b) round 1, B3-i8 in round 2, the float-cache B1-B4 never, and
   round 2 must hit the prefix cache.
   Reports walls, prefill/decode seconds, tokens/s, the cache or pool
   bytes beside the bf16 layout's, resident weight bytes and peak memory;
8. cli     — the user's entry point: ``critique`` through the port's CLI
   (``adversarial_spec_tpu_torch.cli.main`` in this process, the spec on
   stdin, sessions and registry in a temporary directory under build/),
   on tpu://random-8b at full width (Llama-3-8B, bf16, random weights
   from seed 0), greedy, 128 new tokens, a ~3 KB spec from
   spec_document: (a) the dense path, four opponents, round 1 with
   speculation on (B2 must launch), round 2 ``--resume`` with
   ``--no-speculative`` (B1 must launch); (b) the paged path, on a
   temporary registry entry random-8b with kv="paged" that the CLI's own
   ``registry add-model`` writes: twelve opponents through 8 slots over
   two rounds of one session, B4 in round 1, B3 in round 2, and round 2
   must report prefix-cache hits in its ``perf.prefix_cache``. B1-B4's
   counters are zeroed just before each round and read just after; each
   round prints one ``cli round`` line (the round wall from
   ``perf.spans.round``, decode tokens/s, per-model usage, launches, peak
   device memory, all_agreed, perf.interleave's pipeline depth and
   perf.obs.retrace's totals). Every round's ``--json`` must report
   pipeline depth 2; each paged round's retrace watch must have observed
   its dispatches with no unexpected recompile. The process-wide knobs
   the CLI sets are restored after it;
9. hf      — HF safetensors checkpoints from the user's entry point,
   at a cut depth (this phase and pool: Llama-3-8B at full width with 8
   of its 32 layers, HF_POOL_LAYERS; a load's correctness, the cache and
   residency do not need the rest): random-8b's own weights (init on the
   card, seed 0, bf16, 5.6 GB) written under build/ as Meta lays the model out
   (four bf16 shards with HF names and torch's [out, in] Linear layout, an
   index and a config.json from the registered config; the port's own
   safetensors writer), registered by ``registry add-model --checkpoint``
   (no tokenizer: the byte tokenizer) and served through ``critique``:
   (a) ``hf-8b`` dense, the four opponents of phase cli (a) — a cold load
   (HF conversion, then the native-cache write), B2 and B1 must launch;
   the engine dropped and the round run again — a warm load from the
   native cache, greedy text identical; (b) ``hf-8b-int4`` (kv=paged,
   quant=int4) on the same directory, twelve opponents through 8 slots,
   round 1 speculation on (B4, B6), round 2 ``--resume
   --no-speculative`` (B3, B6). After each load every served leaf must be
   bit-identical to the init it was written from (the int4 leaves to
   ``quantize_params`` of it). Each load and cache write prints an ``hf
   load`` line (seconds, bytes read, the reader's largest host staging,
   device memory before it and its peak, resident bytes); each round a
   ``cli round`` line. The phase fails with the bytes it needs when
   build/ lacks the disk (~17 GB at its peak with phase pool's int8
   cache) and leaves its checkpoint to phase pool;
10. pool   — real checkpoints as an opponent pool: phase hf's checkpoint
   registered four times by ``registry add-model``, each alias with its
   own ``tokenizer.json`` from tests/torch_tokenizers/ (Llama-3, Mistral,
   Gemma-2 and Qwen2 layouts, read by the port's own reader): pool-a
   bf16, pool-b int8, pool-c int4 with kv=paged, pool-d bf16 (~16 GB of
   weights at 8 layers), one ``critique`` session naming all four, 128 new tokens,
   greedy, prefix cache off: round 1 speculation on (B2, B4, B5, B6 must
   launch), rounds 2 and 3 ``--resume --no-speculative`` (B1, B3, B5,
   B6). (a) At the natural budget: rounds 2 and 3 must load nothing. (b) A fresh engine
   under ADVSPEC_HBM_BUDGET_BYTES = pool-a + pool-b + half of pool-c (two
   of the four fit) with ``--weight-host-mb 48000``: the rounds must demote,
   promote and consume a prefetch. Each alias's greedy text and generated
   ids must be identical between (a) and (b). Each round prints a ``cli round`` line
   (its wall, perf.weights, each swap's bytes and seconds, prefetch hits,
   encode seconds per prompt, peak device memory, launches). B1-B6's
   launches in the kernels line are this phase's. The checkpoint is
   deleted after it, on failure too;
11. batcher — the rest of the paged batcher at full width: random-8b on a
   ``registry add-model --kv paged`` entry, four opponents on one spec
   whose prompt the engine trims to 4096 tokens (64 blocks of 8 MiB), 32
   new tokens, greedy, through ``critique`` and, where the CLI cannot say
   it, ``GpuEngine.chat`` and the engine's batcher. Rounds are compared
   by the ids they generate (the byte tokenizer drops most of random
   weights' ids from the text): (a) the host tier (``--prefix-cache-pages
   8 --kv-host-mb 1024``: blocks demote and promote, each call timed on
   the card between CUDA events; the allocator's and tiers' invariants
   clean; ids those of the round again, and of ``--no-kv-tier`` with and
   without the cap; stale promotions planted must change them), (b) the
   disk tier (``--kv-store-dir`` under build/, then the same round in a
   fresh process: rehydrated blocks, the same ids), (c) an int8 KV cache
   (demoted blocks carry their scale pages; the ids of tier-off; B4-i8,
   then B3-i8 ``--no-speculative``), (d) in the fused and then the legacy
   loop, a transient ``scheduler_chunk`` fault naming one slot (requeued
   once), a permanent ``kv_alloc`` fault (one request fails) and a
   per-request deadline expiring mid-decode (partial ids), each with the
   other rows' ids those of a fault-free run (B3), (e) ``--no-interleave``
   (the legacy loop) with the fused loop's ids. Prints ``batcher round``
   lines (walls, prefill seconds, ``perf.kv_tier``), ``batcher tier
   swaps``, ``batcher faults`` and ``batcher id checks``; B3's, B4's and
   their int8 modes' launches join the kernels line;
12. pgen   — the round-synchronous ``generate(paged=True)``: a temporary
   registry entry random-8b with kv="paged" and max_seq_len=256, four
   opponents through ``critique`` at 192 new tokens (256 - 192 < 128:
   no bucketed prompt fits, so no batcher), greedy: B3 must launch, B4,
   B1 and B2 must not, and the engine builds no batcher; again with
   kv_dtype="int8" (B3-i8 only); then the dense alias at the same budget
   with ``--no-speculative`` (B1). Each round's first B3 call is
   recomputed by the plain version on the card; one ``pgen round`` line
   per round (wall, prefill and decode seconds, tokens/s, launches,
   peak memory); the rows whose generated ids equal the dense round's
   are counted, not gated (B1 and B3 reduce bf16 in other orders);
13. serve  — the serve daemon: ``cli.main(["serve", ...])`` in a
   subprocess (SERVE_BOOT adds two signal hooks: launch counts out, the
   speculation switch flipped), its registry in a temporary HOME with
   random-8b on a ``registry add-model --kv paged`` entry that reads
   tests/torch_tokenizers/llama3/tokenizer.json, driven through the
   port's ``serve/client.py``; four opponents, a ~3 KB spec, 64 new
   tokens, greedy. (a) one debate alone equals the same round through
   ``critique --json`` (text and tokens per opponent; B4), then its
   second round with speculation off (B3), one weight load; (b) a
   batch-tier debate, then two interactive ones of two tenants: all
   complete, a preempted unit's re-admission hits the prefix cache,
   ``check`` ok, one load; (c) SIGTERM with a debate in flight: it
   completes, exit 0, the drain report counts it. ``serve debate`` lines
   (wall, TTFT, tokens/s, preemptions, sheds, launches) and one ``serve
   drain`` line; B3's and B4's launches join the kernels line;
14. fleet  — two replicas of random-8b (``--kv paged``, the Llama-3
   tokenizer fixture) behind the fleet router, four opponents, a ~3 KB
   spec, 64 new tokens, greedy, through ``critique --fleet
   --fleet-replicas 2`` in this process: (a) in-process replicas, two
   debates the hash ring places on different replicas and round 2 of the
   first, every text equal to a single-engine round's, round 2 an
   affinity hit with cached tokens, B4 and B3 launched and their first
   calls held to the plain versions; (c) the ``Autoscaler`` scales (a)'s
   fleet in (device memory falls by a weight set at once, no garbage
   collection) and out, and the new replica serves the baseline's texts;
   (b) ``--fleet-transport worker``: two worker processes sharing a KV
   store, the serving one SIGKILLed after two completions — the same
   texts, 2 reissued and 0 duplicated completions, the survivor
   rehydrating blocks and its ``check`` clean. ``fleet round``, ``fleet
   scale`` and ``fleet failover`` lines; (a)'s and (c)'s B3/B4 launches
   join the kernels line;
15. mesh   — the multi-device mesh from ``GpuEngine.chat`` on virtual
   meshes (``GpuEngine(devices=[cuda] * n)``: every shard on the one
   card), four opponents, a ~3 KB spec, 64 new tokens, greedy: (a)
   tpu://random-70b on its own {"tp": 8} mesh at full width (Llama-3-70B:
   dim 8192, 64 query over 8 KV heads, ffn 28672) with 8 of its 80
   layers, dense, round 1 speculation on (B2 on every shard), round 2
   off (W1 every step); (b) random-8b at full width and depth, dense on
   {"dp": 2} (the sharded program: B2 a shard, W1), paged on {"tp": 2} (W3) and on
   {"dp": 2, "tp": 2} (W2). Counters zeroed before each round; each
   named kernel must serve every shard at least once; each wrapper's
   launches must be one a device group a layer a decode step (one a
   layer on a virtual mesh; ``mesh round`` lines give them beside the
   shards served); each wrapper's first call is recomputed by its plain
   version (bf16 tolerance); the tp=2
   round's first-step logits are held to one device's on the same
   prompts (bf16 tolerance of the largest logit); each engine is dropped
   before the next and device memory must fall back. ``mesh round``
   lines carry the mesh, its devices and which collective ran. With two
   or more cards it also runs (b)'s tp=2 alias through ``critique``
   over cuda:0 and cuda:1 (NCCL); with one it says it did not;
16. sp     — the sequence-parallel axis from ``GpuEngine.chat`` on
   registry aliases with an sp mesh axis, virtual meshes on the one card,
   greedy, speculation at its default, 32 new tokens: (a) Llama-3.2-3B at
   full width and depth on {"sp": 4}, dense, two opponents on a
   ~16,000-token spec (BASELINE config 5's context); (b) random-8b on
   {"sp": 2}, paged, int8 KV, four opponents, ~6,000 prompt tokens (W3 →
   B3-i8); (c) random-70b at full width with 8 of 80 layers on {"sp": 2,
   "tp": 8}, dense, one opponent, ~7,500 prompt tokens. The ring must
   carry every prefill (calls and hops counted; hops = ``ring_hops``; the
   chunked prefill must not run); the first-step logits are held to the
   same prompts without sp (one device's chunked prefill; for (c)
   {"tp": 8}) within the bf16 tolerance of the largest logit; the sp
   replicas share one weight copy; B2, W1 and W3 on an int8 KV cache must
   launch, and W1 / W3 once a device group a layer a decode step;
   each engine is dropped and device memory must fall back. ``sp round``
   lines give wall, prefill and decode seconds, tok/s, peak memory,
   weight bytes, launches and which way each collective ran;
17. agree  — tiny f32 models decoded greedily on the card (kernels) and on
   the CPU (plain versions) give identical tokens: dense generate() with
   speculation on (B2, or B2-i8, must launch), generate(paged=True) (B3,
   or B3-i8), and the paged batcher with speculation on and off (off: at
   pipeline depth 1 and 2 on the card, both equal to the CPU's, B3 or
   B3-i8 launched at depth 2); full
   precision, the same weights quantized int8 (B5) and int4 (B6), and an
   int8 KV cache beside full-precision and int4 weights; and generate()
   on virtual {"tp": 2}, {"dp": 2} and {"dp": 2, "tp": 2} meshes, dense
   and paged (B2, W3, W2 on dp=2 and on dp=2 x tp=2), and on the sp
   meshes {"sp": 2} dense with speculation, {"sp": 2, "tp": 2} dense,
   {"dp": 2, "sp": 2} paged (W2) and {"sp": 2} paged with int8 KV (W3,
   B3-i8), the ring carrying each prefill.

Each phase's line carries its ``seconds``; a ``seconds`` line sums them
up by phase. Then one ``kernels`` JSON line and, last, ``{"ok": true,
"device": ...}``.
Results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adversarial_spec_tpu_torch"
# The phases ``--only`` runs (each ``phase_<name>(torch)``).
ONLY_PHASES = ("paged", "cli", "batcher", "pgen", "serve", "fleet", "mesh", "sp", "agree")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
B, HQ, HKV, D, S_SPAN = 4, 32, 8, 128, 9
T_CACHE = 4096 + 128  # the slice's 4096-token bucket + 128 new tokens
NS, PAGE, P_TAB = 8, 64, 128  # batcher slots, page size, 8192 / 64 pages
N_ROTATE = 4  # distinct caches the timing loops cycle through
# Each kernel of the port: (its source under the package, the TPU kernel
# it replaces).
KERNELS = {
    "decode_attention": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:422"),
    "decode_attention_mq": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:249"),
    "paged_decode_attention": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:120"),
    "paged_decode_attention_mq": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:271"),
    "decode_attention_int8kv": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:422"),
    "decode_attention_mq_int8kv": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:249"),
    "paged_decode_attention_int8kv": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:120"),
    "paged_decode_attention_mq_int8kv": ("csrc/verify_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:271"),
    "matmul_int8": ("csrc/quant_matmul.cu", "adversarial_spec_tpu/ops/pallas_quant.py:180"),
    "matmul_int4": ("csrc/quant_matmul.cu", "adversarial_spec_tpu/ops/pallas_quant.py:216"),
    # The mesh wrappers: one launch of the sharded entries (B1 / B3 with a
    # shard axis) for the shards a card holds.
    "decode_attention_tp": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_decode.py:350"),
    "paged_decode_attention_tp": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:443"),
    "paged_decode_attention_dp_tp": ("csrc/decode_attention.cu", "adversarial_spec_tpu/ops/pallas_paged.py:372"),
}
MESH_WRAPPERS = ("decode_attention_tp", "paged_decode_attention_tp", "paged_decode_attention_dp_tp")


def kernel_row(name: str) -> str:
    """The kernels line's row of a counter: a mesh wrapper's int8-KV
    launches join its row (B1-B4's int8 entries have rows of their own)."""
    base = name.removesuffix("_int8kv")
    return base if base in MESH_WRAPPERS else name
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)  # one bf16 rounding of the output
F32_TOL = dict(rtol=5e-5, atol=5e-5)  # summation order over 4224 slots


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them:
    every wall this script prints is labelled with it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "not measured"


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call ``fn(i)`` from CUDA events, after one
    warm-up; ``i`` lets the caller rotate inputs so the L2 is cold."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int, torch) -> float:
    """Mean device milliseconds per call ``fn(i)``: the call for each of
    the N_ROTATE inputs is captured once in a CUDA graph (after an eager
    warm-up) and the graphs replay in turn between CUDA events, so the
    host's per-call work (Python, argument checks, the launches) is not
    in the time; the rotation keeps the L2 cold."""
    graphs = []
    for i in range(N_ROTATE):
        fn(i)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(i)
        graphs.append(g)
    graphs[0].replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        graphs[i % N_ROTATE].replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed(fn, iters: int, torch) -> dict:
    """A kernel's device time per call (``ms``, graph_ms) and the time of
    an eager call as the path makes it (``call_ms``, host work included:
    a host-bound call is timed by its enqueue rate)."""
    return {"ms": graph_ms(fn, iters, torch), "call_ms": cuda_ms(fn, iters, torch)}


SWEEP_SPLITS = (1, 2, 3, 5, 8, 9, 12)  # the verify kernels (B2, B4)
DECODE_SWEEP = (1, 2, 4, 8, 9, 12, 17, 24, 34, 48)  # the S=1 kernels (B1, B3)


def split_sweep(torch, fn, n_tiles: int, splits=SWEEP_SPLITS) -> dict:
    """Device ms of a split-KV call with n_split forced to each count of
    ``splits`` (capped by the tiles), beside the planner's choice."""
    from adversarial_spec_tpu_torch.ops import split_kv

    real = split_kv.plan_splits
    out = {}
    try:
        for n in splits:
            split_kv.plan_splits = lambda *args, n=n, **kw: max(1, min(n, n_tiles))
            out[str(n)] = graph_ms(fn, 20, torch)
    finally:
        split_kv.plan_splits = real
    return out


def spec_document(n_bytes: int, seed: int) -> str:
    """A spec-style markdown document of about ``n_bytes`` bytes."""
    topics = [
        "authentication", "rate limiting", "audit logging", "billing",
        "search indexing", "data retention", "webhooks", "notifications",
    ]
    parts = [f"# Product Spec {seed}: {topics[seed % len(topics)].title()}\n"]
    i = 0
    while sum(len(p) for p in parts) < n_bytes:
        t = topics[(seed + i) % len(topics)]
        parts.append(
            f"\n## {i + 1}. {t.title()}\n"
            f"- The service MUST expose {t} through a versioned API "
            f"(v{1 + i % 3}) with p99 latency under {50 + 10 * i} ms.\n"
            f"- Failures in {t} are retried with exponential backoff, at "
            f"most {3 + i % 4} attempts, and surfaced to the operator.\n"
            f"- Acceptance: an integration test covers {t} under load.\n"
        )
        i += 1
    return "".join(parts)[:n_bytes]


def window_bytes(starts, ends, T, per_slot):
    """Bytes of K/V a call must read: each row's union of windows."""
    total = 0
    for lo_row, hi_row in zip(starts, ends):
        spans = [(max(lo, 0), min(hi, T)) for lo, hi in zip(lo_row, hi_row)]
        spans = [(lo, hi) for lo, hi in spans if lo < hi]
        if spans:
            total += (max(h for _, h in spans) - min(lo for lo, _ in spans))
    return total * per_slot


# B1 windows: left pads, a full row, a single slot, an empty window.
B1_BOUNDS = [[0, T_CACHE], [700, T_CACHE], [1500, 3001], [2000, 2000]]
B1_SINGLE = [[0, T_CACHE], [700, T_CACHE], [3000, 3001], [1200, T_CACHE]]
# B2: rows desynchronized (own cache index), per-query causal ends.
B2_PADS = [0, 700, 1500, 2300]
B2_ENDS = [[c + j + 1 for j in range(S_SPAN)] for c in (4100, 4150, 4000, 4214)]
B2_STARTS = [[p] * S_SPAN for p in B2_PADS]
B2_STARTS_EMPTY = B2_STARTS[:3] + [B2_ENDS[3][:]]  # row 3: empty windows


def finish_bounds(results: dict) -> None:
    """Each result's bound: the larger of its bytes over the memory rate
    and its operations over the bf16 peak."""
    for r in results.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def sdpa(qq, kk, vv, mask):
    """scaled_dot_product_attention over a cache of KV heads each shared by
    a group of query heads: the library yardstick (the port never calls
    it)."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, enable_gqa=True)
    except TypeError:  # older torch: no enable_gqa
        g = qq.shape[1] // kk.shape[1]
        return F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1), attn_mask=mask
        )


def check_close(checks: list, name, got, want, tol, empty_row=None) -> float:
    """Raise unless ``got`` is finite (no poison leaked), within ``tol`` of
    ``want`` and, for ``empty_row``, exactly zero; record the case in
    ``checks`` and return the max abs error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output (poison leaked)")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if empty_row is not None and not bool((got[empty_row] == 0).all()):
        raise AssertionError(f"{name}: empty window did not give exact zeros")
    checks.append({"case": name, "max_abs_err": err, "tol": tol})
    return err


def phase_kernels(torch, da) -> tuple[dict, list]:
    from adversarial_spec_tpu_torch.ops import split_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results, checks = {}, []

    def cache(dtype):
        # A layer's slice of an [L, B, Hkv, T, D] cache, as the model reads.
        shape = (2, B, HKV, T_CACHE, D)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        return k[1], v[1]

    def qdraw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b1_bounds, b1_single = B1_BOUNDS, B1_SINGLE
    pads, ends, starts, starts_empty = B2_PADS, B2_ENDS, B2_STARTS, B2_STARTS_EMPTY

    def check(name, got, want, tol, extra=None):
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if extra is not None:
            extra(got)
        checks.append({"case": name, "max_abs_err": err, "tol": tol})
        return err

    def zeros_row(row):
        def f(out):
            sel = out[row]
            if not bool((sel == 0).all()):
                raise AssertionError("empty window did not give exact zeros")
        return f

    kw_b1, kw_b2 = {}, {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k, v = cache(dtype)
        q1 = qdraw((B, HQ, D), dtype)
        q2 = qdraw((B, S_SPAN, HQ, D), dtype)
        for label, bnd in (("windows", b1_bounds), ("single", b1_single)):
            bounds = torch.tensor(bnd, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention(q1, k, v, bounds, attn_softcap=cap)
                want = da.decode_attention_plain(q1, k, v, bounds, attn_softcap=cap)
                err = check(
                    f"B1 {tn} {label} softcap={cap}", got, want, tol,
                    zeros_row(3) if label == "windows" else None,
                )
                if label == "single":
                    # One valid slot: the output is v at that slot.
                    torch.testing.assert_close(
                        got[2].float(),
                        v[2, :, 3000].repeat_interleave(HQ // HKV, 0).float(),
                        rtol=0, atol=0,
                    )
                if dtype == torch.bfloat16 and label == "windows" and cap == 0.0:
                    kw_b1 = dict(q=q1, k=k, v=v, bounds=bounds, err=err, bnd=bnd)
        e_t = torch.tensor(ends, dtype=torch.int32, device=dev)
        for label, st in (("per-query", starts), ("empty", starts_empty)):
            s_t = torch.tensor(st, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention_mq(q2, k, v, s_t, e_t, attn_softcap=cap)
                want = da.decode_attention_mq_plain(q2, k, v, s_t, e_t, attn_softcap=cap)
                err = check(
                    f"B2 {tn} {label} softcap={cap}", got, want, tol,
                    zeros_row(3) if label == "empty" else None,
                )
                if dtype == torch.bfloat16 and label == "per-query" and cap == 0.0:
                    kw_b2 = dict(q=q2, k=k, v=v, starts=s_t, ends=e_t, err=err, st=st)
        # [B, 1] broadcast starts (global layers share one start per row).
        s1 = torch.tensor([[p] for p in pads], dtype=torch.int32, device=dev)
        got = da.decode_attention_mq(q2, k, v, s1, e_t)
        want = da.decode_attention_mq_plain(q2, k, v, s1, e_t)
        check(f"B2 {tn} broadcast-starts", got, want, tol)
    torch.cuda.synchronize()

    # ---- timing at the main path's shapes (bf16) ----
    # Calls rotate over N_ROTATE caches (4 x 69 MB > the 50 MB L2), so each
    # finds its cache cold, as each layer's decode step does.
    elem = 2
    rot = [(kw_b1["k"], kw_b1["v"])] + [
        cache(torch.bfloat16) for _ in range(N_ROTATE - 1)
    ]
    kv = lambda i: rot[i % N_ROTATE]  # noqa: E731
    a = kw_b1
    q, bounds = a["q"], a["bounds"]
    b1_bytes = window_bytes(
        [[lo] for lo, _ in a["bnd"]], [[hi] for _, hi in a["bnd"]],
        T_CACHE, 2 * HKV * D * elem,
    ) + 2 * q.numel() * elem + bounds.numel() * 4
    b1_valid = sum(max(hi - lo, 0) for lo, hi in a["bnd"])
    b1_ops = 4 * HQ * D * b1_valid  # QK and PV, 2 ops per multiply-add
    mask1 = torch.zeros((B, 1, 1, T_CACHE), dtype=torch.bool, device=dev)
    for r, (lo, hi) in enumerate(a["bnd"]):
        mask1[r, :, :, lo:hi] = True

    b1_tiles = -(-T_CACHE // split_kv.decode_tile(D, elem))
    results["decode_attention"] = {
        **timed(lambda i: da.decode_attention(q, *kv(i), bounds), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_plain(q, *kv(i), bounds), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q[:, :, None], *kv(i), mask1), 20, torch
        ),
        "bytes": b1_bytes,
        "ops": b1_ops,
        "max_abs_err": a["err"],
        "n_split": split_kv.decode_splits(B, HKV, HQ // HKV, T_CACHE, D, elem),
        "split_sweep": split_sweep(
            torch, lambda i: da.decode_attention(q, *kv(i), bounds), b1_tiles, DECODE_SWEEP
        ),
    }
    a = kw_b2
    q, s_t, e_t = a["q"], a["starts"], a["ends"]
    b2_bytes = window_bytes(a["st"], ends, T_CACHE, 2 * HKV * D * elem) + (
        2 * q.numel() * elem + 2 * s_t.numel() * 4
    )
    b2_valid = sum(
        max(e - s, 0) for srow, erow in zip(a["st"], ends) for s, e in zip(srow, erow)
    )
    b2_ops = 4 * HQ * D * b2_valid
    mask2 = torch.zeros((B, 1, S_SPAN, T_CACHE), dtype=torch.bool, device=dev)
    for r in range(B):
        for j in range(S_SPAN):
            mask2[r, 0, j, a["st"][r][j] : ends[r][j]] = True
    results["decode_attention_mq"] = {
        **timed(
            lambda i: da.decode_attention_mq(q, *kv(i), s_t, e_t), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_mq_plain(q, *kv(i), s_t, e_t), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q.transpose(1, 2), *kv(i), mask2), 20, torch
        ),
        "bytes": b2_bytes,
        "ops": b2_ops,
        "max_abs_err": a["err"],
        "n_split": split_kv.plan_splits(B, HKV, -(-T_CACHE // split_kv.DENSE_TILE)),
        "split_sweep": split_sweep(
            torch, lambda i: da.decode_attention_mq(q, *kv(i), s_t, e_t),
            -(-T_CACHE // split_kv.DENSE_TILE),
        ),
    }
    finish_bounds(results)
    return results, checks


def kv_pair(torch, gen, dev, shape, dtype, kv):
    """Layer 1 of a random two-layer K/V pair: in ``dtype``, or int8 beside
    its f32 scales (``kv="int8"``)."""
    from adversarial_spec_tpu_torch.ops import kv_inputs

    kf = torch.randn((2, *shape), generator=gen, device=dev)[1]
    vf = torch.randn((2, *shape), generator=gen, device=dev)[1]
    return kv_inputs.kv_pair(kf, vf, dtype, kv)


def phase_verify_edges(torch, da, pa) -> list:
    """The split-KV verify kernels (B2, B4) against their plain versions on
    the edges their grid, ring and combine must get right; returns the
    checks."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    checks = []
    check = functools.partial(check_close, checks)
    pair = functools.partial(kv_pair, torch, gen, dev)

    def tensor(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        for kv in ("float", "int8"):
            for hd in (64, 128, 256):
                tag = f"{tn} {kv} D={hd}"
                k, v, sc = pair((3, 2, 300, hd), dtype, kv)
                q = torch.randn((3, 16, 8, hd), generator=gen, device=dev).to(dtype)
                q9 = q[:, :S_SPAN]
                # Row 0 runs past the last full tile (T = 300), row 1's union
                # is one tile (fewer than n_split), row 2 is empty.
                ends = tensor([[291 + j for j in range(9)], [71 + j for j in range(9)], [300] * 9])
                starts = tensor([[0] * 9, [70] * 9, [300] * 9])
                for cap in (0.0, 50.0):
                    got = da.decode_attention_mq(q9, k, v, starts, ends, attn_softcap=cap, **sc)
                    want = da.decode_attention_mq_plain(q9, k, v, starts, ends, attn_softcap=cap,
                                                        **sc)
                    check(f"B2 edges {tag} softcap={cap}", got, want, tol, empty_row=2)
                b1 = tensor([[0], [70], [0]])
                check(f"B2 edges {tag} [B, 1] starts", da.decode_attention_mq(q9, k, v, b1, ends, **sc),
                      da.decode_attention_mq_plain(q9, k, v, b1, ends, **sc), tol)
                e16 = tensor([[280 + j for j in range(16)]] * 3)
                s16 = tensor([[5], [100], [250]])
                check(f"B2 edges {tag} 64 rows per KV head",
                      da.decode_attention_mq(q, k, v, s16, e16, **sc),
                      da.decode_attention_mq_plain(q, k, v, s16, e16, **sc), tol)
                if kv == "float":  # rows 2 (D + 1) bytes apart: no 16-byte copies
                    buf = torch.randn((3, 2, 300, hd + 1), generator=gen, device=dev).to(dtype)
                    ku, vu = buf[..., :hd], buf[..., 1:]
                    check(f"B2 edges {tag} unaligned rows",
                          da.decode_attention_mq(q9, ku, vu, starts, ends),
                          da.decode_attention_mq_plain(q9, ku, vu, starts, ends), tol, empty_row=2)
                for page in (16, 64):
                    n_pages, P = 24, 8
                    kp, vp, psc = pair((n_pages, 2, page, hd), dtype, kv)
                    table = tensor([[3, 0, 5, 6, 7, 8, 9, 10], [11, 12, 13] + [-1] * 5,
                                    [14] + [-1] * 7])
                    used = set(table.flatten().tolist())
                    poisoned = [0] + [p for p in range(n_pages) if p not in used]
                    if kv == "int8":
                        kp[poisoned] = -128
                        vp[poisoned] = -128
                        for x in psc.values():
                            x[poisoned] = float("nan")
                    else:
                        kp[poisoned] = float("nan")
                        vp[poisoned] = float("nan")
                    last = P * page - 9
                    ends = tensor([[last + j for j in range(1, 10)],
                                   [2 * page + j for j in range(9)], [page // 2] * 9])
                    starts = tensor([[1], [page + 3], [page // 2]])
                    for cap in (0.0, 30.0):
                        got = pa.paged_decode_attention_mq(q9, kp, vp, table, starts, ends,
                                                           attn_softcap=cap, **psc)
                        want = pa.paged_decode_attention_mq_plain(q9, kp, vp, table, starts, ends,
                                                                  attn_softcap=cap, **psc)
                        check(f"B4 edges {tag} page={page} softcap={cap}", got, want, tol,
                              empty_row=2)
                    bnd = tensor([[1, last], [page + 3, 2 * page], [0, 5]])
                    one = pa.paged_decode_attention_mq(q[:, :1], kp, vp, table, bnd[:, :1],
                                                       bnd[:, 1:], **psc)[:, 0]
                    check(f"B4 edges {tag} page={page} S=1 vs B3", one,
                          pa.paged_decode_attention(q[:, 0], kp, vp, table, bnd, **psc), tol)
                    check(f"B4 edges {tag} page={page} S=1", one,
                          pa.paged_decode_attention_plain(q[:, 0], kp, vp, table, bnd, **psc), tol)
    torch.cuda.synchronize()
    return checks


def phase_decode_edges(torch, da, pa) -> list:
    """The split-KV S=1 kernels (B1, B3) against their plain versions on
    the edges their grid, ring and combine must get right, then the
    verify kernels on the spans and pages they refused before (a span of
    g * S = 132 query rows per KV head, pages of 8 and 24 slots, D = 256
    over 128-slot pages); returns the checks."""
    from adversarial_spec_tpu_torch.ops import kv_inputs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    checks = []
    check = functools.partial(check_close, checks)
    pair = functools.partial(kv_pair, torch, gen, dev)

    def tensor(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    paged = functools.partial(kv_inputs.poisoned_pages, gen, dev)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        for kv in ("float", "int8"):
            for hd in (64, 128, 256):
                tag = f"{tn} {kv} D={hd}"
                k, v, sc = pair((4, 2, 300, hd), dtype, kv)
                # Row 0 runs past the last full tile (T = 300), row 1 has a
                # left pad, row 2 one slot, row 3 an empty window.
                bnd = tensor([[0, 300], [37, 250], [100, 101], [80, 80]])
                for hq in (8, 2, 14):  # 4, 1 and 7 query heads per KV head
                    q = torch.randn((4, hq, hd), generator=gen, device=dev).to(dtype)
                    for cap in (0.0, 50.0):
                        got = da.decode_attention(q, k, v, bnd, attn_softcap=cap, **sc)
                        want = da.decode_attention_plain(q, k, v, bnd, attn_softcap=cap, **sc)
                        check(f"B1 edges {tag} g={hq // 2} softcap={cap}", got, want, tol,
                              empty_row=3)
                    one = v[2, :, 100].float()
                    if kv == "int8":
                        one = one * sc["v_scale"][2, :, 100]
                    if not torch.equal(got[2], one.to(dtype).repeat_interleave(hq // 2, 0)):
                        raise AssertionError(f"B1 edges {tag}: one slot is not exactly v")
                if kv == "float":  # rows (D + 1) elements apart: no 16-byte copies
                    buf = torch.randn((4, 2, 300, hd + 1), generator=gen, device=dev).to(dtype)
                    ku, vu = buf[..., :hd], buf[..., 1:]
                    check(f"B1 edges {tag} unaligned rows", da.decode_attention(q, ku, vu, bnd),
                          da.decode_attention_plain(q, ku, vu, bnd), tol, empty_row=3)
                q = q[:3, :8]
                for page in (1, 8, 24, 64):
                    kp, vp, psc, table, pb = paged(page, hd, dtype, kv)
                    for cap in (0.0, 30.0):
                        got = pa.paged_decode_attention(q, kp, vp, table, pb, attn_softcap=cap,
                                                        **psc)
                        want = pa.paged_decode_attention_plain(q, kp, vp, table, pb,
                                                               attn_softcap=cap, **psc)
                        check(f"B3 edges {tag} page={page} softcap={cap}", got, want, tol,
                              empty_row=2)
                    one = pa.paged_decode_attention_mq(q[:, None], kp, vp, table, pb[:, :1],
                                                       pb[:, 1:], **psc)[:, 0]
                    check(f"B4 {tag} page={page} S=1 vs B3", one,
                          pa.paged_decode_attention(q, kp, vp, table, pb, **psc), tol, empty_row=2)
                    if page in (8, 24):  # pages no multiple of 16 (B4 pads them)
                        ends = (pb[:, 1:] - 8 + torch.arange(9, device=dev)).int()
                        ends[2] = 0
                        q9 = torch.randn((3, 9, 8, hd), generator=gen, device=dev).to(dtype)
                        check(f"B4 odd pages {tag} page={page}",
                              pa.paged_decode_attention_mq(q9, kp, vp, table, pb[:, :1], ends,
                                                           **psc),
                              pa.paged_decode_attention_mq_plain(q9, kp, vp, table, pb[:, :1],
                                                                 ends, **psc), tol, empty_row=2)
            # A span of 33 positions at g = 4: 132 query rows per KV head
            # (bf16 q: two launches, runs of 32 and 1 positions; f32 q: one).
            q33 = torch.randn((3, 33, 8, 128), generator=gen, device=dev).to(dtype)
            k, v, sc = pair((3, 2, 300, 128), dtype, kv)
            ends = tensor([[250 + j for j in range(1, 34)], [100 + j for j in range(33)],
                           [60] * 33])
            starts = tensor([[0], [40], [60]])
            check(f"B2 long span {tn} {kv} S=33",
                  da.decode_attention_mq(q33, k, v, starts, ends, **sc),
                  da.decode_attention_mq_plain(q33, k, v, starts, ends, **sc), tol, empty_row=2)
            # f32 q keeps its rows in shared memory: beside 132 of them a
            # 64-slot f32 page is staged in smaller tiles.
            kp, vp, psc, table, _ = paged(64, 128, dtype, kv)
            check(f"B4 long span {tn} {kv} S=33",
                  pa.paged_decode_attention_mq(q33, kp, vp, table, starts, ends, **psc),
                  pa.paged_decode_attention_mq_plain(q33, kp, vp, table, starts, ends, **psc),
                  tol, empty_row=2)
            # D = 256 over 128-slot pages (one f32 page's K + V, 256 KB, is
            # more than a block's shared memory), at S = 9 and S = 33.
            kp, vp, psc, table, _ = paged(128, 256, dtype, kv)
            q256 = torch.randn((3, 33, 8, 256), generator=gen, device=dev).to(dtype)
            for S in (9, 33):
                check(f"B4 D=256 page=128 {tn} {kv} S={S}",
                      pa.paged_decode_attention_mq(q256[:, :S], kp, vp, table, starts,
                                                   ends[:, :S], **psc),
                      pa.paged_decode_attention_mq_plain(q256[:, :S], kp, vp, table, starts,
                                                         ends[:, :S], **psc),
                      tol, empty_row=2)
    torch.cuda.synchronize()
    return checks


def paged_layout(rng):
    """The batcher's shapes for B3/B4: 8 rows, each with its own page
    list drawn from a shared pool (scattered physical ids, -1 padding),
    left pads on two rows, a trash (0) entry inside row 3's window, and
    an empty window on row 7. Returns (table, pads, cur_lens, n_pages)."""
    cur_lens = [4224, 4100, 3000, 2200, 4224, 1800, 3500, 2600]
    pads = [0, 0, 700, 0, 1500, 0, 0, 2000]
    n_row = [-(-(c + S_SPAN) // PAGE) for c in cur_lens]
    n_used = sum(n_row)
    ids = list(rng.permutation(n_used) + 1)  # physical page 0 = trash
    table = [[-1] * P_TAB for _ in range(NS)]
    for r, n in enumerate(n_row):
        for p in range(n):
            table[r][p] = int(ids.pop())
    table[3][10] = 0  # a trash entry inside the window: never read
    return table, pads, cur_lens, n_used + 1 + 16  # 16 unused pages


def paged_counts(table, starts, ends):
    """(K/V slots the call must read — each row's union window, mapped
    pages only — and the (query row, slot) pairs it scores)."""
    read, scored = 0, 0
    for r in range(len(table)):
        mapped = [table[r][t // PAGE] > 0 for t in range(P_TAB * PAGE)]
        spans = [(max(lo, 0), hi) for lo, hi in zip(starts[r], ends[r]) if lo < hi]
        if spans:
            lo = min(a for a, _ in spans)
            hi = max(b for _, b in spans)
            read += sum(mapped[lo:hi])
        scored += sum(sum(mapped[a:b]) for a, b in spans)
    return read, scored


def phase_paged_kernels(torch, pa) -> tuple[dict, list]:
    import numpy as np

    from adversarial_spec_tpu_torch.ops import split_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table_l, pads, cur_lens, n_pages = paged_layout(np.random.RandomState(0))
    used = sorted({p for row in table_l for p in row if p > 0})
    unused = [p for p in range(n_pages) if p not in set(used)]
    table = torch.tensor(table_l, dtype=torch.int32, device=dev)
    b3_bnd = [[pads[r], cur_lens[r]] for r in range(NS)]
    b3_bnd[7] = [2600, 2600]  # empty window
    b4_st = [[pads[r]] * S_SPAN for r in range(NS)]
    b4_en = [[cur_lens[r] + j for j in range(S_SPAN)] for r in range(NS)]
    b4_st[7] = b4_en[7][:]  # empty windows
    results, checks = {}, []

    def pool(dtype):
        # A layer's view of a two-layer [L, n_pages, Hkv, page, D] pool,
        # NaN in the trash page and in every page no row maps.
        shape = (2, n_pages, HKV, PAGE, D)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for x in (k, v):
            x[1, [0] + unused] = float("nan")
        return k[1], v[1]

    check = functools.partial(check_close, checks)

    kw = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k, v = pool(dtype)
        q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        bnd = torch.tensor(b3_bnd, dtype=torch.int32, device=dev)
        st = torch.tensor(b4_st, dtype=torch.int32, device=dev)
        en = torch.tensor(b4_en, dtype=torch.int32, device=dev)
        for cap in (0.0, 50.0):
            got = pa.paged_decode_attention(q1, k, v, table, bnd, attn_softcap=cap)
            want = pa.paged_decode_attention_plain(q1, k, v, table, bnd, attn_softcap=cap)
            err = check(f"B3 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                kw["b3"] = dict(q=q1, bnd=bnd, err=err)
            got = pa.paged_decode_attention_mq(q2, k, v, table, st, en, attn_softcap=cap)
            want = pa.paged_decode_attention_mq_plain(q2, k, v, table, st, en, attn_softcap=cap)
            err = check(f"B4 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                kw["b4"] = dict(q=q2, st=st, en=en, err=err)
        # [B, 1] starts broadcast over the span (row 7 no longer empty).
        s1 = st[:, :1].contiguous()
        got = pa.paged_decode_attention_mq(q2, k, v, table, s1, en)
        want = pa.paged_decode_attention_mq_plain(q2, k, v, table, s1, en)
        check(f"B4 {tn} broadcast-starts", got, want, tol)
        if dtype == torch.bfloat16:
            kw["pool"] = (k, v)
    torch.cuda.synchronize()

    # ---- timing at the batcher's shapes (bf16), pools rotating ----
    rot = [kw["pool"]] + [pool(torch.bfloat16) for _ in range(N_ROTATE - 1)]
    kv = lambda i: rot[i % N_ROTATE]  # noqa: E731
    ids = torch.clamp(table, min=0).long()

    def dense(pages):  # untimed gather for the SDPA yardstick
        x = pages[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, D)
        return torch.nan_to_num(x)  # unmapped slots are masked anyway

    rot_dense = [(dense(k), dense(v)) for k, v in rot]
    kvd = lambda i: rot_dense[i % N_ROTATE]  # noqa: E731
    mapped = (table > 0).repeat_interleave(PAGE, dim=1)  # [NS, T]
    slot = torch.arange(P_TAB * PAGE, device=dev)

    def mask(starts, ends):
        s_t = torch.tensor(starts, device=dev)[..., None]
        e_t = torch.tensor(ends, device=dev)[..., None]
        return ((slot >= s_t) & (slot < e_t) & mapped[:, None, :])[:, None]

    elem = 2
    per_slot = 2 * HKV * D * elem
    b3_starts = [[lo] for lo, _ in b3_bnd]
    b3_ends = [[hi] for _, hi in b3_bnd]
    m3 = mask(b3_starts, b3_ends)
    m3[7] = True  # SDPA gives NaN for an all-masked row; the yardstick only
    q, bnd = kw["b3"]["q"], kw["b3"]["bnd"]
    read, scored = paged_counts(table_l, b3_starts, b3_ends)
    b3_tiles = -(-P_TAB * PAGE // split_kv.decode_tile(D, elem))
    results["paged_decode_attention"] = {
        **timed(lambda i: pa.paged_decode_attention(q, *kv(i), table, bnd), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_plain(q, *kv(i), table, bnd), 8, torch
        ),
        "library_ms": graph_ms(lambda i: sdpa(q[:, :, None], *kvd(i), m3), 20, torch),
        "bytes": read * per_slot + 2 * q.numel() * elem + table.numel() * 4 + bnd.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": kw["b3"]["err"],
        "n_split": split_kv.decode_splits(NS, HKV, HQ // HKV, P_TAB * PAGE, D, elem),
        "split_sweep": split_sweep(
            torch, lambda i: pa.paged_decode_attention(q, *kv(i), table, bnd), b3_tiles,
            DECODE_SWEEP,
        ),
    }
    m4 = mask(b4_st, b4_en)
    m4[7] = True
    q, st, en = kw["b4"]["q"], kw["b4"]["st"], kw["b4"]["en"]
    read, scored = paged_counts(table_l, b4_st, b4_en)
    results["paged_decode_attention_mq"] = {
        **timed(
            lambda i: pa.paged_decode_attention_mq(q, *kv(i), table, st, en), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_mq_plain(q, *kv(i), table, st, en), 8, torch
        ),
        "library_ms": graph_ms(lambda i: sdpa(q.transpose(1, 2), *kvd(i), m4), 20, torch),
        "bytes": read * per_slot + 2 * q.numel() * elem + table.numel() * 4
        + 2 * st.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": kw["b4"]["err"],
        "n_split": split_kv.plan_splits(NS, HKV, P_TAB),
        "split_sweep": split_sweep(
            torch, lambda i: pa.paged_decode_attention_mq(q, *kv(i), table, st, en), P_TAB
        ),
    }
    del rot, rot_dense
    finish_bounds(results)
    return results, checks


def phase_int8kv_kernels(torch, da, pa) -> tuple[dict, list]:
    """The int8-KV variants of B1-B4 (kv_dtype="int8": int8 K/V beside
    per-(slot, head) f32 scales) at the float cases' shapes and windows,
    q and out in bf16 and f32, against their plain versions; the paged
    pool's trash page and unused pages hold int8 -128 values and NaN
    scales. Then bf16 timings with a cold L2 beside the plain version,
    SDPA over the cache dequantized to bf16 beforehand (the yardstick;
    the port never calls it) and the bound."""
    import numpy as np

    from adversarial_spec_tpu_torch.models.transformer import _quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    results, checks = {}, []

    def int8_pair(shape):
        # Layer 1 of a two-layer int8 cache or pool and its [..., 1] scales.
        k8, ks = _quantize_kv(torch.randn((2, *shape), generator=gen, device=dev))
        v8, vs = _quantize_kv(torch.randn((2, *shape), generator=gen, device=dev))
        return k8[1], v8[1], dict(k_scale=ks[1], v_scale=vs[1])

    def dequant(x8, s):  # untimed, for the SDPA yardstick
        return (x8.float() * s).to(torch.bfloat16)

    check = functools.partial(check_close, checks)

    # ---- dense B1-i8 / B2-i8 (B=4, Hq=32, Hkv=8, D=128, T=4224, S=9) ----
    errs = {}
    e_t = torch.tensor(B2_ENDS, dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k8, v8, sc = int8_pair((B, HKV, T_CACHE, D))
        q1 = torch.randn((B, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((B, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        for label, bnd in (("windows", B1_BOUNDS), ("single", B1_SINGLE)):
            bounds = torch.tensor(bnd, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention(q1, k8, v8, bounds, attn_softcap=cap, **sc)
                want = da.decode_attention_plain(q1, k8, v8, bounds, attn_softcap=cap, **sc)
                err = check(f"B1-i8 {tn} {label} softcap={cap}", got, want, tol,
                            3 if label == "windows" else None)
                if label == "single":
                    # One valid slot: the output is that slot's dequantized v.
                    one = (v8[2, :, 3000].float() * sc["v_scale"][2, :, 3000]).to(dtype)
                    torch.testing.assert_close(
                        got[2], one.repeat_interleave(HQ // HKV, 0), rtol=0, atol=0
                    )
                if dtype == torch.bfloat16 and label == "windows" and cap == 0.0:
                    errs["b1"] = err
        for label, st in (("per-query", B2_STARTS), ("empty", B2_STARTS_EMPTY)):
            s_t = torch.tensor(st, dtype=torch.int32, device=dev)
            for cap in (0.0, 50.0):
                got = da.decode_attention_mq(q2, k8, v8, s_t, e_t, attn_softcap=cap, **sc)
                want = da.decode_attention_mq_plain(q2, k8, v8, s_t, e_t, attn_softcap=cap, **sc)
                err = check(f"B2-i8 {tn} {label} softcap={cap}", got, want, tol,
                            3 if label == "empty" else None)
                if dtype == torch.bfloat16 and label == "per-query" and cap == 0.0:
                    errs["b2"] = err
        s1 = torch.tensor([[p] for p in B2_PADS], dtype=torch.int32, device=dev)
        got = da.decode_attention_mq(q2, k8, v8, s1, e_t, **sc)
        want = da.decode_attention_mq_plain(q2, k8, v8, s1, e_t, **sc)
        check(f"B2-i8 {tn} broadcast-starts", got, want, tol)
        del k8, v8, sc
    torch.cuda.synchronize()

    # ---- dense timing (bf16 q), int8 caches rotating past the L2 ----
    rot = [int8_pair((B, HKV, T_CACHE, D)) for _ in range(N_ROTATE)]
    rot_deq = [(dequant(k8, sc["k_scale"]), dequant(v8, sc["v_scale"])) for k8, v8, sc in rot]
    q1 = torch.randn((B, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    q2 = torch.randn((B, S_SPAN, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    bounds = torch.tensor(B1_BOUNDS, dtype=torch.int32, device=dev)
    s_t = torch.tensor(B2_STARTS, dtype=torch.int32, device=dev)
    per_slot = 2 * HKV * (D + 4)  # int8 K and V rows plus one f32 scale each
    mask1 = torch.zeros((B, 1, 1, T_CACHE), dtype=torch.bool, device=dev)
    for r, (lo, hi) in enumerate(B1_BOUNDS):
        mask1[r, :, :, lo:hi] = True
    mask2 = torch.zeros((B, 1, S_SPAN, T_CACHE), dtype=torch.bool, device=dev)
    for r in range(B):
        for j in range(S_SPAN):
            mask2[r, 0, j, B2_STARTS[r][j] : B2_ENDS[r][j]] = True

    def kv(i):
        k8, v8, sc = rot[i % N_ROTATE]
        return (k8, v8), sc

    b1_valid = sum(max(hi - lo, 0) for lo, hi in B1_BOUNDS)
    results["decode_attention_int8kv"] = {
        **timed(lambda i: da.decode_attention(q1, *kv(i)[0], bounds, **kv(i)[1]), 50, torch),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_plain(q1, *kv(i)[0], bounds, **kv(i)[1]), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q1[:, :, None], *rot_deq[i % N_ROTATE], mask1), 20, torch
        ),
        "bytes": window_bytes([[lo] for lo, _ in B1_BOUNDS], [[hi] for _, hi in B1_BOUNDS],
                              T_CACHE, per_slot) + 2 * q1.numel() * 2 + bounds.numel() * 4,
        "ops": 4 * HQ * D * b1_valid,
        "max_abs_err": errs["b1"],
    }
    b2_valid = sum(max(e - st, 0) for srow, erow in zip(B2_STARTS, B2_ENDS)
                   for st, e in zip(srow, erow))
    results["decode_attention_mq_int8kv"] = {
        **timed(
            lambda i: da.decode_attention_mq(q2, *kv(i)[0], s_t, e_t, **kv(i)[1]), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: da.decode_attention_mq_plain(q2, *kv(i)[0], s_t, e_t, **kv(i)[1]), 8, torch
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q2.transpose(1, 2), *rot_deq[i % N_ROTATE], mask2), 20, torch
        ),
        "bytes": window_bytes(B2_STARTS, B2_ENDS, T_CACHE, per_slot)
        + 2 * q2.numel() * 2 + 2 * s_t.numel() * 4,
        "ops": 4 * HQ * D * b2_valid,
        "max_abs_err": errs["b2"],
    }
    del rot, rot_deq
    torch.cuda.empty_cache()

    # ---- paged B3-i8 / B4-i8 (8 slots, page 64, a 128-page table) ----
    table_l, pads, cur_lens, n_pages = paged_layout(np.random.RandomState(0))
    used = {p for row in table_l for p in row if p > 0}
    poisoned = [0] + [p for p in range(n_pages) if p not in used]
    table = torch.tensor(table_l, dtype=torch.int32, device=dev)
    b3_bnd = [[pads[r], cur_lens[r]] for r in range(NS)]
    b3_bnd[7] = [2600, 2600]  # empty window
    b4_st = [[pads[r]] * S_SPAN for r in range(NS)]
    b4_en = [[cur_lens[r] + j for j in range(S_SPAN)] for r in range(NS)]
    b4_st[7] = b4_en[7][:]  # empty windows

    def pool():
        k8, v8, sc = int8_pair((n_pages, HKV, PAGE, D))
        for x in (k8, v8):
            x[poisoned] = -128
        for x in sc.values():
            x[poisoned] = float("nan")
        return k8, v8, sc

    bnd = torch.tensor(b3_bnd, dtype=torch.int32, device=dev)
    st = torch.tensor(b4_st, dtype=torch.int32, device=dev)
    en = torch.tensor(b4_en, dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tn = str(dtype).split(".")[1]
        k8, v8, sc = pool()
        q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(dtype)
        q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(dtype)
        for cap in (0.0, 50.0):
            got3 = pa.paged_decode_attention(q1, k8, v8, table, bnd, attn_softcap=cap, **sc)
            want3 = pa.paged_decode_attention_plain(q1, k8, v8, table, bnd, attn_softcap=cap, **sc)
            err = check(f"B3-i8 {tn} softcap={cap}", got3, want3, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                errs["b3"] = err
            got = pa.paged_decode_attention_mq(q2, k8, v8, table, st, en, attn_softcap=cap, **sc)
            want = pa.paged_decode_attention_mq_plain(
                q2, k8, v8, table, st, en, attn_softcap=cap, **sc
            )
            err = check(f"B4-i8 {tn} softcap={cap}", got, want, tol, empty_row=7)
            if dtype == torch.bfloat16 and cap == 0.0:
                errs["b4"] = err
            # B4-i8 over one position (the split verify kernel) against
            # B3-i8 (the S = 1 body) and against the plain version.
            one = pa.paged_decode_attention_mq(
                q1[:, None], k8, v8, table, bnd[:, :1], bnd[:, 1:], attn_softcap=cap, **sc
            )[:, 0]
            check(f"B4-i8 {tn} S=1 vs B3-i8 softcap={cap}", one, got3, tol, empty_row=7)
            check(f"B4-i8 {tn} S=1 softcap={cap}", one, want3, tol, empty_row=7)
        s1 = st[:, :1].contiguous()
        got = pa.paged_decode_attention_mq(q2, k8, v8, table, s1, en, **sc)
        want = pa.paged_decode_attention_mq_plain(q2, k8, v8, table, s1, en, **sc)
        check(f"B4-i8 {tn} broadcast-starts", got, want, tol)
        del k8, v8, sc
    torch.cuda.synchronize()

    # ---- paged timing (bf16 q), pools rotating ----
    rot = [pool() for _ in range(N_ROTATE)]
    ids = torch.clamp(table, min=0).long()

    def dense(pages, scales):  # untimed gather + dequant for the yardstick
        x = pages[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, D)
        s = scales[ids].permute(0, 2, 1, 3, 4).reshape(NS, HKV, P_TAB * PAGE, 1)
        return torch.nan_to_num(dequant(x, s))  # unmapped slots are masked anyway

    rot_dense = [(dense(k8, sc["k_scale"]), dense(v8, sc["v_scale"])) for k8, v8, sc in rot]
    mapped = (table > 0).repeat_interleave(PAGE, dim=1)
    slot = torch.arange(P_TAB * PAGE, device=dev)

    def mask(starts, ends):
        s_ = torch.tensor(starts, device=dev)[..., None]
        e_ = torch.tensor(ends, device=dev)[..., None]
        m = ((slot >= s_) & (slot < e_) & mapped[:, None, :])[:, None]
        m[7] = True  # SDPA gives NaN for an all-masked row; the yardstick only
        return m

    def pkv(i):
        k8, v8, sc = rot[i % N_ROTATE]
        return (k8, v8), sc

    q1 = torch.randn((NS, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    q2 = torch.randn((NS, S_SPAN, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    b3_starts, b3_ends = [[lo] for lo, _ in b3_bnd], [[hi] for _, hi in b3_bnd]
    m3, m4 = mask(b3_starts, b3_ends), mask(b4_st, b4_en)
    read, scored = paged_counts(table_l, b3_starts, b3_ends)
    results["paged_decode_attention_int8kv"] = {
        **timed(
            lambda i: pa.paged_decode_attention(q1, *pkv(i)[0], table, bnd, **pkv(i)[1]), 50, torch
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_plain(q1, *pkv(i)[0], table, bnd, **pkv(i)[1]),
            8, torch,
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q1[:, :, None], *rot_dense[i % N_ROTATE], m3), 20, torch
        ),
        "bytes": read * per_slot + 2 * q1.numel() * 2 + table.numel() * 4 + bnd.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": errs["b3"],
    }
    read, scored = paged_counts(table_l, b4_st, b4_en)
    results["paged_decode_attention_mq_int8kv"] = {
        **timed(
            lambda i: pa.paged_decode_attention_mq(q2, *pkv(i)[0], table, st, en, **pkv(i)[1]),
            50, torch,
        ),
        "plain_ms": cuda_ms(
            lambda i: pa.paged_decode_attention_mq_plain(
                q2, *pkv(i)[0], table, st, en, **pkv(i)[1]
            ), 8, torch,
        ),
        "library_ms": graph_ms(
            lambda i: sdpa(q2.transpose(1, 2), *rot_dense[i % N_ROTATE], m4), 20, torch
        ),
        "bytes": read * per_slot + 2 * q2.numel() * 2 + table.numel() * 4 + 2 * st.numel() * 4,
        "ops": 4 * HQ * D * scored,
        "max_abs_err": errs["b4"],
    }
    del rot, rot_dense
    torch.cuda.empty_cache()
    finish_bounds(results)
    return results, checks


# Llama-3-8B's matmul weights (K, N), with launches per forward: each of the
# 32 layers runs wq, wk, wv, wo, w_gate, w_up, w_down (224 products); the
# head runs once with f32 logits, at every row of a decode step and at the
# last position of each row of a prefill (lm_head_last_only).
QMM_SHAPES = [
    ("wq/wo", 4096, 4096, 64),
    ("wk/wv", 4096, 1024, 64),
    ("w_gate/w_up", 4096, 14336, 64),
    ("w_down", 14336, 4096, 32),
    ("head", 4096, 128256, 1),
]
# Rows: dense S=1 step, dense verify 4x9, paged verify 8x9, the batcher's
# admission chunk (ADMISSION_CHUNK), one row's prefill chunk, the dense
# path's prefill chunk (4 rows x 1024).
QMM_M = [4, 36, 72, 512, 1024, 4096]
# The head's rows in a forward of M rows: all of them at decode, one per
# prompt row in a prefill chunk.
QMM_HEAD_ROWS = {4: 4, 36: 36, 72: 72, 512: 1, 1024: 1, 4096: 4}
# The main path's rows for each kernel's line: B5 serves phase quant (a),
# the dense int8 path (most products there are the 4 x 9 verify); B6 serves
# (b), the paged int4 path (8 x 9 verify).
QMM_LINE_M = {"matmul_int8": 36, "matmul_int4": 72}
QMM_SWEEP_M = (96, 128, 160, 192, 256)  # the planned split against none, around 128 rows
# The kernels and their plain versions both accumulate in f32 (the plain
# version exactly, by cuBLAS sgemm with TF32 off): they differ by summation
# order (~1e-6 of the largest output at K = 14336) and, for a bf16 output,
# by one bf16 rounding of nearly equal values (2^-7 relative).
QMM_TOL = {"float32": (0.0, 2e-5), "bfloat16": (1e-2, 2e-5)}  # (rtol, atol x max|want|)
L2_BYTES = 50e6


def qmm_check(torch, got, want, out_name: str) -> float:
    """max |got - want|; raises unless |got - want| <= rtol |want| +
    atol max|want| everywhere (QMM_TOL) and the output is finite."""
    rtol, atol = QMM_TOL[out_name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    d = (g - w).abs()
    lim = rtol * w.abs() + atol * float(w.abs().max())
    if not bool((d <= lim).all()):
        i = int(torch.argmax(d - lim))
        raise AssertionError(
            f"max excess {float((d - lim).flatten()[i])} at {i}: got "
            f"{float(g.flatten()[i])}, want {float(w.flatten()[i])}"
        )
    return float(d.max())


def graph_seq_ms(fn, n: int, torch, reps: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(0) .. fn(n - 1)`` captured
    in one CUDA graph (after an eager warm-up of each), replayed ``reps``
    times between CUDA events: the host's per-call work is left out, and
    ``n`` inputs spanning twice the L2 keep it cold."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * n)
    del g
    return ms


@contextlib.contextmanager
def forced_plan(qm, plan):
    """The wrappers' plan (``qm.planned``) replaced by ``plan(M, N, K,
    int4, tma_ok)``."""
    real = qm.planned
    qm.planned = plan
    try:
        yield
    finally:
        qm.planned = real


def phase_quant_kernels(torch, qm, quant) -> tuple[dict, list, list, dict]:
    """B5/B6 against their plain versions on the card, bf16 and f32, at
    Llama-3-8B's shapes and the path's row counts, plus edge cases, each
    main case twice and bit-identical; then bf16 device times with a cold
    L2 beside the plain version, a bf16 cuBLAS product on the weight
    dequantized beforehand (the yardstick), and the bound, summed into
    forwards at every QMM_M; the K-split and path-threshold sweeps.
    Returns (per-kernel line numbers, checks, per-case timings, sweeps)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    fmts = {
        "matmul_int8": (quant.quantize_int8, lambda w: (w["q"],), qm.matmul_int8,
                        qm.matmul_int8_plain),
        "matmul_int4": (quant.quantize_int4, lambda w: (w["q4"],), qm.matmul_int4,
                        qm.matmul_int4_plain),
    }
    checks, cases = [], []
    worst = {name: 0.0 for name in fmts}

    def run_case(label, x, w_f, out_dtype=None, main=False):
        for name, (qz, qw, fn, plain) in fmts.items():
            leaf = qz(w_f)
            args = (x, *qw(leaf), leaf["scale"])
            got = fn(*args, out_dtype=out_dtype)
            want = plain(*args, out_dtype=out_dtype)
            out_name = str(got.dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label}: {got.shape}/{got.dtype}")
            try:
                err = qmm_check(torch, got, want, out_name)
            except AssertionError as e:
                raise AssertionError(f"{name} {label}: {e}") from None
            if main:
                worst[name] = max(worst[name], err)
                if not torch.equal(got, fn(*args, out_dtype=out_dtype)):
                    raise AssertionError(f"{name} {label}: two calls differ")
            checks.append({"case": f"{name} {label}", "max_abs_err": err,
                           "max_abs_want": float(want.float().abs().max()),
                           "tol": QMM_TOL[out_name]})

    def randn(shape, dtype, mag=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * mag).to(dtype)

    def rows_of(label):
        if label != "head":
            return QMM_M
        return sorted(set(QMM_HEAD_ROWS.values()))

    for dtype in (torch.bfloat16, torch.float32):
        tn = str(dtype).split(".")[1]
        for label, K, N, _ in QMM_SHAPES:
            w_f = randn((K, N), dtype, K ** -0.5)
            head_out = torch.float32 if label == "head" else None
            for M in rows_of(label):
                run_case(f"{tn} {label} M={M}", randn((M, K), dtype), w_f, head_out, main=True)
            del w_f
        # Edges: one row, odd K (int4 packs a zero row) at decode and
        # prefill rows, N no multiple of 16 and N = 144 (no tile multiple),
        # ragged rows past 128, a 3-D x, unaligned x row strides (scalar
        # loads), tiny and huge scales.
        w_odd = randn((255, 40), dtype)
        run_case(f"{tn} M=1 K=4096 N=4096", randn((1, 4096), dtype), randn((4096, 4096), dtype))
        run_case(f"{tn} odd K=255 N=40 M=5", randn((5, 255), dtype), w_odd)
        run_case(f"{tn} odd K=255 N=40 M=130", randn((130, 255), dtype), w_odd)
        run_case(f"{tn} odd K=1023 N=144 M=300", randn((300, 1023), dtype),
                 randn((1023, 144), dtype))
        run_case(f"{tn} 3-D x (2, 3, 4096) N=1024", randn((2, 3, 4096), dtype),
                 randn((4096, 1024), dtype))
        run_case(f"{tn} x row stride 4099 M=36", randn((36, 4099), dtype)[:, :4096],
                 randn((4096, 1024), dtype), torch.float32)
        run_case(f"{tn} x row stride 4099 M=300", randn((300, 4099), dtype)[:, :4096],
                 randn((4096, 1024), dtype))
        for mag in (1e-12, 1e12):
            run_case(f"{tn} scale~{mag:g} K=255 N=40 M=72", randn((72, 255), dtype),
                     randn((255, 40), dtype, mag))
    torch.cuda.synchronize()

    # ---- timing (bf16), weights rotating so each call finds the L2 cold ----
    sweeps = {"ksplit": [], "threshold": []}
    sweeps_on = hasattr(qm, "planned")  # a checkout whose B5/B6 have a K-split plan
    for label, K, N, per_fwd in QMM_SHAPES:
        w_f = randn((K, N), torch.bfloat16, K ** -0.5)
        head_out = torch.float32 if label == "head" else None
        leaves = {name: [fmts[name][0](w_f)] for name in fmts}
        lib_w = [quant.dequantize(leaves["matmul_int8"][0], torch.bfloat16)]
        # Enough copies that a rotation spans twice the L2.
        for name in fmts:
            leaf = leaves[name][0]
            copies = 1 + int(2 * L2_BYTES // fmts[name][1](leaf)[0].numel())
            leaves[name] += [{k: t.clone() for k, t in leaf.items()} for _ in range(copies - 1)]
        lib_copies = 1 + int(2 * L2_BYTES // (lib_w[0].numel() * 2))
        lib_w += [lib_w[0].clone() for _ in range(lib_copies - 1)]
        del w_f
        rows = rows_of(label)
        sweep_rows = () if label == "head" else QMM_SWEEP_M
        for M in sorted(set(rows) | set(sweep_rows)):
            x = randn((M, K), torch.bfloat16)
            out_bytes = M * N * (4 if head_out else 2)

            def lib(i, x=x):
                w = lib_w[i % len(lib_w)]
                if head_out:
                    return torch.mm(x, w, out_dtype=torch.float32)
                return torch.matmul(x, w)

            lib_ms = graph_seq_ms(lib, len(lib_w), torch) if M in rows else None
            for name, (_, qw, fn, plain) in fmts.items():
                ls = leaves[name]

                def call(i, fn=fn, ls=ls, x=x):
                    leaf = ls[i % len(ls)]
                    return fn(x, *qw(leaf), leaf["scale"], out_dtype=head_out)

                if M in sweep_rows and sweeps_on:  # the planned split against whole-K tiles
                    planned = qm.planned(M, N, K, name == "matmul_int4", True)
                    for path, pl in (("planned", planned), ("whole-K", (qm.DECODE_WIDTHS[0], 1))):
                        with forced_plan(qm, lambda *a, pl=pl: pl):
                            sweeps["threshold"].append({
                                "kernel": name, "weight": label, "M": M, "path": path,
                                "bn": pl[0], "ksplit": pl[1],
                                "ms": graph_seq_ms(call, len(ls), torch)})
                if M not in rows:
                    continue
                w_bytes = qw(ls[0])[0].numel() + N * 4
                t_bytes = (w_bytes + x.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * M * K * N / PEAK_OPS["bfloat16"] * 1e3
                bn, ks = (qm.planned(M, N, K, name == "matmul_int4", True) if sweeps_on
                          else (None, None))
                cases.append({
                    "kernel": name, "weight": label, "M": M, "K": K, "N": N,
                    "per_forward": per_fwd, "bn": bn, "ksplit": ks,
                    "ms": graph_seq_ms(call, len(ls), torch),
                    "call_ms": cuda_ms(call, 20, torch),
                    "plain_ms": cuda_ms(lambda i: plain(x, *qw(ls[i % len(ls)]),
                                                        ls[i % len(ls)]["scale"],
                                                        out_dtype=head_out), 3, torch),
                    "library_ms": lib_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                })
                if M == QMM_LINE_M[name] and sweeps_on:  # the decode path's K split
                    for n in range(1, qm.MAX_CLUSTER + 1):
                        with forced_plan(qm, lambda *a, bn=bn, n=n: (bn, n)):
                            sweeps["ksplit"].append({
                                "kernel": name, "weight": label, "M": M, "bn": bn,
                                "ksplit": n, "planned": n == ks,
                                "ms": graph_seq_ms(call, len(ls), torch)})
        del leaves, lib_w
        torch.cuda.empty_cache()

    def forward(name, M):
        """One forward's sums at M rows: 224 layer products and the head."""
        rows = [c for c in cases if c["kernel"] == name and (
            (c["weight"] != "head" and c["M"] == M)
            or (c["weight"] == "head" and c["M"] == QMM_HEAD_ROWS[M]))]
        tot = {k: sum(c[k] * c["per_forward"] for c in rows)
               for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(c["bound_ms"] * c["per_forward"] for c in rows if c["bound_by"] == "bytes")
        tot["bound_by"] = "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations"
        return tot

    per_m = {name: {str(M): forward(name, M) for M in QMM_M} for name in fmts}
    sweeps["per_forward"] = per_m
    results = {}
    for name in fmts:
        results[name] = {
            **per_m[name][str(QMM_LINE_M[name])],
            "max_abs_err": worst[name],
            "line_is": f"one forward (224 products and the head) at M={QMM_LINE_M[name]}",
        }
    return results, checks, cases, sweeps


def profile_chat(torch, engine, reqs, sp, name="chip_profile.txt") -> dict:
    """One more chat call under torch.profiler: device busy time by
    kernel, and the idle share of the call's wall time (the profiler's own
    host overhead lengthens the wall, so the share is an upper bound).
    The full table goes to chiprun_out/<name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.chat(reqs, sp)
        torch.cuda.synchronize()
    wall = time.monotonic() - t
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            kernels.append({"name": ev.key[:120], "count": ev.count, "ms": us / 1e3})
    kernels.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in kernels)
    for r in kernels:
        r["share"] = r["ms"] / busy_ms if busy_ms else 0.0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"wall_s {wall}\nbusy_ms {busy_ms}\n")
        for r in kernels:
            f.write(f"{r['ms']:12.3f} ms {r['count']:7d}x {r['share']:.4f}  {r['name']}\n")
    return {
        "phase": "profile",
        "wall_s": wall,
        "device_busy_s": busy_ms / 1e3 if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / 1e3 / wall if kernels else "not measured",
        "top_kernels": kernels[:12],
    }


def slice_requests() -> list:
    """The dense slice's four opponents on tpu://random-8b: spec documents
    of 1600-3400 bytes."""
    from adversarial_spec_tpu_torch.engine.types import ChatRequest

    return [
        ChatRequest(
            model="tpu://random-8b",
            system=p,
            user=spec_document(n, i) + "\n\nCritique this spec.",
        )
        for i, (p, n) in enumerate(zip(PERSONAS[:4], [1600, 2300, 2900, 3400]))
    ]


def paged_requests() -> list:
    """The paged slice's twelve opponents on tpu://random-8b: spec
    documents of 1600-3360 bytes."""
    from adversarial_spec_tpu_torch.engine.types import ChatRequest

    return [
        ChatRequest(
            model="tpu://random-8b",
            system=p,
            user=spec_document(1600 + 160 * i, 10 + i) + "\n\nCritique this spec.",
        )
        for i, p in enumerate(PERSONAS)
    ]


@contextlib.contextmanager
def temp_registry(*specs):
    """The port's registry pointed at a temporary file under build/ that
    holds ``specs`` (user entries shadow the built-in aliases)."""
    from pathlib import Path

    from adversarial_spec_tpu_torch.engine import registry

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    prev_path = registry.REGISTRY_PATH
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        registry.REGISTRY_PATH = Path(tmp) / "registry.json"
        try:
            for spec in specs:
                registry.save_registry_entry(spec)
            yield
        finally:
            registry.REGISTRY_PATH = prev_path


def phase_slice(torch, profile: bool = False) -> dict:
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da

    spec_mod.configure(enabled=True)
    reqs = slice_requests()
    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    engine = GpuEngine()
    t = time.monotonic()
    warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
    if not warm[0].ok:
        raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
    load_s = time.monotonic() - t

    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    t = time.monotonic()
    comps = engine.chat(reqs, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    floats = ("decode_attention", "decode_attention_mq")
    calls = [{"call": "main", "speculative": True, **dict(da.launches)}]
    launched = {k: da.launches[k] for k in floats}
    bad = [c.error for c in comps if not c.ok]
    if bad:
        raise RuntimeError(f"chat failed: {bad}")
    if any(c.usage.output_tokens != 128 for c in comps):
        raise RuntimeError(
            f"rows stopped early: {[c.usage.output_tokens for c in comps]}"
        )
    prefill_s = sum(c.usage.prefill_time_s for c in comps)
    decode_s = sum(c.usage.decode_time_s for c in comps)
    out_tok = sum(c.usage.output_tokens for c in comps)
    # The same round with speculation off (the user's ADVSPEC_SPECULATIVE=0,
    # or the adaptive off-switch): every decode step is B1, at full width.
    spec_mod.configure(enabled=False)
    try:
        da.reset_launches()
        t = time.monotonic()
        off = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall_off = time.monotonic() - t
    finally:
        spec_mod.configure(enabled=True)
    bad = [c.error for c in off if not c.ok]
    if bad or any(c.usage.output_tokens != 128 for c in off):
        raise RuntimeError(f"speculation-off chat failed: {bad or [c.usage for c in off]}")
    off_decode_s = sum(c.usage.decode_time_s for c in off)
    calls.append({"call": "speculation off", "speculative": False, **dict(da.launches)})
    speculation_off = {
        "chat_wall_s": wall_off,
        "prefill_s": sum(c.usage.prefill_time_s for c in off),
        "decode_s": off_decode_s,
        "decode_tokens_per_s": 128 * len(off) / off_decode_s if off_decode_s > 0 else 0.0,
        "launches": dict(da.launches),
    }
    if da.launches["decode_attention"] == 0:
        raise RuntimeError(f"B1 never launched with speculation off: {calls}")
    launched["decode_attention"] += da.launches["decode_attention"]
    if min(launched.values()) == 0:
        raise RuntimeError(f"a kernel of the path never launched: {calls}")
    prof = profile_chat(torch, engine, reqs, sp) if profile else None
    return {
        "phase": "slice",
        "model": "tpu://random-8b",
        "requests": len(reqs),
        "input_tokens": [c.usage.input_tokens for c in comps],
        "output_tokens": [c.usage.output_tokens for c in comps],
        "load_and_warmup_s": load_s,
        "chat_wall_s": wall,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "speculation_off": speculation_off,
        "launch_calls": calls,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


PERSONAS = [
    "You are a security engineer reviewing a product spec.",
    "You are an SRE focused on reliability and operability.",
    "You are a product manager checking scope and acceptance criteria.",
    "You are a staff engineer looking for design flaws and ambiguity.",
    "You are a privacy counsel checking data handling.",
    "You are a QA lead looking for untestable requirements.",
    "You are a database engineer reviewing storage and migrations.",
    "You are a frontend engineer checking API ergonomics.",
    "You are a cost analyst reviewing infrastructure spend.",
    "You are an accessibility specialist reviewing user flows.",
    "You are a support lead checking operability for on-call staff.",
    "You are a compliance auditor checking audit and retention rules.",
]


def phase_paged(torch, profile: bool = False) -> dict:
    """GpuEngine.chat on a kv="paged" random-8b: round 1 speculation on,
    round 2 the same requests with it off, on the same batcher. With
    ``profile``, a third round (speculation on, warm prefix cache) runs
    under torch.profiler."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import registry
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    reqs = paged_requests()
    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    with temp_registry(
        registry.ModelSpec(alias="random-8b", family="llama", size="8b", kv="paged")
    ):
        try:
            engine = GpuEngine()
            t = time.monotonic()
            warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
            if not warm[0].ok:
                raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
            load_s = time.monotonic() - t
            rounds = []
            da.reset_launches()
            pa.reset_launches()
            texts = []
            def one_round(label, on, pdepth, params_, reqs=reqs):
                spec_mod.configure(enabled=on)
                il.configure(pipeline_depth=pdepth)
                before = {**da.launches, **pa.launches}
                b0 = served(engine).batcher
                fetch0 = dict(b0.fetch_counts)
                il.reset_stats()
                torch.cuda.reset_peak_memory_stats()
                t = time.monotonic()
                comps = engine.chat(reqs, params_)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
                bad = [c.error for c in comps if not c.ok]
                if bad:
                    raise RuntimeError(f"{label}: chat failed: {bad}")
                if any(c.usage.output_tokens < 1 for c in comps):
                    raise RuntimeError(f"{label}: a row emitted nothing")
                after = {**da.launches, **pa.launches}
                decode_s = sum(c.usage.decode_time_s for c in comps)
                out_tok = sum(c.usage.output_tokens for c in comps)
                texts.append([c.text for c in comps])
                rounds.append({
                    "round": label,
                    "wall_s": wall,
                    "prefill_s": sum(c.usage.prefill_time_s for c in comps),
                    "decode_s": decode_s,
                    "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
                    "input_tokens": [c.usage.input_tokens for c in comps],
                    "output_tokens": [c.usage.output_tokens for c in comps],
                    "cached_tokens": sum(c.usage.cached_tokens for c in comps),
                    "launches": {k: after[k] - before[k] for k in after},
                    "host_syncs": il.stats.sync_points,
                    "fused_steps": il.stats.fused_steps,
                    "decode_steps": il.stats.decode_steps,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                })
                if on:
                    return
                # The pipelined loop's fetches in this round: ready ones
                # against those the depth bound made wait.
                b1 = served(engine).batcher
                if b1.pipeline_depth != pdepth:
                    raise RuntimeError(f"{label}: the batcher runs depth "
                                       f"{b1.pipeline_depth}, not {pdepth}")
                base = fetch0 if b1 is b0 else {}  # a reused batcher counts on
                fetched = {k: v - base.get(k, 0) for k, v in b1.fetch_counts.items()}
                rounds[-1]["fetches"] = fetched
                emit({"phase": "paged depth", "round": label,
                      "pipeline_depth": il.snapshot()["pipeline_depth"],
                      "fetches": fetched, "wall_s": wall, "card": card()})

            one_round("round 1, speculation on", True, 2, sp)
            one_round("round 2, speculation off", False, 2, sp)
            launched = {k: pa.launches[k] for k in ("paged_decode_attention",
                                                    "paged_decode_attention_mq")}
            prof = None
            if profile:
                spec_mod.configure(enabled=True)
                prof = profile_chat(torch, engine, reqs, sp, "chip_profile_paged.txt")
            lm = served(engine)
            pool_bytes = sum(t.numel() * t.element_size() for t in lm.batcher.pool.values())
            batcher = {"slots": lm.batcher.B, "capacity_tokens": lm.batcher.capacity_tokens,
                       "pool_bytes": pool_bytes}
            # Depth 1 against depth 2 on equal footing and a short budget:
            # a rebuilt (cold) batcher each (the depth, slots and budget
            # key it), the first four requests, 32 new tokens.
            short = SamplingParams(max_new_tokens=32, greedy=True, seed=0)
            one_round("round 3, speculation off, depth 1", False, 1, short, reqs[:4])
            one_round("round 4, speculation off, depth 2", False, 2, short, reqs[:4])
            for k in launched:  # the profiled round's launches stay out
                launched[k] += sum(r["launches"][k] for r in rounds[2:])
        finally:
            spec_mod.configure(enabled=True)
            il.configure(pipeline_depth=il.MAX_PIPELINE_DEPTH)
    r1, r2, r3, r4 = rounds
    if r1["launches"]["paged_decode_attention_mq"] == 0:
        raise RuntimeError(f"B4 never launched with speculation on: {r1['launches']}")
    for r in (r2, r3, r4):
        if r["launches"]["paged_decode_attention"] == 0:
            raise RuntimeError(f"B3 never launched in {r['round']}: {r['launches']}")
    if r2["cached_tokens"] == 0:
        raise RuntimeError("round 2 found no prefix-cache hits on the reused batcher")
    if texts[2] != texts[3]:
        raise RuntimeError("depth 1 and depth 2 gave different texts")
    return {
        "phase": "paged",
        "model": "tpu://random-8b (kv=paged)",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        "batcher": batcher,
        "rounds": rounds,
        "rows_same_text_spec_on_off": sum(a == b for a, b in zip(*texts[:2])),
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


def weight_bytes(params) -> tuple[int, int]:
    """(resident bytes of the params, the bytes the same model takes in
    bf16): a quantized leaf would be its unpacked integer weight at two
    bytes, with no scales."""
    from adversarial_spec_tpu_torch.models.transformer import leaves

    resident = sum(t.numel() * t.element_size() for t in leaves(params))
    weights = [v for k, v in params.items() if k != "layers"]
    weights += [v for lp in params["layers"] for v in lp.values()]
    bf16 = 0
    for v in weights:
        if isinstance(v, dict):  # int8 {"q", "scale"} or int4 {"q4", "scale"}
            bf16 += 2 * v["q"].numel() if "q" in v else 4 * v["q4"].numel()
        else:
            bf16 += 2 * v.numel()
    return resident, bf16


def serve_quantized(torch, spec, reqs, must_launch, profile=False) -> dict:
    """One warm-up call, then one chat() of ``reqs`` on tpu://random-8b as
    ``spec`` (speculation on, 128 new tokens, greedy) with every launch
    counter zeroed just before and read just after; each kernel named in
    ``must_launch`` must have launched, and every row must be ok with 128
    tokens. With ``profile``, one more chat() runs under torch.profiler
    (chiprun_out/chip_profile_quant_<fmt>.txt)."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)
    spec_mod.configure(enabled=True)
    with temp_registry(spec):
        engine = GpuEngine()
        t = time.monotonic()
        warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
        if not warm[0].ok:
            raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
        load_s = time.monotonic() - t
        resident, bf16 = weight_bytes(served(engine).params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        il.reset_stats()
        for mod in (da, pa, qm):
            mod.reset_launches()
        t = time.monotonic()
        comps = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launched = {**da.launches, **pa.launches, **qm.launches}
        peak = torch.cuda.max_memory_allocated()
        prof = (
            profile_chat(torch, engine, reqs, sp, f"chip_profile_quant_{spec.quant}.txt")
            if profile else None
        )
        del engine
    torch.cuda.empty_cache()
    bad = [c.error for c in comps if not c.ok]
    if bad:
        raise RuntimeError(f"{spec.alias} quant={spec.quant}: chat failed: {bad}")
    if any(c.usage.output_tokens != 128 for c in comps):
        raise RuntimeError(f"rows stopped early: {[c.usage.output_tokens for c in comps]}")
    missing = [k for k in must_launch if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{missing} never launched on quant={spec.quant}: {launched}")
    decode_s = sum(c.usage.decode_time_s for c in comps)
    out_tok = sum(c.usage.output_tokens for c in comps)
    return {
        "model": f"tpu://random-8b (quant={spec.quant}, kv={spec.kv})",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        "chat_wall_s": wall,
        "prefill_s": sum(c.usage.prefill_time_s for c in comps),
        "decode_s": decode_s,
        "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
        "input_tokens": [c.usage.input_tokens for c in comps],
        "output_tokens": [c.usage.output_tokens for c in comps],
        "resident_weight_bytes": resident,
        "bf16_weight_bytes": bf16,
        "max_memory_allocated_bytes": peak,
        "host_syncs": il.stats.sync_points,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }


def phase_quant(torch, profile: bool = False) -> dict:
    """Weight-quantized serving of Llama-3-8B on both paths: (a) int8 on
    the dense path (the slice's four requests; B5 with B2), (b) int4 on the
    paged batcher (the paged slice's twelve requests through 8 slots, one
    round; B6 with B4)."""
    from adversarial_spec_tpu_torch.engine.registry import ModelSpec

    dense = serve_quantized(
        torch,
        ModelSpec(alias="random-8b", family="llama", size="8b", quant="int8"),
        slice_requests(),
        ("matmul_int8", "decode_attention_mq"),
        profile,
    )
    paged = serve_quantized(
        torch,
        ModelSpec(alias="random-8b", family="llama", size="8b", quant="int4", kv="paged"),
        paged_requests(),
        ("matmul_int4", "paged_decode_attention_mq"),
        profile,
    )
    return {"phase": "quant", "dense_int8": dense, "paged_int4": paged}


FLOAT_ATTENTION = (
    "decode_attention", "decode_attention_mq",
    "paged_decode_attention", "paged_decode_attention_mq",
)


@contextlib.contextmanager
def recording_dense_caches(made: list):
    """Record (bytes, the same cache's bytes in bf16) of every dense cache
    ``generate()`` builds while the block runs."""
    from adversarial_spec_tpu_torch.engine import generate as gen_mod

    real = gen_mod.init_cache

    def init_cache(*args, **kwargs):
        cache = real(*args, **kwargs)
        made.append((
            sum(t.numel() * t.element_size() for t in cache.values()),
            2 * 2 * cache["k"].numel(),
        ))
        return cache

    gen_mod.init_cache = init_cache
    try:
        yield
    finally:
        gen_mod.init_cache = real


def phase_kv8(torch, profile: bool = False) -> dict:
    """The int8 KV cache (kv_dtype="int8") on random-8b, on temporary
    registry entries: (a) the dense path, the slice's four requests,
    speculation on; (b) the paged path beside int4 weights, the paged
    slice's twelve requests through 8 slots, round 1 with speculation on
    and round 2 with it off on the same batcher. Every launch counter is
    zeroed just before each chat() and read just after: B2-i8 and B1-i8
    must launch in (a), B4-i8 and B6 in (b) round 1, B3-i8 in round 2,
    and the float-cache B1-B4 never. With ``profile``, one more chat() of
    each runs under torch.profiler."""
    from adversarial_spec_tpu_torch.engine import interleave as il
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.registry import ModelSpec
    from adversarial_spec_tpu_torch.engine.types import SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    sp = SamplingParams(max_new_tokens=128, greedy=True, seed=0)

    def load(reqs):
        engine = GpuEngine()
        t = time.monotonic()
        warm = engine.chat([reqs[0]], SamplingParams(max_new_tokens=16, greedy=True))
        if not warm[0].ok:
            raise RuntimeError(f"warm-up chat failed: {warm[0].error}")
        return engine, time.monotonic() - t

    def chat(engine, reqs, label, full_rows=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in (da, pa, qm):
            mod.reset_launches()
        il.reset_stats()
        t = time.monotonic()
        comps = engine.chat(reqs, sp)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launched = {**da.launches, **pa.launches, **qm.launches}
        bad = [c.error for c in comps if not c.ok]
        if bad:
            raise RuntimeError(f"{label}: chat failed: {bad}")
        out = [c.usage.output_tokens for c in comps]
        if (full_rows and any(n != 128 for n in out)) or min(out) < 1:
            raise RuntimeError(f"{label}: rows stopped early: {out}")
        leaked = {k: launched[k] for k in FLOAT_ATTENTION if launched[k]}
        if leaked:
            raise RuntimeError(f"{label}: float-cache kernels ran on an int8 cache: {leaked}")
        decode_s = sum(c.usage.decode_time_s for c in comps)
        return comps, {
            "wall_s": wall,
            "prefill_s": sum(c.usage.prefill_time_s for c in comps),
            "decode_s": decode_s,
            "decode_tokens_per_s": sum(out) / decode_s if decode_s > 0 else 0.0,
            "input_tokens": [c.usage.input_tokens for c in comps],
            "output_tokens": out,
            "cached_tokens": sum(c.usage.cached_tokens for c in comps),
            "host_syncs": il.stats.sync_points,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in launched.items() if v},
        }

    report = {"phase": "kv8"}
    # (a) dense int8 KV, full-precision (bf16) weights.
    reqs = slice_requests()
    spec_mod.configure(enabled=True)
    with temp_registry(ModelSpec(alias="random-8b", family="llama", size="8b", kv_dtype="int8")):
        engine, load_s = load(reqs)
        made = []
        with recording_dense_caches(made):
            _, main = chat(engine, reqs, "kv8 dense")
        calls = [main]
        launched = dict(main["launches"])
        # The same round with speculation off: every decode step is B1-i8.
        spec_mod.configure(enabled=False)
        try:
            _, off = chat(engine, reqs, "kv8 dense, speculation off")
        finally:
            spec_mod.configure(enabled=True)
        calls.append({"speculation": "off", **off})
        if not off["launches"].get("decode_attention_int8kv"):
            raise RuntimeError(f"kv8 dense: B1-i8 never launched with speculation off: {off}")
        launched["decode_attention_int8kv"] = (
            launched.get("decode_attention_int8kv", 0) + off["launches"]["decode_attention_int8kv"]
        )
        missing = [k for k in ("decode_attention_int8kv", "decode_attention_mq_int8kv")
                   if not launched.get(k)]
        if missing:
            raise RuntimeError(f"kv8 dense: {missing} never launched: {calls}")
        resident, _ = weight_bytes(served(engine).params)
        prof = (profile_chat(torch, engine, reqs, sp, "chip_profile_kv8_dense.txt")
                if profile else None)
        del engine
    torch.cuda.empty_cache()
    report["dense"] = {
        "model": "tpu://random-8b (kv_dtype=int8)",
        "requests": len(reqs),
        "load_and_warmup_s": load_s,
        **main,
        "cache_bytes": made[0][0],
        "bf16_cache_bytes": made[0][1],
        "resident_weight_bytes": resident,
        "speculation_off": off,
        "launches": launched,
        **({"profile": prof} if prof else {}),
    }

    # (b) paged int8 KV beside int4 weights, two rounds on one batcher.
    reqs = paged_requests()
    with temp_registry(ModelSpec(alias="random-8b", family="llama", size="8b", kv="paged",
                                 quant="int4", kv_dtype="int8")):
        engine, load_s = load(reqs)
        rounds, launched = [], {}
        try:
            for label, on in (("round 1, speculation on", True),
                              ("round 2, speculation off", False)):
                spec_mod.configure(enabled=on)
                _, r = chat(engine, reqs, f"kv8 paged {label}", full_rows=False)
                rounds.append({"round": label, **r})
                for k, v in r["launches"].items():
                    launched[k] = launched.get(k, 0) + v
            prof = None
            if profile:
                spec_mod.configure(enabled=True)
                prof = profile_chat(torch, engine, reqs, sp, "chip_profile_kv8_paged.txt")
        finally:
            spec_mod.configure(enabled=True)
        lm = served(engine)
        pool = lm.batcher.pool
        resident, bf16 = weight_bytes(lm.params)
        paged = {
            "model": "tpu://random-8b (kv=paged, quant=int4, kv_dtype=int8)",
            "requests": len(reqs),
            "load_and_warmup_s": load_s,
            "slots": lm.batcher.B,
            "capacity_tokens": lm.batcher.capacity_tokens,
            "pool_bytes": sum(t.numel() * t.element_size() for t in pool.values()),
            "bf16_pool_bytes": 2 * 2 * pool["k"].numel(),
            "pool_dtypes": {k: str(t.dtype) for k, t in pool.items()},
            "resident_weight_bytes": resident,
            "bf16_weight_bytes": bf16,
            "rounds": rounds,
            "launches": launched,
            **({"profile": prof} if prof else {}),
        }
        del engine, lm, pool
    torch.cuda.empty_cache()
    r1, r2 = rounds
    for r, names in ((r1, ("paged_decode_attention_mq_int8kv", "matmul_int4")),
                     (r2, ("paged_decode_attention_int8kv",))):
        missing = [k for k in names if not r["launches"].get(k)]
        if missing:
            raise RuntimeError(f"kv8 paged {r['round']}: {missing} never launched: {r['launches']}")
    if r2["cached_tokens"] == 0:
        raise RuntimeError("kv8 paged round 2 found no prefix-cache hits on int8 pages")
    report["paged_int4"] = paged
    return report


@contextlib.contextmanager
def cli_state():
    """The port's CLI pointed at temporary state under build/: sessions
    (and their journals), checkpoints and the registry, all empty. On the
    way out the engines it built are dropped, and the process-wide knobs
    each CLI round sets (speculation, prefix cache, interleave, streaming,
    weight residency, KV tiers, the fleet) get back their values from
    before: a round's ``--no-speculative`` must not reach the phases after
    it. A dropped engine frees its device memory at once (its batcher's
    prefix cache holds no strong reference back), so no collection runs."""
    import dataclasses
    from pathlib import Path

    from adversarial_spec_tpu_torch import fleet
    from adversarial_spec_tpu_torch.debate import session
    from adversarial_spec_tpu_torch.engine import (
        dispatch,
        interleave,
        kvtier,
        prefix_cache,
        registry,
        spec,
        streaming,
        weightres,
    )

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    prev = (session.SESSIONS_DIR, session.CHECKPOINTS_DIR, registry.REGISTRY_PATH)
    knobs = [(m, dataclasses.asdict(m.config()))
             for m in (spec, prefix_cache, interleave, streaming, weightres, kvtier, fleet)]
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        session.SESSIONS_DIR = Path(tmp) / "sessions"
        session.CHECKPOINTS_DIR = Path(tmp) / "checkpoints"
        registry.REGISTRY_PATH = Path(tmp) / "registry.json"
        try:
            yield
        finally:
            session.SESSIONS_DIR, session.CHECKPOINTS_DIR, registry.REGISTRY_PATH = prev
            for mod, values in knobs:
                mod.configure(**values)
            dispatch.clear_engine_cache()


def run_cli(argv: list, stdin: str = "") -> tuple[int, str, str]:
    """``adversarial_spec_tpu_torch.cli.main(argv)`` in this process, with
    ``stdin`` as its standard input: (exit code, stdout, stderr)."""
    import io

    from adversarial_spec_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    prev_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = cli.main(argv)
    finally:
        sys.stdin = prev_stdin
    return code, out.getvalue(), err.getvalue()


def cli_round(torch, label: str, argv: list, stdin: str, must_launch: tuple,
              doc_out: dict | None = None) -> dict:
    """One ``critique`` round through the CLI: B1-B4's and B5/B6's counters
    zeroed just before it and read just after; every kernel of
    ``must_launch`` must have launched. Returns the round's line: its wall
    (perf.spans.round), decode tokens/s, per-model usage, launches, peak
    device memory, all_agreed and a digest of the responses; ``doc_out``
    (when given) receives the round's --json document under "doc"."""
    import hashlib

    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (da, pa, qm):
        mod.reset_launches()
    code, out, err = run_cli(argv, stdin)
    torch.cuda.synchronize()
    launched = {k: v for k, v in {**da.launches, **pa.launches, **qm.launches}.items()
                if k in FLOAT_ATTENTION or k in must_launch}
    if code != 0:
        raise RuntimeError(f"{label}: cli exited {code}: {err[-2000:]}")
    doc = json.loads(out)
    if doc_out is not None:
        doc_out["doc"] = doc
    bad = [r["error"] for r in doc["results"] if r["error"]]
    if bad:
        raise RuntimeError(f"{label}: opponents failed: {bad}")
    missing = [k for k in must_launch if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{label}: {missing} never launched: {launched}")
    perf = doc["perf"]
    responses = json.dumps([r["response"] for r in doc["results"]])
    per_model: dict = {}
    for r in doc["results"]:
        per_model.setdefault(r["model"], []).append(r["response"])
    return {
        "round": label,
        "round_num": doc["round"],
        "round_wall_s": perf["spans"]["round"],
        "decode_tokens_per_sec": perf["decode_tokens_per_sec"],
        "usage": doc["cost"]["models"],
        "output_tokens": [r["output_tokens"] for r in doc["results"]],
        "cached_tokens": sum(r["cached_tokens"] for r in doc["results"]),
        "prefix_cache": {k: perf["prefix_cache"][k]
                         for k in ("lookups", "hits", "saved_tokens")},
        "spec_steps": perf["spec"]["spec_steps"],
        "launches": launched,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "all_agreed": doc["all_agreed"],
        "responses_sha1": hashlib.sha1(responses.encode()).hexdigest(),
        "per_model_sha1": {m: hashlib.sha1(json.dumps(t).encode()).hexdigest()
                           for m, t in per_model.items()},
        "weights": perf["weights"],
        "pipeline_depth": perf["interleave"]["pipeline_depth"],
        "retrace": {
            "programs": sorted(perf["obs"]["retrace"]["programs"]),
            "dispatches": sum(p["dispatches"]
                              for p in perf["obs"]["retrace"]["programs"].values()),
            "unexpected_recompiles": perf["obs"]["retrace"]["unexpected_recompiles"],
        },
    }


def phase_cli(torch) -> dict:
    """The user's entry point: ``critique`` through the port's CLI
    (``cli.main`` in this process, the spec on stdin), on tpu://random-8b
    at full width, bf16, random weights from seed 0, greedy, 128 new
    tokens. (a) dense: four opponents on a ~3 KB spec, round 1 with
    speculation on (B2 must launch), round 2 ``--resume`` with
    ``--no-speculative`` (B1 must launch); (b) paged: a temporary registry
    entry random-8b with kv="paged" made by the CLI's own ``registry``
    action, twelve opponents through 8 slots over two rounds of one
    session, B4 in round 1, B3 in round 2, and round 2 must report
    prefix-cache hits. Each engine loads in a short warm-up round first."""
    from adversarial_spec_tpu_torch.engine import dispatch

    spec = spec_document(3000, 0)
    common = ["--greedy", "--max-new-tokens", "128", "--json"]
    report = {"phase": "cli", "model": "tpu://random-8b", "spec_bytes": len(spec)}
    for part, n_opp, extra in (("dense", 4, []), ("paged", 12, ["--kv", "paged"])):
        models = ",".join(["tpu://random-8b"] * n_opp)
        b_round1, b_round2 = (
            ("decode_attention_mq", "decode_attention") if part == "dense"
            else ("paged_decode_attention_mq", "paged_decode_attention")
        )
        with cli_state():
            if extra:
                code, _, err = run_cli(["registry", "add-model", "random-8b", "--family",
                                        "llama", "--size", "8b", *extra])
                if code != 0:
                    raise RuntimeError(f"registry add-model failed: {err}")
            t = time.monotonic()
            code, _, err = run_cli(["critique", "--models", "tpu://random-8b",
                                    "--greedy", "--max-new-tokens", "16"], spec)
            if code != 0:
                raise RuntimeError(f"{part}: warm-up round exited {code}: {err[-2000:]}")
            load_s = time.monotonic() - t
            session = f"smoke-{part}"
            r1 = cli_round(torch, f"{part} round 1, speculation on",
                           ["critique", "--models", models, "--session", session, *common],
                           spec, (b_round1,))
            emit({"phase": "cli round", "part": part, **r1})
            r2 = cli_round(torch, f"{part} round 2, speculation off",
                           ["critique", "--resume", session, "--no-speculative", *common],
                           "", (b_round2,))
            emit({"phase": "cli round", "part": part, **r2})
            if r2["round_num"] != 2:
                raise RuntimeError(f"{part}: --resume ran round {r2['round_num']}")
            if part == "paged" and r2["prefix_cache"]["hits"] == 0:
                raise RuntimeError("paged round 2 reported no prefix-cache hits")
            for r in (r1, r2):
                if r["pipeline_depth"] != 2:
                    raise RuntimeError(f"{r['round']}: perf.interleave.pipeline_depth "
                                       f"{r['pipeline_depth']}, not the default 2")
                if part == "paged" and (not r["retrace"]["dispatches"]
                                        or r["retrace"]["unexpected_recompiles"]):
                    raise RuntimeError(f"{r['round']}: perf.obs.retrace {r['retrace']}")
            report[part] = {"opponents": n_opp, "load_and_warmup_s": load_s,
                            "rounds": [r1, r2]}
        dispatch.clear_engine_cache()
        torch.cuda.empty_cache()
    launched = {k: 0 for k in FLOAT_ATTENTION}
    for part in ("dense", "paged"):
        for r in report[part]["rounds"]:
            for k in FLOAT_ATTENTION:
                launched[k] += r["launches"][k]
    report["launches"] = launched
    return report


# Meta's HF names of a Llama layer's tensors (``model.layers.{i}.`` prefix).
HF_LAYER_NAMES = {
    "attn_norm": "input_layernorm.weight",
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "ffn_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}


# Phases hf and pool load and swap whole checkpoints: their point (a
# bit-identical load, the cache, residency under a byte budget) needs
# Llama-3-8B's widths, not all 32 of its layers.
HF_POOL_LAYERS = 8


@contextlib.contextmanager
def depth(n_layers: int, key: tuple = ("llama", "8b")):
    """While the block runs, the config ``key`` (random-8b's, llama/8b, by
    default) keeps its full width and only its first ``n_layers`` layers:
    every engine, loader preflight and checkpoint written in the block
    sees that depth."""
    import dataclasses

    from adversarial_spec_tpu_torch.models import config

    full = config.CONFIGS[key]
    config.CONFIGS[key] = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield
    finally:
        config.CONFIGS[key] = full


def write_hf_checkpoint(torch, params, cfg, path: str) -> dict:
    """``params`` (the port's ``[in, out]`` layout, on the card) written at
    ``path`` as Meta lays out Llama-3-8B: four ``model-0000k-of-00004``
    bf16 shards with HF names and torch's ``[out, in]`` Linear layout,
    ``model.safetensors.index.json`` and a ``config.json`` built from the
    registered config. Written with the port's own ``save_file``, one
    tensor at a time."""
    from adversarial_spec_tpu_torch.utils.safetensors import save_file

    named = [("model.embed_tokens.weight", params["embed"])]
    for i, lp in enumerate(params["layers"]):
        for key, hf in HF_LAYER_NAMES.items():
            t = lp[key]
            named.append((f"model.layers.{i}.{hf}", t.t() if t.dim() == 2 else t))
    named += [("model.norm.weight", params["final_norm"]),
              ("lm_head.weight", params["lm_head"].t())]
    total = sum(t.numel() * t.element_size() for _, t in named)
    shards = [{} for _ in range(4)]
    cum = 0
    for name, t in named:  # each tensor in the shard where it starts
        shards[min(3, cum * 4 // total)][name] = t
        cum += t.numel() * t.element_size()
    weight_map = {}
    t0 = time.monotonic()
    for k, shard in enumerate(shards, 1):
        fname = f"model-{k:05d}-of-00004.safetensors"
        save_file(shard, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "intermediate_size": cfg.ffn_dim,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps, "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tied_embeddings, "hidden_act": "silu",
            "torch_dtype": "bfloat16",
        }, f, indent=1)
    return {"seconds": time.monotonic() - t0, "bytes": total, "tensors": len(named),
            "shard_bytes": [sum(t.numel() * t.element_size() for t in s.values())
                            for s in shards]}


@contextlib.contextmanager
def recording_loads(torch, records: list):
    """Time each HF conversion (``materialize_params`` as ``GpuEngine``
    calls it), native-cache read (``load_native``) and cache write
    (``save_native``) while the block runs, each with the bytes the port's
    reader read, its largest host staging (read buffers alive at once),
    the device memory allocated before it and the peak during it
    (``max_memory_allocated``, reset just before), and the resident bytes
    of the params it produced."""
    from adversarial_spec_tpu_torch.engine import checkpoint as ckpt_mod
    from adversarial_spec_tpu_torch.engine import gpu as gpu_mod
    from adversarial_spec_tpu_torch.utils import safetensors

    def wrap(what, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            safetensors.reset_stats()
            t = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            st = safetensors.stats
            rec = {"phase": "hf load", "what": what, "seconds": time.monotonic() - t,
                   "bytes_read": st.bytes_read, "tensors_read": st.tensors_read,
                   "largest_read_bytes": st.max_read_bytes,
                   "largest_host_staging_bytes": st.peak_live_bytes,
                   "device_bytes_before": before,
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
            params = {"hf": lambda: out[0], "cache": lambda: out}.get(what)
            if params is not None:
                rec["resident_weight_bytes"] = weight_bytes(params())[0]
            else:
                cache = args[1]
                rec["bytes_written"] = sum(
                    os.path.getsize(os.path.join(cache, f)) for f in os.listdir(cache))
            records.append(rec)
            return out
        return run

    real = (gpu_mod.materialize_params, ckpt_mod.load_native, ckpt_mod.save_native)
    gpu_mod.materialize_params = wrap("hf", real[0])
    ckpt_mod.load_native = wrap("cache", real[1])
    ckpt_mod.save_native = wrap("cache write", real[2])
    try:
        yield
    finally:
        gpu_mod.materialize_params, ckpt_mod.load_native, ckpt_mod.save_native = real


def served(engine):
    """The one model a single-alias ``GpuEngine`` holds."""
    (lm,) = engine._models.values()
    return lm


def cli_engine():
    """The CLI's cached ``GpuEngine``."""
    from adversarial_spec_tpu_torch.engine import dispatch

    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

    (engine,) = [e for e in dispatch.cached_engines() if isinstance(e, GpuEngine)]
    return engine


def served_params():
    """The params the CLI's cached ``GpuEngine`` holds (one model)."""
    return served(cli_engine()).params


def check_same_params(torch, got, init, quant: str = "") -> int:
    """Every leaf of ``got`` bit-identical to ``init`` (full precision, on
    the card) — with ``quant``, each matmul weight to ``quantize_params``
    of its init leaf — and no leaf missing or extra. Returns the leaves
    compared."""
    from adversarial_spec_tpu_torch.engine.checkpoint import flatten
    from adversarial_spec_tpu_torch.ops.quant import QUANTIZABLE, quantize_params

    have = flatten(got)
    names = set()
    for name, t in flatten(init).items():
        key = name.rsplit(".", 1)[-1]
        parts = ({f"{name}.{p}": v for p, v in quantize_params({key: t}, fmt=quant)[key].items()}
                 if quant and key in QUANTIZABLE else {name: t})
        for n, v in parts.items():
            names.add(n)
            g = have.get(n)
            if g is None or g.dtype != v.dtype or not torch.equal(g, v):
                raise RuntimeError(f"loaded leaf {n} differs from its source")
    if set(have) != names:
        raise RuntimeError(f"loaded leaves {sorted(set(have) ^ names)[:6]} differ")
    return len(have)


def phase_hf(torch, ckpt: str) -> dict:
    """HF safetensors checkpoints from the user's entry point. random-8b's
    own weights (init on the card, seed 0: Llama-3-8B at full width, at the
    depth its config has while the phase runs (``depth``), bf16) written as Meta lays out the model (``write_hf_checkpoint``)
    at ``ckpt`` (a directory under build/, which phase pool reuses and the
    caller deletes), registered with the CLI's ``registry add-model`` (no
    tokenizer: the byte tokenizer) and served by ``critique`` rounds:
    (a) ``hf-8b``, dense, four opponents (phase ``cli`` (a)'s round) —
    cold: HF conversion, then the native-cache write (B2 and B1 must
    launch); then the engine dropped (dispatch cleared) and the round run
    again — warm: from the native cache, identical greedy text; (b)
    ``hf-8b-int4`` (kv=paged, quant=int4) on the same directory, twelve
    opponents through 8 slots: round 1 speculation on (B4 and B6 must
    launch), round 2 ``--resume --no-speculative`` (B3 and B6). After each
    load the served params must be bit-identical to the init they were
    written from (the int4 leaves to ``quantize_params`` of it). Each load
    and cache write prints an ``hf load`` line. The phase fails, with the
    bytes it needs, when build/ lacks the disk (for phase pool's int8 cache
    too)."""
    import math

    from adversarial_spec_tpu_torch.engine import dispatch
    from adversarial_spec_tpu_torch.engine.checkpoint import layout
    from adversarial_spec_tpu_torch.models.config import get_config
    from adversarial_spec_tpu_torch.models.transformer import init_params

    cfg = get_config("llama", "8b")
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)

    def nbytes(lay):
        return sum(math.prod(shape) * dt.itemsize for dt, shape in lay.values())

    bf16 = nbytes(layout(cfg, torch.bfloat16, "", False))
    # The checkpoint, its bf16 cache, the int4 cache and phase pool's int8
    # cache, with 1 GiB slack.
    need = (2 * bf16 + nbytes(layout(cfg, torch.bfloat16, "int4", False))
            + nbytes(layout(cfg, torch.bfloat16, "int8", False)) + (1 << 30))
    free = shutil.disk_usage(build).free
    if free < need:
        raise RuntimeError(f"phase hf needs {need} bytes of disk under build/, {free} are free")
    report = {"phase": "hf", "model": "random-8b written as an HF checkpoint",
              "disk_needed_bytes": need, "disk_free_bytes": free}
    loads: list = []
    try:
        init = init_params(cfg, device=torch.device("cuda"), dtype=torch.bfloat16, seed=0)
        report["write"] = write_hf_checkpoint(torch, init, cfg, ckpt)
        emit({"phase": "hf write", **report["write"]})
        spec = spec_document(3000, 0)
        common = ["--greedy", "--max-new-tokens", "128", "--json"]
        rounds = []
        with cli_state(), recording_loads(torch, loads):
            for alias, extra in (("hf-8b", []), ("hf-8b-int4", ["--kv", "paged", "--quant", "int4"])):
                code, _, err = run_cli(["registry", "add-model", alias, "--checkpoint", ckpt,
                                        "--family", "llama", "--size", "8b", *extra])
                if code != 0:
                    raise RuntimeError(f"registry add-model {alias} failed: {err}")
            dense = ",".join(["tpu://hf-8b"] * 4)
            for label in ("cold", "warm"):
                r = cli_round(torch, f"hf dense, {label} load",
                              ["critique", "--models", dense, "--session", f"hf-{label}",
                               *common], spec, ("decode_attention_mq", "decode_attention"))
                r["leaves_identical"] = check_same_params(torch, served_params(), init)
                emit({"phase": "cli round", "part": f"hf dense {label}", **r})
                rounds.append(r)
                dispatch.clear_engine_cache()
                torch.cuda.empty_cache()
            if rounds[0]["responses_sha1"] != rounds[1]["responses_sha1"]:
                raise RuntimeError("the warm round's greedy text differs from the cold round's")
            paged = ",".join(["tpu://hf-8b-int4"] * 12)
            for label, argv, stdin, must in (
                ("round 1, speculation on",
                 ["critique", "--models", paged, "--session", "hf-int4", *common], spec,
                 ("paged_decode_attention_mq", "matmul_int4")),
                ("round 2, speculation off",
                 ["critique", "--resume", "hf-int4", "--no-speculative", *common], "",
                 ("paged_decode_attention", "matmul_int4")),
            ):
                r = cli_round(torch, f"hf paged int4 {label}", argv, stdin, must)
                if label.startswith("round 1"):  # the round that loaded
                    r["leaves_identical"] = check_same_params(
                        torch, served_params(), init, "int4")
                emit({"phase": "cli round", "part": f"hf paged int4 {label}", **r})
                rounds.append(r)
        for rec in loads:
            emit(rec)
        whats = [rec["what"] for rec in loads]
        if whats != ["hf", "cache write", "cache", "hf", "cache write"]:
            raise RuntimeError(f"loads ran {whats}: expected HF, cache write, cache, HF "
                               "(int4), cache write")
    finally:
        dispatch.clear_engine_cache()
        torch.cuda.empty_cache()
    launched = {}
    for r in rounds:
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
    report.update(rounds=rounds, loads=loads, launches=launched)
    return report


# Phase pool's aliases on phase hf's checkpoint: (its tokenizer under
# tests/torch_tokenizers/, ``registry add-model`` flags).
POOL = {
    "pool-a": ("llama3", []),
    "pool-b": ("mistral", ["--quant", "int8"]),
    "pool-c": ("gemma2", ["--quant", "int4", "--kv", "paged"]),
    "pool-d": ("qwen2", []),
}
POOL_HOST_MB = 48000  # room on the host for every demoted model at once


@contextlib.contextmanager
def recording_tokenizers(encodes: list, decodes: dict):
    """While the block runs, time every ``HFTokenizer.encode`` ((seconds,
    characters, tokens) per prompt into ``encodes``) and keep the longest
    id sequence each tokenizer file decodes (a row's generated ids; a
    streamed row decodes growing prefixes) in ``decodes``."""
    from adversarial_spec_tpu_torch.engine import tokenizer as tok_mod

    real_encode, real_decode = tok_mod.HFTokenizer.encode, tok_mod.HFTokenizer.decode

    def encode(self, text, add_bos=True):
        t = time.perf_counter()
        ids = real_encode(self, text, add_bos)
        encodes.append((time.perf_counter() - t, len(text), len(ids)))
        return ids

    def decode(self, ids):
        ids = [int(i) for i in ids]
        if len(ids) >= len(decodes.get(self._tok.path, ())):
            decodes[self._tok.path] = ids
        return real_decode(self, ids)

    tok_mod.HFTokenizer.encode, tok_mod.HFTokenizer.decode = encode, decode
    try:
        yield
    finally:
        tok_mod.HFTokenizer.encode, tok_mod.HFTokenizer.decode = real_encode, real_decode


def recording_swaps(engine) -> list:
    """The list each load, demotion and promotion the engine's ledger
    commits from now on is appended to: {op, alias, bytes, seconds,
    overlapped}."""
    ledger, records = engine.ledger, []

    def wrap(op, fn, nbytes_at):
        def run(alias, *args, **kwargs):
            out = fn(alias, *args, **kwargs)
            wall = kwargs.get("wall_s", args[nbytes_at + 1] if len(args) > nbytes_at + 1 else 0.0)
            records.append({"op": op, "alias": alias, "bytes": args[nbytes_at],
                            "seconds": wall, "overlapped": bool(kwargs.get("overlapped"))})
            return out
        return run

    ledger.admit_load = wrap("load", ledger.admit_load, 0)
    ledger.demote_model = wrap("demote", ledger.demote_model, 1)
    ledger.promote_model = wrap("promote", ledger.promote_model, 0)
    return records


def phase_pool(torch, ckpt: str) -> dict:
    """Real checkpoints as an opponent pool, from the user's entry point.
    Phase hf's checkpoint (random-8b's weights in Meta's 4-shard layout)
    registered four times with ``registry add-model``, each alias with
    its own ``tokenizer.json`` (``tests/torch_tokenizers/``: Llama-3,
    Mistral, Gemma-2 and Qwen2 layouts, read by the port's reader):
    ``pool-a`` bf16, ``pool-b`` int8, ``pool-c`` int4 with kv=paged,
    ``pool-d`` bf16 (~16 GB of weights at phase hf's 8 layers). One ``critique`` session names
    all four on an ~11 KB spec (prompts of ~4200 tokens), 128 new tokens, greedy, prefix cache off (a demoted model
    loses its prefix cache, so text is compared without it): round 1
    speculation on (B2, B4, B5, B6 must launch), rounds 2 and 3 ``--resume
    --no-speculative`` (B1, B3, B5, B6). (a) At the natural budget all
    four stay resident: rounds 2 and 3 must load nothing. (b) A fresh engine
    under ``ADVSPEC_HBM_BUDGET_BYTES`` = pool-a + pool-b + half of pool-c
    (two of the four fit) and ``--weight-host-mb 48000``: the rounds must
    demote, promote and consume a prefetch. Every alias's greedy text and
    generated ids must be identical between (a) and (b) (random weights
    pick many ids outside a ~3000-token vocabulary, which decode drops).
    Each round prints a ``cli round`` line with its
    residency counters, the swaps the ledger committed (bytes, seconds),
    the prefetch hits and the encode seconds per prompt."""
    import hashlib

    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.engine.gpu import estimate_param_bytes

    tok_root = os.path.join(HERE, "tests", "torch_tokenizers")
    spec = spec_document(11000, 0)  # prompts of ~4200 tokens
    models = ",".join(f"tpu://{a}" for a in POOL)
    common = ["--greedy", "--max-new-tokens", "128", "--json", "--no-prefix-cache",
              "--weight-host-mb", str(POOL_HOST_MB)]
    round_1 = ("decode_attention_mq", "paged_decode_attention_mq", "matmul_int8", "matmul_int4")
    round_2 = ("decode_attention", "paged_decode_attention", "matmul_int8", "matmul_int4")
    report = {"phase": "pool", "aliases": {a: {"tokenizer": t, "flags": f}
                                           for a, (t, f) in POOL.items()}}
    texts = {}
    prev_budget = os.environ.pop("ADVSPEC_HBM_BUDGET_BYTES", None)
    try:
        with cli_state():
            for alias, (layout, flags) in POOL.items():
                code, _, err = run_cli(["registry", "add-model", alias, "--checkpoint", ckpt,
                                        "--tokenizer", os.path.join(tok_root, layout),
                                        "--family", "llama", "--size", "8b", *flags])
                if code != 0:
                    raise RuntimeError(f"registry add-model {alias} failed: {err}")
            sizes = {a: estimate_param_bytes(registry.resolve_model_spec(f"tpu://{a}"))
                     for a in POOL}
            report["weight_bytes"] = sizes
            for part in ("a", "b"):
                if part == "b":
                    budget = sizes["pool-a"] + sizes["pool-b"] + sizes["pool-c"] // 2
                    os.environ["ADVSPEC_HBM_BUDGET_BYTES"] = str(budget)
                    report["forced_budget_bytes"] = budget
                dispatch.clear_engine_cache()
                torch.cuda.empty_cache()
                engine = dispatch.get_engine("tpu://pool-a")
                committed = recording_swaps(engine)
                rounds = []
                for label, argv, stdin, must in (
                    ("round 1, speculation on",
                     ["critique", "--models", models, "--session", f"pool-{part}", *common],
                     spec, round_1),
                    ("round 2, speculation off",
                     ["critique", "--resume", f"pool-{part}", "--no-speculative", *common],
                     "", round_2),
                    ("round 3, speculation off",
                     ["critique", "--resume", f"pool-{part}", "--no-speculative", *common],
                     "", round_2),
                ):
                    encodes, decodes = [], {}
                    n_swaps, hits = len(committed), engine.prefetch_hits
                    with recording_tokenizers(encodes, decodes):
                        r = cli_round(torch, f"pool ({part}) {label}", argv, stdin, must)
                    swaps = committed[n_swaps:]
                    ids = {a: decodes[os.path.join(tok_root, t, "tokenizer.json")]
                           for a, (t, _) in POOL.items()}
                    vocab = {a: engine._models[a].tokenizer.vocab_size
                             if a in engine._models else None for a in POOL}
                    r.update(
                        ids_sha1={a: hashlib.sha1(json.dumps(v).encode()).hexdigest()
                                  for a, v in ids.items()},
                        ids_in_vocab={a: sum(i < (vocab[a] or 0) for i in v)
                                      for a, v in ids.items()},
                        prefetch_hits=engine.prefetch_hits - hits, swaps=swaps,
                        swap_bytes=sum(w["bytes"] for w in swaps if w["op"] != "load"),
                        swap_seconds=sum(w["seconds"] for w in swaps if w["op"] != "load"),
                        encode_seconds=[e[0] for e in encodes],
                        encode_tokens=[e[2] for e in encodes],
                        resident=sorted(engine.ledger.resident_aliases()),
                        host=sorted(engine.ledger.host_aliases()),
                    )
                    engine.check_residency_invariants()
                    emit({"phase": "cli round", "part": f"pool ({part})", **r})
                    rounds.append(r)
                report[part] = rounds
                texts[part] = [(r["per_model_sha1"], r["ids_sha1"]) for r in rounds]
        for r in report["a"][1:]:
            if r["weights"]["loads"] != 0:
                raise RuntimeError(f"{r['round']} loaded {r['weights']['loads']} models")
        wb = [r["weights"] for r in report["b"]]
        for key in ("demotions", "promotions"):
            if not sum(w[key] for w in wb):
                raise RuntimeError(f"pool (b) made no {key}: {wb}")
        if not sum(r["prefetch_hits"] for r in report["b"]):
            raise RuntimeError("pool (b) consumed no prefetch")
        if texts["a"] != texts["b"]:
            raise RuntimeError("pool: greedy text or ids differ between (a) and (b)")
    finally:
        if prev_budget is None:
            os.environ.pop("ADVSPEC_HBM_BUDGET_BYTES", None)
        else:
            os.environ["ADVSPEC_HBM_BUDGET_BYTES"] = prev_budget
        dispatch.clear_engine_cache()
        torch.cuda.empty_cache()
    launched = {}
    for part in ("a", "b"):
        for r in report[part]:
            for k, v in r["launches"].items():
                launched[k] = launched.get(k, 0) + v
    report["launches"] = launched
    return report


# Phase batcher: the paged batcher's fault containment, per-request
# watchdog, legacy loop and KV tiers at full width.
BATCHER_NEW_TOKENS = 32
BATCHER_HOST_MB = 1024  # holds the ~65 demoted 8 MiB blocks of one prompt
BATCHER_CAP_PAGES = 8  # the prefix cache keeps 8 pages: the rest demotes
WATCHDOG_TRIES = 4  # drains that may look for a deadline landing mid-decode
# A fresh process reads the disk tier: the port's CLI in a new Python,
# its registry and sessions under the phase's temporary directory; the
# ids its batcher drains generated go to the file named third.
FRESH_ROUND = r"""
import json
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import chip_smoke
from adversarial_spec_tpu_torch import cli
from adversarial_spec_tpu_torch.debate import session
from adversarial_spec_tpu_torch.engine import registry
tmp = Path(sys.argv[2])
session.SESSIONS_DIR = tmp / "fresh-sessions"
session.CHECKPOINTS_DIR = tmp / "fresh-checkpoints"
registry.REGISTRY_PATH = tmp / "registry.json"
calls = []
with chip_smoke.recording_ids(calls):
    code = cli.main(sys.argv[4:])
Path(sys.argv[3]).write_text(json.dumps(calls))
sys.exit(code)
"""


@contextlib.contextmanager
def recording_ids(calls: list):
    """While the block runs, append the ids each paged batcher drain
    generated to ``calls``: one list per drain, each request's ids in
    request order. Phase batcher compares these, not text: random weights
    pick most ids outside the byte tokenizer's range, whose decode drops
    them, so most of random-8b's texts are empty."""
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

    real = GpuEngine._run_batcher

    def run(self, *args, **kwargs):
        results, decode_time = real(self, *args, **kwargs)
        calls.append([[int(i) for i in r.tokens[: r.n_generated]] for r in results])
        return results, decode_time

    GpuEngine._run_batcher = run
    try:
        yield
    finally:
        GpuEngine._run_batcher = real


@contextlib.contextmanager
def timing_tier_swaps(torch, token_bytes: int, out: dict):
    """While the block runs, time the batcher's own swaps on the card by
    CUDA events on the current stream, the stream both enqueue their
    copies on. Each demotion fetch (``_fetch_page_kv``: the page gather
    and the device→host copy into the pinned arena) is bracketed by two
    events; each promotion (``_promote_tier_blocks``) by four: its
    start, the pool scatter's start and end (``write_tokens`` inside the
    call), its end. An interval also holds any time the stream waited
    for the host to enqueue the work (the first demotion's holds the
    arena's allocation). On the way out, wait, and write per path the
    calls, tokens, bytes, device ms and GB/s (the demotions' also without
    the first call), the promotions' staging ms (materialize and the
    host→device copies) and scatter ms, and host ms into ``out``.
    Patches the class: only batchers built inside the block time their
    demotions (the prefix cache binds the fetch at construction)."""
    from adversarial_spec_tpu_torch.engine import scheduler as sched

    cls = sched.ContinuousBatcher
    real_fetch, real_promote, real_write = (cls._fetch_page_kv, cls._promote_tier_blocks,
                                            sched.write_tokens)
    demotes, promotes = [], []

    def event():
        return torch.cuda.Event(enable_timing=True)

    def fetch(self, page, n_tokens):
        marks = [event(), event()]
        t = time.perf_counter()
        marks[0].record()
        res = real_fetch(self, page, n_tokens)
        marks[1].record()
        demotes.append((marks, n_tokens, time.perf_counter() - t))
        return res

    def promote(self, *args):
        marks = [event() for _ in range(4)]

        def write(*a, **kw):
            marks[1].record()
            res = real_write(*a, **kw)
            marks[2].record()
            return res

        t = time.perf_counter()
        marks[0].record()
        sched.write_tokens = write
        try:
            done = real_promote(self, *args)
        finally:
            sched.write_tokens = real_write
        marks[3].record()
        if done:
            promotes.append((marks, done, time.perf_counter() - t))
        return done

    cls._fetch_page_kv, cls._promote_tier_blocks = fetch, promote
    try:
        yield
    finally:
        cls._fetch_page_kv, cls._promote_tier_blocks = real_fetch, real_promote
        torch.cuda.synchronize()
        ms = [m[0].elapsed_time(m[1]) for m, _, _ in demotes]
        tokens = sum(n for _, n, _ in demotes)
        rest = tokens - (demotes[0][1] if demotes else 0)
        out["demote"] = {
            "calls": len(demotes), "tokens": tokens, "bytes": tokens * token_bytes,
            "device_ms": sum(ms), "gbps": tokens * token_bytes / sum(ms) / 1e6 if ms else None,
            "first_ms": ms[0] if ms else None,
            "gbps_after_first": (rest * token_bytes / sum(ms[1:]) / 1e6
                                 if len(ms) > 1 else None),
            "host_ms": sum(h for _, _, h in demotes) * 1e3,
        }
        tokens = sum(n for _, n, _ in promotes)
        total = sum(m[0].elapsed_time(m[3]) for m, _, _ in promotes)
        out["promote"] = {
            "runs": len(promotes), "tokens": tokens, "bytes": tokens * token_bytes,
            "device_ms": total, "gbps": tokens * token_bytes / total / 1e6 if total else None,
            "staging_ms": [m[0].elapsed_time(m[1]) for m, _, _ in promotes],
            "scatter_ms": [m[1].elapsed_time(m[2]) for m, _, _ in promotes],
            "host_ms": sum(h for _, _, h in promotes) * 1e3,
        }


@contextlib.contextmanager
def stale_promotions(torch, page: int, runs: list):
    """While the block runs, every promoted run reaches the pool as stale
    KV, what a reused arena slot read before its copy landed would
    write: each block of the run carries the run's first block's K/V
    (a one-block run is zeroed). Appends each run's block count to
    ``runs``. Phase batcher's control that its id checks see a wrong
    promotion."""
    from adversarial_spec_tpu_torch.engine import scheduler as sched

    real_promote, real_write = sched.ContinuousBatcher._promote_tier_blocks, sched.write_tokens

    def stale(t):
        if t is None:
            return None
        n = t.shape[3] // page
        if n < 2:
            return torch.zeros_like(t)
        reps = [1] * t.dim()
        reps[3] = n
        return t[:, :, :, :page].repeat(*reps)

    def write(pool, k, v, phys, offs, ks_new=None, vs_new=None):
        runs.append(k.shape[3] // page)
        return real_write(pool, stale(k), stale(v), phys, offs,
                          ks_new=stale(ks_new), vs_new=stale(vs_new))

    def promote(self, *args):
        sched.write_tokens = write
        try:
            return real_promote(self, *args)
        finally:
            sched.write_tokens = real_write

    sched.ContinuousBatcher._promote_tier_blocks = promote
    try:
        yield
    finally:
        sched.ContinuousBatcher._promote_tier_blocks = real_promote


def compare_ids(checks: list, label: str, got: list, want: list, rows=None) -> None:
    """Append to ``checks`` whether ``got``'s rows (every row, or those
    named in ``rows``) hold ``want``'s ids, with the first position at
    which each row differs. Phase batcher fails at its end if any
    check did not hold."""
    rows = list(range(len(want))) if rows is None else list(rows)
    first = {}
    for i in rows:
        a, b = (got[i] if i < len(got) else None), want[i]
        if a != b:
            first[i] = (None if a is None else
                        next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                             min(len(a), len(b))))
    checks.append({"check": label, "rows": rows, "ok": not first, "first_diff": first})


def batcher_round(torch, label, argv, stdin, must_launch, launched) -> tuple[dict, list]:
    """One ``critique`` round of phase batcher: ``cli_round``'s line plus
    the round's ``perf.kv_tier``, each opponent's prefill seconds and
    prompt tokens, and a digest of the generated ids; adds the round's
    paged-kernel launches (zeroed before it, read after) to ``launched``.
    Returns (line, each opponent's generated ids)."""
    import hashlib

    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    holder: dict = {}
    calls: list = []
    with recording_ids(calls):
        line = cli_round(torch, label, argv, stdin, must_launch, doc_out=holder)
    for k in pa.launches:
        launched[k] += pa.launches[k]
    ids = [row for call in calls for row in call]
    if not ids or not all(ids):
        raise RuntimeError(f"{label}: an opponent generated no ids: {[len(r) for r in ids]}")
    doc = holder["doc"]
    line["kv_tier"] = doc["perf"]["kv_tier"]
    line["prefill_s"] = [r["prefill_time_s"] for r in doc["results"]]
    line["input_tokens"] = [r["input_tokens"] for r in doc["results"]]
    line["ids_sha1"] = hashlib.sha1(json.dumps(ids).encode()).hexdigest()
    # The ids the byte tokenizer decodes into text (3-258): few of them.
    line["ids_decoded"] = sum(3 <= i <= 258 for row in ids for i in row)
    line["ids"] = sum(len(row) for row in ids)
    return line, ids


def tier_rates(line: dict, block_bytes: int) -> dict:
    """Demote and promote (or rehydrate, or store-write) rates from a
    round's ``perf.kv_tier``: blocks × block bytes over the swap walls.
    ``swap_out_s`` is host time: a demotion's device→host copy is
    enqueued there and lands later (the store's flush at drain end waits
    for it and writes the files)."""
    kt = line["kv_tier"]
    moved_in = (kt["promoted_blocks"] + kt["rehydrated_blocks"]) * block_bytes
    moved_out = (kt["demoted_blocks"] + kt["store_writes"]) * block_bytes
    return {
        "bytes_in": moved_in,
        "swap_in_s": kt["swap_in_s"],
        "in_gbps": moved_in / kt["swap_in_s"] / 1e9 if kt["swap_in_s"] else None,
        "bytes_out": moved_out,
        "swap_out_s": kt["swap_out_s"],
        "out_gbps": moved_out / kt["swap_out_s"] / 1e9 if kt["swap_out_s"] else None,
    }


def batcher_faults(torch, engine, alias: str, launched: dict, checks: list) -> dict:
    """Part (d): faults and the watchdog through the engine serving
    ``alias`` (its loaded weights), in the fused loop and then in the
    legacy loop, speculation and the prefix cache off so that every call
    prefills the same way: three requests on distinct specs, 48 new
    tokens, greedy. In each loop: a fault-free call, then (1) a transient
    ``scheduler_chunk`` fault naming slot 1 (requeued once, completes),
    (2) a permanent ``kv_alloc`` fault on the first admission (request 0
    fails, alone), each with the other rows' generated ids checked
    against the fault-free call's; (3) through the engine's batcher (a
    per-request deadline is not a chat() argument): request 1 with a
    deadline of half the fault-free drain's wall (bisected over at most
    WATCHDOG_TRIES drains while it expires before the request's first
    token or after its last) is evicted as TIMEOUT with its partial ids,
    a prefix of its fault-free ids, and the others' ids are the
    fault-free drain's."""
    from adversarial_spec_tpu_torch.engine import interleave, prefix_cache, spec
    from adversarial_spec_tpu_torch.engine.scheduler import SchedRequest
    from adversarial_spec_tpu_torch.engine.tokenizer import apply_chat_template
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.resilience import faults, injector

    reqs = [
        ChatRequest(model=f"tpu://{alias}", system=PERSONAS[i],
                    user=spec_document(1500 + 200 * i, 30 + i) + "\n\nCritique this spec.")
        for i in range(3)
    ]
    sp = SamplingParams(max_new_tokens=48, greedy=True)
    prev = (spec.config().enabled, prefix_cache.config().enabled, interleave.config().enabled)
    spec.configure(enabled=False)
    prefix_cache.configure(enabled=False)
    report: dict = {}

    def generated(results) -> list:
        return [[int(i) for i in r.tokens[: r.n_generated]] for r in results]

    def chat(loop, label, chaos=""):
        pa.reset_launches()
        faults.reset()
        injector.install(injector.FaultInjector(injector.parse_chaos_spec(chaos))
                         if chaos else None)
        calls: list = []
        t = time.monotonic()
        try:
            with recording_ids(calls):
                comps = engine.chat(reqs, sp)
        finally:
            injector.install(None)
        torch.cuda.synchronize()
        for k in pa.launches:
            launched[k] += pa.launches[k]
        if pa.launches["paged_decode_attention"] == 0:
            raise RuntimeError(f"batcher (d) {loop} {label}: B3 never launched: {pa.launches}")
        report[loop][label] = {"wall_s": time.monotonic() - t, "ok": [c.ok for c in comps],
                               "errors": [c.error for c in comps],
                               "transient": [c.transient for c in comps],
                               "faults": faults.snapshot(), "launches": dict(pa.launches)}
        return comps, calls[-1]

    try:
        for loop in ("fused", "legacy"):
            interleave.configure(enabled=loop == "fused")
            report[loop] = {}
            base, base_ids = chat(loop, "fault_free")
            if not all(c.ok for c in base):
                raise RuntimeError(f"batcher (d) {loop}: fault-free call failed: {report}")
            got, got_ids = chat(loop, "transient_scheduler_chunk",
                                "device_lost@scheduler_chunk:after=1:times=1:slot=1")
            if not all(c.ok for c in got):
                raise RuntimeError(f"batcher (d) {loop}: transient fault not contained: {report}")
            if report[loop]["transient_scheduler_chunk"]["faults"] != {
                    "scheduler_chunk.device_lost": 1}:
                raise RuntimeError(f"batcher (d) {loop}: the transient fault did not fire once: "
                                   f"{report}")
            compare_ids(checks, f"(d) {loop}: transient scheduler_chunk fault, rows 0 and 2",
                        got_ids, base_ids, rows=(0, 2))
            report[loop]["transient_scheduler_chunk"]["requeued_row_ids_equal"] = (
                got_ids[1] == base_ids[1])
            got, got_ids = chat(loop, "permanent_kv_alloc", "bug@kv_alloc:times=1")
            if got[0].ok or got[0].transient or [c.ok for c in got[1:]] != [True, True]:
                raise RuntimeError(f"batcher (d) {loop}: kv_alloc fault not contained: {report}")
            compare_ids(checks, f"(d) {loop}: permanent kv_alloc fault, rows 1 and 2",
                        got_ids, base_ids, rows=(1, 2))

            lm = engine._models[alias]
            b, tok = lm.batcher, lm.tokenizer
            if b.interleave is not (loop == "fused"):
                raise RuntimeError(f"batcher (d) {loop}: the batcher ran the other loop")
            ids = [tok.encode(apply_chat_template(lm.spec.family, r.system, r.user, False))
                   for r in reqs]

            def drain(deadline_s=0.0):
                pa.reset_launches()
                for i, p in enumerate(ids):
                    b.submit(SchedRequest(req_id=i, prompt_ids=p, max_new_tokens=48,
                                          deadline_s=deadline_s if i == 1 else 0.0))
                t = time.monotonic()
                res = b.run_all()
                torch.cuda.synchronize()
                for k in pa.launches:
                    launched[k] += pa.launches[k]
                return res, time.monotonic() - t

            clean, wall = drain()
            # The deadline must expire while request 1 decodes. Half the
            # fault-free wall lands there on most runs, but two drains'
            # walls differ by up to a third on the card, so a deadline
            # that expires before its first token (too early) or after
            # its last (too late) is bisected, at most WATCHDOG_TRIES
            # drains; the outcome is then checked as before.
            lo, hi, deadline, tries = 0.0, wall, wall / 2, []
            for _ in range(WATCHDOG_TRIES):
                res, timed_wall = drain(deadline_s=deadline)
                n = res[1].n_generated
                tries.append({"deadline_s": deadline, "wall_s": timed_wall,
                              "fault_kind": res[1].fault_kind, "n_generated": n})
                if res[1].fault_kind == "timeout" and n == 0:
                    lo = deadline
                elif res[1].fault_kind is None and n == 48:
                    hi = deadline
                else:
                    break
                deadline = (lo + hi) / 2
            report[loop]["watchdog"] = {
                "fault_free_wall_s": wall, "deadline_s": tries[-1]["deadline_s"],
                "wall_s": timed_wall,
                "fault_kind": [r.fault_kind for r in res],
                "n_generated": [r.n_generated for r in res],
                "tries": tries,
            }
            if res[1].fault_kind != "timeout" or not 1 <= n < 48:
                raise RuntimeError(f"batcher (d) {loop}: watchdog eviction wrong: "
                                   f"{report[loop]['watchdog']}")
            compare_ids(checks, f"(d) {loop}: deadline, rows 0 and 2",
                        generated(res), generated(clean), rows=(0, 2))
            compare_ids(checks, f"(d) {loop}: deadline, row 1's partial ids",
                        [generated(res)[1]], [generated(clean)[1][:n]])
            b.allocator.check_invariants()
    finally:
        spec.configure(enabled=prev[0])
        prefix_cache.configure(enabled=prev[1])
        interleave.configure(enabled=prev[2])
    return report


def phase_batcher(torch) -> dict:
    """The paged batcher's fault containment, per-request watchdog, legacy
    loop and KV tiers, at full width: tpu://random-8b (Llama-3-8B, bf16,
    random weights from seed 0) on a ``registry add-model --kv paged``
    entry, through ``critique`` (``cli.main`` in this process) and, where
    the CLI cannot say it, ``GpuEngine.chat`` and the engine's batcher.
    Four opponents on one ~4200-byte spec, whose prompt the engine trims
    to 4096 tokens (the largest bucket beside 32 new tokens in 8192: 64
    blocks of 64), greedy, 32 new tokens. Rounds are compared by the ids
    they generate (``recording_ids``), each check recorded and the phase
    failed at its end if any did not hold; any other failed gate raises
    at once:

    (a) host tier: ``--prefix-cache-pages 8 --kv-host-mb 1024`` — the
        shared prefix past 8 pages demotes to host RAM and each later
        opponent promotes it back: demoted_blocks, host_hits and
        promoted_tokens > 0, the allocator's and the tiers' invariants
        clean; B4 must launch. The demotion and promotion calls are timed
        on the card (``timing_tier_swaps``). Its ids must be those of the
        same round on a fresh batcher and of ``--no-kv-tier`` without the
        cap (each later opponent adopts the prefix from the pool and
        prefills the same last 64 tokens: the tier's exact twin). Every
        opponent's prompt is the same, so ``--no-kv-tier`` with the cap,
        where each later opponent recomputes the prefix in opponent 1's
        prefill chunks, must give opponent 1's ids to all four (a reused
        prefix prefills in other chunks than a recomputed one, and bf16
        rounds them apart). A round whose promotions land stale
        (``stale_promotions``) must change the ids;
    (b) disk tier: the round with ``--kv-store-dir`` (under build/), then
        the same round in a fresh process over the same store:
        rehydrated_blocks > 0 there, and every opponent's ids those of
        the writing round's opponent 2, which adopted the prefix that the
        fresh process's opponent 1 rehydrates;
    (c) int8 KV: (a) on a ``--kv-dtype int8`` entry: the demoted blocks
        carry the scale pages ``ks``/``vs``; the ids checked as in (a)
        against ``--no-kv-tier`` with and without the cap; B4-i8 must
        launch, and B3-i8 in a last round ``--no-speculative``;
    (d) faults and the watchdog in both loops (``batcher_faults``); B3
        must launch;
    (e) the legacy loop: (a) with ``--no-interleave`` exits 0 with the
        fused loop's ids.

    Prints one ``batcher round`` line per round, ``batcher tier swaps``
    (the timed demotion and promotion calls) for (a) and (c), the tiers'
    rates from ``perf.kv_tier`` (blocks × block bytes over swap_in_s /
    swap_out_s), each opponent's prefill seconds with the tier on and
    off, and ``batcher id checks``."""
    from adversarial_spec_tpu_torch.engine import dispatch
    from adversarial_spec_tpu_torch.models.config import get_config
    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    cfg = get_config("llama", "8b")
    block_bytes = cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim * 2 * 2
    launched = {k: 0 for k in pa.launches}
    checks: list = []
    report = {"phase": "batcher", "model": "tpu://random-8b (kv=paged)",
              "new_tokens": BATCHER_NEW_TOKENS, "block_bytes": block_bytes}
    common = ["--greedy", "--max-new-tokens", str(BATCHER_NEW_TOKENS), "--json"]
    tiered = ["--prefix-cache-pages", str(BATCHER_CAP_PAGES),
              "--kv-host-mb", str(BATCHER_HOST_MB)]
    B4, B3 = ("paged_decode_attention_mq",), ("paged_decode_attention",)
    t_phase = time.monotonic()

    def rnd(label, argv, spec_text, must):
        line, ids = batcher_round(torch, label, argv, spec_text, must, launched)
        emit({"phase": "batcher round", **{k: v for k, v in line.items()
                                          if k not in ("weights", "usage")}})
        return line, ids

    def drop_batcher():
        """The next round builds a new batcher, with new tiers and arena."""
        lm = dispatch.get_engine("tpu://random-8b")._models["random-8b"]
        lm.batcher = lm.batcher_key = None

    with cli_state():
        from adversarial_spec_tpu_torch.engine import registry

        tmp = str(registry.REGISTRY_PATH.parent)
        code, _, err = run_cli(["registry", "add-model", "random-8b", "--family", "llama",
                                "--size", "8b", "--kv", "paged"])
        if code != 0:
            raise RuntimeError(f"registry add-model failed: {err}")
        models = ",".join(["tpu://random-8b"] * 4)
        spec_text = spec_document(4200, 7)
        t = time.monotonic()
        code, out, err = run_cli(["critique", "--models", "tpu://random-8b",
                                  "--greedy", "--max-new-tokens", "4"], spec_text)
        if code != 0:
            raise RuntimeError(f"batcher warm-up exited {code}: {err[-2000:]}")
        report["load_and_warmup_s"] = time.monotonic() - t

        # (a) host tier, on and off.
        swaps: dict = {}
        with timing_tier_swaps(torch, block_bytes // PAGE, swaps):
            a_on, ids_a = rnd("(a) host tier on",
                              ["critique", "--models", models, *tiered, *common], spec_text, B4)
        engine = dispatch.get_engine("tpu://random-8b")
        b = engine._models["random-8b"].batcher
        b.allocator.check_invariants()
        b.tiers.check_invariants()
        del b
        kt = a_on["kv_tier"]
        if not (kt["demoted_blocks"] > 0 and kt["host_hits"] > 0 and kt["promoted_tokens"] > 0):
            raise RuntimeError(f"batcher (a): the host tier did not demote and promote: {kt}")
        emit({"phase": "batcher tier swaps", "part": "(a)", **swaps})
        drop_batcher()
        a_again, ids = rnd("(a) host tier on, fresh batcher",
                           ["critique", "--models", models, *tiered, *common], spec_text, B4)
        compare_ids(checks, "(a) host tier on, run again on a fresh batcher", ids, ids_a)
        drop_batcher()
        runs: list = []
        with stale_promotions(torch, PAGE, runs):
            a_bad, ids_bad = rnd("(a) host tier on, stale promotions planted",
                                 ["critique", "--models", models, *tiered, *common],
                                 spec_text, B4)
        drop_batcher()  # its pool and tiers hold the stale KV
        checks.append({"check": "(a) stale promotions planted change the ids",
                       "ok": bool(runs) and ids_bad != ids_a, "runs": runs,
                       "rows_changed": [i for i, (x, y) in enumerate(zip(ids_bad, ids_a))
                                        if x != y]})
        a_off, ids = rnd("(a) host tier off",
                         ["critique", "--models", models, "--no-kv-tier", *tiered, *common],
                         spec_text, B4)
        # Every opponent's prompt is the same, so each one recomputing its
        # prefix past the cap runs opponent 1's prefill chunks: its ids.
        compare_ids(checks, "(a) --no-kv-tier, prefix cache capped: every opponent "
                    "recomputes as opponent 1 prefilled", ids, [ids_a[0]] * len(ids))
        a_pool, ids = rnd("(a) host tier off, prefix cache uncapped",
                          ["critique", "--models", models, "--no-kv-tier", *common],
                          spec_text, B4)
        compare_ids(checks, "(a) --no-kv-tier, prefix cache uncapped: the prefix adopted",
                    ids, ids_a)
        reused: list = []
        compare_ids(reused, "", ids_a, [ids_a[0]] * len(ids_a))
        report["a"] = {"on": a_on, "again": a_again, "stale": a_bad, "off": a_off,
                       "off_uncapped": a_pool, "rates": tier_rates(a_on, block_bytes),
                       "swaps": swaps,
                       # Where a reused prefix's ids first leave a recomputed one's.
                       "reused_vs_recomputed_first_diff": reused[0]["first_diff"]}

        # (e) the legacy loop against the fused loop's ids.
        e_leg, ids = rnd("(e) legacy loop", ["critique", "--models", models, "--no-interleave",
                                             *tiered, *common], spec_text, B4)
        compare_ids(checks, "(e) the legacy loop against the fused loop", ids, ids_a)
        if engine._models["random-8b"].batcher.interleave is not False:
            raise RuntimeError("batcher (e): the batcher did not run the legacy loop")
        report["e"] = e_leg

        # (d) faults and the watchdog on the same engine, in both loops.
        report["d"] = batcher_faults(torch, engine, "random-8b", launched, checks)
        emit({"phase": "batcher faults", **report["d"]})

        # (b) the disk tier: write through, then a fresh process reads it.
        store = os.path.join(tmp, "kv-store")
        b_w, ids_w = rnd("(b) disk tier write", ["critique", "--models", models,
                                                 "--kv-store-dir", store, *common],
                         spec_text, B4)
        if b_w["kv_tier"]["store_writes"] == 0:
            raise RuntimeError(f"batcher (b): nothing written to the store: {b_w['kv_tier']}")
        compare_ids(checks, "(b) the writing round against (a)", ids_w, ids_a)
        dispatch.clear_engine_cache()
        del engine
        torch.cuda.empty_cache()
        ids_file = os.path.join(tmp, "fresh-ids.json")
        t = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-c", FRESH_ROUND, HERE, tmp, ids_file, "critique",
             "--models", models, "--kv-store-dir", store, *common],
            input=spec_text, capture_output=True, text=True, timeout=600,
        )
        fresh_wall = time.monotonic() - t
        if proc.returncode != 0:
            raise RuntimeError(f"batcher (b): fresh process exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        d_fresh = json.loads(proc.stdout)
        with open(ids_file) as f:
            ids = [row for call in json.load(f) for row in call]
        fresh = {"round": "(b) disk tier, fresh process", "process_wall_s": fresh_wall,
                 "round_wall_s": d_fresh["perf"]["spans"]["round"],
                 "kv_tier": d_fresh["perf"]["kv_tier"],
                 "prefill_s": [r["prefill_time_s"] for r in d_fresh["results"]],
                 "cached_tokens": sum(r["cached_tokens"] for r in d_fresh["results"])}
        emit({"phase": "batcher round", **fresh})
        if fresh["kv_tier"]["rehydrated_blocks"] == 0:
            raise RuntimeError(f"batcher (b): the fresh process rehydrated nothing: {fresh}")
        # Its opponent 1 rehydrates the prefix and prefills the rest, as the
        # writing round's later opponents did after adopting it: their ids.
        compare_ids(checks, "(b) the fresh process: every opponent as the writing round's "
                    "opponent 2", ids, [ids_w[1]] * len(ids))
        report["b"] = {"write": b_w, "fresh": fresh,
                       "write_rates": tier_rates(b_w, block_bytes),
                       "read_rates": tier_rates(fresh, block_bytes)}
    torch.cuda.empty_cache()

    # (c) the int8 KV cache.
    B4i, B3i = ("paged_decode_attention_mq_int8kv",), ("paged_decode_attention_int8kv",)
    kv8_block = block_bytes // 2 + cfg.n_layers * cfg.n_kv_heads * PAGE * 4 * 2
    with cli_state():
        code, _, err = run_cli(["registry", "add-model", "random-8b", "--family", "llama",
                                "--size", "8b", "--kv", "paged", "--kv-dtype", "int8"])
        if code != 0:
            raise RuntimeError(f"registry add-model failed: {err}")
        swaps8: dict = {}
        with timing_tier_swaps(torch, kv8_block // PAGE, swaps8):
            c_on, ids_c = rnd("(c) int8 KV, host tier on",
                              ["critique", "--models", models, *tiered, *common],
                              spec_text, B4i)
        emit({"phase": "batcher tier swaps", "part": "(c)", **swaps8})
        b = dispatch.get_engine("tpu://random-8b")._models["random-8b"].batcher
        b.tiers.check_invariants()
        b.allocator.check_invariants()
        keys = {tuple(sorted(blk.payload)) for blk in b.tiers.host._blocks.values()}
        if c_on["kv_tier"]["demoted_blocks"] == 0 or keys != {("k", "ks", "v", "vs")}:
            raise RuntimeError(f"batcher (c): demoted int8 blocks lack scales: {keys}")
        del b
        c_off, ids = rnd("(c) int8 KV, host tier off",
                         ["critique", "--models", models, "--no-kv-tier", *tiered, *common],
                         spec_text, B4i)
        compare_ids(checks, "(c) int8 KV, --no-kv-tier, prefix cache capped: every opponent "
                    "recomputes as opponent 1 prefilled", ids, [ids_c[0]] * len(ids))
        c_pool, ids = rnd("(c) int8 KV, host tier off, prefix cache uncapped",
                          ["critique", "--models", models, "--no-kv-tier", *common],
                          spec_text, B4i)
        compare_ids(checks, "(c) int8 KV, --no-kv-tier, prefix cache uncapped", ids, ids_c)
        c_b3, _ = rnd("(c) int8 KV, speculation off",
                      ["critique", "--models", models, "--no-speculative", *tiered, *common],
                      spec_text, B3i)
        report["c"] = {"on": c_on, "off": c_off, "off_uncapped": c_pool, "no_spec": c_b3,
                       "block_bytes": kv8_block, "rates": tier_rates(c_on, kv8_block),
                       "swaps": swaps8}
    dispatch.clear_engine_cache()
    torch.cuda.empty_cache()
    for k in ("paged_decode_attention", "paged_decode_attention_mq",
              "paged_decode_attention_int8kv", "paged_decode_attention_mq_int8kv"):
        if launched[k] == 0:
            raise RuntimeError(f"batcher: {k} never launched: {launched}")
    report["id_checks"] = checks
    emit({"phase": "batcher id checks", "checks": checks})
    failed = [c["check"] for c in checks if not c["ok"]]
    if failed:
        raise RuntimeError(f"batcher: generated ids differ: {failed}")
    report["launches"] = launched
    report["seconds"] = time.monotonic() - t_phase
    return report


# Phase pgen: the round-synchronous paged generate at full width.
PGEN_SEQ = 256  # the alias's context: 256 - 192 = 64 < 128, no bucketed prompt fits
PGEN_NEW_TOKENS = 192
PGEN_OPPONENTS = 4


@contextlib.contextmanager
def capturing_first_call(module, name: str, store: list):
    """While the block runs, keep copies of the arguments and the output
    of the first call of ``module.name`` (the kernel wrapper as the model
    calls it), so the call can be recomputed by its plain version."""
    import torch

    real = getattr(module, name)

    def copy(x):  # a tensor, or a mesh wrapper's [dp][tp] grid of them
        if isinstance(x, list):
            return [copy(y) for y in x]
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        if not store:
            store.append(([copy(a) for a in args],
                          {k: copy(v) for k, v in kwargs.items()}, copy(out)))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recording_generate_ids(calls: list):
    """While the block runs, append the ids each ``generate`` call of
    ``GpuEngine`` produced: one list per call, each row's ids."""
    from adversarial_spec_tpu_torch.engine import gpu

    real = gpu.generate

    def run(*args, **kwargs):
        result = real(*args, **kwargs)
        calls.append([[int(i) for i in result.tokens[r, : result.n_generated[r]]]
                      for r in range(len(result.n_generated))])
        return result

    gpu.generate = run
    try:
        yield
    finally:
        gpu.generate = real


def phase_pgen(torch) -> dict:
    """The round-synchronous ``generate(paged=True)``: a temporary
    registry entry random-8b with kv="paged" and max_seq_len=256, four
    opponents through ``critique`` at 192 new tokens (256 - 192 < 128: no
    bucketed prompt fits beside the budget, so no batcher), greedy. B3
    must launch and B4, B1 and B2 must not, and the engine must build no
    batcher; then the same with kv_dtype="int8" (B3-i8, no float kernel);
    then the dense alias at the same budget with ``--no-speculative``
    (B1), whose generated ids are compared row by row with the paged
    round's (printed, not gated: B1 and B3 reduce bf16 in other orders).
    The first B3 call of each paged round is recomputed by its plain
    version on the card."""
    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.models import transformer
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    spec = spec_document(3000, 0)
    models = ",".join(["tpu://random-8b"] * PGEN_OPPONENTS)
    report = {"phase": "pgen", "max_seq_len": PGEN_SEQ, "max_new_tokens": PGEN_NEW_TOKENS}
    checks: list = []
    every = ("paged_decode_attention", "paged_decode_attention_int8kv")
    parts = (
        ("paged", dict(kv="paged"), [], "paged_decode_attention"),
        ("paged int8 KV", dict(kv="paged", kv_dtype="int8"), [],
         "paged_decode_attention_int8kv"),
        ("dense", dict(kv="dense"), ["--no-speculative"], "decode_attention"),
    )
    ids: dict = {}
    launched_all = {k: 0 for k in every}
    for part, kw, extra, must in parts:
        with cli_state():
            registry.save_registry_entry(registry.ModelSpec(
                alias="random-8b", family="llama", size="8b", max_seq_len=PGEN_SEQ, **kw))
            engine = dispatch.get_engine("tpu://random-8b")
            t = time.monotonic()
            engine._load("random-8b")
            torch.cuda.synchronize()
            load_s = time.monotonic() - t
            first: list = []
            calls: list = []
            box: dict = {}
            with capturing_first_call(transformer, "paged_decode_attention", first), \
                    recording_generate_ids(calls):
                line = cli_round(
                    torch, f"pgen {part}",
                    ["critique", "--models", models, "--greedy", "--max-new-tokens",
                     str(PGEN_NEW_TOKENS), "--json", *extra],
                    spec, (must,), doc_out=box)
            launched = {k: v for k, v in {**da.launches, **pa.launches, **qm.launches}.items()
                        if v}
            stray = {k: v for k, v in launched.items() if k != must}
            if stray:
                raise RuntimeError(f"pgen {part}: kernels other than {must} launched: {stray}")
            if engine._models["random-8b"].batcher is not None:
                raise RuntimeError(f"pgen {part}: the engine built a batcher")
            del engine  # the next part's round must not find these weights resident
            if len(calls) != 1:
                raise RuntimeError(f"pgen {part}: {len(calls)} generate() calls, expected 1")
            ids[part] = calls[0]
            if part != "dense":
                (args, kwargs, got) = first[0]
                want = pa.paged_decode_attention_plain(*args, **kwargs)
                err = check_close(checks, f"pgen {part} first B3 call "
                                  f"{list(args[0].shape)} page {args[1].shape[2]} table "
                                  f"{list(args[3].shape)}", got, want, BF16_TOL)
                line["b3_first_call_max_abs_err"] = err
                launched_all[must] += launched[must]
            results = box["doc"]["results"]
            line.update(
                part=part, load_s=load_s,
                prefill_s=sum(r["prefill_time_s"] for r in results),
                decode_s=sum(r["decode_time_s"] for r in results),
                input_tokens=[r["input_tokens"] for r in results],
                all_launches=launched,
            )
            emit({"phase": "pgen round", **line})
            report[part] = line
        torch.cuda.empty_cache()
    report["rows_ids_equal_to_dense"] = sum(
        a == b for a, b in zip(ids["paged"], ids["dense"]))
    report["rows"] = len(ids["dense"])
    report["ids_tokens_generated"] = {p: [len(r) for r in v] for p, v in ids.items()}
    report["checks"] = checks
    report["launches"] = launched_all
    return report


# Phase serve: the daemon as a subprocess, driven through the port's client.
SERVE_NEW_TOKENS = 64
SERVE_OPPONENTS = 4
SERVE_DRAIN_DEADLINE_S = 300
# The daemon's process: the port's CLI ``serve`` (``cli.main``) with two
# signal hooks for this script: SIGUSR1 writes the kernels' launch
# counts since the last read (then zeroes them), the speculation switch
# and ``perf.weights`` to the file named second; SIGUSR2 flips the
# process's speculation switch (the wire protocol has no speculation
# field; the engine re-reads the switch at its next dispatch, as it does
# after a brownout retunes gamma). At exit the counts are written once
# more.
SERVE_BOOT = r"""
import json
import os
import signal
import sys
sys.path.insert(0, sys.argv[1])
from adversarial_spec_tpu_torch import cli
from adversarial_spec_tpu_torch.engine import spec, weightres
from adversarial_spec_tpu_torch.ops import decode_attention as da
from adversarial_spec_tpu_torch.ops import paged_attention as pa
from adversarial_spec_tpu_torch.ops import quant_matmul as qm
out, reads = sys.argv[2], [0]
def dump(*_):
    reads[0] += 1
    counts = {**da.launches, **pa.launches, **qm.launches}
    for mod in (da, pa, qm):
        mod.reset_launches()
    with open(out + ".tmp", "w") as f:
        json.dump({"read": reads[0], "launches": counts, "speculative": spec.config().enabled,
                   "weights": weightres.snapshot()}, f)
    os.replace(out + ".tmp", out)
def flip(*_):
    spec.configure(enabled=not spec.config().enabled)
signal.signal(signal.SIGUSR1, dump)
signal.signal(signal.SIGUSR2, flip)
code = cli.main(sys.argv[3:])
dump()
sys.exit(code)
"""


class DaemonProcess:
    """The serve daemon's subprocess and its launch-count file."""

    def __init__(self, proc, counts_path: str):
        self.proc, self.counts_path, self.reads = proc, counts_path, 0

    def read(self, timeout_s: float = 60.0) -> dict:
        """The launch counts since the last read (zeroing them), the
        speculation switch and ``perf.weights``, from the daemon."""
        import signal

        self.reads += 1
        os.kill(self.proc.pid, signal.SIGUSR1)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with contextlib.suppress(OSError, ValueError):
                with open(self.counts_path) as f:
                    got = json.load(f)
                if got["read"] == self.reads:
                    return got
            if self.proc.poll() is not None:
                raise RuntimeError(f"serve daemon exited {self.proc.returncode}")
            time.sleep(0.02)
        raise RuntimeError("serve daemon did not answer SIGUSR1")

    def flip_speculation(self) -> bool:
        import signal

        os.kill(self.proc.pid, signal.SIGUSR2)
        time.sleep(0.2)
        return self.read()["speculative"]


def debate_request(spec: str, tenant: str, tier: str, round_num: int = 1) -> dict:
    return {"op": "debate", "tenant": tenant, "tier": tier, "spec": spec,
            "models": ["tpu://random-8b"] * SERVE_OPPONENTS, "round": round_num,
            "max_new_tokens": SERVE_NEW_TOKENS, "greedy": True, "stream": True}


def debate_line(label: str, evs: list, launched: dict) -> dict:
    """One ``serve debate`` line from a debate's events."""
    res = evs[-1]
    if res.get("event") != "result" or res.get("error"):
        raise RuntimeError(f"serve {label}: no result: {res}")
    bad = [r["error"] for r in res["results"] if r["error"]]
    if bad:
        raise RuntimeError(f"serve {label}: opponents failed: {bad}")
    out_tokens = [r["output_tokens"] for r in res["results"]]
    return {
        "debate": label, "id": evs[0].get("debate"), "tenant": res["tenant"],
        "tier": res["tier"], "wall_s": res["wall_s"], "ttft_s": res["ttft_s"],
        "output_tokens": out_tokens,
        "tokens_per_sec": sum(out_tokens) / res["wall_s"] if res["wall_s"] else None,
        "cached_tokens": [r["cached_tokens"] for r in res["results"]],
        "streamed": sum(e["event"] == "stream" for e in evs),
        "preempted_units": res["serve"]["units_preempted"],
        "shed_debates": res["serve"]["shed_debates"],
        "launches": {k: v for k, v in launched.items() if v},
    }


def wait_running(client, n: int = 1, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while client.stats()["scheduler"]["running_units"] < n:
        if time.monotonic() > deadline:
            raise RuntimeError("serve: no unit started running")
        time.sleep(0.01)


def phase_serve(torch) -> dict:
    """The serve daemon: ``python -m adversarial_spec_tpu_torch.cli serve``
    as a subprocess (SERVE_BOOT: the CLI's ``main`` plus the launch-count
    hooks), its registry in a temporary HOME under build/ with random-8b
    on a ``registry add-model --kv paged`` entry that reads
    tests/torch_tokenizers/llama3/tokenizer.json (so a debate's text
    carries its ids), driven through the port's ``serve/client.py``;
    each debate four opponents on one ~3 KB spec, 64 new tokens, greedy.
    (a) one debate alone (speculation on, B4 must launch) must give the
    results (text and completion tokens per opponent) of the same round
    through ``critique --json`` in this process beforehand; its second
    round with speculation off must launch B3; ``perf.weights`` one load.
    (b) a batch-tier debate (its own spec), then two interactive debates
    of two tenants once it runs: all complete, at least one unit is
    preempted, each preempted unit's re-admission reports cached tokens,
    ``check`` answers ok, still one load; the texts differing from (a)'s
    are counted (not gated: the batch composition may change bf16
    reductions). (c) SIGTERM with one debate in flight: it finishes, the
    process exits 0 and its drain report counts it."""
    import signal

    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.serve.client import ServeClient

    spec_a = spec_document(3000, 0)
    spec_b = spec_document(3000, 1)
    tok_dir = os.path.join(HERE, "tests", "torch_tokenizers", "llama3")
    report: dict = {"phase": "serve", "model": "tpu://random-8b (kv=paged, llama3 tokenizer)",
                    "opponents": SERVE_OPPONENTS, "max_new_tokens": SERVE_NEW_TOKENS}
    launched_all = {k: 0 for k in FLOAT_ATTENTION}
    with cli_state():
        code, _, err = run_cli(["registry", "add-model", "random-8b", "--family", "llama",
                                "--size", "8b", "--kv", "paged", "--tokenizer", tok_dir])
        if code != 0:
            raise RuntimeError(f"registry add-model failed: {err}")
        box: dict = {}
        base = cli_round(
            torch, "serve baseline (critique --json)",
            ["critique", "--models", ",".join(["tpu://random-8b"] * SERVE_OPPONENTS),
             "--greedy", "--max-new-tokens", str(SERVE_NEW_TOKENS), "--json"],
            spec_a, ("paged_decode_attention_mq",), doc_out=box)
        emit({"phase": "cli round", "part": "serve baseline", **base})
        baseline = [(r["response"], r["output_tokens"]) for r in box["doc"]["results"]]
        reg_file = str(registry.REGISTRY_PATH)
        tmp = os.path.dirname(reg_file)
        # This process's engine and cached blocks go before the daemon
        # loads its own copy of the weights.
        dispatch.clear_engine_cache()
        torch.cuda.empty_cache()
        home = os.path.join(tmp, "home")
        os.makedirs(os.path.join(home, ".config", "adversarial-spec-tpu"))
        shutil.copy(reg_file, os.path.join(home, ".config", "adversarial-spec-tpu",
                                           "registry.json"))
        # Unix socket paths are limited to 107 bytes: the daemon and this
        # client both name it relative to the working directory.
        sock = os.path.relpath(os.path.join(tmp, "s.sock"))
        if len(sock) > 100:
            raise RuntimeError(f"socket path too long: {sock}")
        events = os.path.join(tmp, "events.jsonl")
        drain_file = os.path.join(tmp, "drain.json")
        counts = os.path.join(tmp, "launches.json")
        argv = [sys.executable, "-c", SERVE_BOOT, HERE, counts,
                "serve", "--socket", sock, "--events-out", events, "--drain-report",
                drain_file, "--flight-recorder-size", "200000", "--serve-ttft-slo-ms", "0",
                "--serve-drain-deadline-s", str(SERVE_DRAIN_DEADLINE_S)]
        env = {**os.environ, "HOME": home}
        out_path, err_path = os.path.join(tmp, "daemon.out"), os.path.join(tmp, "daemon.err")
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            proc = subprocess.Popen(argv, cwd=os.getcwd(), env=env, stdout=out_f,
                                    stderr=err_f)
        daemon = DaemonProcess(proc, counts)
        clients = []
        try:
            t = time.monotonic()
            while not os.path.exists(sock):
                if proc.poll() is not None or time.monotonic() - t > 300:
                    raise RuntimeError("serve daemon did not come up: "
                                       + open(err_path).read()[-2000:])
                time.sleep(0.05)
            report["startup_s"] = time.monotonic() - t
            c1 = ServeClient(sock, timeout_s=900)
            c2 = ServeClient(sock, timeout_s=900)
            clients += [c1, c2]
            daemon.read()  # zero the counts

            # (a) one debate alone, then its second round, speculation off.
            evs = c1.collect(c1.send(debate_request(spec_a, "solo", "interactive")), 900)
            got = daemon.read()
            a1 = debate_line("(a) round 1, speculation on", evs, got["launches"])
            texts_a = [r["response"] for r in evs[-1]["results"]]
            served = [(r["response"], r["output_tokens"]) for r in evs[-1]["results"]]
            a1["equal_to_cli"] = served == baseline
            a1["weights"] = got["weights"]
            emit({"phase": "serve debate", **a1})
            if served != baseline:
                raise RuntimeError("serve (a): results differ from the critique --json round")
            if not got["launches"]["paged_decode_attention_mq"]:
                raise RuntimeError("serve (a) round 1: B4 never launched")
            if daemon.flip_speculation():
                raise RuntimeError("serve: speculation did not switch off")
            evs = c1.collect(c1.send(debate_request(spec_a, "solo", "interactive", 2)), 900)
            got = daemon.read()
            a2 = debate_line("(a) round 2, speculation off", evs, got["launches"])
            a2["weights"] = got["weights"]
            emit({"phase": "serve debate", **a2})
            if not got["launches"]["paged_decode_attention"]:
                raise RuntimeError("serve (a) round 2: B3 never launched")
            if got["weights"]["loads"] != 1:
                raise RuntimeError(f"serve (a): {got['weights']['loads']} weight loads")
            if not daemon.flip_speculation():
                raise RuntimeError("serve: speculation did not switch back on")
            report["a"] = [a1, a2]

            # (b) three debates at once from two tenants.
            rid_batch = c1.send(debate_request(spec_b, "acme", "batch"))
            wait_running(c2)
            rid_i1 = c2.send(debate_request(spec_a, "acme", "interactive"))
            rid_i2 = c2.send(debate_request(spec_a, "zeta", "interactive"))
            b_evs = {"batch": c1.collect(rid_batch, 900), "interactive acme":
                     c2.collect(rid_i1, 900), "interactive zeta": c2.collect(rid_i2, 900)}
            got = daemon.read()
            stats = c2.stats()["serve"]
            check = c2.check()
            b_lines = [debate_line(f"(b) {k}", v, got["launches"]) for k, v in b_evs.items()]
            for line in b_lines:
                emit({"phase": "serve debate", **line})
            differ = sum(
                r["response"] != ta
                for k in ("interactive acme", "interactive zeta")
                for r, ta in zip(b_evs[k][-1]["results"], texts_a)
            )
            report["b"] = {"debates": b_lines, "texts_differing_from_a": differ,
                           "units_preempted": stats["units_preempted"],
                           "units_readmitted": stats["units_readmitted"],
                           "check": check, "weights": got["weights"],
                           "launches": got["launches"]}
            if stats["units_preempted"] < 1:
                raise RuntimeError("serve (b): no unit was preempted")
            if not check.get("ok") or check.get("checked") != 1:
                raise RuntimeError(f"serve (b): check failed: {check}")
            if got["weights"]["loads"] != 1:
                raise RuntimeError(f"serve (b): {got['weights']['loads']} weight loads")
            for k in FLOAT_ATTENTION:
                launched_all[k] += a1["launches"].get(k, 0) + a2["launches"].get(k, 0)
                launched_all[k] += got["launches"].get(k, 0)

            # (c) SIGTERM with one debate in flight.
            rid_c = c1.send(debate_request(spec_b, "zeta", "interactive"))
            wait_running(c2)
            t = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            c_evs = c1.collect(rid_c, SERVE_DRAIN_DEADLINE_S + 60)
            # The daemon exits once its connections close.
            for c in clients:
                c.close()
            rc = proc.wait(timeout=SERVE_DRAIN_DEADLINE_S + 60)
            drain_s = time.monotonic() - t
        finally:
            for c in clients:
                c.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        got = json.load(open(counts))  # the daemon's last write, at exit
        c_line = debate_line("(c) in flight at SIGTERM", c_evs, got["launches"])
        emit({"phase": "serve debate", **c_line})
        for k in FLOAT_ATTENTION:
            launched_all[k] += got["launches"].get(k, 0)
        if rc != 0:
            raise RuntimeError(f"serve (c): the daemon exited {rc}: "
                               + open(err_path).read()[-2000:])
        drain = json.loads(open(out_path).read().strip().splitlines()[-1])
        if json.load(open(drain_file)) != drain:
            raise RuntimeError("serve (c): the --drain-report file differs from stdout")
        serve_events = [e for e in map(json.loads, open(events)) if e.get("type") == "serve"]
        finished = {e["debate"] for e in serve_events
                    if e["op"] == "finished" and e["index"] == -1}
        n_debates = 6
        if (drain.get("reason") != "sigterm" or not drain.get("clean_exit")
                or drain["stats"]["completed_debates"] != n_debates
                or c_line["id"] not in finished):
            raise RuntimeError(f"serve (c): drain report does not count the debate: {drain}")
        # Each preempted unit's re-admission hit the prefix cache.
        results = {line["id"]: b_evs[k][-1]["results"]
                   for k, line in zip(b_evs, b_lines)}
        preempted = sorted({(e["debate"], e["index"]) for e in serve_events
                            if e["op"] == "preempted"})
        readmit = [results[d][i]["cached_tokens"] for d, i in preempted]
        report["b"]["preempted_units"] = [list(p) for p in preempted]
        report["b"]["readmitted_cached_tokens"] = readmit
        if not preempted or not all(readmit):
            raise RuntimeError(f"serve (b): preempted {preempted}, re-admissions cached "
                               f"{readmit}")
        report["c"] = c_line
        report["drain"] = {"seconds_from_sigterm": drain_s, "exit_code": rc,
                           "reason": drain["reason"], "clean_exit": drain["clean_exit"],
                           "uptime_s": drain["uptime_s"],
                           "drained_units_at_deadline": drain["drained_units_at_deadline"],
                           "completed_debates": drain["stats"]["completed_debates"],
                           "units_preempted": drain["stats"]["units_preempted"],
                           "shed_debates": drain["stats"]["shed_debates"]}
        emit({"phase": "serve drain", **report["drain"]})
    report["launches"] = launched_all
    return report


# Phase fleet: two replicas of random-8b behind the fleet router.
FLEET_NEW_TOKENS = 64
FLEET_OPPONENTS = 4
FLEET_KILL_AFTER = 2  # the serving worker dies after this many completions
FLEET_TIMEOUT_S = 300.0  # a worker's per-line deadline (its first line loads 16 GB)


def fleet_sessions(nodes: list, want: list, prefix: str) -> list:
    """Session ids ``<prefix>-<k>`` whose debates the hash ring over
    ``nodes`` places on each replica of ``want``, in that order (a
    session's id is its debate's affinity key)."""
    from adversarial_spec_tpu_torch.fleet.hashring import HashRing

    ring, found, k = HashRing(nodes), {}, 0
    while len(found) < len(want):
        sid = f"{prefix}-{k}"
        rid = ring.primary(sid)
        if rid in want:
            found.setdefault(rid, sid)
        k += 1
    return [found[r] for r in want]


def fleet_texts(doc: dict) -> list:
    return [(r["response"], r["output_tokens"]) for r in doc["results"]]


def fleet_line(line: dict, doc: dict) -> dict:
    """A fleet round's line: the ``cli_round`` line with the round's
    ``perf.fleet`` counters, TTFT (each row's prefill seconds in its
    batcher slot, what the batcher's TTFT histogram records) and
    tokens/s."""
    fleet = doc["perf"]["fleet"]
    results = doc["results"]
    wall = line["round_wall_s"]
    line.update(
        fleet={k: fleet[k] for k in (
            "routed_requests", "affinity_hits", "affinity_hit_rate", "failover_hops",
            "reissued_requests", "duplicated_completions", "replicas_retired",
            "handoff_attempts")},
        ttft_s=[r["prefill_time_s"] for r in results],
        output_tokens_per_s=sum(r["output_tokens"] for r in results) / wall if wall else None,
    )
    return line


def phase_fleet(torch) -> dict:
    """The fleet (``adversarial_spec_tpu_torch/fleet``) on one card: random-8b
    on a ``registry add-model --kv paged`` entry that reads
    tests/torch_tokenizers/llama3/tokenizer.json, four opponents on one
    ~3 KB spec, 64 new tokens, greedy, through ``critique`` in this process.
    First the single-engine baseline: round 1 (speculation on) and round 2
    (``--resume --no-speculative``) of one session. (a) ``--fleet
    --fleet-replicas 2`` (in-process replicas, a weight set each): two
    debates whose sessions the hash ring places on different replicas, then
    round 2 of the first; every opponent's text and token count equal to
    the baseline's round, round 2 an affinity hit with cached tokens, B4
    and B3 launched, the first call of each within tolerance of its plain
    version on the card. (c) Through the port's ``Autoscaler`` on (a)'s
    fleet: an idle tick scales in (the replica holding no active debate is
    drained and retired) and device memory falls by at least one weight
    set at once, with no garbage collection; a pressured tick scales out
    (spawn, warm, ring) and a debate the ring places on the new replica
    gives the baseline's texts. (b) ``--fleet-transport worker``: two
    ``python -m adversarial_spec_tpu_torch.fleet.worker`` processes sharing
    a KV store (``ADVSPEC_KV_TIER=1``, ``ADVSPEC_KV_STORE_DIR``), the
    serving one SIGKILLed after its second completion
    (``ADVSPEC_REPLICA_KILL_AFTER``): the round exits 0 with the baseline's
    texts, 0 duplicated completions, 2 reissued requests, the survivor
    rehydrating blocks from the store and answering ``check`` clean. One
    ``fleet round`` line per round, a ``fleet scale`` line and a ``fleet
    failover`` line."""
    from adversarial_spec_tpu_torch import fleet as fleet_mod
    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.engine.gpu import estimate_param_bytes
    from adversarial_spec_tpu_torch.fleet.autoscale import Autoscaler
    from adversarial_spec_tpu_torch.fleet.router import FleetEngine
    from adversarial_spec_tpu_torch.models import transformer
    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    spec = spec_document(3000, 0)
    tok_dir = os.path.join(HERE, "tests", "torch_tokenizers", "llama3")
    model = "tpu://random-8b"
    models = ",".join([model] * FLEET_OPPONENTS)
    common = ["--greedy", "--max-new-tokens", str(FLEET_NEW_TOKENS), "--json"]
    on_fleet = ["--fleet", "--fleet-replicas", "2"]
    b4, b3 = "paged_decode_attention_mq", "paged_decode_attention"
    report: dict = {"phase": "fleet", "model": f"{model} (kv=paged, llama3 tokenizer)",
                    "opponents": FLEET_OPPONENTS, "max_new_tokens": FLEET_NEW_TOKENS}
    checks: list = []
    launched = {b4: 0, b3: 0}

    def rnd(label, argv, stdin, must, want=None):
        box: dict = {}
        line = fleet_line(cli_round(torch, label, argv, stdin, must, doc_out=box), box["doc"])
        if want is not None:
            same = sum(a == b for a, b in zip(fleet_texts(box["doc"]), want))
            line["texts_equal_to_baseline"] = same
            if same != len(want):
                raise RuntimeError(f"{label}: {len(want) - same} opponents' texts differ "
                                   "from the single-engine round")
        emit({"phase": "fleet round", **line})
        return line, box["doc"]

    with cli_state():
        code, _, err = run_cli(["registry", "add-model", "random-8b", "--family", "llama",
                                "--size", "8b", "--kv", "paged", "--tokenizer", tok_dir])
        if code != 0:
            raise RuntimeError(f"registry add-model failed: {err}")
        weight_bytes = estimate_param_bytes(registry.resolve_model_spec(model))
        report["weight_bytes"] = weight_bytes
        # The single-engine baseline.
        base1, d = rnd("fleet baseline round 1 (one engine)",
                       ["critique", "--models", models, "--session", "fleet-base", *common],
                       spec, (b4,))
        want1 = fleet_texts(d)
        base2, d = rnd("fleet baseline round 2 (one engine)",
                       ["critique", "--resume", "fleet-base", "--no-speculative", *common],
                       "", (b3,))
        want2 = fleet_texts(d)
        report["baseline"] = [base1, base2]
        dispatch.clear_engine_cache()
        torch.cuda.synchronize()
        report["memory_allocated_before_fleet"] = torch.cuda.memory_allocated()

        # (a) two in-process replicas.
        s1, s2 = fleet_sessions(["r0", "r1"], ["r0", "r1"], "fleet")
        first4: list = []
        first3: list = []
        with capturing_first_call(transformer, b4, first4), \
                capturing_first_call(transformer, b3, first3):
            a1, _ = rnd(f"fleet (a) debate 1 ({s1} on r0) round 1",
                        ["critique", "--models", models, "--session", s1, *common, *on_fleet],
                        spec, (b4,), want1)
            a2, _ = rnd(f"fleet (a) debate 2 ({s2} on r1) round 1",
                        ["critique", "--models", models, "--session", s2, *common, *on_fleet],
                        spec, (b4,), want1)
            a3, _ = rnd(f"fleet (a) debate 1 round 2",
                        ["critique", "--resume", s1, "--no-speculative", *common, *on_fleet],
                        "", (b3,), want2)
        for name, store, plain in ((b4, first4, pa.paged_decode_attention_mq_plain),
                                   (b3, first3, pa.paged_decode_attention_plain)):
            (args, kwargs, got) = store.pop()
            err = check_close(checks, f"fleet first {name} call {list(args[0].shape)}",
                              got, plain(*args, **kwargs), BF16_TOL)
            report[f"{name}_first_call_max_abs_err"] = err
        del args, kwargs, got  # the copied page pools
        eng = fleet_mod.fleet_engine()
        served = {s["replica"]: sum(s["served"].values()) for s in eng.router.replica_stats()}
        if served != {"r0": 2 * FLEET_OPPONENTS, "r1": FLEET_OPPONENTS}:
            raise RuntimeError(f"fleet (a): replicas served {served}")
        if a3["fleet"]["affinity_hit_rate"] != 1.0 or a3["cached_tokens"] <= 0:
            raise RuntimeError(f"fleet (a) round 2: no affinity hit with cached tokens: {a3}")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        if resident < 2 * weight_bytes:
            raise RuntimeError(f"fleet (a): {resident} bytes resident, under two weight sets")
        report["a"] = {"rounds": [a1, a2, a3], "served": served,
                       "memory_allocated_bytes": resident,
                       "max_memory_allocated_bytes": max(
                           r["max_memory_allocated_bytes"] for r in (a1, a2, a3))}
        for r in (a1, a2, a3):
            for k in launched:
                launched[k] += r["launches"][k]

        # (c) scale-in, then scale-out, through the Autoscaler.
        fleet_mod.configure(scale_in_ticks=1, scale_out_ticks=1, scale_cooldown_s=0.0)
        snap = {"backlog_tokens": 0, "brownout": False, "draining": False,
                "active_keys": [s1], "model_mix": {}}
        scaler = Autoscaler(eng, pressure=lambda: dict(snap))
        try:
            t = time.monotonic()
            if not scaler.tick():
                raise RuntimeError("fleet (c): the idle tick did not scale in")
            torch.cuda.synchronize()
            scale_in_s = time.monotonic() - t
            after_in = torch.cuda.memory_allocated()
            if eng.router.alive_ids() != ["r0"]:
                raise RuntimeError(f"fleet (c): scale-in left {eng.router.alive_ids()}")
            if resident - after_in < weight_bytes:
                raise RuntimeError(f"fleet (c): scale-in freed {resident - after_in} bytes, "
                                   f"under one weight set ({weight_bytes})")
            snap.update(brownout=True, model_mix={model: FLEET_OPPONENTS})
            t = time.monotonic()
            if not scaler.tick():
                raise RuntimeError("fleet (c): the pressured tick did not scale out")
            scale_out_s = time.monotonic() - t
            scaled = {"scale_ins": fleet_mod.stats.scale_ins,
                      "scale_outs": fleet_mod.stats.scale_outs}
            (new,) = set(eng.router.alive_ids()) - {"r0"}
            (s3,) = fleet_sessions(["r0", new], [new], "fleet-new")
            c1, _ = rnd(f"fleet (c) debate on the new replica ({s3} on {new})",
                        ["critique", "--models", models, "--session", s3, *common, *on_fleet],
                        spec, (b4,), want1)
            for k in launched:
                launched[k] += c1["launches"][k]
            served_new = eng.router.replica(new).stats()["served"]
            if sum(served_new.values()) != FLEET_OPPONENTS:
                raise RuntimeError(f"fleet (c): the new replica served {served_new}")
        finally:
            scaler.shutdown()
        report["c"] = {"scale_in_s": scale_in_s, "freed_bytes": resident - after_in,
                       "memory_allocated_after_scale_in": after_in,
                       "scale_out_s": scale_out_s, "new_replica": new, "round": c1,
                       **scaled}
        emit({"phase": "fleet scale", **{k: v for k, v in report["c"].items() if k != "round"}})
        dispatch.clear_engine_cache()  # shuts the fleet down: both weight sets go
        torch.cuda.synchronize()
        report["memory_allocated_after_fleet"] = torch.cuda.memory_allocated()
        torch.cuda.empty_cache()

        # (b) two worker processes sharing a KV store; the serving one dies.
        tmp = os.path.dirname(str(registry.REGISTRY_PATH))
        home = os.path.join(tmp, "home")
        os.makedirs(os.path.join(home, ".config", "adversarial-spec-tpu"))
        shutil.copy(str(registry.REGISTRY_PATH),
                    os.path.join(home, ".config", "adversarial-spec-tpu", "registry.json"))
        (sb,) = fleet_sessions(["r0", "r1"], ["r0"], "fleet-kill")
        primary, survivor = "r0", "r1"
        env = {**os.environ, "HOME": home, "ADVSPEC_KV_TIER": "1",
               "ADVSPEC_KV_STORE_DIR": os.path.join(tmp, "kvstore"),
               "ADVSPEC_REPLICA_KILL_AFTER": f"{primary}:{FLEET_KILL_AFTER}"}
        fleet_mod.configure(enabled=True, replicas=2, transport="worker",
                            request_timeout_s=FLEET_TIMEOUT_S, prefill_replicas=0)
        t0 = time.monotonic()
        workers = FleetEngine(replicas=2, transport="worker",
                              request_timeout_s=FLEET_TIMEOUT_S, worker_env=env,
                              log_dir=os.path.join(tmp, "worker-logs"))
        fleet_mod.install_engine(workers)
        startup = {}

        def come_up(rid):  # process, imports, CUDA context: spawn to warm
            rep = workers.router.replica(rid)
            if not rep.ping() or rep.warm([model]) != 1:
                raise RuntimeError(f"fleet (b): worker {rid} did not come up")
            startup[rid] = time.monotonic() - t0

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(come_up, ("r0", "r1")))
        died: list = []
        on_fault = workers.router._on_replica_fault

        def record_fault(rid, exc):
            died.append((rid, time.monotonic()))
            on_fault(rid, exc)

        workers.router._on_replica_fault = record_fault
        b1, d = rnd(f"fleet (b) worker round ({sb} on {primary}, killed after "
                    f"{FLEET_KILL_AFTER})",
                    ["critique", "--models", models, "--session", sb, *common, *on_fleet,
                     "--fleet-transport", "worker"], spec, (), want1)
        t_end = time.monotonic()
        fl = d["perf"]["fleet"]
        surv = workers.router.replica(survivor).stats()
        problems = []
        try:
            workers.router.check_invariants()
        except Exception as e:  # the survivor's check op
            problems.append(str(e))
        failover = {
            "worker_startup_s": startup, "killed": [r for r, _ in died],
            "failover_wall_s": t_end - died[0][1] if died else None,
            "reissued_requests": fl["reissued_requests"],
            "duplicated_completions": fl["duplicated_completions"],
            "replicas_retired": fl["replicas_retired"],
            "alive": workers.router.alive_ids(), "survivor_served": surv["served"],
            "survivor_rehydrated_blocks": surv["kv_tier"]["rehydrated_blocks"],
            "survivor_check": problems or "ok",
        }
        emit({"phase": "fleet failover", **failover})
        bad = []
        if [r for r, _ in died] != [primary]:
            bad.append(f"expected {primary} to die, saw {died}")
        if fl["duplicated_completions"] != 0:
            bad.append(f"{fl['duplicated_completions']} duplicated completions")
        if fl["reissued_requests"] != FLEET_OPPONENTS - FLEET_KILL_AFTER:
            bad.append(f"{fl['reissued_requests']} reissued requests")
        if failover["alive"] != [survivor]:
            bad.append(f"alive after the kill: {failover['alive']}")
        if not failover["survivor_rehydrated_blocks"]:
            bad.append("the survivor rehydrated nothing from the store")
        if problems:
            bad.append(f"survivor invariants: {problems}")
        if bad:
            raise RuntimeError("fleet (b): " + "; ".join(bad))
        report["b"] = {"round": b1, **failover}
        dispatch.clear_engine_cache()  # the survivor gets its shutdown op
    torch.cuda.empty_cache()
    report["checks"] = checks
    report["launches"] = launched
    return report


def phase_agree(torch) -> dict:
    """Tiny f32 llama, full precision and quantized int8 and int4 from the
    same weights, and with an int8 KV cache beside full-precision and int4
    weights: greedy tokens on the card (kernels) and on the CPU (plain
    versions) must be identical, through generate() (speculation on: B2,
    or B2-i8, must launch), through the round-synchronous
    generate(paged=True) (B3, or B3-i8, must launch) and through the
    paged batcher with speculation on and off."""
    from adversarial_spec_tpu_torch.engine.generate import generate
    from adversarial_spec_tpu_torch.engine.loader import materialize_params
    from adversarial_spec_tpu_torch.engine.scheduler import (
        ContinuousBatcher,
        SchedRequest,
    )
    from adversarial_spec_tpu_torch.models.transformer import map_params
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    prompts = [[1] + [5 + (i * 7 + j) % 200 for j in range(60 + 25 * i)] for i in range(3)]
    base, cfg = materialize_params(
        "random", "llama", "tiny", dtype=torch.float32, device="cuda"
    )
    report = {"phase": "agree"}
    # (weights, KV cache): the report key and the kernels that must launch
    # (of each group, at least one). generate() runs with speculation on,
    # so its first decode step is a verify span: B2 (or B2-i8) must launch;
    # after that it decodes by spans or single steps, as its drafts allow.
    dense = (("decode_attention_mq",),)
    dense8 = (("decode_attention_mq_int8kv",),)
    paged8 = (("paged_decode_attention_int8kv", "paged_decode_attention_mq_int8kv"),)
    cases = (
        ("", "", None, dense),
        ("int8", "", "quant_int8", (("matmul_int8",), *dense)),
        ("int4", "", "quant_int4", (("matmul_int4",), *dense)),
        ("", "int8", "kv8", (*dense8, *paged8)),
        ("int4", "int8", "kv8_int4", (("matmul_int4",), *dense8, *paged8)),
    )
    for fmt, kv_dtype, key, must_launch in cases:
        params = base if not fmt else quant.quantize_params(map_params(torch.clone, base), fmt=fmt)
        on_cpu = map_params(lambda t: t.cpu(), params)  # the same weights on the CPU
        for mod in (da, pa, qm):
            mod.reset_launches()
        out = {
            dev: generate(
                p, cfg, prompts, max_new_tokens=48, eos_ids=[2], greedy=True,
                speculative=True, device=dev, kv_dtype=kv_dtype,
            ).tokens
            for dev, p in (("cuda", params), ("cpu", on_cpu))
        }
        name = f"tiny f32{' ' + fmt if fmt else ''}{' kv ' + kv_dtype if kv_dtype else ''}"
        same = bool((out["cuda"] == out["cpu"]).all())
        if not same:
            raise RuntimeError(f"{name} greedy tokens differ between card and CPU")
        # The round-synchronous generate(paged=True): B3 (or B3-i8) on the
        # card, the gather path on the CPU.
        b3 = "paged_decode_attention" + ("_int8kv" if kv_dtype else "")
        before = pa.launches[b3]
        pgen = {
            dev: generate(
                p, cfg, prompts, max_new_tokens=48, eos_ids=[2], greedy=True,
                paged=True, page_size=16, device=dev, kv_dtype=kv_dtype,
            ).tokens
            for dev, p in (("cuda", params), ("cpu", on_cpu))
        }
        pgen_same = bool((pgen["cuda"] == pgen["cpu"]).all())
        if not pgen_same:
            raise RuntimeError(f"{name} generate(paged=True) tokens differ between card and CPU")
        if pa.launches[b3] == before:
            raise RuntimeError(f"{name}: generate(paged=True) never launched {b3}")
        # The paged batcher (B3/B4 on the card, the gather path on the CPU):
        # 3 requests through 2 slots, prefix cache on, speculation on and off.
        # Speculation off runs on the card at pipeline depth 2 (the
        # default; B3 or B3-i8 must launch) and at depth 1.
        paged, walls = {}, {}
        for spec in (True, False):
            toks = {}
            runs = [("cuda", params, 2), ("cpu", on_cpu, 2)]
            if not spec:
                runs.insert(1, ("cuda depth 1", params, 1))
            for dev, p, pdepth in runs:
                b = ContinuousBatcher(
                    p, cfg, max_batch=2, page_size=16, capacity_tokens=2048,
                    max_new_cap=48, eos_ids=[2], speculative=spec, kv_dtype=kv_dtype,
                    pipeline_depth=pdepth,
                )
                for i, pr in enumerate(prompts):
                    b.submit(SchedRequest(req_id=i, prompt_ids=pr, max_new_tokens=40))
                before = pa.launches[b3]
                t = time.monotonic()
                toks[dev] = [r.tokens.tolist() for r in b.run_all()]
                if dev != "cpu" and not spec:
                    torch.cuda.synchronize()
                    walls[f"spec_off_depth_{pdepth}_s"] = time.monotonic() - t
                    walls[f"spec_off_depth_{pdepth}_fetches"] = b.fetch_counts
                if dev == "cuda" and not spec and pa.launches[b3] == before:
                    raise RuntimeError(f"{name}: the batcher at depth 2 never launched {b3}")
                b.allocator.check_invariants()
            for dev in toks:
                if dev != "cpu":
                    run_name = "spec_on" if spec else "spec_off" + dev[4:].replace(" ", "_")
                    paged[run_name] = toks[dev] == toks["cpu"]
            if any(t != toks["cpu"] for t in toks.values()):
                raise RuntimeError(
                    f"{name} paged batcher tokens differ between card and CPU "
                    f"(speculation {'on' if spec else 'off'}): {paged}"
                )
        launched = {**da.launches, **pa.launches, **qm.launches}
        missing = [g for g in must_launch if not sum(launched[k] for k in g)]
        if missing:
            raise RuntimeError(f"{name}: none of {missing} launched on the card")
        if kv_dtype:
            leaked = {k: launched[k] for k in FLOAT_ATTENTION if launched[k]}
            if leaked:
                raise RuntimeError(f"{name}: float-cache kernels ran on an int8 cache: {leaked}")
        entry = {"identical_tokens": same, "shape": list(out["cuda"].shape),
                 "paged_identical_tokens": paged, "pgen_identical_tokens": pgen_same,
                 "paged_walls": {**walls, "card": card()},
                 "launches": {k: v for k, v in launched.items() if v}}
        if key:
            report[key] = entry
        else:
            report.update(entry)
    report["mesh"] = agree_on_meshes(torch, base, cfg, prompts)
    return report


def agree_on_meshes(torch, base, cfg, prompts) -> dict:
    """The tiny f32 llama on virtual {"tp": 2}, {"dp": 2} and {"dp": 2,
    "tp": 2} meshes, every shard on the card and then every shard on the
    CPU: greedy tokens of generate(mesh=...) identical, dense (speculation
    on: B2 a shard) and paged (W3 on tp=2, W2 on dp=2 and on dp=2 × tp=2:
    every mesh runs the one sharded program); and on the sp meshes
    {"sp": 2} and {"sp": 2, "tp": 2} dense (B2), {"dp": 2, "sp": 2} paged
    (W2) and {"sp": 2} paged with an int8 KV cache (W3, B3-i8), the ring
    carrying each prefill."""
    from adversarial_spec_tpu_torch.engine.generate import generate
    from adversarial_spec_tpu_torch.models.transformer import map_params
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.parallel import sp as sp_mod
    from adversarial_spec_tpu_torch.parallel.mesh import make_mesh
    from adversarial_spec_tpu_torch.parallel.sharding import shard_params

    on_cpu = map_params(lambda t: t.cpu(), base)
    out = {}
    cases = [(spec, paged, kernel, "") for spec, kernel in (
        ({"tp": 2}, "paged_decode_attention_tp"),
        ({"dp": 2}, "paged_decode_attention_dp_tp"),
        ({"dp": 2, "tp": 2}, "paged_decode_attention_dp_tp"),
    ) for paged in (False, True)] + [
        # The sp meshes: the ring prefill, then the dp×tp decode.
        ({"sp": 2}, False, None, ""),
        ({"sp": 2, "tp": 2}, False, None, ""),
        ({"dp": 2, "sp": 2}, True, "paged_decode_attention_dp_tp", ""),
        ({"sp": 2}, True, "paged_decode_attention_tp", "int8"),
    ]
    for spec, paged, paged_kernel, kv_dtype in cases:
        n = mesh_size(spec)
        for mod in (da, pa):
            mod.reset_launches()
        toks = {}
        for dev, p in (("cuda", base), ("cpu", on_cpu)):
            sp_mod.reset_counts()
            mesh = make_mesh(spec, [dev] * n)
            toks[dev] = generate(
                shard_params(mesh, p), cfg, prompts, max_new_tokens=48, eos_ids=[2],
                greedy=True, speculative=not paged, paged=paged, page_size=16, mesh=mesh,
                kv_dtype=kv_dtype,
            ).tokens
            if "sp" in spec and sp_mod.counts["prefills"] != 1:
                raise RuntimeError(f"tiny f32 on {spec}: the ring did not prefill on {dev}")
        label = (f"{json.dumps(spec)} {'paged' if paged else 'dense'}"
                 f"{' kv ' + kv_dtype if kv_dtype else ''}")
        if not bool((toks["cuda"] == toks["cpu"]).all()):
            raise RuntimeError(f"tiny f32 on {label}: tokens differ between card and CPU")
        launched, served = mesh_counts(da, pa)
        # Decode runs on the sp-rank-0 shards: n / sp of them.
        shards = n // spec.get("sp", 1)
        need = paged_kernel + ("_int8kv" if kv_dtype else "") if paged else "decode_attention_mq"
        if served[need] < shards:
            raise RuntimeError(f"tiny f32 on {label}: {need} served {served[need]} "
                               f"shards, fewer than {shards}")
        out[label] = {"identical_tokens": True, "shape": list(toks["cuda"].shape),
                      "launches": {k: v for k, v in launched.items() if v}}
    return out


# -- the multi-device mesh: W1-W3 and phase mesh ---------------------------------

# W1 at Llama-3-70B's decode on its {"tp": 8} mesh (one KV head and its
# eight query heads a shard); W3 and W2 at Llama-3-8B's paged decode on
# {"tp": 2} and {"dp": 2, "tp": 2} (generate(paged=True)'s 128-slot pages,
# 33 a row for T_CACHE slots).
MESH_HQ70, MESH_HKV70 = 64, 8
MESH_PAGE, MESH_PAGES_ROW = 128, -(-T_CACHE // 128)


def phase_mesh_kernels(torch, da, pa) -> tuple[dict, list]:
    """W1, W2 and W3 on a virtual mesh (every shard on cuda:0) at the
    shapes phase mesh gives them: one launch of the sharded entry for all
    the shards, each held against its plain version (B1's / B3's plain
    version on each shard's own operands) within the bf16 tolerance,
    float and int8 K/V: left pads, a single-slot and an empty window, and
    for W2 a NaN-poisoned trash page in each dp slice (int8: -128 beside
    NaN scales) and the global trash id inside a window. Timed as B1/B3
    are (all shards of one call, CUDA graph replay, cold L2), beside the
    plain version, SDPA over the same windows on the unsharded tensors and
    the bound: the sum of the shards' bytes (each shard reads its heads'
    windows, its table and bounds); ``launches_per_call`` is the sharded
    entry's launches in one call (``mesh_launches``), which must be 1,
    ``shards_per_call`` the shards they served (``mesh_shards``)."""
    from adversarial_spec_tpu_torch.engine.kvcache import slice_page_tables
    from adversarial_spec_tpu_torch.ops.kv_inputs import int8_kv
    from adversarial_spec_tpu_torch.parallel.mesh import DP, TP, make_mesh
    from adversarial_spec_tpu_torch.parallel.sharding import gather, split

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    results, checks = {}, []
    elem = 2
    bnd = B1_BOUNDS
    bounds = torch.tensor(bnd, dtype=torch.int32, device=dev)
    valid = sum(max(hi - lo, 0) for lo, hi in bnd)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def per_call(mod, name, call, mesh) -> dict:
        """One eager call's launches of the sharded entry and the shards
        they served: one launch for every shard of the virtual mesh."""
        mod.reset_launches()
        call()
        got = {"launches_per_call": mod.mesh_launches[name],
               "shards_per_call": mod.mesh_shards[name]}
        if got != {"launches_per_call": 1, "shards_per_call": mesh.size}:
            raise AssertionError(f"{name}: one call on {dict(mesh.shape)} made {got}, not one "
                                 f"launch serving its {mesh.size} shards")
        return got

    # ---- W1: 70B on {"tp": 8} ----
    mesh = make_mesh({"tp": 8}, [dev] * 8)
    kv_spec, q_spec = (DP, TP, None, None), (DP, TP, None)
    q = draw((B, MESH_HQ70, D))
    rot = [(draw((B, MESH_HKV70, T_CACHE, D)), draw((B, MESH_HKV70, T_CACHE, D)))
           for _ in range(N_ROTATE)]
    gq, gb = split(q, mesh, q_spec), split(bounds, mesh, (DP,))
    grot = [(split(k, mesh, kv_spec), split(v, mesh, kv_spec)) for k, v in rot]
    gkv = lambda i: grot[i % N_ROTATE]  # noqa: E731
    got = gather(da.decode_attention_tp(gq, *gkv(0), gb, mesh), mesh, q_spec)
    want = gather(da.decode_attention_tp_plain(gq, *gkv(0), gb, mesh), mesh, q_spec)
    err = check_close(checks, "W1 bf16 tp=8 windows", got, want, BF16_TOL, empty_row=3)
    for cap in (50.0,):
        got = gather(da.decode_attention_tp(gq, *gkv(1), gb, mesh, attn_softcap=cap), mesh, q_spec)
        want = gather(da.decode_attention_tp_plain(gq, *gkv(1), gb, mesh, attn_softcap=cap),
                      mesh, q_spec)
        check_close(checks, f"W1 bf16 tp=8 softcap={cap}", got, want, BF16_TOL, empty_row=3)
    (k8, ks8), (v8, vs8) = int8_kv(rot[2][0]), int8_kv(rot[2][1])
    g8 = [split(x, mesh, kv_spec) for x in (k8, v8)]
    gs8 = {n: split(x, mesh, kv_spec) for n, x in (("k_scale", ks8), ("v_scale", vs8))}
    got = gather(da.decode_attention_tp(gq, *g8, gb, mesh, attn_softcap=30.0, **gs8), mesh, q_spec)
    want = gather(da.decode_attention_tp_plain(gq, *g8, gb, mesh, attn_softcap=30.0, **gs8),
                  mesh, q_spec)
    check_close(checks, "W1 bf16 int8 KV tp=8 softcap=30", got, want, BF16_TOL, empty_row=3)
    del k8, v8, ks8, vs8, g8, gs8
    mask1 = torch.zeros((B, 1, 1, T_CACHE), dtype=torch.bool, device=dev)
    for r, (lo, hi) in enumerate(bnd):
        mask1[r, :, :, lo:hi] = True
    tp = mesh.shape[TP]
    results["decode_attention_tp"] = {
        **timed(lambda i: da.decode_attention_tp(gq, *gkv(i), gb, mesh), 50, torch),
        "plain_ms": cuda_ms(lambda i: da.decode_attention_tp_plain(gq, *gkv(i), gb, mesh),
                            8, torch),
        "library_ms": graph_ms(lambda i: sdpa(q[:, :, None], *rot[i % N_ROTATE], mask1),
                               20, torch),
        "bytes": window_bytes([[lo] for lo, _ in bnd], [[hi] for _, hi in bnd], T_CACHE,
                              2 * MESH_HKV70 * D * elem)
        + 2 * q.numel() * elem + tp * bounds.numel() * 4,
        "ops": 4 * MESH_HQ70 * D * valid,
        "max_abs_err": err,
        "mesh": dict(mesh.shape),
        "shard": {"rows": B, "q_heads": MESH_HQ70 // tp, "kv_heads": MESH_HKV70 // tp},
        **per_call(da, "decode_attention_tp",
                   lambda: da.decode_attention_tp(gq, *gkv(0), gb, mesh), mesh),
        # B1 itself on the unsharded tensors (8 query heads a KV head, as
        # each shard has), and W1 with its split count forced.
        "b1_unsharded_ms": graph_ms(lambda i: da.decode_attention(q, *rot[i % N_ROTATE], bounds),
                                    50, torch),
        "split_sweep": split_sweep(torch, lambda i: da.decode_attention_tp(gq, *gkv(i), gb, mesh),
                                   -(-T_CACHE // 32), (4, 6, 8, 9, 12, 16, 24)),
    }
    del rot, grot

    # ---- W3 ({"tp": 2}) and W2 ({"dp": 2, "tp": 2}): 8B's paged decode ----
    for name, spec, wrap, plain in (
        ("paged_decode_attention_tp", {"tp": 2}, pa.paged_decode_attention_tp,
         pa.paged_decode_attention_tp_plain),
        ("paged_decode_attention_dp_tp", {"dp": 2, "tp": 2}, pa.paged_decode_attention_dp_tp,
         pa.paged_decode_attention_dp_tp_plain),
    ):
        mesh = make_mesh(spec, [dev] * mesh_size(spec))
        dp, tp = mesh.shape[DP], mesh.shape[TP]
        _, table_np, lp = slice_page_tables(B, dp, MESH_PAGES_ROW)
        table_np = table_np.copy()
        table_np[0, 3] = 0  # the global trash id inside row 0's window
        n_pages = dp * lp
        table = torch.as_tensor(table_np, dtype=torch.int32, device=dev)
        page_spec = (DP, TP, None, None) if dp > 1 else (None, TP, None, None)
        row_spec = (DP,) if dp > 1 else ()
        q_sp = (DP, TP, None) if dp > 1 else (None, TP, None)

        def pool():
            p = draw((n_pages, HKV, MESH_PAGE, D))
            p[torch.arange(dp, device=dev) * lp] = float("nan")  # each slice's trash page
            return p

        rot = [(pool(), pool()) for _ in range(N_ROTATE)]
        q = draw((B, HQ, D))
        gq = split(q, mesh, q_sp)
        gt, gb = split(table, mesh, row_spec), split(bounds, mesh, row_spec)
        grot = [(split(k, mesh, page_spec), split(v, mesh, page_spec)) for k, v in rot]
        gkv = lambda i: grot[i % N_ROTATE]  # noqa: E731
        got = gather(wrap(gq, *gkv(0), gt, gb, mesh), mesh, q_sp)
        want = gather(plain(gq, *gkv(0), gt, gb, mesh), mesh, q_sp)
        label = "W2" if dp > 1 else "W3"
        err = check_close(checks, f"{label} bf16 {spec}", got, want, BF16_TOL, empty_row=3)

        def int8_pool(p):  # the pool's int8 form, each slice's trash page poisoned
            x8, sc = int8_kv(p.nan_to_num())
            trash = torch.arange(dp, device=dev) * lp
            x8[trash] = -128
            sc[trash] = float("nan")
            return x8, sc

        (k8, ks8), (v8, vs8) = int8_pool(rot[1][0]), int8_pool(rot[1][1])
        g8 = [split(x, mesh, page_spec) for x in (k8, v8)]
        gs8 = {n: split(x, mesh, page_spec) for n, x in (("k_scale", ks8), ("v_scale", vs8))}
        got = gather(wrap(gq, *g8, gt, gb, mesh, attn_softcap=30.0, **gs8), mesh, q_sp)
        want = gather(plain(gq, *g8, gt, gb, mesh, attn_softcap=30.0, **gs8), mesh, q_sp)
        check_close(checks, f"{label} bf16 int8 KV {spec} softcap=30", got, want, BF16_TOL,
                    empty_row=3)
        del k8, v8, ks8, vs8, g8, gs8

        def dense(pages):  # untimed gather for the SDPA yardstick
            g = pages[table.clamp(min=0).long()]  # [B, P, Hkv, page, D]
            return g.transpose(1, 2).reshape(B, HKV, -1, D)

        rot_dense = [(dense(k), dense(v)) for k, v in rot]
        slots = MESH_PAGES_ROW * MESH_PAGE
        mask = torch.zeros((B, 1, 1, slots), dtype=torch.bool, device=dev)
        for r, (lo, hi) in enumerate(bnd):
            mask[r, :, :, lo:hi] = True
        mapped = torch.repeat_interleave(table > 0, MESH_PAGE, dim=1)[:, None, None, :]
        mask &= mapped
        read = sum(max(min(hi, slots) - lo, 0) for lo, hi in bnd)
        results[name] = {
            **timed(lambda i: wrap(gq, *gkv(i), gt, gb, mesh), 50, torch),
            "plain_ms": cuda_ms(lambda i: plain(gq, *gkv(i), gt, gb, mesh), 8, torch),
            "library_ms": graph_ms(
                lambda i: sdpa(q[:, :, None], *rot_dense[i % N_ROTATE], mask), 20, torch
            ),
            "bytes": read * 2 * HKV * D * elem + 2 * q.numel() * elem
            + tp * (table.numel() + bounds.numel()) * 4,
            "ops": 4 * HQ * D * valid,
            "max_abs_err": err,
            "mesh": dict(mesh.shape),
            "shard": {"rows": B // dp, "q_heads": HQ // tp, "kv_heads": HKV // tp,
                      "pages": lp},
            **per_call(pa, name, lambda: wrap(gq, *gkv(0), gt, gb, mesh), mesh),
        }
        del rot, grot, rot_dense
    finish_bounds(results)
    torch.cuda.synchronize()
    return results, checks


def mesh_size(spec: dict) -> int:
    n = 1
    for v in spec.values():
        n *= v
    return n


def summed(rounds: list) -> tuple[dict, dict]:
    """The rounds' ``launches`` and ``shards`` summed by name."""
    out: tuple[dict, dict] = ({}, {})
    for r in rounds:
        for total, key in zip(out, ("launches", "shards")):
            for k, n in r[key].items():
                total[k] = total.get(k, 0) + n
    return out


def mesh_counts(da, pa) -> tuple[dict, dict]:
    """The counters since the last reset: every entry's launches (B1-B4's
    own, and the sharded entries' in ``mesh_launches``), and the shards
    served (a sharded launch serves many, any other launch its one)."""
    launched = {**da.launches, **pa.launches, **da.mesh_launches, **pa.mesh_launches}
    served = {**da.launches, **pa.launches, **da.mesh_shards, **pa.mesh_shards}
    return launched, served


def mesh_steps(da, pa, mesh, n_layers: int, label: str) -> dict:
    """Each mesh wrapper's (and K/V type's) S=1 decode calls since the
    last reset and its sharded entry's launches a decode step. A call
    serves every decode shard (the sp-rank-0 shards of ``device_groups``)
    with one launch for each device group (a run of ``MAX_SHARDS`` at
    most), and every decode step calls it once a layer: on a virtual mesh,
    one launch a layer a step. Raises unless the counts are exactly so."""
    from adversarial_spec_tpu_torch.parallel.mesh import device_groups

    groups = [g for _, g in device_groups(mesh)]
    shards = sum(len(g) for g in groups)
    per_call = sum(-(-len(g) // da.MAX_SHARDS) for g in groups)
    out = {}
    for mod in (da, pa):
        for name, served in mod.mesh_shards.items():
            launched = mod.mesh_launches[name]
            calls, rest = divmod(served, shards)
            if rest or calls % n_layers or launched != calls * per_call:
                raise RuntimeError(
                    f"mesh {label}: {name} made {launched} launches serving {served} shards; "
                    f"each call serves {shards} shards in {per_call} launches, once a layer "
                    f"({n_layers}) a step")
            if served:
                out[name] = {"decode_steps": calls // n_layers, "launches": launched,
                             "launches_per_decode_step": launched // (calls // n_layers),
                             "shards_served": served}
    return out


def mesh_round(torch, engine, reqs, sp, label: str, must_launch: tuple) -> dict:
    """One chat() round on a mesh alias: every counter zeroed just before
    and read just after; each name of ``must_launch`` must have served
    every shard at least once (``mesh_counts``), and each wrapper's
    launches must be one a device group a layer a decode step
    (``mesh_steps``)."""
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.parallel import collectives

    for mod in (da, pa):
        mod.reset_launches()
    collectives.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    comps = engine.chat(reqs, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    bad = [c.error for c in comps if not c.ok]
    if bad:
        raise RuntimeError(f"mesh {label}: chat failed: {bad}")
    launched, served = mesh_counts(da, pa)
    lm = next(iter(engine._models.values()))
    shards = lm.mesh.size
    short = {k: served[k] for k in must_launch if served[k] < shards}
    if short:
        raise RuntimeError(f"mesh {label}: fewer shards served than shards ({shards}): {short}")
    per_step = mesh_steps(da, pa, lm.mesh, lm.cfg.n_layers, label)
    decode_s = sum(c.usage.decode_time_s for c in comps)
    out_tok = sum(c.usage.output_tokens for c in comps)
    line = {
        "round": label,
        "mesh": dict(lm.mesh.shape),
        "devices": sorted({str(d) for d in lm.mesh.devices.flat}),
        "virtual": not lm.mesh.distinct,
        "collectives": dict(collectives.counts),
        "chat_wall_s": wall,
        "prefill_s": sum(c.usage.prefill_time_s for c in comps),
        "decode_s": decode_s,
        "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
        "output_tokens": [c.usage.output_tokens for c in comps],
        "weight_bytes_per_chip": lm.bytes_per_chip,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k: v for k, v in launched.items() if v},
        "shards": {k: v for k, v in {**da.mesh_shards, **pa.mesh_shards}.items() if v},
        "attention_per_decode_step": per_step,
    }
    emit({"phase": "mesh round", **line})
    return line


def held_first_call(torch, store: list, plain, name: str, checks: list) -> float:
    """The first captured call of a mesh wrapper recomputed by its plain
    version on the same inputs, within the bf16 tolerance."""
    from adversarial_spec_tpu_torch.parallel.mesh import Mesh
    from adversarial_spec_tpu_torch.parallel.sharding import gather

    if not store:
        raise RuntimeError(f"{name}: never called on the main path")
    args, kwargs, out = store[0]
    mesh = next(a for a in args if isinstance(a, Mesh))
    spec = ("dp", "tp", None)
    got = gather(out, mesh, spec)
    want = gather(plain(*args, **kwargs), mesh, spec)
    return check_close(checks, f"{name} first call on the main path", got, want, BF16_TOL)


def phase_mesh(torch) -> dict:
    """The multi-device mesh from the user's entry point, on a virtual
    mesh (every shard on cuda:0; ``GpuEngine(devices=[cuda:0] * n)``):
    (a) tpu://random-70b on its own {"tp": 8} mesh at full width with 8
    of its 80 layers, dense, four opponents, a ~3 KB spec, 64 new tokens,
    greedy — round 1 speculation on (B2 on every shard, W1 in its tail),
    round 2 off (W1 every step); (b) random-8b at full width and depth:
    dense on {"dp": 2} (the sharded program: B2 a shard, W1 in the
    tail), paged on {"tp": 2}
    (W3) and paged on {"dp": 2, "tp": 2} (W2). Each wrapper's first call
    is recomputed by its plain version; (b)'s {"tp": 2} round's first
    logits are held to a single-device run's on the same prompts; each
    engine is dropped before the next and device memory must fall back.
    Where the machine has two cards, (b)'s {"tp": 2} round runs through
    ``critique`` over cuda:0 and cuda:1 (NCCL); with one, the line says
    so."""
    import gc

    from adversarial_spec_tpu_torch.engine import gpu as gpu_mod
    from adversarial_spec_tpu_torch.engine import registry
    from adversarial_spec_tpu_torch.engine import spec as spec_mod
    from adversarial_spec_tpu_torch.engine.generate import generate
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.loader import materialize_params
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.models import transformer
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    report = {"phase": "mesh", "cards": torch.cuda.device_count(), "rounds": [], "checks": []}
    checks = report["checks"]
    doc = spec_document(3000, 14) + "\n\nCritique this spec."
    sp = SamplingParams(max_new_tokens=64, greedy=True, seed=0)
    base_mem = torch.cuda.memory_allocated()

    def reqs(alias):
        return [ChatRequest(f"tpu://{alias}", p, doc) for p in PERSONAS[:4]]

    def dropped(engine, label):
        """Drop the engine's models (the caller drops the engine)."""
        engine._models.clear()
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base_mem
        report.setdefault("memory_after_drop", {})[label] = left
        if left > (256 << 20):
            raise RuntimeError(f"mesh {label}: {left} bytes still allocated after the drop")

    # (a) 70B on {"tp": 8}, 8 of its 80 layers.
    with depth(8, ("llama", "70b")):
        engine = GpuEngine(devices=[dev] * 8)
        first: list = []
        spec_mod.configure(enabled=True)
        with capturing_first_call(transformer, "decode_attention_tp", first):
            report["rounds"].append(mesh_round(
                torch, engine, reqs("random-70b"), sp, "70b tp=8 speculation on",
                ("decode_attention_mq",)))
        spec_mod.configure(enabled=False)
        try:
            report["rounds"].append(mesh_round(
                torch, engine, reqs("random-70b"), sp, "70b tp=8 speculation off",
                ("decode_attention_tp",)))
        finally:
            spec_mod.configure(enabled=True)
        report["w1_first_call_err"] = held_first_call(
            torch, first, da.decode_attention_tp_plain, "W1", checks)
        first.clear()
        dropped(engine, "70b tp=8")

    # (b) 8B at full width and depth.
    specs = (
        registry.ModelSpec(alias="mesh-dp2", family="llama", size="8b", mesh={"dp": 2}),
        registry.ModelSpec(alias="mesh-tp2-paged", family="llama", size="8b",
                           mesh={"tp": 2}, kv="paged"),
        registry.ModelSpec(alias="mesh-dp2tp2-paged", family="llama", size="8b",
                           mesh={"dp": 2, "tp": 2}, kv="paged"),
    )
    with temp_registry(*specs):
        engine = GpuEngine(devices=[dev] * 2)
        report["rounds"].append(mesh_round(
            torch, engine, reqs("mesh-dp2"), sp, "8b dp=2 dense",
            ("decode_attention_mq", "decode_attention_tp")))
        dropped(engine, "8b dp=2")

        engine = GpuEngine(devices=[dev] * 2)
        first, calls = [], []
        real = gpu_mod.generate

        def recording(*args, **kwargs):
            calls.append((args[2], {k: v for k, v in kwargs.items() if k != "mesh"}))
            return real(*args, **kwargs)

        gpu_mod.generate = recording
        try:
            with capturing_first_call(transformer, "paged_decode_attention_tp", first), \
                    capturing_logits() as mesh_logits:
                report["rounds"].append(mesh_round(
                    torch, engine, reqs("mesh-tp2-paged"), sp, "8b tp=2 paged",
                    ("paged_decode_attention_tp",)))
        finally:
            gpu_mod.generate = real
        report["w3_first_call_err"] = held_first_call(
            torch, first, pa.paged_decode_attention_tp_plain, "W3", checks)
        first.clear()
        dropped(engine, "8b tp=2 paged")
        # The same prompts on one device: the first step's logits agree.
        params, cfg = materialize_params("random", "llama", "8b", device="cuda")
        prompts, kwargs = calls[0]
        with capturing_logits() as single_logits:
            generate(params, cfg, prompts, **kwargs)
        del params
        # The all-reduce sums bf16 partials in another order than one
        # device's matmul: held to the bf16 tolerance of the largest logit.
        got, want = mesh_logits[0], single_logits[0]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = {"rtol_of_max": BF16_TOL["rtol"], "atol": BF16_TOL["atol"]}
        if not (bool(torch.isfinite(got).all()) and err <= BF16_TOL["rtol"] * scale + BF16_TOL["atol"]):
            raise RuntimeError(f"8b tp=2 first-step logits {err} from one device's "
                               f"(largest {scale})")
        checks.append({"case": "8b tp=2 first-step logits vs one device",
                       "max_abs_err": err, "max_abs_logit": scale, "tol": tol})
        report["tp2_first_logits_err"] = err
        gc.collect()
        torch.cuda.empty_cache()

        engine = GpuEngine(devices=[dev] * 4)
        first = []
        with capturing_first_call(transformer, "paged_decode_attention_dp_tp", first):
            report["rounds"].append(mesh_round(
                torch, engine, reqs("mesh-dp2tp2-paged"), sp, "8b dp=2 tp=2 paged",
                ("paged_decode_attention_dp_tp",)))
        report["w2_first_call_err"] = held_first_call(
            torch, first, pa.paged_decode_attention_dp_tp_plain, "W2", checks)
        first.clear()
        dropped(engine, "8b dp=2 tp=2 paged")

    if torch.cuda.device_count() >= 2:
        report["two_cards"] = mesh_two_cards(torch, doc)
    else:
        report["two_cards"] = ("not run: this machine has one card, so no mesh of "
                               "distinct cards (NCCL collectives) can be built")
    report["launches"], report["shards"] = summed(report["rounds"])
    return report


def phase_sp(torch) -> dict:
    """The sequence-parallel axis from the user's entry point:
    ``GpuEngine.chat`` on registry aliases with an ``sp`` mesh axis, on
    virtual meshes (``GpuEngine(devices=[cuda] * n)``: every shard on the
    one card), greedy, speculation at its default, 32 new tokens: (a)
    Llama-3.2-3B at full width and depth on {"sp": 4}, dense, two
    opponents on a ~16,000-token spec (BASELINE config 5's context); (b)
    random-8b on {"sp": 2}, kv="paged", kv_dtype="int8", four opponents
    on ~6,000 prompt tokens (the int8 quantization at the reshard, W3 →
    B3-i8); (c) random-70b at full width with 8 of its 80 layers on
    {"sp": 2, "tp": 8} (16 shards; BASELINE config 5's TP=8 judge), dense,
    one opponent on ~7,500 prompt tokens. Every prompt pads to a length
    that splits sp ways, so the ring must run (its calls and hops
    counted, the hops equal to ``ring_hops``) and the chunked prefill
    must not. Each case's first-step logits are held to the same prompts
    without sp (one device's chunked prefill for (a) and (b) — (b) with a
    float cache, since the ring attends to full-precision K/V; (c)
    against {"tp": 8}, phase mesh's program) within the bf16 tolerance of
    the largest logit. Each line gives the wall, prefill and decode
    seconds, decode tok/s, peak memory, the weight bytes the card holds
    (the sp replicas share one copy), launches and which way each
    collective ran; each engine is dropped and device memory must fall
    back."""
    import gc

    from adversarial_spec_tpu_torch.engine import generate as gen_mod
    from adversarial_spec_tpu_torch.engine import gpu as gpu_mod
    from adversarial_spec_tpu_torch.engine import registry
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.loader import materialize_params
    from adversarial_spec_tpu_torch.engine.types import ChatRequest, SamplingParams
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.parallel import collectives, ring, sp as sp_mod
    from adversarial_spec_tpu_torch.parallel.sharding import per_chip_param_bytes

    dev = torch.device("cuda")
    report = {"phase": "sp", "cases": [], "checks": []}
    checks = report["checks"]
    sampling = SamplingParams(max_new_tokens=32, greedy=True, seed=0)
    base_mem = torch.cuda.memory_allocated()

    def dropped(engine, label):
        engine._models.clear()
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base_mem
        report.setdefault("memory_after_drop", {})[label] = left
        if left > (256 << 20):
            raise RuntimeError(f"sp {label}: {left} bytes still allocated after the drop")

    def first_logits_check(label, got, want):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= BF16_TOL["rtol"] * scale + BF16_TOL["atol"]
        checks.append({"case": f"{label} first-step logits vs no sp", "max_abs_err": err,
                       "max_abs_logit": scale, "share_of_largest": err / scale,
                       "tol": {"rtol_of_max": BF16_TOL["rtol"], "atol": BF16_TOL["atol"]}})
        if not ok:
            raise RuntimeError(f"sp {label}: first-step logits {err} from the run without sp "
                               f"(largest {scale})")
        return err

    def sp_round(engine, alias, reqs, label, must_launch):
        """One chat() with every counter zeroed just before and read just
        after; the ring must have run on every generate call."""
        calls, chunks, results = [], [], []
        real_gen, real_chunk = gpu_mod.generate, gen_mod.prefill_chunk

        def recording(*args, **kwargs):
            calls.append((args[2], {k: v for k, v in kwargs.items() if k != "mesh"}))
            results.append(real_gen(*args, **kwargs))
            return results[-1]

        def chunk(*args, **kwargs):
            chunks.append(1)
            return real_chunk(*args, **kwargs)

        # Device time of the ring, of the whole sp prefill and of the
        # reshard: CUDA events around each call, read after the chat.
        spans: dict = {"ring": [], "sp_prefill": [], "reshard": []}
        reals = {"ring": "ring_attention_local", "sp_prefill": "sp_prefill",
                 "reshard": "reshard_cache_for_decode"}

        def timed(name, fn):
            def run(*args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                spans[name].append((start, end))
                return out
            return run

        for mod in (da, pa):
            mod.reset_launches()
        for mod in (collectives, ring, sp_mod):
            mod.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gpu_mod.generate, gen_mod.prefill_chunk = recording, chunk
        saved = {name: getattr(sp_mod, attr) for name, attr in reals.items()}
        for name, attr in reals.items():
            setattr(sp_mod, attr, timed(name, saved[name]))
        try:
            with capturing_logits() as logits:
                t = time.monotonic()
                comps = engine.chat(reqs, sampling)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
        finally:
            gpu_mod.generate, gen_mod.prefill_chunk = real_gen, real_chunk
            for name, attr in reals.items():
                setattr(sp_mod, attr, saved[name])
        device_s = {name: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                    for name, ev in spans.items()}
        bad = [c.error for c in comps if not c.ok]
        if bad:
            raise RuntimeError(f"sp {label}: chat failed: {bad}")
        lm = engine._models[alias]
        mesh = lm.mesh
        n_sp = mesh.shape["sp"]
        S = gen_mod.bucket_length(max(len(p) for p in calls[0][0]))
        want_hops = ring.counts["calls"] * ring.ring_hops(n_sp, S // n_sp, 0, True)
        if (sp_mod.counts["prefills"] != len(calls) or chunks or not ring.counts["calls"]
                or ring.counts["hops"] != want_hops or S % n_sp):
            raise RuntimeError(f"sp {label}: the ring did not carry the prefill: "
                               f"{sp_mod.counts} {ring.counts} chunked={len(chunks)} S={S}")
        launched, _ = mesh_counts(da, pa)
        missing = [k for k in must_launch if not launched[k]]
        if missing:
            raise RuntimeError(f"sp {label}: {missing} never launched: {launched}")
        per_step = mesh_steps(da, pa, mesh, lm.cfg.n_layers, f"sp {label}")
        shared = all(lm.params.shard(d, t, s) is lm.params.parts[d][t]
                     for d in range(mesh.shape["dp"]) for t in range(mesh.shape["tp"])
                     for s in range(n_sp))
        one_copy = gpu_mod.param_bytes(lm.params)
        if not shared or per_chip_param_bytes(lm.params) != one_copy:
            raise RuntimeError(f"sp {label}: the sp replicas do not share one weight copy")
        decode_s = sum(r.decode_time_s for r in results)
        out_tok = sum(int(r.n_generated.sum()) for r in results)
        line = {
            "case": label, "mesh": dict(mesh.shape), "rows": len(reqs),
            "prompt_tokens": [len(p) for p in calls[0][0]], "padded_len": S,
            "virtual": not mesh.distinct, "chat_wall_s": wall,
            "prefill_s": sum(r.prefill_time_s for r in results),
            "sp_prefill_device_s": device_s["sp_prefill"],
            "ring_device_s": device_s["ring"],
            "ring_share_of_sp_prefill": device_s["ring"] / device_s["sp_prefill"],
            "reshard_device_s": device_s["reshard"],
            "decode_s": sum(r.decode_time_s for r in results),
            "decode_tokens_per_s": out_tok / decode_s if decode_s > 0 else 0.0,
            "output_tokens": [c.usage.output_tokens for c in comps],
            "sp_prefills": sp_mod.counts["prefills"], "ring_calls": ring.counts["calls"],
            "ring_hops": ring.counts["hops"], "ring_hops_per_call": n_sp,
            "collectives": dict(collectives.counts),
            "weight_bytes_on_card": lm.bytes_per_chip, "weights_shared_over_sp": shared,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in launched.items() if v},
            "shards": {k: v for k, v in {**da.mesh_shards, **pa.mesh_shards}.items() if v},
            "attention_per_decode_step": per_step,
        }
        emit({"phase": "sp round", **line})
        report["cases"].append(line)
        return calls, logits

    def single_device_logits(label, family, size, prompts, kwargs):
        """The same prompts on one device (the chunked prefill): its
        first-step logits; its prefill seconds go beside the case's."""
        params, cfg = materialize_params("random", family, size, device="cuda")
        with capturing_logits() as logits:
            res = gen_mod.generate(params, cfg, prompts, **kwargs)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        case = next(c for c in report["cases"] if c["case"] == label)
        case["one_device_chunked_prefill_s"] = res.prefill_time_s
        case["sp_over_one_device_prefill"] = case["prefill_s"] / res.prefill_time_s
        return logits[0]

    specs = (
        registry.ModelSpec(alias="sp-3b", family="llama", size="3b", mesh={"sp": 4}),
        registry.ModelSpec(alias="sp-8b-paged-kv8", family="llama", size="8b", mesh={"sp": 2},
                           kv="paged", kv_dtype="int8"),
        registry.ModelSpec(alias="sp-70b", family="llama", size="70b", mesh={"sp": 2, "tp": 8}),
    )
    with temp_registry(*specs):
        # (a) Llama-3.2-3B, {"sp": 4}, ~16k tokens.
        doc = spec_document(15600, 15) + "\n\nCritique this spec."
        reqs = [ChatRequest("tpu://sp-3b", p, doc) for p in PERSONAS[:2]]
        engine = GpuEngine(devices=[dev] * 4)
        calls, logits = sp_round(engine, "sp-3b", reqs, "3b sp=4 dense",
                                 ("decode_attention_mq", "decode_attention_tp"))
        mesh_logits = logits[0]
        dropped(engine, "3b sp=4")
        report["first_logits_err_3b"] = first_logits_check(
            "3b sp=4", mesh_logits,
            single_device_logits("3b sp=4 dense", "llama", "3b", *calls[0]))

        # (b) random-8b, {"sp": 2}, paged, int8 KV.
        doc = spec_document(5800, 16) + "\n\nCritique this spec."
        reqs = [ChatRequest("tpu://sp-8b-paged-kv8", p, doc) for p in PERSONAS[:4]]
        engine = GpuEngine(devices=[dev] * 2)
        calls, logits = sp_round(engine, "sp-8b-paged-kv8", reqs, "8b sp=2 paged int8 KV",
                                 ("paged_decode_attention_tp_int8kv",))
        mesh_logits = logits[0]
        dropped(engine, "8b sp=2 paged int8")
        prompts, kwargs = calls[0]
        report["first_logits_err_8b"] = first_logits_check(
            "8b sp=2 paged int8", mesh_logits,
            single_device_logits("8b sp=2 paged int8 KV", "llama", "8b", prompts,
                                 dict(kwargs, kv_dtype="")))

        # (c) 70B at 8 of 80 layers, {"sp": 2, "tp": 8}, against {"tp": 8}.
        with depth(8, ("llama", "70b")):
            doc = spec_document(7300, 17) + "\n\nCritique this spec."
            engine = GpuEngine(devices=[dev] * 16)
            _, logits = sp_round(engine, "sp-70b", [ChatRequest("tpu://sp-70b", PERSONAS[0], doc)],
                                 "70b sp=2 tp=8 dense", ("decode_attention_tp",))
            mesh_logits = logits[0]
            dropped(engine, "70b sp=2 tp=8")
            engine = GpuEngine(devices=[dev] * 8)
            with capturing_logits() as tp_logits:
                (c,) = engine.chat([ChatRequest("tpu://random-70b", PERSONAS[0], doc)], sampling)
            if not c.ok:
                raise RuntimeError(f"sp 70b tp=8 reference round failed: {c.error}")
            dropped(engine, "70b tp=8")
            report["first_logits_err_70b"] = first_logits_check(
                "70b sp=2 tp=8", mesh_logits, tp_logits[0])
    report["launches"], report["shards"] = summed(report["cases"])
    for k in ("decode_attention_mq", "decode_attention_tp", "paged_decode_attention_tp_int8kv"):
        if not report["launches"].get(k):
            raise RuntimeError(f"sp: {k} never launched in the phase: {report['launches']}")
    return report


@contextlib.contextmanager
def capturing_logits():
    """While the block runs, keep the first logits ``generate`` samples
    from (the prefill's last position) of each call."""
    from adversarial_spec_tpu_torch.engine import generate as gen_mod

    real = gen_mod.sample_tokens
    store: list = []

    def wrapped(logits, *args, **kwargs):
        # generate's own call is its prefill's; decode steps sample from
        # helpers (_sample_step) or other modules.
        if sys._getframe(1).f_code.co_name == "generate":
            store.append(logits.float().clone())
        return real(logits, *args, **kwargs)

    gen_mod.sample_tokens = wrapped
    try:
        yield store
    finally:
        gen_mod.sample_tokens = real


def mesh_two_cards(torch, doc: str) -> dict:
    """(b)'s {"tp": 2} paged round through ``critique`` over cuda:0 and
    cuda:1: the collectives must take the NCCL way."""
    from adversarial_spec_tpu_torch.engine import dispatch
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.parallel import collectives

    collectives.reset_counts()
    with cli_state():
        dispatch.install_engine("tpu://mesh-tp2-paged",
                                GpuEngine(devices=["cuda:0", "cuda:1"]))
        code, out, err = run_cli(
            ["registry", "add-model", "mesh-tp2-paged", "--family", "llama", "--size", "8b",
             "--kv", "paged", "--tp", "2"])
        if code:
            raise RuntimeError(f"registry add-model failed: {err[-2000:]}")
        code, out, err = run_cli(
            ["critique", "--models", ",".join(["tpu://mesh-tp2-paged"] * 4),
             "--greedy", "--max-new-tokens", "64", "--json"], doc)
        if code:
            raise RuntimeError(f"two-card critique failed: {err[-2000:]}")
    if collectives.counts["nccl"] == 0:
        raise RuntimeError(f"two-card round never took the NCCL way: {collectives.counts}")
    return {"devices": ["cuda:0", "cuda:1"], "collectives": dict(collectives.counts),
            "results": [r["output_tokens"] for r in json.loads(out)["results"]]}


def main(argv: list[str]) -> int:
    t_start = time.monotonic()
    quick = "--quick" in argv
    qmm_only = "--qmm-only" in argv
    only = []
    if "--only" in argv:
        only = argv[argv.index("--only") + 1].split(",")
        unknown = set(only) - set(ONLY_PHASES)
        if unknown:
            return fail(f"--only takes {', '.join(ONLY_PHASES)}, not {sorted(unknown)}")
    profile = "--profile" in argv
    if not os.path.isdir(os.path.join(HERE, PKG)):
        return fail(f"{PKG}/ not found beside chip_smoke.py: run from a checkout")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs a CUDA card")
    sys.path.insert(0, HERE)
    os.environ.setdefault(
        "ADVSPEC_KERNEL_BUILD_DIR", os.path.join(HERE, "build", "kernels")
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from adversarial_spec_tpu_torch.ops import _build
    from adversarial_spec_tpu_torch.ops import decode_attention as da
    from adversarial_spec_tpu_torch.ops import paged_attention as pa
    from adversarial_spec_tpu_torch.ops import quant
    from adversarial_spec_tpu_torch.ops import quant_matmul as qm

    kind = torch.cuda.get_device_name(0)
    smi_line = card()
    emit({
        "phase": "device", "kind": kind, "count": torch.cuda.device_count(),
        "nvidia_smi": smi_line, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })

    t = time.monotonic()
    libs = _build.build_all()
    ptxas = [
        ln.strip() for src in libs for ln in _build.ptxas_report(src).splitlines()
        if "registers" in ln or "spill" in ln
    ]
    emit({"phase": "build", "seconds": time.monotonic() - t,
          "sources": sorted(libs), "ptxas": ptxas})
    # Each kernel's registers, shared memory and spills, by function.
    for src in ("decode_attention.cu", "verify_attention.cu", "quant_matmul.cu"):
        report = [
            ln.split(":", 1)[-1].strip()
            for ln in _build.ptxas_report(src).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln
        ]
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            report = subprocess.run(["c++filt"], input="\n".join(report), capture_output=True,
                                    text=True, timeout=60).stdout.splitlines() or report
        emit({"phase": "ptxas", "source": src, "lines": report})

    seconds = {"build": time.monotonic() - t}

    def run(name, fn, *args, **kwargs):
        """One phase, timed: its report gains ``seconds`` and is printed."""
        t = time.monotonic()
        out = fn(*args, **kwargs)
        out["seconds"] = seconds[name] = time.monotonic() - t
        emit(out)
        torch.cuda.empty_cache()
        return out

    if only:  # iteration on the named phases; no kernels or ok line
        for name in only:
            run(name, globals()[f"phase_{name}"], torch)
        emit({"phase": "seconds", **seconds})
        print(smi_line, flush=True)
        return 0
    if qmm_only:
        qres, qchecks, qcases, qsweeps = phase_quant_kernels(torch, qm, quant)
        for c in qcases:
            print(f"qmm {c['kernel']} {c['weight']} M={c['M']}: ms {c['ms']:.5f} call "
                  f"{c['call_ms']:.5f} library {c['library_ms']:.5f}", flush=True)
        for name, per_m in qsweeps["per_forward"].items():
            for M, t in per_m.items():
                print(f"qmm forward {name} M={M}: ms {t['ms']:.4f} call {t['call_ms']:.4f} "
                      f"library {t['library_ms']:.4f} bound {t['bound_ms']:.4f}", flush=True)
        out_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_qmm.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi_line, "kernels": qres,
                       "checks": qchecks, "quant_cases": qcases, "quant_sweeps": qsweeps}, f,
                      indent=1)
        print(smi_line, flush=True)
        return 0
    t_kernels = time.monotonic()
    kres, checks = phase_kernels(torch, da)
    pres, pchecks = phase_paged_kernels(torch, pa)
    kres.update(pres)
    checks += pchecks
    ires, ichecks = phase_int8kv_kernels(torch, da, pa)
    kres.update(ires)
    checks += ichecks
    checks += phase_verify_edges(torch, da, pa)
    checks += phase_decode_edges(torch, da, pa)
    qres, qchecks, qcases, qsweeps = phase_quant_kernels(torch, qm, quant)
    kres.update(qres)
    mres, mchecks = phase_mesh_kernels(torch, da, pa)
    kres.update(mres)
    checks += mchecks
    emit({"phase": "kernels", "checks": checks, "quant_checks": len(qchecks),
          "quant_worst": {name: r["max_abs_err"] for name, r in qres.items()}})
    for c in qcases:  # one short line per B5/B6 timing (all in chip_smoke.json)
        print(f"qmm {c['kernel']} {c['weight']} M={c['M']} bn={c['bn']} ks={c['ksplit']}: "
              f"ms {c['ms']:.5f} call {c['call_ms']:.5f} plain {c['plain_ms']:.4f} library "
              f"{c['library_ms']:.5f} bound {c['bound_ms']:.5f} ({c['bound_by']})", flush=True)
    for name, per_m in qsweeps["per_forward"].items():
        for M, t in per_m.items():
            print(f"qmm forward {name} M={M}: ms {t['ms']:.4f} call {t['call_ms']:.4f} "
                  f"library {t['library_ms']:.4f} bound {t['bound_ms']:.4f}", flush=True)
    for c in qsweeps["ksplit"]:
        print(f"qmm ksplit {c['kernel']} {c['weight']} M={c['M']} bn={c['bn']} "
              f"ks={c['ksplit']}{'*' if c['planned'] else ''}: ms {c['ms']:.5f}", flush=True)
    for c in qsweeps["threshold"]:
        print(f"qmm threshold {c['kernel']} {c['weight']} M={c['M']} {c['path']}: "
              f"ms {c['ms']:.5f}", flush=True)
    checks += qchecks
    seconds["kernels"] = time.monotonic() - t_kernels
    torch.cuda.empty_cache()
    record = {"device": kind, "nvidia_smi": smi_line, "kernels": kres, "checks": checks,
              "quant_cases": qcases, "quant_sweeps": qsweeps}

    launches = {name: None for name in kres}
    shards = dict.fromkeys(MESH_WRAPPERS)
    if not quick:
        sl = run("slice", phase_slice, torch, profile=profile)
        launches.update(sl["launches"])
        pg = run("paged", phase_paged, torch, profile=profile)
        launches.update(pg["launches"])
        qt = run("quant", phase_quant, torch, profile=profile)
        launches["matmul_int8"] = qt["dense_int8"]["launches"]["matmul_int8"]
        launches["matmul_int4"] = qt["paged_int4"]["launches"]["matmul_int4"]
        kv8 = run("kv8", phase_kv8, torch, profile=profile)
        for name in KERNELS:
            if name.endswith("_int8kv"):
                launches[name] = (kv8["dense"]["launches"].get(name, 0)
                                  + kv8["paged_int4"]["launches"].get(name, 0))
        # The main path from the user's entry point: B1-B4's launches in
        # the kernels line are this phase's.
        cl = run("cli", phase_cli, torch)
        # HF checkpoints from the user's entry point; then the same
        # checkpoint as an opponent pool, the newest main path: B1-B4's,
        # B5's and B6's launches in the kernels line are phase pool's.
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        ckpt = tempfile.mkdtemp(prefix="hf-8b-", dir=os.path.join(HERE, "build"))
        try:
            with depth(HF_POOL_LAYERS):
                hf = run("hf", phase_hf, torch, ckpt)
                pl = run("pool", phase_pool, torch, ckpt)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        launches.update({k: v for k, v in pl["launches"].items() if k in launches})
        # The batcher's faults, watchdog, legacy loop and KV tiers, the
        # round-synchronous paged generate, the serve daemon and the
        # fleet: their B3 (-i8) and B4 (-i8) launches join the kernels line.
        bt = run("batcher", phase_batcher, torch)
        pgen = run("pgen", phase_pgen, torch)
        sv = run("serve", phase_serve, torch)
        fl = run("fleet", phase_fleet, torch)
        # The multi-device mesh (a virtual one on one card): W1-W3's
        # launches (one a device group) and shards served are this phase's.
        ms = run("mesh", phase_mesh, torch)
        # The sequence-parallel axis (virtual meshes on one card): the
        # ring prefill, then W1 / W3 (B3-i8) decode.
        spp = run("sp", phase_sp, torch)
        for ph in (bt, pgen, sv, fl, ms, spp):
            for k, n in ph["launches"].items():
                if kernel_row(k) in launches:
                    launches[kernel_row(k)] = (launches[kernel_row(k)] or 0) + n
        for ph in (ms, spp):
            for k, n in ph["shards"].items():
                shards[kernel_row(k)] = (shards[kernel_row(k)] or 0) + n
        ag = run("agree", phase_agree, torch)
        record.update(slice=sl, paged=pg, quant=qt, kv8=kv8, cli=cl, hf=hf, pool=pl,
                      batcher=bt, pgen=pgen, serve=sv, fleet=fl, mesh=ms, sp=spp, agree=ag)
    emit({"phase": "seconds", **seconds})
    record["phase_seconds"] = seconds

    line = []
    for name, r in kres.items():
        source, replaces = KERNELS[name]
        line.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"],
            "kernel_ms": r["ms"],
            "call_ms": r.get("call_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"shards": shards[name], "launches_per_call": r["launches_per_call"],
                "shards_per_call": r["shards_per_call"]} if name in shards else {}),
        })
    record["kernels_line"] = line
    record["seconds"] = time.monotonic() - t_start
    emit({"phase": "done", "seconds": record["seconds"]})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(smi_line, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
