#!/usr/bin/env python3
"""Drive paddle_tpu_torch's four paths — Llama serving through the paged
ServingEngine (with speculative decoding, KV block transfer and the int8
KV cache), Llama
generation (forward, generate, greedy_decode) over the
static KV ring, Llama pretraining (TrainStep + AdamW), and the inference
Predictor with weight-only int8 over bench_ladder.py's BERT-base classifier
— on one NVIDIA H100, and check every Hopper kernel on them.

    python3 chip_smoke.py                  # all phases
    python3 chip_smoke.py --phases 1,2     # build + kernel checks only
    python3 chip_smoke.py --phases 2,9,10  # kernels + the int8 predictor
    python3 chip_smoke.py --phases 2,13    # kernels + block_multihead_attention
    python3 chip_smoke.py --phases 1,2 --k1-sweep   # + K1 under each plan

Phases (each prints its seconds):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), compute capability 9.0, and the kernel build from
     paddle_tpu_torch/csrc (nvcc, sm_90a); cuobjdump -sass of the build must
     show tensor-core instructions in every bf16 instance of B1, B8 and B7
     (HGMMA) and of B2 (HMMA);
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     in bfloat16 and float32, at the shapes the paths give it (B9 over
     three steps from one state);
     then CUDA-event times (L2 flushed before each launch) of the kernel,
     the plain version and, where one exists, the one PyTorch call that
     computes the same function, beside the bound: the larger of bytes
     moved over 3.35 TB/s and operations over the peak rate of the type,
     and each row's TFLOP/s and share of its bound;
     K4 at serving's shapes: decode (8 rows; 32 / 32 heads at D 128, 8 / 2
     at D 256, 64 / 1), the single step's mixed batch (max_q_len 256), the
     mixed loop's program (T 256, max_q_len 16), a long-context decode
     (2 rows of ~4000 keys) and the speculative verify (8 rows of up to 9
     tokens, T 72, max_q_len 9, context <= 512, 32 / 32 and 32 / 8 heads),
     each with its GB/s, share of the bound and
     plan (query tile, key tile, ring, splits) (with --k4-sweep, each K4
     case also timed under other plans, informative); B2 at generation's
     shapes (8 rows over 512- and 4096-row rings, 32 / 32 and 32 / 8 heads,
     greedy_decode's pos 150, one row of 32 / 8 heads at pos 4000), each
     with its GB/s, share of the bound and plan (instance, key tile,
     splits) (with --b2-sweep, each B2 case also timed under every split
     count, informative); B7 at the predictor's shapes with and without
     the bias (the head on its strided rows), each with its plan (kind,
     token tile, weight rows, splits) and, informative, the time of
     torch.matmul with the dequantized weight (with --b7-sweep, each bf16
     B7 case also timed under every plan the instances take); K3 also on
     numel % 8 != 0 and at an odd storage offset; K1 at [8, 4096], [1,
     16384], [4, 16384], [2, 32768] and at an odd storage offset, each
     with its plan (with --k1-sweep, each bf16 K1 case also timed under
     every plan the instances take, informative); K2 at a decode step's
     packed [1, 8] rows, at greedy_decode's [8, 1] with the ring's pos on
     the device (32 / 32 and 32 / 8 heads) and at an offset the clamp
     moves; K2's ring mode (B3 folded in) at greedy_decode's decode step
     and [8, 128] prefill, held to the plain composition and, bit for bit,
     to rope_fused then kv_ring_write; B3 at pos -3 (C7: the start counts
     from the end, row 509), bit for bit against index_copy_ at
     dynamic_update_slice's start; B1, B8, B2, B3, K4 and the ring mode at
     head_dim 72, 100, 264, 512, 516, 640 and 1024 (8 / 2 heads; past 512
     the wide instances), SDPA at the same shape the library call; K1 and K2 under every plan their instances take
     (both bodies, rows past the registers, D 72 and 2, strided qkv
     columns, device offsets) against their plain versions, the rope backward's sign flag
     giving the bits of K2 with a -sin table, and apply_rotary_pos_emb
     with a device offset dispatching one K2 launch and nothing else; a
     shape past a kernel's limits is refused with an error, a head dim of
     520 (refused before Queue C8) is computed by B1, B8, B2 and K4 and
     held to the plain versions, and B7 refuses a float16 x and an int32
     weight; K4, B2 and B7 at the edges their
     tiles and splits add (K4 and B2 also at head_dim 72, 100, 264 and
     512, B2 at a negative pos)
     (every split count forced, K4 also every ring depth and several query
     tiles; B7 at M 1, 8, 9, 64, 65 and 4097, N 2 and 130, K 100 and 4096
     and the strided head, with and without a bias, the fused bias giving
     the two-step bits; in both types) against their plain versions, each
     cluster plan giving the same bits in five runs;
     K4-int8 over uint8 pools of random codes with random per-(row, KV
     head) scales: decode (8 rows, context <= 512, 32 / 32 and 32 / 8
     heads), the single step's mixed batch of 255 tokens with an
     out-of-pool block in a decode row's visible range, and decode at 8 /
     2 heads, head_dim 72, 100, 264, 512 and 640, each with its plan and,
     informative, K4's time over a cache of q's dtype at the same shape;
     the pre-caches (A4b): K4 and K4-int8 at decode with a 64-key prefix
     (8 rows, context <= 512, 32 / 32 and 32 / 8 heads; K4's library time
     SDPA over the concatenated context), and every K4 instance (tensor
     cores, SIMT, wide) and both K4-int8 ones with prefixes of 1, 64 and
     130 keys at decode and at the mixed 255-token step, one and four
     splits forced, against their plain versions;
     the additive masks (A4b): K4 and K4-int8 in their masked instances
     at decode (tgt_mask [8, H, 1, 512]) and at the mixed 255-token step
     (its prefill rows under mask [8, 1, 256, 512]), 32 / 32 and 32 / 8
     heads (K4's library time SDPA with a float attn_mask; the bound
     counts the masks' bytes), and every instance under masks of one and
     H heads, fewer and more rows and columns than the call's, with
     prefixes of 0, 1, 64 and 130 keys, splits forced, against their plain
     versions; a row whose visible keys are all -inf (Queue C10) pinned:
     zeros from the kernels, the reference's mean from the plain versions;
     the entry refuses a mask without seq_lens_encoder or of a head count
     other than 1 and H;
     K2's interleaved pairs at the serving step's [1, 256] rows;
     then (informative) B1 and B8 in bf16 at every compiled tile pair
     (autotune.tune), B8's two GQA modes, and whether two bf16 B8 runs
     agree bit for bit;
  3. Llama-2-7B geometry (32000 vocab, 4096 hidden, 11008 intermediate, 32
     layers, 32 heads) in bfloat16 with seeded random weights, served by
     ServingEngine(max_batch_size=8, max_seq_len=512, block_size=16,
     token_budget=256) with the default megastep_k=8 and prefix cache, in
     two waves (the first holds a sampled request); the megastep loops and
     the single step run as CUDA graphs (the engine's default on CUDA);
     the kernels' launch
     counters are zeroed just before and read just after, and the device
     loops and every graph replay run with CUDA sync debugging set to
     raise (no host sync inside a megastep); an eager engine
     (_graphs = False) over the same weights serves the same waves:
     tokens, logprobs and scheduling counters identical, compile_count the
     graphs captured (each one's first-call and capture times printed);
     then on each engine a decode wave (its captures), one timed and one
     under torch.profiler give the wall, the device's busy share, memory,
     K4's device time and kernel count in the traced wave (one kernel per
     wrapper call; a replay adds its captured counts), K1's and K2's
     device time, kernel count and time a launch, and each wave's single
     steps (their count, execute ms and eager runs: none in a timed wave
     on graphs); and the cost of the seeded threefry draw per sampled
     step;
  4. the same geometry at 2 layers in float32 served on cuda (kernels) and
     on the CPU (plain versions) from identical weights: first-step logits
     agree, greedy tokens agree up to the first position whose CPU top-2
     logit gap is below 1e-3, and prefix cache on/off agree on cuda; then
     the same for 2-layer float32 Llamas at head_dim 72 (hidden 576, 8
     heads), 264 (1056, 4) and 640 (1280, 2); and a graph engine after
     load_weights drops its graphs, captures again and serves the new
     weights' tokens; the 2-layer pair also serves repetitive prompts
     with spec_k 8 on cuda and on the CPU (the same top-2-gap rule), and
     a packed block export made on cuda, imported into a CPU engine,
     serves wave 2 with the CPU engine's tokens (the same rule); and the
     int8 cache (cache_quant="int8", K4-int8) on cuda against the CPU at
     head_dim 128, 72 and 640: greedy tokens equal up to the first top-2
     gap below 1e-3 of the CPU engine's own int8 decode, logprobs within
     1e-3 of the largest |logprob| + 1e-3 there;
  5. generation at full width, on phase 3's model: the launch counters are
     zeroed, then (a) model(ids [2, 1024]) gives finite logits, (b) on the
     eager loop (_graphs = False), then on CUDA graphs (the default on
     CUDA: one decode step captured per (B, L), after a short call that
     warms the (8, 512) key, its first-call and capture times printed):
     greedy_decode of ids [8, 128], 128 new tokens over a 512-row ring runs
     with CUDA sync debugging set to raise (tokens/s printed, informative;
     then a 32-token greedy_decode untraced and one under torch.profiler
     give the device's busy share and time by kernel, the trace's kernel
     count, K1's and K2's device time, count and time a launch, and B2's
     device time and kernel count in the traced loop: one kernel per
     wrapper call; no B3 kernel, and as many K2 kernels as ring-mode calls,
     the plain rope mode uncalled; max_memory_allocated); the graph loop's
     tokens at + 128 and + 32, its counters and its trace's kernels by name
     and count equal the eager loop's, but for the fills (the eager loop
     zeroes fresh rings each call: 2 a layer and 1 more), (c)
     generate with the static ring equals greedy_decode; generate with
     growing caches (B1 for every step) gives greedy_decode's first
     token (the same prefill), its logits on greedy_decode's tokens agree
     with the ring path's (B2) within 5% of the largest logit, and its
     tokens agree up to the first position whose top-2 gap is below the
     larger of 1e-3 and twice that logit difference (in bfloat16 the two
     decode kernels' roundings compound over 32 layers: the 1e-3 rule of
     phase 4 holds in float32, phase 6), (d) generate(do_sample=True,
     top_p=0.9, generator=Generator(7)) gives tokens in the vocabulary;
     then the counters are read: every kernel of the path launched;
  6. phase 4's two 2-layer float32 models: forward logits on cuda and on
     the CPU agree, and greedy_decode and generate (ring and growing) on
     cuda agree with greedy_decode on the CPU up to the top-2-gap stop,
     greedy_decode on graphs bit for bit with the eager loop on cuda;
     then the same at head_dim 72, 100 (800 hidden, 8 heads), 264 and 640;
  7. training at bench.py's honest geometry (32000 vocab, 2560 hidden,
     8192 intermediate, 9 layers, 20 heads of 128, bfloat16, recompute)
     with seeded random weights: AdamW(1e-4, multi_precision=True),
     LlamaPretrainingCriterion and TrainStep on one [8, 2048] batch; the
     counters are zeroed, then 2 warm-up and 10 timed steps (finite losses,
     the last below the first; tokens/s, ms per step, peak memory and MFU
     against 989 TFLOP/s printed, informative), run_steps over a
     [4, 8, 2048] stack with CUDA sync debugging set to raise, one step
     untraced and one under torch.profiler (busy share, time by kernel,
     K1's and K2's time a launch); then every kernel of the path
     launched;
  8. phase 4's float32 pair: one step's loss and every parameter's
     gradient, then the parameters after 3 AdamW(multi_precision) steps
     through TrainStep, kernels on cuda against the plain path on the CPU
     (1e-4 of each tensor's largest |value|); then the same at head_dim
     72, 264 and 640;
  9. bench_ladder.py's BERT-base classifier (vocab 30522, hidden 768, 12
     layers, 12 heads, FFN 3072, seq 128) in bfloat16 with seeded random
     weights, ids [32, 128]: (a) the float Predictor gives finite logits;
     (b) the weight-only int8 Predictor (a CUDA graph per input signature,
     the default on CUDA), with the counters zeroed just before one
     replayed run and read just after, launches B7 exactly 73 times and
     B1 12 times, adds every biased Int8Linear's bias in B7's epilogue (a
     counter) and gives finite logits (their distance from (a) printed,
     informative); (c) a full-width bf16 weight quantizes to the same int8
     values and scales on cuda and on the CPU; (d) at [32, 128] and [1,
     128], each predictor on graphs gives the eager predictor's
     (_graphs = False) outputs bit for bit, and ms per run, sequences/s
     and one run untraced and one under torch.profiler (busy share, time
     by kernel) of both predictors in both modes, informative; (e) one
     biased Int8Linear's forward is one B7
     launch with its bias and dispatches no add to PyTorch, and the int8
     run's profile holds no add kernels beyond the residual and
     position-embedding adds;
 10. the classifier at 2 layers in float32 with identical weights on cuda
     and on the CPU, ids [4, 128], through int8 Predictors (identical
     quantized weights) and float ones: logits within 1e-4 of the largest
     |logit|;
 11. speculative serving and block transfer on phase 3's model (run
     before the model is dropped for phase 7), phase 3's engine geometry:
     (a) engines with spec_k 8 (on CUDA graphs, and eager with
     _graphs = False) and spec_k 0 over the same weights serve 8 requests
     of repetitive 64-token prompts, 64 new tokens each, one seeded; the
     counters are zeroed just before the spec engine's wave and read just
     after (the "spec" path); the verify and every loop run under CUDA
     sync debugging set to raise; graphs == eager bit for bit (tokens,
     logprobs, spec and scheduling counters); spec-on == spec-off, or
     at the first position that differs spec-off's choice (teacher-forced)
     was within bfloat16's step, 2^-7 of the largest |logit|: its top-two
     logits, or for the seeded row the top two of its filtered, scaled
     logits plus its Gumbel noise (the margin printed); verify forwards, drafted, accepted, tokens per
     verify, each graph's first-call and capture ms; then for each mode a
     wave untraced and one under torch.profiler (wall, busy share, K1/K2),
     K4's kernels equal to its wrapper calls, and K4's device time per
     launch by the program that launched it (the verify, megasteps, the
     single step); (b) engine A prefills 8 prompts of 256 tokens and
     exports their chains (bytes, ms, GB/s), a fresh engine B imports
     them (ms, GB/s) and exports the same bytes, then serves the prompts
     on the imported prefix (hits = blocks imported) with the tokens of
     engine C, which warmed the same prompts itself, bit for bit;
 12. int8-cache serving on phase 3's model (run before the model is
     dropped for phase 7), phase 3's engine geometry with megastep_k 8 and
     cache_quant="int8": the KV bytes (pools and scales) against the bf16
     cache's; two waves of prompts up to token_budget (one sampled) on
     CUDA graphs, the counters zeroed just before and read just after (the
     "int8" path: K4-int8 launched, K4 over a bf16 cache not), every
     replay under CUDA sync debugging set to raise; an eager engine
     (_graphs = False) over the same weights gives identical tokens,
     logprobs, counters and every layer's cache_scales (each prefill a
     single step, on its graph); the share of tokens equal to a
     bf16-cache engine's (printed); then phase 3's decode wave on each
     engine, one untraced and one under torch.profiler (wall, busy share,
     K1/K2, K4-int8's device time and kernels, equal to its wrapper calls,
     each wave's single steps as phase 3's);
 13. the public incubate.nn.functional.block_multihead_attention (run
     before the 7B model is built) at the 7B attention geometry (32 heads
     of 128, batch 8, max_seq_len 512 in blocks of 64, a [64, KV, 64, 128]
     pool pair for each of 32 layers, seeded random qkv): a prefill call a
     layer (prompts of 7-400 tokens under an ALiBi causal-plus-padding
     mask), then 32 decode steps of 32 layers under tgt_mask, over bf16,
     static-int8 and dynamic-int8 pools, with a 64-key pre-cache, and at
     32 / 8 heads; each run's outputs, pools and scales held against its
     plain twin on the card (K2, K4 and K4-int8 replaced by their plain
     versions), K4 / K4-int8 and K2 launches equal to the calls, all of
     them masked, the pools' data_ptr() unchanged, ms a call; then two
     float32 layers on cuda against the same calls on the CPU;
  then one JSON line {"kernels": [...]}, "launches" per path ({"serving",
  "int8", "spec", "generate", "train", "predict", "blha"}, null for a path
  whose phase did not run), then the card line, then {"ok": true,
  "device": {...}} as the last line.

Any failure raises and the script exits non-zero before the last line.  It
imports nothing of JAX or paddle_tpu.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor, fp32 SIMT
_PROFILE_MARKS = 2048   # spin kernels on each side of a profiled call
_PROFILE_TAKES = 3
_REPLAYS = [0]          # CUDA graph replays of the run (main's wrapper)
REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:47",
    "rms_norm_residual": "paddle_tpu/ops/pallas/fused_norm.py:61",
    "rope": "paddle_tpu/ops/pallas/fused_ops.py:65",
    # K2's ring mode: the rotation of fused_ops.py:65 with the ring write of
    # decode_attention.py:70 (B3) folded into its launch
    "rope_ring": "paddle_tpu/ops/pallas/fused_ops.py:65",
    # the same kernel rotating the cotangents by -theta
    "rope_bwd": "paddle_tpu/ops/pallas/fused_ops.py:121",
    "swiglu": "paddle_tpu/ops/pallas/fused_ops.py:164",
    "swiglu_bwd": "paddle_tpu/ops/pallas/fused_ops.py:178",
    # not a Pallas kernel: the jnp attention core XLA compiles
    "paged_attention": "paddle_tpu/ops/paged_attention.py:262",
    # not a Pallas kernel: the int8 cache's dequantization and
    # full-precision overlay (:239-254) before the same core
    "paged_attention_int8": "paddle_tpu/ops/paged_attention.py:239",
    "flash_attention": "paddle_tpu/ops/pallas/flash_attention.py:148",
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:155",
    "kv_ring_write": "paddle_tpu/ops/pallas/decode_attention.py:70",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:279",
    "fused_adamw": "paddle_tpu/ops/pallas/fused_adamw.py:53",
    "int8_matmul": "paddle_tpu/ops/pallas/int8_matmul.py:65",
}
SOURCES = {
    "rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rms_norm_residual": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rope": "paddle_tpu_torch/csrc/fused_ops.cu",
    "rope_ring": "paddle_tpu_torch/csrc/fused_ops.cu",
    "rope_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_int8": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
    "decode_attention": "paddle_tpu_torch/csrc/decode_attention.cu",
    "kv_ring_write": "paddle_tpu_torch/csrc/decode_attention.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_adamw": "paddle_tpu_torch/csrc/fused_adamw.cu",
    "int8_matmul": "paddle_tpu_torch/csrc/int8_matmul.cu",
}
# the names of a kernel's outputs, where it has more than one
OUTPUTS = {
    "flash_attention": ("out", "lse"),
    "flash_attention_bwd": ("dq", "dk", "dv"),
    "rms_norm_residual": ("out", "residual"),
    "rope": ("q", "k"),
    "rope_ring": ("q", "k ring", "v ring"),
    "rope_bwd": ("gq", "gk"),
    "swiglu_bwd": ("da", "db"),
    "kv_ring_write": ("k ring", "v ring"),
}
# the kernels each path runs (phase 3 serving, phase 5 generation, phase 7
# training, phase 9 the int8 predictor, phase 11 speculative serving: the
# verify runs the serving trunk at max_q_len spec_k + 1; phase 12 serving
# over the int8 KV cache)
PATHS = {
    "serving": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                "paged_attention"),
    "int8": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
             "paged_attention_int8"),
    "spec": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
             "paged_attention"),
    "generate": ("rms_norm", "rms_norm_residual", "rope", "rope_ring",
                 "swiglu", "flash_attention", "decode_attention"),
    "train": ("rms_norm", "rms_norm_residual", "rope", "rope_bwd", "swiglu",
              "swiglu_bwd", "flash_attention", "flash_attention_bwd",
              "fused_adamw"),
    "predict": ("int8_matmul", "flash_attention"),
    # phase 13: the public block_multihead_attention over bf16 and int8
    # pools (K2's rope, K4 and K4-int8 in their masked instances)
    "blha": ("rope", "paged_attention", "paged_attention_int8"),
}
# phase 2's head dims beyond the tensor-core classes (72, 100, 264, 512)
# and past 512 (the wide instances, Queue C8)
HEAD_DIMS = (72, 100, 264, 512, 516, 640, 1024)
# the serving engine at full width (phases 3 and 11), and phase 11's and
# phase 4's speculation depth
SERVE_KW = dict(max_batch_size=8, max_seq_len=512, block_size=16,
                token_budget=256)
SPEC_K = 8
# bench_ladder.py's BERT-base classifier, accelerator branch (:103)
BERT = dict(vocab=30522, hidden=768, layers=12, heads=12, seq=128, batch=32)


def _phase(name):
    print(f"== phase {name}", flush=True)
    return time.perf_counter()


def _done(name, t0):
    print(f"phase {name} seconds: {time.perf_counter() - t0:.3f}", flush=True)


# --------------------------------------------------------------- phase 1
def environment(torch):
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, need (9, 0)")
    from paddle_tpu_torch.ops.hopper import _build

    t = time.perf_counter()
    _build.build(force=True, verbose=True)
    _build.lib()
    print(f"build seconds: {time.perf_counter() - t:.3f}")
    _sass_check(_build.LIB_PATH)
    return card


# bf16 B1, B8 and B7 run on the tensor cores: every instance of these
# kernels must hold warpgroup MMA instructions (HGMMA) in its SASS; bf16 B2
# and K4-int8's tensor-core instance run mma.sync, whose instructions are
# HMMA (the tags match by substring: "int8_tc_kernel" is B7's)
TENSOR_CORE_KERNELS = {"flash_fwd_tc_kernel": "HGMMA",
                       "flash_bwd_tc_kernel": "HGMMA",
                       "decode_tc_kernel": "HMMA",
                       "int8_tc_kernel": "HGMMA",
                       "paged_attention_int8_mma_kernel": "HMMA"}


def _sass_check(lib_path):
    """cuobjdump -sass of the built library: count tensor-core instructions
    per function; raise unless every instance of the bf16 B1, B8 and B7
    kernels has HGMMA and every instance of bf16 B2 and of K4-int8's
    tensor-core kernel has HMMA."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur is not None:
            for op in counts[cur]:   # "HGMMA" does not hold "HMMA"
                counts[cur][op] += op in line
    for tag, op in TENSOR_CORE_KERNELS.items():
        found = {f: n[op] for f, n in counts.items() if tag in f}
        print(f"sass {tag}: {len(found)} instances, {op} per instance "
              f"{sorted(found.values())}")
        if not found or min(found.values()) == 0:
            raise AssertionError(f"no {op} in the SASS of {tag}: {found}")


# --------------------------------------------------------------- phase 2
class Timer:
    """Mean CUDA-event time of fn over ``iters`` launches, each after a
    write of 1 GB that evicts the 50 MB L2 (the serving path meets its
    inputs cold) and keeps the card busy for ~0.3 ms, long enough for the
    host to enqueue fn, so the events time the device work alone."""

    def __init__(self, torch, iters):
        self.torch, self.iters = torch, iters
        self.flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / self.iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _err(torch, got, ref):
    if isinstance(got, tuple):
        return max(_err(torch, g, r) for g, r in zip(got, ref))
    return float((got.float() - ref.float()).abs().max())


def _scale(ref):
    if isinstance(ref, tuple):
        return max(_scale(r) for r in ref)
    return float(ref.float().abs().max())


def _tol(dtype_name, ref):
    # bfloat16: both sides round one float32 result to bf16 (8 mantissa
    # bits), so they differ by at most ~2 ulp of the largest output;
    # float32: summation order and rsqrt/exp/sigmoid approximations
    rel = 1.6e-2 if dtype_name == "bfloat16" else 1e-4
    return rel * _scale(ref) + 1e-5


def kernel_cases(torch, dtype):
    """(name, shape label, kernel fn, plain fn, library fn | None, bytes,
    ops[, check fn -> (kernel result, plain result)]) at the shapes the
    serving, generation and training paths give each kernel."""
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    dev = "cuda"
    es = torch.tensor([], dtype=dtype).element_size()
    F = torch.nn.functional

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device=dev, dtype=dt)

    cases = []
    # K1 at prefill's and decode's rows, then widths past the registers of
    # one block (16384 was refused before), and a view at an odd storage
    # offset (no 16-byte packs: the scalar body)
    for n, H, odd in ((256, 4096, False), (8, 4096, False),
                      (1, 16384, False), (4, 16384, False),
                      (2, 32768, False), (256, 4096, True)):
        if odd:
            x, r = (rnd(n * H + 1)[1:].view(n, H) for _ in range(2))
        else:
            x, r = rnd(n, H), rnd(n, H)
        w = rnd(H)
        label = f"[{n}, {H}]" + (" at an odd storage offset" if odd else "")
        _K1_PLANS[(label, str(dtype).split(".")[1])] = (
            fused_norm.rms_plan(n, H, dtype, not odd), (x, r, w))
        cases.append((
            "rms_norm", label,
            lambda x=x, w=w: fused_norm.rms_norm_fused(x, w, 1e-6),
            lambda x=x, w=w: fused_norm._ref_rms(x, w, 1e-6),
            lambda x=x, w=w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
            (2 * n * H + H) * es, 4 * n * H))
        cases.append((
            "rms_norm_residual", label,
            lambda x=x, r=r, w=w: fused_norm.rms_norm_residual_fused(
                x, r, w, 1e-6),
            lambda x=x, r=r, w=w: fused_norm._ref_rms_residual(x, r, w, 1e-6),
            None, (4 * n * H + H) * es, 5 * n * H))
    # rope over the q and k columns of a packed qkv buffer, per-token rows;
    # the 7B heads (32/32), then a GQA split (32/8)
    T, Hq, D = 256, 32, 128
    pos = torch.randint(0, 512, (T,), generator=g, device=dev)
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = pos[:, None].double() * inv[None, :].double()
    cos, sin = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for Tn, Hk in ((T, Hq), (T, 8), (8, Hq)):
        qkv = rnd(Tn, (Hq + 2 * Hk) * D)
        q = qkv[:, :Hq * D].view(1, Tn, Hq, D)
        k = qkv[:, Hq * D:(Hq + Hk) * D].view(1, Tn, Hk, D)
        cs, sn = cos[:Tn], sin[:Tn]
        label = (f"q [1, {Tn}, {Hq}, {D}], k [1, {Tn}, {Hk}, {D}]"
                 + (" (a decode step)" if Tn == 8 else ""))
        _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
            1, Tn, Hq, Hk, D, dtype, True)
        cases.append((
            "rope", label,
            lambda q=q, k=k, c=cs, s=sn: fused_ops.rope_fused(q, k, c, s),
            lambda q=q, k=k, c=cs, s=sn: fused_ops._rope_ref(q, k, c, s),
            None, 2 * Tn * (Hq + Hk) * D * es + 2 * Tn * (D // 2) * 4,
            6 * Tn * (Hq + Hk) * D // 2))
    # K2's interleaved pairs (blha_attention's use_neox_style=False) at the
    # serving step's [1, 256] packed rows
    qkv = rnd(T, 3 * Hq * D)
    q = qkv[:, :Hq * D].view(1, T, Hq, D)
    k = qkv[:, Hq * D:2 * Hq * D].view(1, T, Hq, D)
    label = f"interleaved q, k [1, {T}, {Hq}, {D}]"
    _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
        1, T, Hq, Hq, D, dtype, True)
    cases.append((
        "rope", label,
        lambda q=q, k=k: fused_ops.rope_fused(q, k, cos, sin,
                                              interleaved=True),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, sin, True),
        None, 4 * T * Hq * D * es + 2 * T * (D // 2) * 4,
        6 * T * 2 * Hq * D // 2))
    # generation's rope: the whole 4096-row table and the ring's pos on the
    # device (greedy_decode's decode step, a 32 / 8 split, and an offset the
    # clamp moves back to Smax - S)
    fr = (torch.arange(4096, device=dev)[:, None].double()
          * inv[None, :].double())
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for B, S, Hk, off in ((8, 1, Hq, 150), (8, 1, 8, 150), (8, 4, Hq, 5000)):
        q, k = rnd(B, S, Hq, D), rnd(B, S, Hk, D)
        o = torch.full((), off, dtype=torch.int32, device=dev)
        label = (f"q [{B}, {S}, {Hq}, {D}], k [{B}, {S}, {Hk}, {D}], "
                 f"device offset {off}"
                 + (" (clamped)" if off > 4096 - S else ""))
        _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
            B, S, Hq, Hk, D, dtype, True)
        cases.append((
            "rope", label,
            lambda q=q, k=k, o=o: fused_ops.rope_fused(q, k, tc, ts, o),
            lambda q=q, k=k, o=o: fused_ops._rope_ref(
                q, k, *fused_ops._window(tc, ts, q.shape[1], o)), None,
            2 * B * S * (Hq + Hk) * D * es + 2 * S * (D // 2) * 4,
            6 * B * S * (Hq + Hk) * D // 2))
    a, b = rnd(256, 11008), rnd(256, 11008)
    cases.append((
        "swiglu", "[256, 11008]",
        lambda: fused_ops.swiglu_fused(a, b),
        lambda: fused_ops._swiglu_ref(a, b), None,
        3 * a.numel() * es, 5 * a.numel()))
    # K3's scalar tail (numel % 8 = 7 in bf16, 3 in float32) and its scalar
    # body (views at an odd storage offset: no 16-byte alignment)
    a7, b7 = rnd(257, 11007), rnd(257, 11007)
    ao = rnd(256 * 11008 + 1)[1:].view(256, 11008)
    bo = rnd(256 * 11008 + 1)[1:].view(256, 11008)
    for label, x, y in (("[257, 11007], numel % 8 = 7", a7, b7),
                        ("[256, 11008] at an odd storage offset", ao, bo)):
        cases.append((
            "swiglu", label,
            lambda x=x, y=y: fused_ops.swiglu_fused(x, y),
            lambda x=x, y=y: fused_ops._swiglu_ref(x, y), None,
            3 * x.numel() * es, 5 * x.numel()))

    cases += _generation_cases(torch, rnd, es, g, dtype)
    cases += _head_dim_cases(torch, rnd, es, g, dtype)
    cases += _training_cases(torch, rnd, es, g, dtype)
    cases += _predict_cases(torch, rnd, es, dtype)

    # paged attention: pool of 256 blocks of 16, 8 rows of up to 32 blocks
    # (max_seq_len 512); the 7B heads, and a head_dim-256 GQA geometry
    # (bench_ladder.py's 1B serving config has head_dim 256)
    B = 8
    for label, heads, kv_heads, hd, dec, now in (
            ("decode 8 rows, context <= 512", Hq, Hq, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B),
            ("mixed 255 tokens", Hq, Hq, D,
             torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
             [1, 100, 16, 1, 60, 0, 1, 76]),
            ("decode 8 rows, 8 heads / 2 KV, head_dim 256", 8, 2, 256,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B),
            # the former refusal: a 64-head group over one KV head
            ("decode 8 rows, 64 heads / 1 KV", 64, 1, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B)):
        cases.append(_paged_case(torch, rnd, es, g, label, heads, kv_heads,
                                 hd, dec.to(torch.int32), now))
    # the mixed loop's program: T = token_budget 256, max_q_len = the
    # 16-token prefill chunk, decode tokens beside 16-token chunks
    cases.append(_paged_case(
        torch, rnd, es, g, "mixed loop T 256, max_q_len 16", Hq, Hq, D,
        torch.tensor([310, 0, 48, 200, 16, 95, 0, 430], dtype=torch.int32,
                     device=dev), [1, 16, 16, 1, 16, 1, 9, 1], mq=16, T=256))
    # long-context decode: 2 rows of ~4000 visible keys (4096-key pool)
    cases.append(_paged_case(
        torch, rnd, es, g, "decode 2 rows, context ~4000", Hq, Hq, D,
        torch.tensor([3990, 4011], dtype=torch.int32, device=dev), [1, 1],
        P=256, NB=512))
    # the speculative verify (spec_k 8): 8 rows of [last token] + a draft
    # of up to 8 tokens packed into T = 8 * 9, max_q_len 9, context <= 512
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_case(
            torch, rnd, es, g, f"verify 8 rows x 9 tokens, context <= 512, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 503, (B,), generator=g, device=dev).to(
                torch.int32), [9, 9, 5, 9, 1, 9, 3, 9], mq=9, T=8 * 9))
    # the pre-caches (A4b): 64 prefix keys before each row's context of up
    # to 512 at decode, 32 / 32 and 32 / 8 heads (K4-int8's below)
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_case(
            torch, rnd, es, g, f"decode 8 rows, context <= 512, prefix 64, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 511, (B,), generator=g, device=dev).to(
                torch.int32), [1] * B, Lp=64))
    # K4-int8 (the int8 cache): decode over 512-token contexts at 32 / 32
    # and 32 / 8 heads, the single step's mixed batch with an out-of-pool
    # block in a decode row's visible range, and the head dims past the
    # tensor-core classes (8 / 2 heads)
    for label, heads, kv_heads, hd, dec, now, oob in (
            ("decode 8 rows, context <= 512", Hq, Hq, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B,
             False),
            ("decode 8 rows, context <= 512, 32 heads / 8 KV", Hq, 8, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B,
             False),
            ("mixed 255 tokens, an out-of-pool block", Hq, Hq, D,
             torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
             [1, 100, 16, 1, 60, 0, 1, 76], True),
            *((f"decode 8 rows, 8 heads / 2 KV, head_dim {d}", 8, 2, d,
               torch.randint(64, 511, (B,), generator=g, device=dev),
               [1] * B, False) for d in (72, 100, 264, 512, 640))):
        cases.append(_paged_int8_case(torch, rnd, es, g, label, heads,
                                      kv_heads, hd, dec.to(torch.int32), now,
                                      oob))
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_int8_case(
            torch, rnd, es, g, f"decode 8 rows, context <= 512, prefix 64, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 511, (B,), generator=g, device=dev).to(
                torch.int32), [1] * B, False, Lp=64))
    # the additive masks (A4b): K4's and K4-int8's masked instances at
    # decode (tgt_mask [8, H, 1, 512]) and at the single step's mixed batch
    # (its prefill rows under mask [8, 1, 256, 512], the others under
    # tgt_mask), 32 / 32 and 32 / 8 heads
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        for what, dec, now in (
                ("decode 8 rows, context <= 512",
                 torch.randint(64, 511, (B,), generator=g, device=dev),
                 [1] * B),
                ("mixed 255 tokens",
                 torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
                 [1, 100, 16, 1, 60, 0, 1, 76])):
            label = f"{what}, masks, {heads} heads / {kv_heads} KV"
            cases.append(_paged_case(torch, rnd, es, g, label, heads,
                                     kv_heads, D, dec.to(torch.int32), now,
                                     masked=True))
            cases.append(_paged_int8_case(torch, rnd, es, g, label, heads,
                                          kv_heads, D, dec.to(torch.int32),
                                          now, False, masked=True))
    return cases


def _generation_cases(torch, rnd, es, g, dtype):
    """B1, B2 and B3 at the generation path's shapes (Llama-2-7B heads,
    32 x 128, and a GQA split 32 / 8)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    dev = "cuda"
    cases = []
    # B1: (label, B, Sq, Sk, H, KVH, D, causal, q_off on the device | None)
    for label, B, Sq, Sk, H, KVH, D, causal, off in (
            ("causal [2, 1024, 32, 128]", 2, 1024, 1024, 32, 32, 128, True,
             None),
            ("GQA causal q [1, 512, 32, 128], k/v 8 heads", 1, 512, 512, 32,
             8, 128, True, None),
            ("growing-cache decode Sq 1, Sk 700", 4, 1, 700, 32, 32, 128,
             True, None),
            ("static prefill Sq 128 over a 512-row ring, q_off 0", 8, 128,
             512, 32, 32, 128, True, 0),
            ("static prefill Sq 128 over a 512-row ring, q_off 200", 8, 128,
             512, 32, 32, 128, True, 200),
            ("non-causal [1, 256, 8, 64]", 1, 256, 256, 8, 8, 64, False,
             None),
            ("causal head_dim 256 [1, 256, 8, 256]", 1, 256, 256, 8, 8, 256,
             True, None),
            ("causal Sq 96 > Sk 64: rows 0-31 see no key", 1, 96, 64, 8, 8,
             128, True, None)):
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
        off_t = (None if off is None else
                 torch.full((), off, dtype=torch.int32, device=dev))
        off_i = Sk - Sq if off is None else off
        scale = 1.0 / D ** 0.5
        # visible (row, key) pairs: the bytes and operations this run needs
        vis = (sum(min(Sk, max(0, i + off_i + 1)) for i in range(Sq))
               if causal else Sq * Sk)
        nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * es \
            + B * H * Sq * 4
        # rows that see no key have lse -1e30 on both sides: compare the
        # outputs alone there, or the tolerance would scale with 1e30
        pick = (lambda r: r[0]) if Sq > Sk else (lambda r: r)
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal, o=off_t, p=pick: p(
                fa.flash_attention_fused(q, k, v, c, None, o)),
            lambda q=q, k=k, v=v, c=causal, o=off_t, s=scale, p=pick: p(
                fa._plain_bshd(q, k, v, c, s, o)),
            _sdpa_b1(torch, q, k, v, causal, off_i), nbytes,
            4 * B * H * vis * D))
    # B2: one token per row against the ring, cols <= pos; greedy_decode's
    # shape (phase 5: 8 rows, 512-row ring, positions 128-160) and a single
    # user's long GQA generation (8 (row, KV head) pairs)
    for label, B, L, H, KVH, D, pos in (
            ("[8, L=512, 32, 128] pos 300", 8, 512, 32, 32, 128, 300),
            ("[8, L=4096, 32, 128] pos 4000", 8, 4096, 32, 32, 128, 4000),
            ("GQA 32 / 8 [8, L=512] pos 300", 8, 512, 32, 8, 128, 300),
            ("greedy_decode [8, L=512, 32, 128] pos 150", 8, 512, 32, 32,
             128, 150),
            ("GQA 32 / 8 [1, L=4096] pos 4000", 1, 4096, 32, 8, 128, 4000)):
        q, kb, vb = rnd(B, 1, H, D), rnd(B, L, KVH, D), rnd(B, L, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        _B2_PLANS[(label, str(dtype).split(".")[1])] = (
            da.decode_plan(B, L, H, KVH, D, dtype), (q, kb, vb, p))
        cases.append((
            "decode_attention", label,
            lambda q=q, kb=kb, vb=vb, p=p: da.decode_attention(q, kb, vb, p),
            lambda q=q, kb=kb, vb=vb, p=p: da.ref_decode_attention(
                q, kb, vb, p),
            _sdpa_b2(torch, q, kb, vb, pos),
            (2 * B * H * D + 2 * B * (pos + 1) * KVH * D) * es,
            4 * B * H * (pos + 1) * D))
    # B3: rows written into [8, 512, 32, 128] rings in place; at -3 the
    # start counts from the end (C7: row 509)
    for label, S, pos in (("1 row into [8, 512, 32, 128] at 300", 1, 300),
                          ("128 rows into [8, 512, 32, 128] at 200", 128,
                           200),
                          ("1 row into [8, 512, 32, 128] at -3 (row 509)",
                           1, -3)):
        cases.append(_b3_case(torch, rnd, es, label, 8, 512, 32, 128, S,
                              pos))
    # K2's ring mode (B3 folded in): greedy_decode's decode step and its
    # [8, 128] prefill over 512-row rings, a 32 / 8 split
    for label, S, Hk, pos in (
            ("greedy_decode step [8, 1, 32 / 32, 128] into [8, 512] rings "
             "at pos 150", 1, 32, 150),
            ("greedy_decode step [8, 1, 32 / 8, 128] into [8, 512] rings "
             "at pos 150", 1, 8, 150),
            ("prefill [8, 128, 32 / 32, 128] into [8, 512] rings at pos 0",
             128, 32, 0)):
        cases.append(_ring_case(torch, rnd, es, dtype, label, 8, S, 32, Hk,
                                128, 512, pos))
    return cases


def _b3_case(torch, rnd, es, label, B, L, KVH, D, S, pos):
    """One B3 case: the rings the kernel writes equal, bit for bit, the
    plain version's and those of index_copy_ at dynamic_update_slice's
    start (a negative pos counted from the end, then clamped to [0, L - S];
    the library call, timed)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    kb, vb = rnd(B, L, KVH, D), rnd(B, L, KVH, D)
    (k1, v1), (k2, v2), (k3, v3) = ((kb.clone(), vb.clone())
                                    for _ in range(3))
    kn, vn = rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    p = torch.full((), pos, dtype=torch.int32, device="cuda")
    start = max(0, min(pos + L if pos < 0 else pos, L - S))
    rows = torch.arange(start, start + S, device="cuda")

    def kern():
        return da.kv_ring_write(k1, v1, kn, vn, p)

    def plain():
        return da._ref_ring_write(k2, v2, kn, vn, p)

    def lib():
        return k3.index_copy_(1, rows, kn), v3.index_copy_(1, rows, vn)

    def check():
        got, ref, dus = kern(), plain(), lib()
        torch.cuda.synchronize()
        parts = [(f"{n} ring{w}", _err(torch, a, b), 0.0)
                 for w, pair in (("", ref), (" vs the start's rows", dus))
                 for n, a, b in zip("kv", got, pair)]
        return max(e for _, e, _ in parts), parts

    return ("kv_ring_write", label, kern, plain, lib,
            4 * B * S * KVH * D * es, 0, check)


def _ring_case(torch, rnd, es, dtype, label, B, S, H, KVH, D, L, pos,
               smax=4096):
    """One case of K2's ring mode: q rotated, k rotated into kbuf and v
    copied into vbuf at the ring rows of the device's pos, one launch.
    Held to the plain composition (_rope_ref then _ref_ring_write, the
    `_tol` of phase 2 for each output) and, bit for bit, to the two
    launches it replaces (rope_fused then kv_ring_write); no one PyTorch
    call computes it."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import fused_ops as fo

    dname = str(dtype).split(".")[1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device="cuda") / D))
    fr = (torch.arange(smax, device="cuda")[:, None].double()
          * inv[None, :].double())
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    kb, vb = rnd(B, L, KVH, D), rnd(B, L, KVH, D)
    (k1, v1), (k2, v2), (k3, v3) = ((kb.clone(), vb.clone())
                                    for _ in range(3))
    p = torch.full((), pos, dtype=torch.int32, device="cuda")
    _K2_PLANS[(label, dname)] = fo.rope_plan(B, S, H, 2 * KVH, D, dtype,
                                             True)

    def kern():
        return fo.rope_ring_fused(q, k, v, tc, ts, k1, v1, p), k1, v1

    def plain():
        qr, kr = fo._rope_ref(q, k, *fo._window(tc, ts, S, p))
        da._ref_ring_write(k2, v2, kr, v, p)
        return qr, k2, v2

    def two_launches():
        qr, kr = fo.rope_fused(q, k, tc, ts, p)
        da.kv_ring_write(k3, v3, kr, v, p)
        return qr, k3, v3

    def check():
        got, ref, two = kern(), plain(), two_launches()
        torch.cuda.synchronize()
        parts = [(n, _err(torch, a, b), _tol(dname, b))
                 for n, a, b in zip(OUTPUTS["rope_ring"], got, ref)]
        parts.append(("elements off rope_fused + kv_ring_write", float(sum(
            int((a != b).sum()) for a, b in zip(got, two))), 0.0))
        return max(e for _, e, _ in parts[:3]), parts

    return ("rope_ring", label, kern, plain, None,
            (2 * B * S * (H + 2 * KVH) * D * es + 2 * S * (D // 2) * 4),
            6 * B * S * (H + KVH) * D // 2, check)


def _head_dim_cases(torch, rnd, es, g, dtype):
    """B1, B8, B2, B3, K4 and K2's ring mode at head dims 72 (a multiple of
    8: the tensor-core classes zero-padded), 100 (not one of 8: B1/B8 pad
    in the wrapper, the others read rows in pieces), 264 and 512 (past the
    tensor-core tiles: the SIMT instances), 516, 640 and 1024 (past 512:
    the wide instances, Queue C8), at 8 / 2 heads; SDPA at the same shape
    as the library call."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    dev = "cuda"
    cases = []
    dname = str(dtype).split(".")[1]
    for D in HEAD_DIMS:
        B, S, H, KVH = 2, 512, 8, 2
        q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
        scale = 1.0 / D ** 0.5
        vis = S * (S + 1) // 2
        label = f"causal head_dim {D} [{B}, {S}, {H} / {KVH}, {D}]"
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v: fa.flash_attention_fused(q, k, v, True),
            lambda q=q, k=k, v=v, s=scale: fa._plain_bshd(q, k, v, True, s,
                                                          None),
            _sdpa_b1(torch, q, k, v, True, 0),
            (2 * B * S * H * D + 2 * B * S * KVH * D) * es + B * H * S * 4,
            4 * B * H * vis * D))
        o, lse = fa.flash_attention_fused(q, k, v, True)
        go = rnd(B, S, H, D)
        cases.append((
            "flash_attention_bwd", label,
            lambda q=q, k=k, v=v, o=o, l=lse, go=go:
                fa.flash_attention_bwd_fused(q, k, v, o, l, go, True),
            lambda q=q, k=k, v=v, o=o, l=lse, go=go, s=scale:
                fa._plain_bwd_bshd(q, k, v, o, l, go, True, s),
            _sdpa_b8(torch, q, k, v, go, True),
            (4 * B * S * H * D + 4 * B * S * KVH * D) * es + B * H * S * 4,
            10 * B * H * vis * D))
        Bd, L, pos = 8, 512, 300
        q1, kb, vb = rnd(Bd, 1, H, D), rnd(Bd, L, KVH, D), rnd(Bd, L, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        label = f"head_dim {D} [{Bd}, L={L}, {H} / {KVH}, {D}] pos {pos}"
        _B2_PLANS[(label, dname)] = (
            da.decode_plan(Bd, L, H, KVH, D, dtype), (q1, kb, vb, p))
        cases.append((
            "decode_attention", label,
            lambda q=q1, kb=kb, vb=vb, p=p: da.decode_attention(q, kb, vb, p),
            lambda q=q1, kb=kb, vb=vb, p=p: da.ref_decode_attention(
                q, kb, vb, p),
            _sdpa_b2(torch, q1, kb, vb, pos),
            (2 * Bd * H * D + 2 * Bd * (pos + 1) * KVH * D) * es,
            4 * Bd * H * (pos + 1) * D))
        cases.append(_b3_case(
            torch, rnd, es, f"1 row into [8, 512, 8, {D}] at -3 (row 509)",
            8, 512, 8, D, 1, -3))
        cases.append(_paged_case(
            torch, rnd, es, g, f"decode 8 rows, 8 heads / 2 KV, head_dim {D}",
            H, KVH, D, torch.randint(64, 511, (8,), generator=g,
                                     device=dev).to(torch.int32), [1] * 8))
        cases.append(_ring_case(
            torch, rnd, es, dtype,
            f"[8, 1, 8 / 2, {D}] into [8, 512] rings at pos -3 (row 509)", 8,
            1, H, KVH, D, 512, -3))
    return cases


def _training_cases(torch, rnd, es, g, dtype):
    """The training path's kernels at its shapes (bench.py's honest
    geometry: batch 8 x seq 2048, hidden 2560, 20 heads of 128,
    intermediate 8192): K1-K3 and B1 forward, the rope backward (K2 with
    -sin), B6b, B8 and B9."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    dev = "cuda"
    N, E, I, S, H, D = 8 * 2048, 2560, 8192, 2048, 20, 128
    cases = []
    x, r, w = rnd(N, E), rnd(N, E), rnd(E)
    dname = str(dtype).split(".")[1]
    _K1_PLANS[(f"train [{N}, {E}]", dname)] = (
        fused_norm.rms_plan(N, E, dtype, True), (x, r, w))
    cases.append((
        "rms_norm_residual", f"train [{N}, {E}]",
        lambda x=x, r=r, w=w: fused_norm.rms_norm_residual_fused(
            x, r, w, 1e-6),
        lambda x=x, r=r, w=w: fused_norm._ref_rms_residual(x, r, w, 1e-6),
        None, (4 * N * E + E) * es, 5 * N * E))
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = torch.arange(S, device=dev)[:, None].double() * inv[None].double()
    cos, sin = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    q, k = rnd(8, S, H, D), rnd(8, S, H, D)
    for label in (f"train q, k [8, {S}, {H}, {D}]",
                  f"train gq, gk [8, {S}, {H}, {D}]"):
        _K2_PLANS[(label, dname)] = fused_ops.rope_plan(8, S, H, H, D,
                                                        dtype, True)
    rope_bytes = 4 * 8 * S * H * D * es + 2 * S * (D // 2) * 4
    cases.append((
        "rope", f"train q, k [8, {S}, {H}, {D}]",
        lambda q=q, k=k: fused_ops.rope_fused(q, k, cos, sin),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, sin), None,
        rope_bytes, 6 * 8 * S * 2 * H * D // 2))
    cases.append((
        "rope_bwd", f"train gq, gk [8, {S}, {H}, {D}]",
        lambda q=q, k=k: fused_ops.rope_bwd_fused(q, k, cos, sin),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, -sin), None,
        rope_bytes, 6 * 8 * S * 2 * H * D // 2))
    a, b, gg = rnd(N, I), rnd(N, I), rnd(N, I)
    cases.append((
        "swiglu", f"train [{N}, {I}]",
        lambda a=a, b=b: fused_ops.swiglu_fused(a, b),
        lambda a=a, b=b: fused_ops._swiglu_ref(a, b), None,
        3 * a.numel() * es, 5 * a.numel()))
    cases.append((
        "swiglu_bwd", f"[{N}, {I}]",
        lambda a=a, b=b, g=gg: fused_ops.swiglu_bwd_fused(a, b, g),
        lambda a=a, b=b, g=gg: fused_ops._swiglu_bwd_ref(a, b, g), None,
        5 * a.numel() * es, 12 * a.numel()))
    # B1 and B8: (label, B, Sq, Sk, H, KVH, D, causal)
    for label, B, Sq, Sk, Hq, KVH, Dh, causal in (
            (f"causal [8, {S}, {H}, {D}]", 8, S, S, H, H, D, True),
            ("GQA causal q [1, 512, 32, 128], k/v 8 heads", 1, 512, 512, 32,
             8, 128, True),
            ("causal Sq 256 < Sk 512 [2, 8 heads, 128]", 2, 256, 512, 8, 8,
             128, True),
            ("non-causal [1, 256, 8, 64]", 1, 256, 256, 8, 8, 64, False),
            (f"causal head_dim 256 [8, {S}, 10, 256] (bench.py headline)", 8,
             S, S, 10, 10, 256, True),
            ("causal Sq 96 > Sk 64: rows 0-31 see no key", 1, 96, 64, 8, 8,
             128, True)):
        q, kk, v = rnd(B, Sq, Hq, Dh), rnd(B, Sk, KVH, Dh), rnd(B, Sk, KVH,
                                                                Dh)
        scale = 1.0 / Dh ** 0.5
        off = Sk - Sq
        vis = (sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))
               if causal else Sq * Sk)
        if label.startswith("causal [") or "head_dim 256" in label:
            cases.append((
                "flash_attention", f"train {label}",
                lambda q=q, k=kk, v=v: fa.flash_attention_fused(
                    q, k, v, True),
                lambda q=q, k=kk, v=v, s=scale: fa._plain_bshd(
                    q, k, v, True, s, None),
                _sdpa_b1(torch, q, kk, v, True, 0),
                (2 * B * Sq * Hq * Dh + 2 * B * Sk * KVH * Dh) * es
                + B * Hq * Sq * 4, 4 * B * Hq * vis * Dh))
        o, lse = fa.flash_attention_fused(q, kk, v, causal)
        go = rnd(B, Sq, Hq, Dh)
        cases.append((
            "flash_attention_bwd", label,
            lambda q=q, k=kk, v=v, o=o, l=lse, go=go, c=causal:
                fa.flash_attention_bwd_fused(q, k, v, o, l, go, c),
            lambda q=q, k=kk, v=v, o=o, l=lse, go=go, c=causal, s=scale:
                fa._plain_bwd_bshd(q, k, v, o, l, go, c, s),
            _sdpa_b8(torch, q, kk, v, go, causal),
            # q, k, v, o, dO and lse read once; dq, dk, dv written once
            (4 * B * Sq * Hq * Dh + 4 * B * Sk * KVH * Dh) * es
            + B * Hq * Sq * 4,
            # S, dP, dQ, dK, dV: 10 D per visible pair
            10 * B * Hq * vis * Dh))
    cases += [_adamw_case(torch, rnd, es, dtype, shape)
              for shape in ((2560, 8192), (2560,))]
    return cases


def _predict_cases(torch, rnd, es, dtype):
    """B7 at the int8 predictor's shapes (BERT-base at [32, 128]: 4096
    token rows, hidden 768, FFN 3072, the 2-way head on the strided first
    token), an odd shape, and one decode-sized case off the path; B1
    non-causal at the classifier's heads."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    from paddle_tpu_torch.quantization import weight_quantize

    T, E, I, S, H = (BERT["batch"] * BERT["seq"], BERT["hidden"],
                     4 * BERT["hidden"], BERT["seq"], BERT["heads"])
    cases = []
    dname = str(dtype).split(".")[1]
    for label, x, K, N, bias in (
            (f"q/k/v/out [{T}, {E}] x [{E}, {E}]", rnd(T, E), E, E, False),
            (f"q/k/v/out [{T}, {E}] x [{E}, {E}] + bias", rnd(T, E), E, E,
             True),
            (f"linear1 [{T}, {E}] x [{E}, {I}]", rnd(T, E), E, I, False),
            (f"linear1 [{T}, {E}] x [{E}, {I}] + bias", rnd(T, E), E, I,
             True),
            (f"linear2 [{T}, {I}] x [{I}, {E}]", rnd(T, I), I, E, False),
            (f"head x[:, 0] [{BERT['batch']}, {E}] x [{E}, 2], rows "
             f"{S * E} apart", rnd(BERT["batch"], S, E)[:, 0], E, 2, False),
            (f"head x[:, 0] [{BERT['batch']}, {E}] x [{E}, 2], rows "
             f"{S * E} apart + bias", rnd(BERT["batch"], S, E)[:, 0], E, 2,
             True),
            ("odd [3, 100] x [100, 130]", rnd(3, 100), 100, 130, False),
            ("odd, 16-byte copies with tails: [64, 100 of 104] x [100, 144]",
             rnd(64, 104)[:, :100], 100, 144, False),
            ("off the path: decode-sized [8, 4096] x [4096, 11008]",
             rnd(8, 4096), 4096, 11008, False)):
        qw, sc = weight_quantize(rnd(K, N, dt=torch.float32) * 0.05)
        b = rnd(N) if bias else None
        M = x.shape[0]
        w = qw.to(dtype) * sc.to(dtype)
        _B7_PLANS[(label, dname)] = (im.int8_plan(M, N, K, dtype),
                                     (x, qw, sc, b), lambda x=x, w=w: x @ w)
        cases.append((
            "int8_matmul", label,
            lambda x=x, qw=qw, sc=sc, b=b: im.int8_linear(x, qw, sc, b),
            lambda x=x, qw=qw, sc=sc, b=b: im._int8_matmul_ref(x, qw, sc, b),
            None if bias else _int8pack_lib(torch, x, qw, sc),
            # x, qw, scale (and bias) read once, out written once
            M * K * es + K * N + 4 * N + M * N * es + (N * es if bias else 0),
            2 * M * N * K))
    B, D = BERT["batch"], E // H
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    cases.append((
        "flash_attention", f"predict non-causal [{B}, {S}, {H}, {D}]",
        lambda: fa.flash_attention_fused(q, k, v, False),
        lambda: fa._plain_bshd(q, k, v, False, 1.0 / D ** 0.5, None),
        _sdpa_b1(torch, q, k, v, False, 0),
        4 * B * S * H * D * es + B * H * S * 4, 4 * B * H * S * S * D))
    return cases


def _int8pack_lib(torch, x, qw, scale):
    """torch._weight_int8pack_mm (weight [N, K], scales in x's dtype) on
    copies made here, or None where this PyTorch has no CUDA version."""
    xc, wt, sc = x.contiguous(), qw.t().contiguous(), scale.to(x.dtype)
    try:
        got = torch._weight_int8pack_mm(xc, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        print(f"library torch._weight_int8pack_mm: none ({str(e)[:120]})")
        return None
    ref = ((xc.float() @ qw.float()) * scale).to(x.dtype)
    print(f"library torch._weight_int8pack_mm {tuple(xc.shape)} x "
          f"{tuple(qw.shape)}: max abs diff from the plain version "
          f"{float((got.float() - ref.float()).abs().max()):.3e}")
    return lambda: torch._weight_int8pack_mm(xc, wt, sc)


def _sdpa_b8(torch, q, k, v, go, causal):
    """The backward of F.scaled_dot_product_attention alone: its forward
    runs here, once, and each call is torch.autograd.grad of that output
    (graph retained) on [B, H, S, D] copies; causal with Sq != Sk takes
    the explicit bottom-right boolean mask (with Sq > Sk its first rows
    see no key: SDPA gives them NaN, which the timing does not read)."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = go.transpose(1, 2).contiguous()
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if causal and Sq != Sk:
        rows = torch.arange(Sq, device=q.device)[:, None] + Sk - Sq
        kw["attn_mask"] = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        kw["is_causal"] = causal
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def _adamw_case(torch, rnd, es, dtype, shape):
    """B9 on one parameter (bf16 or f32, the case's type) with float32
    master and moments.  The check runs three steps (t = 1, 2, 3) on the
    kernel and on the plain version from one state, and holds each output
    to its own limit: the master within 1e-3 of the plain version's largest
    change over the steps (a missing or stale step is off by a whole
    change), m and v within 1e-4 of their own largest value, and a bf16
    parameter within one bf16 ulp of its own value everywhere and equal to
    the plain rounding in all but 1e-3 of the elements (the two masters may
    straddle a rounding midpoint; a skipped, stale or truncating store
    differs almost everywhere).  The times are of one step.  Library:
    torch.optim.AdamW(fused=True) over the float32 master, which writes no
    low-precision copy."""
    from paddle_tpu_torch.ops.hopper import fused_adamw as fad

    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    w0 = rnd(*shape, dt=torch.float32) * 0.02
    grads = [rnd(*shape) * 0.01 for _ in range(3)]

    def state():
        w = w0.clone()
        p = w.to(dtype) if dtype != torch.float32 else w
        return [p, w, torch.zeros_like(w), torch.zeros_like(w),
                torch.ones(1, device="cuda")]

    def run(fn, st, steps):
        for i in range(steps):
            st[4].fill_(i + 1)
            fn(*st[:4], grads[i], 1e-4, st[4], **kw)
        return tuple(st[:4])

    def check():
        kp, kw, km, kv = run(fad.fused_adamw, state(), 3)
        rp, rw, rm, rv = run(fad._fused_adamw_ref, state(), 3)
        torch.cuda.synchronize()
        parts = [("master", _err(torch, kw, rw),
                  1e-3 * _scale(rw - w0) + 1e-12),
                 ("m", _err(torch, km, rm), 1e-4 * _scale(rm) + 1e-12),
                 ("v", _err(torch, kv, rv), 1e-4 * _scale(rv) + 1e-12)]
        err = max(e for _, e, _ in parts)
        if not own:
            rf, d = rp.float(), (kp.float() - rp.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                rf.abs().clamp_min(2.0 ** -126))) - 7)
            parts += [("p / own bf16 ulp", float((d / ulp).max()), 1.0),
                      ("p share off the plain rounding",
                       float((d > 0).float().mean()), 1e-3)]
            err = max(err, float(d.max()))
        return err, parts

    ks, ps = state(), state()
    lw = w0.clone().requires_grad_()
    lw.grad = grads[0].float()
    lib = torch.optim.AdamW([lw], lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=True)
    n = w0.numel()
    own = dtype == torch.float32
    return ("fused_adamw", f"{list(shape)} x 3 steps",
            lambda: fad.fused_adamw(*ks[:4], grads[0], 1e-4, ks[4], **kw),
            lambda: fad._fused_adamw_ref(*ps[:4], grads[0], 1e-4, ps[4],
                                         **kw),
            lib.step,
            # g read, w/m/v read and written, p written (no p: w is p)
            n * (es + 24 + (0 if own else es)), 15 * n, check)


def _sdpa_b1(torch, q, k, v, causal, off):
    """F.scaled_dot_product_attention on [B, H, S, D] copies (transposes
    made here, not timed): is_causal when Sq == Sk and the offset is 0,
    else a boolean mask of cols <= row + off."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if causal and not (Sq == Sk and off == 0):
        rows = torch.arange(Sq, device=q.device)[:, None] + off
        kw["attn_mask"] = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def _sdpa_b2(torch, q, kb, vb, pos):
    """SDPA of the [B, H, 1, D] query over ring[:, :pos + 1] (sliced and
    transposed here, not timed)."""
    F = torch.nn.functional
    qt = q.transpose(1, 2).contiguous()
    kt = kb[:, :pos + 1].transpose(1, 2).contiguous()
    vt = vb[:, :pos + 1].transpose(1, 2).contiguous()
    kw = {"enable_gqa": True} if kb.shape[2] != q.shape[2] else {}
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


# K4's plan, arguments and pre-caches for each case, by (label, dtype
# name): the plan is printed beside its time, the arguments serve the
# --k4-sweep
_K4_PLANS = {}
_K4_ARGS = {}
_K4_PRE = {}
# B2's (plan, arguments) for each case, by (label, dtype name): the plan is
# printed beside its time, the arguments serve the --b2-sweep
_B2_PLANS = {}
# B7's (plan, arguments, dense yardstick) for each case, by (label, dtype
# name): the plan and the time of torch.matmul with the dequantized weight
# are printed beside its time, the arguments serve the --b7-sweep
_B7_PLANS = {}
# K1's (plan, arguments) and K2's plan for each case, by (label, dtype
# name): the plan is printed beside its time, K1's arguments serve the
# --k1-sweep
_K1_PLANS = {}
_K2_PLANS = {}


def _serving_masks(torch, g, H, dec, now, mq, L):
    """Additive masks of a serving step (blha_attention's): ``mask`` [B, 1,
    mq, L] on the rows in prefill (seq_lens_encoder = now where dec is 0,
    the rows that start their prompt), ``tgt_mask`` [B, H, 1, L] on the
    others, seeded values in [-2, 0] (a learned or positional bias)."""
    B = now.shape[0]
    dev = now.device
    enc = torch.where(dec == 0, now, 0).to(torch.int32)

    def bias(*shape):
        return -2 * torch.rand(*shape, generator=g, device=dev)

    return dict(mask=bias(B, 1, mq, L), tgt_mask=bias(B, H, 1, L),
                seq_lens_encoder=enc)


def _mask_bytes(masks, dec, live, Lp, ctx):
    """The bytes of the masks a call reads: for each attending token (local
    index s of its row) and each head of the row's mask, its visible keys'
    entries inside the mask (s below its rows, keys below its columns),
    float32."""
    enc = masks["seq_lens_encoder"].tolist()
    n = 0
    for b, (d, t) in enumerate(zip(dec.tolist(), live)):
        m = masks["mask"] if enc[b] > 0 else masks["tgt_mask"]
        if m is None:
            continue
        _, heads, sq, lm = m.shape
        for s in range(min(t, sq)):
            n += heads * min(Lp + min(d + s + 1, ctx), lm)
    return 4 * n


def _paged_case(torch, rnd, es, g, label, H, KV, D, dec, now, mq=None,
                T=None, P=32, NB=256, Lp=0, masked=False):
    """One K4 case: a decode batch (one token per row, T = B), a mixed
    batch in the single-step program's [256] buffer (max_q_len 256), or
    the given ``mq`` and ``T`` (the mixed loop's program); ``Lp`` > 0
    puts pre-caches [B, KV, Lp, D] in front of every row's context;
    ``masked`` adds ``_serving_masks`` (the masked instances)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    bs, B = 16, len(now)
    dev = "cuda"
    kc, vc = rnd(NB, KV, bs, D), rnd(NB, KV, bs, D)
    pre = (dict(pre_key=rnd(B, KV, Lp, D), pre_value=rnd(B, KV, Lp, D))
           if Lp else {})
    bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(B, P).to(
        torch.int32)
    now = torch.tensor(now, dtype=torch.int32, device=dev)
    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(now, 0)
    decode = int(now.max()) == 1
    if mq is None:
        T = int(cu[-1]) if decode else 256
        mq = 1 if decode else 256
    if masked:
        pre.update(_serving_masks(torch, g, H, dec, now, mq, Lp + P * bs))
    q = rnd(T, H, D)
    dname = str(q.dtype).split(".")[1]
    _K4_PLANS[(label, dname)] = pa.paged_plan(T, B, mq, P, bs, H, KV, D,
                                              q.dtype, pre_len=Lp)
    _K4_ARGS[(label, dname)] = (q, kc, vc, dec, now, cu, bt, mq)
    _K4_PRE[(label, dname)] = pre
    # the tokens that attend: a row's first min(now, max_q_len) (the rest,
    # and the padding past cu[B], are written as zeros, their q unread)
    live = [min(n, mq) for n in now.tolist()]
    # bytes: the q of the tokens that attend, the whole output, and each
    # row's visible K/V once, its prefix included (none for a row with no
    # token that attends)
    keys = sum(Lp + min(d + n, P * bs)
               for d, n in zip(dec.tolist(), live) if n)
    nbytes = ((sum(live) + T) * H * D + 2 * keys * KV * D) * es
    if masked:
        nbytes += _mask_bytes(pre, dec, live, Lp, P * bs)
    # QK^T and PV, 2 operations per multiply-add, over each attending
    # token's visible keys (the whole prefix, then its paged keys)
    vis = sum(Lp + min(d + j + 1, P * bs)
              for d, n in zip(dec.tolist(), live) for j in range(n))
    ops = 4 * vis * H * D
    return ("paged_attention", label,
            lambda: pa.paged_attention(q, kc, vc, dec, now, cu, bt, mq,
                                       **pre),
            lambda: pa._paged_attention_ref(q, kc, vc, dec, now, cu, bt, mq,
                                            **pre),
            _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq, **pre),
            nbytes, ops)


# K4-int8's plan, the K4 call over a cache of q's dtype at the same shape
# and the call's arguments (the SIMT instance forced beside the tensor
# cores), for each case, by (label, dtype name): printed
# beside its time
_K4I_PLANS = {}
_K4I_K4 = {}
_K4I_ARGS = {}


def _paged_int8_case(torch, rnd, es, g, label, H, KV, D, dec, now, oob,
                     P=32, NB=256, Lp=0, masked=False):
    """One K4-int8 case over uint8 pools of random codes and random
    per-(row, KV head) scales: a decode batch (T = B) or a mixed batch in
    the single step's [256] buffer (max_q_len 256); ``oob``: row 0's first
    block-table entry, visible, is outside the pool (uint8 0); ``Lp`` > 0
    puts full-precision pre-caches [B, KV, Lp, D] in front of every
    row's context; ``masked`` adds ``_serving_masks``."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    bs, B = 16, len(now)
    dev = "cuda"

    def codes():
        return torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                             device=dev, dtype=torch.uint8)

    kc, vc = codes(), codes()
    bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(B, P).to(
        torch.int32)
    if oob:
        bt[0, 0] = -1
    now = torch.tensor(now, dtype=torch.int32, device=dev)
    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(now, 0)
    decode = int(now.max()) == 1
    T = int(cu[-1]) if decode else 256
    mq = 1 if decode else 256
    q, k, v = rnd(T, H, D), rnd(T, KV, D), rnd(T, KV, D)
    kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    pre = (dict(pre_key=rnd(B, KV, Lp, D), pre_value=rnd(B, KV, Lp, D))
           if Lp else {})
    if masked:
        pre.update(_serving_masks(torch, g, H, dec, now, mq, Lp + P * bs))
    dname = str(q.dtype).split(".")[1]
    _K4I_PLANS[(label, dname)] = pa.paged_int8_plan(T, B, mq, P, bs, H, KV,
                                                    D, q.dtype, pre_len=Lp)
    kcf, vcf = rnd(NB, KV, bs, D), rnd(NB, KV, bs, D)
    _K4I_K4[(label, dname)] = lambda: pa.paged_attention(
        q, kcf, vcf, dec, now, cu, bt, mq, **pre)
    ctx = P * bs
    live = [min(n, mq) for n in now.tolist()]
    rows = [(d, n) for d, n in zip(dec.tolist(), live) if n]
    # bytes: the q of the tokens that attend, the whole output, each row's
    # cached keys and values (one byte an element) and its fresh and
    # prefix ones (of q's dtype) once, the scales; operations: QK^T and PV
    # over each attending token's visible keys, and the dequantization (a
    # subtract and a multiply) of every cached element read
    cached = sum(min(d, ctx) for d, _ in rows)
    fresh = sum(Lp + min(d + n, ctx) - min(d, ctx) for d, n in rows)
    nbytes = ((sum(live) + T) * H * D * es + 2 * cached * KV * D
              + 2 * fresh * KV * D * es + 2 * B * KV * 4)
    if masked:
        nbytes += _mask_bytes(pre, dec, live, Lp, ctx)
    vis = sum(Lp + min(d + j + 1, ctx) for d, n in rows for j in range(n))
    ops = 4 * vis * H * D + 4 * cached * KV * D
    args = (q, k, v, kc, vc, kd, vd, dec, now, cu, bt, mq)
    _K4I_ARGS[(label, dname)] = (args, pre)
    return ("paged_attention_int8", label,
            lambda: pa.paged_attention_int8(*args, **pre),
            lambda: pa._paged_attention_int8_ref(*args, **pre), None, nbytes,
            ops)


def _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq, pre_key=None,
               pre_value=None, **masks):
    """F.scaled_dot_product_attention over the gathered, padded context,
    after the pre-caches where given (the library yardstick for K4; timed
    alone, gather and concatenation excluded); with ``masks`` (mask,
    tgt_mask, seq_lens_encoder) a float attn_mask: the masks' term on the
    visible keys, -inf elsewhere (made before the timing)."""
    from paddle_tpu_torch.ops.hopper.paged_attention import (
        _mask_bias,
        paged_gather_kv,
    )

    B = bt.shape[0]
    H, D = q.shape[1], q.shape[2]
    S = int(now.max())
    k_all = paged_gather_kv(kc, bt)              # [B, KV, L, D]
    v_all = paged_gather_kv(vc, bt)
    Lp = 0
    if pre_key is not None:
        Lp = pre_key.shape[2]
        k_all = torch.cat([pre_key, k_all], 2)
        v_all = torch.cat([pre_value, v_all], 2)
    L = k_all.shape[2]
    qp = torch.zeros(B, H, S, D, dtype=q.dtype, device=q.device)
    for b in range(B):
        n = int(now[b])
        if n:
            qp[b, :, :n] = q[int(cu[b]):int(cu[b]) + n].transpose(0, 1)
    qpos = dec.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :] - Lp
            <= qpos[:, :, None])[:, None]        # [B, 1, S, L]
    if masks:
        bias = _mask_bias((masks["mask"], masks["tgt_mask"],
                           masks["seq_lens_encoder"], now), H, S, L)
        mask = torch.where(mask, bias, float("-inf")).to(q.dtype)
    F = torch.nn.functional
    gqa = {"enable_gqa": True} if k_all.shape[1] != H else {}
    return lambda: F.scaled_dot_product_attention(
        qp, k_all, v_all, attn_mask=mask, **gqa)


def kernels_vs_plain(torch, iters=20, k4_sweep=False, b2_sweep=False,
                     b7_sweep=False, k1_sweep=False):
    """Check every case in both types; time it; return the rows of the
    kernels line (bfloat16, the type the paths run in).  ``k4_sweep`` also
    times each K4 case under other plans (``_paged_sweep``), ``b2_sweep``
    each B2 case (``_decode_sweep``), ``b7_sweep`` each B7 case
    (``_int8_sweep``), ``k1_sweep`` each K1 case (``_norm_sweep``)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    timer = Timer(torch, iters)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name, label, kern, plain, lib, nbytes, ops, *check in \
                kernel_cases(torch, dtype):
            # a case may bring its own check (several steps from one state,
            # a limit for each output): (max abs error, [(output, value,
            # limit)])
            if check:
                err, parts = check[0]()
            else:
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                err = _err(torch, got, ref)
                # several outputs (B1's out and lse, B8's dq, dk, dv, two
                # rings): each is held to its own scale, so a small output
                # beside a large one gets a limit of its own size
                if isinstance(ref, tuple):
                    names = OUTPUTS.get(name) or [f"output {i}"
                                                  for i in range(len(ref))]
                    parts = [(n, _err(torch, a, b), _tol(dname, b))
                             for n, a, b in zip(names, got, ref)]
                else:
                    parts = [("", err, _tol(dname, ref))]
            tol = (parts[0][2] if len(parts) == 1
                   else {lab: lim for lab, _, lim in parts})
            ms, plain_ms = timer(kern), timer(plain)
            lib_ms = timer(lib) if lib is not None else None
            bound_ms, bound_by = _bound(nbytes, ops, dname)
            limits = " ".join(f"{lab + ' ' if lab else ''}{val:.3e} "
                              f"tol {lim:.3e}" for lab, val, lim in parts)
            print(f"kernel {name} {dname} {label}: max_abs_err {err:.3e} "
                  f"[{limits}] ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" bound_ms {bound_ms:.4f} ({bound_by}) TFLOP/s "
                  f"{ops / ms / 1e9:.1f} of_bound {bound_ms / ms:.3f}",
                  flush=True)
            plan = _K4_PLANS.get((label, dname)) if name == \
                "paged_attention" else None
            if plan is not None:
                print(f"k4 {dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; qt {plan.qt} kt "
                      f"{plan.kt} stages {plan.stages} splits {plan.splits} "
                      f"chunk {plan.chunk} blocks {plan.blocks} smem "
                      f"{plan.smem}", flush=True)
            if name == "paged_attention_int8":
                p8 = _K4I_PLANS[(label, dname)]
                simt = ""
                if p8.tc:   # the SIMT instance forced at the same shape
                    a8, pre8 = _K4I_ARGS[(label, dname)]
                    s_ms = timer(lambda: pa._launch_int8(*a8, tc=False,
                                                         **pre8))
                    simt = (f"; SIMT forced {s_ms:.4f} ms (tensor cores "
                            f"{'faster' if ms < s_ms else 'NOT faster'})")
                print(f"k4-int8 {dname} {label}: {nbytes / ms / 1e6:.1f} "
                      f"GB/s, {bound_ms / ms:.3f} of the bound; "
                      f"{'tensor cores' if p8.tc else 'SIMT'} qt {p8.qt} "
                      f"kt {p8.kt} splits {p8.splits} blocks {p8.blocks} "
                      f"smem {p8.smem}{simt}; K4 over a {dname} cache at the "
                      f"same shape {timer(_K4I_K4[(label, dname)]):.4f} ms "
                      "(informative)", flush=True)
            if name == "int8_matmul":
                b7, _, dense = _B7_PLANS[(label, dname)]
                print(f"b7 {dname} {label}: {ops / ms / 1e9:.1f} TFLOP/s, "
                      f"{bound_ms / ms:.3f} of the bound; kind {b7.kind} "
                      f"tile {b7.tile} rows {b7.rows} splits {b7.splits} "
                      f"blocks {b7.blocks} smem {b7.smem}; dense yardstick "
                      f"torch.matmul with the dequantized {dname} weight "
                      f"{timer(dense):.4f} ms (informative)", flush=True)
            k12 = (_K1_PLANS[(label, dname)][0] if name.startswith("rms")
                   else _K2_PLANS.get((label, dname)))
            if k12 is not None:
                print(f"{'k1' if name.startswith('rms') else 'k2'} {name} "
                      f"{dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; {k12}", flush=True)
            if name == "decode_attention":
                b2 = _B2_PLANS[(label, dname)][0]
                print(f"b2 {dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; tc {b2.tc} rows "
                      f"{b2.rows} kt {b2.kt} splits {b2.splits} blocks "
                      f"{b2.blocks} smem {b2.smem}", flush=True)
            for lab, val, lim in parts:
                if not val <= lim:
                    raise AssertionError(
                        f"{name} {dname} {label}: kernel and plain differ "
                        f"{'in ' + lab + ' ' if lab else ''}by {val} > {lim}")
            if plan is not None and k4_sweep:
                _paged_sweep(torch, timer, label, dname)
            if name == "decode_attention" and b2_sweep:
                _decode_sweep(torch, timer, label, dname)
            if name == "int8_matmul" and b7_sweep and dname == "bfloat16":
                _int8_sweep(torch, timer, label, dname)
            if name.startswith("rms") and k1_sweep and dname == "bfloat16":
                _norm_sweep(torch, timer, name, label, dname)
            if dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, shape=label, dtype=dname, route="cuda",
                    source=SOURCES[name], replaces=REPLACES[name],
                    max_abs_err=err, max_err=err, tol=tol, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms))
    _refusals(torch)
    _norm_rope_edges(torch)
    _rope_sign_bits(torch)
    _rope_one_launch(torch)
    _paged_edges(torch)
    _paged_int8_edges(torch)
    _pre_edges(torch)
    _mask_edges(torch)
    _decode_edges(torch)
    _int8_edges(torch)
    _flash_tiles(torch)
    return rows


def _norm_sweep(torch, timer, name, label, dname):
    """Informative, for rms_plan's rules (``--k1-sweep``): one K1 case
    timed under every packs-a-thread instance at 32-1024 threads a row."""
    from paddle_tpu_torch.ops.hopper import fused_norm

    base, (x, r, w) = _K1_PLANS[(label, dname)]
    fn = (fused_norm.rms_norm_residual_fused if name.endswith("residual")
          else fused_norm.rms_norm_fused)
    r = r if name.endswith("residual") else None
    n, h = x.shape
    out = []
    for per in fused_norm.PERS:
        for tpr in (None, 32, 64, 128, 256, 512, 1024):
            kw = dict(per=per, tpr=tpr)
            try:
                plan = fused_norm.rms_plan(n, h, x.dtype,
                                           x.data_ptr() % 16 == 0, **kw)
            except ValueError:
                continue
            if tpr is not None and plan.tpr == base.tpr and \
                    plan.per == base.per:
                continue
            ms = timer(lambda kw=kw: fused_norm._launch(fn, x, r, w, 1e-6,
                                                        **kw))
            out.append((ms, f"p{plan.per}/t{plan.tpr}/r{plan.rows}"
                        + ("/wide" if plan.wide else "")))
    out.sort()
    print(f"k1 sweep {name} {dname} {label} (plan p{base.per}/t{base.tpr}/"
          f"r{base.rows}): " + ", ".join(f"{p} {ms:.4f}" for ms, p in
                                         out[:12])
          + f" ms (fastest 12 of {len(out)})", flush=True)


def _norm_rope_edges(torch):
    """K1 and K2 against their plain versions (the `_tol` of phase 2) in
    bfloat16 and float32 under every plan their instances take (forced).
    K1: rows of 2, 64, 4096, 4100 (no 16-byte packs), 2560, 16384, 32768
    and 65536 (past the registers: the rest of the row read twice), with
    and without the residual, aligned and at an odd storage offset; each
    packs-a-thread instance at its own threads and at 32 a row, both
    bodies.  K2: D 128, 64, 72 (D / 2 % 8 != 0) and 2, q and k as the
    columns of a packed qkv buffer, with and without the device offset
    (at 0, inside, and past Smax - S), both bodies."""
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(41)
    dev = "cuda"
    n_k1 = n_k2 = worst = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

        for n, h in ((3, 2), (5, 64), (7, 4096), (6, 4100), (33, 2560),
                     (2, 16384), (2, 32768), (1, 65536)):
            for odd in (False, True):
                if odd:
                    x, r = (rnd(n * h + 1)[1:].view(n, h) for _ in range(2))
                else:
                    x, r = rnd(n, h), rnd(n, h)
                w = rnd(h)
                refs = {None: fused_norm._ref_rms(x, w, 1e-6),
                        "res": fused_norm._ref_rms_residual(x, r, w, 1e-6)}
                for vec in (True, False):
                    for per in fused_norm.PERS:
                        for tpr in (None, 32):
                            kw = dict(vec=vec, per=per, tpr=tpr)
                            try:
                                plan = fused_norm.rms_plan(n, h, dtype,
                                                           not odd, **kw)
                            except ValueError:   # not an instance's plan
                                continue
                            for res, ref in refs.items():
                                fn = (fused_norm.rms_norm_residual_fused
                                      if res else fused_norm.rms_norm_fused)
                                got = fused_norm._launch(
                                    fn, x, r if res else None, w, 1e-6,
                                    **kw)
                                got = got if res else got[0]
                                for a, b in zip(got if res else (got,),
                                                ref if res else (ref,)):
                                    err, tol = _err(torch, a, b), _tol(
                                        dname, b)
                                    worst = max(worst, err / tol)
                                    if not err <= tol:
                                        raise AssertionError(
                                            f"K1 edge {dname} [{n}, {h}] "
                                            f"odd {odd} residual {bool(res)}"
                                            f" {plan}: kernel and plain "
                                            f"differ by {err} > {tol}")
                                n_k1 += 1
        inv = 1.0 / (10000.0 ** (torch.arange(0, 128, 2, device=dev) / 128))
        for B, S, H, KVH, D in ((2, 3, 4, 2, 128), (1, 5, 8, 8, 64),
                                (3, 2, 4, 1, 72), (2, 4, 2, 2, 2)):
            half = D // 2
            fr = (torch.arange(64, device=dev)[:, None].double()
                  * inv[None, :half].double())
            tc, ts = fr.cos().float().contiguous(), fr.sin().float()\
                .contiguous()
            qkv = rnd(B, S, (H + 2 * KVH) * D)
            q = qkv[..., :H * D].view(B, S, H, D)
            k = qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D)
            for off in (None, 0, 17, 63):
                o = (None if off is None else
                     torch.full((), off, dtype=torch.int64, device=dev))
                c, s = ((tc[:S], ts[:S]) if o is None else (tc, ts))
                ref = fused_ops._rope_ref(
                    q, k, *fused_ops._window(c, s, S, o))
                for vec in (True, False):
                    try:
                        plan = fused_ops.rope_plan(B, S, H, KVH, D, dtype,
                                                   True, vec=vec)
                    except ValueError:
                        continue
                    got = fused_ops._rope_launch(fused_ops.rope_fused, q, k,
                                                 c, s, o, vec=vec)
                    for a, b in zip(got, ref):
                        err, tol = _err(torch, a, b), _tol(dname, b)
                        worst = max(worst, err / tol)
                        if not err <= tol:
                            raise AssertionError(
                                f"K2 edge {dname} [{B}, {S}, {H} / {KVH}, "
                                f"{D}] offset {off} {plan}: kernel and "
                                f"plain differ by {err} > {tol}")
                    n_k2 += 1
    torch.cuda.synchronize()
    print(f"k1/k2 edges: {n_k1} K1 plans and {n_k2} K2 plans agree with "
          f"the plain versions (largest error {worst:.3f} of its "
          "tolerance)")


def _rope_sign_bits(torch):
    """The rope backward's sign flag gives the bits of K2 launched with an
    explicit -sin table, in both types and both bodies, at training's
    [8, 2048, 20, 128] and with generation's device offset."""
    from paddle_tpu_torch.ops.hopper import fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(43)
    dev, n = "cuda", 0
    D = 128
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = torch.arange(4096, device=dev)[:, None].double() * inv[None].double()
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, KVH, off in ((8, 2048, 20, 20, None),
                                  (8, 1, 32, 8, 150)):
            gq = torch.randn(B, S, H, D, generator=g, device=dev, dtype=dtype)
            gk = torch.randn(B, S, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            o = (None if off is None else
                 torch.full((), off, dtype=torch.int32, device=dev))
            c, s = (tc[:S], ts[:S]) if o is None else (tc, ts)
            for vec in (True, False):
                flag = fused_ops._rope_launch(fused_ops.rope_bwd_fused, gq,
                                              gk, c, s, o, sign=-1.0, vec=vec)
                table = fused_ops._rope_launch(fused_ops.rope_fused, gq, gk,
                                               c, -s, o, vec=vec)
                if not all(torch.equal(a, b) for a, b in zip(flag, table)):
                    raise AssertionError(
                        f"K2 sign flag {dtype} [{B}, {S}, {H} / {KVH}] "
                        f"vec {vec}: not the bits of the -sin table")
                n += 1
    print(f"k2 sign flag: {n} backward launches give the bits of K2 with an "
          "explicit -sin table")


def _dispatches(torch, fn):
    """The PyTorch operators ``fn()`` dispatches under no_grad, by name (a
    ctypes kernel launch dispatches none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class _Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), _Log():
        fn()
    torch.cuda.synchronize()
    return ops


def _rope_one_launch(torch):
    """apply_rotary_pos_emb with the ring's pos on the device is one K2
    launch and dispatches nothing to PyTorch but the outputs' allocations
    (the window's clamp, arange, add and gathers were six launches)."""
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    from paddle_tpu_torch.ops.hopper import fused_ops

    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(8, 1, 32, 128, device=dev, dtype=dt)
    k = torch.randn(8, 1, 32, 128, device=dev, dtype=dt)
    tc = torch.randn(4096, 64, device=dev)
    pos = torch.full((), 150, dtype=torch.int32, device=dev)
    n0 = fused_ops.rope_fused.launches
    ops = _dispatches(torch, lambda: apply_rotary_pos_emb(
        q, k, tc, tc, position_offset=pos))
    kernels = [op for op in ops if not op.startswith("aten.empty")]
    print(f"apply_rotary_pos_emb with a device offset: "
          f"{fused_ops.rope_fused.launches - n0} K2 launch, PyTorch "
          f"dispatches {ops}")
    if kernels or fused_ops.rope_fused.launches != n0 + 1:
        raise AssertionError(f"apply_rotary_pos_emb dispatched {ops} "
                             "beside one K2 launch")


def _int8_edges(torch):
    """B7 against its plain version (the `_tol` of phase 2) at the edges
    its plan adds, in bfloat16 and float32, with and without a bias: M 1,
    8, 9, 64, 65 and 4097 (token tiles 8-128, one row past each), N 2 (the
    narrow kind) and 130 (a ragged 64-row weight tile), K 100 (one ragged
    step) and 4096 (the plan splits K where the grid is small), and the
    classifier head's strided x[:, 0].  With a bias the kernel's epilogue
    must give the bits of the kernel's product plus a separate add (the
    two-step rounding).  In bfloat16 every split count the instance takes
    (forced) is held too, and a plan with a cluster must give the same bits
    in five runs (the merge has no atomics)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    from paddle_tpu_torch.quantization import weight_quantize

    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    dev = "cuda"
    n = worst = clusters = fused = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]

        def rnd(*shape, dt=dtype):
            return torch.randn(*shape, generator=g, device=dev, dtype=dt)

        xs = {(M, K): rnd(M, K) for M in (1, 8, 9, 64, 65, 4097)
              for K in (100, 4096)}
        xs[("head", 768)] = rnd(32, 128, 768)[:, 0]
        for (M, K), x in xs.items():
            for N in (2, 130):
                qw, sc = weight_quantize(rnd(K, N, dt=torch.float32) * 0.05)
                b = rnd(N)
                M = x.shape[0]
                splits = [None]
                if dtype == torch.bfloat16 and N >= im.NARROW_N:
                    splits += [s for s in im.SPLITS if s > 1]
                for bias in (None, b):
                    ref = im._int8_matmul_ref(x, qw, sc, bias)
                    tol = _tol(dname, ref)
                    for sp in splits:
                        kw = {} if sp is None else dict(splits=sp)
                        try:
                            plan = im.int8_plan(M, N, K, dtype, **kw)
                        except ValueError:   # a split left empty: refused
                            continue
                        got = im._launch(x, qw, sc, bias, **kw)
                        err = _err(torch, got, ref)
                        n += 1
                        worst = max(worst, err / tol)
                        if not err <= tol:
                            raise AssertionError(
                                f"B7 edge {dname} [{M}, {K}] x [{K}, {N}] "
                                f"bias {bias is not None} {plan}: kernel and "
                                f"plain differ by {err} > {tol}")
                        if bias is not None:
                            two = im._launch(x, qw, sc, **kw) + bias
                            if not torch.equal(got, two):
                                raise AssertionError(
                                    f"B7 edge {dname} [{M}, {K}] x [{K}, "
                                    f"{N}] {plan}: the fused bias differs "
                                    "from the two-step add")
                            fused += 1
                        for _ in range(4 if plan.splits > 1 else 0):
                            if not torch.equal(
                                    im._launch(x, qw, sc, bias, **kw), got):
                                raise AssertionError(
                                    f"B7 edge {dname} [{M}, {K}] x [{K}, "
                                    f"{N}] {plan}: two runs differ")
                        clusters += plan.splits > 1
    torch.cuda.synchronize()
    print(f"b7 edges: {n} plans agree with the plain version (largest error "
          f"{worst:.3f} of its tolerance); {fused} with a bias give the "
          f"two-step bits; the {clusters} with clusters gave the same bits "
          "in 5 runs each")


def _int8_sweep(torch, timer, label, dname):
    """Informative, for int8_plan's rules (``--b7-sweep``): one B7 case
    timed under every plan the instances take (the narrow kind, and every
    token tile, weight-row count and split count of the wgmma kind)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im

    base, (x, qw, sc, b), _ = _B7_PLANS[(label, dname)]
    M, K = x.shape
    N = qw.shape[1]
    plans = [dict(kind="narrow")] + [
        dict(kind="wgmma", tile=t, rows=r, splits=s)
        for t in im.TILES for r in im.ROWS for s in im.SPLITS]
    out = []
    for kw in plans:
        try:
            im.int8_plan(M, N, K, x.dtype, **kw)
        except ValueError:
            continue
        ms = timer(lambda kw=kw: im._launch(x, qw, sc, b, **kw))
        out.append((ms, "narrow" if kw["kind"] == "narrow" else
                    f"t{kw['tile']}/r{kw['rows']}/s{kw['splits']}"))
    out.sort()
    print(f"b7 sweep {dname} {label} (plan {base.kind} t{base.tile}/"
          f"r{base.rows}/s{base.splits}): " + ", ".join(
              f"{name} {ms:.4f}" for ms, name in out[:12]) + " ms (fastest "
          f"12 of {len(out)})", flush=True)


def _decode_edges(torch):
    """B2 against its plain version (the `_tol` of phase 2) at the edges
    its tiles and splits add, in bfloat16 and float32, under every split
    count (forced): pos 0 (one key), pos 1 (empty shares under 4 and 8
    splits), pos + 1 at and one past a multiple of the key tile, pos L - 1
    and past it (clamped), a negative pos (no key: zeros), a ring of 100
    rows; groups of 1, 2, 4, 8, 16 and 64 heads (a group past 16 takes
    several blocks), head_dim 48, 64, 72, 80 and 144 (zero-padded columns
    on the tensor cores), 128 and 256, and 100, 264 and 512 (the SIMT
    instance in both types: rows read in pieces, 16-key tiles in float32
    past 256).  A plan with a cluster must give the same bits in five runs
    (the merge has no atomics)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    dev, B = "cuda", 3
    n = worst = clusters = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for G, KVH, D, L in ((1, 2, 64, 100), (2, 2, 128, 300),
                             (4, 2, 80, 100), (8, 1, 256, 100),
                             (16, 1, 128, 200), (64, 1, 128, 100),
                             (1, 1, 48, 64), (2, 1, 144, 100),
                             (4, 1, 72, 100), (2, 2, 100, 100),
                             (16, 1, 264, 100), (1, 2, 512, 64)):
            H = G * KVH
            q = torch.randn(B, 1, H, D, generator=g, device=dev, dtype=dtype)
            kb = torch.randn(B, L, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            vb = torch.randn(B, L, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            for pos in sorted({-3, 0, 1, 15, 16, 63, 64, 127, 128, L - 1,
                               L + 5}):
                p = torch.full((), pos, dtype=torch.int32, device=dev)
                ref = da.ref_decode_attention(q, kb, vb, p)
                tol = _tol(dname, ref)
                for splits in (1, 2, 4, da.SPLIT_CAP):
                    kw = dict(splits=splits)
                    try:
                        plan = da._plan(B, L, H, KVH, D, dtype, **kw)
                    except ValueError:   # past the limits: refused
                        continue
                    got = da._launch(q, kb, vb, p, **kw)
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"B2 edge {dname} G {G} D {D} L {L} pos {pos} "
                            f"{plan}: kernel and plain differ by {err} > "
                            f"{tol}")
                    # the cluster merge has no atomics: a plan's runs agree
                    # bit for bit, or blocks race
                    for _ in range(4 if plan.splits > 1 else 0):
                        if not torch.equal(da._launch(q, kb, vb, p, **kw),
                                           got):
                            raise AssertionError(
                                f"B2 edge {dname} G {G} D {D} L {L} pos "
                                f"{pos} {plan}: two runs differ")
                    clusters += plan.splits > 1
    torch.cuda.synchronize()
    print(f"b2 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          "with clusters gave the same bits in 5 runs each")


def _decode_sweep(torch, timer, label, dname):
    """Informative, for decode_plan's split rule (``--b2-sweep``): one B2
    case timed under every split count."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    base, (q, kb, vb, p) = _B2_PLANS[(label, dname)]
    out = []
    for splits in (1, 2, 4, da.SPLIT_CAP):
        try:
            ms = timer(lambda: da._launch(q, kb, vb, p, splits=splits))
            ms = f"{ms:.4f}"
        except ValueError:          # past the limits: refused
            ms = "refused"
        out.append(f"splits {splits} {ms}")
    print(f"b2 sweep {dname} {label} (plan splits {base.splits}): "
          + ", ".join(out) + " ms", flush=True)


def _paged_edges(torch):
    """K4 against its plain version (the `_tol` of phase 2) at the edges
    its tiles and splits add, in bfloat16 and float32, under every split
    count and several query tiles (the plan forced): visible key counts at
    0, 1 and -1 mod 16 and mod the split chunk, a position past the pool
    (clamped), a row with now = 0, now > max_q_len, block ids -1 and past
    the pool, padding tokens; GQA groups 1, 4 and 8, head_dim 64, 128 and
    256, 80 and 72 (bf16: tensor cores on zero-padded columns), and 100,
    264 and 512 (the SIMT instance in both types: rows read in pieces,
    16-key tiles past 256 where larger rings do not fit).  A plan with a
    cluster must give the same bits in five runs (the merge has no
    atomics)."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    dev, bs, P, NB, B = "cuda", 16, 12, 128, 8
    batches = (  # (max_q_len, dec, now)
        (1, [0, 14, 15, 126, 127, 63, 200, 0], [1, 1, 1, 1, 1, 1, 1, 0]),
        (16, [0, 17, 31, 5, 100, 0, 64, 150], [16, 1, 20, 0, 9, 3, 1, 16]))
    n = worst = clusters = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for G, D in ((1, 64), (4, 128), (8, 256), (1, 128), (8, 64),
                     (2, 80), (1, 72), (2, 100), (4, 264), (1, 512)):
            KV, H = 2, 2 * G
            kc = torch.randn(NB, KV, bs, D, generator=g, device=dev,
                             dtype=dtype)
            vc = torch.randn(NB, KV, bs, D, generator=g, device=dev,
                             dtype=dtype)
            bt = torch.randperm(NB, generator=g, device=dev)[:B * P]
            bt = bt.view(B, P).to(torch.int32)
            bt[2, 1], bt[5, 0] = -1, NB + 3
            for mq, dec, now in batches:
                dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                cu[1:] = torch.cumsum(now_t, 0)
                q = torch.randn(sum(now) + 5, H, D, generator=g, device=dev,
                                dtype=dtype)
                args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
                ref = pa._paged_attention_ref(*args)
                tol = _tol(dname, ref)
                T = q.shape[0]
                for qt, splits, stages in itertools.product(
                        (1, 5, 16) if mq > 1 else (1,),
                        (1, 2, pa.SPLIT_CAP), pa.STAGES[pa._tc(dtype, D)]):
                    kw = dict(qt=qt, splits=splits, stages=stages)
                    try:
                        p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype, **kw)
                    except ValueError:   # past the limits: refused
                        continue
                    got = pa._launch(*args, **kw)
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"K4 edge {dname} G {G} D {D} mq {mq} {p}: "
                            f"kernel and plain differ by {err} > {tol}")
                    # the cluster merge has no atomics: a plan's runs agree
                    # bit for bit, or blocks race
                    for _ in range(4 if p.splits > 1 else 0):
                        if not torch.equal(pa._launch(*args, **kw), got):
                            raise AssertionError(
                                f"K4 edge {dname} G {G} D {D} mq {mq} {p}: "
                                "two runs differ")
                    clusters += p.splits > 1
    torch.cuda.synchronize()
    print(f"k4 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          "with clusters gave the same bits in 5 runs each")


def _paged_int8_edges(torch):
    """K4-int8 against its plain version (the `_tol` of phase 2) at the
    edges of its two instances, in bfloat16 (the tensor cores where the
    shape allows, and SIMT forced) and float32 (SIMT), under every split
    count 1-4: head_dim 8, 64, 72 (8-byte code pieces), 128 and 256 at 1,
    4, 8, 16 and 64 query heads a KV head; a decode batch (visible key
    counts at 0, 1 and -1 mod 64, a position past the pool, a row with now
    0) and a prefill batch (dec 0 rows, tiles straddling cached and fresh
    keys, now > max_q_len); block ids -1 and past the pool inside the
    visible range; block size 16 and, at some shapes, 48 (a split's chunk
    of 64 keys then starts inside a block); k and v as views of a packed
    qkv buffer.  A plan with a cluster must give the same bits in three
    runs.  float32 outputs (``out_dtype``) of both K4-int8 instances and
    of K4's three (tensor cores, SIMT, wide) against the plain versions'."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    dev, B, f32 = "cuda", 8, torch.float32
    batches = (  # (max_q_len, dec, now)
        (1, [0, 63, 64, 127, 128, 200, 500, 0], [1, 1, 1, 1, 1, 1, 1, 0]),
        (16, [0, 17, 60, 5, 100, 0, 64, 150], [16, 1, 20, 0, 9, 3, 1, 16]))
    n = worst = clusters = wides = 0
    for dtype in (torch.bfloat16, f32):
        dname = str(dtype).split(".")[1]
        for G, D in itertools.product((1, 4, 8, 16, 64),
                                      (8, 64, 72, 128, 256)):
            KV, H = 2, 2 * G
            for bs in ((16, 48) if (G, D) in ((4, 128), (1, 72), (16, 256))
                       else (16,)):
                P = -(-192 // bs)
                NB = B * P + 4
                kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                        device=dev, dtype=torch.uint8)
                          for _ in range(2))
                bt = torch.randperm(NB, generator=g, device=dev)[:B * P]
                bt = bt.view(B, P).to(torch.int32)
                bt[1, 1], bt[4, 0] = -1, NB + 3
                kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
                vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
                for mq, dec, now in batches:
                    dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                    now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                    cu[1:] = torch.cumsum(now_t, 0)
                    T = sum(now) + 5
                    qkv = torch.randn(T, (H + 2 * KV) * D, generator=g,
                                      device=dev, dtype=dtype)
                    q = qkv[:, :H * D].reshape(T, H, D).contiguous()
                    k = qkv[:, H * D:(H + KV) * D].view(T, KV, D)
                    v = qkv[:, (H + KV) * D:].view(T, KV, D)
                    args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
                    ref = pa._paged_attention_int8_ref(*args)
                    ref32 = pa._paged_attention_int8_ref(*args,
                                                         out_dtype=f32)
                    tol = _tol(dname, ref)
                    can_tc = pa._tc(dtype, D) and G <= pa.TC_ROWS
                    for tc in ((True, False) if can_tc else (False,)):
                        for splits in (1, 2, 3, 4):
                            try:
                                p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                                  dtype, tc, splits)
                            except ValueError:   # past the limits: refused
                                continue
                            got = pa._launch_int8(*args, tc=tc,
                                                  splits=splits)
                            err = _err(torch, got, ref)
                            n += 1
                            worst = max(worst, err / tol)
                            if not err <= tol:
                                raise AssertionError(
                                    f"K4-int8 edge {dname} G {G} D {D} bs "
                                    f"{bs} mq {mq} {p}: kernel and plain "
                                    f"differ by {err} > {tol}")
                            for _ in range(2 if p.splits > 1 else 0):
                                if not torch.equal(pa._launch_int8(
                                        *args, tc=tc, splits=splits), got):
                                    raise AssertionError(
                                        f"K4-int8 edge {dname} G {G} D {D} "
                                        f"mq {mq} {p}: two runs differ")
                            clusters += p.splits > 1
                        try:
                            got = pa._launch_int8(*args, out_dtype=f32,
                                                  tc=tc)
                        except ValueError:
                            continue
                        err = _err(torch, got, ref32)
                        if got.dtype != f32 or not err <= _tol(dname, ref32):
                            raise AssertionError(
                                f"K4-int8 edge {dname} G {G} D {D} tc {tc}: "
                                f"float32 output {got.dtype} differs by "
                                f"{err}")
                        wides += 1
    # bf16 k and v one element past 16-byte alignment: the launch's own
    # plan takes SIMT, gives the forced SIMT instance's bits and agrees
    # with the plain version
    KV, H, D, bs, P = 2, 8, 128, 16, 12
    NB = B * P
    kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                            device=dev, dtype=torch.uint8) for _ in range(2))
    bt = torch.randperm(NB, generator=g, device=dev).view(B, P).to(
        torch.int32)
    kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    misaligned = 0
    for mq, dec, now in batches:
        dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
        now_t = torch.tensor(now, dtype=torch.int32, device=dev)
        cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
        cu[1:] = torch.cumsum(now_t, 0)
        T = sum(now) + 5
        qkv = torch.randn(T, (H + 2 * KV) * D + 1, generator=g, device=dev,
                          dtype=torch.bfloat16)[:, 1:]
        q = qkv[:, :H * D].reshape(T, H, D).contiguous()
        k = qkv[:, H * D:(H + KV) * D].view(T, KV, D)
        v = qkv[:, (H + KV) * D:].view(T, KV, D)
        args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
        plan = pa._int8_launch_plan(q, k, v, kc, vc, bt, mq)
        ref = pa._paged_attention_int8_ref(*args)
        got = pa._launch_int8(*args)
        err = _err(torch, got, ref)
        if (plan.tc or not torch.equal(got, pa._launch_int8(*args, tc=False))
                or not err <= _tol("bfloat16", ref)):
            raise AssertionError(f"K4-int8 misaligned k/v mq {mq}: {plan}, "
                                 f"error {err}")
        misaligned += 1
    # K4's three instances with a float32 output
    k4 = 0
    for dtype, D in ((torch.bfloat16, 128), (torch.bfloat16, 100),
                     (f32, 64), (torch.bfloat16, 640)):
        dname = str(dtype).split(".")[1]
        bs, P, KV, H = 16, 12, 2, 8
        NB = B * P
        kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                              dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        for mq, dec, now in batches:
            dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
            now_t = torch.tensor(now, dtype=torch.int32, device=dev)
            cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
            cu[1:] = torch.cumsum(now_t, 0)
            q = torch.randn(sum(now) + 5, H, D, generator=g, device=dev,
                            dtype=dtype)
            args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
            ref32 = pa._paged_attention_ref(*args, out_dtype=f32)
            got = pa.paged_attention(*args, out_dtype=f32)
            err = _err(torch, got, ref32)
            if got.dtype != f32 or not err <= _tol(dname, ref32):
                raise AssertionError(f"K4 {dname} D {D} mq {mq}: float32 "
                                     f"output {got.dtype} differs by {err}")
            k4 += 1
    torch.cuda.synchronize()
    print(f"k4-int8 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          f"with clusters gave the same bits in 3 runs each; {wides} "
          f"float32 outputs of K4-int8 and {k4} of K4 (tensor cores, SIMT, "
          f"wide) agree with the plain versions'; {misaligned} misaligned "
          "bf16 k/v calls took SIMT")


def _pre_edges(torch):
    """The pre-caches (A4b) in every K4 and K4-int8 instance against the
    plain versions (the `_tol` of phase 2): K4's tensor cores (bf16 D 128),
    its SIMT instance (float32 D 128, bf16 D 100) and its wide one (bf16
    and float32 D 640), K4-int8's tensor cores (bf16 D 128) and SIMT
    (forced on bf16 D 128, float32 D 128, bf16 D 100); prefixes of 1, 64
    and 130 keys (within a tile, one whole tile, straddling three); at
    decode (8 rows, context <= 512, a row with now 0, an out-of-pool block)
    and at the single step's mixed batch of 255 tokens (max_q_len 256);
    32 / 8 heads (16 / 2 past 512 columns); the plan's own split and one
    and four splits forced where the instance takes them.  Each plan with
    a cluster gives the same bits in three runs.  No instance refuses a
    prefix: the unforced call of each case must run."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    dev, bs, P, B = "cuda", 16, 32, 8
    NB = B * P + 4
    batches = (  # (max_q_len, T, dec, now)
        (1, B, [300, 0, 200, 450, 17, 63, 511, 64], [1, 1, 1, 1, 1, 1, 0, 1]),
        (256, 256, [300, 0, 200, 450, 0, 0, 20, 64],
         [1, 100, 16, 1, 60, 0, 1, 76]))
    instances = (  # (kernel, dtype, D, tensor cores forced)
        ("k4", torch.bfloat16, 128, None), ("k4", torch.float32, 128, None),
        ("k4", torch.bfloat16, 100, None), ("k4", torch.bfloat16, 640, None),
        ("k4", torch.float32, 640, None),
        ("k4-int8", torch.bfloat16, 128, None),
        ("k4-int8", torch.bfloat16, 128, False),
        ("k4-int8", torch.float32, 128, None),
        ("k4-int8", torch.bfloat16, 100, None))
    n = worst = clusters = 0
    for kern, dtype, D, tc in instances:
        dname = str(dtype).split(".")[1]
        KV, H = (2, 16) if D > 512 else (8, 32)
        int8 = kern == "k4-int8"
        if int8:
            kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                    device=dev, dtype=torch.uint8)
                      for _ in range(2))
            kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
            vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
        else:
            kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                                  dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        bt[3, 2] = -1                   # visible to row 3, outside the pool
        for Lp in (1, 64, 130):
            pre = dict(pre_key=torch.randn(B, KV, Lp, D, generator=g,
                                           device=dev, dtype=dtype),
                       pre_value=torch.randn(B, KV, Lp, D, generator=g,
                                             device=dev, dtype=dtype))
            for mq, T, dec, now in batches:
                dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                cu[1:] = torch.cumsum(now_t, 0)
                q = torch.randn(T, H, D, generator=g, device=dev,
                                dtype=dtype)
                if int8:
                    k, v = (torch.randn(T, KV, D, generator=g, device=dev,
                                        dtype=dtype) for _ in range(2))
                    args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt,
                            mq)
                    ref = pa._paged_attention_int8_ref(*args, **pre)
                    own = pa.paged_attention_int8(*args, **pre)
                else:
                    args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
                    ref = pa._paged_attention_ref(*args, **pre)
                    own = pa.paged_attention(*args, **pre)
                tol = _tol(dname, ref)
                outs = [("plan", own, None)]
                for splits in (1, pa.SPLIT_CAP):
                    try:
                        if int8:
                            p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                              dtype, tc, splits, Lp)
                            run = (lambda s=splits: pa._launch_int8(
                                *args, tc=tc, splits=s, **pre))
                        else:
                            p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype,
                                         splits=splits, pre_len=Lp)
                            run = (lambda s=splits: pa._launch(
                                *args, splits=s, **pre))
                    except ValueError:   # the wide instance: one split
                        continue
                    got = run()
                    outs.append((p, got, run))
                for p, got, run in outs:
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"{kern} prefix {Lp} {dname} D {D} tc {tc} mq "
                            f"{mq} {p}: kernel and plain differ by {err} > "
                            f"{tol}")
                    if run is not None and p.splits > 1:
                        clusters += 1
                        for _ in range(2):
                            if not torch.equal(run(), got):
                                raise AssertionError(
                                    f"{kern} prefix {Lp} {dname} D {D} mq "
                                    f"{mq} {p}: two runs differ")
    torch.cuda.synchronize()
    print(f"prefix edges: {n} calls of K4 and K4-int8 with pre-caches agree "
          f"with the plain versions (largest error {worst:.3f} of its "
          f"tolerance); the {clusters} with clusters gave the same bits in 3 "
          "runs each")


def _mask_configs(H, mq, Lf):
    """The masks of ``_mask_edges``, as ((heads, rows, columns) of ``mask``
    | None, the same of ``tgt_mask`` | None): one head and H heads, fewer
    and more rows than ``max_q_len``, fewer and more columns than the
    combined key axis Lf, each mask alone and both together."""
    return (((1, mq, Lf), (H, 1, Lf)),
            ((H, max(1, mq // 2), Lf - 37), (1, 1, Lf + 9)),
            ((1, mq + 7, Lf + 20), None),
            (None, (H, 3, Lf - 100)))


def _mask_edges(torch):
    """The additive masks (A4b) in every K4 and K4-int8 instance against the
    plain versions (the `_tol` of phase 2): the instances of `_pre_edges`
    (K4's tensor cores, SIMT and wide; K4-int8's tensor cores and SIMT,
    forced and by dtype / head dim), without a prefix and with prefixes of
    1, 64 and 130 keys, at decode (two rows in prefill under ``mask``, the
    others under ``tgt_mask``, a row with now 0, an out-of-pool block) and
    at the single step's mixed batch of 255 tokens (its prefill rows under
    ``mask``, the rest under ``tgt_mask``), under the masks of
    `_mask_configs` in turn (values in [-3, 1], 5% of them -inf, column 0
    finite so that every query keeps a key); the plan's own split and one
    and four splits forced.  Each plan with a cluster gives the same bits
    in three runs.  Then the edge of ROADMAP Queue C10 in every instance:
    a decode row whose visible keys all carry -inf gives zeros from the
    kernel, and the mean of its invisible keys' values from the plain
    version (the reference's answer); the other rows agree."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(18)
    dev, bs, P, B = "cuda", 16, 32, 8
    NB = B * P + 4
    batches = (  # (max_q_len, T, dec, now, enc)
        (1, B, [300, 0, 200, 450, 17, 63, 511, 64], [1, 1, 1, 1, 1, 1, 0, 1],
         [0, 1, 0, 0, 1, 0, 0, 0]),
        (256, 256, [300, 0, 200, 450, 0, 0, 20, 64],
         [1, 100, 16, 1, 60, 0, 1, 76], [0, 100, 0, 0, 60, 0, 0, 76]))
    instances = (  # (kernel, dtype, D, tensor cores forced)
        ("k4", torch.bfloat16, 128, None), ("k4", torch.float32, 128, None),
        ("k4", torch.bfloat16, 100, None), ("k4", torch.bfloat16, 640, None),
        ("k4", torch.float32, 640, None),
        ("k4-int8", torch.bfloat16, 128, None),
        ("k4-int8", torch.bfloat16, 128, False),
        ("k4-int8", torch.float32, 128, None),
        ("k4-int8", torch.bfloat16, 100, None))

    def rand_mask(shape):
        if shape is None:
            return None
        m = torch.rand(B, *shape, generator=g, device=dev) * 4 - 3
        m[torch.rand(m.shape, generator=g, device=dev) < 0.05] = -float("inf")
        m[..., 0] = 0.0
        return m

    n = worst = clusters = turn = 0
    edge = []
    for kern, dtype, D, tc in instances:
        dname = str(dtype).split(".")[1]
        KV, H = (2, 16) if D > 512 else (8, 32)
        int8 = kern == "k4-int8"
        if int8:
            kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                    device=dev, dtype=torch.uint8)
                      for _ in range(2))
            kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
            vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
        else:
            kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                                  dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        bt[3, 2] = -1                   # visible to row 3, outside the pool

        def call(mq, T, dec, now, enc, Lp, masks):
            """(args, kwargs, plain output, kernel output) of one case."""
            dec_t, now_t, enc_t = (torch.tensor(x, dtype=torch.int32,
                                                device=dev)
                                   for x in (dec, now, enc))
            cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
            cu[1:] = torch.cumsum(now_t, 0)
            q = torch.randn(T, H, D, generator=g, device=dev, dtype=dtype)
            kw = dict(seq_lens_encoder=enc_t, **masks)
            if Lp:
                kw.update({n_: torch.randn(B, KV, Lp, D, generator=g,
                                           device=dev, dtype=dtype)
                           for n_ in ("pre_key", "pre_value")})
            if int8:
                k, v = (torch.randn(T, KV, D, generator=g, device=dev,
                                    dtype=dtype) for _ in range(2))
                args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
                return (args, kw, pa._paged_attention_int8_ref(*args, **kw),
                        pa.paged_attention_int8(*args, **kw))
            args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
            return (args, kw, pa._paged_attention_ref(*args, **kw),
                    pa.paged_attention(*args, **kw))

        for Lp in (0, 1, 64, 130):
            for mq, T, dec, now, enc in batches:
                cfg = _mask_configs(H, mq, Lp + P * bs)
                mk, tk = cfg[turn % len(cfg)]
                turn += 1
                masks = dict(mask=rand_mask(mk), tgt_mask=rand_mask(tk))
                args, kw, ref, own = call(mq, T, dec, now, enc, Lp, masks)
                tol = _tol(dname, ref)
                outs = [("plan", own, None)]
                for splits in (1, pa.SPLIT_CAP):
                    try:
                        if int8:
                            p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                              dtype, tc, splits, Lp)
                            run = (lambda s=splits: pa._launch_int8(
                                *args, tc=tc, splits=s, **kw))
                        else:
                            p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype,
                                         splits=splits, pre_len=Lp)
                            run = (lambda s=splits: pa._launch(
                                *args, splits=s, **kw))
                    except ValueError:   # the wide instance: one split
                        continue
                    outs.append((p, run(), run))
                for p, got, run in outs:
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"{kern} masks {mk} / {tk} prefix {Lp} {dname} D "
                            f"{D} tc {tc} mq {mq} {p}: kernel and plain "
                            f"differ by {err} > {tol}")
                    if run is not None and p.splits > 1:
                        clusters += 1
                        for _ in range(2):
                            if not torch.equal(run(), got):
                                raise AssertionError(
                                    f"{kern} masks prefix {Lp} {dname} D {D} "
                                    f"mq {mq} {p}: two runs differ")
        # Queue C10: row 0 (decode, position 300) sees keys 0 .. 300, all
        # -inf under its tgt_mask; its keys 301 .. 511 are finite
        tgt = torch.zeros(B, 1, 1, P * bs, device=dev)
        tgt[0, :, :, :301] = -float("inf")
        args, kw, ref, own = call(1, B, *batches[0][2:], 0,
                                  dict(mask=None, tgt_mask=tgt))
        tol = _tol(dname, ref[1:])
        if (own[0].abs().max() != 0 or not ref[0].abs().max() > 0
                or not _err(torch, own[1:], ref[1:]) <= tol):
            raise AssertionError(
                f"{kern} {dname} D {D}: the all -inf row gave "
                f"{float(own[0].abs().max())} (kernel) and "
                f"{float(ref[0].abs().max())} (plain), or another row moved")
        edge.append(f"{kern} {dname} D {D} tc {tc}: kernel 0, plain "
                    f"|max| {float(ref[0].float().abs().max()):.4f}")
    torch.cuda.synchronize()
    print(f"mask edges: {n} calls of K4 and K4-int8 under masks agree with "
          f"the plain versions (largest error {worst:.3f} of its "
          f"tolerance); the {clusters} with clusters gave the same bits in 3 "
          f"runs each; mask launches {pa.paged_attention.mask_launches} "
          f"(K4) {pa.paged_attention_int8.mask_launches} (K4-int8)")
    print("mask edge, a row whose visible keys are all -inf (Queue C10): "
          + "; ".join(edge))


def _paged_sweep(torch, timer, label, dname):
    """Informative, for paged_plan's rules (``--k4-sweep``): one K4 case
    timed under every split count, ring depth and, for prefill tiles,
    several query tiles (bfloat16 on the tensor cores takes up to 64 query
    rows a tile)."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    base = _K4_PLANS[(label, dname)]
    args = _K4_ARGS[(label, dname)]
    pre = _K4_PRE[(label, dname)]
    tc = pa._tc(args[0].dtype, args[0].shape[2])
    qts = ((base.qt,) if base.qt == 1 else (8, 16, 32, 64) if tc
           else (1, 2, 4, 8, 16))
    out = []
    for qt, stages, splits in itertools.product(
            qts, pa.STAGES[tc], (1, 2, pa.SPLIT_CAP)):
        kw = dict(qt=qt, splits=splits, stages=stages, **pre)
        try:
            ms = f"{timer(lambda: pa._launch(*args, **kw)):.4f}"
        except ValueError:          # past the limits: refused
            ms = "refused"
        out.append(f"qt {qt} stages {stages} splits {splits} {ms}")
    print(f"k4 sweep {dname} {label} (plan qt {base.qt} stages "
          f"{base.stages} splits {base.splits}): " + ", ".join(out) + " ms",
          flush=True)


def _flash_tiles(torch):
    """Informative, for autotune's table (bf16, CUDA events): B1 and B8 at
    every compiled tile pair, by autotune.tune (causal, 16 heads, ~8192
    rows) and at the training shapes (L2 flushed); B8's two GQA modes at
    four grid sizes beside the pair the selector picks; whether two B8 runs
    agree bit for bit (dQ is summed with atomics)."""
    from paddle_tpu_torch.ops.hopper import autotune
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    autotune.tune(seqs=(512, 2048), head_dims=(64, 128, 256))
    autotune.clear_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    timer = Timer(torch, 10)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    for B, S, H, D in ((8, 2048, 20, 128), (8, 2048, 10, 256)):
        q, k, v, go = (rnd(B, S, H, D) for _ in range(4))
        o, lse = fa.flash_attention_fused(q, k, v, True)
        dc = autotune.head_dim_class(D)
        for pair in autotune.INSTANCES[("fwd", dc)]:
            ms = timer(lambda p=pair: fa.flash_attention_fused(
                q, k, v, True, blocks=p))
            print(f"tiles fwd causal [{B}, {S}, {H}, {D}] {pair}: {ms:.4f} ms")
        for pair in autotune.INSTANCES[("bwd", dc)]:
            ms = timer(lambda p=pair: fa.flash_attention_bwd_fused(
                q, k, v, o, lse, go, True, blocks=p))
            print(f"tiles bwd causal [{B}, {S}, {H}, {D}] {pair}: {ms:.4f} ms")
    pick = fa._gqa_heads_per_block
    try:
        for B, S in ((1, 512), (2, 512), (4, 1024), (8, 2048)):
            q, go = rnd(B, S, 32, 128), rnd(B, S, 32, 128)
            k, v = rnd(B, S, 8, 128), rnd(B, S, 8, 128)
            o, lse = fa.flash_attention_fused(q, k, v, True)
            times = {}
            for hpb in (1, 4):  # the two modes, the selector substituted
                fa._gqa_heads_per_block = lambda *_, h=hpb: h
                times[hpb] = timer(lambda: fa.flash_attention_bwd_fused(
                    q, k, v, o, lse, go, True))
            print(f"B8 GQA causal [{B}, {S}, 32 / 8, 128]: one head per "
                  f"block {times[1]:.4f} ms, a block per group "
                  f"{times[4]:.4f} ms; the selector picks "
                  f"{pick(B, 8, S, 4)} head(s) per block")
    finally:
        fa._gqa_heads_per_block = pick
    q, go = rnd(1, 512, 32, 128), rnd(1, 512, 32, 128)
    k, v = rnd(1, 512, 8, 128), rnd(1, 512, 8, 128)
    o, lse = fa.flash_attention_fused(q, k, v, True)
    a = fa.flash_attention_bwd_fused(q, k, v, o, lse, go, True)
    b = fa.flash_attention_bwd_fused(q, k, v, o, lse, go, True)
    print("B8 bf16 GQA [1, 512] two runs bit for bit: " + ", ".join(
        f"{n} {bool(torch.equal(x, y))}" for n, x, y in zip(
            ("dq", "dk", "dv"), a, b)))


def _refusals(torch):
    """Shapes past a kernel's shared memory are refused and raise, naming
    the limit: a 128-head group over one KV head at head_dim 256 past the
    64 query rows of K4's bfloat16 tensor-core tile and, in float32, past
    the 227 KB a K4 block may use (by its plan, before any launch); the K4
    entry refuses a plan it has no instance for, a chunk short of the
    prefix and the context, and a prefix without its rows or off 16-byte
    alignment; the entry refuses a mask
    without seq_lens_encoder or of neither 1 nor H heads.  A head dim of
    520, which
    B1, B8, B2 and K4 refused here before (Queue C8), is computed and held
    to the plain versions in both dtypes.  (K1 refused a 16384-wide row
    here before its rows moved to registers, and B2 a head dim of 72
    before every head dim up to 512 had an instance: phase 2 now holds
    [1, 16384] and head dims 72 to 1024 against the plain versions.)"""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    dev, dt = "cuda", torch.bfloat16
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    cu = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    bt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    for kdt, limit in ((dt, "64 query rows"), (torch.float32, "227 KB")):
        big = torch.ones(1, 128, 256, dtype=kdt, device=dev)
        kv = torch.ones(1, 1, 16, 256, dtype=kdt, device=dev)
        try:
            pa.paged_attention(big, kv, kv, z, one, cu, bt, 1)
        except ValueError as e:
            if limit not in str(e):
                raise
            print(f"refused paged_attention {kdt} 128 heads / 1 KV, "
                  f"head_dim 256: {e}")
        else:
            raise AssertionError(f"paged_attention {kdt} 128 heads / 1 KV "
                                 "was not refused")
    from paddle_tpu_torch.ops.hopper import _build
    q = torch.ones(1, 8, 128, dtype=dt, device=dev)
    kv = torch.ones(1, 8, 16, 128, dtype=dt, device=dev)
    bt = torch.zeros(1, 32, dtype=torch.int32, device=dev)
    # (query tile, key tile, stages, splits, chunk, blocks of the row,
    # prefix keys, the prefix's pointers)
    pre = kv.data_ptr()
    for what, (qt, kt, stages, splits, chunk, P, Lp, pk) in {
            "key tile 48": (1, 48, 2, 1, 48, 1, 0, None),
            "8 splits": (1, 64, 2, 8, 64, 32, 0, None),
            "a chunk short of the context": (1, 64, 2, 1, 0, 1, 0, None),
            "a ring of 3 on the tensor cores": (1, 64, 3, 1, 64, 1, 0, None),
            "a chunk short of the prefix and the context": (
                1, 64, 2, 1, 64, 4, 16, pre),
            "a prefix without its rows": (1, 64, 2, 1, 128, 4, 16, None),
            "a prefix off 16-byte alignment": (1, 64, 2, 1, 128, 4, 16,
                                               pre + 2)}.items():
        err = _build.lib().ptt_paged_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), one.data_ptr(), cu.data_ptr(), bt.data_ptr(), pk,
            pk, 1, 1, P, 1, 8, 8, 128, 16, Lp, 1, 0.1, qt, kt, stages,
            splits, chunk, 0, *(0,) * 9, 1,
            torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"paged_attention {what} not refused: "
                                 f"{err}")
        print(f"refused paged_attention plan with {what}: cudaError_t 1")
    # the masks' arguments (mask, heads, rows, columns, tgt_mask, ...,
    # seq_lens_encoder) under a plan the entry takes
    m = torch.zeros(1, 1, 1, 16, device=dev).data_ptr()
    for what, mk in (
            ("a mask without seq_lens_encoder", (m, 1, 1, 16, 0, 0, 0, 0, 0)),
            ("a mask of 2 heads for 8",
             (0, 0, 0, 0, m, 2, 1, 16, z.data_ptr()))):
        err = _build.lib().ptt_paged_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), one.data_ptr(), cu.data_ptr(), bt.data_ptr(), None,
            None, 1, 1, 1, 1, 8, 8, 128, 16, 0, 1, 0.1, 1, 64, 2, 1, 64, 0,
            *mk, 1, torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"paged_attention {what} not refused: "
                                 f"{err}")
        print(f"refused paged_attention with {what}: cudaError_t 1")
    # a head dim past 512 (C8, closed): every attention kernel computes
    # it (the wide instances), held to its plain version
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(520)
    pos = torch.full((), 40, dtype=torch.int32, device=dev)
    for kdt in (dt, torch.float32):
        dname = str(kdt).split(".")[1]

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev, dtype=kdt)

        wide, go = rnd(1, 16, 2, 520), rnd(1, 16, 2, 520)
        ring, pool = rnd(1, 64, 2, 520), rnd(1, 2, 16, 520)
        o, lse = fa.flash_attention_fused(wide, wide, wide, True)
        s = 1.0 / 520 ** 0.5
        paged = (wide[0, :1], pool, pool, z, one, cu, bt[:, :1], 1)
        for label, kern, plain in (
                ("flash_attention",
                 lambda: fa.flash_attention_fused(wide, wide, wide, True),
                 lambda: fa._plain_bshd(wide, wide, wide, True, s, None)),
                ("flash_attention_bwd",
                 lambda: fa.flash_attention_bwd_fused(wide, wide, wide, o,
                                                      lse, go, True),
                 lambda: fa._plain_bwd_bshd(wide, wide, wide, o, lse, go,
                                            True, s)),
                ("decode_attention",
                 lambda: da.decode_attention(wide[:, :1], ring, ring, pos),
                 lambda: da.ref_decode_attention(wide[:, :1], ring, ring,
                                                 pos)),
                ("paged_attention", lambda: pa.paged_attention(*paged),
                 lambda: pa._paged_attention_ref(*paged))):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if not isinstance(ref, tuple):
                got, ref = (got,), (ref,)
            for a, b in zip(got, ref):
                err, tol = _err(torch, a, b), _tol(dname, b)
                if not err <= tol:
                    raise AssertionError(f"{label} {dname} head_dim 520: "
                                         f"kernel and plain differ by {err}"
                                         f" > {tol}")
            print(f"computed {label} {dname} head_dim 520 (refused before "
                  "Queue C8): within the tolerance of the plain version")
    q = torch.ones(1, 1, 8, 128, dtype=dt, device=dev)
    kv = torch.ones(1, 512, 8, 128, dtype=dt, device=dev)
    # (splits, ring rows, dtype code)
    for what, (splits, L, code) in {
            "16 splits": (16, 512, 1),
            "3 splits": (3, 512, 1),
            "more splits than key tiles": (8, 448, 1),
            "float16": (1, 512, 2)}.items():
        err = _build.lib().ptt_decode_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), 1, L, 8, 8, 128, 0.1, splits, code,
            torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"decode_attention {what} not refused: "
                                 f"{err}")
        print(f"refused decode_attention plan with {what}: cudaError_t 1")
    # the C dispatch refuses a flash tile pair it has no instance for
    # (cudaErrorInvalidValue, 1; the wrapper refuses it first, so the entry
    # is called directly)
    from paddle_tpu_torch.ops.hopper import _build
    x = torch.zeros(1, 64, 1, 64, dtype=dt, device=dev)
    lse = torch.zeros(1, 1, 64, device=dev)
    err = _build.lib().ptt_flash_attention(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), None, 1, 64, 64, 1, 1, 64, *x.stride()[:3],
        *x.stride()[:3], *x.stride()[:3], 0, 0, 0.125, 32, 32, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 1:
        raise AssertionError(f"flash tiles (32, 32) not refused: {err}")
    print("refused flash_attention bf16 tiles (32, 32): cudaError_t 1")
    # B7 takes float32 or bfloat16 x and int8 weights, nothing else
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul
    q8 = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    s8 = torch.ones(32, device=dev)
    for label, call in {
            "int8_matmul float16 x": lambda: int8_matmul(
                torch.ones(4, 64, dtype=torch.float16, device=dev), q8, s8),
            "int8_matmul int32 qw": lambda: int8_matmul(
                torch.ones(4, 64, dtype=dt, device=dev), q8.int(), s8)
    }.items():
        try:
            call()
        except TypeError as e:
            print(f"refused {label}: {e}")
        else:
            raise AssertionError(f"{label} was not refused")
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 3
def _counters():
    """The kernel wrappers that count their launches, from the package (a
    CUDA graph's replay adds its captured counts to the same ones)."""
    from paddle_tpu_torch.ops.hopper import launch_counters

    return launch_counters()


def _zero_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["int8_matmul"].bias_launches = 0   # B7 with the bias fused
    for name in ("paged_attention", "paged_attention_int8"):
        counters[name].mask_launches = 0        # the masked instances
    return counters


def _path_launches(path, counters):
    """Read the counters after a path's run; raise if one of its kernels
    never launched."""
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"launches {path} {json.dumps(launches)}")
    for k in PATHS[path]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 f"{path} path")
    return launches


def _serve_waves(eng, waves, logprobs=None):
    """Run each wave of (prompt, max_new_tokens, sampling) to completion;
    check every request returned its token count.  ``logprobs``, a list,
    gets each request's logprobs (None where it asked for none)."""
    out = []
    for wave in waves:
        rids = [eng.add_request(p, max_new_tokens=n, sampling=s)
                for p, n, s in wave]
        done = eng.run()
        eng.pop_finished()
        lps = eng.pop_token_logprobs()
        for rid, (_, n, _) in zip(rids, wave):
            if len(done[rid]) != n:
                raise AssertionError(f"request {rid} returned "
                                     f"{len(done[rid])} of {n} tokens")
            out.append(done[rid])
            if logprobs is not None:
                logprobs.append(lps.get(rid))
    return out


def _step_meter(torch, eng):
    """Meter ``eng``'s single steps: a dict that counts the ``step()``
    calls that ran the single-step program (``steps``), their
    ``phase_seconds["execute"]`` (``execute``, seconds: the program and
    its one read-back) and the runs of ``_run_step`` outside a CUDA graph
    capture (``eager``: on graphs only a key's first call; on the eager
    loops every step)."""
    meter = {"steps": 0, "execute": 0.0, "eager": 0}
    step, graphed, run_step = eng.step, eng._graphed, eng._run_step
    ran = [False]

    def graphed_(key, fn, arrays):
        ran[0] = ran[0] or key[0] == "step"
        return graphed(key, fn, arrays)

    def run_step_(*args):
        if not torch.cuda.is_current_stream_capturing():
            meter["eager"] += 1
        return run_step(*args)

    def step_():
        ran[0] = False
        t0 = eng.phase_seconds["execute"]
        out = step()
        if ran[0]:
            meter["steps"] += 1
            meter["execute"] += eng.phase_seconds["execute"] - t0
        return out

    eng.step, eng._graphed, eng._run_step = step_, graphed_, run_step_
    return meter


def _metered(meter, fn, out):
    """``fn`` wrapped: each call leaves in ``out`` how far ``meter`` moved
    over it."""
    def run():
        m0 = dict(meter)
        fn()
        out.update({k: meter[k] - m0[k] for k in meter})
    return run


def _step_report(where, label, waves, graphs):
    """Print each wave's single steps (their count, execute ms, eager runs
    of ``_run_step``); on graphs a timed wave must run none eagerly (every
    step key was captured in an earlier wave)."""
    for name, d in waves.items():
        print(f"single steps in the {name} {where}, {label}: {d['steps']} "
              f"steps, execute {d['execute'] * 1e3:.2f} ms "
              f"({d['execute'] * 1e3 / max(d['steps'], 1):.2f} ms a step), "
              f"{d['eager']} eager runs of the step program")
        if graphs and name != "first" and d["eager"]:
            raise AssertionError(f"{where}, {label}: {d['eager']} eager "
                                 f"single steps in the {name} wave")


def _sync_free(torch, loop):
    """Run ``loop`` with CUDA sync debugging set to raise: any operation
    that waits for the device inside it (``.item()``, a device-to-host
    copy) is an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def full_width_model(torch):
    """Llama-2-7B geometry in bfloat16, seeded random weights, on cuda."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    t = time.perf_counter()
    model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama_7b: {n_params} parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16, init seconds "
          f"{time.perf_counter() - t:.3f}")
    return model


def full_width_serving(torch, model):
    """Phase 3: the 7B geometry served through CUDA graphs (the engine's
    default on CUDA) and, over the same model (the same weight tensors, a
    KV pool of its own), through the eager loops (``_graphs = False``):
    the same waves give identical tokens, logprobs and scheduling
    counters; then the decode wave on each, untraced and profiled."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    eng = ServingEngine(model, **SERVE_KW)
    eager = ServingEngine(model, **SERVE_KW)
    eager._graphs = False
    kv_gb = sum(c.numel() * c.element_size()
                for c in eng.key_caches + eng.value_caches) / 1e9
    print(f"KV pool {eng.blocks.num_blocks} blocks, {kv_gb:.2f} GB (one "
          "for each engine)")
    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    greedy = dict(logprobs=True)
    sampled = dict(temperature=0.8, top_p=0.9, seed=7, logprobs=True)
    lens = [7, 40, 128, 200, 260, 33, 400, 90, 150]
    news = [48, 32, 64, 40, 56, 1, 36, 60, 44]
    wave1 = [(prompt(n), m, sampled if i == 3 else greedy)
             for i, (n, m) in enumerate(zip(lens, news))]
    wave2 = [(wave1[2][0], 32, greedy), (prompt(70), 40, greedy)]
    # no host sync inside a device program (the eager loops and steps, a
    # key's first call and its capture) or a replay (main): each raises on
    # one
    for e in (eng, eager):
        for name in ("_run_megastep", "_run_mixed", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    replays0 = _REPLAYS[0]
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(eng, [wave1], lps)
    torch.cuda.synchronize()
    wave1_s = time.perf_counter() - t
    outs += _serve_waves(eng, [wave2], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("serving", counters)
    st = eng.state_summary()
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {n_tok} tokens in {secs:.3f} s "
          f"({n_tok / secs:.1f} tokens/s, informative); wave 1 (one "
          f"sampled request) {wave1_s:.3f} s; {_REPLAYS[0] - replays0} "
          "graph replays, each under CUDA sync debugging set to raise")
    print(f"megastep {st['megastep']} prefill_tokens_computed "
          f"{eng.prefill_tokens_computed} prefix_hit_blocks "
          f"{eng.prefix_hit_blocks}")
    print(f"phase_seconds {json.dumps(st['phase_seconds'])}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    if not (eng.megasteps > 0 and eng.megasteps_mixed > 0
            and eng.prefix_hit_blocks > 0):
        raise AssertionError("the serving run did not arm the megastep, the "
                             "mixed loop and the prefix cache")
    for o in outs:
        if any(not 0 <= t < cfg.vocab_size for t in o):
            raise AssertionError("token outside the vocabulary")
    cache = eng._graph_cache
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not (eng.compile_count == cache.captures == len(cache.seconds)
            == len(cache.graphs) > 0 and eager.compile_count == 0):
        raise AssertionError(f"compile_count {eng.compile_count} is not the "
                             f"{len(cache.seconds)} graphs captured")
    # the eager loops over the same waves: identical
    e_lps = []
    t = time.perf_counter()
    e_outs = _serve_waves(eager, [wave1, wave2], e_lps)
    torch.cuda.synchronize()
    e_secs = time.perf_counter() - t
    names = ("megasteps", "megasteps_mixed", "prefill_chunks",
             "prefix_hit_blocks")
    got = [getattr(eng, n) for n in names]
    want = [getattr(eager, n) for n in names]
    if outs != e_outs or lps != e_lps or got != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"graphs and eager loops differ: tokens of "
                             f"requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}")
    print(f"graphs == eager: tokens, logprobs and {names} {got} identical "
          f"over {len(outs)} requests (the sampled one too); compile_count "
          f"{eng.compile_count} (eager 0); served in {secs:.3f} s with "
          f"graphs, {e_secs:.3f} s eager (informative)")
    # the decode-heavy wave on each engine (8 rows, 64-token prompts, 32 new
    # tokens each): a first wave captures the keys it adds (its wall
    # printed), then the untraced wall of the next, then K4's kernels in
    # the traced one against its wrapper's count there (one launch per
    # call; a replay adds its captured count)
    waves = [[(prompt(64), 32, None) for _ in range(8)] for _ in range(3)]
    for label, e in (("graphs", eng), ("eager", eager)):
        calls = []
        meter = _step_meter(torch, e)
        stepped = {"first": {}, "untraced": {}, "traced": {}}

        def traced(e=e):
            n0 = pa.paged_attention.launches
            _serve_waves(e, [waves[2]])
            calls.append(pa.paged_attention.launches - n0)

        n_cap = e.compile_count
        torch.cuda.synchronize()
        t = time.perf_counter()
        _metered(meter, lambda e=e: _serve_waves(e, [waves[0]]),
                 stepped["first"])()
        torch.cuda.synchronize()
        print(f"decode wave, {label}, first: wall "
              f"{(time.perf_counter() - t) * 1e3:.2f} ms, "
              f"{e.compile_count - n_cap} graphs captured in it")
        n_cap = e.compile_count
        torch.cuda.reset_peak_memory_stats()
        evs = _profile(torch, f"decode wave, {label} (8 rows, 64-token "
                       "prompts, 32 new tokens)",
                       _metered(meter, lambda e=e: _serve_waves(e, [waves[1]]),
                                stepped["untraced"]),
                       _metered(meter, traced, stepped["traced"]), top=15)
        _step_report("decode wave", label, stepped, e is eng)
        print(f"memory decode wave, {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, memory_reserved "
              f"{torch.cuda.memory_reserved()} bytes; graphs captured in "
              f"the measured waves {e.compile_count - n_cap}")
        _k1_k2(evs, f"the decode wave, {label}")
        k4 = [ev for ev in evs if "paged_attention" in ev.key]
        k4_n = sum(ev.count for ev in k4)
        k4_ms = sum(ev.self_device_time_total for ev in k4) / 1e3
        print(f"profile K4 in the decode wave, {label}: {k4_ms:.3f} ms "
              f"device, {k4_n} kernels, {calls[-1]} wrapper calls")
        if k4_n != calls[-1]:
            raise AssertionError(f"K4 ({label}): {k4_n} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([ev.key for ev in k4], f"K4 in the decode wave, {label}")
    _draw_cost(torch, cfg.vocab_size)
    return launches


def _draw_cost(torch, V):
    """CUDA-event time of one sampling step of the engine (8 rows of
    float32 logits, V wide) with one seeded sampled row (top-k 0, top-p
    0.9, temperature 0.8) against the same step all greedy, and of the
    threefry draw alone."""
    from paddle_tpu_torch.inference.serving import _draw, _sample_tokens

    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    B = 8
    lg = torch.randn(B, V, generator=g, device="cuda") * 3
    temps = torch.zeros(B, device="cuda")
    temps[3] = 0.8
    top_ks = torch.zeros(B, dtype=torch.int32, device="cuda")
    top_ps = torch.full((B,), 0.9, device="cuda")
    seeds = torch.arange(B, dtype=torch.int32, device="cuda")
    spos = torch.full((B,), 17, dtype=torch.int32, device="cuda")
    timer = Timer(torch, 20)
    sampled = timer(lambda: _sample_tokens(lg, temps, top_ks, top_ps, seeds,
                                           spos, all_greedy=False))
    greedy = timer(lambda: _sample_tokens(lg, temps, top_ks, top_ps, seeds,
                                          spos, all_greedy=True))
    draw = timer(lambda: _draw(lg, seeds, spos))
    print(f"sampling step [{B}, {V}]: one sampled row {sampled:.4f} ms, all "
          f"greedy {greedy:.4f} ms, threefry draw alone {draw:.4f} ms")


def _unmasked(names, label):
    """Raise unless each of the profiled K4 / K4-int8 kernel ``names`` is
    an unmasked instance, its last template argument (kMask) false: the
    serving engines pass no mask, so they launch what they did before the
    masks."""
    import re

    instances = set()
    for name in names:
        m = re.search(r"paged_attention\w*<([^<>]*)>", name)
        if m is None or m.group(1).rsplit(",", 1)[-1].strip() != "false":
            raise AssertionError(f"{label}: not an unmasked instance: "
                                 f"{name[:200]}")
        instances.add(m.group(0))
    print(f"{label}: every kernel unmasked (kMask false): "
          f"{', '.join(sorted(instances))}")


def _profile(torch, label, untraced, traced=None, top=12, trace=None):
    """Run ``untraced()`` on the host clock (wall time), then ``traced()``
    (the same call by default) under torch.profiler: the device's busy share
    of the untraced wall time (one stream, so kernel times do not overlap;
    the trace's own wall time is inflated by the profiler) and device time
    by kernel.

    The profiler can lose a run of device records at the start or the end
    of a session (on an H100: all 64 marker kernels and the next 14 of a
    process's second session; 14 of 992 B2 kernels of phase 5's
    greedy_decode; 132 trailing markers of phase 3's wave).  So the
    traced call sits between ``_PROFILE_MARKS`` spin kernels on each side,
    synchronized, and a trace counts only when some of the markers on each
    side were recorded: then no kernel of the call was lost at an end.
    Otherwise the trace is taken again, ``_PROFILE_TAKES`` times at most.
    ``trace``, a list, gets the kept trace's device kernels (markers
    excluded) in the order they started."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA

    def marks():
        for _ in range(_PROFILE_MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t = time.perf_counter()
    untraced()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    for take in range(1, _PROFILE_TAKES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marks()
            (traced or untraced)()
            torch.cuda.synchronize()
            marks()
        kernels = [e for e in prof.events() if e.device_type == cuda]
        spins = [e.time_range.start for e in kernels
                 if "spin_kernel" in e.name]
        work = [e.time_range.start for e in kernels
                if "spin_kernel" not in e.name]
        before = sum(s < min(work) for s in spins) if work else 0
        after = sum(s > max(work) for s in spins) if work else 0
        print(f"profile {label}, take {take}: {before} and {after} of "
              f"{_PROFILE_MARKS} marker kernels recorded before and after "
              "the call")
        if before and after:
            break
    else:
        raise AssertionError(f"profile {label}: the profiler lost the "
                             f"markers at an end of {_PROFILE_TAKES} traces")
    if trace is not None:
        trace.extend(sorted((e for e in prof.events()
                               if e.device_type == cuda
                               and "spin_kernel" not in e.name),
                              key=lambda e: e.time_range.start))
    evs = [e for e in prof.key_averages()
           if e.device_type == cuda and "spin_kernel" not in e.key]
    dev_us = sum(e.self_device_time_total for e in evs)
    print(f"profile {label}: untraced wall {wall_us / 1e3:.2f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms ({100 * dev_us / wall_us:.1f}%), "
          f"{sum(e.count for e in evs)} device kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d}  {e.key[:90]}")
    return evs


def _k1_k2(evs, where):
    """K1's and K2's device time, kernel count and time a launch in a
    profile, by kernel name (also where they miss the top of the list)."""
    for name, kernel in (("K1", "rms_kernel"), ("K2", "rope_kernel")):
        mine = [e for e in evs if kernel in e.key]
        n = sum(e.count for e in mine)
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        print(f"profile {name} ({kernel}) in {where}: {ms:.3f} ms device, "
              f"{n} kernels, {1e3 * ms / max(n, 1):.2f} us a launch")


# --------------------------------------------------------------- phase 4
def _first_step_logits(torch, eng, prompts):
    """Logits of the first (all-prefill) step of ``prompts`` on a fresh
    engine: one packed buffer, every row prefilled from position 0."""
    import numpy as np

    for p in prompts:
        eng.add_request(p, max_new_tokens=1)
    eng._try_admit()
    B = eng.B
    now = np.zeros(B, np.int32)
    for req in eng._active.values():
        now[req.slot] = len(req.prompt)
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    tokens = np.zeros(eng.T, np.int32)
    for req in eng._active.values():
        tokens[cu[req.slot]:cu[req.slot + 1]] = req.prompt
    d = eng._dev
    with torch.no_grad():
        return eng._forward(d(tokens), d(now), d(np.zeros(B, np.int32)),
                            d(now), d(cu), d(eng.block_tables),
                            eng.T).float().cpu()


def _forced_trunk(torch, eng, seq):
    """The trunk's output [T, E] with ``seq`` prefilled from position 0 on
    a fresh engine (teacher forcing)."""
    import numpy as np

    eng.add_request(seq, max_new_tokens=1)
    eng._try_admit()
    n = len(seq)
    z = np.zeros(eng.B, np.int32)
    now = z.copy()
    now[0] = n
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    tokens = np.zeros(eng.T, np.int32)
    tokens[:n] = seq
    d = eng._dev
    return eng._trunk(d(tokens), d(now), d(z), d(now), d(cu),
                      d(eng.block_tables), eng.T)


def _top2_gaps(torch, eng, prompt, gen):
    """CPU teacher-forced logits of prompt + gen[:-1] on a fresh engine ->
    the top-2 logit gap at each generated position."""
    seq = list(prompt) + list(gen[:-1])
    h = _forced_trunk(torch, eng, seq)
    lg = (h[len(prompt) - 1:len(seq)] @ eng._weights["head"]).float()
    top2 = torch.topk(lg, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _logits_at(torch, eng, prompt, gen):
    """The float32 logits [V] after prompt + gen, teacher-forced on a fresh
    engine: the row from which the next token is chosen."""
    seq = list(prompt) + list(gen)
    with torch.no_grad():
        h = _forced_trunk(torch, eng, seq)
        return (h[len(seq) - 1] @ eng._weights["head"]).float().cpu()


def _agree(a, b, gaps, what, thresh=1e-3):
    """Tokens equal up to the first position whose top-2 gap < thresh."""
    stop = next((i for i, g in enumerate(gaps) if g < thresh), len(gaps))
    if stop < len(gaps):
        print(f"{what}: top-2 gap {gaps[stop]:.2e} < {thresh:.1e} at "
              f"position {stop}; compared positions 0..{stop - 1}")
    if a[:stop] != b[:stop]:
        raise AssertionError(f"{what}: tokens differ before position {stop}:"
                             f" {a[:stop]} vs {b[:stop]}")


# the head dims the tensor-core classes do not hold (640: past 512, the
# wide instances): head_dim -> (hidden, heads, intermediate) of a 2-layer
# float32 Llama (phases 4, 6 and 8), with
# a 4096-token vocabulary: random weights at these widths give logits
# below 1, and over 32000 tokens the top-2 gaps fall under the 1e-3 at
# which the token comparisons stop
HEAD_DIM_LLAMAS = {72: (576, 8, 1536), 100: (800, 8, 2048),
                   264: (1056, 4, 2816), 640: (1280, 2, 3456)}


def two_layer_models(torch, head_dim=None, seed=1):
    """The 7B geometry at 2 layers in float32 (or, with ``head_dim``, the
    2-layer Llama of ``HEAD_DIM_LLAMAS``), on cuda and on the CPU, with
    identical weights from ``seed`` (phases 4, 6 and 8)."""
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        llama_7b,
        load_numpy_state_dict,
    )

    if head_dim is None:
        cfg = llama_7b(dtype="float32", num_hidden_layers=2)
    else:
        hidden, heads, inter = HEAD_DIM_LLAMAS[head_dim]
        cfg = llama_7b(dtype="float32", num_hidden_layers=2,
                       hidden_size=hidden, num_attention_heads=heads,
                       intermediate_size=inter, vocab_size=4096)
        assert cfg.head_dim == head_dim
    gpu_model = LlamaForCausalLM(cfg, seed=seed)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    load_numpy_state_dict(cpu_model, {k: v.cpu().numpy() for k, v in
                                      gpu_model.state_dict().items()})
    return gpu_model, cpu_model


def kernels_vs_plain_path(torch, gpu_model, cpu_model):
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = gpu_model.config
    engine_kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
                     token_budget=128)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 48, 20)]
    # first-step logits: kernels on cuda vs plain on the CPU.  float32
    # logits of magnitude ~50 after two layers: XLA-free but differently
    # ordered sums (cuBLAS vs MKL, the kernels' reductions)
    lg_gpu = _first_step_logits(torch, ServingEngine(gpu_model, **engine_kw),
                                prompts)
    lg_cpu = _first_step_logits(
        torch, ServingEngine(cpu_model, device="cpu", **engine_kw), prompts)
    err = float((lg_gpu - lg_cpu).abs().max())
    tol = 1e-3 * float(lg_cpu.abs().max()) + 1e-3
    print(f"first-step logits: max_abs_err {err:.3e} tol {tol:.3e} "
          f"(max |logit| {float(lg_cpu.abs().max()):.3f})")
    if not err <= tol:
        raise AssertionError("first-step logits differ beyond tolerance")
    # greedy serving, 16 new tokens each; the repeat of prompt 1 comes
    # after the first wave retired, so it hits the prefix cache
    waves = [[(p, 16, None) for p in prompts], [(prompts[1], 16, None)]]
    gpu = _serve_waves(ServingEngine(gpu_model, **engine_kw), waves)
    cpu = _serve_waves(ServingEngine(cpu_model, device="cpu", **engine_kw),
                       waves)
    off_eng = ServingEngine(gpu_model, prefix_cache=False, **engine_kw)
    gpu_off = _serve_waves(off_eng, waves)
    flat = [p for w in waves for p, _, _ in w]
    for i, p in enumerate(flat):
        gaps = _top2_gaps(torch, ServingEngine(cpu_model, device="cpu",
                                               **engine_kw), p, cpu[i])
        _agree(gpu[i], cpu[i], gaps, f"request {i} cuda vs cpu")
        _agree(gpu[i], gpu_off[i], gaps,
               f"request {i} prefix cache on vs off")
    print(f"kernel path == plain path on {len(flat)} requests "
          f"(prefix hit blocks on cuda: repeat served)")


def _load_weights_on_graphs(torch, gpu_model, other):
    """A graph engine that served ``gpu_model``, after ``load_weights(other)``
    (the same geometry, other weights): its graphs are dropped (they read
    the old weights), it captures again, and it serves ``other``'s tokens,
    those of a fresh graph engine over ``other`` (the same kernels on the
    same card: identical)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128)
    rng = np.random.default_rng(23)
    V = gpu_model.config.vocab_size
    waves = [[(rng.integers(1, V, n).tolist(), 16, None)
              for n in (9, 33, 48)], [(rng.integers(1, V, 5).tolist(), 16,
                                       None)]]
    eng = ServingEngine(gpu_model, **kw)
    old = _serve_waves(eng, waves)
    n = eng.compile_count
    eng.load_weights(other, version="v1")
    if eng._graph_cache.graphs or eng.compile_count != n or not n:
        raise AssertionError(f"load_weights kept "
                             f"{len(eng._graph_cache.graphs)} "
                             f"graphs (compile_count {n} -> "
                             f"{eng.compile_count})")
    got = _serve_waves(eng, waves)
    want = _serve_waves(ServingEngine(other, **kw), waves)
    if got != want or got == old or eng.compile_count <= n:
        raise AssertionError("after load_weights the graph engine does not "
                             "serve the new weights' tokens")
    print(f"load_weights: graphs dropped and captured again (compile_count "
          f"{n} -> {eng.compile_count}); the new weights' tokens on "
          f"{len(got)} requests")


# --------------------------------------------------------------- phase 5
def _forced_logits(torch, model, ids, toks, static):
    """Last-position logits [B, n, V] (float32) of the prefill and of each
    decode step fed ``toks[:, :-1]``: the logits from which a decode loop
    picked ``toks``, through the ring (static) or growing caches."""
    from paddle_tpu_torch.models.generation import _ring_length, _Rings

    B, S = ids.shape
    n = toks.shape[1]
    cfg = model.config
    if static:
        rings = _Rings(model, B, _ring_length(model, S, n, None))

        def fwd(x):
            return rings.forward(model, x)
    else:
        dt = model.llama.embed_tokens.weight.dtype
        z = torch.zeros((B, 0, cfg.num_key_value_heads, cfg.head_dim),
                        dtype=dt, device=ids.device)
        caches = [(z, z) for _ in range(cfg.num_hidden_layers)]

        def fwd(x):
            nonlocal caches
            logits, caches = model(x, caches=caches)
            return logits
    out = []
    with torch.no_grad():
        out.append(fwd(ids)[:, -1].float())
        for i in range(n - 1):
            out.append(fwd(toks[:, i:i + 1])[:, -1].float())
    return torch.stack(out, dim=1)


def _gaps(torch, logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().tolist()


def full_width_generation(torch, model):
    """Phase 5 on the 7B model; returns the generation path's launches."""
    from paddle_tpu_torch.framework.random import Generator
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    V = model.config.vocab_size
    g = torch.Generator(device="cuda")
    g.manual_seed(5)

    def ids(B, S):
        return torch.randint(1, V, (B, S), generator=g, device="cuda")

    def in_vocab(toks, what):
        if not bool(((toks >= 0) & (toks < V)).all()):
            raise AssertionError(f"{what}: token outside the vocabulary")

    p2, p8, p4 = ids(2, 1024), ids(8, 128), ids(4, 200)
    torch.cuda.synchronize()
    counters = _zero_counters()
    t = time.perf_counter()
    with torch.no_grad():
        logits = model(p2)
    if logits.shape != (2, 1024, V) or not bool(torch.isfinite(
            logits).all()):
        raise AssertionError(f"forward logits {tuple(logits.shape)} are not "
                             "finite [2, 1024, V]")
    print(f"(a) forward [2, 1024]: {time.perf_counter() - t:.3f} s, "
          f"logits finite")
    del logits
    # B2's kernels in the traced loop, against its wrapper's count there
    # (one launch per call; a replay adds its captured count)
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import fused_ops as fo

    runs = {}
    for mode in ("eager", "graphs"):
        model._graphs = mode == "graphs"
        # earlier phases' objects held in reference cycles go now, not
        # during the loop (the peak is measured from here)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if model._graphs:
            # the key's first call synchronises and captures: warm it
            # before the sync-free loop and the untraced timing
            t = time.perf_counter()
            greedy_decode(model, p8, max_new_tokens=2, max_length=512)
            torch.cuda.synchronize()
            first, cap = model._decode_graphs.seconds[("decode", 8, 512)]
            print(f"(b) graphs: key (8, 512) warmed in "
                  f"{time.perf_counter() - t:.3f} s: first call (eager "
                  f"step) {first * 1e3:.1f} ms, capture {cap * 1e3:.1f} ms")
        t = time.perf_counter()
        toks = _sync_free(torch, greedy_decode)(model, p8,
                                               max_new_tokens=128,
                                               max_length=512)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        in_vocab(toks, "greedy_decode")
        print(f"(b) {mode}: greedy_decode [8, 128] + 128 tokens, ring 512: "
              f"{secs:.3f} s ({8 * 128 / secs:.1f} tokens/s, informative), "
              "no host sync inside the loop")
        calls = []

        def traced():
            n0 = (da.decode_attention.launches, fo.rope_ring_fused.launches,
                  fo.rope_fused.launches, da.kv_ring_write.launches)
            out = greedy_decode(model, p8, max_new_tokens=32, max_length=512)
            calls.append([n - m for n, m in zip(
                (da.decode_attention.launches, fo.rope_ring_fused.launches,
                 fo.rope_fused.launches, da.kv_ring_write.launches), n0)]
                + [out])

        evs = _profile(torch, f"greedy_decode [8, 128] + 32 tokens, {mode}",
                       lambda: greedy_decode(model, p8, max_new_tokens=32,
                                             max_length=512), traced)
        n_kernels = sum(e.count for e in evs)
        print(f"profile greedy_decode, {mode}: {n_kernels} kernels in the "
              f"trace; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, memory_allocated "
              f"after {torch.cuda.memory_allocated()} bytes")
        _k1_k2(evs, f"greedy_decode, {mode}")
        b2 = [e for e in evs if "decode_tc_kernel" in e.key
              or "decode_simt_kernel" in e.key]
        b2_n = sum(e.count for e in b2)
        b2_ms = sum(e.self_device_time_total for e in b2) / 1e3
        b2_calls, ring_calls, rope_calls, b3_calls, toks32 = calls[-1]
        print(f"profile B2 in greedy_decode, {mode}: {b2_ms:.3f} ms device, "
              f"{b2_n} kernels, {b2_calls} wrapper calls")
        if b2_n != b2_calls:
            raise AssertionError(f"B2 ({mode}): {b2_n} kernels for "
                                 f"{b2_calls} calls")
        # B3 is folded into K2's ring mode: no ring-write kernel, and every
        # K2 kernel of the loop is a ring-mode call (the plain mode is not
        # called)
        b3_n = sum(e.count for e in evs if "ring_write_kernel" in e.key)
        k2 = [e for e in evs if "rope_kernel" in e.key]
        k2_n = sum(e.count for e in k2)
        k2_ms = sum(e.self_device_time_total for e in k2) / 1e3
        print(f"profile K2 ring mode in greedy_decode, {mode}: {k2_ms:.3f} "
              f"ms device, {k2_n} kernels, {ring_calls} ring-mode calls, "
              f"{rope_calls} plain rope calls; B3: {b3_n} kernels, "
              f"{b3_calls} calls")
        if b3_n or b3_calls:
            raise AssertionError(f"greedy_decode launched B3 ({b3_n} "
                                 f"kernels, {b3_calls} calls): it is "
                                 "folded into K2")
        if rope_calls or k2_n != ring_calls:
            raise AssertionError(f"K2 in greedy_decode ({mode}): {k2_n} "
                                 f"kernels for {ring_calls} ring-mode and "
                                 f"{rope_calls} plain calls")
        runs[mode] = (toks, toks32, calls[-1][:4],
                      {e.key: e.count for e in evs})
    model._graphs = True
    (e128, e32, e_calls, e_n), (g128, g32, g_calls, g_n) = (runs["eager"],
                                                            runs["graphs"])
    cache = model._decode_graphs
    if not (torch.equal(g128, e128) and torch.equal(g32, e32)):
        raise AssertionError(
            f"greedy_decode on graphs differs from the eager loop: "
            f"{int((g128 != e128).sum())} of {g128.numel()} tokens at + 128, "
            f"{int((g32 != e32).sum())} of {g32.numel()} at + 32")
    # the same kernels by name and count, but for the fills: the eager
    # loop zeroes fresh rings each call (2 a layer, pos and the token
    # buffer), the graph loop only resets its key's pos
    fills = [sum(n for k, n in d.items() if "FillFunctor" in k)
             for d in (e_n, g_n)]
    differ = {k for k in set(e_n) | set(g_n) if "FillFunctor" not in k
              and e_n.get(k) != g_n.get(k)}
    layers = model.config.num_hidden_layers
    if (differ or e_calls != g_calls or fills[0] - fills[1] != 2 * layers + 1
            or cache.captures != 1):
        raise AssertionError(f"greedy_decode's traces differ: {sorted(differ)}"
                             f", counters {e_calls} / {g_calls}, fills "
                             f"{fills}; {cache.captures} captures")
    print(f"(b) greedy_decode graphs == eager: tokens at + 128 and + 32 bit "
          f"for bit; kernels by name and count equal ({sum(g_n.values())} "
          f"on graphs, {sum(e_n.values())} eager: fill kernels {fills[1]} / "
          f"{fills[0]}, the eager loop's fresh rings), 1 capture")
    ref = greedy_decode(model, p4, max_new_tokens=32)
    ring = generate(model, p4, max_new_tokens=32, use_static_cache=True)
    grow = generate(model, p4, max_new_tokens=32)
    if not torch.equal(ring, ref):
        raise AssertionError("generate(use_static_cache=True) differs from "
                             "greedy_decode (the same kernels and shapes)")
    if not torch.equal(grow[:, 0], ref[:, 0]):
        raise AssertionError("generate with growing caches differs from "
                             "greedy_decode at the first token (one prefill)")
    f_ring = _forced_logits(torch, model, p4, ref, True)
    f_grow = _forced_logits(torch, model, p4, ref, False)
    noise = float((f_ring - f_grow).abs().max())
    scale = float(f_ring.abs().max())
    print(f"(c) generate ring == greedy_decode; ring vs growing caches on "
          f"the same tokens: max logit difference {noise:.3e} (max |logit| "
          f"{scale:.3f})")
    # bf16 activations through 32 layers; each layer's output is rounded
    # to 8 mantissa bits (0.4%) on paths that sum in different orders
    if not noise <= 0.05 * scale:
        raise AssertionError(f"ring and growing-cache decode logits differ by "
                             f"{noise} > 5% of {scale}")
    thresh = max(1e-3, 2 * noise)
    gaps = _gaps(torch, f_ring)
    for r in range(p4.shape[0]):
        _agree(grow[r].tolist(), ref[r].tolist(), gaps[r],
               f"row {r} growing vs ring", thresh)
    sampled = generate(model, p4, max_new_tokens=32, do_sample=True,
                       top_p=0.9, use_static_cache=True,
                       generator=Generator(7))
    in_vocab(sampled, "generate(do_sample=True)")
    print(f"(d) sampled {tuple(sampled.shape)} tokens, "
          f"{int((sampled != ref).sum())} of {sampled.numel()} differ from "
          "greedy")
    # greedy_decode, generate and the sampled generate on [4, 200] share
    # the (4, 232) key: one more capture
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager step) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if cache.captures != 2 or set(cache.graphs) != {("decode", 8, 512),
                                                    ("decode", 4, 232)}:
        raise AssertionError(f"{cache.captures} captures, keys "
                             f"{sorted(cache.graphs)}")
    return _path_launches("generate", counters)


# --------------------------------------------------------------- phase 6
def generation_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4's float32 pair: forward logits, and greedy tokens of
    greedy_decode / generate on cuda against greedy_decode on the CPU."""
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    g = torch.Generator()
    g.manual_seed(13)
    V = gpu_model.config.vocab_size
    ids = torch.randint(1, V, (2, 64), generator=g)
    with torch.no_grad():
        lg_gpu = gpu_model(ids.cuda()).cpu()
        lg_cpu = cpu_model(ids)
    err = float((lg_gpu - lg_cpu).abs().max())
    tol = 1e-3 * float(lg_cpu.abs().max()) + 1e-3
    print(f"forward logits [2, 64]: max_abs_err {err:.3e} tol {tol:.3e}")
    if not err <= tol:
        raise AssertionError("forward logits differ beyond tolerance")
    p = ids[:, :32]
    cpu = greedy_decode(cpu_model, p, 16, max_length=64)
    gaps = _gaps(torch, _forced_logits(torch, cpu_model, p, cpu, True))
    for what, got in (
            ("greedy_decode", greedy_decode(gpu_model, p.cuda(), 16,
                                            max_length=64)),
            ("generate ring", generate(gpu_model, p.cuda(), 16,
                                       use_static_cache=True)),
            ("generate growing", generate(gpu_model, p.cuda(), 16))):
        got = got.cpu()
        for r in range(p.shape[0]):
            _agree(got[r].tolist(), cpu[r].tolist(), gaps[r],
                   f"{what} row {r} cuda vs cpu")
    # the same call on the eager loop: the graph path's bits
    gpu_model._graphs = False
    eager = greedy_decode(gpu_model, p.cuda(), 16, max_length=64)
    gpu_model._graphs = True
    graph = greedy_decode(gpu_model, p.cuda(), 16, max_length=64)
    if not torch.equal(graph, eager):
        raise AssertionError("greedy_decode on graphs differs from the eager "
                             "loop on cuda")
    print("generation kernel path == plain path (greedy_decode, generate "
          "ring and growing); greedy_decode on graphs == the eager loop on "
          f"cuda, bit for bit ({gpu_model._decode_graphs.captures} "
          "captures)")


# --------------------------------------------------------------- phase 7
def _train_setup(torch, model, lr):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=True)
    crit = LlamaPretrainingCriterion()
    return TrainStep(model, lambda m, ids: crit(m(ids), ids), opt)


def full_width_training(torch):
    """Phase 7: bench.py's honest geometry in bfloat16 with recompute,
    AdamW(1e-4, multi_precision) through TrainStep on one [8, 2048] batch;
    returns the training path's launches."""
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=2560,
                      intermediate_size=8192, num_hidden_layers=9,
                      num_attention_heads=20, max_position_embeddings=2048,
                      dtype="bfloat16", recompute=True)
    B, S = 8, 2048
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    step = _train_setup(torch, model, 1e-4)
    torch.cuda.synchronize()
    n_params = model.num_params
    print(f"train model: {n_params} parameters, {len(list(model.parameters()))}"
          f" tensors, setup seconds {time.perf_counter() - t:.3f}")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device="cuda")
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        losses.append(step(ids))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 10
    lv = torch.stack(losses).float().cpu()
    print(f"losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()) or not lv[-1] < lv[0]:
        raise AssertionError(f"training losses not finite and falling: {lv}")
    tok_s = B * S / dt
    # bench.py:96: 6 N per token (forward + backward) + the attention term
    flops_tok = 6 * n_params + 12 * cfg.num_hidden_layers \
        * cfg.hidden_size * S * 0.5
    print(f"train step [{B}, {S}]: {dt * 1e3:.1f} ms, {tok_s:.1f} tokens/s, "
          f"MFU {tok_s * flops_tok / 989e12:.4f} against 989 TFLOP/s "
          f"(informative), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    # run_steps: 4 steps over a stacked window, no host sync inside
    stack = ids[None].expand(4, B, S)
    torch.cuda.synchronize()
    t = time.perf_counter()
    l4 = _sync_free(torch, step.run_steps)(stack)
    torch.cuda.synchronize()
    l4 = l4.float().cpu()
    if l4.shape != (4,) or not bool(torch.isfinite(l4).all()):
        raise AssertionError(f"run_steps losses {l4}")
    print(f"run_steps [4, {B}, {S}]: {time.perf_counter() - t:.3f} s, "
          f"losses {[round(float(x), 4) for x in l4]}, no host sync inside")
    _k1_k2(_profile(torch, "train step", lambda: step(ids), top=20),
           "the train step")
    n_steps = 12 + 4 + 2
    launches = _path_launches("train", counters)
    print("launches per train step: " + json.dumps(
        {k: launches[k] / n_steps for k in PATHS["train"]}))
    return launches


# --------------------------------------------------------------- phase 8
def _grads_of(torch, model, ids):
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    model.zero_grad(set_to_none=True)
    loss = LlamaPretrainingCriterion()(model(ids), ids)
    loss.backward()
    return float(loss.detach())


def training_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 8 on phase 4's float32 pair: one step's loss and every
    gradient, then the parameters after 3 AdamW(multi_precision) steps
    through TrainStep, kernels on cuda against plain versions on the CPU;
    1e-4 of each tensor's largest |value|."""
    g = torch.Generator()
    g.manual_seed(17)
    V = gpu_model.config.vocab_size
    ids = torch.randint(1, V, (2, 64), generator=g)
    lg = _grads_of(torch, gpu_model, ids.cuda())
    lc = _grads_of(torch, cpu_model, ids)
    print(f"loss: cuda {lg:.6f} cpu {lc:.6f}")
    if not abs(lg - lc) <= 1e-4 * abs(lc):
        raise AssertionError("losses differ beyond 1e-4")
    worst = 0.0
    for (n, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                cpu_model.named_parameters()):
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        scale = float(pc.grad.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= 1e-4 * scale + 1e-9:
            raise AssertionError(f"grad of {n}: {err} > 1e-4 of {scale}")
    print(f"gradients: every parameter within {worst:.2e} of its largest "
          f"|grad|")
    gpu_model.zero_grad(set_to_none=True)
    cpu_model.zero_grad(set_to_none=True)
    lr, steps = 1e-4, 3
    sg, sc = _train_setup(torch, gpu_model, lr), _train_setup(
        torch, cpu_model, lr)
    for i in range(steps):
        a, b = float(sg(ids.cuda())), float(sc(ids))
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"step {i} loss cuda {a} cpu {b}")
    # Adam moves an element by ~lr a step whatever its gradient's size:
    # where a gradient is within float noise of zero its sign, and the
    # step, may differ; such elements stay within 2 lr steps
    n_out = n_all = 0
    for (n, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                cpu_model.named_parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs()
        tol = 1e-4 * float(pc.detach().abs().max())
        n_out += int((err > tol).sum())
        n_all += err.numel()
        if not float(err.max()) <= tol + 2 * lr * steps:
            raise AssertionError(f"{n} after {steps} steps: "
                                 f"{float(err.max())}")
    print(f"parameters after {steps} AdamW steps: {n_out} of {n_all} "
          f"elements beyond 1e-4 of their tensor's largest |w| (all within "
          f"2 lr steps)")
    if n_out > 1e-4 * n_all:
        raise AssertionError("too many parameters differ after AdamW")
    print("training kernel path == plain path (loss, gradients, AdamW)")


# --------------------------------------------------------------- phase 9
def bert_classifier(torch, layers, dtype, device=None, seed=0):
    """bench_ladder.py's BertClassifier (bench_ladder.py:107-123) from the
    port's layers: token and learned position embeddings, a post-norm gelu
    TransformerEncoder (FFN 4 x hidden, dropout 0.1, the identity in eval),
    a 2-way Linear head on the first token.  Random weights from a
    generator seeded with ``seed`` on ``device`` (None: CUDA)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.nn.transformer import (
        TransformerEncoder,
        TransformerEncoderLayer,
    )

    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h, seq = BERT["hidden"], BERT["seq"]
    kw = dict(device=dev, dtype=dtype, generator=g)

    class BertClassifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = pnn.Embedding(BERT["vocab"], h, **kw)
            self.pos = pnn.Embedding(seq, h, **kw)
            self.encoder = TransformerEncoder(TransformerEncoderLayer(
                h, BERT["heads"], 4 * h, dropout=0.1, activation="gelu",
                **kw), layers)
            self.cls = pnn.Linear(h, 2, **kw)

        def forward(self, ids):
            x = self.embed(ids) + self.pos(torch.arange(seq,
                                                        device=ids.device))
            return self.cls(self.encoder(x)[:, 0])

    return BertClassifier()


def _predictor(model, int8):
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = Config()
    cfg.set_layer(model)
    if int8:
        cfg.enable_weight_only_quant("int8")
    return create_predictor(cfg)


def _ms_per_run(torch, pred, ids, n=10):
    """Host time of ``pred.run`` (each run ends in the logits' copy to the
    host, which waits for the card), after one warm-up run."""
    pred.run([ids])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        pred.run([ids])
    return (time.perf_counter() - t) / n * 1e3


def full_width_predictor(torch, card):
    """Phase 9: BERT-base in bfloat16 through the float and the
    weight-only int8 Predictor; returns the predict path's launches."""
    import numpy as np

    from paddle_tpu_torch.inference import Int8Linear
    from paddle_tpu_torch.quantization import weight_quantize

    t = time.perf_counter()
    model = bert_classifier(torch, BERT["layers"], torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, BERT["vocab"], (BERT["batch"], BERT["seq"])
                       ).astype(np.int32)
    ids1 = ids[:1]
    fp = _predictor(model, int8=False)
    q8 = _predictor(model, int8=True)
    torch.cuda.synchronize()
    # the same predictors on the eager path, for the comparison
    fp_e = _predictor(model, int8=False)
    q8_e = _predictor(model, int8=True)
    fp_e._graphs = q8_e._graphs = False
    torch.cuda.synchronize()
    print(f"bert_base: {n_params} parameters, bf16; four predictors (float "
          f"and int8, graphs and eager) built in "
          f"{time.perf_counter() - t:.3f} s")
    ref = fp.run([ids])[0]
    if ref.shape != (BERT["batch"], 2) or not np.isfinite(ref).all():
        raise AssertionError(f"float logits {ref.shape} not finite [32, 2]")
    print(f"(a) float predictor: logits {ref.shape} {ref.dtype}, finite")
    q8.run([ids])           # the signature's first run: eager, captured
    torch.cuda.synchronize()
    counters = _zero_counters()
    got = q8.run([ids])[0]  # a replay
    launches = _path_launches("predict", counters)
    want = {"int8_matmul": 6 * BERT["layers"] + 1,
            "flash_attention": BERT["layers"]}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"one int8 run launched {launches}, "
                             f"expected {want}")
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError("int8 logits not finite")
    # every Int8Linear with a bias added it in B7's epilogue
    biased = sum(1 for m in q8._layer.modules()
                 if isinstance(m, Int8Linear) and m.bias is not None)
    fused = counters["int8_matmul"].bias_launches
    if fused != biased or biased != want["int8_matmul"]:
        raise AssertionError(f"{fused} B7 launches fused a bias, the run "
                             f"has {biased} biased Int8Linears")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"(b) int8 predictor, a replayed run: B7 "
          f"{launches['int8_matmul']} and B1 {launches['flash_attention']} "
          f"launches, all {fused} biased Int8Linears with the bias in B7's "
          f"epilogue, logits finite; largest difference from (a) {rel:.4f} "
          f"of the largest |logit| {float(np.abs(ref).max()):.4f} "
          "(informative)")
    w = model.encoder.layers[0].linear1.weight
    qg, sg = weight_quantize(w)
    qc, sc = weight_quantize(w.detach().cpu())
    if not (torch.equal(qg.cpu(), qc)
            and torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))):
        raise AssertionError("weight_quantize differs between cuda and cpu")
    print(f"(c) weight_quantize of a bf16 {list(w.shape)} weight: int8 "
          f"values and scales identical on cuda and the CPU")
    q8_evs = None
    for x in (ids, ids1):
        shape = f"[{x.shape[0]}, {x.shape[1]}]"
        for name, pred, eager in (("float", fp, fp_e), ("int8", q8, q8_e)):
            pred.run([x])               # [1, 128]: eager, captured
            a, b = pred.run([x])[0], eager.run([x])[0]   # a replay
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"{name} predictor {shape}: graphs differ from eager by "
                    f"{float(np.abs(a - b).max())}")
            for mode, p in (("graphs", pred), ("eager", eager)):
                ms = _ms_per_run(torch, p, x)
                print(f"(d) {name} predictor {shape}, {mode}: {ms:.3f} ms "
                      f"per run, {x.shape[0] / ms * 1e3:.1f} sequences/s "
                      f"({card}; informative)")
                evs = _profile(torch, f"{name} predictor {shape}, {mode}",
                               lambda p=p: p.run([x]))
                if name == "int8" and mode == "graphs" and x is ids:
                    q8_evs = evs
        print(f"(d) predictors {shape}: graphs == eager, bit for bit (float "
              "and int8)")
    for name, pred in (("float", fp), ("int8", q8)):
        cache = pred._graph_cache
        for key, (first, cap) in cache.seconds.items():
            print(f"graph {name} {key}: first run (eager) "
                  f"{first * 1e3:.1f} ms, capture {cap * 1e3:.1f} ms")
        if cache.captures != 2:
            raise AssertionError(f"{name} predictor: {cache.captures} "
                                 "captures for 2 input signatures")
    _no_bias_add(torch, q8, q8_evs)
    return launches


def _no_bias_add(torch, q8, evs):
    """No separate bias add in the int8 run: one biased Int8Linear's
    forward dispatches no add to PyTorch (its bias rides B7's epilogue;
    the launch itself goes through ctypes), and the run's profile holds no
    more elementwise add kernels than the encoder's residual adds (2 a
    layer) and the position embedding's (the parent's 73 bias adds ran as
    adds of their own).  CUPTI may drop a session's first records, so the
    profile's count is a ceiling check, not an exact one."""
    lin = q8._layer.encoder.layers[0].linear1
    x = torch.randn(BERT["batch"], BERT["seq"], BERT["hidden"],
                    device="cuda", dtype=lin.bias.dtype)
    b7 = _counters()["int8_matmul"]
    n0, f0 = b7.launches, b7.bias_launches
    ops = _dispatches(torch, lambda: lin(x))
    adds = [op for op in ops if "add" in op]
    if adds or (b7.launches, b7.bias_launches) != (n0 + 1, f0 + 1):
        raise AssertionError(f"one biased Int8Linear dispatched {ops} "
                             "beside one B7 launch with its bias")
    n_adds = sum(e.count for e in evs if "add" in e.key.lower()
                 and "int8" not in e.key)
    limit = 2 * BERT["layers"] + 1
    print(f"(e) a biased Int8Linear [{BERT['batch']}, {BERT['seq']}, "
          f"{BERT['hidden']}] is one B7 launch with its bias and dispatches "
          f"no add ({', '.join(sorted(set(ops))) or 'nothing else'}); "
          f"the int8 run's profile holds {n_adds} elementwise add kernels "
          f"(residuals and the position embedding: at most {limit})")
    if n_adds > limit:
        raise AssertionError(f"{n_adds} add kernels in the int8 run, more "
                             f"than its {limit} residual and embedding adds")


# -------------------------------------------------------------- phase 10
def predictor_kernels_vs_plain(torch):
    """Phase 10: a 2-layer BERT-width float32 classifier with identical
    weights on cuda and on the CPU, through int8 and float Predictors:
    identical quantized weights, logits within 1e-4 of the largest
    |logit|."""
    import numpy as np

    from paddle_tpu_torch.inference import Int8Linear
    from paddle_tpu_torch.nn import load_numpy_state_dict

    gm = bert_classifier(torch, 2, torch.float32, seed=1)
    cm = bert_classifier(torch, 2, torch.float32, device="cpu", seed=2)
    # biases start at zero and the encoder's layers are copies of one: give
    # every bias and norm weight its own seeded values, so B7's bias add
    # and each layer's own norms carry something
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    with torch.no_grad():
        for name, p in gm.named_parameters():
            r = torch.randn(p.shape, generator=g, device="cuda")
            if name.endswith("bias"):
                p.copy_(0.1 * r)
            elif "norm" in name:
                p.copy_(1.0 + 0.1 * r)
    load_numpy_state_dict(cm, {k: v.cpu().numpy()
                               for k, v in gm.state_dict().items()})
    ids = np.random.default_rng(3).integers(
        0, BERT["vocab"], (4, BERT["seq"])).astype(np.int32)
    for int8 in (True, False):
        pg, pc = _predictor(gm, int8), _predictor(cm, int8)
        if int8:
            mods = [(a, b) for a, b in zip(pg._layer.modules(),
                                           pc._layer.modules())
                    if isinstance(a, Int8Linear)]
            if len(mods) != 13 or not all(
                    torch.equal(a.qweight.cpu(), b.qweight)
                    and torch.equal(a.scale.cpu(), b.scale)
                    for a, b in mods):
                raise AssertionError("quantized weights differ between "
                                     "cuda and the CPU")
        lg, lc = pg.run([ids])[0], pc.run([ids])[0]
        err = float(np.abs(lg - lc).max())
        tol = 1e-4 * float(np.abs(lc).max())
        what = "int8" if int8 else "float"
        print(f"{what} predictor [4, {BERT['seq']}] cuda vs cpu: "
              f"max_abs_err {err:.3e} tol {tol:.3e}"
              + (" (13 qweights and scales identical)" if int8 else ""))
        if not err <= tol:
            raise AssertionError(f"{what} predictor logits differ beyond "
                                 "1e-4 of the largest |logit|")
    print("predictor kernel path == plain path (int8 and float)")


# ------------------------------------------------------------------ main
# -------------------------------------------------------------- phase 11
def _repetitive_prompts(rng, V, n, length, period=8):
    """``n`` prompts of ``length`` tokens, each a random ``period``-token
    pattern repeated: n-gram drafting finds their tails in the history."""
    out = []
    for _ in range(n):
        pat = rng.integers(1, V, period).tolist()
        out.append((pat * (length // period + 1))[:length])
    return out


def _drafting_prompts(eng, prompts, rounds=6):
    """``prompts`` changed so that each one's greedy next token (served by
    ``eng``, a spec-off engine) is already one of its tokens: n-gram
    drafting then proposes a draft at the first decode step (random
    weights rarely repeat a token of the history on their own).  Each
    round writes a prompt's prediction over its next leading token, far
    from the end, until the prediction is in the prompt."""
    prompts = [list(p) for p in prompts]
    for r in range(rounds):
        nxt = _serve_waves(eng, [[(p, 1, None) for p in prompts]])
        todo = [(p, g) for p, (g,) in zip(prompts, nxt) if g not in p]
        if not todo:
            break
        for p, g in todo:
            p[r] = g
    print(f"drafting prompts: {len(prompts) - len(todo)} of {len(prompts)} "
          f"hold their next token after {r + 1} rounds")
    return prompts


def _spec_counts(eng):
    st = eng.state_summary()["spec"]
    vf = st["verify_forwards"]
    return (f"verify forwards (rows scored) {vf}, drafted {st['drafted']}, "
            f"accepted {st['accepted']}, tokens per verify "
            f"{(vf + st['accepted']) / max(vf, 1):.3f}")


def _logged_programs(eng, log):
    """Log each device program ``eng`` runs as (name, iterations): the
    single step, a megastep loop of K, the verify (K4 launches one kernel
    per layer per iteration); all go through ``_graphed``, on graphs and
    eagerly."""
    graphed = eng._graphed

    def run_graphed(key, fn, arrays):
        log.append((key[0], 1) if key[0] in ("spec", "step")
                   else (key[0], key[1]))
        return graphed(key, fn, arrays)

    eng._graphed = run_graphed


def _draw_margin(torch, lg, sampling, pos):
    """(margin, bfloat16 step) of the choice at sample index ``pos`` from
    the logits row ``lg`` [V]: the top-two logits of a greedy row, the
    top-two of the filtered, scaled logits plus the row's threefry Gumbel
    noise for a sampled one (the draw's argmax); the step is 2^-7 of the
    largest |logit|, scaled as the logits are."""
    from paddle_tpu_torch.framework.random import fold_in, gumbel, key
    from paddle_tpu_torch.inference.serving import _filtered

    step = 2.0 ** -7 * float(lg.abs().max())
    t = (sampling or {}).get("temperature", 0.0)
    score = lg
    if t > 0:
        filt = _filtered(lg[None] / t, torch.zeros(1, dtype=torch.int32),
                         torch.tensor([sampling.get("top_p", 1.0)]))[0]
        g = gumbel(fold_in(key(sampling["seed"]), pos), (lg.shape[0],))
        score, step = filt + g, step / t
    top2 = torch.topk(score, 2).values
    return float(top2[0] - top2[1]), step


def _spec_vs_off(torch, model, on, off, reqs):
    """Spec-on tokens against spec-off's: equal, or, from the first
    position where they differ, spec-off's choice there within
    bfloat16's step (``_draw_margin`` over spec-off's logits,
    teacher-forced on a fresh spec-off engine)."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    for i, ((prompt, _, sampling), a, b) in enumerate(zip(reqs, on, off)):
        if a == b:
            continue
        pos = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = _logits_at(torch, ServingEngine(model, **SERVE_KW), prompt,
                        b[:pos])
        margin, step = _draw_margin(torch, lg, sampling, pos)
        print(f"spec on vs off, request {i}: first differ at generated "
              f"position {pos} ({a[pos]} vs {b[pos]}); spec-off's margin "
              f"{margin:.4e}, bf16 step {step:.4e}")
        if not margin <= step:
            raise AssertionError(f"spec on and off differ at request {i} "
                                 f"position {pos} with a margin {margin} "
                                 f"past bf16's step {step}")


def full_width_spec(torch, model):
    """Phase 11a: speculative serving at 7B width (module docstring);
    returns the spec path's launches."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(11)
    probe = ServingEngine(model, prefix_cache=False, **SERVE_KW)

    def wave():
        sampled = dict(temperature=0.8, top_p=0.9, seed=5, logprobs=True)
        prompts = _drafting_prompts(probe, _repetitive_prompts(
            rng, cfg.vocab_size, 8, 64))
        return [(p, 64, sampled if i == 5 else dict(logprobs=True))
                for i, p in enumerate(prompts)]

    # checked, two warm waves (the keys they add captured), untraced,
    # traced
    waves = [wave() for _ in range(5)]
    probe = None
    on = ServingEngine(model, spec_k=SPEC_K, **SERVE_KW)
    eager = ServingEngine(model, spec_k=SPEC_K, **SERVE_KW)
    eager._graphs = False
    off = ServingEngine(model, **SERVE_KW)
    # no host sync inside a device program (the eager programs, a key's
    # first call and its capture) or a replay (main)
    for e in (on, eager, off):
        for name in ("_run_megastep", "_run_mixed", "_run_spec_verify"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    counters = _zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(on, waves[:1], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("spec", counters)
    if not on.spec_verify_forwards:
        raise AssertionError("the spec engine never ran its verify")
    print(f"spec_k {SPEC_K}, on graphs: {_spec_counts(on)}; wave of 8 x 64 "
          f"tokens in {secs:.3f} s (its captures included)")
    for key, (first, cap) in on._graph_cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not {("spec", True), ("spec", False)} & set(on._graph_cache.graphs):
        raise AssertionError("the verify was not captured")
    e_lps = []
    e_outs = _serve_waves(eager, waves[:1], e_lps)
    names = ("spec_verify_forwards", "spec_draft_tokens",
             "spec_accepted_tokens", "megasteps", "prefill_chunks")
    got = [getattr(on, n) for n in names]
    want = [getattr(eager, n) for n in names]
    if outs != e_outs or lps != e_lps or got != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"spec graphs and eager differ: tokens of "
                             f"requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}")
    print(f"spec graphs == eager: tokens, logprobs and {names} {got} "
          "identical over 8 requests (the seeded one too)")
    off_outs = _serve_waves(off, waves[:1])
    _spec_vs_off(torch, model, outs, off_outs, waves[0])
    same = sum(a == b for a, b in zip(outs, off_outs))
    print(f"spec on vs off: {same} of 8 requests token for token equal")
    # the decode-heavy waves: a warm one (the keys it adds captured), then
    # the untraced wall and busy share in each mode, and K4 in each trace:
    # kernels against wrapper calls, and each program's K4 kernels (tagged
    # by the order the programs ran)
    for label, e in (("spec on", on), ("spec off", off)):
        calls, log, kernels, caps = [], [], [], []
        _serve_waves(e, waves[1:3])

        def untraced(e=e, caps=caps):
            n_cap = e.compile_count
            _serve_waves(e, [waves[3]])
            caps.append(e.compile_count - n_cap)

        def traced(e=e, calls=calls, log=log):
            log.clear()             # a trace taken again logs again
            n0 = pa.paged_attention.launches
            _logged_programs(e, log)
            try:
                _serve_waves(e, [waves[4]])
            finally:
                del e._graphed
            calls.append(pa.paged_attention.launches - n0)

        evs = _profile(torch, f"decode wave, {label} (8 rows, repetitive "
                       "64-token prompts, 64 new tokens)", untraced, traced,
                       top=10, trace=kernels)
        print(f"{label}, over its 5 waves: {_spec_counts(e)}; megasteps "
              f"{e.megasteps}; "
              f"graphs captured in the untraced wave {caps[0]}")
        _k1_k2(evs, f"the decode wave, {label}")
        k4 = [k for k in kernels if "paged_attention" in k.name]
        if len(k4) != calls[-1]:
            raise AssertionError(f"K4 ({label}): {len(k4)} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([k.name for k in k4], f"K4 in the decode wave, {label}")
        tags = [name for name, n in log for _ in range(n * L)]
        if len(tags) != len(k4):
            raise AssertionError(f"K4 ({label}): {len(k4)} kernels for "
                                 f"{len(tags)} by the programs run")
        for name in sorted(set(tags)):
            us = [k.time_range.end - k.time_range.start
                  for k, tag in zip(k4, tags) if tag == name]
            print(f"profile K4 in the decode wave, {label}, {name}: "
                  f"{len(us)} kernels, {sum(us) / 1e3:.3f} ms, "
                  f"{sum(us) / len(us):.2f} us a launch")
    return launches


def full_width_transfer(torch, model):
    """Phase 11b: block transfer at 7B width (module docstring)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                     prompt_block_hashes)

    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, model.config.vocab_size, 256).tolist()
               for _ in range(8)]
    chains = [prompt_block_hashes(p, SERVE_KW["block_size"])
              for p in prompts]
    warm = [[(p, 1, None) for p in prompts]]
    a = ServingEngine(model, **SERVE_KW)
    _serve_waves(a, warm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    payloads = [a.export_blocks_packed(c) for c in chains]
    export_s = time.perf_counter() - t
    nbytes = sum(len(raw) for _, raw in payloads)
    if any(h["hashes"] != c for (h, _), c in zip(payloads, chains)):
        raise AssertionError("an export stopped short of its chain")
    a = None
    b = ServingEngine(model, **SERVE_KW)
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = sum(b.import_blocks_packed(h, raw) for h, raw in payloads)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    print(f"block transfer: 8 chains of {len(chains[0])} blocks, {nbytes} "
          f"bytes; export {export_s * 1e3:.2f} ms "
          f"({nbytes / export_s / 1e9:.2f} GB/s), import {n} blocks "
          f"{import_s * 1e3:.2f} ms ({nbytes / import_s / 1e9:.2f} GB/s)")
    if n != sum(len(c) for c in chains):
        raise AssertionError(f"imported {n} blocks")
    if [b.export_blocks_packed(c) for c in chains] != payloads:
        raise AssertionError("the importer's export differs from the "
                             "exported bytes")
    c = ServingEngine(model, **SERVE_KW)
    _serve_waves(c, warm)
    wave = [[(p, 32, None) for p in prompts]]
    got, want = _serve_waves(b, wave), _serve_waves(c, wave)
    if b.prefix_hit_blocks != n or c.prefix_hit_blocks != n:
        raise AssertionError(f"prefix hits {b.prefix_hit_blocks} on the "
                             f"imported blocks, {c.prefix_hit_blocks} warm")
    if got != want:
        raise AssertionError("serving on imported blocks differs from "
                             "serving on locally warmed ones")
    print(f"block transfer: the importer's export is the exported bytes; "
          f"served on {n} imported blocks (prefix hits {n}) == served on "
          "locally warmed ones, bit for bit, 8 x 32 tokens")


def spec_and_transfer_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4's float32 pair: speculative serving (spec_k 8) on cuda
    against the CPU plain path, then a packed export made on the card
    imported into a CPU engine, serving wave 2 on it."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                     prompt_block_hashes)

    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128)
    rng = np.random.default_rng(17)
    prompts = _drafting_prompts(
        ServingEngine(gpu_model, prefix_cache=False, **kw),
        _repetitive_prompts(rng, gpu_model.config.vocab_size, 4, 40))
    waves = [[(p, 16, None) for p in prompts], [(prompts[1], 16, None)]]
    gpu_eng = ServingEngine(gpu_model, spec_k=SPEC_K, **kw)
    gpu = _serve_waves(gpu_eng, waves)
    cpu_eng = ServingEngine(cpu_model, spec_k=SPEC_K, device="cpu", **kw)
    cpu = _serve_waves(cpu_eng, waves)
    if not gpu_eng.spec_verify_forwards:
        raise AssertionError("the spec engine never ran its verify")
    flat = [p for w in waves for p, _, _ in w]
    gaps = [_top2_gaps(torch, ServingEngine(cpu_model, device="cpu", **kw),
                       p, cpu[i]) for i, p in enumerate(flat)]
    for i in range(len(flat)):
        _agree(gpu[i], cpu[i], gaps[i], f"spec request {i} cuda vs cpu")
    print(f"spec_k {SPEC_K}: kernel path == plain path on {len(flat)} "
          f"requests; cuda {_spec_counts(gpu_eng)}; cpu "
          f"{_spec_counts(cpu_eng)}")
    src = ServingEngine(gpu_model, **kw)
    _serve_waves(src, waves[:1])
    hashes = prompt_block_hashes(prompts[1], kw["block_size"])
    header, raw = src.export_blocks_packed(hashes)
    dst = ServingEngine(cpu_model, device="cpu", **kw)
    n = dst.import_blocks_packed(header, raw)
    got = _serve_waves(dst, waves[1:])
    if n != len(hashes) or dst.prefix_hit_blocks != n:
        raise AssertionError(f"imported {n} of {len(hashes)} blocks, "
                             f"prefix hits {dst.prefix_hit_blocks}")
    _agree(got[0], cpu[-1], gaps[-1], "wave 2 on blocks from cuda vs cpu")
    print(f"block transfer cuda -> cpu: {n} blocks, {len(raw)} bytes; "
          "wave 2 on them == the CPU engine's wave 2")


# --------------------------------------------------------- phases 4, 12
def _int8_gaps(torch, cpu_model, kw, prompt, n):
    """The top-2 logit gap at each of the ``n`` greedy tokens a CPU int8
    engine (``kw``) gives ``prompt`` served alone: its own quantized
    decode, read off each logits row it samples from (slot 0; the frozen
    iterations after the last token come after these)."""
    from paddle_tpu_torch.inference import serving

    eng = serving.ServingEngine(cpu_model, device="cpu", **kw)
    gaps = []
    sample = serving._sample_tokens

    def recording(logits, *args, **kwargs):
        top2 = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top2[0] - top2[1]))
        return sample(logits, *args, **kwargs)

    serving._sample_tokens = recording
    try:
        rid = eng.add_request(prompt, max_new_tokens=n)
        eng.run()[rid]
    finally:
        serving._sample_tokens = sample
    return gaps[:n]


def int8_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4: the int8 engine (K4-int8) on cuda against the CPU plain
    path from identical weights: greedy tokens equal up to the first
    position whose top-2 gap on the CPU (its own int8 decode) is below
    1e-3, logprobs there within 1e-3 of the largest |logprob| + 1e-3."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = gpu_model.config
    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128, cache_quant="int8")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 48, 20)]
    lp = dict(logprobs=True)
    waves = [[(p, 16, lp) for p in prompts], [(prompts[1], 16, lp)]]
    g_lps, c_lps = [], []
    gpu_eng = ServingEngine(gpu_model, **kw)
    gpu = _serve_waves(gpu_eng, waves, g_lps)
    cpu = _serve_waves(ServingEngine(cpu_model, device="cpu", **kw), waves,
                       c_lps)
    if gpu_eng.megasteps_mixed or not gpu_eng.megasteps:
        raise AssertionError("the int8 engine ran a mixed loop or no "
                             "megastep")
    worst = 0.0
    flat = [p for w in waves for p, _, _ in w]
    for i, p in enumerate(flat):
        gaps = _int8_gaps(torch, cpu_model, kw, p, len(cpu[i]))
        _agree(gpu[i], cpu[i], gaps, f"int8 request {i} cuda vs cpu")
        stop = next((j for j, g_ in enumerate(gaps) if g_ < 1e-3),
                    len(gaps))
        a, b = np.array(g_lps[i][:stop]), np.array(c_lps[i][:stop])
        err = float(np.abs(a - b).max()) if stop else 0.0
        tol = 1e-3 * float(np.abs(b).max()) + 1e-3 if stop else 0.0
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"int8 request {i}: logprobs differ by "
                                 f"{err} > {tol}")
    print(f"int8 cache: kernel path == plain path on {len(flat)} requests "
          f"(logprobs max_abs_err {worst:.3e}); megasteps "
          f"{gpu_eng.megasteps}, mixed 0, prefill chunks "
          f"{gpu_eng.prefill_chunks}")


def _cache_bytes(eng):
    """The bytes of an engine's KV pools (drop block included) and, for
    the int8 cache, its scales."""
    n = sum(c.numel() * c.element_size()
            for c in eng.key_caches + eng.value_caches)
    for sc in eng.cache_scales or ():
        n += sum(t.numel() * t.element_size() for t in sc.values())
    return n


def full_width_int8(torch, model):
    """Phase 12: the 7B geometry served over the int8 KV cache on CUDA
    graphs and on the eager loops (identical tokens, logprobs and
    counters), its tokens beside a bf16-cache engine's (printed), cache
    bytes, and the decode wave profiled on each with K4-int8's kernels
    against its wrapper's count."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    eng = ServingEngine(model, cache_quant="int8", megastep_k=8, **SERVE_KW)
    eager = ServingEngine(model, cache_quant="int8", megastep_k=8,
                          **SERVE_KW)
    eager._graphs = False
    bf16 = ServingEngine(model, megastep_k=8, **SERVE_KW)
    print(f"KV cache bytes: int8 {_cache_bytes(eng)} (pools and scales), "
          f"bf16 {_cache_bytes(bf16)}, ratio "
          f"{_cache_bytes(eng) / _cache_bytes(bf16):.4f}")
    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    greedy = dict(logprobs=True)
    sampled = dict(temperature=0.8, top_p=0.9, seed=7, logprobs=True)
    # prompts up to token_budget (int8 prefills in one step)
    lens = [7, 40, 128, 200, 256, 33, 250, 90, 150]
    news = [48, 32, 64, 40, 56, 1, 36, 60, 44]
    wave1 = [(prompt(n), m, sampled if i == 3 else greedy)
             for i, (n, m) in enumerate(zip(lens, news))]
    wave2 = [(wave1[2][0], 32, greedy), (prompt(70), 40, greedy)]
    for e in (eng, eager):
        for name in ("_run_megastep", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    replays0 = _REPLAYS[0]
    counters = _zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(eng, [wave1, wave2], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("int8", counters)
    if launches["paged_attention"]:
        raise AssertionError("the int8 engine launched K4 over a bf16 cache")
    n_tok = sum(len(o) for o in outs)
    print(f"int8 served {len(outs)} requests, {n_tok} tokens in {secs:.3f} "
          f"s ({n_tok / secs:.1f} tokens/s, informative); "
          f"{_REPLAYS[0] - replays0} graph replays under CUDA sync "
          f"debugging set to raise; megasteps {eng.megasteps}, mixed "
          f"{eng.megasteps_mixed}, prefill chunks {eng.prefill_chunks}")
    if not eng.megasteps or eng.megasteps_mixed or eng.prefix_hit_blocks:
        raise AssertionError("the int8 run did not arm the megastep, or "
                             "armed the mixed loop or the prefix cache")
    kd = eng.cache_scales[0]["kd"]
    if not bool(torch.isfinite(kd).all()):
        raise AssertionError("non-finite int8 cache scales")
    e_lps = []
    e_outs = _serve_waves(eager, [wave1, wave2], e_lps)
    names = ("megasteps", "megasteps_mixed", "prefill_chunks")
    got = [getattr(eng, n) for n in names]
    want = [getattr(eager, n) for n in names]
    # every layer's dynamic scales, refreshed in place by the steps'
    # graphs on one engine and eagerly on the other
    scales = all(torch.equal(a[n], b[n]) for a, b in
                 zip(eng.cache_scales, eager.cache_scales) for n in a)
    if outs != e_outs or lps != e_lps or got != want or not scales:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"int8 graphs and eager loops differ: tokens "
                             f"of requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}, "
                             f"cache_scales equal {scales}")
    cache = eng._graph_cache
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not any(k[0] == "step" for k in cache.graphs):
        raise AssertionError("the int8 single step was not captured")
    print(f"int8 graphs == eager: tokens, logprobs, {names} {got} and the "
          f"{len(eng.cache_scales)} layers' cache_scales identical over "
          f"{len(outs)} requests (the sampled one too); compile_count "
          f"{eng.compile_count}, step keys "
          f"{sorted(k for k in cache.graphs if k[0] == 'step')}")
    b_outs = _serve_waves(bf16, [wave1, wave2])
    same = sum(a == b for o, r in zip(outs, b_outs) for a, b in zip(o, r))
    first = [next((j for j, (a, b) in enumerate(zip(o, r)) if a != b),
                  len(o)) for o, r in zip(outs, b_outs)]
    print(f"int8 vs bf16 cache: {same} of {n_tok} tokens agree by position "
          f"({same / n_tok:.4f}); first difference per request {first} "
          "(informative)")
    waves = [[(prompt(64), 32, None) for _ in range(8)] for _ in range(3)]
    for label, e in (("graphs", eng), ("eager", eager)):
        calls = []
        meter = _step_meter(torch, e)
        stepped = {"first": {}, "untraced": {}, "traced": {}}

        def traced(e=e):
            n0 = pa.paged_attention_int8.launches
            _serve_waves(e, [waves[2]])
            calls.append(pa.paged_attention_int8.launches - n0)

        n_cap = e.compile_count
        _metered(meter, lambda e=e: _serve_waves(e, [waves[0]]),
                 stepped["first"])()
        print(f"int8 decode wave, {label}, first: "
              f"{e.compile_count - n_cap} graphs captured in it")
        n_cap = e.compile_count
        evs = _profile(torch, f"int8 decode wave, {label} (8 rows, 64-token "
                       "prompts, 32 new tokens)",
                       _metered(meter, lambda e=e: _serve_waves(e, [waves[1]]),
                                stepped["untraced"]),
                       _metered(meter, traced, stepped["traced"]), top=15)
        _step_report("int8 decode wave", label, stepped, e is eng)
        print(f"int8 decode wave, {label}: graphs captured in the measured "
              f"waves {e.compile_count - n_cap}")
        _k1_k2(evs, f"the int8 decode wave, {label}")
        k4 = [ev for ev in evs if "paged_attention_int8" in ev.key]
        k4_n = sum(ev.count for ev in k4)
        k4_ms = sum(ev.self_device_time_total for ev in k4) / 1e3
        print(f"profile K4-int8 in the int8 decode wave, {label}: "
              f"{k4_ms:.3f} ms device, {k4_n} kernels "
              f"({1e3 * k4_ms / max(k4_n, 1):.2f} us a launch), "
              f"{calls[-1]} wrapper calls")
        if k4_n != calls[-1] or not k4_n:
            raise AssertionError(f"K4-int8 ({label}): {k4_n} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([ev.key for ev in k4],
                  f"K4-int8 in the int8 decode wave, {label}")
    return launches


# -------------------------------------------------------------- phase 13
# the public block_multihead_attention at the Llama-2-7B attention
# geometry (phases 3 and 12): 32 heads of 128, batch 8, max_seq_len 512 in
# blocks of 64 (8 a row), one [64, KV, 64, 128] pool pair a layer
BLHA = dict(batch=8, max_seq_len=512, block_size=64, layers=32, heads=32,
            head_dim=128, decode_steps=32,
            prompts=(7, 400, 128, 256, 33, 300, 90, 150))


class _PlainKernels:
    """Within the block, ``ops.paged_attention`` (what blha_attention
    calls) runs the plain PyTorch versions of K2, K4 and K4-int8 on the
    card's tensors: the wrapper's plain twin."""

    def __enter__(self):
        from paddle_tpu_torch.ops import paged_attention as blha
        from paddle_tpu_torch.ops.hopper import fused_ops
        from paddle_tpu_torch.ops.hopper import paged_attention as pa

        self.mod = blha
        self.saved = {n: getattr(blha, n) for n in (
            "rope_fused", "paged_attention", "paged_attention_int8")}
        blha.rope_fused = (lambda q, k, cos, sin, interleaved=False:
                           fused_ops._rope_ref(q, k, cos, sin, interleaved))
        blha.paged_attention = pa._paged_attention_ref
        blha.paged_attention_int8 = pa._paged_attention_int8_ref
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)


def _alibi_masks(torch, H, lens, Lp, L, decode_pos=None):
    """Additive masks of a model with linear position biases, float32 on the
    card: head h's slope 2^(-8 (h + 1) / H) times the distance s - j on
    visible keys, -1e4 on padding.  A prefill (``decode_pos`` None): mask
    [B, H, max, Lp + L], row s of row b live while s < its length, its
    visible keys the prefix (bias 0) and paged keys j <= s.  A decode step:
    tgt_mask [B, H, 1, Lp + L] at each row's position."""
    dev = "cuda"
    slope = 2.0 ** (-8.0 * torch.arange(1, H + 1, device=dev) / H)
    j = torch.arange(Lp + L, device=dev) - Lp            # paged key index
    if decode_pos is None:
        n = torch.tensor(lens, device=dev)
        s = torch.arange(int(n.max()), device=dev)
        dist = (s[:, None] - j[None, :]).clamp(min=0).float()   # [S, Lk]
        ok = ((j[None, None, :] <= s[None, :, None])
              & (s[None, :, None] < n[:, None, None]))            # [B, S, Lk]
        ok = ok | (j < 0)[None, None, :]
        m = -slope[None, :, None, None] * dist[None, None]
        return torch.where(ok[:, None], m, -1e4).contiguous()
    pos = torch.tensor(decode_pos, device=dev)
    dist = (pos[:, None] - j[None, :]).clamp(min=0).float()       # [B, Lk]
    ok = (j[None, :] <= pos[:, None]) | (j < 0)[None, :]
    m = -slope[None, :, None] * dist[:, None, :]                  # [B, H, Lk]
    return torch.where(ok[:, None], m, -1e4)[:, :, None].contiguous()


def _blha_run(torch, KV, quant, Lp, layers=None, dtype=None, device="cuda",
              plain=False, seed=13):
    """One run of the wrapper: a prefill call a layer (prompts of 7-400
    tokens under an ALiBi causal-plus-padding ``mask``), then
    ``decode_steps`` decode calls a layer under ``tgt_mask``, over fresh
    pools per layer (``quant`` "none": q's dtype, else uint8 with static
    [KV] or dynamic [B, KV] scales), rope at absolute positions (neox), a
    ``Lp``-key pre-cache per layer where Lp > 0.  Seeded on the card, the
    same inputs for the same ``seed`` on either device.  ``plain`` runs the
    plain twin (``_PlainKernels``).  Returns (the outputs of every call,
    the pools, the scale tensors, wall seconds of the prefill and decode
    calls, the number of calls, the pools' data_ptr() before and after)."""
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention,
    )

    c = BLHA
    dtype = dtype or torch.bfloat16
    layers = layers or c["layers"]
    B, bs, H, D = c["batch"], c["block_size"], c["heads"], c["head_dim"]
    P = c["max_seq_len"] // bs
    NB = B * P
    lens = list(c["prompts"])
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    bt = torch.randperm(NB, generator=g, device="cuda").view(B, P).to(
        torch.int32)
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device="cuda") / D))
    fr = torch.arange(c["max_seq_len"], device="cuda")[:, None] * inv
    rope = torch.stack([fr.cos(), fr.sin()])[:, None, :, None, :].float()
    cdt = torch.uint8 if quant != "none" else dtype
    pools = [[torch.zeros(NB, KV, bs, D, dtype=cdt, device="cuda")
              for _ in range(2)] for _ in range(layers)]
    pre = [dict(pre_key_cache=rnd(B, KV, Lp, D),
                pre_value_cache=rnd(B, KV, Lp, D)) if Lp else {}
           for _ in range(layers)]
    names = ("cache_k_quant_scales", "cache_v_quant_scales",
             "cache_k_dequant_scales", "cache_v_dequant_scales")
    if quant == "static":
        kq = torch.full((KV,), 127.0 / 4, device="cuda")
        scales = [dict(zip(names, (kq, kq.clone(), 1 / kq, 1 / kq)))
                  for _ in range(layers)]
    elif quant == "dynamic":
        scales = [{n: torch.zeros(B, KV, device="cuda") for n in names}
                  for _ in range(layers)]
    else:
        scales = [{} for _ in range(layers)]
    mask = _alibi_masks(torch, H, lens, Lp, P * bs)
    W = (H + 2 * KV) * D
    steps = [(lens, [0] * B, lens, dict(mask=mask))]
    for t in range(c["decode_steps"]):
        pos = [n + t for n in lens]
        steps.append(([0] * B, pos, [1] * B, dict(
            tgt_mask=_alibi_masks(torch, H, lens, Lp, P * bs, pos))))
    # every call's qkv, made up front from the seed
    qkvs = [[rnd(sum(now), W) for _ in range(layers)]
            for _, _, now, _ in steps]
    dev = torch.device(device)
    move = (lambda t: t.to(dev)) if dev.type == "cpu" else (lambda t: t)
    pools = [[move(t) for t in pr] for pr in pools]
    pre = [{k: move(v) for k, v in d.items()} for d in pre]
    scales = [{k: move(v) for k, v in d.items()} for d in scales]
    rope, bt = move(rope), move(bt)
    ptrs = [[t.data_ptr() for t in pr] for pr in pools]
    outs, secs = [], [0.0, 0.0]
    with _PlainKernels() if plain else contextlib.nullcontext():
        for i, (enc, dec, now, masks) in enumerate(steps):
            cu = [0]
            for n in now:
                cu.append(cu[-1] + n)
            ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in (enc, dec, now, cu)]
            kw = {k: move(v) for k, v in masks.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for layer in range(layers):
                out = block_multihead_attention(
                    move(qkvs[i][layer]), *pools[layer], *ints[:3], None,
                    None, ints[3], ints[3], bt, rope_emb=rope,
                    block_size=bs, use_neox_style=True,
                    use_dynamic_cachekv_quant=quant == "dynamic",
                    **pre[layer], **scales[layer], **kw)[0]
                outs.append(out)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs[min(i, 1)] += time.perf_counter() - t0
    after = [[t.data_ptr() for t in pr] for pr in pools]
    return (outs, pools, scales, secs, len(steps) * layers, ptrs, after)


def full_width_blha(torch):
    """Phase 13: the public incubate.nn.functional.block_multihead_attention
    at full width (``BLHA``): per run, 32 layers' prefill calls and 32
    decode steps of 32 layers; bf16, static and dynamic int8 pools, a
    64-key pre-cache, GQA 32 / 8.  Each run's outputs held against its plain
    twin on the card (K2, K4 and K4-int8 replaced by their plain
    versions), the pools and scales after the run too; K4 / K4-int8 and K2
    launches equal to the wrapper's calls, every one a masked launch; the
    pools written in place; ms a call.  Then a float32 two-layer run
    against the same wrapper on the CPU."""
    from paddle_tpu_torch.ops.hopper import fused_ops
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    counters = _zero_counters()
    runs = (("bf16", 32, "none", 0), ("static int8", 32, "static", 0),
            ("dynamic int8", 32, "dynamic", 0),
            ("bf16, 64-key pre-cache", 32, "none", 64),
            ("bf16, GQA 32 / 8", 8, "none", 0))
    for label, KV, quant, Lp in runs:
        kern = (pa.paged_attention_int8 if quant != "none"
                else pa.paged_attention)
        n0, m0, r0 = kern.launches, kern.mask_launches, \
            fused_ops.rope_fused.launches
        outs, pools, scales, secs, calls, ptrs, after = _blha_run(
            torch, KV, quant, Lp)
        launched = (kern.launches - n0, kern.mask_launches - m0,
                    fused_ops.rope_fused.launches - r0)
        if launched != (calls, calls, calls) or ptrs != after:
            raise AssertionError(
                f"blha {label}: {launched} kernel / masked / K2 launches for "
                f"{calls} calls, or a pool moved ({ptrs != after})")
        p_outs, p_pools, p_scales, *_ = _blha_run(torch, KV, quant, Lp,
                                                  plain=True)
        worst = 0.0
        for got, ref in zip(outs, p_outs):
            err, tol = _err(torch, got, ref), _tol("bfloat16", ref)
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"blha {label}: the wrapper and its "
                                     f"plain twin differ by {err} > {tol}")
        codes = 1.0
        for pr, qr in zip(pools, p_pools):
            for a, b in zip(pr, qr):
                if quant == "none":
                    if not _err(torch, a, b) <= _tol("bfloat16", b):
                        raise AssertionError(f"blha {label}: pools differ")
                else:
                    d = (a.int() - b.int()).abs()
                    codes = min(codes, float((d == 0).float().mean()))
                    if int(d.max()) > 1:
                        raise AssertionError(f"blha {label}: codes differ "
                                             "by more than 1")
        for sa, sb in zip(scales, p_scales):
            for n in sa:
                if not torch.allclose(sa[n], sb[n], rtol=1e-2) or not bool(
                        (sa[n] > 0).all()):
                    raise AssertionError(f"blha {label}: scales {n} differ "
                                         "from the plain twin's or are 0")
        if codes < 0.99:
            raise AssertionError(f"blha {label}: {codes:.4f} of the codes "
                                 "equal the plain twin's")
        n_dec = calls - BLHA["layers"]
        print(f"blha {label}: {calls} calls ({BLHA['layers']} prefill of "
              f"{sum(BLHA['prompts'])} tokens, {n_dec} decode), "
              f"{launched[0]} {kern.__name__} launches, all masked, "
              f"{launched[2]} K2; prefill {1e3 * secs[0] / BLHA['layers']:.3f}"
              f" ms a call, decode {1e3 * secs[1] / n_dec:.3f} ms a call "
              f"(host wall, a host read each); outputs within "
              f"{worst:.3f} of the tolerance of the plain twin, pools in "
              f"place" + ("" if quant == "none" else
                          f", {codes:.4f} of the codes equal"), flush=True)
    launches = _path_launches("blha", counters)
    # float32, two layers: the wrapper on the card against the CPU
    kw = dict(KV=32, quant="none", Lp=0, layers=2, dtype=torch.float32)
    gpu = _blha_run(torch, **kw)
    cpu = _blha_run(torch, device="cpu", **kw)
    err = max(_err(torch, a.cpu(), b) for a, b in zip(gpu[0], cpu[0]))
    scale = max(_scale(b) for b in cpu[0])
    perr = max(_err(torch, a.cpu(), b) for pa_, pb in zip(gpu[1], cpu[1])
               for a, b in zip(pa_, pb))
    if not (err <= 1e-4 * scale + 1e-5 and perr <= 1e-5):
        raise AssertionError(f"blha float32: cuda and the CPU differ by "
                             f"{err} (outputs) / {perr} (pools)")
    print(f"blha float32, 2 layers: cuda == CPU within {err:.3e} of "
          f"{scale:.3e} (outputs), {perr:.3e} (pools) over {len(cpu[0])} "
          "calls")
    return launches



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13",
                    help="phases to run after phase 1 (always run)")
    ap.add_argument("--k4-sweep", action="store_true",
                    help="phase 2 also times each K4 case under other "
                         "plans (informative)")
    ap.add_argument("--b2-sweep", action="store_true",
                    help="phase 2 also times each B2 case under every "
                         "split count (informative)")
    ap.add_argument("--k1-sweep", action="store_true",
                    help="phase 2 also times each bf16 K1 case under every "
                         "plan the instances take (informative)")
    ap.add_argument("--b7-sweep", action="store_true",
                    help="phase 2 also times each bf16 B7 case under every "
                         "plan the instances take (informative)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch  # noqa: F401  (precision pin)
    from paddle_tpu_torch.jit import graphs

    # a CUDA graph's replay (the serving engines' megastep loops) waits for
    # nothing on the host: every replay of the run raises on a sync
    replay = _sync_free(torch, graphs.CapturedGraph.replay)

    def counted_replay(self, arrays=()):
        _REPLAYS[0] += 1
        return replay(self, arrays)

    graphs.CapturedGraph.replay = counted_replay

    t = _phase("1 environment")
    card = environment(torch)
    _done("1", t)
    rows = []
    if 2 in phases:
        t = _phase("2 kernels vs plain")
        rows = kernels_vs_plain(torch, k4_sweep=args.k4_sweep,
                                b2_sweep=args.b2_sweep,
                                b7_sweep=args.b7_sweep,
                                k1_sweep=args.k1_sweep)
        _done("2", t)
    launches = {path: None for path in PATHS}
    if 13 in phases:
        t = _phase("13 the public block_multihead_attention")
        launches["blha"] = full_width_blha(torch)
        gc.collect()
        torch.cuda.empty_cache()
        _done("13", t)
    model = full_width_model(torch) if phases & {3, 5, 11, 12} else None
    if 3 in phases:
        t = _phase("3 full-width serving")
        launches["serving"] = full_width_serving(torch, model)
        _done("3", t)
    pair = two_layer_models(torch) if phases & {4, 6, 8} else None
    # the 2-layer Llamas at head_dim 72, 100, 264 and 640 (phases 4, 6, 8)
    dims = ({d: two_layer_models(torch, d) for d in HEAD_DIM_LLAMAS}
            if phases & {4, 6, 8} else None)
    if 4 in phases:
        t = _phase("4 kernel path vs plain path")
        kernels_vs_plain_path(torch, *pair)
        spec_and_transfer_vs_plain(torch, *pair)
        for d in (72, 264, 640):
            print(f"-- head_dim {d}")
            kernels_vs_plain_path(torch, *dims[d])
        _load_weights_on_graphs(torch, dims[72][0],
                                two_layer_models(torch, 72, seed=2)[0])
        for d in (None, 72, 640):
            print(f"-- int8 cache, head_dim {d or 128}")
            int8_kernels_vs_plain(torch, *(dims[d] if d else pair))
        _done("4", t)
    if 5 in phases:
        t = _phase("5 full-width generation")
        launches["generate"] = full_width_generation(torch, model)
        _done("5", t)
    if 6 in phases:
        t = _phase("6 generation: kernel path vs plain path")
        generation_kernels_vs_plain(torch, *pair)
        for d in (72, 100, 264, 640):
            print(f"-- head_dim {d}")
            generation_kernels_vs_plain(torch, *dims[d])
        _done("6", t)
    if 11 in phases:
        t = _phase("11 full-width speculative serving and block transfer")
        launches["spec"] = full_width_spec(torch, model)
        gc.collect()
        full_width_transfer(torch, model)
        gc.collect()
        torch.cuda.empty_cache()
        _done("11", t)
    if 12 in phases:
        t = _phase("12 full-width int8-cache serving")
        launches["int8"] = full_width_int8(torch, model)
        gc.collect()
        torch.cuda.empty_cache()
        _done("12", t)
    model = None                # the 7B weights: room for training
    torch.cuda.empty_cache()
    if 7 in phases:
        t = _phase("7 full-width training")
        launches["train"] = full_width_training(torch)
        torch.cuda.empty_cache()
        _done("7", t)
    if 8 in phases:
        t = _phase("8 training: kernel path vs plain path")
        training_kernels_vs_plain(torch, *pair)
        for d in (72, 264, 640):
            print(f"-- head_dim {d}")
            training_kernels_vs_plain(torch, *dims[d])
        _done("8", t)
    pair = dims = None
    torch.cuda.empty_cache()
    if 9 in phases:
        t = _phase("9 full-width predictor")
        launches["predict"] = full_width_predictor(torch, card)
        _done("9", t)
    if 10 in phases:
        t = _phase("10 predictor: kernel path vs plain path")
        predictor_kernels_vs_plain(torch)
        _done("10", t)
    # launches per path, each from that path's own run: null when its
    # phase did not run
    for r in rows:
        r["launches"] = {path: (None if n is None else n[r["name"]])
                         for path, n in launches.items()}
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
