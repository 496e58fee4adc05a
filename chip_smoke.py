#!/usr/bin/env python3
"""Drive paddle_tpu_torch's four paths — Llama serving through the paged
ServingEngine, Llama generation (forward, generate, greedy_decode) over the
static KV ring, Llama pretraining (TrainStep + AdamW), and the inference
Predictor with weight-only int8 over bench_ladder.py's BERT-base classifier
— on one NVIDIA H100, and check every Hopper kernel on them.

    python3 chip_smoke.py                  # all phases
    python3 chip_smoke.py --phases 1,2     # build + kernel checks only
    python3 chip_smoke.py --phases 2,9,10  # kernels + the int8 predictor

Phases (each prints its seconds):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), compute capability 9.0, and the kernel build from
     paddle_tpu_torch/csrc (nvcc, sm_90a); cuobjdump -sass of the build must
     show tensor-core (HGMMA) instructions in every bf16 B1 and B8
     instance;
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     in bfloat16 and float32, at the shapes the paths give it (B9 over
     three steps from one state);
     then CUDA-event times (L2 flushed before each launch) of the kernel,
     the plain version and, where one exists, the one PyTorch call that
     computes the same function, beside the bound: the larger of bytes
     moved over 3.35 TB/s and operations over the peak rate of the type,
     and each row's TFLOP/s and share of its bound;
     a shape past a kernel's shared memory is refused with an error, and
     B7 refuses a float16 x and an int32 weight; then (informative) B1 and
     B8 in bf16 at every compiled tile pair (autotune.tune), B8's two GQA
     modes, and whether two bf16 B8 runs agree bit for bit;
  3. Llama-2-7B geometry (32000 vocab, 4096 hidden, 11008 intermediate, 32
     layers, 32 heads) in bfloat16 with seeded random weights, served by
     ServingEngine(max_batch_size=8, max_seq_len=512, block_size=16,
     token_budget=256) with the default megastep_k=8 and prefix cache, in
     two waves (the first holds a sampled request); the kernels' launch
     counters are zeroed just before and read just after, and the device
     loops run with CUDA sync debugging set to raise (no host sync inside a
     megastep); then the cost of the seeded threefry draw per sampled step,
     and two more waves, one timed and one under torch.profiler, give the
     device's busy share;
  4. the same geometry at 2 layers in float32 served on cuda (kernels) and
     on the CPU (plain versions) from identical weights: first-step logits
     agree, greedy tokens agree up to the first position whose CPU top-2
     logit gap is below 1e-3, and prefix cache on/off agree on cuda;
  5. generation at full width, on phase 3's model: the launch counters are
     zeroed, then (a) model(ids [2, 1024]) gives finite logits, (b)
     greedy_decode of ids [8, 128], 128 new tokens over a 512-row ring runs
     with CUDA sync debugging set to raise (tokens/s printed, informative;
     then a 32-token greedy_decode untraced and one under torch.profiler
     give the device's busy share and time by kernel), (c) generate with
     the static ring equals greedy_decode; generate with growing caches
     (B1 for every step) gives greedy_decode's first
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
     cuda agree with greedy_decode on the CPU up to the top-2-gap stop;
  7. training at bench.py's honest geometry (32000 vocab, 2560 hidden,
     8192 intermediate, 9 layers, 20 heads of 128, bfloat16, recompute)
     with seeded random weights: AdamW(1e-4, multi_precision=True),
     LlamaPretrainingCriterion and TrainStep on one [8, 2048] batch; the
     counters are zeroed, then 2 warm-up and 10 timed steps (finite losses,
     the last below the first; tokens/s, ms per step, peak memory and MFU
     against 989 TFLOP/s printed, informative), run_steps over a
     [4, 8, 2048] stack with CUDA sync debugging set to raise, one step
     untraced and one under torch.profiler (busy share, time by kernel);
     then every kernel of the path launched;
  8. phase 4's float32 pair: one step's loss and every parameter's
     gradient, then the parameters after 3 AdamW(multi_precision) steps
     through TrainStep, kernels on cuda against the plain path on the CPU
     (1e-4 of each tensor's largest |value|);
  9. bench_ladder.py's BERT-base classifier (vocab 30522, hidden 768, 12
     layers, 12 heads, FFN 3072, seq 128) in bfloat16 with seeded random
     weights, ids [32, 128]: (a) the float Predictor gives finite logits;
     (b) the weight-only int8 Predictor, with the counters zeroed just
     before one run and read just after, launches B7 exactly 73 times and
     B1 12 times and gives finite logits (their distance from (a) printed,
     informative); (c) a full-width bf16 weight quantizes to the same int8
     values and scales on cuda and on the CPU; (d) ms per run and
     sequences/s of both predictors at [32, 128] and [1, 128], and one int8
     run untraced and one under torch.profiler (busy share, time by
     kernel), informative;
 10. the classifier at 2 layers in float32 with identical weights on cuda
     and on the CPU, ids [4, 128], through int8 Predictors (identical
     quantized weights) and float ones: logits within 1e-4 of the largest
     |logit|;
  then one JSON line {"kernels": [...]}, "launches" per path ({"serving",
  "generate", "train", "predict"}, null for a path whose phase did not
  run), then the card line, then {"ok": true, "device": {...}} as the last
  line.

Any failure raises and the script exits non-zero before the last line.  It
imports nothing of JAX or paddle_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor, fp32 SIMT
REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:47",
    "rms_norm_residual": "paddle_tpu/ops/pallas/fused_norm.py:61",
    "rope": "paddle_tpu/ops/pallas/fused_ops.py:65",
    # the same kernel rotating the cotangents by -theta
    "rope_bwd": "paddle_tpu/ops/pallas/fused_ops.py:121",
    "swiglu": "paddle_tpu/ops/pallas/fused_ops.py:164",
    "swiglu_bwd": "paddle_tpu/ops/pallas/fused_ops.py:178",
    # not a Pallas kernel: the jnp attention core XLA compiles
    "paged_attention": "paddle_tpu/ops/paged_attention.py:262",
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
    "rope_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
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
    "rope_bwd": ("gq", "gk"),
    "swiglu_bwd": ("da", "db"),
    "kv_ring_write": ("k ring", "v ring"),
}
# the kernels each path runs (phase 3 serving, phase 5 generation, phase 7
# training, phase 9 the int8 predictor)
PATHS = {
    "serving": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                "paged_attention"),
    "generate": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                 "flash_attention", "decode_attention", "kv_ring_write"),
    "train": ("rms_norm", "rms_norm_residual", "rope", "rope_bwd", "swiglu",
              "swiglu_bwd", "flash_attention", "flash_attention_bwd",
              "fused_adamw"),
    "predict": ("int8_matmul", "flash_attention"),
}
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


# bf16 B1 and B8 run on the tensor cores: every instance of these kernels
# must hold warpgroup MMA instructions (HGMMA) in its SASS
TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_tc_kernel")


def _sass_check(lib_path):
    """cuobjdump -sass of the built library: count HGMMA instructions per
    function; raise unless every instance of the bf16 B1 and B8 kernels has
    some."""
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
            counts[cur] = 0
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    for tag in TENSOR_CORE_KERNELS:
        found = {f: n for f, n in counts.items() if tag in f}
        print(f"sass {tag}: {len(found)} instances, HGMMA per instance "
              f"{sorted(found.values())}")
        if not found or min(found.values()) == 0:
            raise AssertionError(f"no HGMMA in the SASS of {tag}: "
                                 f"{found}")


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
    for n in (256, 8):
        H = 4096
        x, r, w = rnd(n, H), rnd(n, H), rnd(H)
        cases.append((
            "rms_norm", f"[{n}, {H}]",
            lambda x=x, w=w: fused_norm.rms_norm_fused(x, w, 1e-6),
            lambda x=x, w=w: fused_norm._ref_rms(x, w, 1e-6),
            lambda x=x, w=w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
            (2 * n * H + H) * es, 4 * n * H))
        cases.append((
            "rms_norm_residual", f"[{n}, {H}]",
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
    for Hk in (Hq, 8):
        qkv = rnd(T, (Hq + 2 * Hk) * D)
        q = qkv[:, :Hq * D].view(1, T, Hq, D)
        k = qkv[:, Hq * D:(Hq + Hk) * D].view(1, T, Hk, D)
        cases.append((
            "rope", f"q [1, {T}, {Hq}, {D}], k [1, {T}, {Hk}, {D}]",
            lambda q=q, k=k: fused_ops.rope_fused(q, k, cos, sin),
            lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, sin), None,
            2 * T * (Hq + Hk) * D * es + 2 * T * (D // 2) * 4,
            6 * T * (Hq + Hk) * D // 2))
    a, b = rnd(256, 11008), rnd(256, 11008)
    cases.append((
        "swiglu", "[256, 11008]",
        lambda: fused_ops.swiglu_fused(a, b),
        lambda: fused_ops._swiglu_ref(a, b), None,
        3 * a.numel() * es, 5 * a.numel()))

    cases += _generation_cases(torch, rnd, es, g, dtype)
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
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B)):
        cases.append(_paged_case(torch, rnd, es, g, label, heads, kv_heads,
                                 hd, dec.to(torch.int32), now))
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
    # B2: one token per row against the ring, cols <= pos
    for label, B, L, H, KVH, D, pos in (
            ("[8, L=512, 32, 128] pos 300", 8, 512, 32, 32, 128, 300),
            ("[8, L=4096, 32, 128] pos 4000", 8, 4096, 32, 32, 128, 4000),
            ("GQA 32 / 8 [8, L=512] pos 300", 8, 512, 32, 8, 128, 300)):
        q, kb, vb = rnd(B, 1, H, D), rnd(B, L, KVH, D), rnd(B, L, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        cases.append((
            "decode_attention", label,
            lambda q=q, kb=kb, vb=vb, p=p: da.decode_attention(q, kb, vb, p),
            lambda q=q, kb=kb, vb=vb, p=p: da.ref_decode_attention(
                q, kb, vb, p),
            _sdpa_b2(torch, q, kb, vb, pos),
            (2 * B * H * D + 2 * B * (pos + 1) * KVH * D) * es,
            4 * B * H * (pos + 1) * D))
    # B3: rows written into [8, 512, 32, 128] rings in place
    for label, S, pos in (("1 row into [8, 512, 32, 128] at 300", 1, 300),
                          ("128 rows into [8, 512, 32, 128] at 200", 128,
                           200)):
        B, L, KVH, D = 8, 512, 32, 128
        kb, vb = rnd(B, L, KVH, D), rnd(B, L, KVH, D)
        kb2, vb2 = kb.clone(), vb.clone()
        kn, vn = rnd(B, S, KVH, D), rnd(B, S, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        rows = torch.arange(pos, pos + S, device=dev)
        cases.append((
            "kv_ring_write", label,
            lambda kb=kb, vb=vb, kn=kn, vn=vn, p=p: da.kv_ring_write(
                kb, vb, kn, vn, p),
            lambda kb=kb2, vb=vb2, kn=kn, vn=vn, p=p: da._ref_ring_write(
                kb, vb, kn, vn, p),
            lambda kb=kb2, vb=vb2, kn=kn, vn=vn, r=rows: (
                kb.index_copy_(1, r, kn), vb.index_copy_(1, r, vn)),
            4 * B * S * KVH * D * es, 0))
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
            None if Sq > Sk else _sdpa_b8(torch, q, kk, v, go, causal),
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
    for label, x, K, N in (
            (f"q/k/v/out [{T}, {E}] x [{E}, {E}]", rnd(T, E), E, E),
            (f"linear1 [{T}, {E}] x [{E}, {I}]", rnd(T, E), E, I),
            (f"linear2 [{T}, {I}] x [{I}, {E}]", rnd(T, I), I, E),
            (f"head x[:, 0] [{BERT['batch']}, {E}] x [{E}, 2], rows "
             f"{S * E} apart", rnd(BERT["batch"], S, E)[:, 0], E, 2),
            ("odd [3, 100] x [100, 130]", rnd(3, 100), 100, 130),
            ("odd, 16-byte copies with tails: [64, 100 of 104] x [100, 144]",
             rnd(64, 104)[:, :100], 100, 144),
            ("off the path: decode-sized [8, 4096] x [4096, 11008]",
             rnd(8, 4096), 4096, 11008)):
        qw, sc = weight_quantize(rnd(K, N, dt=torch.float32) * 0.05)
        M = x.shape[0]
        cases.append((
            "int8_matmul", label,
            lambda x=x, qw=qw, sc=sc: im.int8_matmul(x, qw, sc),
            lambda x=x, qw=qw, sc=sc: im._int8_matmul_ref(x, qw, sc),
            _int8pack_lib(torch, x, qw, sc),
            # x, qw and scale read once, out written once
            M * K * es + K * N + 4 * N + M * N * es, 2 * M * N * K))
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
    (graph retained) on [B, H, S, D] copies."""
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


def _paged_case(torch, rnd, es, g, label, H, KV, D, dec, now):
    """One K4 case: a decode batch (one token per row, T = B) or a mixed
    batch in the single-step program's [256] buffer (max_q_len 256)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    NB, bs, P, B = 256, 16, 32, 8
    dev = "cuda"
    kc, vc = rnd(NB, KV, bs, D), rnd(NB, KV, bs, D)
    bt = torch.randperm(NB, generator=g, device=dev).view(B, P).to(
        torch.int32)
    now = torch.tensor(now, dtype=torch.int32, device=dev)
    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(now, 0)
    decode = int(now.max()) == 1
    T = int(cu[-1]) if decode else 256
    mq = 1 if decode else 256
    q = rnd(T, H, D)
    # bytes: q and the output once, each row's visible K/V once
    ctx = int((dec + now).sum())
    nbytes = (2 * T * H * D + 2 * ctx * KV * D) * es
    # QK^T and PV, 2 operations per multiply-add, over each token's
    # visible keys
    vis = sum(d * n + n * (n + 1) // 2
              for d, n in zip(dec.tolist(), now.tolist()))
    ops = 4 * vis * H * D
    return ("paged_attention", label,
            lambda: pa.paged_attention(q, kc, vc, dec, now, cu, bt, mq),
            lambda: pa._paged_attention_ref(q, kc, vc, dec, now, cu, bt, mq),
            _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq), nbytes, ops)


def _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq):
    """F.scaled_dot_product_attention over the gathered, padded context
    (the library yardstick for K4; timed alone, gather excluded)."""
    from paddle_tpu_torch.ops.hopper.paged_attention import paged_gather_kv

    B = bt.shape[0]
    H, D = q.shape[1], q.shape[2]
    S = int(now.max())
    k_all = paged_gather_kv(kc, bt)              # [B, KV, L, D]
    v_all = paged_gather_kv(vc, bt)
    L = k_all.shape[2]
    qp = torch.zeros(B, H, S, D, dtype=q.dtype, device=q.device)
    for b in range(B):
        n = int(now[b])
        if n:
            qp[b, :, :n] = q[int(cu[b]):int(cu[b]) + n].transpose(0, 1)
    qpos = dec.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]        # [B, 1, S, L]
    F = torch.nn.functional
    gqa = {"enable_gqa": True} if k_all.shape[1] != H else {}
    return lambda: F.scaled_dot_product_attention(
        qp, k_all, v_all, attn_mask=mask, **gqa)


def kernels_vs_plain(torch, iters=20):
    """Check every case in both types; time it; return the rows of the
    kernels line (bfloat16, the type the paths run in)."""
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
            for lab, val, lim in parts:
                if not val <= lim:
                    raise AssertionError(
                        f"{name} {dname} {label}: kernel and plain differ "
                        f"{'in ' + lab + ' ' if lab else ''}by {val} > {lim}")
            if dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, shape=label, dtype=dname, route="cuda",
                    source=SOURCES[name], replaces=REPLACES[name],
                    max_abs_err=err, max_err=err, tol=tol, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms))
    _refusals(torch)
    _flash_tiles(torch)
    return rows


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
    """Shapes past a kernel's 48 KB of shared memory are refused by the
    C entry (the one place the limit is stated) and raise, naming the
    error: a 16384-wide RMSNorm row, a 64-head group over one KV head."""
    from paddle_tpu_torch.ops.hopper import fused_norm
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    dev, dt = "cuda", torch.bfloat16
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    calls = {
        "rms_norm [1, 16384]": lambda: fused_norm.rms_norm_fused(
            torch.ones(1, 16384, dtype=dt, device=dev),
            torch.ones(16384, dtype=dt, device=dev)),
        "paged_attention 64 heads / 1 KV": lambda: pa.paged_attention(
            torch.ones(1, 64, 128, dtype=dt, device=dev),
            torch.ones(1, 1, 16, 128, dtype=dt, device=dev),
            torch.ones(1, 1, 16, 128, dtype=dt, device=dev), z, one,
            torch.tensor([0, 1], dtype=torch.int32, device=dev),
            torch.zeros(1, 1, dtype=torch.int32, device=dev), 1),
    }
    for label, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "invalid configuration" not in str(e):
                raise
            print(f"refused {label}: {e}")
        else:
            raise AssertionError(f"{label} was not refused")
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
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    from paddle_tpu_torch.ops.hopper.fused_adamw import fused_adamw
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul

    return {"rms_norm": fused_norm.rms_norm_fused,
            "rms_norm_residual": fused_norm.rms_norm_residual_fused,
            "rope": fused_ops.rope_fused,
            "rope_bwd": fused_ops.rope_bwd_fused,
            "swiglu": fused_ops.swiglu_fused,
            "swiglu_bwd": fused_ops.swiglu_bwd_fused,
            "paged_attention": pa.paged_attention,
            "flash_attention": fa.flash_attention_fused,
            "decode_attention": da.decode_attention,
            "kv_ring_write": da.kv_ring_write,
            "flash_attention_bwd": fa.flash_attention_bwd_fused,
            "fused_adamw": fused_adamw,
            "int8_matmul": int8_matmul}


def _zero_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
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


def _serve_waves(eng, waves):
    """Run each wave of (prompt, max_new_tokens, sampling) to completion;
    check every request returned its token count."""
    out = []
    for wave in waves:
        rids = [eng.add_request(p, max_new_tokens=n, sampling=s)
                for p, n, s in wave]
        done = eng.run()
        eng.pop_finished()
        for rid, (_, n, _) in zip(rids, wave):
            if len(done[rid]) != n:
                raise AssertionError(f"request {rid} returned "
                                     f"{len(done[rid])} of {n} tokens")
            out.append(done[rid])
    return out


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
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = model.config
    eng = ServingEngine(model, max_batch_size=8, max_seq_len=512,
                        block_size=16, token_budget=256)
    kv_gb = sum(c.numel() * c.element_size()
                for c in eng.key_caches + eng.value_caches) / 1e9
    print(f"KV pool {eng.blocks.num_blocks} blocks, {kv_gb:.2f} GB")
    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    sampled = dict(temperature=0.8, top_p=0.9, seed=7)
    lens = [7, 40, 128, 200, 260, 33, 400, 90, 150]
    news = [48, 32, 64, 40, 56, 1, 36, 60, 44]
    wave1 = [(prompt(n), m, sampled if i == 3 else None)
             for i, (n, m) in enumerate(zip(lens, news))]
    wave2 = [(wave1[2][0], 32, None), (prompt(70), 40, None)]
    # no host sync inside a megastep: the device loops raise on one
    for name in ("_run_megastep", "_run_mixed"):
        setattr(eng, name, _sync_free(torch, getattr(eng, name)))
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = _serve_waves(eng, [wave1])
    torch.cuda.synchronize()
    wave1_s = time.perf_counter() - t
    outs += _serve_waves(eng, [wave2])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("serving", counters)
    st = eng.state_summary()
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {n_tok} tokens in {secs:.3f} s "
          f"({n_tok / secs:.1f} tokens/s, informative); wave 1 (one "
          f"sampled request) {wave1_s:.3f} s")
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
    # a decode-heavy wave: 8 rows, 64-token prompts, 32 new tokens each
    waves = [[(prompt(64), 32, None) for _ in range(8)] for _ in range(2)]
    _profile(torch, "decode wave (8 rows, 64-token prompts, 32 new tokens)",
             lambda: _serve_waves(eng, [waves[0]]),
             lambda: _serve_waves(eng, [waves[1]]), top=15)
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


def _profile(torch, label, untraced, traced=None, top=12):
    """Run ``untraced()`` on the host clock (wall time), then ``traced()``
    (the same call by default) under torch.profiler: the device's busy share
    of the untraced wall time (one stream, so kernel times do not overlap;
    the trace's own wall time is inflated by the profiler) and device time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    untraced()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (traced or untraced)()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in evs)
    print(f"profile {label}: untraced wall {wall_us / 1e3:.2f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms ({100 * dev_us / wall_us:.1f}%), "
          f"{sum(e.count for e in evs)} device kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d}  {e.key[:90]}")


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


def _top2_gaps(torch, eng, prompt, gen):
    """CPU teacher-forced logits of prompt + gen[:-1] on a fresh engine ->
    the top-2 logit gap at each generated position."""
    import numpy as np

    seq = list(prompt) + list(gen[:-1])
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
    h = eng._trunk(d(tokens), d(now), d(z), d(now), d(cu),
                   d(eng.block_tables), eng.T)
    lg = (h[len(prompt) - 1:n] @ eng._weights["head"]).float()
    top2 = torch.topk(lg, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _agree(a, b, gaps, what, thresh=1e-3):
    """Tokens equal up to the first position whose top-2 gap < thresh."""
    stop = next((i for i, g in enumerate(gaps) if g < thresh), len(gaps))
    if stop < len(gaps):
        print(f"{what}: top-2 gap {gaps[stop]:.2e} < {thresh:.1e} at "
              f"position {stop}; compared positions 0..{stop - 1}")
    if a[:stop] != b[:stop]:
        raise AssertionError(f"{what}: tokens differ before position {stop}:"
                             f" {a[:stop]} vs {b[:stop]}")


def two_layer_models(torch):
    """The 7B geometry at 2 layers in float32, on cuda and on the CPU, with
    identical weights (phases 4 and 6)."""
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        llama_7b,
        load_numpy_state_dict,
    )

    cfg = llama_7b(dtype="float32", num_hidden_layers=2)
    gpu_model = LlamaForCausalLM(cfg, seed=1)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=1)
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


# --------------------------------------------------------------- phase 5
def _forced_logits(torch, model, ids, toks, static):
    """Last-position logits [B, n, V] (float32) of the prefill and of each
    decode step fed ``toks[:, :-1]``: the logits from which a decode loop
    picked ``toks``, through the ring (static) or growing caches."""
    from paddle_tpu_torch.models.generation import _make_static_caches

    B, S = ids.shape
    n = toks.shape[1]
    cfg = model.config
    if static:
        _, caches = _make_static_caches(model, B, S, n, None)
    else:
        dt = model.llama.embed_tokens.weight.dtype
        z = torch.zeros((B, 0, cfg.num_key_value_heads, cfg.head_dim),
                        dtype=dt, device=ids.device)
        caches = [(z, z) for _ in range(cfg.num_hidden_layers)]
    out = []
    with torch.no_grad():
        logits, caches = model(ids, caches=caches)
        out.append(logits[:, -1].float())
        for i in range(n - 1):
            logits, caches = model(toks[:, i:i + 1], caches=caches)
            out.append(logits[:, -1].float())
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
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = _sync_free(torch, greedy_decode)(model, p8, max_new_tokens=128,
                                           max_length=512)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    in_vocab(toks, "greedy_decode")
    print(f"(b) greedy_decode [8, 128] + 128 tokens, ring 512: {secs:.3f} s "
          f"({8 * 128 / secs:.1f} tokens/s, informative), no host sync "
          "inside the loop")
    _profile(torch, "greedy_decode [8, 128] + 32 tokens",
             lambda: greedy_decode(model, p8, max_new_tokens=32,
                                   max_length=512))
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
    print("generation kernel path == plain path (greedy_decode, generate "
          "ring and growing)")


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
    _profile(torch, "train step", lambda: step(ids), top=20)
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
    print(f"bert_base: {n_params} parameters, bf16; both predictors built "
          f"in {time.perf_counter() - t:.3f} s")
    ref = fp.run([ids])[0]
    if ref.shape != (BERT["batch"], 2) or not np.isfinite(ref).all():
        raise AssertionError(f"float logits {ref.shape} not finite [32, 2]")
    print(f"(a) float predictor: logits {ref.shape} {ref.dtype}, finite")
    torch.cuda.synchronize()
    counters = _zero_counters()
    got = q8.run([ids])[0]
    launches = _path_launches("predict", counters)
    want = {"int8_matmul": 6 * BERT["layers"] + 1,
            "flash_attention": BERT["layers"]}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"one int8 run launched {launches}, "
                             f"expected {want}")
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError("int8 logits not finite")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"(b) int8 predictor: B7 {launches['int8_matmul']} and B1 "
          f"{launches['flash_attention']} launches in one run, logits "
          f"finite; largest difference from (a) {rel:.4f} of the largest "
          f"|logit| {float(np.abs(ref).max()):.4f} (informative)")
    w = model.encoder.layers[0].linear1.weight
    qg, sg = weight_quantize(w)
    qc, sc = weight_quantize(w.detach().cpu())
    if not (torch.equal(qg.cpu(), qc)
            and torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))):
        raise AssertionError("weight_quantize differs between cuda and cpu")
    print(f"(c) weight_quantize of a bf16 {list(w.shape)} weight: int8 "
          f"values and scales identical on cuda and the CPU")
    for x in (ids, ids1):
        for name, pred in (("float", fp), ("int8", q8)):
            ms = _ms_per_run(torch, pred, x)
            print(f"(d) {name} predictor [{x.shape[0]}, {x.shape[1]}]: "
                  f"{ms:.3f} ms per run, {x.shape[0] / ms * 1e3:.1f} "
                  f"sequences/s ({card}; informative)")
    _profile(torch, f"int8 predictor [{ids.shape[0]}, {ids.shape[1]}]",
             lambda: q8.run([ids]))
    return launches


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
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10",
                    help="phases to run after phase 1 (always run)")
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

    t = _phase("1 environment")
    card = environment(torch)
    _done("1", t)
    rows = []
    if 2 in phases:
        t = _phase("2 kernels vs plain")
        rows = kernels_vs_plain(torch)
        _done("2", t)
    launches = {path: None for path in PATHS}
    model = full_width_model(torch) if phases & {3, 5} else None
    if 3 in phases:
        t = _phase("3 full-width serving")
        launches["serving"] = full_width_serving(torch, model)
        _done("3", t)
    pair = two_layer_models(torch) if phases & {4, 6, 8} else None
    if 4 in phases:
        t = _phase("4 kernel path vs plain path")
        kernels_vs_plain_path(torch, *pair)
        _done("4", t)
    if 5 in phases:
        t = _phase("5 full-width generation")
        launches["generate"] = full_width_generation(torch, model)
        _done("5", t)
    if 6 in phases:
        t = _phase("6 generation: kernel path vs plain path")
        generation_kernels_vs_plain(torch, *pair)
        _done("6", t)
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
        _done("8", t)
    pair = None
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
