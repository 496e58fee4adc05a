#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path — Llama serving through the paged
ServingEngine — on one NVIDIA H100, and check every Hopper kernel on it.

    python3 chip_smoke.py               # all phases
    python3 chip_smoke.py --phases 1,2  # build + kernel checks only

Phases (each prints its seconds):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), compute capability 9.0, and the kernel build from
     paddle_tpu_torch/csrc (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     in bfloat16 and float32, at the shapes the serving path gives it;
     then CUDA-event times (L2 flushed before each launch) of the kernel,
     the plain version and, where one exists, the one PyTorch call that
     computes the same function, beside the bound: the larger of bytes
     moved over 3.35 TB/s and operations over the peak rate of the type;
     and a shape past a kernel's shared memory is refused with an error;
  3. Llama-2-7B geometry (32000 vocab, 4096 hidden, 11008 intermediate, 32
     layers, 32 heads) in bfloat16 with seeded random weights, served by
     ServingEngine(max_batch_size=8, max_seq_len=512, block_size=16,
     token_budget=256) with the default megastep_k=8 and prefix cache, in
     two waves; the kernels' launch counters are zeroed just before and
     read just after, and the device loops run with CUDA sync debugging
     set to raise (no host sync inside a megastep); then two more waves,
     one timed and one under torch.profiler, give the device's busy share;
  4. the same geometry at 2 layers in float32 served on cuda (kernels) and
     on the CPU (plain versions) from identical weights: first-step logits
     agree, greedy tokens agree up to the first position whose CPU top-2
     logit gap is below 1e-3, and prefix cache on/off agree on cuda;
  5. one JSON line {"kernels": [...]} ("launches" is null for every kernel
     when phase 3 did not run), then the card line, then
     {"ok": true, "device": {...}} as the last line.

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
    "swiglu": "paddle_tpu/ops/pallas/fused_ops.py:164",
    # not a Pallas kernel: the jnp attention core XLA compiles
    "paged_attention": "paddle_tpu/ops/paged_attention.py:262",
}
SOURCES = {
    "rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rms_norm_residual": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rope": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu": "paddle_tpu_torch/csrc/fused_ops.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
}


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
    return card


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
    ops) at the shapes the serving path gives each kernel."""
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
    kernels line (bfloat16, the serving type)."""
    timer = Timer(torch, iters)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name, label, kern, plain, lib, nbytes, ops in kernel_cases(
                torch, dtype):
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            err, tol = _err(torch, got, ref), _tol(dname, ref)
            ms, plain_ms = timer(kern), timer(plain)
            lib_ms = timer(lib) if lib is not None else None
            bound_ms, bound_by = _bound(nbytes, ops, dname)
            print(f"kernel {name} {dname} {label}: max_abs_err {err:.3e} "
                  f"tol {tol:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
            if not err <= tol:
                raise AssertionError(f"{name} {dname} {label}: kernel and "
                                     f"plain differ by {err} > {tol}")
            if dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, shape=label, dtype=dname, route="cuda",
                    source=SOURCES[name], replaces=REPLACES[name],
                    max_abs_err=err, max_err=err, tol=tol, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms))
    _refusals(torch)
    return rows


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
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 3
def _counters():
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    return {"rms_norm": fused_norm.rms_norm_fused,
            "rms_norm_residual": fused_norm.rms_norm_residual_fused,
            "rope": fused_ops.rope_fused, "swiglu": fused_ops.swiglu_fused,
            "paged_attention": pa.paged_attention}


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


def full_width_serving(torch):
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    cfg = llama_7b(dtype="bfloat16")
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama_7b: {n_params} parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16, init seconds "
          f"{time.perf_counter() - t:.3f}")
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
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = _serve_waves(eng, [wave1, wave2])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.state_summary()
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {n_tok} tokens in {secs:.3f} s "
          f"({n_tok / secs:.1f} tokens/s, informative)")
    print(f"megastep {st['megastep']} prefill_tokens_computed "
          f"{eng.prefill_tokens_computed} prefix_hit_blocks "
          f"{eng.prefix_hit_blocks}")
    print(f"phase_seconds {json.dumps(st['phase_seconds'])}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    print(f"launches {json.dumps(launches)}")
    if not (eng.megasteps > 0 and eng.megasteps_mixed > 0
            and eng.prefix_hit_blocks > 0):
        raise AssertionError("the serving run did not arm the megastep, the "
                             "mixed loop and the prefix cache")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 "main path")
    for o in outs:
        if any(not 0 <= t < cfg.vocab_size for t in o):
            raise AssertionError("token outside the vocabulary")
    # a decode-heavy wave: 8 rows, 64-token prompts, 32 new tokens each
    _profile_window(torch, eng, [[(prompt(64), 32, None) for _ in range(8)]
                                 for _ in range(2)])
    return launches


def _profile_window(torch, eng, waves):
    """Serve ``waves[0]`` untraced (wall time), then ``waves[1]`` (same
    shape, other prompts) under torch.profiler: device time by kernel, and
    the device's busy share of the untraced wall time (one stream, so
    kernel times do not overlap; the trace's own wall time is inflated by
    the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    _serve_waves(eng, [waves[0]])
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _serve_waves(eng, [waves[1]])
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in evs)
    print(f"profile: untraced wall {wall_us / 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / wall_us:.1f}%), "
          f"{sum(e.count for e in evs)} device kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.2f} ms "
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


def _agree(a, b, gaps, what):
    """Tokens equal up to the first position whose top-2 gap < 1e-3."""
    stop = next((i for i, g in enumerate(gaps) if g < 1e-3), len(gaps))
    if stop < len(gaps):
        print(f"{what}: CPU top-2 gap {gaps[stop]:.2e} < 1e-3 at position "
              f"{stop}; compared positions 0..{stop - 1}")
    if a[:stop] != b[:stop]:
        raise AssertionError(f"{what}: tokens differ before position {stop}:"
                             f" {a[:stop]} vs {b[:stop]}")


def kernels_vs_plain_path(torch):
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
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


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4",
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
    launches = {}
    if 3 in phases:
        t = _phase("3 full-width serving")
        launches = full_width_serving(torch)
        _done("3", t)
    if 4 in phases:
        t = _phase("4 kernel path vs plain path")
        kernels_vs_plain_path(torch)
        _done("4", t)
    # launch counts come from phase 3 only: null when it did not run
    for r in rows:
        r["launches"] = launches.get(r["name"])
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
