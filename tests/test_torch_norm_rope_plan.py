"""Kernels K1 (RMSNorm) and K2 (rope): their division of work and the
edges it adds, on the CPU.

``rms_plan`` (``paddle_tpu_torch/ops/hopper/fused_norm.py``) picks K1's
pack width, the packs a thread holds, the threads of a row and the rows of
a block from host sizes; ``rope_plan`` (``ops/hopper/fused_ops.py``) K2's
thread per (token, head, chunk).  Python mirrors of the kernels' index
maps (``rms_kernel`` in ``csrc/fused_norm.cu``, ``rope_kernel`` in
``csrc/fused_ops.cu``) show, over many sizes (hypothesis), that every
element is read and written exactly once, including the rows wider than
the registers, D % 16 != 0 and the strided q / k columns of a packed qkv
buffer; that the plan names only instances the source's dispatch compiles,
within its thread limit and the register budget.  An emulation of K1's
sums (per thread, then per row, in the kernel's order) is held against
the plain version, and the plain versions against the reference's Pallas
kernels in ``interpret=True`` at the widths the port used to refuse (H
16384), without 16-byte packs (H 4100) and training's (H 2560).  ``rope``
with the position offset on the device is held against the reference's
``apply_rotary_pos_emb(position_offset=Tensor)``, clamped offsets
included, and the backward's sign flag against ``-sin`` bit for bit.

Tolerances: float32 1e-5 abs / 1e-5 rel, as test_torch_kernels.py (one
row reduction or an elementwise rotation, summed in another order); the
sum emulation 1e-6 of the row's sum of squares (float32 partial sums in
another association).
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import paddle_tpu as P
from paddle_tpu.models.llama import apply_rotary_pos_emb as jax_rope_llama
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16
CSRC = os.path.join(os.path.dirname(fused_norm.__file__), "..", "..",
                    "csrc")
HELD_FLOATS = 64      # floats of its row a thread may hold (P 8 x 8 bf16)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ K1
def _norm_source():
    """The packs-a-thread instances the dispatch compiles, and the launch
    bounds' rule (held floats <= a -> b threads, else c)."""
    src = open(os.path.join(CSRC, "fused_norm.cu")).read()
    pers = {int(p) for p in re.findall(r"case (\d+): return go<", src)}
    a, b, c = map(int, re.search(
        r"__launch_bounds__\(P \* Pack<T, kVec>::N <= (\d+) \? (\d+) : "
        r"(\d+), 1\)", src).groups())
    return pers, (lambda held: b if held <= a else c)


def _row_packs(plan, nv):
    """The packs each thread of a row takes, in the kernel's order: the
    held ones (t + j tpr, j < per), then the rest of the row (from per
    tpr + t, step tpr).  -> a list over threads of index arrays."""
    out = []
    for t in range(plan.tpr):
        held = t + plan.tpr * np.arange(plan.per)
        rest = np.arange(plan.per * plan.tpr + t, nv, plan.tpr)
        out.append(np.concatenate([held[held < nv], rest]))
    return out


def _check_rms_plan(p, n, h, dtype, aligned):
    es = 2 if dtype == BF else 4
    pers, limit = _norm_source()
    assert set(fused_norm.PERS) == pers and p.per in pers
    assert p.vec == (aligned and h % (16 // es) == 0)
    assert p.pack == (16 // es if p.vec else 1)
    assert p.per * p.pack <= HELD_FLOATS
    assert p.threads == p.tpr * p.rows and p.threads % 32 == 0
    assert p.threads <= limit(p.per * p.pack)
    assert limit(p.per * p.pack) == fused_norm.max_threads(p.per * p.pack)
    assert (p.tpr < 32 and p.tpr & (p.tpr - 1) == 0) or p.tpr % 32 == 0
    # the rows: block b's thread i takes row b rows + i // tpr, each of
    # 0 .. n-1 exactly once (threads past n join only the reduction)
    tid = np.arange(p.threads)
    rows = (np.arange(p.blocks)[:, None] * p.rows
            + (tid // p.tpr)[None, :]).ravel()
    live = np.unique(rows[rows < n], return_counts=True)
    assert (live[0] == np.arange(n)).all() and (live[1] == p.tpr).all()
    assert p.blocks == -(-n // p.rows)
    # a row: every element in exactly one pack of exactly one thread
    nv = h // p.pack
    assert nv * p.pack == h
    hits = np.zeros(nv, np.int64)
    for packs in _row_packs(p, nv):
        np.add.at(hits, packs, 1)
    assert (hits == 1).all()
    assert p.wide == (p.per * p.tpr < nv)


@settings(max_examples=200, deadline=None, database=None)
@given(n=st.integers(1, 20000), h=st.integers(2, 65536),
       bf16=st.booleans(), aligned=st.booleans())
def test_rms_plan_covers_every_element_once(n, h, bf16, aligned):
    dtype = BF if bf16 else torch.float32
    p = fused_norm.rms_plan(n, h, dtype, aligned)
    _check_rms_plan(p, n, h, dtype, aligned)
    # the smallest holding that fits a row in one block, else the most
    if not p.wide:
        for smaller in fused_norm.PERS[:fused_norm.PERS.index(p.per)]:
            need = fused_norm._row_threads(-(-(h // p.pack) // smaller))
            assert need > fused_norm.max_threads(smaller * p.pack)


@pytest.mark.parametrize("n,h", [(8, 4096), (256, 4096), (16384, 2560),
                                 (1, 16384), (4, 16384), (2, 32768),
                                 (256, 4100), (3, 2), (100, 64), (7, 4097)])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_rms_plan_every_forced_instance(n, h, dtype):
    """Every plan chip_smoke.py's edge loop forces (both pack widths,
    every packs-a-thread instance with its default threads, and a 32-thread
    row) covers the same way; a forced plan the instances do not take
    raises."""
    forced = 0
    for vec in (True, False):
        for per in fused_norm.PERS:
            for tpr in (None, 32):
                try:
                    p = fused_norm.rms_plan(n, h, dtype, True, vec=vec,
                                            per=per, tpr=tpr)
                except ValueError:
                    continue
                _check_rms_plan(p, n, h, dtype, vec)
                forced += 1
    assert forced >= len(fused_norm.PERS)
    with pytest.raises(ValueError):
        fused_norm.rms_plan(n, h, dtype, True, per=3)
    with pytest.raises(ValueError):
        fused_norm.rms_plan(n, h, dtype, True, per=1, tpr=48)
    with pytest.raises(ValueError):
        fused_norm.rms_plan(n, h, dtype, True, tpr=64)


def test_rms_plan_choices():
    """Decode's [8, 4096] bf16: a thread a pack, 512 threads a row, one
    round trip; prefill's [256, 4096] 256 blocks of 512; training's [16384,
    2560] 320 threads a row, one pack each; [1, 16384] (refused before)
    2 packs a thread at 1024 threads, in registers; [2, 32768] past the
    registers (wide); H 4100 and a misaligned pointer take the scalar
    body; short rows share a block, fewer of them under 132 blocks."""
    plan = fused_norm.rms_plan
    p = plan(8, 4096, BF, True)
    assert (p.vec, p.per, p.tpr, p.rows, p.blocks, p.wide) == (
        True, 1, 512, 1, 8, False)
    assert plan(256, 4096, BF, True).blocks == 256
    p = plan(16384, 2560, BF, True)
    assert (p.per, p.tpr, p.threads) == (1, 320, 320)
    p = plan(1, 16384, BF, True)
    assert (p.per, p.tpr, p.wide) == (2, 1024, False)
    assert plan(2, 32768, BF, True).wide
    assert not plan(256, 4100, BF, True).vec
    assert not plan(8, 4096, BF, False).vec
    p = plan(100, 64, BF, True)
    assert (p.tpr, p.rows, p.blocks) == (8, 4, 25)
    assert plan(100000, 64, BF, True).rows == 32


def _emulate_rms(x, r, w, eps, plan):
    """K1's arithmetic on float32 numpy in the kernel's order: each
    thread's packs summed in its order, a row's threads added as the
    kernel adds them (a lane butterfly under 32, else warp butterflies
    then the warps in order), then (s * inv) * w."""
    s = x.astype(np.float32) + (0 if r is None else r.astype(np.float32))
    n, h = s.shape
    nv = h // plan.pack
    packs = _row_packs(plan, nv)
    out = np.empty_like(s)
    for i in range(n):
        sq = (s[i] * s[i]).reshape(nv, plan.pack)
        # a thread's sum, element after element (cumsum is sequential)
        part = np.array([np.cumsum(sq[ps].ravel(), dtype=np.float32)[-1]
                         if len(ps) else 0 for ps in packs], np.float32)

        def butterfly(v):
            v = v.copy()
            o = len(v) // 2
            while o:
                v = (v + v[np.arange(len(v)) ^ o]).astype(np.float32)
                o //= 2
            return v[0]

        if plan.tpr <= 32:
            tot = butterfly(part)
        else:
            tot = np.float32(0)
            for wv in part.reshape(-1, 32):
                tot = np.float32(tot + butterfly(wv))
        inv = np.float32(1) / np.sqrt(np.float32(tot / np.float32(h)
                                                 + np.float32(eps)))
        out[i] = (s[i] * inv) * w
    return out, s


@pytest.mark.parametrize("n,h,kw", [
    (3, 4096, {}), (2, 16384, {}), (2, 32768, {}), (3, 4100, {}),
    (4, 2560, {}), (5, 64, {}), (2, 4096, dict(per=1, tpr=64)),
    (2, 1000, dict(vec=False, per=2, tpr=32))])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_sum_emulation_matches_the_plain_version(n, h, kw, residual):
    rng = np.random.default_rng(h + n)
    x, w = _np(rng, n, h), _np(rng, h)
    r = _np(rng, n, h) if residual else None
    plan = fused_norm.rms_plan(n, h, torch.float32, True, **kw)
    got, s = _emulate_rms(x, r, w, 1e-6, plan)
    if residual:
        ref, res = fused_norm._ref_rms_residual(
            torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(w), 1e-6)
        np.testing.assert_array_equal(res.numpy(), s)
    else:
        ref = fused_norm._ref_rms(torch.as_tensor(x), torch.as_tensor(w),
                                  1e-6)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,h", [(2, 16384), (3, 4100), (4, 2560)])
def test_plain_versions_match_pallas_at_the_new_widths(n, h):
    """H 16384 (the CUDA entry refused it before), H 4100 (no 16-byte
    packs: the scalar body) and training's H 2560, against the reference's
    kernels in interpret mode."""
    rng = np.random.default_rng(h)
    x, r, w = _np(rng, n, h), _np(rng, n, h), _np(rng, h)
    ours = fused_norm.rms_norm_fused(torch.as_tensor(x), torch.as_tensor(w),
                                     1e-6)
    ref = jfn._pallas_rms(jnp.asarray(x), jnp.asarray(w), 1e-6, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    out, res = fused_norm.rms_norm_residual_fused(
        torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(w), 1e-6)
    j_out, j_res = jfn._pallas_rms_residual(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), 1e-6, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(j_res), **TOL)


# ------------------------------------------------------------------ K2
def _rope_threads(plan, B, S, H, KVH, D, qs, ks):
    """The kernel's map of thread i -> (source offsets of x1 and x2 in the
    q or k storage, destination offsets in oq or ok, q-or-k), decomposed
    as rope_kernel does (the chunk fastest, then the head, then the
    token).  qs, ks: (stride over B, stride over S) as the wrapper passes
    them."""
    i = np.arange(plan.items, dtype=np.int64)
    heads = H + KVH
    rest, c = i // plan.chunks, i % plan.chunks
    tok, head = rest // heads, rest % heads
    b, s = tok // S, tok % S
    half, j = D // 2, c * plan.pairs
    isq = head < H
    hk = np.where(isq, head, head - H)
    sb = np.where(isq, qs[0], ks[0])
    ss = np.where(isq, qs[1], ks[1])
    src = b * sb + s * ss + hk * D + j
    dst = (tok * np.where(isq, H, KVH) + hk) * D + j
    e = np.arange(plan.pairs)
    return (src[:, None] + e, src[:, None] + half + e,
            dst[:, None] + e, dst[:, None] + half + e, isq)


@settings(max_examples=150, deadline=None, database=None)
@given(B=st.integers(1, 3), S=st.integers(1, 6), H=st.integers(1, 6),
       KVH=st.integers(1, 4), half=st.integers(1, 40), bf16=st.booleans(),
       packed=st.booleans(), aligned=st.booleans())
def test_rope_threads_cover_every_pair_once(B, S, H, KVH, half, bf16,
                                            packed, aligned):
    """Every (token, head, pair) of q and k is rotated by exactly one
    thread, reading the element of the (possibly strided) input it
    rotates: q and k as the columns of a packed [B, S, (H + 2 KVH) D]
    qkv buffer, or contiguous; D % 16 != 0 included (the scalar body)."""
    D = 2 * half
    dtype = BF if bf16 else torch.float32
    es = 2 if bf16 else 4
    plan = fused_ops.rope_plan(B, S, H, KVH, D, dtype, aligned)
    assert plan.vec == (aligned and half % (16 // es) == 0)
    assert plan.pairs * plan.chunks == half
    assert plan.items == B * S * (H + KVH) * plan.chunks
    assert plan.blocks == -(-plan.items // fused_ops.ROPE_THREADS)
    if packed:
        buf = np.arange(B * S * (H + 2 * KVH) * D).reshape(
            B, S, (H + 2 * KVH) * D)
        q = buf[:, :, :H * D].reshape(B, S, H, D)
        k = buf[:, :, H * D:(H + KVH) * D].reshape(B, S, KVH, D)
        qbuf = kbuf = buf.ravel()
        st_ = (S * (H + 2 * KVH) * D, (H + 2 * KVH) * D)
        qs = ks = tuple(x if n > 1 else 0 for x, n in zip(st_, (B, S)))
        qoff, koff = 0, H * D
    else:
        q = np.arange(B * S * H * D).reshape(B, S, H, D)
        k = -1 - np.arange(B * S * KVH * D).reshape(B, S, KVH, D)
        qbuf, kbuf = q.ravel(), k.ravel()
        qs = tuple(x if n > 1 else 0 for x, n in zip((S * H * D, H * D),
                                                      (B, S)))
        ks = tuple(x if n > 1 else 0 for x, n in zip((S * KVH * D, KVH * D),
                                                      (B, S)))
        qoff = koff = 0
    x1, x2, d1, d2, isq = _rope_threads(plan, B, S, H, KVH, D, qs, ks)
    for which, x, buf, off in ((isq, q, qbuf, qoff),
                               (~isq, k, kbuf, koff)):
        hits = np.zeros(x.size, np.int64)
        np.add.at(hits, d1[which].ravel(), 1)
        np.add.at(hits, d2[which].ravel(), 1)
        assert (hits == 1).all()
        # what each thread reads is the element its output position rotates
        flat = x.reshape(-1, D)
        want1 = flat.ravel()[d1[which]]
        want2 = flat.ravel()[d2[which]]
        np.testing.assert_array_equal(buf[off + x1[which]], want1)
        np.testing.assert_array_equal(buf[off + x2[which]], want2)


def test_rope_plan_choices():
    """Decode's 8 tokens x 64 heads (32 / 32) of D 128 in bf16: 8-pair
    chunks, 4096 threads in 32 blocks; D 72 (36 pairs) or a misaligned
    pointer: a thread a pair."""
    p = fused_ops.rope_plan(8, 1, 32, 32, 128, BF, True)
    assert (p.vec, p.pairs, p.chunks, p.items, p.blocks) == (
        True, 8, 8, 4096, 32)
    assert fused_ops.rope_plan(8, 1, 32, 32, 128, torch.float32,
                               True).pairs == 4
    assert not fused_ops.rope_plan(1, 4, 4, 2, 72, BF, True).vec
    assert not fused_ops.rope_plan(1, 4, 4, 2, 128, BF, False).vec
    with pytest.raises(ValueError):
        fused_ops.rope_plan(1, 4, 4, 2, 72, BF, True, vec=True)


def _tables(smax, D):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float64) / D))
    fr = np.outer(np.arange(smax, dtype=np.float64), inv)
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


@pytest.mark.parametrize("off", [0, 5, 57, 60, 99, -3, -70])
@pytest.mark.parametrize("S", [1, 4])
def test_rope_device_offset_matches_jax(off, S):
    """rope_fused / apply_rotary_pos_emb with a 0-d offset tensor against
    the reference's apply_rotary_pos_emb(position_offset=Tensor): rows
    clamp(off, 0, Smax - S) + s of the whole table (64 rows; 60 with S 4
    sits at the edge, 99 is moved by the clamp; a negative offset counts
    from the end first, as JAX indexes: -3 is 61, -70 clamps to 0)."""
    rng = np.random.default_rng(off + 100 * S)
    B, H, KVH, D, smax = 2, 4, 2, 16, 64
    q, k = _np(rng, B, S, H, D), _np(rng, B, S, KVH, D)
    cos, sin = _tables(smax, D)
    jq, jk = jax_rope_llama(P.to_tensor(q), P.to_tensor(k),
                            P.to_tensor(cos), P.to_tensor(sin),
                            position_offset=P.to_tensor(np.int32(off)))
    t = [torch.as_tensor(a) for a in (q, k, cos, sin)]
    for dt in (torch.int32, torch.int64):
        o = torch.tensor(off, dtype=dt)
        for oq, ok in (fused_ops.rope_fused(*t, position_offset=o),
                       apply_rotary_pos_emb(*t, position_offset=o)):
            np.testing.assert_allclose(oq.numpy(), np.asarray(jq._value),
                                       **TOL)
            np.testing.assert_allclose(ok.numpy(), np.asarray(jk._value),
                                       **TOL)


@pytest.mark.parametrize("off", [None, 3, 70])
def test_rope_backward_is_the_rotation_by_minus_sin_bit_for_bit(off):
    """rope_bwd_fused on the CPU gives _rope_ref(g, cos, -sin) exactly,
    over the window the offset picks (70 clamps to Smax - S), and so does
    the autograd backward of rope_fused."""
    rng = np.random.default_rng(7)
    B, S, H, KVH, D, smax = 2, 5, 3, 1, 24, 64
    gq = torch.as_tensor(_np(rng, B, S, H, D))
    gk = torch.as_tensor(_np(rng, B, S, KVH, D))
    cos, sin = (torch.as_tensor(a) for a in _tables(smax, D))
    if off is None:
        cos, sin = cos[10:10 + S], sin[10:10 + S]
        o, start = None, 0
    else:
        o, start = torch.tensor(off), min(off, smax - S)
    c, s = cos[start:start + S], sin[start:start + S]
    ref = fused_ops._rope_ref(gq, gk, c, -s)
    got = fused_ops.rope_bwd_fused(gq, gk, cos, sin, o)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    q = torch.as_tensor(_np(rng, B, S, H, D)).requires_grad_()
    k = torch.as_tensor(_np(rng, B, S, KVH, D)).requires_grad_()
    oq, ok = fused_ops.rope_fused(q, k, cos, sin, o)
    torch.autograd.backward((oq, ok), (gq, gk))
    assert torch.equal(q.grad, ref[0]) and torch.equal(k.grad, ref[1])


def test_rope_refuses_a_table_shorter_than_the_window():
    q = torch.zeros(1, 8, 2, 16)
    cos = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_ops.rope_fused(q, q, cos, cos, torch.tensor(0))
