"""Head dims past the tensor-core classes (72, 100, 264, 512, and past 512:
516, 640, 1024) and the ring write at a negative position, on the CPU.

The port's kernels B1, B8, B2, B3 and K4 take every head dim on the card:
the plain versions, which the kernels are held to there (``chip_smoke.py``
phase 2), against the Pallas functions in ``interpret=True`` (K4 against
the JAX ``blha_attention``) at D 72 (a multiple of 8, not of 16), 100 (not
of 8), 264 and 512 (past the 256-column tensor-core tiles), 516, 640 and
1024 (past 512, the wide instances that stream the head dim: Queue C8);
the plans (``_select_blocks``, ``autotune.head_dim_class``,
``decode_plan``, ``paged_plan``) pick the instance each D runs, and every
D up to 2048 has one.  The ring write takes ``dynamic_update_slice``'s
start, a negative pos counted from the end first (Queue C7), and B2 gives
zeros where no key is visible, as the Pallas kernel; rope's ring mode (K2
with B3 folded in) gives the ring the bits of ``rope_fused`` then
``kv_ring_write``.  Then a 2-layer Llama at head_dim 72 (hidden 576, 8
heads), 100 (800, 8), 264 (1056, 4) and 640 (1280, 2) against the JAX
package: forward logits, ``generate`` and ``greedy_decode`` tokens over
the ring, one criterion backward, and served tokens.  Inputs and weights
come from a numpy seed or the JAX model's state_dict.

Tolerances (float32): kernels rtol 1e-5 / atol 1e-5 (B8 rtol 1e-4 / atol
2e-5), as test_torch_flash_attention.py and test_torch_training_kernels.py
(one softmax over a few dozen keys, summed in another order; a 512-wide
dot product adds no more than that); logits, the loss and gradients within
1e-4 of the largest |value| (two layers of sums in another order, as
test_torch_training.py); tokens and the ring's bits exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as P
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.generation import greedy_decode as jax_greedy
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas.decode_attention import decode_attention as jdec
from paddle_tpu.ops.pallas.decode_attention import kv_ring_write as jring
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.models.generation import generate, greedy_decode
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import (
    LlamaPretrainingCriterion,
    load_numpy_state_dict,
)
from paddle_tpu_torch.ops.hopper import autotune as at
from paddle_tpu_torch.ops.hopper import decode_attention as da
from paddle_tpu_torch.ops.hopper import flash_attention as fa
from paddle_tpu_torch.ops.hopper import fused_ops as fo
from paddle_tpu_torch.ops.hopper import paged_attention as pa
from paddle_tpu_torch.ops.hopper import wide

torch.set_num_threads(2)

HEAD_DIMS = (72, 100, 264, 512)
WIDE_DIMS = (516, 640, 1024)            # past 512: the wide instances
TOL = dict(rtol=1e-5, atol=1e-5)
B8_TOL = dict(rtol=1e-4, atol=2e-5)
BF = torch.bfloat16


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------------ kernels B1/B8
@pytest.mark.parametrize("d", HEAD_DIMS + WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_b1_b8_plain_match_pallas_at_the_new_head_dims(d, causal):
    """block_fwd / block_bwd's plain versions against _pallas_fwd /
    _pallas_bwd (interpret): 16 rows over 24 keys, a GQA group of 2."""
    rng = np.random.default_rng(d + 7 * causal)
    bhk, rep, sq, sk = 2, 2, 16, 24
    q, k, v = _np(rng, bhk * rep, sq, d), _np(rng, bhk, sk, d), _np(
        rng, bhk, sk, d)
    g = _np(rng, bhk * rep, sq, d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = jfa._pallas_fwd(jq, jk, jv, causal, scale, 8, 8,
                             interpret=True, kv_rep=rep)
    po, pl = fa.block_fwd(_t(q), _t(k), _t(v), causal, scale, kv_rep=rep)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    ref = jfa._pallas_bwd(jq, jk, jv, jo, jl, jg, causal, scale, 8, 8, True,
                          kv_rep=rep)
    ours = fa.block_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jl), _t(g), causal,
                        scale, kv_rep=rep)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **B8_TOL)


# --------------------------------------------------------------- kernel B2
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos", [0, 40, 47, -3])
def test_b2_plain_matches_pallas_at_the_new_head_dims(d, pos):
    """8 / 2 heads over a 48-row ring; pos 0 (one key), inside, L - 1,
    and negative (no key: the Pallas kernel skips every tile and gives
    zeros, and so does the port)."""
    rng = np.random.default_rng(d * 10 + pos + 3)
    B, L, H, KVH = 2, 48, 8, 2
    q, kb, vb = _np(rng, B, 1, H, d), _np(rng, B, L, KVH, d), _np(
        rng, B, L, KVH, d)
    ref = jdec(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
               jnp.int32(pos), block_l=16, interpret=True)
    ours = da.decode_attention(_t(q), _t(kb), _t(vb),
                               torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if pos < 0:
        assert not ours.numpy().any()


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("pos", [40, -3])
def test_b2_plain_matches_pallas_past_512(d, pos):
    """The same past 512 columns, inside the ring and at a negative pos."""
    test_b2_plain_matches_pallas_at_the_new_head_dims(d, pos)


# --------------------------------------------------------------- kernel K4
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_k4_plain_matches_jax_blha_past_512(d):
    """JAX blha_attention (writes the step's K/V, then attends) against
    the port's plain K4 on the caches it left: 8 / 2 heads, three decode
    rows (one whose block id is -1) and a 5-token prefill chunk of
    max_q_len 8 over 16-key blocks."""
    rng = np.random.default_rng(d + 60)
    H, KV, bs, P = 8, 2, 16, 4
    dec = np.array([20, 0, 47, 3], np.int32)
    now = np.array([1, 5, 1, 1], np.int32)
    B = len(now)
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    T = int(cu[-1]) + 2
    NB = B * P + 2
    bt = rng.permutation(NB)[:B * P].reshape(B, P).astype(np.int32)
    bt[3, 0] = -1
    qkv = _np(rng, T, (H + 2 * KV) * d)
    kc, vc = _np(rng, NB, KV, bs, d), _np(rng, NB, KV, bs, d)
    enc = np.where(dec == 0, now, 0).astype(np.int32)
    out, kc2, vc2, *_ = jax_blha(
        *(jnp.asarray(a) for a in (qkv, kc, vc, enc, dec, now, cu, bt)),
        num_heads=H, kv_num_heads=KV, head_dim=d, block_size=bs,
        max_q_len=8, use_neox_style=True)
    q = torch.as_tensor(qkv[:, :H * d].reshape(T, H, d))
    ours = pa.paged_attention(q, _t(kc2), _t(vc2),
                              *(torch.as_tensor(a) for a in (dec, now, cu,
                                                             bt)), 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out).reshape(
        T, H, d), rtol=2e-5, atol=2e-5)
    assert not ours[int(cu[-1]):].any()


# ---------------------------------------------------- kernel B3 and C7
def _dus(buf, new, pos):
    return np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(buf), jnp.asarray(new), (0, jnp.int32(pos), 0, 0)))


@pytest.mark.parametrize("d", HEAD_DIMS + WIDE_DIMS)
@pytest.mark.parametrize("pos", [0, 5, 14, -1, -3, -16])
def test_b3_ring_write_matches_dynamic_update_slice(d, pos):
    """One row against the Pallas kv_ring_write (interpret) and
    dynamic_update_slice, three rows against dynamic_update_slice, in a
    ring of 16: a negative pos counts from the end first (-16 is row 0),
    then the start is clamped to [0, L - S] (14 with 3 rows: 13)."""
    rng = np.random.default_rng(d + pos + 40)
    B, L, KVH = 2, 16, 3
    kb, vb = _np(rng, B, L, KVH, d), _np(rng, B, L, KVH, d)
    for S in (1, 3):
        kn, vn = _np(rng, B, S, KVH, d), _np(rng, B, S, KVH, d)
        pk, pv = _t(kb).clone(), _t(vb).clone()
        da.kv_ring_write(pk, pv, _t(kn), _t(vn),
                         torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(pk.numpy(), _dus(kb, kn, pos))
        np.testing.assert_array_equal(pv.numpy(), _dus(vb, vn, pos))
        if S == 1:
            ref = jring(jnp.asarray(kb), jnp.asarray(kn), jnp.int32(pos),
                        interpret=True)
            np.testing.assert_array_equal(pk.numpy(), np.asarray(ref))


def test_c7_a_negative_pos_wraps_before_the_clamp():
    """The fault C7 closes: a ring of 8, pos -3 writes row 5 (and 6 for a
    second row), as dynamic_update_slice and the Pallas kernel do; the old
    clamp wrote rows 0 and 1."""
    L = 8
    for S, rows in ((1, [5]), (2, [5, 6])):
        kb, vb = torch.zeros(1, L, 1, 8), torch.zeros(1, L, 1, 8)
        new = torch.ones(1, S, 1, 8)
        da.kv_ring_write(kb, vb, new, new,
                         torch.tensor(-3, dtype=torch.int32))
        assert kb[0, :, 0, 0].nonzero().flatten().tolist() == rows
        assert int(da._ring_start(-3, L, S)) == 5
    assert int(da._ring_start(-20, L, 2)) == 0     # wraps to -12, clamped
    assert int(da._ring_start(7, L, 2)) == 6       # past L - S, clamped


def _table(smax, d):
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    fr = np.arange(smax, dtype=np.float64)[:, None] * inv[None]
    return (torch.as_tensor(np.cos(fr).astype(np.float32)),
            torch.as_tensor(np.sin(fr).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("pos", [0, 5, 16 - 4 + 2, -3, -1, -16])
def test_ring_mode_is_rope_then_ring_write_bit_for_bit(dtype, pos):
    """rope_ring_fused (K2's ring mode) against rope_fused with the same
    device pos and then kv_ring_write: the returned q and both rings equal
    bit for bit, at 4 new rows (and 1) of a 16-row ring and a 40-row
    table (pos L - S + 2 clamps the ring's start to L - S but not the
    table's row).  The rings equal dynamic_update_slice of the rotated k
    and of v (and, for one row, the Pallas kv_ring_write), the table rows
    dynamic_slice's: each offset wraps by its own length."""
    _ring_mode_check(dtype, pos, 72, np.random.default_rng(abs(pos) + 50))


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_ring_mode_past_512_is_rope_then_ring_write(dtype, d):
    """The same past 512 columns, at pos 5 and -3."""
    for pos in (5, -3):
        _ring_mode_check(dtype, pos, d, np.random.default_rng(d + pos))


def _ring_mode_check(dtype, pos, D, rng):
    B, H, KVH, L = 2, 6, 2, 16
    cos, sin = _table(40, D)
    for S in (4, 1):
        q, k, v = (_t(_np(rng, B, S, h, D)).to(dtype) for h in (H, KVH, KVH))
        kb, vb = (_t(_np(rng, B, L, KVH, D)).to(dtype) for _ in range(2))
        kb0, vb0 = kb.float().numpy(), vb.float().numpy()
        kb2, vb2 = kb.clone(), vb.clone()
        p = torch.tensor(pos, dtype=torch.int32)
        qr = fo.rope_ring_fused(q, k, v, cos, sin, kb, vb, p)
        rq, rk = fo.rope_fused(q, k, cos, sin, position_offset=p)
        da.kv_ring_write(kb2, vb2, rk, v, p)
        assert torch.equal(qr, rq)
        assert torch.equal(kb, kb2) and torch.equal(vb, vb2)
        rkf, vf = rk.float().numpy(), v.float().numpy()
        np.testing.assert_array_equal(kb.float().numpy(),
                                      _dus(kb0, rkf, pos))
        np.testing.assert_array_equal(vb.float().numpy(),
                                      _dus(vb0, vf, pos))
        if S == 1:
            ref = jring(jnp.asarray(kb0), jnp.asarray(rkf), jnp.int32(pos),
                        interpret=True)
            np.testing.assert_array_equal(kb.float().numpy(),
                                          np.asarray(ref))
        t0 = max(0, min(pos + 40 if pos < 0 else pos, 40 - S))
        ref = fo._rope_ref(q, k, cos[t0:t0 + S], sin[t0:t0 + S])[0]
        assert torch.equal(qr, ref)


# --------------------------------------------------------------- the plans
@pytest.mark.parametrize("d", HEAD_DIMS + WIDE_DIMS)
def test_plans_pick_the_instance_of_each_head_dim(d):
    """D 72: the tensor-core instances of class 128 (columns past D zero);
    D 100: the same after the wrapper pads B1/B8 to 104, while B2 and K4
    read the rows in place on their SIMT instances; 264 and 512: the SIMT
    instances of class 512 in both dtypes (B1 32 x 32 tiles, B8 16 x 16;
    B2 16-key tiles in float32; K4 16-key tiles where larger rings do not
    fit); past 512 the wide instances, class 512's tile pairs in B1/B8,
    32-key tiles, one split and a block for each slice of at most 512
    output columns in B2 and K4."""
    dp = d + (-d % 8)
    wide_d = d > 256
    if d > wide.MAX_HEAD_DIM:
        return _check_wide_plans(d)
    assert at.head_dim_class(d) == at.head_dim_class(dp) == (
        512 if wide_d else 128)
    for kind in ("fwd", "bwd"):
        bf = fa._select_blocks("f", kind, BF, 512, 512, dp)
        f32 = fa._select_blocks("f", kind, torch.float32, 512, 512, dp)
        assert bf in at.INSTANCES[(kind, at.head_dim_class(dp))]
        assert f32 == at.SIMT_TILES[kind](dp)
        if wide_d:
            assert bf == f32 == ((32, 32) if kind == "fwd" else (16, 16))
    for dtype in (BF, torch.float32):
        p = da.decode_plan(8, 512, 32, 8, d, dtype)
        assert p.tc == (dtype == BF and d == 72)
        assert p.kt == (64 if p.tc else 16 if dtype == torch.float32
                        and wide_d else 32)
        assert p.smem <= da.SMEM_PER_BLOCK
        for mq in (1, 16):
            k = pa.paged_plan(64, 8, mq, 32, 16, 8, 2, d, dtype)
            assert pa._tc(dtype, d) == (dtype == BF and d == 72)
            assert k.smem <= pa.SMEM_PER_BLOCK
            assert k.kt in ((pa.TC_KEYS,) if pa._tc(dtype, d)
                            else pa._simt_key_tiles(d))


def _check_wide_plans(d):
    """Past 512: class 512's tile pairs in B1/B8 (the wide instances take
    them), and B2/K4 plans on the wide instance: 32-key tiles, one split,
    no ring, slices of at most 512 columns covering D, within 227 KB."""
    dp = d + (-d % 8)
    assert at.head_dim_class(d) == 512
    for kind in ("fwd", "bwd"):
        pair = (32, 32) if kind == "fwd" else (16, 16)
        for dtype in (BF, torch.float32):
            assert fa._select_blocks("f", kind, dtype, 512, 512, dp) == pair
    for dtype in (BF, torch.float32):
        for G in (1, 4, 16, 32):
            p = da.decode_plan(8, 512, 2 * G, 2, d, dtype)
            R = min(G, da.ROWS)
            W = wide.slice_cols(R, d)
            assert (p.tc, p.rows, p.kt, p.splits) == (False, R, 32, 1)
            assert 8 <= W <= 512 and W % 8 == 0 and -(-d // W) * W >= d
            assert p.blocks == 8 * 2 * -(-G // da.ROWS) * -(-d // W)
            assert p.smem == wide.smem_bytes(R, W) <= da.SMEM_PER_BLOCK
        for G, mq in ((1, 1), (4, 1), (8, 16), (64, 1), (64, 16)):
            k = pa.paged_plan(64, 8, mq, 32, 16, 2 * G, 2, d, dtype)
            assert (k.kt, k.stages, k.splits) == (32, 1, 1)
            assert k.chunk >= 32 * 16 and k.smem <= pa.SMEM_PER_BLOCK
            assert k.qt * G <= max(G, pa.WIDE_ROWS)
    with pytest.raises(ValueError, match="one split"):
        da._plan(8, 512, 8, 2, d, BF, splits=2)
    with pytest.raises(ValueError, match="one split"):
        pa._plan(64, 8, 1, 32, 16, 8, 2, d, BF, splits=2)


def test_every_head_dim_up_to_2048_has_a_plan_and_computes():
    """Queue C8, closed: every even D up to 2048 (and the odd 99, 255,
    511, 513, 1023, 2047) in both dtypes has a B1/B8 tile pair, and B2 and
    K4 plans within 227 KB at the serving and generation head groups
    (past 512 on the wide instances); before, a D past 512 raised naming
    the limit.  At D 513, 1000 and 2048 the plain versions of B1, B8, B2
    and K4 compute finite outputs of their shapes."""
    for dtype in (BF, torch.float32):
        for d in list(range(2, 2049, 2)) + [99, 255, 511, 513, 1023, 2047]:
            dp = d + (-d % 8)
            for kind in ("fwd", "bwd"):
                pair = fa._select_blocks("f", kind, dtype, 256, 256, dp)
                assert pair in at.INSTANCES[(kind, at.head_dim_class(dp))] \
                    or pair == at.SIMT_TILES[kind](dp)
            for G in (1, 4, 16):
                assert da.decode_plan(4, 1024, 2 * G, 2, d,
                                      dtype).smem <= da.SMEM_PER_BLOCK
            for G, mq in ((1, 1), (4, 1), (8, 16)):
                assert pa.paged_plan(64, 8, mq, 32, 16, 2 * G, 2, d,
                                     dtype).smem <= pa.SMEM_PER_BLOCK
    rng = np.random.default_rng(9)
    for d in (513, 1000, 2048):
        q, k, v = (_t(_np(rng, 1, 8, h, d)) for h in (2, 1, 1))
        o, lse = fa.flash_attention_fused(q, k, v, True)
        grads = fa.flash_attention_bwd_fused(q, k, v, o, lse, q, True)
        kb, vb = _t(_np(rng, 1, 16, 1, d)), _t(_np(rng, 1, 16, 1, d))
        dec = da.decode_attention(q[:, :1], kb, vb,
                                  torch.tensor(9, dtype=torch.int32))
        pool = _t(_np(rng, 3, 1, 16, d))
        i32 = dict(dtype=torch.int32)
        paged = pa.paged_attention(
            q[0, :2], pool, pool, torch.tensor([4], **i32),
            torch.tensor([2], **i32), torch.tensor([0, 2], **i32),
            torch.tensor([[2, 0]], **i32), 2)
        for x, shape in ((o, (1, 8, 2, d)), (lse, (1, 2, 8)),
                         (dec, (1, 1, 2, d)), (paged, (2, 2, d)),
                         *((g, t.shape) for g, t in zip(grads, (q, k, v)))):
            assert tuple(x.shape) == tuple(shape)
            assert torch.isfinite(x).all() and x.abs().sum() > 0


# ------------------------------------------------- a Llama at these dims
# hidden / heads -> head_dim 72, 100, 264, 640 (the reference's config
# rule)
LLAMAS = {72: (576, 8), 100: (800, 8), 264: (1056, 4), 640: (1280, 2)}


@pytest.fixture(scope="module")
def llamas():
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    out = {}
    for d, (hidden, heads) in LLAMAS.items():
        set_hybrid_communicate_group(None)
        P.seed(d)
        jm = JaxLlama(JaxConfig(vocab_size=256, hidden_size=hidden,
                                intermediate_size=256, num_hidden_layers=2,
                                num_attention_heads=heads,
                                max_position_embeddings=64))
        jm.eval()
        assert jm.config.head_dim == d
        sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
        pm = load_numpy_state_dict(PortLlama(
            PortConfig(**dataclasses.asdict(jm.config)), device="cpu"), sd)
        out[d] = (jm, pm)
    return out


def _ids(seed, B, S):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _val(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


def _close(ours, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + 1e-6, err


@pytest.mark.parametrize("d", list(LLAMAS))
def test_llama_forward_and_generation_match_jax(llamas, d):
    """Forward logits, then generate over the ring and greedy_decode
    (the ring mode of rope, B2 and the static prefill) token for token;
    the growing-cache generate gives the port's ring tokens."""
    jm, pm = llamas[d]
    ids = _ids(d, 2, 9)
    with torch.no_grad():
        _close(pm(torch.as_tensor(ids)).numpy(), _val(jm(P.to_tensor(ids))))
    ref = _val(jax_generate(jm, P.to_tensor(ids), max_new_tokens=4,
                            use_static_cache=True))
    ring = generate(pm, torch.as_tensor(ids), max_new_tokens=4,
                    use_static_cache=True).numpy()
    np.testing.assert_array_equal(ring, ref)
    ref = _val(jax_greedy(jm, P.to_tensor(ids), max_new_tokens=4,
                          max_length=16))
    np.testing.assert_array_equal(
        greedy_decode(pm, torch.as_tensor(ids), max_new_tokens=4,
                      max_length=16).numpy(), ref)
    np.testing.assert_array_equal(
        generate(pm, torch.as_tensor(ids), max_new_tokens=4).numpy(), ring)


@pytest.mark.parametrize("d", list(LLAMAS))
def test_llama_train_step_matches_jax(llamas, d):
    """One criterion backward: the loss and every parameter's gradient
    against jax.grad over the reference's parameter values."""
    from paddle_tpu.autograd import tape
    from paddle_tpu.jit.api import _SwapValues

    jm, pm = llamas[d]
    ids = _ids(d + 1, 2, 12)
    jt = P.to_tensor(ids)
    names, params = zip(*jm.named_parameters())

    def f(vals):
        with _SwapValues(list(params), vals), tape.no_grad():
            return JaxCriterion()(jm(jt), jt)._value

    jloss, jg = jax.value_and_grad(f)([p._value for p in params])
    pm.zero_grad(set_to_none=True)
    t = torch.as_tensor(ids)
    loss = LlamaPretrainingCriterion()(pm(t), t)
    loss.backward()
    _close(loss.item(), np.asarray(jloss))
    for n, g in zip(names, jg):
        _close(dict(pm.named_parameters())[n].grad.numpy(), np.asarray(g))
    pm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("d", list(LLAMAS))
def test_llama_serving_matches_jax(llamas, d):
    """Two requests through the paged engines (K4 for attention): a prompt
    longer than the token budget (chunked prefill) beside a short one;
    the greedy tokens equal the reference engine's."""
    jm, pm = llamas[d]
    kw = dict(max_batch_size=2, max_seq_len=48, block_size=8,
              token_budget=16)
    prompts = [_ids(d + 2, 1, 20)[0].tolist(), [3, 17, 101, 7]]
    outs = []
    for eng in (JaxEngine(jm, **kw), PortEngine(pm, device="cpu", **kw)):
        rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
        done = eng.run()
        outs.append([list(done[r]) for r in rids])
    assert outs[0] == outs[1]
    assert all(len(t) == 5 for t in outs[1])
