"""Plain versions of the port's training kernels against the JAX package, on
the CPU: B8 (flash-attention backward), B6b (SwiGLU backward), B9 (fused
AdamW), the rope backward (K2 with -sin), both RMSNorm backwards and the
cross-entropy.

The JAX side runs its Pallas kernels as the JAX tests do on the CPU
(``interpret=True``), through ``jax.vjp`` of its ``custom_vjp`` functions
where the port's counterpart is an autograd Function; the port's wrappers
take their plain PyTorch versions for CPU tensors.  Inputs come from a
numpy seed and reach both packages as numpy.

Tolerances: float32 throughout except B9's parameter.  Elementwise kernels
and one-row reductions (B6b, rope, norms, cross-entropy): 1e-5 abs / 1e-5
rel.  B8: 2e-5 abs / 1e-4 rel, since dK and dV are sums over every query
row in different orders.  B9: master, m and v 1e-6 rel / 1e-7 abs after
three steps (the same float32 expression, one rounding apart per step);
the bfloat16 parameter is each side's rounding of those masters, so it may
differ by one bf16 ulp (2^-7 relative) where a master lies near a rounding
midpoint.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_adamw as jfad
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu.ops.pallas import fused_ops as jfo
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as fa
from paddle_tpu_torch.ops.hopper import fused_adamw as fad
from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B8_TOL = dict(rtol=1e-4, atol=2e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


B8_CASES = [(16, 16, 1, False), (16, 16, 1, True), (8, 24, 1, True),
            (16, 32, 2, True), (16, 32, 2, False), (24, 16, 1, True)]


@pytest.mark.parametrize("sq,sk,rep,causal", B8_CASES)
def test_b8_plain_matches_pallas_interpret(sq, sk, rep, causal):
    """block_bwd's plain version against _pallas_bwd (interpret), both from
    the forward's out and lse: causal and not, Sq < Sk, Sq > Sk (the first
    rows see no key: zero gradients), GQA rep 2."""
    rng = np.random.default_rng(sq * 100 + sk + rep + 7 * causal)
    bhk, d = 2, 32
    q, k, v = _np(rng, bhk * rep, sq, d), _np(rng, bhk, sk, d), _np(
        rng, bhk, sk, d)
    g = _np(rng, bhk * rep, sq, d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = jfa._pallas_fwd(jq, jk, jv, causal, scale, 8, 8, True,
                             kv_rep=rep)
    ref = jfa._pallas_bwd(jq, jk, jv, jo, jl, jg, causal, scale, 8, 8, True,
                          kv_rep=rep)
    ours = fa.block_bwd(_t(q), _t(k), _t(v), _t(np.asarray(jo)),
                        _t(np.asarray(jl)), _t(g), causal, scale, kv_rep=rep)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **B8_TOL)
    if causal and sq > sk:
        assert not ours[0].numpy()[:, :sq - sk].any()


# the tile table's head-dim classes and a GQA group of 4 at D 128 (see
# tests/test_torch_flash_attention.py's TILE_EDGE_CASES)
B8_TILE_CASES = [(d, c, 1, 16, 24) for d in (64, 128, 256)
                 for c in (False, True)] + [(128, True, 4, 16, 16),
                                            (128, True, 1, 24, 16)]


@pytest.mark.parametrize("d,causal,rep,sq,sk", B8_TILE_CASES)
def test_b8_plain_matches_pallas_at_the_tile_table_head_dims(d, causal, rep,
                                                             sq, sk):
    """block_bwd's plain version against _pallas_bwd (interpret) at each
    head-dim class of ``autotune.INSTANCES``: the semantics the card's bf16
    instances are held to."""
    rng = np.random.default_rng(d + 10 * causal + rep + sq + 3)
    bhk = 2
    q, k, v = _np(rng, bhk * rep, sq, d), _np(rng, bhk, sk, d), _np(
        rng, bhk, sk, d)
    g = _np(rng, bhk * rep, sq, d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = jfa._pallas_fwd(jq, jk, jv, causal, scale, 8, 8, True,
                             kv_rep=rep)
    ref = jfa._pallas_bwd(jq, jk, jv, jo, jl, jg, causal, scale, 8, 8, True,
                          kv_rep=rep)
    ours = fa.block_bwd(_t(q), _t(k), _t(v), _t(np.asarray(jo)),
                        _t(np.asarray(jl)), _t(g), causal, scale, kv_rep=rep)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **B8_TOL)


@pytest.mark.parametrize("kvh,causal", [(4, True), (2, True), (4, False)])
def test_flash_attention_grads_match_jax_vjp(kvh, causal):
    """The autograd Function over B1/B8: out, dq, dk, dv against jax.vjp
    of _flash_core (interpret) on [B, S, H, D]."""
    rng = np.random.default_rng(kvh + 10 * causal)
    B, S, H, D = 2, 16, 4, 16
    q, k, v = _np(rng, B, S, H, D), _np(rng, B, S, kvh, D), _np(
        rng, B, S, kvh, D)
    g = _np(rng, B, S, H, D)
    rep = H // kvh

    def jfun(q, k, v):
        fold = lambda x: jnp.moveaxis(x, 2, 1).reshape(  # noqa: E731
            -1, S, D)
        o = jfa._flash_core(fold(q), fold(k), fold(v), causal,
                            1.0 / np.sqrt(D), True, rep)
        return jnp.moveaxis(o.reshape(B, H, S, D), 1, 2)

    jo, vjp = jax.vjp(jfun, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fa.flash_attention_fwd(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    for o, r in zip(grads, jgrads):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **B8_TOL)


def test_flash_attention_refuses_a_gradient_through_q_offset():
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="q_offset"):
        fa.flash_attention_fwd(x, x, x, causal=True,
                               q_offset=torch.tensor(0, dtype=torch.int32))


def test_swiglu_bwd_matches_pallas():
    rng = np.random.default_rng(3)
    a, b, g = _np(rng, 16, 96), _np(rng, 16, 96), _np(rng, 16, 96)
    ref = jfo._swiglu_bwd_pallas(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(g), True)
    ours = fused_ops.swiglu_bwd_fused(_t(a), _t(b), _t(g))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    # and through autograd: swiglu_fused's backward is B6b
    ta, tb = _t(a, True), _t(b, True)
    got = torch.autograd.grad(fused_ops.swiglu_fused(ta, tb), (ta, tb),
                              _t(g))
    _, vjp = jax.vjp(lambda x, y: jfo.swiglu_fused(x, y, True),
                     jnp.asarray(a), jnp.asarray(b))
    for o, r in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_rope_bwd_matches_jax_vjp():
    """The rope backward (K2 with -sin) against jax.vjp of rope_fused
    (interpret), GQA heads."""
    rng = np.random.default_rng(4)
    B, S, H, KVH, D = 2, 8, 4, 2, 16
    q, k = _np(rng, B, S, H, D), _np(rng, B, S, KVH, D)
    gq, gk = _np(rng, B, S, H, D), _np(rng, B, S, KVH, D)
    fr = np.outer(np.arange(S) + 3, 1.0 / (10000.0 ** (np.arange(0, D, 2)
                                                       / D)))
    cos, sin = np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y: jfo.rope_fused(x, y, jnp.asarray(cos),
                                                 jnp.asarray(sin), True),
                     jnp.asarray(q), jnp.asarray(k))
    ref = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    tq, tk = _t(q, True), _t(k, True)
    oq, ok = fused_ops.rope_fused(tq, tk, _t(cos), _t(sin))
    got = torch.autograd.grad((oq, ok), (tq, tk), (_t(gq), _t(gk)))
    direct = fused_ops.rope_bwd_fused(_t(gq), _t(gk), _t(cos), _t(sin))
    for o, d, r in zip(got, direct, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
        np.testing.assert_allclose(d.numpy(), np.asarray(r), **TOL)


def test_rms_norm_bwd_matches_jax_vjp():
    rng = np.random.default_rng(5)
    x, w, g = _np(rng, 2, 5, 64), _np(rng, 64), _np(rng, 2, 5, 64)
    _, vjp = jax.vjp(lambda a, b: jfn.rms_norm_fused(a, b, 1e-6, True),
                     jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    got = torch.autograd.grad(fused_norm.rms_norm_fused(tx, tw, 1e-6),
                              (tx, tw), _t(g))
    for o, r in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_rms_norm_residual_bwd_matches_jax_vjp():
    """Cotangents on both outputs: dsum reaches x and residual alike."""
    rng = np.random.default_rng(6)
    x, r, w = _np(rng, 6, 64), _np(rng, 6, 64), _np(rng, 64)
    g_out, g_res = _np(rng, 6, 64), _np(rng, 6, 64)
    _, vjp = jax.vjp(
        lambda a, b, c: jfn.rms_norm_residual_fused(a, b, c, 1e-6, True),
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
    ref = vjp((jnp.asarray(g_out), jnp.asarray(g_res)))
    tx, tr, tw = _t(x, True), _t(r, True), _t(w, True)
    out, res = fused_norm.rms_norm_residual_fused(tx, tr, tw, 1e-6)
    got = torch.autograd.grad((out, res), (tx, tr, tw),
                              (_t(g_out), _t(g_res)))
    for o, rr in zip(got, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(rr), **TOL)


def _bf16_torch(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def test_fused_adamw_matches_pallas_over_three_steps():
    """bf16 parameter, float32 master/m/v, bf16 gradients; the port's step
    count t on the device against the reference's b**t scalars."""
    rng = np.random.default_rng(7)
    n = 512 * 256                      # the Pallas kernel's block
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    w0 = _np(rng, n)
    jp, jw = jnp.asarray(w0.astype(ml_dtypes.bfloat16)), jnp.asarray(w0)
    jm = jv = jnp.zeros(n, jnp.float32)
    tp, tw = _bf16_torch(w0.astype(ml_dtypes.bfloat16)), torch.tensor(w0)
    tm, tv = torch.zeros(n), torch.zeros(n)
    t = torch.zeros(1)
    before = fad.fused_adamw.launches
    for step, lr in ((1, 1e-3), (2, 5e-4), (3, 1e-3)):
        g = (_np(rng, n) * 0.1).astype(ml_dtypes.bfloat16)
        jp, jw, jm, jv = jfad.fused_adamw(
            jp, jw, jm, jv, jnp.asarray(g), lr, 0.9 ** step, 0.999 ** step,
            interpret=True, **kw)
        t.add_(1)
        fad.fused_adamw(tp, tw, tm, tv, _bf16_torch(g), lr, t, **kw)
    assert fad.fused_adamw.launches == before
    for o, r in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(jp).astype(np.float32),
                               rtol=2 ** -7, atol=0)
    # a float32 parameter is its own master weight
    p = torch.tensor(w0)
    fad.fused_adamw(p, p, torch.zeros(n), torch.zeros(n),
                    torch.tensor(g.astype(np.float32)), 1e-3, torch.ones(1),
                    **kw)
    assert not torch.equal(p, torch.tensor(w0))


@pytest.mark.parametrize("skip", [None, 0.0, 1.0])
@pytest.mark.parametrize("gmul", [None, 0.3712])
def test_fused_adamw_gmul_and_skip_match_the_reference(gmul, skip):
    """B9's plain version with a clip scale and a skip flag against the
    reference's arithmetic: the clip's ``(g * scale).astype(g.dtype)`` then
    the Pallas update (interpret mode), and ``jnp.where(found_inf, old,
    new)`` over every state.  A set flag leaves parameter, master and
    moments bit for bit as they were."""
    rng = np.random.default_rng(11)
    n = 512 * 256
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    w0 = _np(rng, n)
    m0 = np.abs(_np(rng, n)) * 1e-3
    v0 = np.abs(_np(rng, n)) * 1e-5
    g = (_np(rng, n) * 0.1).astype(ml_dtypes.bfloat16)
    jg = jnp.asarray(g)
    if gmul is not None:
        jg = (jg * jnp.float32(gmul)).astype(jnp.bfloat16)
    jp0 = jnp.asarray(w0.astype(ml_dtypes.bfloat16))
    jout = jfad.fused_adamw(jp0, jnp.asarray(w0), jnp.asarray(m0),
                            jnp.asarray(v0), jg, 1e-3, 0.9 ** 2,
                            0.999 ** 2, interpret=True, **kw)
    if skip:
        jout = (jp0, jnp.asarray(w0), jnp.asarray(m0), jnp.asarray(v0))
    tp = _bf16_torch(w0.astype(ml_dtypes.bfloat16))
    tw, tm, tv = (torch.tensor(a) for a in (w0, m0, v0))
    fad.fused_adamw(tp, tw, tm, tv, _bf16_torch(g), 1e-3,
                    torch.full((1,), 2.0), **kw,
                    gmul=None if gmul is None else torch.tensor([gmul]),
                    skip=None if skip is None else torch.tensor([skip]))
    jp, jw, jm, jv = (np.asarray(a).astype(np.float32) for a in jout)
    if skip:
        for o, r in ((tp, jp), (tw, jw), (tm, jm), (tv, jv)):
            np.testing.assert_array_equal(o.float().numpy(), r)
        return
    for o, r in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2 ** -7,
                               atol=0)


def test_fused_adamw_refuses_controls_of_another_shape():
    n = 8
    args = [torch.zeros(n) for _ in range(5)]
    for bad in (dict(gmul=torch.ones(2)), dict(skip=torch.ones(1).double())):
        with pytest.raises(ValueError, match="one float32"):
            fad._check("fused_adamw", *args, torch.ones(1), **bad)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(8)
    logits = _np(rng, 12, 40) * 3
    labels = rng.integers(0, 40, 12).astype(np.int64)
    labels[[2, 7]] = -100
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           reduction=reduction)
    tl = _t(logits, True)
    ours = F.cross_entropy(tl, torch.as_tensor(labels), reduction=reduction)
    np.testing.assert_allclose(ours.detach().numpy(),
                               np.asarray(ref._value), **TOL)
    (g,) = torch.autograd.grad(ours.sum(), tl)
    _, vjp = jax.vjp(lambda x: JF.cross_entropy(
        x, jnp.asarray(labels), reduction=reduction)._value.sum(),
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(1.0)[0]), **TOL)


def test_cpu_tensors_take_plain_versions_without_launching():
    x = torch.randn(3, 32, requires_grad=True)
    counted = (fused_ops.swiglu_bwd_fused, fused_ops.rope_bwd_fused,
               fa.flash_attention_bwd_fused, fad.fused_adamw)
    before = [f.launches for f in counted]
    torch.autograd.grad(fused_ops.swiglu_fused(x, x).sum(), x)
    q = x.reshape(1, 3, 2, 16)
    oq, ok = fused_ops.rope_fused(q, q, torch.ones(3, 8), torch.zeros(3, 8))
    torch.autograd.grad((oq.sum() + ok.sum()), x)
    out = fa.flash_attention_fwd(q, q, q, causal=True)
    torch.autograd.grad(out.sum(), x)
    assert [f.launches for f in counted] == before
