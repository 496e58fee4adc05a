"""The additive masks of the port's ``blha_attention`` (``mask`` on the rows
in prefill, ``tgt_mask`` on the others) against the JAX
``blha_attention`` on the CPU, and the plain versions of K4 and K4-int8
under the masks against the attention the JAX function computes.

One step of a mixed batch (a decode row, a prefill row of 6, a chunk of 3
after 10 cached, an empty row; block size 8, 3 blocks a row, not the
identity) with rope: masks of one and of H heads, fewer and more rows than
``max_q_len`` (zero-padded or cropped), fewer and more columns than the
combined key axis, a 3-key pre-cache in front of it, a mixed call with a
prefill row under ``mask`` and rows under ``tgt_mask``, GQA 8 / 2, static
and dynamic int8 caches under both masks, ``out_shift`` with a mask, and
-inf entries.  A row whose every visible key carries -inf is an edge
where the kernels differ from the reference (ROADMAP Queue C10): the
plain versions' answer, the reference's, is pinned here.

Tolerances, float32: the attention output rtol = atol = 2e-5 (sums over
the context in another order); the float caches hold the rotated keys
(1e-6); a uint8 code may land one apart when a value sits within ~1e-7 of
a rounding boundary (at least 99.9% equal, none more than 1 apart); the
dynamic scales are one float32 division of the same absmax (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu_torch.ops.hopper.paged_attention import (
    _check_masks,
    _mask_args,
    _paged_attention_int8_ref,
    _paged_attention_ref,
    paged_attention,
    paged_attention_int8,
)
from paddle_tpu_torch.ops.paged_attention import blha_attention

torch.set_num_threads(2)

NAMES = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
SCALES = ("cache_k_quant_scales", "cache_v_quant_scales",
          "cache_k_dequant_scales", "cache_v_dequant_scales")
TOL = dict(rtol=2e-5, atol=2e-5)
BS, P, MQ = 8, 3, 6


def _rope_emb(D, smax):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    fr = np.outer(np.arange(smax), inv)
    return np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :].astype(
        np.float32)


def _batch(rng, H, KV, D, quant="none", Lp=0, enc=(0, 6, 3, 0)):
    """A decode row (13 cached), a prefill row of 6, a chunk of 3 after 10
    cached, an empty row; float caches or uint8 codes with scales; the
    pre-caches [B, KV, Lp, D] where Lp > 0.  ``enc`` picks the rows in
    prefill (the chunk's 3 puts it under ``mask``, 0 under ``tgt_mask``)."""
    now = np.array([1, 6, 3, 0], np.int32)
    dec = np.array([13, 0, 10, 0], np.int32)
    B = len(now)
    NB = B * P + 2
    bt = rng.permutation(NB)[:B * P].reshape(B, P).astype(np.int32)
    bt[3] = -1                  # the empty row owns no blocks
    T = 12                      # 10 real tokens + 2 of padding
    m = dict(qkv=rng.uniform(-1, 1, (T, (H + 2 * KV) * D)).astype(np.float32),
             enc=np.array(enc, np.int32), dec=dec, now=now, bt=bt,
             cu=np.concatenate([[0], np.cumsum(now)]).astype(np.int32))
    if Lp:
        m["pk"] = rng.uniform(-1, 1, (B, KV, Lp, D)).astype(np.float32)
        m["pv"] = rng.uniform(-1, 1, (B, KV, Lp, D)).astype(np.float32)
    if quant == "none":
        m["kc"] = rng.uniform(-1, 1, (NB, KV, BS, D)).astype(np.float32)
        m["vc"] = rng.uniform(-1, 1, (NB, KV, BS, D)).astype(np.float32)
        return m
    m["kc"] = rng.integers(0, 256, (NB, KV, BS, D)).astype(np.uint8)
    m["vc"] = rng.integers(0, 256, (NB, KV, BS, D)).astype(np.uint8)
    shape = (KV,) if quant == "static" else (B, KV)
    for kind in ("k", "v"):
        qs = rng.uniform(100, 140, shape).astype(np.float32)
        m[f"cache_{kind}_quant_scales"] = qs
        m[f"cache_{kind}_dequant_scales"] = (1 / qs).astype(np.float32)
    return m


def _mask(rng, heads, sq, lm, neg_inf=0.0):
    """An additive mask [4, heads, sq, lm]: uniform in [-2, 1], with a share
    ``neg_inf`` of its entries -inf."""
    m = rng.uniform(-2, 1, (4, heads, sq, lm)).astype(np.float32)
    if neg_inf:
        m[rng.random(m.shape) < neg_inf] = -np.inf
    return m


def _jax(m, **kw):
    """The JAX blha_attention -> numpy (out, kc, vc, kq, vq, kd, vd)."""
    extra = {n: jnp.asarray(m[n]) for n in SCALES if n in m}
    if "pk" in m:
        extra.update(pre_key_cache=jnp.asarray(m["pk"]),
                     pre_value_cache=jnp.asarray(m["pv"]))
    for n in ("mask", "tgt_mask"):
        if n in kw:
            kw[n] = jnp.asarray(kw[n])
    res = jax_blha(*(jnp.asarray(m[n]) for n in NAMES), **extra, **kw)
    return [None if r is None else np.asarray(r) for r in res]


def _port(m, **kw):
    """The port's blha_attention on copies of ``m``'s arrays, the caches one
    (drop) block longer -> numpy (out, kc, vc) and the scale tensors,
    updated in place."""
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    extra = {n: torch.as_tensor(np.array(m[n])) for n in SCALES if n in m}
    if "pk" in m:
        extra.update(pre_key_cache=torch.as_tensor(m["pk"]),
                     pre_value_cache=torch.as_tensor(m["pv"]))
    for n in ("mask", "tgt_mask"):
        if n in kw:
            kw[n] = torch.as_tensor(kw[n])
    sc = {n: t for n, t in extra.items() if n in SCALES}
    out, kc, vc = blha_attention(*args, **extra, **kw)
    assert kc is args[1] and vc is args[2]
    return out.numpy(), kc[:-1].numpy(), vc[:-1].numpy(), sc


def _codes_close(ours, ref):
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _kw(H, KV, D, quant="none", **extra):
    return dict(num_heads=H, kv_num_heads=KV, head_dim=D, block_size=BS,
                max_q_len=MQ, use_neox_style=True, cache_quant=quant,
                **extra)


# (label, H, KV, D, pre-cache length, enc, mask (heads, Sq, Lm) | None,
#  tgt_mask (heads, Sq, Lm) | None); Lf = Lp + 24
CASES = [
    ("mask of 1 head", 4, 2, 32, 0, (0, 6, 3, 0), (1, MQ, 24), None),
    ("mask of H heads", 4, 2, 32, 0, (0, 6, 3, 0), (4, MQ, 24), None),
    ("Sq < max_q_len", 4, 2, 32, 0, (0, 6, 3, 0), (4, 4, 24), None),
    ("Sq > max_q_len", 4, 2, 32, 0, (0, 6, 3, 0), (1, 9, 24), None),
    ("Lm < Lf", 4, 2, 32, 0, (0, 6, 3, 0), (4, MQ, 17), None),
    ("Lm > Lf", 4, 2, 32, 0, (0, 6, 3, 0), (1, MQ, 30), None),
    ("3-key pre-cache", 4, 2, 32, 3, (0, 6, 3, 0), (4, MQ, 27), (1, 1, 27)),
    ("mixed: prefill under mask, decode and chunk under tgt_mask", 4, 2, 32,
     0, (0, 6, 0, 0), (1, MQ, 24), (4, 1, 20)),
    ("GQA 8 / 2", 8, 2, 32, 0, (0, 6, 3, 0), (8, MQ, 24), (1, 1, 24)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_blha_attention_masks_match_jax(case):
    """One step under the masks: the output and both caches (the masks
    touch the attention only: the pools are the reference's)."""
    label, H, KV, D, Lp, enc, mk, tk = case
    rng = np.random.default_rng(sum(map(ord, label)))
    m = _batch(rng, H, KV, D, Lp=Lp, enc=enc)
    masks = {}
    if mk:
        masks["mask"] = _mask(rng, *mk)
    if tk:
        masks["tgt_mask"] = _mask(rng, *tk)
    rope = _rope_emb(D, 64)
    j = _jax(m, rope_emb=jnp.asarray(rope), **_kw(H, KV, D), **dict(masks))
    out, kc, vc, _ = _port(m, rope_emb=torch.as_tensor(rope), **_kw(H, KV, D),
                           **dict(masks))
    np.testing.assert_allclose(out, j[0], **TOL)
    assert not out[int(m["cu"][-1]):].any()     # padding tokens give zeros
    np.testing.assert_allclose(kc, j[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vc, j[2], rtol=1e-6, atol=1e-6)
    # the masks moved the output: without them it is another
    plain = _port(m, rope_emb=torch.as_tensor(rope), **_kw(H, KV, D))[0]
    assert np.abs(plain - out).max() > 1e-3


@pytest.mark.parametrize("quant", ["static", "dynamic"])
def test_int8_caches_under_both_masks_match_jax(quant):
    """Static and dynamic int8 caches under ``mask`` and ``tgt_mask``:
    output, codes and (dynamic) the refreshed scales; a 2-key pre-cache in
    front."""
    H, KV, D = 4, 2, 32
    rng = np.random.default_rng(11 + len(quant))
    m = _batch(rng, H, KV, D, quant, Lp=2, enc=(0, 6, 0, 0))
    masks = dict(mask=_mask(rng, 4, MQ, 26), tgt_mask=_mask(rng, 1, 1, 26))
    rope = _rope_emb(D, 64)
    kw = _kw(H, KV, D, quant)
    j = _jax(m, rope_emb=jnp.asarray(rope), **kw, **dict(masks))
    out, kc, vc, sc = _port(m, rope_emb=torch.as_tensor(rope), **kw,
                            **dict(masks))
    np.testing.assert_allclose(out, j[0], **TOL)
    _codes_close(kc, j[1])
    _codes_close(vc, j[2])
    for i, n in enumerate(SCALES):
        if quant == "dynamic":
            np.testing.assert_allclose(sc[n].numpy(), j[3 + i], rtol=1e-6)
        else:
            np.testing.assert_array_equal(sc[n].numpy(), m[n])


def test_out_shift_with_a_mask_matches_jax():
    """The shift/smooth epilogue reads the masked attention's float32
    value, then the int8 output quantization."""
    H, KV, D = 4, 2, 32
    rng = np.random.default_rng(21)
    m = _batch(rng, H, KV, D)
    shift = rng.uniform(-0.5, 0.5, H * D).astype(np.float32)
    smooth = rng.uniform(0.5, 1.5, H * D).astype(np.float32)
    mask = _mask(rng, 1, MQ, 24)
    for extra in (dict(out_shift=shift),
                  dict(out_shift=shift, out_smooth=smooth,
                       has_out_quant=True, out_scale=0.5)):
        j = _jax(m, **_kw(H, KV, D), mask=mask,
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                    for k, v in extra.items()})
        out = _port(m, **_kw(H, KV, D), mask=mask,
                    **{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                       else v for k, v in extra.items()})[0]
        if out.dtype == np.int8:
            diff = np.abs(out.astype(np.int32) - j[0].astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        else:
            np.testing.assert_allclose(out, j[0], **TOL)


def test_masks_with_neg_inf_entries_match_jax():
    """-inf entries (a fifth of them) on visible keys: each row keeps at
    least one finite visible key, so the softmax is the reference's."""
    H, KV, D = 4, 2, 32
    rng = np.random.default_rng(31)
    m = _batch(rng, H, KV, D)
    mask = _mask(rng, 4, MQ, 24, neg_inf=0.2)
    tgt = _mask(rng, 1, 1, 24, neg_inf=0.2)
    # key 0 stays finite on every row: every query sees it
    mask[..., 0] = 0.0
    tgt[..., 0] = 0.0
    j = _jax(m, **_kw(H, KV, D), mask=mask, tgt_mask=tgt)
    out = _port(m, **_kw(H, KV, D), mask=mask, tgt_mask=tgt)[0]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, j[0], **TOL)


def test_a_row_whose_visible_keys_are_all_neg_inf():
    """The edge of ROADMAP Queue C10: every visible key of the decode row's
    query carries -inf.  The reference's softmax then falls onto its -1e30
    keys (the invisible ones, where the mask is finite): the row gives
    their values' mean.  The plain versions transcribe the reference, so
    the port on the CPU gives the same; the kernels skip invisible keys
    (-inf), so on the card that row has no key and gives zeros
    (``chip_smoke.py``'s ``_mask_edges`` pins both sides there).  The
    other rows are unaffected."""
    H, KV, D = 4, 2, 32
    rng = np.random.default_rng(41)
    m = _batch(rng, H, KV, D)
    tgt = _mask(rng, 1, 1, 24)
    tgt[0, :, :, :14] = -np.inf         # row 0 sees keys 0 .. 13: all -inf
    j = _jax(m, **_kw(H, KV, D), tgt_mask=tgt)
    out = _port(m, **_kw(H, KV, D), tgt_mask=tgt)[0]
    np.testing.assert_allclose(out, j[0], **TOL)
    # the reference: the mean of the row's invisible keys' values (keys 14
    # .. 23 of its context: positions past its 14 tokens)
    ctx = np.concatenate([m["vc"][b] for b in m["bt"][0]], axis=1)
    want = np.repeat(ctx[:, 14:].mean(axis=1), H // KV, axis=0).reshape(-1)
    np.testing.assert_allclose(j[0][0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["k4", "k4_int8"])
def test_plain_versions_under_masks_match_jax_core(kernel):
    """The plain versions of K4 (``_paged_attention_ref``) and K4-int8
    (``_paged_attention_int8_ref``, static scales), and their wrappers on
    CPU tensors, under both masks and a 2-key pre-cache, against the
    attention the JAX blha_attention computes (no rope): each is handed
    the caches the JAX call left, the unrotated q and, for K4-int8, this
    step's k and v."""
    H, KV, D = 4, 2, 32
    quant = "none" if kernel == "k4" else "static"
    rng = np.random.default_rng(51 + len(kernel))
    m = _batch(rng, H, KV, D, quant, Lp=2, enc=(0, 6, 0, 0))
    mask, tgt = _mask(rng, 4, 9, 30), _mask(rng, 1, 1, 20)
    j = _jax(m, **_kw(H, KV, D, quant), mask=mask, tgt_mask=tgt)
    T = m["qkv"].shape[0]
    qkv = torch.as_tensor(m["qkv"])
    q = qkv[:, :H * D].reshape(T, H, D)
    ints = [torch.as_tensor(m[n]) for n in ("dec", "now", "cu", "bt")]
    kw = dict(pre_key=torch.as_tensor(m["pk"]),
              pre_value=torch.as_tensor(m["pv"]),
              mask=torch.as_tensor(mask), tgt_mask=torch.as_tensor(tgt),
              seq_lens_encoder=torch.as_tensor(m["enc"]))
    caches = [torch.as_tensor(np.array(c)) for c in j[1:3]]
    if kernel == "k4":
        outs = [f(q, *caches, *ints, MQ, **kw)
                for f in (_paged_attention_ref, paged_attention)]
    else:
        k = qkv[:, H * D:(H + KV) * D].reshape(T, KV, D)
        v = qkv[:, (H + KV) * D:].reshape(T, KV, D)
        scales = [torch.as_tensor(m[n]) for n in SCALES[2:]]
        outs = [f(q, k, v, *caches, *scales, *ints, MQ, **kw)
                for f in (_paged_attention_int8_ref, paged_attention_int8)]
    for ours in outs:
        np.testing.assert_allclose(ours.numpy(), j[0].reshape(T, H, D), **TOL)


def test_mask_checks():
    """A mask needs seq_lens_encoder; its heads are 1 or H and its rows B;
    what a launch takes (``_mask_args``): float32, contiguous, 16-byte
    aligned on q's device, seq_lens_encoder int32; an empty mask is none."""
    q = torch.zeros(5, 4, 32)
    enc = torch.zeros(3, dtype=torch.int32)
    ok = torch.zeros(3, 1, 6, 20)
    for bad in (dict(mask=ok), dict(tgt_mask=ok),
                dict(mask=ok, seq_lens_encoder=torch.zeros(2)),
                dict(mask=torch.zeros(3, 2, 6, 20), seq_lens_encoder=enc),
                dict(mask=torch.zeros(2, 1, 6, 20), seq_lens_encoder=enc),
                dict(tgt_mask=torch.zeros(3, 4, 20), seq_lens_encoder=enc)):
        args = {**dict(mask=None, tgt_mask=None, seq_lens_encoder=None),
                **bad}
        with pytest.raises(ValueError, match="mask|seq_lens_encoder"):
            _check_masks("k4", q, args["mask"], args["tgt_mask"],
                         args["seq_lens_encoder"], 3)
    assert _mask_args("k4", q, None, None, None, 3) == (0,) * 9
    assert _mask_args("k4", q, torch.zeros(3, 1, 0, 20), None, enc,
                      3) == (0,) * 9
    tgt = torch.zeros(3, 4, 1, 7)
    got = _mask_args("k4", q, ok, tgt, enc, 3)
    assert got == (ok.data_ptr(), 1, 6, 20, tgt.data_ptr(), 4, 1, 7,
                   enc.data_ptr())
    for bad in (ok.double(), ok.transpose(2, 3).contiguous().transpose(2, 3),
                torch.zeros(3 * 6 * 20 + 1)[1:].view(3, 1, 6, 20)):
        with pytest.raises(ValueError, match="mask"):
            _mask_args("k4", q, bad, None, enc, 3)
    with pytest.raises(ValueError, match="seq_lens_encoder"):
        _mask_args("k4", q, ok, None, enc.long(), 3)
    # blha_attention: a mask without seq_lens_encoder is a ValueError
    rng = np.random.default_rng(3)
    m = _batch(rng, 4, 2, 32)
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    args[3] = None
    with pytest.raises(ValueError, match="seq_lens_encoder"):
        blha_attention(*args, **_kw(4, 2, 32),
                       mask=torch.zeros(4, 1, MQ, 24))
