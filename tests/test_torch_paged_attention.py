"""The port's paged attention against the JAX ``blha_attention`` on the CPU:
the plain version of kernel K4 against the reference's attention core, and
the port's ``blha_attention`` (output and both updated caches), on a mixed
batch (a decode row, a prefill row, a chunk continuing a prefill, an empty
row) with GQA, rope at absolute positions and block tables that are not
the identity.

Tolerances: float32; the caches hold the rotated keys and values, which
are elementwise (1e-6 abs / 1e-6 rel); the attention output sums over the
context in another order (2e-5 abs / 2e-5 rel).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu.ops.paged_attention import paged_gather_kv as jax_gather
from paddle_tpu_torch.ops.hopper.paged_attention import paged_attention
from paddle_tpu_torch.ops.paged_attention import (
    blha_attention,
    paged_gather_kv,
)

torch.set_num_threads(2)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mixed_batch(rng, H=4, KV=2, D=16, bs=4, P=6):
    """One decode row, one prefill row of 5 tokens, one chunk continuing a
    prefill (3 tokens after 6 cached), one empty row; block tables that are
    not the identity and share no block."""
    dec = np.array([9, 0, 6, 0], np.int32)
    now = np.array([1, 5, 3, 0], np.int32)
    enc = np.array([0, 5, 3, 0], np.int32)
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    T = 12                      # 9 real tokens + 3 of padding
    NB = 4 * P + 2
    perm = rng.permutation(NB)[:4 * P].reshape(4, P).astype(np.int32)
    bt = perm.copy()
    bt[3] = -1                  # the empty row owns no blocks
    qkv = _np(rng, T, (H + 2 * KV) * D)
    kc = _np(rng, NB, KV, bs, D)
    vc = _np(rng, NB, KV, bs, D)
    return dict(qkv=qkv, kc=kc, vc=vc, enc=enc, dec=dec, now=now, cu=cu,
                bt=bt, H=H, KV=KV, D=D, bs=bs)


def test_paged_attention_matches_blha_attention_core():
    """K4 against the attention output of the JAX blha_attention on a mixed
    batch with GQA: the JAX function scatters this step's K/V and attends;
    K4 is handed the caches it left and the unrotated q (rope_emb=None),
    and must give the same [T, H, D]."""
    rng = np.random.default_rng(5)
    m = _mixed_batch(rng)
    H, KV, D, T = m["H"], m["KV"], m["D"], m["qkv"].shape[0]
    mq = int(m["now"].max())
    out, kc, vc, *_ = jax_blha(
        *(jnp.asarray(m[k]) for k in ("qkv", "kc", "vc", "enc", "dec", "now",
                                      "cu", "bt")),
        num_heads=H, kv_num_heads=KV, head_dim=D, block_size=m["bs"],
        max_q_len=mq, use_neox_style=True)
    q = torch.as_tensor(m["qkv"][:, :H * D].reshape(T, H, D))
    ours = paged_attention(
        q, torch.as_tensor(np.array(kc)), torch.as_tensor(np.array(vc)),
        *(torch.as_tensor(m[k]) for k in ("dec", "now", "cu", "bt")), mq)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(out).reshape(T, H, D),
                               rtol=2e-5, atol=2e-5)
    assert not ours[int(m["cu"][-1]):].any()     # padding tokens give zeros


def _port_args(m):
    """The port's blha_attention arguments: the JAX ones, with the caches
    one block longer — the drop block, filled with a marker so a test sees
    whether anything landed in it."""
    names = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
    args = [torch.as_tensor(m[k]).clone() for k in names]
    for i in (1, 2):
        drop = torch.full_like(args[i][:1], 7.0)
        args[i] = torch.cat([args[i], drop])
    return args


def _rope_emb(D, smax):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    fr = np.outer(np.arange(smax), inv)
    return np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :].astype(
        np.float32)


@pytest.mark.parametrize("max_q_len", [5, 3])
def test_blha_attention_matches_jax(max_q_len):
    """max_q_len=3 also drops the prefill row's last two query tokens from
    the attention output (the reference's padded-query contract), while
    their K/V still land in the cache."""
    rng = np.random.default_rng(6)
    m = _mixed_batch(rng)
    rope = _rope_emb(m["D"], 64)
    kw = dict(num_heads=m["H"], kv_num_heads=m["KV"], head_dim=m["D"],
              block_size=m["bs"], max_q_len=max_q_len, use_neox_style=True)
    names = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
    j_out, j_kc, j_vc, *_ = jax_blha(*(jnp.asarray(m[k]) for k in names),
                                     rope_emb=jnp.asarray(rope), **kw)
    args = _port_args(m)
    out, kc, vc = blha_attention(*args, rope_emb=torch.as_tensor(rope), **kw)
    assert kc is args[1] and vc is args[2]              # updated in place
    # the pool (all but the drop block) is the reference's cache
    np.testing.assert_allclose(kc[:-1].numpy(), np.asarray(j_kc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vc[:-1].numpy(), np.asarray(j_vc), rtol=1e-6,
                               atol=1e-6)
    assert not np.array_equal(kc[:-1].numpy(), m["kc"])  # something was written
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=2e-5,
                               atol=2e-5)


def test_empty_step_writes_nothing():
    rng = np.random.default_rng(7)
    m = _mixed_batch(rng)
    m["now"][:] = 0
    m["cu"][:] = 0
    out, kc, vc = blha_attention(
        *_port_args(m), num_heads=m["H"], kv_num_heads=m["KV"],
        head_dim=m["D"], block_size=m["bs"], max_q_len=1)
    np.testing.assert_array_equal(kc[:-1].numpy(), m["kc"])
    np.testing.assert_array_equal(vc[:-1].numpy(), m["vc"])
    assert not out.any()


def test_dropped_writes_land_in_the_drop_block():
    """The writes the reference drops (padding tokens past cu[-1], and a
    token whose block-table entry is outside the pool) go to the drop
    block and nowhere else; every kept write lands in the pool."""
    rng = np.random.default_rng(10)
    m = _mixed_batch(rng)
    m["bt"][0, 2] = -1          # the decode row's block of position 9
    kw = dict(num_heads=m["H"], kv_num_heads=m["KV"], head_dim=m["D"],
              block_size=m["bs"], max_q_len=5, use_neox_style=True)
    names = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
    _, j_kc, j_vc, *_ = jax_blha(*(jnp.asarray(m[k]) for k in names), **kw)
    args = _port_args(m)
    _, kc, vc = blha_attention(*args, **kw)
    for ours, ref in ((kc, j_kc), (vc, j_vc)):
        np.testing.assert_array_equal(ours[:-1].numpy(), np.asarray(ref))
        assert (ours[-1] != 7.0).any()      # the drop block took the writes
    # each drop-block slot holds the marker or the (unrotated: no rope_emb)
    # key of a dropped token: the decode token 0 or a padding token 9-11
    H, KV, D = m["H"], m["KV"], m["D"]
    keys = torch.as_tensor(m["qkv"][:, H * D:(H + KV) * D]).view(-1, KV, D)
    dropped = [keys[t] for t in (0, 9, 10, 11)]
    for slot in range(m["bs"]):
        got = kc[-1][:, slot]
        assert (got == 7.0).all() or any(torch.equal(got, k)
                                         for k in dropped)


def test_helpers_match_jax():
    rng = np.random.default_rng(8)
    cache = rng.standard_normal((5, 2, 4, 8)).astype(np.float32)
    bt = np.array([[3, -1, 0], [4, 2, 7]], np.int32)
    np.testing.assert_array_equal(
        paged_gather_kv(torch.as_tensor(cache), torch.as_tensor(bt)).numpy(),
        np.asarray(jax_gather(jnp.asarray(cache), jnp.asarray(bt))))


def test_unported_surface_raises():
    """What the port's blha_attention did not take before A4b: the
    pre-caches (its first half) and the encoder/decoder masks (its second
    half, which raised NotImplementedError naming A4b until then) are
    computed: the output is the JAX function's, with the masks alone and
    with both (tests/test_torch_pre_cache.py and
    tests/test_torch_blha_masks.py hold them in full)."""
    rng = np.random.default_rng(9)
    m = _mixed_batch(rng)
    kw = dict(num_heads=m["H"], kv_num_heads=m["KV"], head_dim=m["D"],
              block_size=m["bs"], max_q_len=5)
    B, H, KV, D = len(m["now"]), m["H"], m["KV"], m["D"]
    pre = rng.standard_normal((B, KV, 2, D)).astype(np.float32)
    mask = rng.uniform(-2, 1, (B, 1, 5, 26)).astype(np.float32)
    tgt = rng.uniform(-2, 1, (B, H, 1, 24)).astype(np.float32)
    names = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
    for extra in (dict(pre_key_cache=pre, pre_value_cache=pre),
                  dict(mask=mask[..., :24]), dict(tgt_mask=tgt),
                  dict(pre_key_cache=pre, pre_value_cache=pre, mask=mask,
                       tgt_mask=tgt)):
        out, _, _ = blha_attention(
            *_port_args(m), **{k: torch.as_tensor(v)
                               for k, v in extra.items()}, **kw)
        j_out = jax_blha(*(jnp.asarray(m[k]) for k in names),
                         **{k: jnp.asarray(v) for k, v in extra.items()},
                         **kw)[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=2e-5, atol=2e-5)
