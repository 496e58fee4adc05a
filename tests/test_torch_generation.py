"""The port's Llama forward, generate and greedy_decode (paddle_tpu_torch)
against the JAX package's, on the CPU in float32.

Both models carry the same weights (the JAX model's state_dict, moved by
``load_numpy_state_dict``); prompts come from a numpy seed.  The port runs
every kernel's plain version here: B1 (flash attention) for the uncached
and growing-cache forwards and the static prefill, B2 (decode attention)
and B3 (ring write) for the static decode step, K1-K3 for the trunk.

Tolerances: logits within 1e-5 of the largest |logit| (+ 1e-5).  Both
sides are float32, but XLA and PyTorch sum the projections and the
attention in different orders; the error follows the size of the summed
terms, not of the result, so a logit near 0 among logits up to ~30 moves
by ~1.5e-5 (3e-4 of itself).  Tokens are compared exactly:
greedy argmaxes, and sampled tokens, which both sides draw with threefry
under the same keys.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.generation import greedy_decode as jax_greedy
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.framework.random import Generator
from paddle_tpu_torch.models.generation import generate, greedy_decode
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import load_numpy_state_dict

torch.set_num_threads(2)

KINDS = {"mha": {}, "gqa": dict(num_key_value_heads=2),
         "tied": dict(tie_word_embeddings=True)}


def _pair(seed=0, **kw):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**kw))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = PortConfig(**dataclasses.asdict(jm.config))
    return jm, load_numpy_state_dict(PortLlama(cfg, device="cpu"), sd)


@pytest.fixture(scope="module")
def models():
    return {kind: _pair(seed=i, **kw)
            for i, (kind, kw) in enumerate(KINDS.items())}


def _close(ours, ref):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()) + 1e-5, err


def _ids(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _np(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_logits_match_jax(models, kind):
    jm, pm = models[kind]
    ids = _ids(1, 2, 11)
    ref = _np(jm(P.to_tensor(ids)))
    with torch.no_grad():
        ours = pm(torch.as_tensor(ids)).numpy()
    assert ours.shape == (2, 11, 512)
    _close(ours, ref)


def _jax_caches(jm, B, L, static):
    import jax.numpy as jnp
    from paddle_tpu.tensor.tensor import Tensor

    cfg = jm.config
    shape = (B, L if static else 0, cfg.num_key_value_heads, cfg.head_dim)
    mk = lambda: Tensor(jnp.zeros(shape, jnp.float32))  # noqa: E731
    if static:
        return [(mk(), mk(), Tensor(jnp.zeros((), jnp.int32)))
                for _ in range(cfg.num_hidden_layers)]
    return [(mk(), mk()) for _ in range(cfg.num_hidden_layers)]


def _port_caches(pm, B, L, static):
    cfg = pm.config
    shape = (B, L if static else 0, cfg.num_key_value_heads, cfg.head_dim)
    if static:
        return [(torch.zeros(shape), torch.zeros(shape),
                 torch.zeros((), dtype=torch.int32))
                for _ in range(cfg.num_hidden_layers)]
    return [(torch.zeros(shape), torch.zeros(shape))
            for _ in range(cfg.num_hidden_layers)]


@pytest.mark.parametrize("kind,static", [("mha", False), ("mha", True),
                                         ("gqa", True)])
def test_cache_modes_match_jax_step_by_step(models, kind, static):
    """A 6-token prefill, then three single-token steps, then a 2-token
    chunk, through each cache mode: the logits of every call, and the
    ring's rows, equal JAX's."""
    jm, pm = models[kind]
    ids = _ids(2, 2, 11)
    jc, pc = _jax_caches(jm, 2, 16, static), _port_caches(pm, 2, 16, static)
    with torch.no_grad():
        for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 11)):
            jl, jc = jm(P.to_tensor(ids[:, lo:hi]), caches=jc)
            pl, pc = pm(torch.as_tensor(ids[:, lo:hi]), caches=pc)
            _close(pl.numpy(), _np(jl))
    for (jk, jv, *jp), (pk, pv, *pp) in zip(jc, pc):
        _close(pk.numpy(), _np(jk))
        _close(pv.numpy(), _np(jv))
        if static:
            assert int(pp[0]) == int(_np(jp[0])) == 11


# the JAX growing-cache forward compiles its ops once per length (slow on
# the CPU): greedy growing-cache tokens are held to JAX's in the EOS test
@pytest.mark.parametrize("kind,static", [("mha", True), ("gqa", True),
                                         ("tied", True)])
def test_generate_greedy_matches_jax(models, kind, static):
    jm, pm = models[kind]
    ids = _ids(3, 2, 6)
    ref = _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=6,
                           use_static_cache=static))
    ours = generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                    use_static_cache=static)
    assert ours.dtype == torch.int32 and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_greedy_decode_matches_jax_and_generate(models):
    jm, pm = models["gqa"]
    ids = _ids(4, 2, 6)
    ref = _np(jax_greedy(jm, P.to_tensor(ids), max_new_tokens=6,
                         max_length=16))
    ours = greedy_decode(pm, torch.as_tensor(ids), max_new_tokens=6,
                         max_length=16)
    assert ours.shape == (2, 6) and ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(
        ours.numpy(), generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                               use_static_cache=True).numpy())
    assert greedy_decode(pm, torch.as_tensor(ids), 0).shape == (2, 0)


@pytest.mark.parametrize("static", [False, True], ids=["growing", "ring"])
def test_eos_and_zero_budget_match_jax(models, static):
    jm, pm = models["mha"]
    ids = _ids(5, 2, 6)
    free = generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                    use_static_cache=static).numpy()
    eos = int(free[0, 2])       # row 0 stops at its third token
    ref = _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=6,
                           eos_token_id=eos, use_static_cache=static))
    ours = generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                    eos_token_id=eos, use_static_cache=static).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours[0, 2] == eos and (ours[0, 3:] == eos).all()
    empty = generate(pm, torch.as_tensor(ids), max_new_tokens=0,
                     use_static_cache=static)
    assert empty.shape == (2, 0)
    assert _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=0,
                            use_static_cache=static)).shape == (2, 0)


@pytest.mark.parametrize("static", [False, True], ids=["growing", "ring"])
def test_sampled_generate_matches_jax(models, static):
    """do_sample with top_p: the port's Generator(7) gives the tokens JAX
    gives after P.seed(7) (one key per draw, and in the ring mode one per
    forward as well, as the reference's to_static forward takes)."""
    jm, pm = models["mha"]
    ids = _ids(6, 2, 6)
    for top_p, temp in ((0.9, 1.0), (0.6, 0.7)):
        P.seed(7)
        ref = _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=6,
                               do_sample=True, top_p=top_p,
                               temperature=temp, use_static_cache=static))
        gen = Generator(7)
        ours = generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                        do_sample=True, top_p=top_p, temperature=temp,
                        use_static_cache=static, generator=gen).numpy()
        np.testing.assert_array_equal(ours, ref)
        # one key per draw, and in the ring mode one per forward (6)
        assert gen.get_state() == (7, 12 if static else 6)
    greedy = generate(pm, torch.as_tensor(ids), max_new_tokens=6).numpy()
    assert (ours != greedy).any()   # the draws really sampled


def test_sampling_needs_an_explicit_generator(models):
    _, pm = models["mha"]
    with pytest.raises(ValueError, match="generator"):
        generate(pm, torch.as_tensor(_ids(7, 1, 3)), max_new_tokens=2,
                 do_sample=True)


@pytest.mark.parametrize("fn", ["generate", "greedy_decode"])
def test_ring_guards_match_jax(models, fn):
    """The two guards of _make_static_caches raise on both sides: a ring
    shorter than prompt + budget, and one past the rope table."""
    jm, pm = models["mha"]
    ids = _ids(8, 1, 6)
    port_fn = {"generate": lambda m, x, **kw: generate(
        m, x, use_static_cache=True, **kw), "greedy_decode": greedy_decode}
    jax_fn = {"generate": lambda m, x, **kw: jax_generate(
        m, x, use_static_cache=True, **kw), "greedy_decode": jax_greedy}
    for kw, match in ((dict(max_new_tokens=5, max_length=8), "KV ring"),
                      (dict(max_new_tokens=5, max_length=300),
                       "max_position_embeddings")):
        with pytest.raises(ValueError, match=match):
            port_fn[fn](pm, torch.as_tensor(ids), **kw)
        with pytest.raises(ValueError, match=match):
            jax_fn[fn](jm, P.to_tensor(ids), **kw)
