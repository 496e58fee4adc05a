"""The port's ServingEngine (paddle_tpu_torch) against the JAX ServingEngine.

Both engines are built from the same weights (the JAX model's state_dict
carried over by ``load_numpy_state_dict``) and fed the same request
schedule on the CPU, in float32.  The port runs every kernel's plain
PyTorch version here.  Asserted: identical greedy tokens per request,
allclose logprobs, equal scheduling counters, at megastep_k 1 and 8, with
staggered admissions (the mixed-phase loop arms), a prompt longer than the
token budget (chunked prefill), a repeated prompt (prefix hit) and an EOS
retirement.  Then the contracts the JAX tests hold the JAX engine to, held
against the port alone.

Tolerances: logprobs rtol 1e-4 / atol 1e-5.  Both sides are float32 on the
CPU, but XLA and PyTorch sum the projections, attention and softmax in
different orders, and the error grows through the layers to ~1e-6
relative in the logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference.serving import _sample_tokens as jax_sample
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.inference.serving import _sample_tokens as port_sample
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import load_numpy_state_dict

torch.set_num_threads(2)

ENGINE = dict(max_batch_size=3, max_seq_len=96, block_size=8,
              token_budget=16)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=13)
COUNTERS = ("megasteps", "megasteps_mixed", "prefill_chunks",
            "prefill_tokens_computed", "prefix_hit_blocks")


def _port_from(jax_model):
    sd = {k: np.asarray(v._value) for k, v in jax_model.state_dict().items()}
    cfg = PortConfig(**dataclasses.asdict(jax_model.config))
    return load_numpy_state_dict(PortLlama(cfg, device="cpu"), sd)


@pytest.fixture(scope="module")
def mha(serving_model):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    return serving_model, _port_from(serving_model)


@pytest.fixture(scope="module")
def gqa():
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(5)
    m = JaxLlama(jax_llama_tiny(num_key_value_heads=2))
    m.eval()
    return m, _port_from(m)


# wave 1: staggered arrivals (engine steps); B is longer than the token
# budget; wave 2 (after wave 1 retired): B's prompt again -> prefix hit
WAVE1 = [
    (0, [3, 17, 101, 7, 250], 10, dict(logprobs=True)),
    (1, [40 + i for i in range(20)], 6, dict(logprobs=True)),
    (2, [7, 9, 11], 8, {}),
]
WAVE2 = [
    (0, [40 + i for i in range(20)], 5, dict(logprobs=True)),
    (0, [90, 91, 92, 93, 94, 95, 96, 97, 98], 6, {}),
]


def _drive(eng, waves, eos=None):
    """Admit each wave with its staggered arrivals, run it to the end,
    then the next; -> ([tokens per request], [logprobs per request])."""
    toks, lps = [], []
    for wave in waves:
        rids, nxt, steps = [], 0, 0
        while True:
            while nxt < len(wave) and wave[nxt][0] <= steps:
                _, prompt, n, sp = wave[nxt]
                rids.append(eng.add_request(
                    prompt, max_new_tokens=n, sampling=sp or None,
                    eos_token_id=(eos or {}).get(len(toks) + nxt)))
                nxt += 1
            if eng.num_active == 0 and not eng.state_summary()["queue_depth"]:
                if nxt >= len(wave):
                    break
                steps = wave[nxt][0]
                continue
            eng.step()
            steps += 1
        done = eng.pop_finished()
        got = eng.pop_token_logprobs()
        toks += [done[r] for r in rids]
        lps += [got.get(r, []) for r in rids]
    return toks, lps


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_engine_parity_with_jax(request, which, k):
    jm, pm = request.getfixturevalue(which)
    # EOS retirement: request 2 stops at the third token the JAX engine
    # emits for it without an EOS
    free, _ = _drive(JaxEngine(jm, megastep_k=k, **ENGINE), [WAVE1])
    eos = {2: free[2][2]}
    jeng = JaxEngine(jm, megastep_k=k, **ENGINE)
    peng = PortEngine(pm, megastep_k=k, device="cpu", **ENGINE)
    jt, jl = _drive(jeng, [WAVE1, WAVE2], eos)
    pt, pl = _drive(peng, [WAVE1, WAVE2], eos)
    assert pt == jt
    assert len(pt[2]) == 3 and pt[2][-1] == eos[2]
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert _counters(peng) == _counters(jeng)
    assert peng.prefix_hit_blocks > 0
    if k > 1:
        assert peng.megasteps_mixed > 0 and peng.megasteps > 0


def test_sample_tokens_matches_jax():
    """Identical logits: every row gives JAX's token, greedy and sampled
    (the port draws with JAX's threefry under the same
    ``fold_in(key(seed), sample_pos)`` keys); logprobs and the post-filter
    distributions agree for temperature, top-k and top-p rows.  Tolerance
    1e-6: both take float32 softmaxes of the same numbers."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B, V = 6, 97
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.3, 0.9, 0.0, 1.0], np.float32)
    top_ks = np.array([0, 0, 10, 0, 5, 20], np.int32)
    # nucleus thresholds halfway between two cumulative masses, so the
    # two frameworks' cumsum orders cannot land on opposite sides
    top_ps = np.ones(B, np.float32)
    for r, i in ((3, 5), (4, 2), (5, 12)):
        z = logits[r].astype(np.float64) / max(temps[r], 1e-6)
        c = np.cumsum(np.sort(np.exp(z - z.max()) / np.exp(z - z.max()).sum())[::-1])
        top_ps[r] = (c[i] + c[i + 1]) / 2
    seeds = np.arange(B, dtype=np.int32)
    spos = np.arange(B, dtype=np.int32) * 3
    jn, jl, jp = jax_sample(*(jnp.asarray(a) for a in (
        logits, temps, top_ks, top_ps, seeds, spos)), return_probs=True)
    pn, plp, pp = port_sample(*(torch.as_tensor(a) for a in (
        logits, temps, top_ks, top_ps, seeds, spos)), return_probs=True)
    greedy = temps <= 0
    np.testing.assert_array_equal(pn.numpy()[greedy], np.asarray(jn)[greedy])
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    # the same draws without the probabilities (the JAX side's lax.cond
    # path), and over other keys
    for k in range(3):
        jn2, _, _ = jax_sample(*(jnp.asarray(a) for a in (
            logits, temps, top_ks, top_ps, seeds + 100 * k, spos + k)))
        pn2, _, _ = port_sample(*(torch.as_tensor(a) for a in (
            logits, temps, top_ks, top_ps, seeds + 100 * k, spos + k)))
        np.testing.assert_array_equal(pn2.numpy(), np.asarray(jn2))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    # logprob of the drawn token, read off the same raw-logit log-softmax
    ls = torch.log_softmax(torch.as_tensor(logits), -1).numpy()
    np.testing.assert_allclose(plp.numpy(), ls[np.arange(B), pn.numpy()],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jl)[greedy], plp.numpy()[greedy],
                               rtol=1e-6, atol=1e-6)
    # every drawn token lies inside its row's filtered support
    assert (pp.numpy()[np.arange(B), pn.numpy()] > 0).all()


def _run(pm, prompt, n, k, sampling=None, **kw):
    eng = PortEngine(pm, megastep_k=k, device="cpu", **{**ENGINE, **kw})
    rid = eng.add_request(prompt, max_new_tokens=n, sampling=sampling)
    return eng.run()[rid]


@pytest.mark.parametrize("k", [1, 8])
def test_sampled_engine_parity_with_jax(mha, k):
    """Seeded sampled requests beside greedy ones: the port engine emits
    the JAX engine's tokens (one threefry stream per request, keyed by
    its seed and sample index)."""
    jm, pm = mha
    wave = [(0, [3, 17, 101, 7, 250], 10, SAMPLED),
            (1, [40 + i for i in range(20)], 6, {**SAMPLED, "seed": 99,
                                                 "top_k": 0}),
            (2, [7, 9, 11], 8, {}),
            (3, [5, 6], 7, dict(temperature=1.1, seed=4, top_p=0.9))]
    jt, _ = _drive(JaxEngine(jm, megastep_k=k, **ENGINE), [wave])
    pt, _ = _drive(PortEngine(pm, megastep_k=k, device="cpu", **ENGINE),
                   [wave])
    assert pt == jt
    greedy, _ = _drive(JaxEngine(jm, megastep_k=k, **ENGINE),
                       [[(0, wave[0][1], 10, {})]])
    assert pt[0] != greedy[0]       # the sampled row really sampled


@pytest.mark.parametrize("sampling", [None, SAMPLED])
def test_k1_and_k8_token_identical(mha, sampling):
    _, pm = mha
    prompt = [3, 17, 101, 7]
    assert _run(pm, prompt, 10, 1, sampling) == _run(pm, prompt, 10, 8,
                                                     sampling)


def test_prefix_cache_on_and_off_identical(mha):
    _, pm = mha
    shared = list(range(30, 46))              # 2 full blocks
    outs = {}
    for cache in (False, "auto"):
        eng = PortEngine(pm, prefix_cache=cache, megastep_k=8,
                         device="cpu", **ENGINE)
        r0 = eng.add_request(shared + [7, 9], max_new_tokens=8)
        first = eng.run()[r0]
        r1 = eng.add_request(shared + [5], max_new_tokens=8)
        outs[cache] = (first, eng.run()[r1])
        if cache == "auto":
            assert eng.prefix_hit_blocks > 0
    assert outs[False] == outs["auto"]


def test_seeded_stream_replays_across_rebuild(mha):
    _, pm = mha
    first = _run(pm, [42, 5, 7], 8, 8, SAMPLED)
    assert _run(pm, [42, 5, 7], 8, 8, SAMPLED) == first
    assert _run(pm, [42, 5, 7], 8, 8, {**SAMPLED, "seed": 14}) != first


def test_unported_options_raise(mha):
    """The engine's typed refusals: ``pull_blocks`` (ported since the
    binary data plane, ``blockwire.py``) raises the reference's
    ``WireError`` where no listener answers, the transport fault callers
    degrade on; ``cache_quant`` past "none" and "int8" is refused as the
    reference refuses it."""
    from paddle_tpu_torch.inference.blockwire import WireError

    _, pm = mha
    eng = PortEngine(pm, device="cpu", **ENGINE)
    with pytest.raises(WireError):
        eng.pull_blocks("127.0.0.1:1", [], timeout=5.0)
    with pytest.raises(ValueError, match="cache_quant"):
        PortEngine(pm, cache_quant="fp8", device="cpu", **ENGINE)


def test_preempt_resume_across_megastep_boundary(mha):
    """Evict at a megastep boundary, re-queue prompt + generated: the
    stream equals the uninterrupted one, which equals the JAX engine's."""
    jm, pm = mha
    prompt = [3, 17, 101]
    full = _run(pm, prompt, 12, 8)
    eng = PortEngine(pm, megastep_k=4, device="cpu", **ENGINE)
    rid = eng.add_request(prompt, max_new_tokens=12)
    eng.step()       # prefill + first token
    eng.step()       # one K=4 megastep
    req = eng.evict(rid)
    assert 0 < len(req.generated) < 12
    rid2 = eng.add_request(prompt + req.generated,
                           max_new_tokens=12 - len(req.generated))
    assert req.generated + eng.run()[rid2] == full
    jeng = JaxEngine(jm, megastep_k=8, **ENGINE)
    jrid = jeng.add_request(prompt, max_new_tokens=12)
    assert jeng.run()[jrid] == full


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("engine_cls", ["jax", "port"])
def test_deadline_freezes_the_row_inside_the_loop(mha, engine_cls):
    """A deadline budget of 3 iterations stops a K=4 loop one iteration
    short: the row emits exactly 3 more tokens and is released at the
    boundary, on both engines, with the same tokens."""
    jm, pm = mha
    clock = _Clock()
    kw = dict(megastep_k=4, deadline_token_seconds=1.0, clock=clock,
              **ENGINE)
    eng = (JaxEngine(jm, **kw) if engine_cls == "jax"
           else PortEngine(pm, device="cpu", **kw))
    rid = eng.add_request([3, 17, 101], max_new_tokens=30, deadline_s=100.0)
    eng.step()              # prefill + first token at t=0
    clock.t = 97.0          # 3 iteration budgets remain
    eng.step()              # K=4 loop with budget 3
    req = eng._active[rid]
    assert len(req.generated) == 4 and req.slot == -1
    assert req.generated == _run(pm, [3, 17, 101], 4, 8)


def test_load_weights_swaps_and_invalidates_the_prefix_cache(mha, gqa):
    _, pm = mha
    other = PortLlama(PortConfig(**dataclasses.asdict(pm.config)),
                      device="cpu", seed=3)
    prompt = list(range(30, 50))
    eng = PortEngine(pm, device="cpu", **ENGINE)
    eng.add_request(prompt, max_new_tokens=4)
    eng.run()
    assert eng.cached_block_hashes()
    with pytest.raises(ValueError, match="geometry"):
        eng.load_weights(gqa[1])           # refused before any change
    assert eng.cached_block_hashes()
    assert eng.load_weights(other, version="v1") == "v1"
    assert not eng.cached_block_hashes()
    rid = eng.add_request(prompt, max_new_tokens=6)
    assert eng.run()[rid] == _run(other, prompt, 6, 8)
