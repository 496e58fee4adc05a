"""Speculative decoding in the port's ServingEngine against the JAX engine.

Both engines are built from the same weights (the JAX model's state_dict
carried over by ``load_numpy_state_dict``) and fed the same requests on
the CPU in float32; the port runs every kernel's plain PyTorch version.
Asserted: the port's ``ngram_draft`` equals the reference's; at spec_k 1
and 8, greedy, seeded and near-greedy, the port's tokens, logprobs and
``spec`` counters equal the JAX engine's, and spec-on equals spec-off;
two rows batched (MHA and GQA), the captured q(x) and its redraw
property, the per-request opt-out, the two failpoints under the same
``FaultInjector`` schedule, preempt and resume, EOS inside an accepted
burst, and the verify on the graph path (the cache's CPU stand-in for a
CUDA graph, as in ``tests/test_torch_cuda_graphs.py``).

Tolerances: logprobs rtol 1e-4 / atol 1e-5 and the captured
distributions atol 1e-5, as ``tests/test_torch_serving.py`` states them
(the two frameworks sum in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference.faults import FaultInjector as JaxFaults
from paddle_tpu.inference.serving import ngram_draft as jax_ngram_draft
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.framework.random import categorical, fold_in, key
from paddle_tpu_torch.inference.faults import FaultInjector as PortFaults
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.inference.serving import ngram_draft
from paddle_tpu_torch.jit.graphs import GraphCache
from paddle_tpu_torch.ops.hopper import launch_counters
from test_torch_cuda_graphs import _stub_capture
from test_torch_serving import _port_from

torch.set_num_threads(2)

ENGINE = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              token_budget=16, megastep_k=4)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=13)
# the argmax dominates every draw, so the greedy cycles (and real
# multi-token accepts) survive sampling
NEAR_GREEDY = dict(temperature=0.001, seed=21)
# PROMPT_A drives the shared serving model into a recurring cycle (the
# drafter's accepts > 0 on it); the alphabets are disjoint
PROMPT_A = [1, 2, 3, 1, 2, 3, 1, 2]
PROMPT_B = [9, 4, 9, 4, 9, 4, 9, 4]
N_LONG = 48
SPEC = ("spec_accepted_tokens", "spec_draft_tokens", "spec_verify_forwards")


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


def _engines(pair, **kw):
    jm, pm = pair
    return (JaxEngine(jm, **{**ENGINE, **kw}),
            PortEngine(pm, device="cpu", **{**ENGINE, **kw}))


def _serve(eng, reqs):
    """Run ``reqs`` [(prompt, n, sampling, eos)] together -> ([tokens],
    [logprobs]) per request."""
    rids = [eng.add_request(p, max_new_tokens=n, sampling=s,
                            eos_token_id=eos) for p, n, s, eos in reqs]
    done = eng.run()
    lps = eng.pop_token_logprobs()
    return [done[r] for r in rids], [lps.get(r, []) for r in rids]


def _spec(eng):
    return {c: getattr(eng, c) for c in SPEC}


def _assert_same(jeng, peng, reqs):
    jt, jl = _serve(jeng, reqs)
    pt, pl = _serve(peng, reqs)
    assert pt == jt
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert _spec(peng) == _spec(jeng)
    assert peng.state_summary()["spec"] == jeng.state_summary()["spec"]
    return pt


def test_ngram_draft_equals_the_reference():
    """Seeded histories over small alphabets (so tail n-grams recur), every
    k and n-gram cap, and the reference's own edge cases."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 40))
        h = rng.integers(0, int(rng.integers(1, 6)), n).tolist()
        for k in (-1, 0, 1, 3, 8):
            for m in (1, 2, 3, 5):
                assert ngram_draft(h, k, m) == jax_ngram_draft(h, k, m)
    assert ngram_draft([5, 6, 7, 5, 6], 3) == [7, 5, 6]
    assert ngram_draft([1, 2, 9, 1, 2, 8, 1, 2], 1) == [8]
    for h, k in (([], 4), ([5], 4), ([5, 6], 4), ([5, 6, 7], 0),
                 ([5, 5, 5, 5], -1)):
        assert ngram_draft(h, k) == jax_ngram_draft(h, k) == []
    for k in range(1, 6):
        assert ngram_draft(PROMPT_A, k) == jax_ngram_draft(PROMPT_A, k)


@pytest.mark.parametrize("sampling", ["greedy", "sampled", "near_greedy"])
@pytest.mark.parametrize("spec_k", [1, 8])
def test_spec_parity_with_jax(mha, spec_k, sampling):
    """The port's tokens, logprobs and spec counters equal the JAX
    engine's; spec-on equals spec-off; greedy PROMPT_A accepts drafts."""
    sp = {"greedy": {}, "sampled": SAMPLED,
          "near_greedy": NEAR_GREEDY}[sampling]
    reqs = [(PROMPT_A, N_LONG, dict(sp, logprobs=True), None)]
    jeng, peng = _engines(mha, spec_k=spec_k)
    got = _assert_same(jeng, peng, reqs)
    off, _ = _serve(PortEngine(mha[1], device="cpu", **ENGINE), reqs)
    assert got == off
    assert peng.spec_verify_forwards > 0
    if sampling != "sampled":
        assert peng.spec_accepted_tokens > 0
        assert peng.spec_verify_forwards < N_LONG - 1


@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_two_rows_batched(request, which):
    """Both slots speculate in one packed verify; each row's stream is the
    JAX engine's and its own spec-off stream."""
    pair = request.getfixturevalue(which)
    reqs = [(PROMPT_A, N_LONG, None, None), (PROMPT_B, N_LONG, None, None)]
    got = _assert_same(*_engines(pair, spec_k=8), reqs)
    off, _ = _serve(PortEngine(pair[1], device="cpu", **ENGINE), reqs)
    assert got == off


def test_captured_sample_probs_and_the_redraw(mha):
    """With ``capture_sample_probs`` every committed token, bursts
    included, exposes the q(x) it was drawn from: close to the JAX
    engine's, and redrawing token i from q_i under fold_in(key(seed), i)
    gives the token back."""
    reqs = [(PROMPT_A, N_LONG, NEAR_GREEDY, None)]
    jeng, peng = _engines(mha, spec_k=8, capture_sample_probs=True)
    got = _assert_same(jeng, peng, reqs)
    assert peng.spec_accepted_tokens > 0
    rid = peng._next_rid - 1
    qs, jqs = peng.pop_sample_probs()[rid], jeng.pop_sample_probs()[rid]
    assert len(qs) == len(jqs) == len(got[0])
    np.testing.assert_allclose(np.stack(qs), np.stack(jqs), atol=1e-5)
    seed = torch.tensor([NEAR_GREEDY["seed"]], dtype=torch.int32)
    for i, (q, t) in enumerate(zip(qs, got[0])):
        k = fold_in(key(seed), torch.tensor([i], dtype=torch.int32))
        assert int(categorical(k, torch.log(torch.as_tensor(q))[None])) == t
    off, _ = _serve(PortEngine(mha[1], device="cpu", spec_k=8, **ENGINE),
                    reqs)
    assert off == got


def test_per_request_opt_out(mha):
    """``spec=False``: the same tokens, no draft and no verify."""
    reqs = [(PROMPT_A, N_LONG, dict(spec=False), None)]
    jeng, peng = _engines(mha, spec_k=8)
    got = _assert_same(jeng, peng, reqs)
    assert peng.spec_verify_forwards == peng.spec_draft_tokens == 0
    assert got == _serve(PortEngine(mha[1], device="cpu", **ENGINE),
                         reqs)[0]


@pytest.mark.parametrize("site", ["engine.spec_draft", "engine.spec_verify"])
def test_faults_degrade_as_the_reference(mha, site):
    """The same schedule on each engine's own injector: the port's tokens
    and counters are the JAX engine's, and the tokens spec-off's."""
    spec = {site: {"kind": "error", "after": 1, "times": 3}}
    jinj, pinj = JaxFaults(spec, seed=3), PortFaults(spec, seed=3)
    jeng, peng = _engines(mha, spec_k=8)
    jeng._faults, peng._faults = jinj, pinj
    reqs = [(PROMPT_A, N_LONG, None, None), (PROMPT_B, N_LONG, None, None)]
    got = _assert_same(jeng, peng, reqs)
    assert pinj.fires(site) == jinj.fires(site) == 3
    assert got == _serve(PortEngine(mha[1], device="cpu", **ENGINE),
                         reqs)[0]


@pytest.mark.parametrize("spec_k", [1, 8])
@pytest.mark.parametrize("sampling", [None, SAMPLED])
def test_preempt_and_resume(mha, spec_k, sampling):
    """Evict after a verify burst, resume with prompt + generated and
    ``sample_offset``: the stream is the JAX engine's unpreempted one."""
    jeng = JaxEngine(mha[0], **ENGINE)
    rid = jeng.add_request(PROMPT_A, max_new_tokens=N_LONG,
                           sampling=sampling)
    full = jeng.run()[rid]
    eng = PortEngine(mha[1], device="cpu", spec_k=spec_k, **ENGINE)
    rid = eng.add_request(PROMPT_A, max_new_tokens=N_LONG, sampling=sampling)
    eng.step()          # prefill + first token
    eng.step()          # one verify (or megastep) burst
    req = eng.evict(rid)
    assert 0 < len(req.generated) < N_LONG
    assert req.generated == full[:len(req.generated)]
    rid2 = eng.add_request(PROMPT_A + req.generated,
                           max_new_tokens=N_LONG - len(req.generated),
                           sampling=sampling,
                           sample_offset=len(req.generated))
    assert req.generated + eng.run()[rid2] == full


def _fresh_burst(pm, prompt, n):
    """Serve ``prompt`` on a spec engine step by step -> the first token
    that leads a verify burst of >= 2 committed tokens (an accepted draft
    token) and is new to the row's output, or None."""
    eng = PortEngine(pm, device="cpu", spec_k=8, **ENGINE)
    rid = eng.add_request(prompt, max_new_tokens=n)
    seen = []
    while rid not in eng._finished:
        new = eng.step().get(rid, [])
        if len(new) >= 2 and new[0] not in seen and eng.spec_accepted_tokens:
            return new[0]
        seen += new
    return None


def test_eos_inside_an_accepted_burst(mha):
    """An EOS that is an accepted draft token in the middle of a verify
    burst retires the row there: the tokens after it in the burst are
    dropped, as the JAX engine and spec-off stop.  Drafts repeat the
    history, so the burst's first token is new to the output only where
    its earlier occurrence is in the prompt: the prompt is PROMPT_A and a
    prefix of its own greedy stream."""
    stream = _serve(PortEngine(mha[1], device="cpu", **ENGINE),
                    [(PROMPT_A, N_LONG, None, None)])[0][0]
    for cut in range(len(stream) - 4, 0, -1):
        prompt = PROMPT_A + stream[:cut]
        n = min(12, ENGINE["max_seq_len"] - len(prompt))
        eos = _fresh_burst(mha[1], prompt, n)
        if eos is not None:
            break
    else:
        pytest.fail("no verify burst led by a token new to the output")
    reqs = [(prompt, n, None, eos)]
    jeng, peng = _engines(mha, spec_k=8)
    got = _assert_same(jeng, peng, reqs)
    assert got[0][-1] == eos and eos not in got[0][:-1]
    assert len(got[0]) < n
    assert got == _serve(PortEngine(mha[1], device="cpu", **ENGINE),
                         reqs)[0]


def test_the_verify_on_graphs(mha):
    """The verify through the graph cache (the CPU stand-in captures):
    one capture per ("spec", all_greedy) key, replays after it, tokens
    and counters of the eager engine; ``load_weights`` drops the keys."""
    def graph_engine():
        eng = PortEngine(mha[1], device="cpu", spec_k=8, **ENGINE)
        eng._graphs = True
        eng._graph_cache = GraphCache("cpu", counters=launch_counters,
                                      capture=_stub_capture)
        return eng

    waves = [[(PROMPT_A, N_LONG, None, None), (PROMPT_B, 20, None, None)],
             [(PROMPT_A, 30, SAMPLED, None)],
             [(PROMPT_B, N_LONG, NEAR_GREEDY, None)]]
    eng = graph_engine()
    eager = PortEngine(mha[1], device="cpu", spec_k=8, **ENGINE)
    for wave in waves:
        assert _serve(eng, wave) == _serve(eager, wave)
    assert _spec(eng) == _spec(eager)
    cache = eng._graph_cache
    spec_keys = {k for k in cache.graphs if k[0] == "spec"}
    assert spec_keys == {("spec", True), ("spec", False)}
    assert eng.compile_count == len(cache.graphs) == cache.captures
    replays = sum(cache.graphs[k].graph.replays for k in spec_keys)
    assert replays > 0
    eng.load_weights(mha[1], version="v1")
    assert not cache.graphs
    assert _serve(eng, waves[0]) == _serve(
        PortEngine(mha[1], device="cpu", spec_k=8, **ENGINE), waves[0])
    assert ("spec", True) in cache.graphs


def test_spec_k_validation(mha):
    with pytest.raises(ValueError):
        PortEngine(mha[1], device="cpu", spec_k=-1, **ENGINE)
    eng = PortEngine(mha[1], device="cpu", spec_k=3, **ENGINE)
    assert eng.state_summary()["spec"] == {
        "k": 3, "accepted": 0, "drafted": 0, "verify_forwards": 0}
