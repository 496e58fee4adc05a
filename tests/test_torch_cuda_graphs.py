"""The serving engine's graph cache (``paddle_tpu_torch/jit/graphs.py``) on
the CPU, where there is no card and nothing is captured by default.

On CUDA the engine runs its two megastep loops as CUDA graphs, one per
(program, K, ``all_greedy``), and its single step, one per ("step",
``mq``, ``all_greedy``, ``capture_sample_probs``); ``chip_smoke.py``
phases 3 and 12 hold them against the eager loops on the card.  Here the
cache's logic runs with a stand-in for a CUDA graph (its capture runs the
function once to make the output buffers, its replay runs it again into
them): the key each megastep and single step takes, the static input
buffers against ``_dev``, the launch counts a replay adds,
``load_weights`` dropping the graphs, tokens, logprobs and scheduling
counters equal to the eager engine's (over the int8 cache too, with every
layer's dynamic scales), and a default CPU engine capturing nothing.
Float32, a 2-layer Llama; tokens, logprobs and scales compared exactly
(the same code on the same device in both engines).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.jit.graphs import GraphCache, StaticInputs
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.ops.hopper import launch_counters

torch.set_num_threads(2)

ENGINE = dict(device="cpu", max_batch_size=3, max_seq_len=96, block_size=8,
              token_budget=16, megastep_k=8)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=13,
               logprobs=True)
COUNTERS = ("megasteps", "megasteps_mixed", "prefill_chunks",
            "prefill_tokens_computed", "prefix_hit_blocks", "megastep_tokens")


class _Replayed:
    """A CUDA graph's stand-in: each replay runs the captured function again
    and copies its results into the outputs the capture returned."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        for o, n in zip(self.outputs, self.fn()):
            if o is not None:
                o.copy_(n)


def _stub_capture(fn, pool):
    out = fn()
    return _Replayed(fn, out), out


def _graph_engine(model, **kw):
    """A CPU engine on the graph path, the stand-in capturing."""
    eng = ServingEngine(model, **{**ENGINE, **kw})
    eng._graphs = True
    eng._graph_cache = GraphCache("cpu", counters=launch_counters,
                                  capture=_stub_capture)
    return eng


@pytest.fixture(scope="module")
def models():
    return (LlamaForCausalLM(llama_tiny(), device="cpu", seed=3),
            LlamaForCausalLM(llama_tiny(), device="cpu", seed=4))


# A decodes alone (K 4 from 3 left); B's chunked prompt, C's sampled one
# and D's arrive together (mixed loops); E and F share a prompt; G decodes
# alone for 19 tokens (K 8 twice, then 4), H sampled (K 8 from 6 left)
def _serve(eng):
    rng = np.random.default_rng(0)
    a = eng.add_request([3, 17, 101, 7, 250], max_new_tokens=4,
                        sampling=dict(logprobs=True))
    eng.step()
    eng.step()
    b = eng.add_request(rng.integers(1, 512, 20).tolist(), max_new_tokens=12,
                        sampling=dict(logprobs=True))
    c = eng.add_request([9, 8, 7], max_new_tokens=6, sampling=SAMPLED)
    d = eng.add_request(rng.integers(1, 512, 17).tolist(), max_new_tokens=2)
    done = eng.run()
    prompt = rng.integers(1, 512, 24).tolist()
    e = eng.add_request(prompt, max_new_tokens=9)
    f = eng.add_request(prompt, max_new_tokens=5)
    done.update(eng.run())
    g = eng.add_request([5, 6, 7, 8], max_new_tokens=20)
    done.update(eng.run())
    h = eng.add_request([11, 12], max_new_tokens=7, sampling=SAMPLED)
    done.update(eng.run())
    rids = (a, b, c, d, e, f, g, h)
    lps = eng.pop_token_logprobs()
    return ([done[r] for r in rids], [lps.get(r) for r in rids],
            {n: getattr(eng, n) for n in COUNTERS})


def test_keys_follow_program_k_bucket_and_all_greedy(models):
    """Each megastep launch takes the key (program, K, all_greedy): the
    pure-decode loop K bucketed to the power of two at or above the most
    tokens a row has left (at most megastep_k), the mixed loop megastep_k;
    each single step ("step", mq, all_greedy, capture_sample_probs): mq 1
    for a pure-decode step ([B] tokens), token_budget for one carrying
    prefill ([T] tokens); all_greedy from the host's temperatures.  One
    capture per key; every later call of a key replays its graph."""
    eng = _graph_engine(models[0])
    calls = []
    program, graphed = eng._program, eng._graphed

    def logged(name, fn, arrays, K, all_greedy):
        temps = arrays[10] if name == "megastep" else arrays[11]
        calls.append((name, K, all_greedy))
        assert all_greedy == bool((temps <= 0).all())
        return program(name, fn, arrays, K, all_greedy)

    def logged_step(key, fn, arrays):
        if key[0] == "step":
            _, mq, all_greedy, probs = key
            calls.append(key)
            assert arrays[0].shape == ((eng.B,) if mq == 1 else (eng.T,))
            assert mq in (1, eng.T)
            assert all_greedy == bool((arrays[6] <= 0).all())
            assert probs is eng.capture_sample_probs is False
        return graphed(key, fn, arrays)

    eng._program, eng._graphed = logged, logged_step
    _serve(eng)
    keys = set(calls)
    assert keys == {("megastep", 4, True), ("megastep", 8, True),
                    ("megastep", 8, False), ("mixed", 8, False),
                    ("mixed", 8, True), ("step", 16, True, False),
                    ("step", 16, False, False)}
    for name, K, *_ in keys:
        assert (K == 8 if name == "mixed" else K == 16 if name == "step"
                else K in (1, 2, 4, 8))
    assert set(eng._graph_cache.graphs) == keys
    assert eng.compile_count == eng._graph_cache.captures == len(keys)
    replays = sum(g.graph.replays for g in eng._graph_cache.graphs.values())
    assert replays == len(calls) - len(keys) > 0


def test_graph_engine_equals_the_eager_engine(models):
    """Tokens, logprobs (exactly) and scheduling counters of the graph path
    (first calls eager, then replays into the captured outputs) against
    the eager engine over the same schedule."""
    got = _serve(_graph_engine(models[0]))
    eager = ServingEngine(models[0], **ENGINE)
    assert eager._graphs is False
    assert got == _serve(eager)


def _serve_int8(eng):
    """Waves over the int8 cache: one-shot prefills (prompts within the
    16-token budget, a prefill waiting for budget beside decoding rows),
    single steps at mq 1 and 16, megasteps, a sampled request.  Returns
    tokens, logprobs, the scheduling counters and every layer's scales."""
    rng = np.random.default_rng(2)
    a = eng.add_request(rng.integers(1, 512, 12).tolist(), max_new_tokens=3,
                        sampling=dict(logprobs=True))
    b = eng.add_request(rng.integers(1, 512, 9).tolist(), max_new_tokens=10,
                        sampling=SAMPLED)
    eng.step()
    c = eng.add_request(rng.integers(1, 512, 15).tolist(), max_new_tokens=6,
                        sampling=dict(logprobs=True))
    d = eng.add_request([4, 5, 6], max_new_tokens=1)
    done = eng.run()
    e = eng.add_request(rng.integers(1, 512, 16).tolist(), max_new_tokens=2,
                        sampling=dict(logprobs=True))
    f = eng.add_request(rng.integers(1, 512, 7).tolist(), max_new_tokens=11,
                        sampling=SAMPLED)
    done.update(eng.run())
    # alone with one token left: pure-decode single steps (mq 1)
    g = eng.add_request([8, 9, 10, 11], max_new_tokens=2,
                        sampling=dict(logprobs=True))
    done.update(eng.run())
    h = eng.add_request(rng.integers(1, 512, 5).tolist(), max_new_tokens=2)
    done.update(eng.run())
    rids = (a, b, c, d, e, f, g, h)
    lps = eng.pop_token_logprobs()
    scales = [{n: t.clone() for n, t in sc.items()}
              for sc in eng.cache_scales]
    return ([done[r] for r in rids], [lps.get(r) for r in rids],
            {n: getattr(eng, n) for n in COUNTERS}, scales)


def test_int8_graph_engine_equals_the_eager_engine(models):
    """The int8 cache's single steps (every prefill is one: no mixed loop)
    on graphs: their first calls eager, then replays that refresh the
    dynamic scales in place at the graph's fixed addresses.  Tokens,
    logprobs, the scheduling counters and every layer's ``cache_scales``
    equal the eager engine's exactly; the step keys at mq 1 and 16 were
    captured and replayed."""
    eng = _graph_engine(models[0], cache_quant="int8")
    got = _serve_int8(eng)
    eager = ServingEngine(models[0], cache_quant="int8", **ENGINE)
    assert eager._graphs is False
    want = _serve_int8(eager)
    assert got[:3] == want[:3]
    assert got[2]["megasteps"] > 0 and not got[2]["megasteps_mixed"]
    assert len(got[3]) == len(want[3]) == models[0].config.num_hidden_layers
    for g, w in zip(got[3], want[3]):
        assert set(g) == {"kq", "vq", "kd", "vd"}
        for n in g:
            assert torch.equal(g[n], w[n]), n
    graphs = eng._graph_cache.graphs
    steps = {k for k in graphs if k[0] == "step"}
    assert {("step", 1, True, False), ("step", 16, True, False),
            ("step", 16, False, False)} <= steps
    assert sum(graphs[k].graph.replays for k in steps) > 0
    assert eager.compile_count == 0 and not eager._graph_cache.graphs


def test_static_inputs_are_what_dev_gives(models):
    """The staged buffers hold the arrays `_dev` makes tensors of: dtype,
    shape and values, block tables included; a refill changes the values
    in the same tensors."""
    eng = ServingEngine(models[0], **ENGINE)
    rng = np.random.default_rng(1)
    arrays = [rng.integers(0, 99, 3).astype(np.int32),
              rng.random(3) > 0.5,
              rng.random(3).astype(np.float32),
              np.full((3, 12), -1, np.int32),
              rng.integers(0, 9, (3, 64)).astype(np.int32)]
    staged = StaticInputs(arrays, torch.device("cpu"))
    first = staged.fill(arrays)
    for t, a in zip(first, arrays):
        ref = eng._dev(a)
        assert t.dtype == ref.dtype and t.shape == ref.shape
        assert torch.equal(t, ref)
    again = [a + 1 if a.dtype != bool else ~a for a in arrays]
    second = staged.fill(again)
    assert all(x is y for x, y in zip(first, second))
    for t, a in zip(second, again):
        assert torch.equal(t, eng._dev(a))
    with pytest.raises(ValueError, match="buffer"):
        staged.fill([a[:1] for a in arrays])


def test_a_replay_adds_exactly_the_captured_launch_counts():
    """The warm-up's launches count (they ran); the capture's are put back
    (nothing ran); each replay adds what the capture recorded, for every
    ``*launches`` counter (B7's ``bias_launches`` too)."""
    def k1():
        pass

    def k2():
        pass

    k1.launches, k2.launches, k2.bias_launches = 5, 0, 0
    counters = {"k1": k1, "k2": k2}
    replaying = []

    def fn(x):
        if not replaying:       # a replay runs no wrapper
            k1.launches += 3
            k2.bias_launches += 1
        return (x * 2,)

    def capture(f, pool):
        g, out = _stub_capture(f, pool)
        run = g.fn
        g.fn = lambda: replaying.append(1) or run()
        return g, out

    cache = GraphCache("cpu", counters=lambda: counters, capture=capture)
    x = np.arange(4, dtype=np.float32)
    out = cache.run("key", fn, [x])
    assert (k1.launches, k2.launches, k2.bias_launches) == (8, 0, 1)
    assert cache.captures == 1 and "key" in cache.graphs
    assert cache.graphs["key"].deltas == {("k1", "launches"): 3,
                                          ("k2", "bias_launches"): 1}
    for i in range(3):
        out = cache.run("key", fn, [x + i])
        assert torch.equal(out[0], torch.as_tensor((x + i) * 2))
    assert (k1.launches, k2.launches, k2.bias_launches) == (8 + 9, 0, 1 + 3)
    assert cache.captures == 1


def test_load_weights_drops_the_graphs_and_serves_the_new_weights(models):
    """The captured graphs read the old weights' memory: ``load_weights``
    drops them (captures stay counted) and the next megasteps capture
    again; the engine then serves the new weights' tokens, those of a
    fresh eager engine over the new model."""
    eng = _graph_engine(models[0])
    _serve(eng)
    before = eng.compile_count
    assert before > 0 and len(eng._graph_cache.graphs) == before
    eng.load_weights(models[1], version="v1")
    assert not eng._graph_cache.graphs and eng.compile_count == before
    got = _serve(eng)
    assert eng.compile_count > before
    fresh = ServingEngine(models[1], **ENGINE)
    want = _serve(fresh)
    assert got[:2] == want[:2]


def test_a_new_pool_once_every_graph_was_dropped(monkeypatch):
    """Graphs share one pool while any of them lives; once ``clear`` (a
    rolling swap's ``load_weights``) or ``watch`` dropped them all, the
    next capture takes a new pool: PyTorch asserts on a capture into a
    pool whose graphs are gone while their outputs hold its memory."""
    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    cache = GraphCache("cpu")
    first = cache._pool_for_capture()
    cache.graphs["a"] = object()
    assert cache._pool_for_capture() == first
    cache.graphs["b"] = object()
    cache.drop("a")
    assert cache._pool_for_capture() == first      # "b" still uses it
    cache.clear()
    assert cache._pool_for_capture() != first


def test_a_cpu_engine_captures_nothing(models):
    """By default a CPU engine runs every loop eagerly: no graph, no
    capture, compile_count 0 after megasteps and mixed loops ran."""
    eng = ServingEngine(models[0], **ENGINE)
    _, _, counters = _serve(eng)
    assert counters["megasteps"] > 0 and counters["megasteps_mixed"] > 0
    assert eng._graphs is False
    assert eng.compile_count == 0 and not eng._graph_cache.graphs
