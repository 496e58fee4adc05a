"""Generation's decode step and the ``Predictor``'s forward on the graph
cache (``paddle_tpu_torch/jit/graphs.py``), on the CPU, where there is no
card and nothing is captured by default.

On CUDA ``greedy_decode`` and ``generate(use_static_cache=True)`` replay
one captured decode step per (B, L) and ``Predictor.run`` one graph per
input signature; ``chip_smoke.py`` phases 5, 6 and 9 hold them against the
eager loops on the card.  Here a stand-in takes the CUDA graph's place: its
capture runs the function once to make the outputs and then puts back
every ring row and pos the run wrote (a real capture runs no kernel), and
its replay runs the function again into those outputs.  Float32, the
2-layer ``llama_tiny`` and a 2-layer BERT classifier; tokens and outputs
compared exactly, against the eager path (the same code on the same
device) and, for ``greedy_decode``, against JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.generation import greedy_decode as jax_greedy
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework.random import Generator
from paddle_tpu_torch.jit import graphs
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.generation import generate, greedy_decode
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.llama import llama_tiny, load_numpy_state_dict
from paddle_tpu_torch.nn.transformer import (
    TransformerEncoder,
    TransformerEncoderLayer,
)
from paddle_tpu_torch.ops.hopper import flash_attention as fa
from paddle_tpu_torch.ops.hopper import int8_matmul as i8

torch.set_num_threads(2)

_REPLAYING = [False]


class _Replayed:
    """A CUDA graph's stand-in: each replay runs the captured function
    again and copies its results into the outputs the capture returned."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        _REPLAYING[0] = True
        try:
            new = self.fn()
        finally:
            _REPLAYING[0] = False
        if isinstance(self.outputs, torch.Tensor):
            self.outputs.copy_(new)
        else:
            for o, n in zip(self.outputs, new):
                o.copy_(n)


def _capture_of(model=None):
    """The stand-in capture; with ``model``, it puts back the pos, token
    buffer and ring rows of every key of the model's decode graphs after
    its run, as a capture that runs no kernel leaves them."""
    def capture(fn, pool):
        held = ([] if model is None else
                [t for r in model._decode_graphs.states.values()
                 for t in (r.pos, r.tok, *[b for k, v, _ in r.caches
                                          for b in (k, v)])])
        saved = [t.clone() for t in held]
        out = fn()
        for t, s in zip(held, saved):
            t.copy_(s)
        return _Replayed(fn, out), out
    return capture


@pytest.fixture(scope="module")
def pair():
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(0)
    jm = JaxLlama(jax_llama_tiny(num_key_value_heads=2))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.config))
    return jm, load_numpy_state_dict(LlamaForCausalLM(cfg, device="cpu"), sd)


@pytest.fixture
def on_graphs(monkeypatch):
    """Put a CPU model on the graph path with the stand-in capture (a
    fresh graph cache); the fixture's end takes it off again."""
    models = []

    def enable(model):
        model._graphs = True
        model.__dict__.pop("_decode_graphs", None)
        monkeypatch.setattr(graphs, "_cuda_capture", _capture_of(model))
        models.append(model)
        return model

    yield enable
    for m in models:
        del m._graphs
        m.__dict__.pop("_decode_graphs", None)


def _ids(seed, B, S):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (B, S)).astype(np.int32))


def _eager(model, fn, *args, **kw):
    model._graphs = False
    try:
        return fn(model, *args, **kw)
    finally:
        model._graphs = True


def _replays(model):
    return sum(g.graph.replays for g in model._decode_graphs.graphs.values())


def test_greedy_decode_on_graphs_equals_eager_and_jax(pair, on_graphs):
    jm, pm = pair
    m = on_graphs(pm)
    ids = _ids(1, 2, 7)
    got = greedy_decode(m, ids, 9, max_length=20)
    cache = m._decode_graphs
    assert cache.captures == 1 and set(cache.graphs) == {("decode", 2, 20)}
    assert _replays(m) == 7             # step 1 eager + captured, 7 replays
    want = _eager(m, greedy_decode, ids, 9, max_length=20)
    assert torch.equal(got, want) and got.dtype == torch.int32
    ref = np.asarray(jax_greedy(jm, P.to_tensor(ids.numpy()), 9,
                                max_length=20)._value)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_static_generate_on_graphs_equals_eager(pair, on_graphs, sampled,
                                                eos):
    m = on_graphs(pair[1])
    ids = _ids(2, 2, 6)
    kw = dict(max_new_tokens=8, use_static_cache=True)
    if sampled:
        kw.update(do_sample=True, top_p=0.9, temperature=0.8)
    if eos:   # row 0 stops at its third token, row 1 runs on
        free = _eager(m, generate, ids, **kw,
                      generator=Generator(7) if sampled else None)
        kw["eos_token_id"] = int(free[0, 2])
    runs = []
    for graph in (True, False):
        gen = Generator(7) if sampled else None
        out = (generate(m, ids, **kw, generator=gen) if graph
               else _eager(m, generate, ids, **kw, generator=gen))
        runs.append((out, gen and gen.get_state()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]     # one key per forward and per draw
    assert m._decode_graphs.captures == 1
    if eos:
        assert (runs[0][0][0, 2:] == kw["eos_token_id"]).all()


def test_one_capture_per_key_and_stale_rows_are_never_read(pair, on_graphs):
    """Calls with other prompt lengths and budgets on one (B, L) share its
    graph; a shorter prompt after a longer one (the ring holding the
    longer call's rows past it) gives a fresh eager call's tokens."""
    m = on_graphs(pair[1])
    long, short = _ids(3, 2, 14), _ids(4, 2, 4)
    greedy_decode(m, long, 10, max_length=32)
    got = [greedy_decode(m, short, 12, max_length=32),
           generate(m, short, max_new_tokens=5, use_static_cache=True,
                    max_length=32)]
    cache = m._decode_graphs
    assert cache.captures == 1 and set(cache.graphs) == {("decode", 2, 32)}
    assert torch.equal(got[0], _eager(m, greedy_decode, short, 12,
                                      max_length=32))
    assert torch.equal(got[1], got[0][:, :5])


def test_pos_advances_once_per_step(pair, on_graphs):
    m = on_graphs(pair[1])
    ids = _ids(5, 3, 5)
    greedy_decode(m, ids, 7, max_length=40)
    rings = m._decode_graphs.states[("decode", 3, 40)]
    assert int(rings.pos) == 5 + 6      # the prefill, then 6 steps
    assert all(p is rings.pos for _, _, p in rings.caches)
    greedy_decode(m, ids[:, :2], 4, max_length=40)
    assert int(rings.pos) == 2 + 3
    assert torch.equal(rings.tok[:, 0], greedy_decode(m, ids[:, :2], 4,
                                                      max_length=40)[:, 2])


def test_new_weights_reach_the_captured_graphs(pair, on_graphs):
    """``load_numpy_state_dict`` writes in place: the captured graph gives
    the new weights' tokens with no new capture.  A parameter replaced by
    another tensor drops the model's graphs, which are captured again."""
    cfg = pair[1].config
    m = on_graphs(LlamaForCausalLM(cfg, device="cpu", seed=11))
    other = LlamaForCausalLM(cfg, device="cpu", seed=12)
    ids = _ids(6, 2, 6)
    before = greedy_decode(m, ids, 6, max_length=16)
    load_numpy_state_dict(m, {k: v.detach().numpy()
                              for k, v in other.named_parameters()})
    got = greedy_decode(m, ids, 6, max_length=16)
    assert m._decode_graphs.captures == 1
    assert torch.equal(got, greedy_decode(other, ids, 6, max_length=16))
    assert not torch.equal(got, before)
    norm = m.llama.norm
    norm.weight = torch.nn.Parameter(norm.weight.detach() * 1.5)
    got = greedy_decode(m, ids, 6, max_length=16)
    assert m._decode_graphs.captures == 2
    assert torch.equal(got, _eager(m, greedy_decode, ids, 6, max_length=16))


def test_a_ninth_key_drops_the_oldest(pair, on_graphs):
    m = on_graphs(pair[1])
    ids = _ids(7, 1, 3)
    lengths = [8 + i for i in range(generation.MAX_DECODE_KEYS + 1)]
    toks = [greedy_decode(m, ids, 3, max_length=L) for L in lengths]
    cache = m._decode_graphs
    held = [("decode", 1, L) for L in lengths[1:]]
    assert list(cache.states) == held and set(cache.graphs) == set(held)
    assert cache.captures == len(lengths)
    again = greedy_decode(m, ids, 3, max_length=lengths[0])
    assert cache.captures == len(lengths) + 1
    assert ("decode", 1, lengths[1]) not in cache.states
    assert all(torch.equal(t, again) for t in toks)


# ------------------------------------------------------------ the predictor
VOCAB, H, HEADS, SEQ = 512, 64, 4, 16


class Bert(torch.nn.Module):
    """bench_ladder.py's BertClassifier, 2 layers at the test's sizes."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        kw = dict(device="cpu", dtype=torch.float32, generator=g)
        self.embed = pnn.Embedding(VOCAB, H, **kw)
        self.pos = pnn.Embedding(SEQ, H, **kw)
        self.encoder = TransformerEncoder(TransformerEncoderLayer(
            H, HEADS, 4 * H, dropout=0.1, activation="gelu", **kw), 2)
        self.cls = pnn.Linear(H, 2, **kw)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))

    def forward(self, ids):
        x = self.embed(ids) + self.pos(torch.arange(SEQ, device=ids.device))
        return self.cls(self.encoder(x)[:, 0])


@pytest.fixture(scope="module")
def bert():
    return Bert()


@pytest.fixture
def counting(monkeypatch):
    """B7's and B1's plain versions count as their kernels' launches do on
    the card (one per call; B7's fused bias too), except inside the
    stand-in's replays, where the graph adds its captured counts."""
    b7, b1 = i8.int8_matmul, fa.flash_attention_fused
    ref7, ref1 = i8._int8_matmul_ref, fa._plain_bshd

    def plain7(x, qw, scale, bias):
        if not _REPLAYING[0]:
            b7.launches += 1
            b7.bias_launches += bias is not None
        return ref7(x, qw, scale, bias)

    def plain1(*a):
        if not _REPLAYING[0]:
            b1.launches += 1
        return ref1(*a)

    monkeypatch.setattr(i8, "_int8_matmul_ref", plain7)
    monkeypatch.setattr(fa, "_plain_bshd", plain1)
    monkeypatch.setattr(graphs, "_cuda_capture", _capture_of())

    def counts():
        return b7.launches, b7.bias_launches, b1.launches
    return counts


def _predictors(layer, int8, n=1):
    """(graph predictors, an eager one) over ``layer``."""
    cfg = pinf.Config()
    cfg.set_layer(layer)
    if int8:
        cfg.enable_weight_only_quant("int8")
    preds = [pinf.create_predictor(cfg) for _ in range(n)]
    for p in preds:
        p._graphs = True
    return preds, pinf.create_predictor(cfg)


def _ids_np(seed, batch):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (batch, SEQ)).astype(np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_predictor_replays_equal_eager_runs(bert, counting, int8):
    (pred,), eager = _predictors(bert, int8)
    assert eager._graphs is False
    cache = pred._graph_cache
    for batch in (2, 3):
        x = _ids_np(batch, batch)
        want = eager.run([x])[0]
        n0 = counting()
        first = pred.run([x])[0]        # eager, then captured
        n1 = counting()
        run = tuple(b - a for a, b in zip(n0, n1))
        assert run == ((13, 13, 2) if int8 else (0, 0, 2))
        for seed in (0, 1):
            y = _ids_np(10 + seed, batch)
            got = pred.run([y])[0]      # a replay
            assert np.array_equal(got, eager.run([y])[0])
        n2 = counting()
        # each replay added the eager run's counts; the eager twin's two
        # runs counted as runs
        assert tuple(b - a for a, b in zip(n1, n2)) == tuple(
            4 * r for r in run)
        assert np.array_equal(first, want)
    assert cache.captures == 2 and set(cache.graphs) == {
        (((2, SEQ), torch.int32),), (((3, SEQ), torch.int32),)}


def test_tensor_inputs_and_handles_take_the_same_route(bert, counting):
    (pred, other), eager = _predictors(bert, True, n=2)
    x = _ids_np(20, 2)
    want = eager.run([x])[0]
    pred.run([x])
    assert pred._graph_cache.captures == 1
    y = _ids_np(21, 2)
    got_t = pred.run([torch.from_numpy(y)])[0]
    h = pred.get_input_handle("ids")
    h.copy_from_cpu(y)
    pred.run()
    got_h = pred.get_output_handle("out0").copy_to_cpu()
    key = (((2, SEQ), torch.int32),)
    assert set(pred._graph_cache.graphs) == {key}
    assert pred._graph_cache.captures == 1
    assert pred._graph_cache.graphs[key].graph.replays == 2
    assert np.array_equal(got_t, eager.run([y])[0])
    assert np.array_equal(got_h, got_t)
    # a pool's predictors each own a cache (and its pool)
    pool = pinf.PredictorPool(pred.config, size=2)
    a, b = pool.retrieve(0), pool.retrieve(1)
    assert a._graph_cache is not b._graph_cache
    assert other._graph_cache is not pred._graph_cache
    assert np.array_equal(pred.run([x])[0], want)


def test_a_replaced_parameter_drops_the_predictor_graphs(counting):
    """The float predictor serves the caller's layer: a weight written in
    place reaches the replays, a parameter replaced by another tensor drops
    the graphs, which are captured again."""
    layer = Bert()
    (pred,), eager = _predictors(layer, False)
    x = _ids_np(30, 2)
    pred.run([x])
    with torch.no_grad():
        layer.cls.bias.add_(1.0)
    assert np.array_equal(pred.run([x])[0], eager.run([x])[0])
    assert pred._graph_cache.captures == 1
    layer.cls.weight = torch.nn.Parameter(layer.cls.weight.detach() * 2)
    got = pred.run([x])[0]
    assert pred._graph_cache.captures == 2
    assert np.array_equal(got, eager.run([x])[0])


def test_cpu_defaults_capture_nothing(pair, bert):
    pm = pair[1]
    ids = _ids(8, 2, 5)
    greedy_decode(pm, ids, 4)
    generate(pm, ids, max_new_tokens=4, use_static_cache=True)
    assert generation._decode_graphs(pm) is None
    assert "_decode_graphs" not in pm.__dict__
    pred = _predictors(bert, False)[1]
    pred.run([_ids_np(9, 2)])
    assert pred._graphs is False
    assert pred._graph_cache.captures == 0 and not pred._graph_cache.graphs


def test_static_inputs_take_numpy_and_tensors():
    """One buffer per input: numpy arrays and tensors of its shape and
    dtype fill the same tensor; anything else raises."""
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    staged = graphs.StaticInputs([a], torch.device("cpu"))
    first = staged.fill([a])[0]
    second = staged.fill([torch.from_numpy(a + 1)])[0]
    assert first is second and torch.equal(second, torch.from_numpy(a + 1))
    for bad in (a.astype(np.int64), a[:1], torch.zeros(3, 2)):
        with pytest.raises(ValueError, match="buffer"):
            staged.fill([bad])
