"""The port's ``jit.to_static`` (``paddle_tpu_torch/jit/api.py``,
``lazy_segments.py``) against the JAX package's on the CPU.

The same numpy weights and inputs go through ``paddle_tpu.jit.to_static``
and the port's: forward values and gradients for an MLP and a 2-layer,
hidden-64 Llama (the port's Llama through the plain versions of K1, K2,
K3 and B1, the custom ops' CPU implementations), the number of guard keys
after the reference's call sequences (``tests/test_jit_amp_io.py``), the
dropout masks for one seed, ``bucket_dynamic_batch``, and the graph-break
cases of ``tests/test_graph_break.py`` (segment counts, broken and whole
keys, values and gradients).  The CUDA graph path runs here with a
stand-in for the capture (``tests/test_torch_cuda_graphs.py``'s): one
capture per key, replays equal to the eager calls, an in-place parameter
update seen by the replay, a replaced parameter captured again.

Tolerances, float32: 1e-5 (XLA's and PyTorch's summation orders); the
dropout masks and anything the port computes twice on one path, exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate import inference as incubate_inference
from paddle_tpu_torch.jit.graphs import GraphCache
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import load_numpy_state_dict
from paddle_tpu_torch.ops.hopper import launch_counters

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)


class JaxSmallNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.drop = jnn.Dropout(0.5)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(self.drop(P.nn.functional.relu(self.fc1(x))))


class SmallNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator()
        self.fc1 = pnn.Linear(8, 16, device="cpu", generator=g)
        self.drop = pnn.Dropout(0.5)
        self.fc2 = pnn.Linear(16, 4, device="cpu", generator=g)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


def _carry(jax_layer, port_layer):
    load_numpy_state_dict(port_layer, {k: np.asarray(v._value) for k, v in
                                       jax_layer.state_dict().items()})
    return jax_layer, port_layer


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else \
        t.detach().numpy()


class _Replayed:
    """A CUDA graph's stand-in: a replay runs the captured function again
    into the outputs the capture returned."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        for o, n in zip(self.outputs, self.fn()):
            o.copy_(n)


def _stub_capture(fn, pool):
    out = fn()
    return _Replayed(fn, out), out


def _on_graphs(st):
    st._graphs = True
    st._graph_cache = GraphCache("cpu", counters=launch_counters,
                                 capture=_stub_capture,
                                 weights=None if st._layer is None else
                                 jit.api.module_tensors(st._layer))
    return st


def _replays(st):
    return sum(g.graph.replays for g in st._graph_cache.graphs.values())


@pytest.fixture(scope="module")
def mlp_pair():
    P.seed(5)
    return _carry(JaxSmallNet(), SmallNet())


@pytest.fixture(scope="module")
def llama_pair():
    P.seed(6)
    return _carry(JaxLlama(JaxLlamaConfig(**LLAMA)),
                  LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu"))


def _grads_jax(layer):
    return {k: np.asarray(p.grad._value)
            for k, p in layer.named_parameters() if p.grad is not None}


def _grads_port(layer):
    return {k: p.grad.numpy() for k, p in layer.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("case", ["mlp", "llama"])
def test_forward_and_gradients_match_the_reference(case, mlp_pair,
                                                   llama_pair):
    jl, pl = mlp_pair if case == "mlp" else llama_pair
    jl.eval()
    pl.eval()
    if case == "mlp":
        xn = _x(1, 4, 8)
        jx, px = P.to_tensor(xn), torch.from_numpy(xn)
        cot = _x(2, 4, 4)
    else:
        xn = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
            np.int32)
        jx, px = P.to_tensor(xn), torch.from_numpy(xn)
        cot = _x(2, 2, 16, 256)
    jst, pst = P.jit.to_static(jl), jit.to_static(pl)
    jl.clear_gradients()
    pl.zero_grad()
    jo, po = jst(jx), pst(px)
    np.testing.assert_allclose(_np(po), _np(jo), **TOL)
    (jo * P.to_tensor(cot)).sum().backward()
    (po * torch.from_numpy(cot)).sum().backward()
    gj, gp = _grads_jax(jl), _grads_port(pl)
    assert set(gp) == set(gj) and gp
    for k in gj:
        scale = max(1.0, float(np.abs(gj[k]).max()))
        np.testing.assert_allclose(gp[k], gj[k], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)
    # the no-grad call of the same signature, on graphs (a new key: grad
    # mode is one of the guards), equals the reference's value
    _on_graphs(pst)
    with torch.no_grad():
        for _ in range(3):
            np.testing.assert_allclose(pst(px).numpy(), _np(jo), **TOL)
    assert pst._graph_cache.captures == 1 and _replays(pst) == 1
    assert len(pst._cache) == 2


def _key_sequence(to_static, net, randn, ones, no_grad):
    """The reference's guard-key sequences (test_jit_amp_io.py:46-66) plus
    a no-grad call -> the key count after each."""
    counts = []
    sf = to_static(net)
    net.eval()
    for shape in ([2, 8], [4, 8], [2, 8]):
        sf(randn(shape))
        counts.append(len(sf._cache))
    net.train()
    sf(ones([2, 8]))
    counts.append(len(sf._cache))
    net.eval()
    sf(ones([2, 8]))
    counts.append(len(sf._cache))
    with no_grad():
        sf(ones([2, 8]))
    counts.append(len(sf._cache))
    return counts


def test_guard_keys_count_as_the_reference(mlp_pair):
    jl, pl = mlp_pair
    ref = _key_sequence(P.jit.to_static, jl, P.randn, P.ones,
                        P.no_grad if hasattr(P, "no_grad") else
                        P.autograd.tape.no_grad)
    ours = _key_sequence(jit.to_static, pl, lambda s: torch.randn(*s),
                         lambda s: torch.ones(*s), torch.no_grad)
    assert ours == ref == [1, 2, 2, 3, 3, 4]


def test_dropout_masks_equal_the_reference_for_one_seed():
    """A to_static function that draws a dropout mask: each call a fresh
    key, the reference's masks bit for bit; on graphs the replays draw
    new masks too (the key is a static input refilled at each replay)."""
    xn = np.ones((4, 64), np.float32)

    def jf(x):
        return P.nn.functional.dropout(x, 0.5, training=True) * 3.0

    def pf(x):
        return F.dropout(x, 0.5, training=True) * 3.0

    P.seed(7)
    jst = P.jit.to_static(jf)
    ref = [_np(jst(P.to_tensor(xn))) for _ in range(4)]
    for graphs in (False, True):
        prandom.seed(7)
        pst = jit.to_static(pf)
        if graphs:
            _on_graphs(pst)
        got = [pst(torch.from_numpy(xn)).numpy() for _ in range(4)]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(got[0], got[1])
        assert not np.array_equal(got[2], got[3])
        if graphs:
            assert pst._graph_cache.captures == 1 and _replays(pst) == 2


@pytest.mark.parametrize("what", ["counts", "values", "gradients"])
def test_bucketed_dynamic_batch_as_the_reference(what):
    """test_jit_amp_io.py:431-468 on both packages."""
    rng = np.random.default_rng(0)
    w = _x(3, 4, 8)
    b = _x(4, 8)
    jl, pl = jnn.Linear(4, 8), pnn.Linear(4, 8, device="cpu",
                                          generator=torch.Generator())
    jl.set_state_dict({"weight": w, "bias": b})
    load_numpy_state_dict(pl, {"weight": w, "bias": b})
    jst = P.jit.to_static(jl, input_spec=[P.jit.InputSpec([None, 4])],
                          bucket_dynamic_batch=True)
    pst = jit.to_static(pl, input_spec=[jit.InputSpec([None, 4])],
                        bucket_dynamic_batch=True)
    if what == "counts":
        for n in (3, 5, 6, 7, 2, 1):
            xn = rng.standard_normal((n, 4)).astype(np.float32)
            out, ref = pst(torch.from_numpy(xn)), jst(P.to_tensor(xn))
            assert tuple(out.shape) == (n, 8) and list(ref.shape) == [n, 8]
            np.testing.assert_allclose(out.detach().numpy(), _np(ref), **TOL)
        assert len(pst._cache) == len(jst._cache) == 4
    elif what == "values":
        xn = rng.standard_normal((5, 4)).astype(np.float32)
        with torch.no_grad():
            _on_graphs(pst)
            for _ in range(3):
                out = pst(torch.from_numpy(xn))
                np.testing.assert_allclose(out.numpy(),
                                           _np(jl(P.to_tensor(xn))), **TOL)
                np.testing.assert_array_equal(out.numpy(),
                                              pl(torch.from_numpy(xn)).numpy())
        assert set(k[1][0][0] for k in pst._cache) == {(8, 4)}
    else:
        xn = rng.standard_normal((3, 4)).astype(np.float32)
        pst(torch.from_numpy(xn)).sum().backward()
        P.sum(jst(P.to_tensor(xn))).backward()
        expect = xn.sum(0)[:, None] * np.ones((1, 8))
        np.testing.assert_allclose(pl.weight.grad.numpy(), expect, **TOL)
        np.testing.assert_allclose(pl.weight.grad.numpy(),
                                   _np(jl.weight.grad), **TOL)
        np.testing.assert_allclose(pl.bias.grad.numpy(), np.full(8, 3.0),
                                   **TOL)


# ------------------------------------------------------------ graph breaks
def _host(t):
    """The tensor's values on the host, as the card's code reads them."""
    return np.asarray(t.detach().cpu().numpy())


class _Pair:
    """A graph-break case on both packages: (reference net, port net)."""

    def __init__(self, kind):
        P.seed(11)
        self.kind = kind
        h = 16 if kind in ("mid", "mid_scaled") else 8
        if kind == "branchy":
            self.jax = _JaxBreak(kind, jnn.Linear(8, 8), jnn.Linear(8, 8))
            self.port = _PortBreak(kind, h)
        else:
            second = (jnn.Linear(16, 4) if kind != "inplace" else None)
            self.jax = _JaxBreak(kind, jnn.Linear(8, h), second)
            self.port = _PortBreak(kind, h)
        _carry(self.jax, self.port)


class _JaxBreak(jnn.Layer):
    """tests/test_graph_break.py's nets, one class by ``kind``."""

    def __init__(self, kind, a, b):
        super().__init__()
        self.kind = kind
        self.a = a
        if b is not None:
            self.b = b

    def forward(self, x):
        if self.kind == "branchy":
            if float(np.asarray(x.numpy()).sum()) > 0:
                return self.a(x)
            return self.b(x)
        h = self.a(x)
        if self.kind == "mid":
            scale = float(np.asarray(h.numpy()).mean())
            return self.b(h * (1.0 + 0.0 * scale) + scale * 0.0)
        if self.kind == "mid_scaled":
            s = float(np.asarray(h.numpy()).std()) + 1.0
            return self.b(h / s)
        _ = float(np.asarray(h.numpy()).mean())
        h2 = h * 2.0
        h2.add_(P.ones([8]))
        return h2 * 0.5


class _PortBreak(torch.nn.Module):
    def __init__(self, kind, h):
        super().__init__()
        self.kind = kind
        g = torch.Generator()
        self.a = pnn.Linear(8, h, device="cpu", generator=g)
        if kind == "branchy":
            self.b = pnn.Linear(8, 8, device="cpu", generator=g)
        elif kind != "inplace":
            self.b = pnn.Linear(16, 4, device="cpu", generator=g)

    def forward(self, x):
        if self.kind == "branchy":
            if float(_host(x).sum()) > 0:
                return self.a(x)
            return self.b(x)
        h = self.a(x)
        if self.kind == "mid":
            scale = float(_host(h).mean())
            return self.b(h * (1.0 + 0.0 * scale) + scale * 0.0)
        if self.kind == "mid_scaled":
            s = float(_host(h).std()) + 1.0
            return self.b(h / s)
        _ = float(_host(h).mean())
        h2 = h * 2.0
        h2.add_(torch.ones(8))
        return h2 * 0.5


@pytest.mark.parametrize("kind", ["branchy", "mid", "mid_scaled", "inplace"])
def test_graph_breaks_count_the_reference_segments(kind):
    pair = _Pair(kind)
    xn = np.abs(_x(0, 4, 8))
    jst, pst = P.jit.to_static(pair.jax), jit.to_static(pair.port)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jo = jst(P.to_tensor(xn))
        po = pst(torch.from_numpy(xn))
    assert sum("graph break" in str(m.message) for m in w) == 2
    assert pst.last_segment_count == jst.last_segment_count
    assert pst.last_segment_count == {"branchy": 1}.get(kind, 2)
    assert len(pst._fallback_keys) == len(jst._fallback_keys) == 1
    assert not pst._cache and not jst._cache
    want = pair.port(torch.from_numpy(xn))
    np.testing.assert_array_equal(po.detach().numpy(), want.detach().numpy())
    np.testing.assert_allclose(po.detach().numpy(), _np(jo), **TOL)
    # the broken key runs segmented from then on, warning no more
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pst(torch.from_numpy(xn))
    assert not w and pst.last_segment_count == jst.last_segment_count
    if kind == "mid_scaled":
        # gradients through the broken key equal eager (and the reference)
        y = _x(5, 4, 4)
        pair.port.zero_grad()
        torch.nn.functional.mse_loss(pst(torch.from_numpy(xn)),
                                     torch.from_numpy(y)).backward()
        g_seg = pair.port.a.weight.grad.clone()
        pair.port.zero_grad()
        torch.nn.functional.mse_loss(pair.port(torch.from_numpy(xn)),
                                     torch.from_numpy(y)).backward()
        torch.testing.assert_close(g_seg, pair.port.a.weight.grad, rtol=0,
                                   atol=0)
        P.nn.functional.mse_loss(jst(P.to_tensor(xn)),
                                 P.to_tensor(y)).backward()
        np.testing.assert_allclose(g_seg.numpy(), _np(pair.jax.a.weight.grad),
                                   **TOL)


def test_full_graph_raises_and_signatures_break_independently():
    pair = _Pair("mid_scaled")
    with pytest.raises(RuntimeError, match="graph break"):
        jit.to_static(pair.port, full_graph=True)(torch.ones(4, 8))

    def make(np_read):
        def f(x, flag=False):
            if flag:
                _ = float(np_read(x).sum())
            return x * 2
        return f

    jst = P.jit.to_static(make(lambda x: np.asarray(x.numpy())))
    pst = jit.to_static(make(_host))
    for st, t in ((jst, P.to_tensor), (pst, torch.from_numpy)):
        a = st(t(_x(1, 3)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = st(t(_x(2, 3)), True)
        assert list(a.shape) == [3] and list(b.shape) == [3]
    assert (len(pst._fallback_keys), len(pst._cache),
            pst.last_segment_count) == (len(jst._fallback_keys),
                                        len(jst._cache),
                                        jst.last_segment_count) == (1, 1, 1)


def test_graphs_read_parameters_in_place_and_recapture_a_new_one():
    """test_jit_amp_io.py's test_param_update_visible_to_compiled_fn on the
    graph path: an in-place write reaches the replay; a parameter replaced
    by a new tensor drops the graph, which is captured again."""
    net = pnn.Linear(2, 2, device="cpu", generator=torch.Generator(),
                     bias_attr=False)
    st = _on_graphs(jit.to_static(net))
    x = torch.ones(1, 2)
    with torch.no_grad():
        y1 = [st(x) for _ in range(3)][-1].numpy()
        net.weight.mul_(2)
        y2 = st(x).numpy()
        np.testing.assert_allclose(y2, y1 * 2, rtol=1e-6)
        assert st._graph_cache.captures == 1
        net.weight = torch.nn.Parameter(net.weight.detach() * 2)
        y3 = [st(x) for _ in range(2)][-1].numpy()
    np.testing.assert_allclose(y3, y1 * 4, rtol=1e-6)
    assert st._graph_cache.captures == 2


def test_switches_and_incubate_inference(mlp_pair):
    _, pl = mlp_pair
    pl.eval()
    x = torch.from_numpy(_x(3, 2, 8))
    st = jit.to_static(pl)
    jit.enable_to_static(False)
    try:
        out = st(x)
    finally:
        jit.enable_to_static(True)
    assert not st._cache
    np.testing.assert_array_equal(out.detach().numpy(),
                                  pl(x).detach().numpy())
    assert jit.not_to_static(len) is len and jit.not_to_static()(len) is len
    assert jit.ignore_module([np]) is None
    jit.set_code_level(100)
    jit.set_verbosity(0)
    fn = incubate_inference(lambda a: pl(a) * 2)
    got = fn(x)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), (pl(x) * 2).detach().numpy())
