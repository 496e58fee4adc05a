"""The port's gradient clips (``paddle_tpu_torch/nn/clip.py``) and the
optimizers' ``grad_clip`` against the JAX package's, on the CPU.

- The three clip classes on (param, grad) pairs, float32 and bfloat16
  gradients, and ``clip_grad_norm_`` at norm types 1, 2, 3 and inf.
- ``grad_clip`` in the eager ``step`` and in ``TrainStep``, with two
  parameter groups (the second at half the rate): the clip applies per
  group, as the reference's.

Tolerances: float32 gradients 1e-6 relative to each tensor's largest
|value| (the port takes each norm with ``torch._foreach_norm`` and squares
it, the reference sums the squares: the scale differs in float32 rounding).
bfloat16 gradients: every element within one bf16 ulp of the reference's
(the product is rounded once in both; a scale one float32 ulp apart can
move a product across a rounding midpoint).  Parameters after 3 AdamW
steps: 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JFn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

SHAPES = [(7, 5), (33,), (4, 3, 2)]


def _grads(seed, dtype):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * (i + 1) * 0.7).astype(np.float32)
            for i, s in enumerate(SHAPES)]


def _pairs_jax(gs, dtype):
    out = []
    for g in gs:
        p = P.to_tensor(np.zeros_like(g))
        p.stop_gradient = False
        out.append((p, P.to_tensor(g).astype(dtype)))
    return out


def _pairs_port(gs, dtype):
    return [(torch.nn.Parameter(torch.zeros(g.shape)),
             torch.as_tensor(g).to(dtype)) for g in gs]


def _check(ours, ref, dtype):
    for (_, a), (_, b) in zip(ours, ref):
        assert a.dtype == dtype
        a = a.float().numpy()
        b = np.asarray(b.astype("float32")._value)
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b),
                                                      2.0 ** -126))) - 7)
            assert np.all(np.abs(a - b) <= ulp)


CLIPS = {
    "value": (lambda: jnn.ClipGradByValue(0.9, -0.4),
              lambda: pnn.ClipGradByValue(0.9, -0.4)),
    "norm": (lambda: jnn.ClipGradByNorm(1.3), lambda: pnn.ClipGradByNorm(1.3)),
    "global_norm": (lambda: jnn.ClipGradByGlobalNorm(2.1),
                    lambda: pnn.ClipGradByGlobalNorm(2.1)),
    "global_norm_unclipped": (lambda: jnn.ClipGradByGlobalNorm(1e4),
                              lambda: pnn.ClipGradByGlobalNorm(1e4)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CLIPS))
def test_clip_matches_the_reference(name, dtype):
    gs = _grads(1, dtype)
    jclip, pclip = (f() for f in CLIPS[name])
    tdt = getattr(torch, dtype)
    _check(pclip(_pairs_port(gs, tdt)), jclip(_pairs_jax(gs, dtype)), tdt)


def test_global_norm_skips_untrainable_parameters_in_the_sum():
    """A frozen parameter's gradient leaves the norm, and is still
    scaled, as the reference's."""
    gs = _grads(2, "float32")
    jp, pp = _pairs_jax(gs, "float32"), _pairs_port(gs, torch.float32)
    jp[0][0].trainable = False
    pp[0][0].requires_grad_(False)
    _check(pnn.ClipGradByGlobalNorm(0.5)(pp),
           jnn.ClipGradByGlobalNorm(0.5)(jp), torch.float32)


@pytest.mark.parametrize("norm_type", [1.0, 2.0, 3.0, float("inf")])
def test_clip_grad_norm_matches_the_reference(norm_type):
    gs = _grads(3, "float32")
    jps, pps = [], []
    for g in gs:
        jp = P.to_tensor(np.zeros_like(g))
        jp.grad = P.to_tensor(g)
        jps.append(jp)
        pp = torch.nn.Parameter(torch.zeros(g.shape))
        pp.grad = torch.as_tensor(g).clone()
        pps.append(pp)
    jt = jnn.clip_grad_norm_(jps, 1.5, norm_type=norm_type)
    pt = pnn.clip_grad_norm_(pps, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(float(pt), float(jt.numpy()), rtol=1e-6)
    for jp, pp in zip(jps, pps):
        ref = jp.grad.numpy()
        np.testing.assert_allclose(pp.grad.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


class _JaxNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(6, 8)
        self.l2 = jnn.Linear(8, 3)

    def forward(self, x):
        return self.l2(JFn.relu(self.l1(x)))


class _PortNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator()
        self.l1 = pnn.Linear(6, 8, device="cpu", generator=g)
        self.l2 = pnn.Linear(8, 3, device="cpu", generator=g)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


def _nets():
    P.seed(9)
    jn = _JaxNet()
    pn = _PortNet()
    pnn.load_numpy_state_dict(pn, {k: np.asarray(v._value)
                                   for k, v in jn.state_dict().items()})
    return jn, pn


def _groups(net):
    return [{"params": list(net.l1.parameters())},
            {"params": list(net.l2.parameters()), "learning_rate": 0.5}]


def _data():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((16, 6)).astype(np.float32) * 3,
            rng.standard_normal((16, 3)).astype(np.float32))


@pytest.mark.parametrize("clip", ["norm", "global_norm", "value"])
@pytest.mark.parametrize("mode", ["eager", "train_step"])
def test_grad_clip_per_group_matches_the_reference(clip, mode):
    """3 AdamW steps with a clip over two parameter groups: the clip is
    applied to each group's gradients apart, in the eager ``step`` and in
    ``TrainStep``."""
    jn, pn = _nets()
    jclip, pclip = (f() for f in CLIPS[clip])
    jopt = P.optimizer.AdamW(learning_rate=0.05, parameters=_groups(jn),
                             grad_clip=jclip)
    popt = AdamW(learning_rate=0.05, parameters=_groups(pn),
                 grad_clip=pclip)
    x, y = _data()
    jx, jy = P.to_tensor(x), P.to_tensor(y)
    px, py = torch.as_tensor(x), torch.as_tensor(y)
    if mode == "eager":
        for _ in range(3):
            loss = JFn.mse_loss(jn(jx), jy)
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            ploss = torch.mean((pn(px) - py) ** 2)
            ploss.backward()
            popt.step()
            popt.clear_grad()
    else:
        jstep = P.jit.TrainStep(jn, lambda m, a, b: JFn.mse_loss(m(a), b),
                                jopt)
        pstep = TrainStep(pn, lambda m, a, b: torch.mean((m(a) - b) ** 2),
                          popt)
        for _ in range(3):
            jstep(jx, jy)
            pstep(px, py)
    for k, v in pn.state_dict().items():
        ref = np.asarray(jn.state_dict()[k]._value)
        np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)
