"""The port's 13 other optimizers (``paddle_tpu_torch/optimizer/
optimizers.py``: SGD, Momentum, Adamax, Adagrad, Adadelta, RMSProp, Lamb,
Lars, LBFGS, ASGD, Rprop, NAdam, RAdam) against the JAX package's, on the
CPU, from the same numpy parameters and gradients.

- Eager ``step`` over 5 steps with two parameter groups (the second at
  half the rate), in three modes: float32 with the weight decay each
  optimizer takes, a ``ClipGradByGlobalNorm`` and a ``StepDecay``
  schedule; bfloat16 parameters with float32 master weights
  (``multi_precision``, where the optimizer takes it); bfloat16 without
  them.  Every state tensor is compared by its reference key, its dtype
  equal to the reference's.
- LBFGS through ``step(closure)`` on a least-squares problem.
- ``TrainStep`` on a 2-layer Llama with a ``GradScaler``, one step forced
  to overflow: every parameter and every state tensor keeps its bits.
- Queue C14: the norm clips of a large gradient on the CPU.

Tolerances.  float32, and bfloat16 under master weights (the same float32
arithmetic in the same order): every state and master within 1e-6 of its
tensor's largest |value| (Lamb and Lars sum their norms in another order;
the runs measured 1.4e-7 at most, and 0 for the others), bfloat16
parameters within one bf16 ulp of their own value (a master one float32
ulp apart can round either way).  bfloat16 without master weights: JAX
rounds a Python scalar to bfloat16 before it multiplies a bfloat16 array
(0.9 becomes 0.8984375) and XLA's CPU fusions keep float32 between bf16
ops; torch multiplies by the float32 scalar and rounds each op.  So the
state lies within 2e-2 of its tensor's largest |value| (measured at most
1.2e-2: Rprop's step sizes compound 1.2 against 1.203125 over 5 steps),
and each parameter within 2 bf16 ulps of its tensor's largest |w|.
NAdam and RAdam there run without weight decay: the reference writes
their float32 update into the bfloat16 parameter, which turns it float32,
and a decayed gradient then turns the moments float32; the port's
parameter keeps its dtype.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import (
    LlamaPretrainingCriterion,
    load_numpy_state_dict,
)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.optimizer import lr as plr

torch.set_num_threads(2)

SHAPES = [(6, 5), (7,), (3, 2, 2)]
STEPS = 5

# name -> (constructor keywords, takes weight_decay, takes multi_precision)
OPTS = {
    "SGD": (dict(), True, True),
    "Momentum": (dict(momentum=0.8, use_nesterov=True), True, True),
    "Adamax": (dict(), True, False),
    "Adagrad": (dict(initial_accumulator_value=0.1), True, False),
    "Adadelta": (dict(rho=0.9), True, False),
    "RMSProp": (dict(centered=True, momentum=0.5), True, False),
    "Lamb": (dict(lamb_weight_decay=0.02), False, True),
    "Lars": (dict(lars_coeff=0.01), False, True),
    "ASGD": (dict(batch_num=3), True, True),
    "Rprop": (dict(), False, True),
    "NAdam": (dict(), True, True),
    "RAdam": (dict(), True, True),
}
LRS = {"SGD": 0.1, "Momentum": 0.1, "Adagrad": 0.1, "Adadelta": 1.0,
       "Lars": 0.5, "ASGD": 0.1}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[(rng.standard_normal(s) * (1 + i)).astype(np.float32)
           for i, s in enumerate(SHAPES)] for _ in range(STEPS)]
    return ws, gs


def _groups(params):
    return [{"params": params[:2]},
            {"params": params[2:], "learning_rate": 0.5}]


def _make(name, mode):
    """The two optimizers over the same parameters, and those
    parameters."""
    kw, wd, mp = OPTS[name]
    kw = dict(kw)
    dtype = "float32" if mode == "float32" else "bfloat16"
    ws, gs = _data()
    jps = [P.Tensor(jnp.asarray(w).astype(dtype), stop_gradient=False,
                    name=f"param_{i}") for i, w in enumerate(ws)]
    pps = [torch.nn.Parameter(torch.as_tensor(w).to(getattr(torch, dtype)))
           for w in ws]
    jlr = plr_ = LRS.get(name, 0.01)
    if mode == "float32":
        jlr = P.optimizer.lr.StepDecay(jlr, step_size=2, gamma=0.5)
        plr_ = plr.StepDecay(plr_, step_size=2, gamma=0.5)
        kw_j = dict(kw, grad_clip=P.nn.ClipGradByGlobalNorm(2.0))
        kw_p = dict(kw, grad_clip=ClipGradByGlobalNorm(2.0))
    else:
        kw_j, kw_p = dict(kw), dict(kw)
    decay = wd and not (mode == "bf16" and name in ("NAdam", "RAdam"))
    for k in (kw_j, kw_p):
        if decay:
            k["weight_decay"] = 0.01
        if mp:
            k["multi_precision"] = mode == "bf16_master"
    jo = getattr(P.optimizer, name)(learning_rate=jlr,
                                    parameters=_groups(jps), **kw_j)
    po = getattr(popt, name)(learning_rate=plr_, parameters=_groups(pps),
                             **kw_p)
    return jo, po, jps, pps, gs, dtype


def _steps(jo, po, jps, pps, gs, dtype):
    for g in gs:
        for t, x in zip(jps, g):
            t.grad = P.Tensor(jnp.asarray(x).astype(dtype))
        for t, x in zip(pps, g):
            t.grad = torch.as_tensor(x).to(getattr(torch, dtype))
        jo.step()
        po.step()
        for o in (jo, po):
            if not isinstance(o._learning_rate, float):
                o._learning_rate.step()


def _f32(t):
    return np.asarray(t._value).astype(np.float32)


def _ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _compare(jo, po, jps, pps, mode):
    js, ps = jo.state_dict(), po.state_dict()
    assert set(ps) == set(js)
    assert ps["@step"] == js["@step"] == STEPS
    for k, v in ps.items():
        if k in ("@step", "LR_Scheduler"):
            continue
        ref = np.asarray(js[k]._value)
        assert str(v.dtype) == f"torch.{ref.dtype}", k
        a, b = v.float().numpy(), ref.astype(np.float32)
        rel = 2e-2 if mode == "bf16" else 1e-6
        assert np.abs(a - b).max() <= rel * np.abs(b).max() + 1e-30, k
    for i, (jp, pp) in enumerate(zip(jps, pps)):
        a, b = pp.detach().float().numpy(), _f32(jp)
        if mode == "float32":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
        elif mode == "bf16_master":
            assert np.all(np.abs(a - b) <= _ulp(b)), i
        else:
            assert np.abs(a - b).max() <= 2 * _ulp(np.abs(b).max()), i


CASES = [(n, m) for n, (_, _, mp) in OPTS.items()
         for m in (("float32", "bf16_master", "bf16") if mp
                   else ("float32", "bf16"))]


@pytest.mark.parametrize("name,mode", CASES)
def test_optimizer_matches_the_reference(name, mode):
    jo, po, jps, pps, gs, dtype = _make(name, mode)
    _steps(jo, po, jps, pps, gs, dtype)
    _compare(jo, po, jps, pps, mode)
    # the state moved: a step that did nothing would fail the comparison
    ws, _ = _data()
    for w, pp in zip(ws, pps):
        assert not np.array_equal(pp.detach().float().numpy(),
                                  torch.as_tensor(w).to(pp.dtype).float()
                                  .numpy())


def _lsq(seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((12, 5)) / 3).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    w0 = rng.standard_normal((5,)).astype(np.float32) * 0.1
    return a, b, w0


@pytest.mark.parametrize("history", [100, 2])
def test_lbfgs_matches_the_reference(history):
    """Two ``step(closure)`` calls on 0.5 |A w - b|^2 + 0.1 |w|^2 (the
    closure computes the loss and calls backward): the same loss and
    weights as the reference's (1e-5 relative: the line search reads the
    same floats; the dot products sum in another order)."""
    a, b, w0 = _lsq()
    jw = P.Tensor(jnp.asarray(w0), stop_gradient=False, name="param_0")
    pw = torch.nn.Parameter(torch.tensor(w0))
    ja, jb = P.to_tensor(a), P.to_tensor(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    jo = P.optimizer.LBFGS(learning_rate=1.0, max_iter=4,
                           history_size=history, parameters=[jw])
    po = popt.LBFGS(learning_rate=1.0, max_iter=4, history_size=history,
                    parameters=[pw])

    def jclosure():
        r = P.matmul(ja, jw) - jb
        loss = 0.5 * (r * r).sum() + 0.1 * (jw * jw).sum()
        loss.backward()
        return loss

    def pclosure():
        r = ta @ pw - tb
        loss = 0.5 * (r * r).sum() + 0.1 * (pw * pw).sum()
        loss.backward()
        return loss

    for _ in range(2):
        jl = float(jo.step(jclosure).numpy())
        pl = float(po.step(pclosure))
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        np.testing.assert_allclose(pw.detach().numpy(), _f32(jw), rtol=1e-5,
                                   atol=1e-6)
    assert po._step_count == 2 and len(po._s_hist) <= history
    assert not np.allclose(pw.detach().numpy(), w0)


def _llama(seed):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(seed)
    jm = JaxLlama(jax_llama_tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = PortConfig(**dataclasses.asdict(jm.config))
    return load_numpy_state_dict(PortLlama(cfg, device="cpu"), sd)


@pytest.mark.parametrize("name", list(OPTS))
def test_train_step_overflow_keeps_every_state(name):
    """2 float32 ``TrainStep``s under a dynamic ``GradScaler``, then a step
    whose loss is multiplied by inf: every parameter and every state
    tensor keeps its bits and the step counts stay; the next finite step
    moves them again."""
    model = _llama(11)
    kw, wd, _ = OPTS[name]
    opt = getattr(popt, name)(learning_rate=LRS.get(name, 0.01),
                              parameters=model.parameters(),
                              grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, lambda m, x, k: crit(m(x), x) * k, opt,
                     scaler=GradScaler(init_loss_scaling=256.0))
    ids = torch.as_tensor(np.random.default_rng(12).integers(
        0, 512, (2, 12)))
    one, inf = torch.ones(()), torch.full((), float("inf"))
    for _ in range(2):
        assert torch.isfinite(step(ids, one))
    snap = ({n: p.detach().clone() for n, p in model.named_parameters()},
            {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in opt.state_dict().items()})
    assert not torch.isfinite(step(ids, inf))
    for n, p in model.named_parameters():
        assert torch.equal(p, snap[0][n]), n
    after = opt.state_dict()
    assert set(after) == set(snap[1])
    for k, v in after.items():
        if isinstance(v, torch.Tensor):
            old = snap[1][k]
            assert v.dtype == old.dtype and torch.equal(v, old), k
    assert torch.isfinite(step(ids, one))
    moved = sum(not torch.equal(p, snap[0][n])
                for n, p in model.named_parameters())
    assert moved > 0


@pytest.mark.parametrize("clip", ["global_norm", "norm"])
def test_a_large_gradients_clip_scale_matches_the_reference(clip):
    """Queue C14: the clips' norms of a [256, 4096] gradient on the CPU (a
    narrow Llama's lm_head has that shape).  torch's CPU norm kernel sums
    float32 squares in one pass: 1e-5 of the norm off at 1M elements, 2e-4
    for an lm_head gradient.  Now the clipped gradient lies within 1e-6
    of the clip computed in float64, and within 2e-6 of the reference's
    (XLA's float32 sum is 1.3e-6 off the float64 norm here)."""
    rng = np.random.default_rng(41)
    g = (rng.standard_normal((256, 4096)) * 1e-3).astype(np.float32)
    g[:, :8] += rng.standard_normal((256, 8)).astype(np.float32)
    small = rng.standard_normal((7,)).astype(np.float32)
    xs = (g, small)
    if clip == "global_norm":
        ref_clip, ours = P.nn.ClipGradByGlobalNorm(1.0), \
            ClipGradByGlobalNorm(1.0)
        total = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in xs))
        exact = [x / total for x in xs]
    else:
        ref_clip, ours = P.nn.ClipGradByNorm(1.0), ClipGradByNorm(1.0)
        exact = [x / np.sqrt((x.astype(np.float64) ** 2).sum())
                 for x in xs]
    jp = [(P.to_tensor(np.zeros_like(x)), P.to_tensor(x)) for x in xs]
    pp = [(torch.nn.Parameter(torch.zeros(x.shape)), torch.as_tensor(x))
          for x in xs]
    for (_, a), (_, b), e in zip(ours(pp), ref_clip(jp), exact):
        ref = np.asarray(b._value)
        np.testing.assert_allclose(a.numpy(), e, rtol=0,
                                   atol=1e-6 * np.abs(e).max())
        np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
