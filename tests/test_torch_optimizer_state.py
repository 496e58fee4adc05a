"""Queue C13: ``Optimizer.set_state_dict`` keeps each saved state's dtype,
as the reference's does (``paddle_tpu/optimizer/optimizer.py:187-191``).

For every optimizer of the port but LBFGS (whose state is its step count
alone), over bfloat16 parameters without master weights and, where the
optimizer takes them, with them: two steps, ``state_dict`` ->
``set_state_dict`` into a fresh optimizer, two more steps, on both
packages from the same numpy parameters and gradients.  The state comes
either from the port's own ``state_dict`` or from the reference's, as
numpy (a bfloat16 state is an ``ml_dtypes`` array there; the reference's
parameters are copied in with it).

- Every state tensor's dtype equals the reference's after the load and
  after the steps.  On the tree before this fix the port widened every
  state to float32, so Adam's bfloat16 moments failed here.
- The port's run through the round trip equals the port's run without
  one, bit for bit; a state loaded from the reference's numpy equals the
  reference's bit for bit.
- Values against the reference after the four steps: with master weights
  (the same float32 arithmetic) within 1e-6 of each tensor's largest
  |value|; without them within 3e-2 (bfloat16 ops round at other places in
  XLA's fusions and JAX rounds Python scalars to bfloat16 first: see
  ``tests/test_torch_optimizers.py``; measured 2.0e-2 for Adadelta, whose
  eps of 1e-6 is rounded to bfloat16 in the reference, and at most 9.7e-3
  for the others).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu_torch import optimizer as popt

torch.set_num_threads(2)

SHAPES = [(5, 4), (9,)]
NAMES = ["Adam", "AdamW", "SGD", "Momentum", "Adamax", "Adagrad",
         "Adadelta", "RMSProp", "Lamb", "Lars", "ASGD", "Rprop", "NAdam",
         "RAdam"]
NO_MASTER = {"Adamax", "Adagrad", "Adadelta", "RMSProp"}
KW = {"Momentum": dict(use_nesterov=True), "RMSProp": dict(centered=True,
                                                           momentum=0.5),
      "Adagrad": dict(initial_accumulator_value=0.1)}
CASES = [(n, mp, src) for n in NAMES
         for mp in ((False,) if n in NO_MASTER else (False, True))
         for src in ("port", "reference")]


def _data():
    rng = np.random.default_rng(21)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
          for _ in range(4)]
    return ws, gs


def _bf16(a):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        torch.bfloat16)


def _kw(name, mp):
    kw = dict(KW.get(name, {}), learning_rate=0.05)
    if name not in NO_MASTER:
        kw["multi_precision"] = mp
    return kw


def _feed(params, grads, jax_side):
    for p, g in zip(params, grads):
        p.grad = (P.Tensor(jnp.asarray(g).astype("bfloat16")) if jax_side
                  else _bf16(g))


def _states(opt):
    return {k: v for k, v in opt.state_dict().items()
            if k not in ("@step", "LR_Scheduler")}


def _ref_dtypes(jo):
    return {k: f"torch.{np.asarray(v._value).dtype}"
            for k, v in _states(jo).items()}


@pytest.mark.parametrize("name,mp,source", CASES)
def test_set_state_dict_keeps_the_saved_dtype(name, mp, source):
    ws, gs = _data()
    jcls, pcls = getattr(P.optimizer, name), getattr(popt, name)
    jps = [P.Tensor(jnp.asarray(w).astype("bfloat16"), stop_gradient=False,
                    name=f"param_{i}") for i, w in enumerate(ws)]
    pps = [torch.nn.Parameter(_bf16(w)) for w in ws]
    twin = [torch.nn.Parameter(_bf16(w)) for w in ws]
    jo, po = jcls(parameters=jps, **_kw(name, mp)), pcls(
        parameters=pps, **_kw(name, mp))
    to = pcls(parameters=twin, **_kw(name, mp))
    for g in gs[:2]:
        _feed(jps, g, True)
        _feed(pps, g, False)
        _feed(twin, g, False)
        jo.step()
        po.step()
        to.step()
    jsd = jo.state_dict()
    jo = jcls(parameters=jps, **_kw(name, mp))
    jo.set_state_dict(jsd)
    saved = po.state_dict()
    po = pcls(parameters=pps, **_kw(name, mp))
    if source == "port":
        po.set_state_dict(saved)
        for k, v in _states(po).items():
            assert v.dtype == saved[k].dtype, k
            assert torch.equal(v, saved[k]), k
    else:
        with torch.no_grad():
            for p, jp in zip(pps, jps):
                p.copy_(_bf16(jp._value))
        po.set_state_dict({k: (np.asarray(v._value) if hasattr(v, "_value")
                               else v) for k, v in jsd.items()})
        for k, v in _states(po).items():
            ref = np.asarray(jsd[k]._value).astype(np.float32)
            assert np.array_equal(v.float().numpy(), ref), k
    assert po._step_count == 2
    want = _ref_dtypes(jo)
    assert {k: str(v.dtype) for k, v in _states(po).items()} == want
    for g in gs[2:]:
        _feed(jps, g, True)
        _feed(pps, g, False)
        _feed(twin, g, False)
        jo.step()
        po.step()
        to.step()
    js, ps = _states(jo), _states(po)
    assert {k: str(v.dtype) for k, v in ps.items()} == _ref_dtypes(jo)
    if source == "port":
        ts = _states(to)
        assert set(ts) == set(ps)
        for k, v in ps.items():
            assert torch.equal(v, ts[k]), k
        for a, b in zip(pps, twin):
            assert torch.equal(a, b)
    rel = 1e-6 if mp else 3e-2
    for k, v in ps.items():
        ref = np.asarray(js[k]._value).astype(np.float32)
        err = np.abs(v.float().numpy() - ref).max()
        assert err <= rel * np.abs(ref).max() + 1e-30, (k, err)


def test_lbfgs_state_is_its_step_count():
    """LBFGS keeps no accumulator (its history is not part of the
    reference's ``state_dict`` either): the step count round-trips."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = popt.LBFGS(parameters=[w], max_iter=2)

    def closure():
        loss = ((w - 2.0) ** 2).sum()
        loss.backward()
        return loss

    opt.step(closure)
    sd = opt.state_dict()
    assert sd == {"@step": 1}
    again = popt.LBFGS(parameters=[w])
    again.set_state_dict(sd)
    assert again._step_count == 1 and w.dtype == torch.float32
