"""The port's training path (paddle_tpu_torch) against the JAX package's, on
the CPU: ``LlamaForCausalLM`` + ``LlamaPretrainingCriterion`` gradients,
``recompute``, ``pretraining_loss``, ``AdamW``/``Adam`` with
``multi_precision=True`` and
``TrainStep`` (``__call__`` and ``run_steps``), and the rule that the
inference entry points record no graph.

Both models carry the same weights (the JAX model's state_dict, moved by
``load_numpy_state_dict``); token ids come from a numpy seed.  The
reference's gradients are ``jax.grad`` over its parameters' values, as its
``TrainStep`` takes them: its eager tape drops the tied head's share of
the embedding gradient (``LlamaForCausalLM.forward`` wraps the transposed
weight in a fresh Tensor), which the compiled step does not.  The port runs
every kernel's plain version here (K1-K3 forward, their backwards, B1/B8,
and AdamW's plain update on the CPU).

Tolerances:
- float32 loss and gradients: 1e-4 of the largest |value| of each tensor
  (XLA and PyTorch sum the projections and attention in different orders;
  the error follows the size of the summed terms).
- float32 weights after AdamW steps: 1e-4 of each tensor's largest |w| for
  all but 1e-4 of the elements.  Adam moves an element by about ``lr`` a
  step whatever its gradient's size, so where a gradient is within float
  noise of zero its sign, and the step, may differ; such elements stay
  within 2 * lr * steps.
- bfloat16: losses within 2e-2 relative.  Weights: at most 5% of each
  tensor's elements lie more than one bf16 ulp of their own value from the
  reference's, and each tensor's change over the steps (w - w0) is within
  20% of the reference's change in L2 norm, so a missing, stale or
  wrongly rounded bfloat16 write fails (the runs measured ~3% and at most
  5% of the change for the matrices, 14% for the [128] norm weights, whose
  bf16 steps are quantized).  No element is further off than one bf16 ulp
  of the largest |w| plus 2 * lr * steps.  The port adds each residual in
  float32 inside the next norm (K1); the reference adds in bfloat16 first.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.generation import generate, greedy_decode
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import (
    LlamaPretrainingCriterion,
    load_numpy_state_dict,
)
from paddle_tpu_torch.optimizer import Adam, AdamW

torch.set_num_threads(2)

KINDS = {"mha": {}, "gqa": dict(num_key_value_heads=2),
         "tied": dict(tie_word_embeddings=True)}
LR, STEPS = 1e-3, 5


def _jax_model(seed, **kw):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**kw))
    if jm.config.dtype == "bfloat16":
        jm.bfloat16()
    return jm


def _port_of(jm, **over):
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = PortConfig(**{**dataclasses.asdict(jm.config), **over})
    return load_numpy_state_dict(PortLlama(cfg, device="cpu"), sd)


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (kind, kw) in enumerate(KINDS.items()):
        jm = _jax_model(i, **kw)
        out[kind] = (jm, _port_of(jm))
    return out


def _ids(seed, B=2, S=12, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _np(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


def _close(ours, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + 1e-7, err


def _port_loss(pm, ids):
    crit = LlamaPretrainingCriterion()
    t = torch.as_tensor(ids)
    return crit(pm(t), t)


@pytest.mark.parametrize("kind", list(KINDS))
def test_backward_matches_jax(models, kind):
    """One backward of the criterion: the loss and every parameter's
    gradient equal the reference's."""
    import jax

    from paddle_tpu.autograd import tape
    from paddle_tpu.jit.api import _SwapValues

    jm, pm = models[kind]
    ids = _ids(1)
    jt = P.to_tensor(ids)
    names, params = zip(*jm.named_parameters())

    def f(vals):
        with _SwapValues(list(params), vals), tape.no_grad():
            return JaxCriterion()(jm(jt), jt)._value

    jloss, jg = jax.value_and_grad(f)([p._value for p in params])
    jgrads = dict(zip(names, map(np.asarray, jg)))
    pm.zero_grad(set_to_none=True)
    loss = _port_loss(pm, ids)
    loss.backward()
    _close(loss.item(), _np(jloss))
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        _close(g, jgrads[n])
    pm.zero_grad(set_to_none=True)


def _grads(pm, ids):
    pm.zero_grad(set_to_none=True)
    loss = _port_loss(pm, ids)
    loss.backward()
    out = {n: p.grad.clone() for n, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    return loss.detach(), out


def test_recompute_gives_the_same_gradients(models):
    """config.recompute checkpoints each decoder layer: its forward runs
    again in the backward, and loss and gradients are unchanged."""
    jm, plain = models["gqa"]
    rec = _port_of(jm, recompute=True)
    calls = []
    for layer in rec.llama.layers:
        # a pre-hook: the replay stops once it has rebuilt what the
        # backward needs, before a forward hook would fire
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    ids = _ids(2)
    l0, g0 = _grads(plain, ids)
    l1, g1 = _grads(rec, ids)
    assert len(calls) == 2 * len(rec.llama.layers)
    assert torch.equal(l0, l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)


def test_pretraining_loss_equals_the_criterion(models):
    _, pm = models["mha"]
    ids = _ids(3, B=2, S=13)         # 24 shifted tokens, padded to 8 chunks
    crit_loss, crit_grads = _grads(pm, ids)
    pm.zero_grad(set_to_none=True)
    loss = pm.pretraining_loss(torch.as_tensor(ids), n_chunks=5)
    loss.backward()
    _close(loss.item(), crit_loss.item(), 1e-6)
    for n, p in pm.named_parameters():
        _close(p.grad.numpy(), crit_grads[n].numpy())
    pm.zero_grad(set_to_none=True)


# (the JAX optimizer, the port's, their keyword arguments)
OPTS = {"AdamW": (P.optimizer.AdamW, AdamW, {}),
        "Adam": (P.optimizer.Adam, Adam, dict(weight_decay=0.01))}


def _jax_train(jm, ids, steps, opt_name="AdamW"):
    cls, _, kw = OPTS[opt_name]
    opt = cls(learning_rate=LR, parameters=jm.parameters(),
              multi_precision=True, **kw)
    crit = JaxCriterion()
    step = P.jit.TrainStep(jm, lambda m, x: crit(m(x), x), opt)
    losses = [float(_np(step(P.to_tensor(ids)))) for _ in range(steps)]
    return losses, {k: _np(v).astype(np.float32)
                    for k, v in jm.state_dict().items()}


def _port_train(pm, ids, steps, opt_name="AdamW"):
    _, cls, kw = OPTS[opt_name]
    opt = cls(learning_rate=LR, parameters=pm.parameters(),
              multi_precision=True, **kw)
    crit = LlamaPretrainingCriterion()
    step = TrainStep(pm, lambda m, x: crit(m(x), x), opt)
    losses = [float(step(torch.as_tensor(ids))) for _ in range(steps)]
    return losses, {k: v.float().numpy()
                    for k, v in pm.state_dict().items()}


@pytest.mark.parametrize("dtype,opt_name", [("float32", "AdamW"),
                                            ("bfloat16", "AdamW"),
                                            ("float32", "Adam")])
def test_train_steps_match_jax_train_step(dtype, opt_name):
    """5 steps of TrainStep + AdamW (or Adam with its L2 decay), both with
    multi_precision=True, on one batch: the losses and the final weights
    equal the JAX TrainStep's."""
    jm = _jax_model(4, dtype=dtype)
    pm = _port_of(jm)
    w0 = {k: _np(v).astype(np.float32) for k, v in jm.state_dict().items()}
    ids = _ids(5)
    jl, jw = _jax_train(jm, ids, STEPS, opt_name)
    pl, pw = _port_train(pm, ids, STEPS, opt_name)
    assert pl[-1] < pl[0]
    drift = 2 * LR * STEPS
    if dtype == "float32":
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        n_out = n_all = 0
        for k, w in pw.items():
            err = np.abs(w - jw[k])
            tol = 1e-4 * float(np.abs(jw[k]).max())
            n_out += int((err > tol).sum())
            n_all += err.size
            assert float(err.max()) <= tol + drift, k
        assert n_out <= 1e-4 * n_all, (n_out, n_all)
    else:
        np.testing.assert_allclose(pl, jl, rtol=2e-2)
        for k, w in pw.items():
            err = np.abs(w - jw[k])
            ulp = 2 ** -7 * float(np.abs(jw[k]).max())
            assert float(err.max()) <= ulp + drift, k
            own_ulp = np.exp2(np.floor(np.log2(
                np.maximum(np.abs(jw[k]), 2.0 ** -126))) - 7)
            assert float(np.mean(err > own_ulp)) <= 0.05, k
            dj = jw[k] - w0[k]
            assert np.linalg.norm(dj) > 0, k
            assert (np.linalg.norm((w - w0[k]) - dj)
                    <= 0.2 * np.linalg.norm(dj)), k


def test_run_steps_equals_single_steps(models):
    jm, _ = models["mha"]
    ids = np.stack([_ids(6 + i) for i in range(3)])
    a, b = _port_of(jm), _port_of(jm)
    crit = LlamaPretrainingCriterion()
    loss_fn = lambda m, x: crit(m(x), x)  # noqa: E731
    sa = TrainStep(a, loss_fn, AdamW(learning_rate=LR,
                                     parameters=a.parameters()))
    sb = TrainStep(b, loss_fn, AdamW(learning_rate=LR,
                                     parameters=b.parameters()))
    losses = sa.run_steps(torch.as_tensor(ids))
    single = torch.stack([sb(torch.as_tensor(x)) for x in ids])
    assert losses.shape == (3,)
    assert torch.equal(losses, single)
    assert sa.optimizer._step_count == sb.optimizer._step_count == 3
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
        assert pa.grad is None


def test_optimizer_state_dict_keys_match_the_reference(models):
    """The same accumulator, master-weight and step keys, parameter by
    parameter (the reference names a parameter by its generated name, the
    port by position: both are mapped to the position)."""
    jm = _jax_model(7, dtype="bfloat16")
    pm = _port_of(jm)
    jopt = P.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                             multi_precision=True)
    jopt._ensure_state()
    pos = {p.name: f"param_{i}" for i, p in enumerate(jm.parameters())}

    def norm(key):
        if "__" not in key:
            return key
        name, acc = key.rsplit("__", 1)
        return f"{pos[name]}__{acc}"

    ref = {norm(k): v for k, v in jopt.state_dict().items()}
    opt = AdamW(learning_rate=LR, parameters=pm.parameters(),
                multi_precision=True)
    opt._ensure_state()
    ours = opt.state_dict()
    assert set(ours) == set(ref)
    for k, v in ours.items():
        if k != "@step":
            assert tuple(v.shape) == tuple(_np(ref[k]).shape), k
            assert v.dtype == torch.float32
    # a round trip through set_state_dict
    again = AdamW(learning_rate=LR, parameters=pm.parameters(),
                  multi_precision=True)
    again.set_state_dict(ours)
    assert set(again.state_dict()) == set(ours)


def test_unported_options_raise():
    """``grad_clip`` and ``TrainStep(scaler=)``, refused before AMP and the
    clips were ported, now compute: 3 float32 TrainSteps with
    ClipGradByGlobalNorm(0.5) and a dynamic GradScaler (doubling after 2
    good steps) give the reference's losses, weights and scaler state
    (the float32 tolerances above)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    jm = _jax_model(7)
    pm = _port_of(jm)
    ids = _ids(8)
    jopt = P.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                             grad_clip=P.nn.ClipGradByGlobalNorm(0.5))
    jscaler = P.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=2)
    jcrit = JaxCriterion()
    jstep = P.jit.TrainStep(jm, lambda m, x: jcrit(m(x), x), jopt,
                            scaler=jscaler)
    opt = AdamW(learning_rate=LR, parameters=pm.parameters(),
                grad_clip=ClipGradByGlobalNorm(0.5))
    scaler = GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    crit = LlamaPretrainingCriterion()
    step = TrainStep(pm, lambda m, x: crit(m(x), x), opt, scaler=scaler)
    jl = [float(_np(jstep(P.to_tensor(ids)))) for _ in range(3)]
    pl = [float(step(torch.as_tensor(ids))) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert scaler.get_loss_scaling() == float(_np(jscaler._scale)) == 2048.0
    assert scaler.state_dict()["incr_count"] == 1
    jw = {k: _np(v) for k, v in jm.state_dict().items()}
    for k, v in pm.state_dict().items():
        err = np.abs(v.numpy() - jw[k])
        assert float(err.max()) <= (1e-4 * float(np.abs(jw[k]).max())
                                    + 2 * LR * 3), k


def test_inference_records_no_graph(models):
    """Serving, generate and greedy_decode leave every .grad None and give
    tensors without a graph, though the parameters require grad."""
    _, pm = models["mha"]
    assert all(p.requires_grad for p in pm.parameters())
    pm.zero_grad(set_to_none=True)
    ids = torch.as_tensor(_ids(9, B=2, S=5))
    eng = ServingEngine(pm, device="cpu", max_batch_size=2, max_seq_len=32,
                        block_size=8, token_budget=16)
    eng.add_request(ids[0].tolist(), max_new_tokens=3)
    eng.run()
    for out in (generate(pm, ids, max_new_tokens=3),
                generate(pm, ids, max_new_tokens=3, use_static_cache=True),
                greedy_decode(pm, ids, max_new_tokens=3)):
        assert out.grad_fn is None and not out.requires_grad
    assert all(p.grad is None for p in pm.parameters())


def test_lr_scheduler_drives_the_learning_rate():
    """An LRScheduler as learning_rate: get_lr reads it, run_steps holds
    one rate for the window, and the state_dict carries it, as the
    reference's."""
    from paddle_tpu.optimizer.lr import LRScheduler as JaxScheduler
    from paddle_tpu_torch.optimizer.lr import LRScheduler

    def halving(base):
        class Halving(base):
            def get_lr(self):
                return self.base_lr * 0.5 ** self.last_epoch
        return Halving(learning_rate=0.1)

    pm = PortLlama(PortConfig(vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=2), device="cpu")
    ours, ref = halving(LRScheduler), halving(JaxScheduler)
    opt = AdamW(learning_rate=ours, parameters=pm.parameters())
    jopt = P.optimizer.AdamW(learning_rate=ref,
                             parameters=[P.to_tensor(np.zeros(2))])
    for _ in range(3):
        assert opt.get_lr() == jopt.get_lr()
        ours.step()
        ref.step()
    assert opt.state_dict()["LR_Scheduler"] == jopt.state_dict()[
        "LR_Scheduler"]
