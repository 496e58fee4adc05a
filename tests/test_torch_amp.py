"""The port's AMP (``paddle_tpu_torch/amp``) against the JAX package's, on
the CPU.

- O1 and O2 casts, op by op, for every op of the training paths the port
  tags (``linear``, ``embedding``, ``layer_norm``, ``rms_norm``,
  ``fused_rope``, ``flash_attention``, ``sdpa``, ``gelu``, ``dropout``,
  ``cross_entropy``, the swiglu MLP's ``silu`` / ``multiply``, the residual
  ``add``): each output's dtype equals the reference's, its values within
  bf16's rounding (2^-6 of the largest |value|: both round the same
  products to bf16, at other places).  Custom white and black lists, and
  float16 (through the plain versions here; a CUDA kernel refuses float16
  naming ROADMAP F16).
- ``decorate``: which parameters O2 casts (LayerNorm's stay float32,
  RMSNorm's do not) and ``multi_precision`` switched on.
- The eager ``GradScaler`` against the reference's over 9 steps with
  injected infs: scale, good and bad counts, ``state_dict`` and the weights
  (float32, 1e-6).
- ``TrainStep(scaler=)`` on a 2-layer Llama under O2 bf16 (``decorate``,
  ``AdamW`` with ``ClipGradByGlobalNorm`` and a ``LinearWarmup`` schedule,
  a dynamic ``GradScaler``) with one step forced to overflow (the loss
  times an inf from the batch), against the reference's ``TrainStep``:
  losses within 2e-2 relative, the scaler's state equal, every parameter
  within one bf16 ulp of its tensor's largest |w| for all but 1e-2 of its
  elements (the worst tensor has 0.45% outside) and within that plus 2 lr
  steps at the most, Adam's state tensor by tensor (the step count equal,
  moment1 and moment2 within 5e-2 of the reference's norm, the masters'
  update within 0.15 of the reference's update's norm; measured 1.2%, 2.1%
  and 5.4%) and, across the overflow step, the port's parameters, masters
  and moments bit for bit unchanged.  The moments carry the unscale and the
  clip's factor (the global norm is about 3, so the clip scales by about a
  third); an update that did nothing would miss by its own size.
- Recompute under AMP: the recomputed layers run under the forward's AMP
  state, so the gradients equal a run without recompute bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import apply_rotary_pos_emb as jax_rope
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as pllama
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr

torch.set_num_threads(2)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32")._value)


def _dt(t):
    return (str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor)
            else str(np.dtype(t._value.dtype)))


def _gen():
    return dict(device="cpu", generator=torch.Generator())


# ------------------------------------------------------------- op by op
def _linear():
    x, w, b = _x(1, 4, 8), _x(2, 8, 6), _x(3, 6)
    return (lambda: JF.linear(P.to_tensor(x), P.to_tensor(w), P.to_tensor(b)),
            lambda: F.linear(*(torch.as_tensor(a) for a in (x, w, b))))


def _layer(jl, pl, x):
    pnn.load_numpy_state_dict(pl, {k: np.asarray(v._value)
                                   for k, v in jl.state_dict().items()})
    return (lambda: jl(P.to_tensor(x)), lambda: pl(torch.as_tensor(x)))


def _embedding():
    P.seed(0)
    ids = np.array([[1, 5, 7], [2, 0, 9]], np.int32)
    jl, pl = jnn.Embedding(10, 4), pnn.Embedding(10, 4, **_gen())
    pnn.load_numpy_state_dict(pl, {"weight": np.asarray(jl.weight._value)})
    return (lambda: jl(P.to_tensor(ids)),
            lambda: pl(torch.as_tensor(ids).long()))


def _attention(fn):
    q, k, v = (_x(i, 2, 8, 2, 16) for i in range(3))

    def run(mod, conv):
        args = [conv(a) for a in (q, k, v)]
        if fn == "flash":
            return mod.flash_attention(*args, causal=True)[0]
        return mod.scaled_dot_product_attention(*args, is_causal=True)
    return (lambda: run(JF, P.to_tensor), lambda: run(F, torch.as_tensor))


def _rope():
    q, k = _x(4, 2, 8, 2, 16), _x(5, 2, 8, 2, 16)
    cfg = jax_llama_tiny()
    cos, sin = (a[:16, :8] for a in pllama._rope_cache(
        pllama.LlamaConfig(**dataclasses.asdict(cfg))))
    return (lambda: jax_rope(*(P.to_tensor(a) for a in (q, k, cos, sin)))[0],
            lambda: pllama.apply_rotary_pos_emb(
                *(torch.as_tensor(a) for a in (q, k, cos, sin)))[0])


def _cross_entropy():
    x = _x(6, 5, 7)
    y = np.array([0, 3, 6, 2, 1], np.int64)
    return (lambda: JF.cross_entropy(P.to_tensor(x), P.to_tensor(y)),
            lambda: F.cross_entropy(torch.as_tensor(x), torch.as_tensor(y)))


def _dropout():
    x = _x(7, 6, 9)

    def ref():
        P.seed(3)
        return JF.dropout(P.to_tensor(x), 0.2)

    def ours():
        from paddle_tpu_torch.framework import random as prand

        prand.seed(3)
        return F.dropout(torch.as_tensor(x), 0.2)
    return ref, ours


def _mlp():
    """Llama's MLP: the reference's silu(gate) * up, the port's K3."""
    from paddle_tpu.models.llama import LlamaMLP as JaxMLP

    cfg = jax_llama_tiny()
    P.seed(1)
    jm = JaxMLP(cfg)
    pcfg = pllama.LlamaConfig(**dataclasses.asdict(cfg))
    pm = pllama.LlamaMLP(pcfg, pllama._Init(torch.device("cpu"),
                                            torch.float32,
                                            torch.Generator()))
    return _layer(jm, pm, _x(8, 2, 3, cfg.hidden_size))


def _add():
    from paddle_tpu_torch.nn.transformer import _add as padd

    a, b = _x(9, 4, 5), _x(10, 4, 5)
    return (lambda: P.to_tensor(a) + P.to_tensor(b).astype("bfloat16"),
            lambda: padd(torch.as_tensor(a),
                         torch.as_tensor(b).to(torch.bfloat16)))


OPS = {
    "linear": _linear,
    "embedding": _embedding,
    "layer_norm": lambda: _layer(jnn.LayerNorm(12),
                                 pnn.LayerNorm(12, device="cpu"),
                                 _x(11, 3, 12)),
    "rms_norm": lambda: _layer(jnn.RMSNorm(12),
                               pnn.RMSNorm(12, device="cpu",
                                           dtype=torch.float32),
                               _x(12, 3, 12)),
    "gelu": lambda: (lambda: JF.gelu(P.to_tensor(_x(13, 4, 6))),
                     lambda: F.gelu(torch.as_tensor(_x(13, 4, 6)))),
    "flash_attention": lambda: _attention("flash"),
    "sdpa": lambda: _attention("sdpa"),
    "fused_rope": _rope,
    "cross_entropy": _cross_entropy,
    "dropout": _dropout,
    "silu_multiply": _mlp,
    "add": _add,
}


def _compare(ref, ours):
    assert _dt(ours) == _dt(ref)
    r = _f32(ref)
    np.testing.assert_allclose(_f32(ours), r, rtol=0,
                               atol=2 ** -6 * max(float(np.abs(r).max()),
                                                  1e-6))


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", list(OPS))
def test_op_casts_match_the_reference(op, level):
    ref_fn, port_fn = OPS[op]()
    with P.amp.auto_cast(level=level):
        ref = ref_fn()
    with pamp.auto_cast(level=level):
        assert pamp.is_auto_cast_enabled()
        assert pamp.get_amp_dtype() == "bfloat16"
        ours = port_fn()
    assert not pamp.is_auto_cast_enabled()
    _compare(ref, ours)


@pytest.mark.parametrize("lists", [
    dict(custom_white_list={"gelu"}),
    dict(custom_black_list={"linear"}, level="O2"),
    dict(custom_white_list={"cross_entropy"}),
    dict(custom_black_list={"sdpa"}),
])
def test_custom_lists_match_the_reference(lists):
    for op in ("gelu", "linear", "cross_entropy", "sdpa"):
        ref_fn, port_fn = OPS[op]()
        with P.amp.auto_cast(**lists):
            ref = ref_fn()
        with pamp.auto_cast(**lists):
            ours = port_fn()
        _compare(ref, ours)


def test_float16_runs_the_plain_versions_and_kernels_name_f16():
    from paddle_tpu_torch.ops.hopper import _build

    for op in ("linear", "rms_norm", "fused_rope", "flash_attention"):
        ref_fn, port_fn = OPS[op]()
        with P.amp.auto_cast(level="O2", dtype="float16"):
            ref = ref_fn()
        with pamp.auto_cast(level="O2", dtype="float16"):
            ours = port_fn()
        assert _dt(ours) == _dt(ref)
        r = _f32(ref)
        np.testing.assert_allclose(_f32(ours), r, rtol=0,
                                   atol=2 ** -9 * float(np.abs(r).max()))
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops
    from paddle_tpu_torch.ops.hopper import int8_matmul as b7

    f16 = torch.float16
    with pytest.raises(TypeError, match="F16"):
        _build.dtype_code("rms_norm", torch.zeros(1, dtype=f16))
    with pytest.raises(ValueError, match="F16"):
        fused_norm.rms_plan(4, 64, f16, True)
    with pytest.raises(ValueError, match="F16"):
        fused_ops.rope_plan(1, 4, 2, 2, 16, f16, True)
    with pytest.raises(TypeError, match="F16"):
        b7._check(torch.zeros(2, 4, dtype=f16),
                  torch.zeros(4, 4, dtype=torch.int8), torch.ones(4))
    with pytest.raises(ValueError):
        pamp.auto_cast(level="O3")


# ------------------------------------------------------------- decorate
class _JaxEnc(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.lin = jnn.Linear(8, 8)
        self.ln = jnn.LayerNorm(8)
        self.rms = jnn.RMSNorm(8)


class _PortEnc(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = pnn.Linear(8, 8, **_gen())
        self.ln = pnn.LayerNorm(8, device="cpu")
        self.rms = pnn.RMSNorm(8, device="cpu", dtype=torch.float32)


def test_decorate_casts_what_the_reference_casts():
    jm, pm = _JaxEnc(), _PortEnc()
    jopt = P.optimizer.AdamW(parameters=jm.parameters())
    popt = AdamW(parameters=pm.parameters())
    jm2, jopt2 = P.amp.decorate(jm, jopt, level="O2")
    pm2, popt2 = pamp.decorate(pm, popt, level="O2")
    assert pm2 is pm and popt2 is popt
    assert popt._multi_precision and jopt._multi_precision
    ref = {k: str(np.dtype(v._value.dtype)) for k, v in
           jm.state_dict().items()}
    ours = {k: _dt(v) for k, v in pm.state_dict().items()}
    assert ours == ref
    assert ours["ln.weight"] == "float32" and ours["rms.weight"] == "bfloat16"
    # O1 casts nothing; master_weight=False leaves the optimizer
    pm3, popt3 = _PortEnc(), AdamW(parameters=_PortEnc().parameters())
    pamp.decorate(pm3, popt3, level="O1")
    assert all(p.dtype == torch.float32 for p in pm3.parameters())
    pamp.decorate(pm3, popt3, level="O2", master_weight=False)
    assert not popt3._multi_precision


# ---------------------------------------------------------- eager scaler
def test_eager_grad_scaler_matches_the_reference():
    P.seed(2)
    jl = jnn.Linear(4, 3)
    pl = pnn.Linear(4, 3, **_gen())
    pnn.load_numpy_state_dict(pl, {k: np.asarray(v._value)
                                   for k, v in jl.state_dict().items()})
    kw = dict(init_loss_scaling=256.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js, ps = P.amp.GradScaler(**kw), pamp.GradScaler(**kw)
    jopt = P.optimizer.AdamW(learning_rate=0.01, parameters=jl.parameters())
    popt = AdamW(learning_rate=0.01, parameters=pl.parameters())
    poison = [1, 1, 1, 1, np.inf, 1, np.inf, np.inf, 1]
    for i, f in enumerate(poison):
        x = _x(20 + i, 5, 4)
        jloss = (jl(P.to_tensor(x)) ** 2).mean() * float(f)
        ploss = (pl(torch.as_tensor(x)) ** 2).mean() * float(f)
        js.minimize(jopt, js.scale(jloss))
        ps.minimize(popt, ps.scale(ploss))
        jopt.clear_grad()
        popt.clear_grad()
        assert ps.state_dict() == {k: (float(v) if k == "scale" else v)
                                   for k, v in js.state_dict().items()}, i
    assert ps.get_loss_scaling() == 256.0 * 2 / 2   # one rise, one fall
    for k, v in pl.state_dict().items():
        ref = np.asarray(jl.state_dict()[k]._value)
        np.testing.assert_allclose(v.detach().numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    # load_state_dict takes the scale and the counts, as the reference's
    again, jagain = pamp.GradScaler(), P.amp.GradScaler()
    again.load_state_dict(ps.state_dict())
    jagain.load_state_dict(js.state_dict())
    assert again.state_dict() == jagain.state_dict()
    assert again.get_loss_scaling() == ps.get_loss_scaling()


# ----------------------------------------------------- TrainStep under O2
LR, WARM = 2e-3, 2


def _models(recompute=False):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(5)
    jm = JaxLlama(jax_llama_tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = pllama.LlamaConfig(**{**dataclasses.asdict(jm.config),
                                "recompute": recompute})
    pm = pllama.load_numpy_state_dict(
        pllama.LlamaForCausalLM(cfg, device="cpu"), sd)
    return jm, pm


def _assert_adam_state(jm, pm, jopt, popt, w0, upd_tol, mom_tol):
    """Adam's state against the reference's, tensor by tensor: the step
    count equal, moment1 and moment2 within ``mom_tol`` of the reference's
    norm, and the update (the master weight, else the parameter, minus its
    start ``w0``) within ``upd_tol`` of the reference's update's norm."""
    for (name, a), (pname, b) in zip(jm.named_parameters(),
                                     pm.named_parameters()):
        assert name == pname
        for acc in ("beta_pow", "moment1", "moment2"):
            ref = np.asarray(jopt._accumulators[acc][id(a)]).astype(
                np.float32)
            got = _f32(popt._accumulators[acc][id(b)])
            if acc == "beta_pow":
                assert np.array_equal(got, ref), name
                continue
            assert (np.linalg.norm(got - ref)
                    <= mom_tol * np.linalg.norm(ref)), (name, acc)
        ref = np.asarray(jopt._master_weights.get(id(a), a._value)).astype(
            np.float32) - w0[name]
        got = _f32(popt._master_weights.get(id(b), b)) - w0[name]
        assert np.linalg.norm(ref) > 0, name
        assert np.linalg.norm(got - ref) <= upd_tol * np.linalg.norm(ref), \
            name


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(LR, T_max=8), WARM, 0.0, LR)


def test_train_step_with_scaler_under_o2_matches_the_reference():
    jm, pm = _models()
    jopt = P.optimizer.AdamW(learning_rate=_sched(P.optimizer.lr),
                             parameters=jm.parameters(),
                             grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    popt = AdamW(learning_rate=_sched(plr), parameters=pm.parameters(),
                 grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    jm, jopt = P.amp.decorate(jm, jopt, level="O2")
    pm, popt = pamp.decorate(pm, popt, level="O2")
    w0 = {k: _f32(v) for k, v in jm.named_parameters()}
    kw = dict(init_loss_scaling=2.0 ** 12, incr_every_n_steps=2)
    js, ps = P.amp.GradScaler(**kw), pamp.GradScaler(**kw)
    jcrit, pcrit = JaxCrit(), pllama.LlamaPretrainingCriterion()

    def jloss(m, ids, poison):
        with P.amp.auto_cast(level="O2"):
            return jcrit(m(ids), ids) * poison

    def ploss(m, ids, poison):
        with pamp.auto_cast(level="O2"):
            return pcrit(m(ids), ids) * poison

    jstep = P.jit.TrainStep(jm, jloss, jopt, scaler=js)
    pstep = TrainStep(pm, ploss, popt, scaler=ps)
    ids = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(np.int32)
    poison = [1.0, 1.0, 1.0, np.inf, 1.0, 1.0]
    jl, pl = [], []
    for i, f in enumerate(poison):
        if f != 1.0:
            before = ({k: v.clone() for k, v in pm.state_dict().items()},
                      {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in popt.state_dict().items()})
        jl.append(float(_f32(jstep(P.to_tensor(ids),
                                   P.to_tensor(np.float32(f))))))
        pl.append(float(pstep(torch.as_tensor(ids),
                              torch.tensor(f, dtype=torch.float32))))
        assert ps.state_dict() == js.state_dict() | {
            "scale": float(_f32(js._scale)),
            "incr_count": int(np.asarray(js._good_steps)),
            "decr_count": int(np.asarray(js._bad_steps))}, i
        if f != 1.0:
            after = pm.state_dict(), popt.state_dict()
            for k, v in before[0].items():
                assert torch.equal(v, after[0][k]), k
            for k, v in before[1].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, after[1][k]), k
        for s in (jopt, popt):
            s._learning_rate.step()
    assert not np.isfinite(pl[3]) and not np.isfinite(jl[3])
    fin = [i for i, f in enumerate(poison) if f == 1.0]
    np.testing.assert_allclose([pl[i] for i in fin], [jl[i] for i in fin],
                               rtol=2e-2)
    assert pl[-1] < pl[0]
    # the scale doubled after steps 2 and (after the overflow halved it)
    # never again within 2 good steps
    assert ps.get_loss_scaling() == 2.0 ** 12 * 2 / 2 * 2
    drift = 2 * LR * len(fin)
    for k, v in pm.state_dict().items():
        ref = _f32(jm.state_dict()[k])
        assert _dt(v) == _dt(jm.state_dict()[k]), k
        err = np.abs(_f32(v) - ref)
        ulp = 2 ** -7 * float(np.abs(ref).max())
        assert float(err.max()) <= ulp + drift, k
        assert float(np.mean(err > ulp)) <= 1e-2, k
    _assert_adam_state(jm, pm, jopt, popt, w0, upd_tol=0.15, mom_tol=5e-2)


def test_recompute_keeps_the_amp_state():
    """Under O2 the recomputed layers cast as in the forward (else their
    dtypes would differ and checkpoint would refuse them): the gradients
    with recompute equal those without, bit for bit."""
    grads = []
    for recompute in (False, True):
        _, pm = _models(recompute)
        pamp.decorate(pm, level="O2")
        pm.train()
        ids = torch.as_tensor(np.random.default_rng(7).integers(
            0, 512, (2, 12)))
        with pamp.auto_cast(level="O2"):
            loss = pllama.LlamaPretrainingCriterion()(pm(ids), ids)
        loss.backward()
        grads.append([p.grad.clone() for p in pm.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------- C16: decode steps under O1
def _o1():
    return (P.amp.auto_cast(level="O1", dtype="bfloat16"),
            pamp.auto_cast(level="O1", dtype="bfloat16"))


def _cache_pair(jm, pm, B, L, static):
    import jax.numpy as jnp
    from paddle_tpu.tensor.tensor import Tensor

    cfg = pm.config
    shape = (B, L if static else 0, cfg.num_key_value_heads, cfg.head_dim)
    jc = [(Tensor(jnp.zeros(shape, jnp.float32)),
           Tensor(jnp.zeros(shape, jnp.float32)))
          + ((Tensor(jnp.zeros((), jnp.int32)),) if static else ())
          for _ in range(cfg.num_hidden_layers)]
    pc = [(torch.zeros(shape), torch.zeros(shape))
          + ((torch.zeros((), dtype=torch.int32),) if static else ())
          for _ in range(cfg.num_hidden_layers)]
    return jc, pc


@pytest.mark.parametrize("static", [False, True], ids=["growing", "ring"])
def test_c16_decode_step_under_o1_matches_the_reference(static):
    """A float32 Llama under O1 bf16: a 7-token prefill, then one decode
    step, over growing caches and over the static ring.  The reference
    projects a decode step's q, k and v with one ``qkv_fused`` product, on
    neither AMP list, so in float32; its prefill projects in bf16 and its
    ring write casts the rotated rows into the float32 ring (rounded, then
    widened).  Every cache row keeps the reference's dtype.  The first
    layer reads the embedding, the same bits on both sides, so its rows
    (the prefill's and the step's) lie within the suite's float32
    tolerance, 1e-5 of the largest |value| + 1e-5 (the port's three bf16
    projections put the step's row 3.7e-3 of max |k| away; measured now
    7.2e-7); the ring's prefill rows are bf16 values.  The second layer
    reads the first one's bf16 attention and MLP, which the two sides
    round at other places (one bf16 ulp), so its rows and the logits are
    held to the file's bf16 rule, 2^-6 of the largest |value|."""
    jm, pm = _models()
    ids = np.random.default_rng(16).integers(0, 512, (2, 8)).astype(np.int32)
    jc, pc = _cache_pair(jm, pm, 2, 16, static)
    ja, pa = _o1()
    with ja, pa, torch.no_grad():
        for lo, hi in ((0, 7), (7, 8)):
            jl, jc = jm(P.to_tensor(ids[:, lo:hi]), caches=jc)
            pl, pc = pm(torch.as_tensor(ids[:, lo:hi]), caches=pc)
            assert _dt(pl) == _dt(jl)
            _compare(jl, pl)
    for layer, (jt, pt) in enumerate(zip(jc, pc)):
        for j, p in zip(jt[:2], pt[:2]):
            assert _dt(p) == _dt(j) == "float32"
            ref, got = _f32(j)[:, :8], _f32(p)[:, :8]
            tol = (1e-5 * np.abs(ref).max() + 1e-5 if layer == 0
                   else 2 ** -6 * np.abs(ref).max())
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
            if static:
                rows = p[:, :7]
                assert torch.equal(rows.bfloat16().float(), rows)
        if static:
            assert int(pt[2]) == int(np.asarray(jt[2]._value)) == 8


def test_c16_greedy_tokens_under_o1_match_the_reference():
    """Greedy tokens over 8 steps under O1 bf16: ``generate`` over growing
    caches and over the ring, and ``greedy_decode``, equal the
    reference's."""
    from paddle_tpu.models.generation import generate as jgen
    from paddle_tpu.models.generation import greedy_decode as jgreedy
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    jm, pm = _models()
    jm.eval()
    ids = np.random.default_rng(17).integers(0, 512, (2, 7)).astype(np.int32)
    ja, pa = _o1()
    with ja, pa:
        for static in (False, True):
            ref = np.asarray(jgen(jm, P.to_tensor(ids), max_new_tokens=8,
                                  use_static_cache=static)._value)
            ours = generate(pm, torch.as_tensor(ids), max_new_tokens=8,
                            use_static_cache=static)
            np.testing.assert_array_equal(ours.numpy(), ref)
        ref = np.asarray(jgreedy(jm, P.to_tensor(ids), 8)._value)
        np.testing.assert_array_equal(
            greedy_decode(pm, torch.as_tensor(ids), 8).numpy(), ref)
