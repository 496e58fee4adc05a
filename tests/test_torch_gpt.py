"""The port's GPT family (``paddle_tpu_torch/models/gpt.py``) against the
JAX package's ``paddle_tpu/models/gpt.py``, on the CPU at ``gpt_tiny``
(2 layers, hidden 128, 4 heads, vocab 512).

Both models carry the same weights (the JAX model's ``state_dict`` moved
by ``load_numpy_state_dict``); token ids come from a numpy seed.  The port
runs its kernels' plain versions here: B1 (causal flash attention, also a
cached step's Sq < Sk) and B8 (its backward) through ``F.flash_attention``,
the plain masked attention under an ``attn_mask``, and AdamW's plain
update on the CPU.

Tolerances: float32 logits within 1e-5 of the largest |logit| (XLA and
PyTorch sum the products in different orders); ``dtype="bfloat16"``
(the embeddings' sum rounded to bfloat16, then the first norm in
bfloat16) within 2e-2, with the reference's output dtype.  The criterion
within 1e-5 relative.  Three ``TrainStep``s of AdamW: the losses within
1e-5 relative; the parameters within 1e-5 of each tensor's largest |w|
plus the steps' reach (lr x steps: a bias starts at 0, so its largest
|w| is a few steps) for all but 1e-4 of the elements, and every element
within 2 lr steps a step.  Adam moves an element by about lr a step
whatever its gradient's size, so where a gradient is within float noise
of zero its sign, and the step, may differ (the runs: 26 of 560k
elements, at most 4.8e-5).  The k third of ``qkv.bias`` is all such
elements: its gradient is 0 in exact arithmetic (the softmax over keys
ignores a shift every key shares), so it is held to the 2 lr steps
only.  Tokens are compared exactly: greedy argmaxes, and
sampled tokens, which both sides draw with threefry under the same keys.
Under AMP (``ParallelLinear``'s bias under O1 / O2: 1e-2; the growing
caches under O2, C15: 2e-2) the bfloat16 products round in both, with
the reference's dtypes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.distributed.fleet.mp_layers import (
    ColumnParallelLinear as JaxColumn,
)
from paddle_tpu.distributed.fleet.mp_layers import RowParallelLinear as JaxRow
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.generation import greedy_decode as jax_greedy
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch.framework.random import Generator
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    GPTConfig,
    GPTForCausalLM,
    GPTPretrainingCriterion,
    generate,
    gpt3_1_3b,
    gpt_tiny,
    greedy_decode,
)
from paddle_tpu_torch.nn import ParallelLinear, load_numpy_state_dict
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

LR, STEPS = 1e-3, 3


def _jax_model(seed=0, **kw):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(seed)
    return JaxGPT(jax_gpt_tiny(**kw))


def _sd(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _port_of(jm):
    cfg = GPTConfig(**dataclasses.asdict(jm.config))
    return load_numpy_state_dict(GPTForCausalLM(cfg, device="cpu"), _sd(jm))


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = _jax_model(dtype=dtype)
        jm.eval()
        pm = _port_of(jm)
        pm.eval()
        out[dtype] = (jm, pm)
    return out


def _ids(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _np(x):
    v = np.asarray(x._value if hasattr(x, "_value") else x)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _f32(t):
    return t.detach().float().numpy()


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + rel, err


def test_state_dict_loads_one_for_one():
    """The reference's keys are the port's, in order, with the same shapes
    (the 3-major qkv included); a missing or extra key is refused."""
    jm = _jax_model()
    sd = _sd(jm)
    pm = GPTForCausalLM(GPTConfig(**dataclasses.asdict(jm.config)),
                        device="cpu")
    assert list(pm.state_dict()) == list(sd)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: v.shape for k, v in sd.items()}
    load_numpy_state_dict(pm, sd)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    with pytest.raises(KeyError, match="gpt.h.0.attn.qkv.bias"):
        load_numpy_state_dict(pm, {k: v for k, v in sd.items()
                                   if k != "gpt.h.0.attn.qkv.bias"})


def test_num_params_match_the_reference():
    jm = _jax_model()
    pm = _port_of(jm)
    assert pm.num_params == jm.num_params == 560640
    assert len(list(pm.parameters())) == 2 + 12 * 2 + 2 + 1
    # gpt3_1_3b's count from the layers' shapes, without building it
    c = gpt3_1_3b()
    h, f, v = c.hidden_size, c.intermediate_size, c.vocab_size
    block = (h * 3 * h + 3 * h) + (h * h + h) + 4 * h + (h * f + f) \
        + (f * h + h)
    assert (v * h + c.max_position_embeddings * h + c.num_hidden_layers
            * block + 2 * h + h * v) == 1_418_842_112


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(models, dtype):
    jm, pm = models[dtype]
    ids = _ids(1)
    ref = jm(P.to_tensor(ids))
    with torch.no_grad():
        ours = pm(torch.as_tensor(ids))
    assert str(ours.dtype).split(".")[-1] == ref._value.dtype.name
    _close(_f32(ours), _np(ref), 1e-5 if dtype == "float32" else 2e-2)


def test_attn_mask_forward_matches_jax(models):
    """An additive mask takes the plain attention on both sides."""
    jm, pm = models["float32"]
    ids = _ids(2, S=10)
    rng = np.random.default_rng(3)
    mask = np.where(np.tril(np.ones((10, 10), bool))[None, None]
                    & (rng.random((2, 1, 10, 10)) > 0.2), 0.0,
                    -1e9).astype(np.float32)
    mask[..., 0] = 0.0                    # every row sees a key
    ref = _np(jm(P.to_tensor(ids), P.to_tensor(mask)))
    with torch.no_grad():
        ours = pm(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    _close(ours, ref, 1e-5)
    with torch.no_grad():
        causal = pm(torch.as_tensor(ids)).numpy()
    assert np.abs(ours - causal).max() > 1e-3     # the mask acted


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_steps_match_jax(models, dtype):
    """A prefill over empty caches in the config's dtype, then a
    one-token step: the logits, the positions (offset by the cache's
    length) and the caches' dtypes (bfloat16 zeros concatenated with
    float32 keys give float32, as jnp's promotion)."""
    import jax.numpy as jnp

    from paddle_tpu.tensor.tensor import Tensor

    jm, pm = models[dtype]
    ids = _ids(4, S=7)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jc = [(Tensor(jnp.zeros((2, 0, 4, 32), jdt)),
           Tensor(jnp.zeros((2, 0, 4, 32), jdt))) for _ in range(2)]
    pc = [(torch.zeros((2, 0, 4, 32), dtype=pdt),
           torch.zeros((2, 0, 4, 32), dtype=pdt)) for _ in range(2)]
    tol = 1e-5 if dtype == "float32" else 2e-2
    for step in (ids, ids[:, 3:4]):
        jl, jc = jm(P.to_tensor(step), caches=jc)
        with torch.no_grad():
            pl, pc = pm(torch.as_tensor(step), caches=pc)
        _close(_f32(pl), _np(jl), tol)
        for (pk, pv), (jk, jv) in zip(pc, jc):
            assert str(pk.dtype).split(".")[-1] == jk._value.dtype.name
            _close(_f32(pk), _np(jk), tol)
            _close(_f32(pv), _np(jv), tol)
    assert pc[0][0].shape[1] == 8


def test_criterion_matches_jax(models):
    jm, pm = models["float32"]
    ids = _ids(5)
    ref = float(_np(JaxCriterion()(jm(P.to_tensor(ids)), P.to_tensor(ids))))
    with torch.no_grad():
        t = torch.as_tensor(ids)
        ours = float(GPTPretrainingCriterion()(pm(t), t))
    assert abs(ours - ref) <= 1e-5 * abs(ref)


def _jax_train(jm, ids):
    opt = P.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters())
    crit = JaxCriterion()
    step = P.jit.TrainStep(jm, lambda m, x: crit(m(x), x), opt)
    losses = [float(_np(step(P.to_tensor(ids)))) for _ in range(STEPS)]
    return losses, {k: _np(v) for k, v in jm.state_dict().items()}


def _port_train(pm, ids):
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    crit = GPTPretrainingCriterion()
    step = TrainStep(pm, lambda m, x: crit(m(x), x), opt)
    losses = [float(step(torch.as_tensor(ids))) for _ in range(STEPS)]
    return losses, {k: v.numpy() for k, v in pm.state_dict().items()}


@pytest.mark.parametrize("recompute", [False, True])
def test_train_steps_match_jax_train_step(recompute):
    jm = _jax_model(6, recompute=recompute)
    pm = _port_of(jm)
    assert pm.config.recompute is recompute
    ids = _ids(7)
    jl, jw = _jax_train(jm, ids)
    pl, pw = _port_train(pm, ids)
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    n_out = n_all = 0
    for k, w in pw.items():
        err = np.abs(w - jw[k])
        assert float(err.max()) <= 2 * LR * STEPS, k
        if k.endswith("qkv.bias"):
            err = np.delete(err, np.s_[128:256])   # the k third: noise
        tol = 1e-5 * (float(np.abs(jw[k]).max()) + LR * STEPS)
        n_out += int((err > tol).sum())
        n_all += err.size
    assert n_out <= 1e-4 * n_all, (n_out, n_all)


def test_recompute_launches_the_forward_again():
    """Under recompute each block's attention runs again in the backward
    (B1's plain version here): 2 forward calls a layer, not 1."""
    from paddle_tpu_torch.nn import functional as PF

    counts = []
    real = PF.flash_attention

    def counting(*a, **k):
        counts.append(1)
        return real(*a, **k)

    for recompute in (False, True):
        pm = GPTForCausalLM(gpt_tiny(recompute=recompute), device="cpu")
        counts.clear()
        PF.flash_attention = counting
        try:
            t = torch.as_tensor(_ids(8))
            GPTPretrainingCriterion()(pm(t), t).backward()
        finally:
            PF.flash_attention = real
        assert len(counts) == (4 if recompute else 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_greedy_matches_jax(models, dtype):
    jm, pm = models[dtype]
    ids = _ids(9, S=6)
    ref = _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=6))
    ours = generate(pm, torch.as_tensor(ids), max_new_tokens=6).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_sampled_generate_matches_jax(models):
    """do_sample with top_p: Generator(7) gives the tokens JAX gives after
    P.seed(7) (one key per draw)."""
    jm, pm = models["float32"]
    ids = _ids(10, S=6)
    for top_p, temp in ((0.9, 1.0), (0.6, 0.7)):
        P.seed(7)
        ref = _np(jax_generate(jm, P.to_tensor(ids), max_new_tokens=6,
                               do_sample=True, top_p=top_p,
                               temperature=temp))
        gen = Generator(7)
        ours = generate(pm, torch.as_tensor(ids), max_new_tokens=6,
                        do_sample=True, top_p=top_p, temperature=temp,
                        generator=gen).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert gen.get_state() == (7, 6)
    greedy = generate(pm, torch.as_tensor(ids), max_new_tokens=6).numpy()
    assert (ours != greedy).any()       # the draws really sampled


def test_generate_equals_the_full_forward(models):
    """``tests/test_gpt.py``'s identity on the port: the last generated
    token is the argmax of a full forward over prompt + the tokens before
    it."""
    _, pm = models["float32"]
    ids = _ids(11, S=6)
    out = generate(pm, torch.as_tensor(ids), max_new_tokens=4).numpy()
    full = np.concatenate([ids, out[:, :-1]], axis=1)
    with torch.no_grad():
        logits = pm(torch.as_tensor(full))
    np.testing.assert_array_equal(out[:, -1],
                                  logits[:, -1].argmax(-1).numpy())


def test_static_paths_raise_as_the_reference(models):
    jm, pm = models["float32"]
    ids = _ids(12, B=1, S=4)
    with pytest.raises(ValueError, match="static KV"):
        generate(pm, torch.as_tensor(ids), max_new_tokens=4,
                 use_static_cache=True)
    with pytest.raises(ValueError, match="static KV"):
        jax_generate(jm, P.to_tensor(ids), max_new_tokens=4,
                     use_static_cache=True)
    with pytest.raises(ValueError, match="static KV"):
        greedy_decode(pm, torch.as_tensor(ids), max_new_tokens=4)
    with pytest.raises(ValueError, match="static KV"):
        jax_greedy(jm, P.to_tensor(ids), max_new_tokens=4)


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
def test_linear_promotes_two_float_dtypes_as_jnp(xdt, wdt):
    """A product of two float dtypes runs at the wider, the reference's
    ``v @ w + b`` under jnp's promotion (torch.matmul takes one dtype)."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as PF

    rng = np.random.default_rng(16)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    ref = JF.linear(P.to_tensor(x).astype(xdt), P.to_tensor(w).astype(wdt),
                    P.to_tensor(b))
    ours = PF.linear(torch.as_tensor(x).to(getattr(torch, xdt)),
                     torch.as_tensor(w).to(getattr(torch, wdt)),
                     torch.as_tensor(b))
    assert ours.dtype == torch.float32 == getattr(torch, ref._value.dtype.name)
    _close(_f32(ours), _np(ref), 1e-5)


@pytest.mark.parametrize("amp_level", [None, "O1", "O2"])
@pytest.mark.parametrize("row", [False, True], ids=["column", "row"])
def test_parallel_linear_bias_placement(row, amp_level):
    """The column form adds its bias inside the product's op, the row form
    after it as an "add": under O1 the column output is bfloat16, the row
    output float32 (a bfloat16 product plus a float32 bias); values and
    dtypes equal the reference's layers'."""
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((16, 8)) / 4).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jl = (JaxRow(16, 8, input_is_parallel=True) if row
          else JaxColumn(16, 8, gather_output=False))
    jl.set_state_dict({"weight": w, "bias": b})
    pl = ParallelLinear(16, 8, has_bias=True if row else None, row=row,
                        device="cpu", generator=torch.Generator())
    load_numpy_state_dict(pl, {"weight": w, "bias": b})
    assert list(pl.state_dict()) == ["weight", "bias"]
    if amp_level is None:
        ref = jl(P.to_tensor(x))
        with torch.no_grad():
            ours = pl(torch.as_tensor(x))
    else:
        with P.amp.auto_cast(level=amp_level, dtype="bfloat16"):
            ref = jl(P.to_tensor(x))
        with torch.no_grad(), pamp.auto_cast(level=amp_level,
                                             dtype="bfloat16"):
            ours = pl(torch.as_tensor(x))
    assert str(ours.dtype).split(".")[-1] == ref._value.dtype.name
    _close(_f32(ours), _np(ref), 1e-5 if amp_level is None else 1e-2)
    if amp_level == "O1":
        assert ours.dtype == (torch.float32 if row else torch.bfloat16)
    # the default keeps Llama's projections bias-free
    plain = ParallelLinear(16, 8, device="cpu", generator=torch.Generator())
    assert plain.bias is None and list(plain.state_dict()) == ["weight"]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_growing_caches_under_o2_keep_the_reference_dtype(family):
    """C15: under O2 a float32 cache (``generate`` starts one for a
    float32 config) grows through the reference's "concat", which AMP
    casts to bfloat16, so the returned caches are bfloat16; torch.cat
    promoted them to float32 (Llama's growing cache before this fix).
    The logits and the caches' values equal the reference's."""
    import jax.numpy as jnp

    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu.tensor.tensor import Tensor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    if family == "gpt":
        jm = _jax_model(14)
        pm = _port_of(jm)
    else:
        P.seed(14)
        jm = JaxLlama(jax_llama_tiny())
        pm = load_numpy_state_dict(
            LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jm.config)),
                             device="cpu"), _sd(jm))
    jm.eval()
    pm.eval()
    P.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    pamp.decorate(models=pm, level="O2", dtype="bfloat16")
    cfg = pm.config
    shape = (2, 0, cfg.num_key_value_heads, cfg.head_dim)
    jc = [(Tensor(jnp.zeros(shape, jnp.float32)),) * 2
          for _ in range(cfg.num_hidden_layers)]
    pc = [(torch.zeros(shape),) * 2 for _ in range(cfg.num_hidden_layers)]
    ids = _ids(15, S=5)
    with P.amp.auto_cast(level="O2", dtype="bfloat16"):
        jl, jc = jm(P.to_tensor(ids), caches=jc)
    with torch.no_grad(), pamp.auto_cast(level="O2", dtype="bfloat16"):
        pl, pc = pm(torch.as_tensor(ids), caches=pc)
    _close(_f32(pl), _np(jl), 2e-2)
    for (pk, pv), (jk, jv) in zip(pc, jc):
        assert jk._value.dtype.name == "bfloat16"
        assert pk.dtype == pv.dtype == torch.bfloat16
        _close(_f32(pk), _np(jk), 2e-2)
        _close(_f32(pv), _np(jv), 2e-2)
