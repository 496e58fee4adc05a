"""The port's ``save`` / ``load`` (``paddle_tpu_torch/framework_io.py``)
against the JAX package's ``paddle_tpu.framework_io``, on the CPU: a file
saved by either package loads in the other, exactly.

Covered leaves: float32, int64 (the reference's JAX, without 64-bit types,
holds its tensors as int32; a numpy int64 payload it wrote stays int64),
bool, nested dicts, lists and tuples with Python values beside the
tensors, a model's ``state_dict``, an optimizer's state (AdamW over
bfloat16 parameters without master weights: bfloat16 moments, a float32
step count, a scheduler's state) and bfloat16 leaves.  The port writes a
bfloat16 leaf as its exact float32 values with ``"dtype": "bfloat16"``
(no ``ml_dtypes`` on the card's machine) and reads it back as bfloat16;
the reference reads those values as float32.  A bfloat16 leaf the
reference wrote (an ``ml_dtypes`` array) loads in the port as bfloat16
with the same bits.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as ptt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay

torch.set_num_threads(2)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nested_port():
    return {"w": torch.as_tensor(_x(0, 3, 4)),
            "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "mask": torch.tensor([True, False]),
            "half": torch.as_tensor(_x(1, 5)).to(torch.bfloat16),
            "inner": {"list": [torch.ones(2), 3, "name"],
                      "tuple": (torch.zeros(1), 2.5)},
            "epoch": 7}


def _f32(t):
    return np.asarray(t._value if hasattr(t, "_value") else t).astype(
        np.float32)


def test_a_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.pdparams")
    obj = _nested_port()
    ptt.save(obj, path)
    ref = P.load(path)
    assert np.array_equal(np.asarray(ref["w"]._value), obj["w"].numpy())
    assert np.array_equal(np.asarray(ref["ids"]._value), obj["ids"].numpy())
    assert np.array_equal(np.asarray(ref["mask"]._value),
                          obj["mask"].numpy())
    # the bfloat16 leaf as its float32 values
    assert np.array_equal(np.asarray(ref["half"]._value),
                          obj["half"].float().numpy())
    assert np.array_equal(np.asarray(ref["inner"]["list"][0]._value),
                          np.ones(2, np.float32))
    assert ref["inner"]["list"][1:] == [3, "name"]
    assert isinstance(ref["inner"]["tuple"], tuple)
    assert ref["inner"]["tuple"][1] == 2.5 and ref["epoch"] == 7
    raw = P.load(path, return_numpy=True)
    assert raw["ids"].dtype == np.int64 and raw["half"].dtype == np.float32


def test_a_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    half = jnp.asarray(_x(2, 4, 3)).astype("bfloat16")
    obj = {"w": P.to_tensor(_x(3, 2, 2)),
           "ids": np.arange(4, dtype=np.int64),
           "half": P.Tensor(half),
           "nested": {"a": [P.to_tensor(np.int32(5)), 1]}}
    P.save(obj, path)
    got = ptt.load(path)
    assert got["w"].dtype == torch.float32
    assert np.array_equal(got["w"].numpy(), _x(3, 2, 2))
    assert isinstance(got["ids"], np.ndarray)     # a numpy leaf stays numpy
    assert got["half"].dtype == torch.bfloat16
    bits = np.asarray(half).view(np.int16)
    assert np.array_equal(got["half"].view(torch.int16).numpy(), bits)
    assert int(got["nested"]["a"][0]) == 5 and got["nested"]["a"][1] == 1
    raw = ptt.load(path, return_numpy=True)
    assert raw["half"].dtype.name == "bfloat16"


def test_the_port_round_trip_is_exact(tmp_path):
    path = str(tmp_path / "rt.pdparams")
    obj = _nested_port()
    obj["param"] = torch.nn.Parameter(torch.as_tensor(_x(4, 3)))
    ptt.save(obj, path)
    got = ptt.load(path)
    for k in ("w", "ids", "mask", "half"):
        assert got[k].dtype == obj[k].dtype and torch.equal(got[k], obj[k])
    assert isinstance(got["param"], torch.nn.Parameter)
    assert got["param"].requires_grad
    assert torch.equal(got["param"], obj["param"])
    assert not isinstance(got["w"], torch.nn.Parameter)
    assert got["inner"]["list"][1:] == [3, "name"]
    with open(path, "rb") as f:
        leaf = pickle.load(f)["half"]
    assert leaf["__paddle_tpu_tensor__"] and leaf["dtype"] == "bfloat16"
    assert leaf["data"].dtype == np.float32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_optimizer_state_crosses_both_ways(tmp_path, writer):
    """AdamW over bfloat16 parameters without master weights, a StepDecay
    schedule, two steps on each side: the state saved by one package and
    loaded by the other keeps its keys, dtypes and values."""
    ws = [_x(5, 4, 3), _x(6, 3)]
    gs = [_x(7, 4, 3), _x(8, 3)]
    path = str(tmp_path / "opt.pdopt")
    if writer == "port":
        ps = [torch.nn.Parameter(torch.as_tensor(w).to(torch.bfloat16))
              for w in ws]
        opt = AdamW(learning_rate=StepDecay(0.1, 1), parameters=ps)
        for _ in range(2):
            for p, g in zip(ps, gs):
                p.grad = torch.as_tensor(g).to(torch.bfloat16)
            opt.step()
        sd = opt.state_dict()
        ptt.save(sd, path)
        ref = P.load(path)
        assert set(ref) == set(sd)
        assert ref["LR_Scheduler"] == sd["LR_Scheduler"]
        for k, v in sd.items():
            if isinstance(v, torch.Tensor):
                assert np.array_equal(_f32(ref[k]), v.float().numpy()), k
        again = ptt.load(path)
        for k, v in sd.items():
            if isinstance(v, torch.Tensor):
                assert again[k].dtype == v.dtype, k
                assert torch.equal(again[k], v.cpu()), k
    else:
        js = [P.Tensor(jnp.asarray(w).astype("bfloat16"),
                       stop_gradient=False, name=f"param_{i}")
              for i, w in enumerate(ws)]
        jopt = P.optimizer.AdamW(learning_rate=P.optimizer.lr.StepDecay(
            0.1, 1), parameters=js)
        for _ in range(2):
            for p, g in zip(js, gs):
                p.grad = P.Tensor(jnp.asarray(g).astype("bfloat16"))
            jopt.step()
        sd = jopt.state_dict()
        P.save(sd, path)
        got = ptt.load(path)
        assert set(got) == set(sd)
        ps = [torch.nn.Parameter(torch.zeros(w.shape, dtype=torch.bfloat16))
              for w in ws]
        opt = AdamW(learning_rate=StepDecay(0.1, 1), parameters=ps)
        opt.set_state_dict(got)
        mine = opt.state_dict()
        for k, v in sd.items():
            if hasattr(v, "_value"):
                ref = np.asarray(v._value)
                assert str(mine[k].dtype) == f"torch.{ref.dtype}", k
                assert np.array_equal(mine[k].float().numpy(),
                                      ref.astype(np.float32)), k
        assert mine["@step"] == 2
        assert opt._learning_rate.last_epoch == \
            jopt._learning_rate.last_epoch
