"""The port's ``hapi.Model`` and callbacks (``paddle_tpu_torch/hapi``,
``paddle_tpu_torch.callbacks``) and its metrics (``paddle_tpu_torch.
metric``) against the JAX package's, on the CPU.

- ``Model.fit`` on a 2-layer float32 BERT classifier (bench_ladder.py's
  ``BertClassifier`` at hidden 64, dropout 0.1), AdamW through the
  ``TrainStep`` that ``train_batch`` builds, 2 epochs of 4 batches, an
  evaluation after each, ``Accuracy``: the history, the evaluation's loss
  and accuracy, ``predict``'s outputs and the weights against the
  reference's ``Model.fit`` from the same weights, data and seed (the
  port's loader with 0 and 2 workers, the reference's in process).
  Tolerances as ``tests/test_torch_dropout.py``'s float32 BERT: losses
  1e-5 relative, weights 1e-4 of each tensor's largest |w| for all but
  1e-3 of its elements (k_proj's bias, whose gradient is rounding noise,
  only within 2 lr steps), logits 1e-4 of their largest |value|,
  accuracy equal.
- ``accumulate_grad_batches=2`` (the eager backward, a step every two
  batches), without dropout: the same tolerances.
- The callbacks: ``EarlyStopping``'s stop epoch and ``ReduceLROnPlateau``'s
  rates over the same monitored values, ``LRScheduler`` by step and by
  epoch inside ``fit``, ``ModelCheckpoint``'s files (the same names as the
  reference's) and a fresh ``Model`` ``load``ed from the final one giving
  the trained model's logits and optimizer state bit for bit.
- ``summary``'s counts against the reference's.
- The metrics: ``accuracy``, ``Accuracy`` (top 1 and 2), ``Precision``,
  ``Recall`` and ``Auc`` equal the reference's exactly on seeded inputs.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import callbacks as pcb
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework import random as prand
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.transformer import (
    TransformerEncoder,
    TransformerEncoderLayer,
)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr

torch.set_num_threads(2)

VOCAB, H, HEADS, SEQ, LAYERS = 128, 64, 4, 16, 2
N_TRAIN, N_EVAL, BATCH, LR = 32, 16, 8, 1e-3


class _JaxBert(jnn.Layer):
    def __init__(self, dropout):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, H)
        self.pos = jnn.Embedding(SEQ, H)
        self.encoder = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
            H, HEADS, 4 * H, dropout=dropout, activation="gelu"), LAYERS)
        self.cls = jnn.Linear(H, 2)

    def forward(self, ids):
        x = self.embed(ids) + self.pos(P.arange(SEQ).astype("int32"))
        return self.cls(self.encoder(x)[:, 0])


class _PortBert(torch.nn.Module):
    def __init__(self, dropout):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator())
        self.embed = pnn.Embedding(VOCAB, H, **kw)
        self.pos = pnn.Embedding(SEQ, H, **kw)
        self.encoder = TransformerEncoder(TransformerEncoderLayer(
            H, HEADS, 4 * H, dropout=dropout, activation="gelu", **kw),
            LAYERS)
        self.cls = pnn.Linear(H, 2, **kw)

    def forward(self, ids):
        x = self.embed(ids) + self.pos(torch.arange(SEQ, device=ids.device))
        return self.cls(self.encoder(x)[:, 0])


def _nets(dropout=0.1):
    P.seed(0)
    jm = _JaxBert(dropout)
    pm = _PortBert(dropout)
    pnn.load_numpy_state_dict(pm, {k: np.asarray(v._value)
                                   for k, v in jm.state_dict().items()})
    return jm, pm


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (n, SEQ)).astype(np.int64),
            rng.integers(0, 2, (n,)).astype(np.int64))


def _datasets():
    tr, ev = _data(N_TRAIN, 1), _data(N_EVAL, 2)
    return ((pio.TensorDataset(list(tr)), pio.TensorDataset(list(ev))),
            (P.io.TensorDataset(list(tr)), P.io.TensorDataset(list(ev))))


def _models(dropout=0.1, opt_lr=LR):
    jm, pm = _nets(dropout)
    jmodel = P.Model(jm).prepare(
        P.optimizer.AdamW(learning_rate=opt_lr, parameters=jm.parameters()),
        lambda out, y: JF.cross_entropy(out, y), P.metric.Accuracy())
    pmodel = ptt.Model(pm).prepare(
        AdamW(learning_rate=opt_lr, parameters=pm.parameters()),
        F.cross_entropy, pmetric.Accuracy())
    return jmodel, pmodel


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value).astype(np.float32)


def _weights_close(jmodel, pmodel, steps):
    drift = 2 * LR * steps
    js = jmodel.network.state_dict()
    for k, v in pmodel.network.state_dict().items():
        ref = _f32(js[k])
        err = np.abs(_f32(v) - ref)
        tol = 1e-4 * float(np.abs(ref).max())
        assert float(err.max()) <= tol + drift, k
        if not k.endswith("k_proj.bias"):
            assert float(np.mean(err > tol)) <= 1e-3, k


def _seed(s):
    P.seed(s)
    prand.seed(s)


@pytest.mark.parametrize("workers", [0, 2])
def test_fit_evaluate_predict_match_the_reference(workers):
    (ptr, pev), (jtr, jev) = _datasets()
    jmodel, pmodel = _models()
    _seed(100)
    jh = jmodel.fit(jtr, jev, batch_size=BATCH, epochs=2, shuffle=False,
                    verbose=0)
    _seed(100)
    ph = pmodel.fit(ptr, pev, batch_size=BATCH, epochs=2, shuffle=False,
                    verbose=0, num_workers=workers)
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-5)
    assert prand.get_rng_state() == (100, 2 * N_TRAIN // BATCH)
    _weights_close(jmodel, pmodel, 2 * N_TRAIN // BATCH)
    jr = jmodel.evaluate(jev, batch_size=BATCH, verbose=0)
    pr = pmodel.evaluate(pev, batch_size=BATCH, verbose=0,
                         num_workers=workers)
    np.testing.assert_allclose(pr["loss"], jr["loss"], rtol=1e-5)
    assert pr["acc"] == jr["acc"]
    jp = jmodel.predict(jev, batch_size=BATCH)
    pp = pmodel.predict(pev, batch_size=BATCH, num_workers=workers)
    assert len(pp) == len(jp) == N_EVAL // BATCH
    for a, b in zip(pp, jp):
        ref = _f32(b)
        np.testing.assert_allclose(_f32(a), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    # train mode comes back after an evaluation
    assert pmodel.network.training


def test_fit_accumulates_gradients_as_the_reference():
    (ptr, _), (jtr, _) = _datasets()
    jmodel, pmodel = _models(dropout=0.0)
    jh = jmodel.fit(jtr, batch_size=BATCH, epochs=1, shuffle=False,
                    verbose=0, accumulate_grad_batches=2)
    ph = pmodel.fit(ptr, batch_size=BATCH, epochs=1, shuffle=False,
                    verbose=0, accumulate_grad_batches=2)
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-5)
    assert pmodel._optimizer._step_count == jmodel._optimizer._step_count \
        == N_TRAIN // BATCH // 2
    assert pmodel._train_step is None
    _weights_close(jmodel, pmodel, N_TRAIN // BATCH // 2)


class _Holder:
    """What a callback reads of a Model: ``_optimizer`` and
    ``stop_training``."""

    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False


def _opts():
    w = P.Tensor(np.ones(2, np.float32), stop_gradient=False)
    return (P.optimizer.SGD(learning_rate=0.5, parameters=[w]),
            ptt.optimizer.SGD(learning_rate=0.5, parameters=[
                torch.nn.Parameter(torch.ones(2))]))


VALUES = [1.0, 0.8, 0.85, 0.9, 0.79, 0.795, 0.81, 0.9, 0.95, 1.0]


@pytest.mark.parametrize("monitor,mode,patience,delta", [
    ("loss", "auto", 2, 0.0), ("val_loss", "min", 1, 0.02),
    ("acc", "auto", 3, 0.0)])
def test_early_stopping_and_plateau_follow_the_reference(monitor, mode,
                                                         patience, delta):
    values = [(-v if monitor == "acc" else v) for v in VALUES]
    jo, po = _opts()
    found = {}
    for side, cbmod, opt in (("ref", P.callbacks, jo), ("port", pcb, po)):
        holder = _Holder(opt)
        es = cbmod.EarlyStopping(monitor, mode=mode, patience=patience,
                                 min_delta=delta)
        rp = cbmod.ReduceLROnPlateau(monitor, factor=0.5, patience=patience,
                                     mode=mode, min_delta=delta, cooldown=1,
                                     min_lr=0.1)
        for cb in (es, rp):
            cb.set_model(holder)
        es.on_train_begin()
        lrs, stop = [], None
        for epoch, v in enumerate(values):
            es.on_epoch_end(epoch, {monitor: v})
            rp.on_epoch_end(epoch, {monitor: v})
            lrs.append(opt.get_lr())
            if holder.stop_training and stop is None:
                stop = epoch
        found[side] = (stop, es.stopped_epoch, es.best, lrs)
    assert found["port"] == found["ref"]
    assert found["port"][0] is not None and found["port"][3][-1] < 0.5


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_callback_steps_as_the_reference(by):
    (ptr, _), (jtr, _) = _datasets()
    jm, pm = _nets(0.0)
    jsched = P.optimizer.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    psched = plr.StepDecay(0.01, step_size=3, gamma=0.5)
    jmodel = P.Model(jm).prepare(
        P.optimizer.AdamW(learning_rate=jsched, parameters=jm.parameters()),
        lambda out, y: JF.cross_entropy(out, y))
    pmodel = ptt.Model(pm).prepare(
        AdamW(learning_rate=psched, parameters=pm.parameters()),
        F.cross_entropy)
    kw = dict(by_step=by == "step", by_epoch=by == "epoch")
    jh = jmodel.fit(jtr, batch_size=BATCH, epochs=2, shuffle=False,
                    verbose=0, callbacks=[P.callbacks.LRScheduler(**kw)])
    ph = pmodel.fit(ptr, batch_size=BATCH, epochs=2, shuffle=False,
                    verbose=0, callbacks=[pcb.LRScheduler(**kw)])
    assert psched.last_epoch == jsched.last_epoch == (8 if by == "step"
                                                      else 2)
    assert psched() == jsched()
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-5)


def test_checkpoints_and_load(tmp_path):
    """``ModelCheckpoint(save_freq=1)`` over 2 epochs writes the
    reference's files; a fresh model and optimizer loaded from ``final``
    give the trained model's eval logits and optimizer state bit for
    bit; ``EarlyStopping`` on ``val_loss`` sees the evaluation's loss."""
    (ptr, pev), (jtr, jev) = _datasets()
    jmodel, pmodel = _models(dropout=0.1)
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    for model, tr, ev, d, cb in ((jmodel, jtr, jev, jdir, P.callbacks),
                                 (pmodel, ptr, pev, pdir, pcb)):
        model.fit(tr, ev, batch_size=BATCH, epochs=2, shuffle=False,
                  verbose=0, callbacks=[
                      cb.ModelCheckpoint(save_freq=1, save_dir=str(d)),
                      cb.EarlyStopping("val_loss", patience=5)])
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    _, fresh = _nets(0.1)
    fm = ptt.Model(fresh).prepare(
        AdamW(learning_rate=LR, parameters=fresh.parameters()),
        F.cross_entropy)
    fm.load(str(pdir / "final"))
    ids = torch.as_tensor(_data(N_EVAL, 2)[0])
    assert torch.equal(fm.predict_batch([ids]),
                       pmodel.predict_batch([ids]))
    want, got = pmodel._optimizer.state_dict(), fm._optimizer.state_dict()
    assert set(got) == set(want) and got["@step"] == want["@step"] == 8
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the reference reads the port's checkpoint
    ref_state = P.load(str(pdir / "final.pdparams"))
    for k, v in pmodel.network.state_dict().items():
        assert np.array_equal(np.asarray(ref_state[k]._value), v.numpy()), k
    # load without an optimizer file, as the reference, keeps the state
    os.remove(pdir / "0.pdopt")
    fm.load(str(pdir / "0"))
    assert fm._optimizer.state_dict()["@step"] == 8


def test_summary_counts_equal_the_reference(capsys):
    jm, pm = _nets()
    list(pm.parameters())[0].requires_grad_(False)
    list(jm.parameters())[0].stop_gradient = True
    ours = ptt.summary(pm)
    ref = P.summary(jm)
    assert ours == ref
    assert ours["trainable_params"] < ours["total_params"]
    assert ptt.Model(pm).summary() == ours
    assert "Total params" in capsys.readouterr().out


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(31)
    logits = rng.standard_normal((50, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (50, 1)).astype(np.int64)
    for k in (1, 2):
        ours = float(pmetric.accuracy(torch.as_tensor(logits),
                                      torch.as_tensor(labels), k=k))
        ref = float(P.metric.accuracy(P.to_tensor(logits),
                                      P.to_tensor(labels), k=k).numpy())
        assert ours == ref
    pa, ja = pmetric.Accuracy(topk=(1, 2)), P.metric.Accuracy(topk=(1, 2))
    for lo in range(0, 50, 20):
        sl = slice(lo, lo + 20)
        pc = pa.compute(torch.as_tensor(logits[sl]),
                        torch.as_tensor(labels[sl]))
        jc = ja.compute(P.to_tensor(logits[sl]), P.to_tensor(labels[sl]))
        assert np.array_equal(pc.numpy(), np.asarray(jc._value))
        assert pa.update(pc) == ja.update(jc)
    assert pa.accumulate() == ja.accumulate() and pa.name() == ja.name()
    probs = rng.random((60, 2)).astype(np.float32)
    y = rng.integers(0, 2, (60,)).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        ours, ref = getattr(pmetric, cls)(), getattr(P.metric, cls)()
        for lo in (0, 30):
            p = probs[lo:lo + 30] if cls == "Auc" else probs[lo:lo + 30, 1]
            ours.update(torch.as_tensor(p), torch.as_tensor(y[lo:lo + 30]))
            ref.update(P.to_tensor(p), P.to_tensor(y[lo:lo + 30]))
        assert ours.accumulate() == ref.accumulate(), cls
        assert ours.name() == ref.name()
        ours.reset()
        assert ours.accumulate() == 0.0
