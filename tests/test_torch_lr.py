"""The port's learning-rate schedulers (``paddle_tpu_torch/optimizer/lr.py``)
against the JAX package's (``paddle_tpu/optimizer/lr.py``), one case per
scheduler: the rate after each of N ``step()`` calls (``ReduceOnPlateau``
fed a seeded loss curve), then a ``state_dict`` taken midway and loaded
into a fresh scheduler, which must go on with the same rates.  Both are
host arithmetic on Python floats: the rates agree within float64 rounding
(rtol 1e-15).
"""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as plr

N = 40

CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=15,
                                                   end_lr=1e-3, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=1e-3, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=30, eta_min=1e-5), 8, 0.0, 3e-4),
    "LinearWarmup-float": lambda m: m.LinearWarmup(0.05, 6, 0.001, 0.05),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 11, 25], 0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=6, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-4),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=13, eta_min=1e-3),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 3 else 1.0),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=30),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        0.1, total_steps=30, anneal_strategy="linear", phase_pct=0.25),
    "CyclicLR": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=4,
                                     step_size_down=6),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(
        1e-3, 0.1, step_size_up=5, mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(
        1e-3, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-4),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=20, start_factor=0.2),
    "ConstantLR": lambda m: m.ConstantLR(0.1, factor=0.25, total_steps=9),
}

# a loss curve that falls, then stalls and wobbles (ReduceOnPlateau's input)
_LOSSES = [2.0 * math.exp(-0.2 * i) + 0.3 for i in range(12)] + list(
    0.5 + 0.01 * np.random.default_rng(0).standard_normal(N))


def _advance(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, plr.ReduceOnPlateau)):
        s.step(_LOSSES[i])
    else:
        s.step()


def _rates(s, start, stop):
    out = []
    for i in range(start, stop):
        out.append(s())
        _advance(s, i)
    return out


def test_every_reference_scheduler_is_ported():
    """18 schedulers and the base, the reference's names one for one."""
    assert set(plr.__all__) == set(jlr.__all__)
    assert len(plr.__all__) == 19


@pytest.mark.parametrize("name", list(CASES))
def test_scheduler_rates_and_state_dict_match_the_reference(name):
    ours, ref = CASES[name](plr), CASES[name](jlr)
    np.testing.assert_allclose(_rates(ours, 0, N // 2),
                               _rates(ref, 0, N // 2), rtol=1e-15, atol=0)
    sd = ours.state_dict()
    assert sd == ref.state_dict()
    again = CASES[name](plr)
    again.set_state_dict(sd)
    np.testing.assert_allclose(_rates(again, N // 2, N),
                               _rates(ref, N // 2, N), rtol=1e-15, atol=0)
