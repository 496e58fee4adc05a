"""The port's fleet chaos soaks (``paddle_tpu_torch.tools.chaos_serving``)
over CPU worker processes on the JAX package's weights, against the JAX
package's ``tools/chaos_serving.py``.

* ``run_chaos_fleet(seed=0, workers=3, num_requests=8)``: every request
  terminal, at least one worker death survived, and the COMPLETED
  survivors equal the JAX package's fault-free ``_reference_tokens`` for
  the same stream and weights;
* ``run_standby_fleet(seed=0)`` in crash mode: the active frontend child
  SIGKILLs itself, the standby takes over at epoch 2, every client retry
  returns its rid, one terminal per admit, and the survivors (greedy and
  seeded sampled) equal the JAX package's crash-free reference;
* the soaks' seeded helpers (request streams, the fault schedule) give
  the JAX package's values.

Every spawn and wait inside the soaks carries a 60 s deadline; spawned CPU
workers run with ``OMP_NUM_THREADS=1``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.tools import chaos_serving as port_chaos

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_chaos():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_serving", os.path.join(ROOT, "tools", "chaos_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_weights(jax_chaos, tmp_path_factory):
    """The JAX soak's model and an .npz of its state_dict."""
    model = jax_chaos._build_model()
    path = tmp_path_factory.mktemp("chaos_weights") / "state.npz"
    np.savez(path, **{k: np.asarray(v._value)
                      for k, v in model.state_dict().items()})
    return model, str(path)


def _plain(reqs):
    """A request stream with its priorities as names (the two packages'
    enums are different classes)."""
    return [(p, m, pr.name, *rest) for p, m, pr, *rest in reqs]


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_helpers_equal_jax(jax_chaos, seed):
    assert port_chaos.MODEL == jax_chaos.MODEL
    assert port_chaos.ENGINE == jax_chaos.ENGINE
    for poison in (False, True):
        assert _plain(port_chaos._request_stream(seed, 12, poison)) == \
            _plain(jax_chaos._request_stream(seed, 12, poison))
        assert port_chaos._fault_schedule(seed, 6, poison) == \
            jax_chaos._fault_schedule(seed, 6, poison)
    assert _plain(port_chaos._kill_request_stream(seed, 10)) == \
        _plain(jax_chaos._kill_request_stream(seed, 10))


def test_chaos_fleet_survivors_equal_jax_reference(jax_chaos, jax_weights):
    model, path = jax_weights
    rpc.shutdown()
    report = port_chaos.run_chaos_fleet(seed=0, workers=3, num_requests=8,
                                        device="cpu", numpy_state=path)
    want = jax_chaos._reference_tokens(
        model, jax_chaos._request_stream(0, 8, poison=False))
    assert sum(report["statuses"].values()) == 8
    assert report["replica_deaths"] >= 1
    assert report["workers_alive_at_end"] >= 1
    assert report["survivors"]
    for i, tokens in report["survivors"].items():
        assert tokens == want[i], i


def test_standby_fleet_crash_mode(jax_chaos, jax_weights):
    model, path = jax_weights
    rpc.shutdown()
    report = port_chaos.run_standby_fleet(seed=0, device="cpu",
                                          numpy_state=path)
    assert report["variant"] == "sigkill"
    assert report["takeover_epoch"] == 2
    assert report["idempotent_hits"] == report["requests"] == 10
    assert report["exactly_one_terminal_per_admit"]
    assert report["statuses"] == {"completed": 10}
    want = jax_chaos._reference_tokens(
        model, jax_chaos._kill_request_stream(0, 10), replicas=2)
    assert sorted(report["survivors"]) == list(range(10))
    for i, tokens in report["survivors"].items():
        assert tokens == want[i], i
