"""The port's in-process chaos soaks (``paddle_tpu_torch.tools.chaos_serving``)
on the CPU, on the JAX package's weights, against the JAX package's
``tools/chaos_serving.py``.

* The seeded helpers of the in-process modes (``_spec_request_stream``,
  ``_disagg_request_stream``, ``_mt_request_stream``) give the JAX
  package's values.
* Each of the six modes (``run_chaos``, with and without brownout;
  ``run_chaos_spec``, ``run_chaos_disagg``, ``run_chaos_multitenant``,
  ``run_kill_frontend``, ``run_standby``) runs with ``device="cpu"`` over
  the JAX soak's weights loaded through ``numpy_state`` (the multitenant
  soak's second version too) and keeps its own assertions; its survivors
  equal the JAX package's fault-free ``_reference_tokens`` for the same
  stream and weights (a brownout-truncated survivor: a prefix of them),
  with ``replicas=2`` where the reference's soak uses two; each
  multitenant survivor equals the reference of the version that served
  it.  Where a report field does not depend on the weights' values (the
  fault schedule's counts, statuses, trace digests), it equals the JAX
  soak's report over the JAX soak's own weights.
* ``run_chaos`` replays to an equal report (trace digest included).

Every soak runs at its own default size (the file takes ~25 s here).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import chaos_serving as port_chaos

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_REQUESTS = 12          # the spec soak's default


@pytest.fixture(scope="module")
def jax_chaos():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_serving", os.path.join(ROOT, "tools", "chaos_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _npz(model, path):
    np.savez(path, **{k: np.asarray(v._value)
                      for k, v in model.state_dict().items()})
    return str(path)


@pytest.fixture(scope="module")
def jax_weights(jax_chaos, tmp_path_factory):
    """The JAX soak's model (seed 11) and its second weights version (the
    multitenant soak's seed 13), each with an .npz of its state_dict."""
    import paddle_tpu as P
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    d = tmp_path_factory.mktemp("chaos_inprocess")
    v0 = jax_chaos._build_model()
    P.seed(13)
    v2 = LlamaForCausalLM(LlamaConfig(**jax_chaos.MODEL))
    v2.eval()
    return (v0, _npz(v0, d / "v0.npz")), (v2, _npz(v2, d / "v2.npz"))


def _plain(reqs):
    """A request stream with its priorities as names (the two packages'
    enums are different classes)."""
    return [(p, m, getattr(pr, "name", pr), *rest) for p, m, pr, *rest in reqs]


def _schedule_fields(report):
    """The report without the port's own fields: what the JAX soak reports
    over its own weights (the schedule does not read the weights)."""
    skip = {"device", "survivors", "survivor_versions", "brownout_truncated"}
    return {k: v for k, v in report.items() if k not in skip}


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_helpers_equal_jax(jax_chaos, seed):
    assert port_chaos.SEED_V2 == 13
    assert _plain(port_chaos._spec_request_stream(seed, 12)) == \
        _plain(jax_chaos._spec_request_stream(seed, 12))
    assert _plain(port_chaos._disagg_request_stream(seed, 16)) == \
        _plain(jax_chaos._disagg_request_stream(seed, 16))
    assert port_chaos._mt_request_stream(seed, 18) == \
        jax_chaos._mt_request_stream(seed, 18)


def _held_to(survivors, want, truncated=()):
    assert survivors
    for i, tokens in survivors.items():
        if i in truncated:
            assert tokens and tokens == want[i][:len(tokens)], i
        else:
            assert tokens == want[i], i


@pytest.mark.parametrize("brownout", [False, True])
def test_run_chaos_equals_jax_and_replays(jax_chaos, jax_weights, brownout):
    (jm, path), _ = jax_weights
    kw = dict(seed=7, replicas=3, brownout=brownout, device="cpu",
              numpy_state=path)
    report = port_chaos.run_chaos(**kw)
    assert report["mode"] == "in-process" and report["device"] == "cpu"
    assert len(report["fault_kinds_fired"]) >= 3
    assert report["poison_status"] in ("failed_poison", "failed")
    want = jax_chaos._reference_tokens(
        jm, jax_chaos._request_stream(7, 18, poison=True))
    _held_to(report["survivors"], want, report["brownout_truncated"])
    # the schedule, statuses and trace digest are the JAX soak's
    assert _schedule_fields(report) == jax_chaos.run_chaos(
        seed=7, replicas=3, brownout=brownout)
    if not brownout:
        assert port_chaos.run_chaos(**kw) == report


def test_run_chaos_spec(jax_chaos, jax_weights):
    (jm, path), _ = jax_weights
    report = port_chaos.run_chaos_spec(seed=0, num_requests=SPEC_REQUESTS,
                                       device="cpu", numpy_state=path)
    assert report["replay_digest_equal"]
    assert all(n >= 1 for n in report["spec_fires"].values())
    assert report["accepted_tokens"] >= 1
    assert report["statuses"] == {"completed": SPEC_REQUESTS}
    want = jax_chaos._reference_tokens(
        jm, jax_chaos._spec_request_stream(0, SPEC_REQUESTS), replicas=2)
    _held_to(report["survivors"], want)
    assert sorted(report["survivors"]) == list(range(SPEC_REQUESTS))


def test_run_chaos_disagg(jax_chaos, jax_weights):
    (jm, path), _ = jax_weights
    report = port_chaos.run_chaos_disagg(seed=0, device="cpu",
                                         numpy_state=path)
    assert all(n >= 1 for n in report["fabric_fires"].values())
    assert report["wire_pulls"] >= 1 and report["wire_fallbacks"] >= 1
    want = jax_chaos._reference_tokens(
        jm, jax_chaos._disagg_request_stream(0, 16))
    _held_to(report["survivors"], want)
    assert _schedule_fields(report) == jax_chaos.run_chaos_disagg(seed=0)


def test_run_chaos_multitenant(jax_chaos, jax_weights):
    (v0, p0), (v2, p2) = jax_weights
    report = port_chaos.run_chaos_multitenant(
        seed=0, device="cpu", numpy_state=p0, numpy_state_v2=p2)
    assert report["replica_versions"] == ["v0", "v2", "v2", "v2"]
    assert report["swapped_replicas"] == 3 and report["rejected_budget"] >= 1
    assert set(report["result_versions"]) == {"v0", "v2"}
    from paddle_tpu.inference import Priority

    base = [(p, m, Priority.NORMAL)
            for p, m, _ in jax_chaos._mt_request_stream(0, 18)]
    want = {"v0": jax_chaos._reference_tokens(v0, base),
            "v2": jax_chaos._reference_tokens(v2, base)}
    survivors = report["survivors"]
    assert len(survivors) == report["admitted"]
    for i, tokens in survivors.items():
        assert tokens == want[report["survivor_versions"][i]][i], i
    assert _schedule_fields(report) == jax_chaos.run_chaos_multitenant(seed=0)


def test_run_kill_frontend(jax_chaos, jax_weights, tmp_path):
    (jm, path), _ = jax_weights
    report = port_chaos.run_kill_frontend(seed=0, device="cpu",
                                          numpy_state=path,
                                          journal_dir=str(tmp_path))
    assert report["exactly_one_terminal_per_admit"]
    assert 5 <= report["terminal_before_kill"] < 16
    assert report["recovered_requests"] == 16 - report["terminal_before_kill"]
    assert report["idempotent_hits"] == 16
    want = jax_chaos._reference_tokens(
        jm, jax_chaos._kill_request_stream(0, 16), replicas=2)
    _held_to(report["survivors"], want)
    assert report["sampled_survivors_token_identical"] >= 1


def test_run_standby(jax_chaos, jax_weights, tmp_path):
    (jm, path), _ = jax_weights
    report = port_chaos.run_standby(seed=0, device="cpu", numpy_state=path,
                                    journal_dir=str(tmp_path))
    assert report["takeover_epoch"] == 2 and report["handoff_epoch"] == 2
    assert report["zombie_fenced_rpcs"] >= 1
    assert report["idempotent_hits"] == 14
    want = jax_chaos._reference_tokens(
        jm, jax_chaos._kill_request_stream(0, 14), replicas=2)
    _held_to(report["survivors"], want)
    assert report["statuses"] == {"completed": 14}
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    assert _schedule_fields(report) == jax_chaos.run_standby(
        seed=0, journal_dir=str(jax_dir))
