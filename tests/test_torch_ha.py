"""The port's high-availability control plane (``paddle_tpu_torch``'s
``distributed/launch/master.py`` and ``inference/ha.py``) against the
reference's, on 127.0.0.1.

* The launch KV store: ``KVServer`` / ``KVClient`` put, get, CAS and
  delete, and each package's client talks to the other's server.
* ``FrontendLease``: acquire, renew, expiry past the TTL on an injected
  clock (the epoch goes up by one), early release; a port lease and a
  reference lease contend over one store, so the record is shared.
* ``EpochFence`` and ``FencedEngine`` over the port's engine: a lower
  epoch raises ``StaleEpoch`` and never reaches the engine.
* ``StandbyFrontend``: an active frontend holding the lease is paused
  past its TTL with a request in flight; the standby takes over at epoch
  + 1, recovers the journal, dedupes the client's retry and completes the
  request with the reference's tokens (the same scenario run on both
  packages).
"""
import pytest
import torch

from test_torch_control_plane import make_sides

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sides(serving_model):
    return make_sides(serving_model)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture()
def stores(sides):
    """One KV server of each package, and their endpoints."""
    servers = [s.master.KVServer(0).start() for s in sides]
    try:
        yield [f"127.0.0.1:{srv.port}" for srv in servers]
    finally:
        for srv in servers:
            srv.stop()


def test_kv_store_and_cross_package_clients(sides, stores):
    for side in sides:
        for ep in stores:
            kv = side.master.KVClient(ep)
            key = f"/{side.name}"
            assert kv.cas(key, None, "a")
            assert not kv.cas(key, None, "b")
            assert not kv.cas(key, "z", "b")
            assert kv.cas(key, "a", "b") and kv.get(key) == "b"
            kv.put(key + "/x", "1")
            assert kv.get(key + "/x") == "1"
            kv.delete(key)
            assert kv.get(key) is None
    jax_kv, port_kv = (s.master.KVClient(stores[1]) for s in sides)
    port_kv.put("/shared", "from port")
    assert jax_kv.get("/shared") == "from port"


def test_lease_acquire_renew_expiry_release(sides, stores):
    jax_side, port = sides
    ep = stores[1]
    clk = Clock()
    a = port.ha.FrontendLease(ep, holder="a", clock=clk, ttl_s=10.0)
    b = port.ha.FrontendLease(ep, holder="b", clock=clk, ttl_s=10.0)
    assert a.acquire() == 1
    assert b.acquire() is None and a.held and not b.held
    assert a.renew() is True
    clk.advance(11.0)
    assert b.acquire() == 2
    assert a.renew() is False and not a.held
    assert b.release() is True
    assert a.acquire() == 3
    # a reference lease over the same record: live under a, then epoch 4
    r = jax_side.ha.FrontendLease(ep, holder="r", clock=clk, ttl_s=10.0)
    assert r.acquire() is None
    a.release()
    assert r.acquire() == 4
    assert a.acquire() is None


def test_fenced_engine_over_the_port_engine(sides):
    port = sides[1]
    f = port.ha.EpochFence()
    f.check(None)
    f.check(3, "step")
    with pytest.raises(port.ha.StaleEpoch, match="seen epoch 3"):
        f.check(2, "step")
    eng = port.engine()
    fence = port.ha.EpochFence()
    new = port.ha.FencedEngine(eng, fence, epoch=2)
    old = port.ha.FencedEngine(eng, fence, epoch=1)
    rid = new.add_request([3, 17, 9], max_new_tokens=4)
    for op in (old.step, lambda: old.add_request([1], max_new_tokens=2),
               lambda: old.evict(rid), old.reap_orphans):
        with pytest.raises(port.ha.StaleEpoch):
            op()
    assert fence.fenced_total == 4
    assert len(eng._queue) == 1 and eng.num_active == 0   # untouched
    out = eng.run()
    assert len(out[rid]) == 4
    old.set_epoch(3)
    old.step()                                 # a re-epoched caller passes


def _takeover(side, ep, jpath):
    """Active frontend "a" at epoch 1, a request in flight, paused past
    its TTL; the standby "b" takes over: (epoch, tokens, status, retry
    rid == rid, takeover counters)."""
    clk = Clock()
    la = side.ha.FrontendLease(ep, holder="a", clock=clk, ttl_s=30.0,
                               seed=0)
    assert la.acquire() == 1
    fe_a = side.ServingFrontend(
        [side.engine()], journal=side.journal.RequestJournal(
            jpath, fsync=False), epoch=la.epoch, clock=clk)
    rid = fe_a.submit([3, 17, 101], max_new_tokens=6, idempotency_key="k")
    fe_a.step()
    clk.advance(31.0)
    lb = side.ha.FrontendLease(ep, holder="b", clock=clk, ttl_s=30.0,
                               seed=0)
    standby = side.ha.StandbyFrontend(lb, jpath, lambda: [side.engine()],
                                      frontend_kwargs={"clock": clk})
    fe_b = standby.poll()
    assert fe_b is not None
    again = fe_b.submit([3, 17, 101], max_new_tokens=6, idempotency_key="k")
    res = fe_b.run()
    c = fe_b.metrics.snapshot()["counters"]
    return (fe_b.epoch, [int(t) for t in res[rid].tokens],
            res[rid].status.value, again == rid,
            c.get("standby_takeovers_total"), c.get("failovers_total"))


def test_standby_takeover_at_epoch_plus_one(sides, stores, tmp_path):
    got = [_takeover(side, ep, str(tmp_path / f"{side.name}.wal"))
           for side, ep in zip(sides, stores)]
    assert got[1] == got[0]
    epoch, tokens, status, same, takeovers, failovers = got[1]
    assert (epoch, status, same, takeovers, failovers) == (
        2, "completed", True, 1, 1)
    assert len(tokens) == 6
