"""The port's request journal (``paddle_tpu_torch.inference.journal``) and
the frontend's recovery from it, against the reference's.

* Framing, both packages: records round-trip; a torn tail is dropped and
  truncated before the next append; a CRC mismatch mid-file and a
  garbage length field fail loud (``JournalCorruption``); an oversize
  record is refused at write time; compaction writes a snapshot and a
  suffix that replay to the same state.
* The same records written by both packages give byte-equal files, so
  the on-disk format is the reference's.
* A journal the reference's frontend writes, then abandons with
  requests in flight, is recovered by the port's frontend over port
  engines (and the reverse): every admitted request ends with exactly one
  terminal status, pre-crash terminals come back as recovered terminals,
  and the recovered requests' tokens (greedy and seeded) are the
  crash-free run's of the package that wrote the journal.
* Idempotency across a restart in the port: a client retry with its key
  returns the first rid, and no duplicate runs.
"""
import pytest
import torch

from test_torch_control_plane import make_sides

torch.set_num_threads(2)

SIDE_NAMES = ["jax", "port"]

REQS = [([3, 17, 101, 7], 6, {}),
        ([42, 5, 9], 6, dict(temperature=0.9, top_k=12, seed=77)),
        ([8, 8, 8, 8, 8], 6, {}),
        ([100, 2], 6, dict(temperature=0.7, top_p=0.9, seed=5))]


@pytest.fixture(scope="module")
def sides(serving_model):
    return make_sides(serving_model)


def _side(sides, name):
    return sides[SIDE_NAMES.index(name)]


def _journal(side, path, **kw):
    kw.setdefault("fsync", False)
    return side.journal.RequestJournal(str(path), **kw)


# ----------------------------------------------------------------- framing
@pytest.mark.parametrize("name", SIDE_NAMES)
def test_round_trip_torn_tail_and_truncation(sides, name, tmp_path):
    side = _side(sides, name)
    J = side.journal.RequestJournal
    j = _journal(side, tmp_path / "a.wal")
    recs = [{"t": "progress", "rid": i, "n": 1} for i in range(3)]
    total = sum(j.append(r) for r in recs)
    j.close()
    assert j.records_appended == 3 and j.bytes_appended == total
    assert J(j.path).replay() == (None, recs)
    data = open(j.path, "rb").read()
    open(j.path, "wb").write(data[:3])          # torn inside a header
    assert J(j.path).replay() == (None, [])
    open(j.path, "wb").write(data[:-5])         # torn inside a payload
    assert [r["rid"] for r in J(j.path).replay()[1]] == [0, 1]
    j2 = _journal(side, j.path)
    j2.append({"t": "progress", "rid": 9, "n": 9})
    j2.close()
    assert [r["rid"] for r in J(j.path).replay()[1]] == [0, 1, 9]


@pytest.mark.parametrize("name", SIDE_NAMES)
def test_crc_mismatch_and_garbage_length_fail_loud(sides, name, tmp_path):
    side = _side(sides, name)
    J, Corrupt = side.journal.RequestJournal, side.journal.JournalCorruption
    j = _journal(side, tmp_path / "a.wal")
    for i in range(4):
        j.append({"t": "progress", "rid": i, "n": 1})
    j.close()
    data = bytearray(open(j.path, "rb").read())
    data[12] ^= 0xFF
    open(j.path, "wb").write(bytes(data))
    with pytest.raises(Corrupt, match="CRC mismatch"):
        J(j.path).replay()
    with pytest.raises(Corrupt):
        _journal(side, j.path).append({"t": "x"})
    j = _journal(side, tmp_path / "b.wal")
    j.append({"t": "progress", "rid": 0, "n": 1})
    j.close()
    with open(j.path, "ab") as f:
        f.write(b"\xff\xff\xff\x7f" + b"\x00" * 40)
    with pytest.raises(Corrupt, match="length field"):
        J(j.path).replay()


@pytest.mark.parametrize("name", SIDE_NAMES)
def test_oversize_record_and_compaction(sides, name, tmp_path,
                                        monkeypatch):
    side = _side(sides, name)
    monkeypatch.setattr(side.journal, "_MAX_RECORD", 64)
    j = _journal(side, tmp_path / "a.wal")
    j.append({"t": "progress", "rid": 0, "n": 1})
    with pytest.raises(ValueError, match="frame cap"):
        j.append({"t": "admit", "rid": 1, "prompt": list(range(64))})
    j.close()
    monkeypatch.undo()
    j = _journal(side, tmp_path / "b.wal")
    for i in range(6):
        j.append({"t": "admit", "rid": i, "prompt": [i]})
    snap = {"next_rid": 6, "open": [{"rid": 4}, {"rid": 5}],
            "done": [{"rid": 1, "key": "k1", "status": "completed"}]}
    j.rewrite(snap, suffix=[{"t": "admit", "rid": 6, "prompt": [6]}])
    j.append({"t": "terminal", "rid": 4, "status": "completed"})
    j.close()
    got_snap, got = side.journal.RequestJournal(j.path).replay()
    assert got_snap["t"] == "snapshot" and got_snap["next_rid"] == 6
    assert [r["rid"] for r in got_snap["open"]] == [4, 5]
    assert got == [{"t": "admit", "rid": 6, "prompt": [6]},
                   {"t": "terminal", "rid": 4, "status": "completed"}]
    assert j.compactions == 1


def test_same_records_give_byte_equal_files(sides, tmp_path):
    """Appends, an epoch record, a compaction with a suffix and appends
    after it: the two packages' files are equal byte for byte, and each
    package replays the other's file to the same records."""
    recs = [{"t": "admit", "rid": 0, "prompt": [1, 2, 3], "max_new": 4,
             "key": "k0", "sampling": {"temperature": 0.5, "seed": 7}},
            {"t": "progress", "rid": 0, "n": 2, "dl": 1.25},
            {"t": "epoch", "epoch": 3, "nr": 1},
            {"t": "terminal", "rid": 0, "status": "completed",
             "detail": "é ünïcode"}]
    paths = []
    for side in sides:
        p = tmp_path / f"{side.name}.wal"
        j = _journal(side, p)
        for r in recs:
            j.append(r)
        j.rewrite({"next_rid": 1, "open": [], "done": [
            {"rid": 0, "key": "k0", "status": "completed"}]},
            suffix=recs[2:3])
        j.append(recs[1])
        j.close()
        paths.append(p)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]
    for side in sides:
        replays = [side.journal.RequestJournal(str(p)).replay()
                   for p in paths]
        assert replays[0] == replays[1]
        assert side.journal.recorded_epoch(str(paths[0])) == 3


# ---------------------------------------------------------------- recovery
def _crash_free(side):
    fe = side.ServingFrontend([side.engine()])
    rids = [fe.submit(p, max_new_tokens=m, **kw) for p, m, kw in REQS]
    res = fe.run()
    return [[int(t) for t in res[r].tokens] for r in rids]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_crosses_packages(sides, writer, reader, tmp_path):
    """The writer's frontend admits four requests (two seeded), runs two
    steps and is dropped; the reader's frontend recovers the journal over
    its own engines.  One terminal status each, pre-crash terminals
    marked recovered, recovered tokens equal the writer's crash-free
    tokens, and both packages' crash-free tokens are equal."""
    w, r = _side(sides, writer), _side(sides, reader)
    want = _crash_free(w)
    assert _crash_free(r) == want
    j = _journal(w, tmp_path / "req.wal")
    fe = w.ServingFrontend([w.engine()], journal=j)
    rids = [fe.submit(p, max_new_tokens=m, idempotency_key=f"k{i}", **kw)
            for i, (p, m, kw) in enumerate(REQS)]
    fe.step()
    fe.step()
    pre_done = set(fe.results())
    assert pre_done and len(pre_done) < len(rids)
    j.close()
    fe2 = r.ServingFrontend.recover(j.path, [r.engine()])
    assert fe2.metrics.counter("recoveries_total") == 1
    assert (fe2.metrics.counter("recovered_requests_total")
            == len(rids) - len(pre_done))
    res = fe2.run()
    assert sorted(res) == sorted(rids)
    for i, rid in enumerate(rids):
        if rid in pre_done:
            assert res[rid].detail.startswith("recovered terminal")
        else:
            assert res[rid].status is r.RequestStatus.COMPLETED
            assert [int(t) for t in res[rid].tokens] == want[i]
    # the journal the reader now owns replays in the writer's package
    snap, recs = w.journal.RequestJournal(j.path).replay()
    terminals = [x["rid"] for x in recs if x["t"] == "terminal"]
    terminals += [x["rid"] for x in (snap or {}).get("done", [])]
    assert sorted(terminals) == sorted(rids)


def test_idempotency_across_a_restart_and_orphans(sides, tmp_path):
    """The port's frontend, crashed mid-flight over a live engine: the
    recovered frontend reaps the orphan the engine still holds, a client
    retry with its key returns the first rid (terminal or in flight), and
    no rid runs twice; the reference does the same on its side."""
    outs = []
    for side in sides:
        j = _journal(side, tmp_path / f"{side.name}.wal")
        eng = side.engine()
        fe = side.ServingFrontend([eng], journal=j)
        prompts = [[3, 17, 101, 7], [42, 5, 9], [8, 8, 8, 8, 8]]
        news = [5, 12, 12]      # the first ends before the crash
        rids = [fe.submit(p, max_new_tokens=n, idempotency_key=f"k{i}")
                for i, (p, n) in enumerate(zip(prompts, news))]
        fe.step()
        fe.step()
        active = eng.num_active
        fe2 = side.ServingFrontend.recover(j.path, [eng])
        reaped = fe2.metrics.counter("orphans_reaped_total")
        retries = [fe2.submit(p, max_new_tokens=n, idempotency_key=f"k{i}")
                   for i, (p, n) in enumerate(zip(prompts, news))]
        assert retries == rids
        res = fe2.run()
        assert set(res) == set(rids)
        assert fe2.metrics.counter("admitted_total") == 0
        outs.append((active, reaped, fe2.metrics.counter(
            "idempotent_hits_total"), {k: (v.status.value,
                                           [int(t) for t in v.tokens])
                                       for k, v in res.items()}))
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[1][1] > 0 and outs[1][2] == 3
