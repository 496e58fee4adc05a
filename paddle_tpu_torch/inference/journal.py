"""Write-ahead request journal for the serving control plane (reference
analogs: the etcd/RocksDB WAL framing discipline — length + CRC per
record, torn tail tolerated, mid-file corruption fatal — and
vLLM-lineage serving systems' request-journal + snapshot recovery, where
the frontend's request lifecycle is the durable state and the tokens are
not: greedy determinism plus seeded, replayable sample streams make a
recovered request's output provably identical to a crash-free run).

Copied from ``paddle_tpu/inference/journal.py`` (the port never imports
the JAX package).  The on-disk format is the reference's byte for byte,
so a journal one package writes, the other recovers.

Format: an append-only file of CRC-framed records,

    [u32 payload_len][u32 crc32(payload)][payload = compact JSON]

Three lifecycle record kinds (written by ``ServingFrontend``), plus one
compaction kind:

* ``admit``    — rid, prompt ids, ``SamplingParams`` wire dict, priority,
  remaining deadline seconds, token budget fields, idempotency key.
  Journaled at admission, BEFORE the request can reach a replica.
* ``progress`` — rid + tokens-generated count, appended at megastep
  boundaries.  Observability only: recovery re-prefills from the prompt
  and the tokens replay (they are deliberately NOT journaled).
* ``terminal`` — rid, typed ``RequestStatus`` value, token count,
  attempts, idempotency key.  Exactly one per admitted rid.
* ``epoch`` — the writer's fencing epoch, appended when an
  epoch-armed frontend arms a fresh journal; compaction snapshots carry
  the same field.  ``ServingFrontend.recover`` REFUSES a journal whose
  recorded epoch exceeds the recovering frontend's (the caller is the
  stale incarnation) and, absent an explicit epoch, arms at the
  journal's epoch + 1 — the journal-side half of the zombie fence.
* ``snapshot`` — whole-state record written by compaction
  (``rewrite``): open admits + the bounded keyed-terminal cache +
  ``next_rid`` + the writer epoch.  Replay = snapshot state, then the
  suffix records.

Failure semantics on replay (``replay``):

* an EMPTY file is a valid empty journal;
* a TORN TAIL — the file ends mid-header or mid-payload, the shape a
  crash mid-``append`` leaves — is tolerated: replay stops at the last
  complete record, and opening for append truncates the tear so new
  records never land after garbage;
* a complete frame whose CRC does not match (bit rot, concurrent
  writers, a wrong file) raises :class:`JournalCorruption` — corruption
  mid-file must fail LOUD, never be skipped, because every record after
  it is untrustworthy and "recovered" state built over it would silently
  drop or duplicate requests.

Durability knob: ``fsync=True`` (default) fsyncs every append — survives
machine crash; ``fsync=False`` leaves records in the OS page cache —
survives process SIGKILL (the kill-frontend chaos soak's failure model)
but not power loss.  Both I/O paths carry failpoints
(``journal.append``, ``journal.fsync`` — ``inference/faults.py``) so
chaos runs can fail the journal deterministically; the frontend reacts
by degrading to non-durable serving with a loud ``journal_degraded``
gauge, never by killing the data plane.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["RequestJournal", "JournalCorruption", "JournalSuperseded",
           "recorded_epoch",
           "ADMIT", "PROGRESS", "TERMINAL", "SNAPSHOT", "EPOCH"]

_HDR = struct.Struct("<II")          # payload length, crc32(payload)
# a complete frame claiming a payload larger than this is corruption,
# not a big record (admit records are ~prompt-sized; snapshots are
# bounded by open requests + the keyed-terminal cache)
_MAX_RECORD = 64 * 1024 * 1024

ADMIT = "admit"
PROGRESS = "progress"
TERMINAL = "terminal"
SNAPSHOT = "snapshot"
EPOCH = "epoch"


class JournalCorruption(RuntimeError):
    """A complete mid-file record failed its CRC (or decode): everything
    after it is untrustworthy, so replay refuses to continue.  Carries
    the byte offset of the bad frame."""

    def __init__(self, path: str, offset: int, why: str):
        super().__init__(
            f"journal {path!r} corrupt at byte {offset}: {why} — refusing "
            "to skip-and-continue (records after a corrupt frame cannot be "
            "trusted); restore the file or start a fresh journal")
        self.path = path
        self.offset = offset


class JournalSuperseded(RuntimeError):
    """The file at ``path`` is no longer the one this journal instance
    owns: a successor incarnation recovered and compacted it (recovery
    always compacts, which ``os.replace``s the path with a NEW inode).
    Raised instead of writing — RPC-level epoch fencing cannot protect
    the journal FILE, so a resumed zombie's compaction would otherwise
    ``os.replace`` its stale snapshot over the successor's live WAL.
    Terminal for the writer: the frontend treats it like a worker fence
    (depose, stop journaling), not like a degradable I/O fault."""


class RequestJournal:
    """Append-only CRC-framed journal of the request lifecycle.

    >>> j = RequestJournal("/var/lib/paddle_tpu/requests.wal")
    >>> j.append({"t": "admit", "rid": 0, "prompt": [1, 5, 7], ...})
    >>> snapshot, records = RequestJournal(path).replay()

    The file handle opens lazily on first ``append`` (scanning the
    existing file and truncating any torn tail first, so appends never
    land after garbage).  ``rewrite`` is snapshot-based compaction:
    the new content is written to a sibling file and atomically
    ``os.replace``d over the journal.
    """

    def __init__(self, path, *, fsync: bool = True, fault_injector=None):
        from .faults import FaultInjector

        self.path = os.fspath(path)
        self.fsync_enabled = bool(fsync)
        self._faults = (fault_injector if fault_injector is not None
                        else FaultInjector.from_env())
        self._fh = None
        # (st_dev, st_ino) of the file this instance owns, recorded at
        # first open / after each compaction.  A mismatch with the path
        # later means a successor os.replace'd the journal — see
        # JournalSuperseded.  None until the first write.
        self._owned_id: Optional[Tuple[int, int]] = None
        # local instrumentation for tools/tests; the frontend keeps its
        # own registry counters (journal_records/bytes_total) from
        # append() return values rather than reading these
        self.records_appended = 0
        self.bytes_appended = 0
        self.compactions = 0

    # ------------------------------------------------------------- framing
    @staticmethod
    def _frame(rec: Dict) -> bytes:
        payload = json.dumps(rec, separators=(",", ":")).encode()
        if len(payload) > _MAX_RECORD:
            # enforce the cap at WRITE time too: a correctly-CRC'd frame
            # past the cap would be rejected by _scan as corruption, so
            # writing one would poison the whole journal (the frontend
            # turns this raise into degraded non-durable serving)
            raise ValueError(
                f"journal record of {len(payload)} bytes exceeds the "
                f"{_MAX_RECORD}-byte frame cap (snapshot of an unbounded "
                "open-request set? cap admission queues)")
        return _HDR.pack(len(payload), zlib.crc32(payload)) + payload

    def _scan(self) -> Tuple[List[Dict], int]:
        """Parse every complete record; returns (records, clean_end) where
        ``clean_end`` is the byte offset after the last complete record
        (< file size exactly when the tail is torn).  Raises
        :class:`JournalCorruption` on a complete frame with a bad CRC or
        undecodable payload."""
        records: List[Dict] = []
        if not os.path.exists(self.path):
            return records, 0
        with open(self.path, "rb") as f:
            data = f.read()
        off, size = 0, len(data)
        while off < size:
            if size - off < _HDR.size:
                break                                    # torn header
            length, crc = _HDR.unpack_from(data, off)
            if length > _MAX_RECORD:
                raise JournalCorruption(
                    self.path, off, f"frame claims {length} payload bytes "
                    f"(cap {_MAX_RECORD}) — length field is garbage")
            if size - off - _HDR.size < length:
                break                                    # torn payload
            payload = data[off + _HDR.size:off + _HDR.size + length]
            if zlib.crc32(payload) != crc:
                raise JournalCorruption(
                    self.path, off, "CRC mismatch on a complete frame")
            try:
                records.append(json.loads(payload))
            except ValueError as e:
                raise JournalCorruption(
                    self.path, off, f"payload is not valid JSON ({e})") \
                    from e
            off += _HDR.size + length
        return records, off

    # -------------------------------------------------------------- append
    def _check_owner(self):
        """Refuse to touch the path once it stopped being OUR file.
        Best-effort (a replace can still land between this check and the
        write), but the deterministic zombie case — the successor already
        recovered, which always compacts to a new inode — is caught."""
        if self._owned_id is None:
            return
        try:
            st = os.stat(self.path)
        except OSError as e:
            raise JournalSuperseded(
                f"journal {self.path!r} vanished from under its writer "
                "(moved or deleted) — a successor owns the path now; "
                "stop journaling") from e
        if (st.st_dev, st.st_ino) != self._owned_id:
            raise JournalSuperseded(
                f"journal {self.path!r} was replaced by another "
                "incarnation (recovery compaction installs a new inode) "
                "— this writer is the stale one; stop journaling")

    def _open_for_append(self):
        if self._fh is not None:
            return
        _, clean_end = self._scan()            # raises on real corruption
        fh = open(self.path, "ab")
        if fh.tell() != clean_end:
            # torn tail from a crash mid-append: truncate it so new
            # records are readable (appending after garbage would make
            # every later record unreachable to replay)
            fh.truncate(clean_end)
            fh.seek(clean_end)
        self._fh = fh
        if self._owned_id is None:
            st = os.fstat(fh.fileno())
            self._owned_id = (st.st_dev, st.st_ino)

    def _fsync(self):
        if self._faults is not None:
            self._faults.fire("journal.fsync", detail=self.path)
        if self.fsync_enabled:
            os.fsync(self._fh.fileno())

    def append(self, rec: Dict) -> int:
        """Frame + write (+ fsync per policy) one record; returns the
        bytes written.  Raises on any I/O fault — the caller (the
        frontend) owns the degrade-to-non-durable reaction."""
        return self.append_batch([rec])

    def append_batch(self, recs) -> int:
        """Group commit: frame + write every record, then ONE flush +
        fsync for the whole batch.  The frontend batches the per-request
        PROGRESS records of one control step through here — per-record
        fsync on the decode hot path would cost one synchronous disk
        barrier per active request per megastep, handing back the host-
        sync win megastep decode exists for.  (Batch durability is
        all-or-torn-tail: a crash mid-batch loses a suffix of it, which
        replay already tolerates.)  The ``journal.append`` failpoint
        still fires per record so chaos schedules see stable traversal
        counts."""
        frames = []
        for rec in recs:
            if self._faults is not None:
                self._faults.fire("journal.append",
                                  detail=str(rec.get("t", "")))
            frames.append(self._frame(rec))
        if not frames:
            return 0
        # one stat per group commit: a resumed zombie with its handle
        # still OPEN would otherwise keep "successfully" appending into
        # the orphaned inode after a successor os.replace'd the path —
        # the write cannot corrupt the successor, but the caller must
        # learn it is deposed, not get a silent no-op ack.  Also covers
        # the closed-then-reopened writer before _open_for_append would
        # land its records in the SUCCESSOR's live file.
        self._check_owner()
        self._open_for_append()
        for frame in frames:
            self._fh.write(frame)
        self._fh.flush()
        self._fsync()
        self.records_appended += len(frames)
        n = sum(len(f) for f in frames)
        self.bytes_appended += n
        return n

    # -------------------------------------------------------------- replay
    def replay(self) -> Tuple[Optional[Dict], List[Dict]]:
        """(snapshot record or None, lifecycle records after it).

        Tolerates an empty file and a torn tail; raises
        :class:`JournalCorruption` on a complete-but-bad mid-file frame.
        A snapshot anywhere but record 0 supersedes everything before it
        (compaction replaces the file atomically, so mid-file snapshots
        only appear if an operator concatenated journals — honoring the
        LAST one keeps that well-defined)."""
        records, _ = self._scan()
        snapshot = None
        suffix: List[Dict] = []
        for rec in records:
            if rec.get("t") == SNAPSHOT:
                snapshot, suffix = rec, []
            else:
                suffix.append(rec)
        return snapshot, suffix

    # ---------------------------------------------------------- compaction
    def rewrite(self, snapshot: Dict, suffix: Iterable[Dict] = ()):
        """Snapshot-based compaction: atomically replace the journal with
        ``snapshot`` (+ optional ``suffix`` records).  The write goes to
        a sibling temp file first, so a crash mid-compaction leaves the
        old journal intact.  Raises :class:`JournalSuperseded` instead of
        replacing a file another incarnation already installed over the
        path — the one journal write RPC epoch fencing cannot stop (a
        resumed zombie compacting would clobber the successor's WAL)."""
        self._check_owner()
        if self._faults is not None:
            self._faults.fire("journal.append", detail=SNAPSHOT)
        if snapshot.get("t") != SNAPSHOT:
            snapshot = dict(snapshot, t=SNAPSHOT)
        tmp = self.path + ".compact"
        frames = [self._frame(snapshot)] + [self._frame(r) for r in suffix]
        self.close()
        with open(tmp, "wb") as f:
            for fr in frames:
                f.write(fr)
            f.flush()
            # compaction's durability barrier traverses the same
            # failpoint as append-path fsyncs, so chaos schedules can
            # fail it (the frontend degrades, old journal stays intact)
            if self._faults is not None:
                self._faults.fire("journal.fsync", detail=tmp)
            if self.fsync_enabled:
                os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self.fsync_enabled:
            # the rename itself must be durable, or a machine crash could
            # resurrect the pre-compaction file
            try:
                dfd = os.open(os.path.dirname(os.path.abspath(self.path)),
                              os.O_RDONLY)
            except OSError:
                dfd = None
            if dfd is not None:
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        self.compactions += 1
        self.records_appended += len(frames)
        self.bytes_appended += sum(len(fr) for fr in frames)
        # reopen for append directly: the file is exactly the frames just
        # written, so the lazy-open full-file rescan (a read+JSON-parse of
        # the snapshot on the serving control path right after every
        # compaction) is provably unnecessary here
        self._fh = open(self.path, "ab")
        st = os.fstat(self._fh.fileno())
        self._owned_id = (st.st_dev, st.st_ino)

    # ------------------------------------------------------------ lifecycle
    def close(self):
        if self._fh is not None:
            try:
                self._fh.flush()
            finally:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def recorded_epoch(journal) -> Optional[int]:
    """Highest writer epoch a journal records (the snapshot ``epoch``
    field or ``EPOCH`` records), or None for a pre-HA journal / missing
    file.  Standbys pass this as the acquisition FLOOR
    (``FrontendLease.acquire(min_epoch=...)``): if the lease record is
    lost while the fleet is at epoch N (KV master restart, an operator
    deleting the key), acquiring at epoch 1 would depose the healthy
    active AND be refused by the journal — a full outage that only
    heals one TTL per epoch increment.  The journal remembers N.

    This is a second full replay on the takeover path (``recover``
    replays again right after) — accepted: compaction every
    ``journal_compact_every`` records bounds the file to one snapshot
    plus a short suffix, and the floor is needed BEFORE ``acquire``,
    which is needed before ``recover`` may touch anything."""
    if not isinstance(journal, RequestJournal):
        journal = RequestJournal(journal)
    snapshot, records = journal.replay()
    epoch = None
    if snapshot is not None and snapshot.get("epoch") is not None:
        epoch = int(snapshot["epoch"])
    for rec in records:
        if rec.get("t") == EPOCH:
            epoch = max(epoch or 0, int(rec["epoch"]))
    return epoch
