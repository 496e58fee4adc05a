"""Fleet-wide KV fabric — the directory + transfer layer under
disaggregated prefill/decode serving (DistServe /
Mooncake shape: arXiv:2401.09670, arXiv:2407.00079).

Copied from ``paddle_tpu/inference/kv_fabric.py`` (the port never
imports the JAX package).

Three pieces, all built on rails that already exist:

* **Directory** (:class:`KVFabric`): a map from process-portable
  ``prefix_block_hash`` chain hashes (serving.py) to *(owner
  replica, writer epoch, chain depth)*, stored in the launch KV master
  (``distributed/launch/master.py`` — the same store the frontend lease
  and worker registration already live in).  A directory entry stamped
  with the writer's epoch IS a fenced block lease: readers reject
  entries whose epoch is below the highest epoch the fabric has seen
  (typed :class:`~.ha.StaleEpoch`, reusing :class:`~.ha.EpochFence`
  rather than inventing a new ownership story).  Chain *depth* rides
  each entry as the eviction cost signal — a deep chain is costlier to
  recompute than a shallow one, so capacity pressure drops shallow
  entries first (:meth:`KVFabric._enforce_capacity`).

* **Prefill-in-progress table**: CAS-claimed keys (one per chain tail
  hash) that dedupe concurrent identical prefills.
  Two identical prompts admitted together cost ONE prefill; the second
  waits for the first claim holder to publish, then pulls.

* **Transfer hop** (:meth:`KVFabric.pull`): moves bit-exact KV block
  payloads between engines via ``ServingEngine.export_blocks`` /
  ``import_blocks`` (serving.py).  Payloads are raw cache bits keyed by
  chain hash; equal hash ⇒ equal KV content (the chain-hash contract), so a
  decode replica that imports a chain is token-identical to one that
  computed it locally.  ``cache_quant='int8'`` engines hard-error on
  both ends: their cache bits are only meaningful under the writer's
  per-(slot, kv-head) dynamic scales.

What the directory does NOT guarantee: an entry is a *hint* with a
fenced writer, not a replicated block store.  The owner may have
evicted the block (export returns a partial payload) or died (the pull
raises); callers MUST be able to fall back to recomputing the prefix —
``ServingFrontend`` does exactly that.  Durability, replication and
read-repair are out of scope; losing the whole directory costs
recompute time, never correctness.

Transport
--------------------
:meth:`KVFabric.pull` is a degrade ladder; every rung preserves the
greedy+seeded token-parity contract because imported blocks are
bit-exact wherever (and however) they land:

1. **Direct wire** — when the source exposes a ``wire_endpoint`` (a
   ``blockwire.BlockWireServer`` data-plane listener) and the
   destination has ``pull_blocks``, the DESTINATION pulls the chain
   straight off the source over a persistent binary socket: one
   length+CRC32-framed message carrying one contiguous packed buffer
   (self-describing geometry header + raw cache bytes, no pickle).
   Payload bytes cross the wire ONCE; the frontend only orchestrates
   with directory-sized control messages (``_w_pull_blocks``).
2. **Frontend relay** — the compatibility fallback:
   ``src.export_blocks`` → ``dst.import_blocks`` dict payloads over
   the pickle control channel, relayed through the frontend (payload
   crosses the wire twice).  Entered when there is no wire endpoint or
   when the wire rung fails (``wire_fallbacks_total``).
3. **Recompute** — both transports failed; ``pull`` raises and the
   CALLER recomputes the prefix (``ServingFrontend`` does).

What is and is NOT fenced on the wire: the pull *handshake* carries
the caller's epoch and the serving side checks it against the same
``EpochFence`` its control RPCs use — a stale puller gets a typed
``StaleEpoch`` error frame before any payload bytes move (and
``StaleEpoch`` never falls back to relay: the caller is deposed, not
unlucky).  The payload bytes themselves are NOT fenced mid-flight;
that is safe because blocks are content-addressed (equal hash ⇒ equal
bits) and re-publication into the directory re-checks the fence.

Failpoint sites (chaos-schedulable, see faults.py / tools/chaos_serving.py):
``fabric.publish`` (prefill worker dies mid-stream, before its chain
reaches the directory), ``fabric.pull`` (decode pulls from a dead
peer), ``fabric.directory`` (directory reads, incl. the
stale-entry rejection path), ``fabric.wire`` (the data-plane listener
faults mid-handshake; registered in blockwire.py, degrades to relay).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .faults import register_failpoint
from .ha import EpochFence, StaleEpoch

__all__ = ["KVFabric", "FabricEntry", "MemoryKV", "payload_nbytes",
           "FABRIC_PUBLISH", "FABRIC_PULL", "FABRIC_DIRECTORY"]

FABRIC_PUBLISH = register_failpoint("fabric.publish")
FABRIC_PULL = register_failpoint("fabric.pull")
FABRIC_DIRECTORY = register_failpoint("fabric.directory")

BLOCKS_PREFIX = "/fabric/blocks/"
PREFILL_PREFIX = "/fabric/prefill/"


@dataclass(frozen=True)
class FabricEntry:
    """One directory row: a fenced lease on one prefix block."""
    hash: str
    owner: str            # replica/worker name that can export the block
    epoch: Optional[int]  # writer's frontend epoch (None = unfenced)
    depth: int            # 1-based position in the chain (eviction cost)


class MemoryKV:
    """In-process stand-in for ``launch.master.KVClient`` (same
    put/get/get_prefix/delete/cas surface) so single-process fleets,
    benches and tier-1 tests get a directory without an HTTP server."""

    def __init__(self):
        self._kv: Dict[str, str] = {}
        self._lock = threading.Lock()

    def put(self, key: str, value: str, timeout: float = 5) -> bool:
        with self._lock:
            self._kv[key] = value
        return True

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kv.get(key)

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        with self._lock:
            return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    def delete(self, key: str) -> bool:
        with self._lock:
            self._kv.pop(key, None)
        return True

    def cas(self, key: str, expect: Optional[str], new: str,
            timeout: float = 5) -> bool:
        with self._lock:
            if self._kv.get(key) != expect:
                return False
            self._kv[key] = new
            return True


def payload_nbytes(payload: Dict) -> int:
    """Total KV bytes in an ``export_blocks`` payload (trace attribution)."""
    total = 0
    for kv in payload.get("blocks", {}).values():
        total += sum(int(a.nbytes) for a in kv["k"])
        total += sum(int(a.nbytes) for a in kv["v"])
    return total


class KVFabric:
    """Fleet-level block directory + transfer hop (module docstring).

    ``master`` is either a ``host:port`` endpoint of the launch KV
    master or any object with the KVClient surface (``put``/``get``/
    ``get_prefix``/``delete``/``cas``) — :class:`MemoryKV` for
    in-process fleets, the standby's master object for HA stacks.
    """

    def __init__(self, master, *, fence: Optional[EpochFence] = None,
                 fault_injector=None, max_entries: Optional[int] = None):
        if isinstance(master, str):
            from ..distributed.launch.master import KVClient
            master = KVClient(master)
        self._kv = master
        self.fence = fence if fence is not None else EpochFence()
        self._faults = fault_injector
        self.max_entries = max_entries
        self.counters = {
            "published_total": 0,      # directory entries written
            "stale_entries_total": 0,  # entries rejected via StaleEpoch
            "pulls_total": 0,          # transfer hops attempted
            "pulled_blocks_total": 0,  # blocks imported on the dst side
            "pulled_bytes_total": 0,   # raw KV bytes moved (any transport)
            "prefill_claims_total": 0,
            "prefill_dedup_hits_total": 0,  # claim found held by a peer
            # transport ladder: wire bytes cross once,
            # relayed bytes cross twice — payload_hop_bytes ratio =
            # (wire*1 + relay*2) / pulled_bytes_total
            "wire_pulls_total": 0,     # pulls served by the direct rung
            "wire_bytes_total": 0,     # raw bytes over the data plane
            "wire_fallbacks_total": 0,  # wire rung failed → relay rung
            "relay_pulls_total": 0,    # pulls served by the relay rung
            "relay_bytes_total": 0,    # raw bytes relayed via frontend
        }

    # ------------------------------------------------------------------
    # epoch fencing

    def set_epoch(self, epoch: Optional[int]):
        """Advance the fabric's fence to the caller's epoch.  Entries
        written by lower epochs become stale leases from here on."""
        self.fence.check(epoch, "fabric.epoch")

    # ------------------------------------------------------------------
    # directory

    def publish_chain(self, owner: str, hashes: Sequence[str], *,
                      epoch: Optional[int] = None) -> int:
        """Record ``owner`` as the exporter for a chain of prefix block
        hashes (parent-first order; depth = 1-based chain position).
        A writer below the fabric's fenced epoch raises
        :class:`StaleEpoch` — a deposed frontend cannot install leases.
        An existing entry with a HIGHER epoch wins over ours (never
        downgrade a lease).  Returns the number of entries written."""
        if self._faults is not None:
            self._faults.fire(FABRIC_PUBLISH, detail=owner)
        self.fence.check(epoch, "fabric.publish")
        written = 0
        for depth, h in enumerate(hashes, start=1):
            cur = self._kv.get(BLOCKS_PREFIX + h)
            if cur is not None:
                try:
                    cur_epoch = json.loads(cur).get("epoch")
                except ValueError:
                    cur_epoch = None
                if (cur_epoch is not None and epoch is not None
                        and cur_epoch > epoch):
                    continue
            rec = json.dumps({"owner": owner, "epoch": epoch,
                              "depth": depth})
            self._kv.put(BLOCKS_PREFIX + h, rec)
            written += 1
        self.counters["published_total"] += written
        if self.max_entries is not None:
            self._enforce_capacity()
        return written

    def lookup(self, h: str) -> Optional[FabricEntry]:
        """Directory read for one chain hash.  Returns ``None`` on a
        miss; raises :class:`StaleEpoch` (after deleting the row) when
        the entry's writer epoch is below the fabric's fenced epoch —
        the lease belongs to a deposed incarnation and the owner may not
        even hold the block any more."""
        if self._faults is not None:
            self._faults.fire(FABRIC_DIRECTORY, detail=h[:12])
        raw = self._kv.get(BLOCKS_PREFIX + h)
        if raw is None:
            return None
        try:
            rec = json.loads(raw)
        except ValueError:
            self._kv.delete(BLOCKS_PREFIX + h)
            return None
        entry = FabricEntry(hash=h, owner=str(rec.get("owner", "")),
                            epoch=rec.get("epoch"),
                            depth=int(rec.get("depth", 1)))
        highest = self.fence.highest
        if (entry.epoch is not None and highest is not None
                and entry.epoch < highest):
            self._kv.delete(BLOCKS_PREFIX + h)
            self.counters["stale_entries_total"] += 1
            raise StaleEpoch(
                f"fabric directory entry for {h[:12]}… was written at "
                f"epoch {entry.epoch} but the fabric has seen epoch "
                f"{highest}: the lease holder is a deposed incarnation — "
                "recompute the prefix instead of pulling")
        return entry

    def lookup_chain(self, hashes: Sequence[str]) -> List[FabricEntry]:
        """Longest usable prefix of a chain that has live directory
        entries.  Stale entries end the chain (they are deleted and
        counted; the caller recomputes from there) — a chain is only as
        trustworthy as its shallowest fresh lease."""
        out: List[FabricEntry] = []
        for h in hashes:
            try:
                entry = self.lookup(h)
            except StaleEpoch:
                break
            if entry is None:
                break
            out.append(entry)
        return out

    def entries(self) -> Dict[str, FabricEntry]:
        got = self._kv.get_prefix(BLOCKS_PREFIX)
        out: Dict[str, FabricEntry] = {}
        for k, raw in got.items():
            h = k[len(BLOCKS_PREFIX):]
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            out[h] = FabricEntry(hash=h, owner=str(rec.get("owner", "")),
                                 epoch=rec.get("epoch"),
                                 depth=int(rec.get("depth", 1)))
        return out

    def drop_owner(self, owner: str) -> int:
        """Remove every lease held by ``owner`` (dead replica): its
        blocks are gone with its process, so the hints are now lies."""
        n = 0
        for h, entry in self.entries().items():
            if entry.owner == owner:
                self._kv.delete(BLOCKS_PREFIX + h)
                n += 1
        return n

    def eviction_cost(self, h: str) -> int:
        """Chain depth of a fleet-visible block (0 = not in the
        directory).  Deeper chains cost more prefill to rebuild."""
        raw = self._kv.get(BLOCKS_PREFIX + h)
        if raw is None:
            return 0
        try:
            return int(json.loads(raw).get("depth", 1))
        except ValueError:
            return 0

    def _enforce_capacity(self):
        entries = self.entries()
        excess = len(entries) - self.max_entries
        if excess <= 0:
            return
        # shallow chains first: cheapest to recompute, least worth a lease
        for entry in sorted(entries.values(),
                            key=lambda e: (e.depth, e.hash))[:excess]:
            self._kv.delete(BLOCKS_PREFIX + entry.hash)

    # ------------------------------------------------------------------
    # prefill-in-progress table (concurrent-identical-prefill dedup)

    def begin_prefill(self, key: str, owner: str, *,
                      epoch: Optional[int] = None) -> bool:
        """CAS-claim a prefill for chain-tail hash ``key``.  Returns
        True when this caller won the claim (it must prefill + publish +
        :meth:`finish_prefill`); False when a live claim is already
        held — the caller should wait for the holder's publish instead
        of burning a duplicate prefill.  A claim left by a LOWER epoch
        is stale (its frontend is deposed mid-prefill) and is replaced."""
        self.fence.check(epoch, "fabric.begin_prefill")
        rec = json.dumps({"owner": owner, "epoch": epoch})
        if self._kv.cas(PREFILL_PREFIX + key, None, rec):
            self.counters["prefill_claims_total"] += 1
            return True
        cur = self._kv.get(PREFILL_PREFIX + key)
        if cur is not None:
            try:
                cur_epoch = json.loads(cur).get("epoch")
            except ValueError:
                cur_epoch = None
            highest = self.fence.highest
            if (cur_epoch is not None and highest is not None
                    and cur_epoch < highest
                    and self._kv.cas(PREFILL_PREFIX + key, cur, rec)):
                self.counters["prefill_claims_total"] += 1
                return True
        self.counters["prefill_dedup_hits_total"] += 1
        return False

    def prefill_owner(self, key: str) -> Optional[str]:
        raw = self._kv.get(PREFILL_PREFIX + key)
        if raw is None:
            return None
        try:
            return str(json.loads(raw).get("owner", ""))
        except ValueError:
            return None

    def finish_prefill(self, key: str):
        """Release a prefill claim (publish done, or the pass failed and
        a waiter should be free to re-claim)."""
        self._kv.delete(PREFILL_PREFIX + key)

    # ------------------------------------------------------------------
    # transfer hop

    def pull(self, src, dst, hashes: Sequence[str], *, owner: str = "",
             epoch: Optional[int] = None) -> Tuple[int, int, str]:
        """Move blocks ``src`` → ``dst`` down the transport degrade
        ladder (module docstring): direct wire when the source exposes
        a ``wire_endpoint`` and the destination can ``pull_blocks``,
        else (or on a wire fault) the frontend-relay
        ``export_blocks``/``import_blocks`` dict path.  Returns
        ``(blocks_imported, payload_bytes, transport)`` with transport
        ``"wire"`` or ``"relay"``.  ``StaleEpoch`` from the wire
        handshake propagates — a deposed caller must not retry via
        relay.  Any other failure of the LAST rung raises too: the
        caller owns the recompute fallback."""
        if self._faults is not None:
            self._faults.fire(FABRIC_PULL, detail=owner)
        self.counters["pulls_total"] += 1
        hashes = list(hashes)
        if epoch is None:
            epoch = self.fence.highest
        endpoint = getattr(src, "wire_endpoint", None)
        if endpoint and hasattr(dst, "pull_blocks"):
            try:
                imported, nbytes = dst.pull_blocks(endpoint, hashes,
                                                   epoch=epoch)
            except StaleEpoch:
                raise
            except Exception:  # noqa: BLE001 — torn frame, dead listener,
                # injected fabric.wire: degrade to the relay rung below
                self.counters["wire_fallbacks_total"] += 1
            else:
                self.counters["wire_pulls_total"] += 1
                self.counters["wire_bytes_total"] += int(nbytes)
                self.counters["pulled_blocks_total"] += int(imported)
                self.counters["pulled_bytes_total"] += int(nbytes)
                return int(imported), int(nbytes), "wire"
        payload = src.export_blocks(hashes)
        nbytes = payload_nbytes(payload)
        imported = dst.import_blocks(payload)
        self.counters["relay_pulls_total"] += 1
        self.counters["relay_bytes_total"] += nbytes
        self.counters["pulled_blocks_total"] += int(imported)
        self.counters["pulled_bytes_total"] += nbytes
        return int(imported), nbytes, "relay"
