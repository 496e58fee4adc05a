"""Continuous-batching serving engine over the paged KV cache — the
PyTorch + CUDA port of ``paddle_tpu/inference/serving.py``.

What carries over unchanged is the host scheduling: ``SamplingParams``,
``BlockManager`` with its prefix-cache hash index, ``ServingRequest``,
admission, chunked prefill, the megastep arming rules, deadline budgets,
eviction and retirement are copied line for line, so the scheduling
counters (``megasteps``, ``megasteps_mixed``, ``prefill_chunks``,
``prefill_tokens_computed``, ``prefix_hit_blocks``) match the JAX engine
request for request.

What changes is the device side.  Each ``jax.jit`` program of the
reference is a plain function here:

- the trunk (``_trunk``) runs embed -> layers -> final norm with the
  Hopper kernels on its path: RMSNorm and residual + RMSNorm (K1,
  ``ops/hopper/fused_norm.py``), rope (K2) and the paged attention (K4)
  inside ``ops.paged_attention.blha_attention``, and SwiGLU (K3,
  ``ops/hopper/fused_ops.py``).  The projections are ``torch.matmul``, as
  the reference leaves them to XLA;
- each ``lax.scan`` megastep (pure-decode and mixed-phase) is a K-iteration
  loop over device tensors with no host sync inside: tokens, masks,
  remaining budgets, deadline budgets and sample indices stay on the
  device, and the host reads the stacked outputs once after the loop;
- the KV caches are updated IN PLACE (the reference donates them to each
  program and gets new ones back).  A frozen or finished row inside a
  scan re-feeds the same token at the same position, so it rewrites the
  same KV bits, as in the reference.

Speculative decoding (``spec_k > 0``): a pure-decode batch drafts up to
``spec_k`` tokens a row on the host (``ngram_draft``) and one verify
forward (``_run_spec_verify``) scores ``[last token] + draft`` for every
row, redraws each position under the non-spec key stream and commits the
longest draft prefix the redraw reproduces, plus one token.  Rejected
positions wrote K/V that the next feed overwrites before any read, so
spec-on gives spec-off's tokens.

The program cache: on CUDA the two megastep loops (``_run_megastep``,
``_run_mixed``), the verify and the single step (``_run_step``), sampling
and its threefry draw included, run as CUDA graphs (``jit/graphs.py``),
one per (program, K, ``all_greedy``), K bucketed to powers of two up to
``megastep_k`` for the pure-decode loop and ``megastep_k`` for the mixed
one, one per ("spec", ``all_greedy``) for the verify (its shapes are
fixed by the batch and ``spec_k``), and one per ("step", ``mq``,
``all_greedy``, ``capture_sample_probs``) for the single step, ``mq`` 1
for a pure-decode step (a [B] token buffer) and ``token_budget`` for one
that carries prefill (a [T] buffer), as the reference compiles its step
once per ``mq``.  A key's first call runs eagerly (its results are
returned) and is then captured; later calls copy the host arrays, block
tables included, into the graph's static buffers and replay it.  A graph
reads and writes the KV pools and, under the int8 cache, each layer's
``cache_scales`` at fixed addresses (the step's dynamic refresh rewrites
them in place).  ``compile_count`` counts the captures, as the reference
counts its jit programs; ``load_weights`` drops the graphs, which read
the old weights.  On the CPU nothing is captured (``compile_count`` stays
0).
The private ``_graphs = False`` runs the loops eagerly on CUDA too, for
comparison (the tests and ``chip_smoke.py``); there is no public switch,
as the reference has none.
Sampling draws on the device with JAX's threefry under the key
``fold_in(key(seed), sample index)`` (``framework/random.py``), so a seeded
stream is the JAX engine's, and replays across K, rebuilds and preemption.

Block transfer (``export_blocks[_packed]``, ``import_blocks[_packed]``)
moves published KV blocks between engines as bit-exact payloads keyed by
chain hash, with the reference's headers; ``pull_blocks`` takes a chain
straight off a peer's ``blockwire.BlockWireServer`` (the serving control
plane's one-hop pull, ``control_plane.py`` / ``kv_fabric.py``).

The int8 paged cache (``cache_quant="int8"``, the reference's dynamic
cache-quant serving mode): uint8 blocks with float32 per-(slot, KV head)
scales (``cache_scales``, a dict of ``kq``, ``vq``, ``kd``, ``vd`` [B, KV]
per layer) that a row's one-shot prefill sets and every later step reads,
refreshed in place by ``blha_attention`` in the single-step program and
read at fixed addresses by the pure-decode loop's CUDA graph; attention
through K4-int8.  Its scheduling contract is the reference's: a prompt
must prefill in one step (longer than ``token_budget`` is a ValueError at
``add_request``, and a prefill waits for budget rather than chunk), no
mixed-phase loop, no speculation, no prefix cache, no block transfer.

``ServingEngine(model, ..., device=None)`` runs on CUDA and raises
without it; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

import hashlib
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..framework.random import categorical, fold_in, key
from ..jit.graphs import GraphCache
from ..ops.hopper import launch_counters
from ..ops.hopper.fused_norm import rms_norm_fused, rms_norm_residual_fused
from ..ops.hopper.fused_ops import swiglu_fused
from ..ops.paged_attention import blha_attention, plan_step
from .faults import (InjectedDrop, InjectedFault, InjectedTimeout,
                     register_failpoint)

__all__ = ["BlockManager", "ServingRequest", "ServingEngine",
           "SamplingParams", "prefix_block_hash", "prompt_block_hashes",
           "ngram_draft"]

# fired at the top of load_weights, BEFORE any state is touched, so an
# injected swap fault leaves the old weights fully serving
WEIGHTS_SWAP = register_failpoint("weights.swap")
# speculative decoding: both sites DEGRADE, never corrupt — a drafting
# fault empties that row's draft (the verify still commits its one
# non-spec token), a verify fault sends the whole step down the non-spec
# path.  Either way the tokens are spec-off's.
SPEC_DRAFT = register_failpoint("engine.spec_draft")
SPEC_VERIFY = register_failpoint("engine.spec_verify")
_INJECTED = (InjectedFault, InjectedTimeout, InjectedDrop)


@dataclass
class SamplingParams:
    """Per-request decode sampling knobs, applied on the device.

    ``temperature=0`` (default) is exact greedy argmax — bit-identical to
    the engine's historical path, which is what the preempt/resume,
    prefix-cache-parity, and chaos token-identity contracts are stated
    over.  With ``temperature > 0``: logits are scaled, the top-k then
    top-p (nucleus) filters apply, and the token is drawn with a
    per-request random stream derived ONLY from ``(seed, sample index)`` —
    never from batch slot, megastep size, or replica — so the same seed
    replays the same token stream across preemption, failover resume,
    and worker restarts.  ``logprobs=True`` additionally returns the
    log-softmax of the RAW logits at each sampled token (temperature- and
    filter-independent, so greedy and sampled runs report comparable
    values)."""

    temperature: float = 0.0
    top_k: int = 0          # 0 = no top-k filter
    top_p: float = 1.0      # 1.0 = no nucleus filter
    seed: int = 0
    logprobs: bool = False
    # opt OUT of speculative decoding for this request (only meaningful
    # on a spec_k > 0 engine; the verify then never arms for its batch
    # unless another row speculates, and this row is never drafted)
    spec: bool = True

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        # the seed feeds an int32 tensor of the device step:
        # reject out-of-range here (submit time) — otherwise numpy raises
        # mid-step and the control plane reads that as a replica DEATH,
        # burning the whole retry budget on one bad user parameter
        if not 0 <= self.seed < 2 ** 31:
            raise ValueError("seed must be in [0, 2**31)")

    @classmethod
    def coerce(cls, v) -> "SamplingParams":
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        return cls(**dict(v))   # plain dict: the RPC wire format

    def to_wire(self) -> Dict:
        """The dict form shipped over RPC (and back through ``coerce``) —
        the ONE place the field list is enumerated, so a new sampling
        knob cannot be silently dropped at a transport boundary."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed,
                "logprobs": self.logprobs, "spec": self.spec}


def _filtered(scaled, top_ks, top_ps):
    """Top-k then top-p in sorted space (ties at the threshold are kept);
    filtered logits are -inf."""
    V = scaled.shape[1]
    srt, order = torch.sort(scaled, dim=-1, descending=True)
    kth = srt.gather(1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
    keep_k = (top_ks[:, None] <= 0) | (scaled >= kth)
    # the sorted probabilities are the unsorted ones reordered (not a
    # second softmax), so the cutoff compares equal to its own token
    probs = torch.softmax(scaled, dim=-1)
    probs_srt = probs.gather(1, order)
    csum = torch.cumsum(probs_srt, dim=-1)
    # nucleus cutoff: the prob of the first sorted token at which the
    # cumulative mass reaches p (so at least one token always stays)
    first = torch.argmax((csum >= top_ps[:, None]).to(torch.int32), dim=-1)
    cutoff = probs_srt.gather(1, first[:, None])
    keep_p = (top_ps[:, None] >= 1.0) | (probs >= cutoff)
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, float("-inf")))


def _draw(filt, seeds, sample_pos):
    """One categorical draw per row of the filtered logits under the key
    ``fold_in(key(seed), sample_pos)`` of that row: JAX's threefry draw,
    token for token (``framework/random.py``), on the logits' device."""
    keys = fold_in(key(seeds), sample_pos)
    return categorical(keys, filt).to(torch.int32)


def _sample_tokens(logits, temps, top_ks, top_ps, seeds, sample_pos,
                   return_probs: bool = False,
                   all_greedy: Optional[bool] = None):
    """Next-token selection for one batch of logits rows [B, V], on the
    logits' device.

    Greedy rows (``temps <= 0``) take the exact float32 argmax.  Sampled
    rows divide by temperature, apply top-k and top-p in sorted space and
    draw with threefry under ``fold_in(key(seed), sample_pos)``.  The caller
    passes ``all_greedy`` (it knows the temperatures on the host) so an
    all-greedy batch skips the two [B, V] sorts without a device sync;
    None reads it from ``temps``.  Returns (next_token [B] int32,
    raw-logit logprob of that token [B] float32, and with
    ``return_probs`` the renormalized post-filter distribution [B, V] the
    token was drawn from — a one-hot at the argmax for greedy rows — else
    None)."""
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    is_greedy = temps <= 0.0
    if all_greedy is None:
        all_greedy = bool(is_greedy.all())
    probs = None
    if return_probs or not all_greedy:
        filt = _filtered(lg / torch.clamp(temps, min=1e-6)[:, None], top_ks,
                         top_ps)
        nxt = torch.where(is_greedy, greedy, _draw(filt, seeds, sample_pos))
        if return_probs:
            one_hot = torch.zeros_like(lg).scatter_(
                1, greedy.long()[:, None], 1.0)
            probs = torch.where(is_greedy[:, None], one_hot,
                                torch.softmax(filt, dim=-1))
    else:
        nxt = greedy
    logprob = torch.log_softmax(lg, dim=-1).gather(
        1, nxt.long()[:, None])[:, 0]
    return nxt, logprob, probs


def ngram_draft(history: Sequence[int], k: int,
                max_ngram: int = 3) -> List[int]:
    """Model-free n-gram / prompt-lookup drafting: find the most recent
    EARLIER occurrence of the history's longest matching tail n-gram (n =
    ``max_ngram`` down to 1) and propose up to ``k`` tokens of its
    continuation.  Pure Python over ints — deterministic, seed-free, and
    identical across processes, so a resumed or replayed request re-drafts
    the same proposals.  Reads ONE request's ``prompt + generated`` only.
    Returns ``[]`` when the history is too short or no tail n-gram recurs:
    drafting is best-effort, the verify commits >= 1 token either way."""
    h = [int(t) for t in history]
    n_hist = len(h)
    if k <= 0 or n_hist < 2:
        return []
    for n in range(min(int(max_ngram), n_hist - 1), 0, -1):
        pat = h[-n:]
        for i in range(n_hist - n - 1, -1, -1):
            if h[i:i + n] == pat:
                return h[i + n:i + n + k]
    return []


def prefix_block_hash(parent: Optional[str], tokens: Sequence[int]) -> str:
    """Chain hash of ONE full block of token ids:
    ``blake2b(parent_hash, token bytes)``.  The chaining means a block's
    hash commits to the entire token prefix before it, so equal hashes ⇒
    equal KV content.  blake2b (not builtin ``hash``, which is randomized
    per process) keeps hashes comparable across worker processes — the
    frontend's prefix-affinity routing matches its own prompt hashes
    against hash sets shipped from remote replicas."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent.encode() if parent else b"\x00root")
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


def prompt_block_hashes(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chain hashes for every FULL block of ``tokens`` (a partial tail
    block is never cached or matched — it would alias every continuation
    sharing its first few tokens)."""
    out: List[str] = []
    parent = None
    for i in range(len(tokens) // block_size):
        parent = prefix_block_hash(
            parent, tokens[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


class BlockManager:
    """Host-side refcounted allocator over the global block pool, with a
    content-hash index for automatic prefix caching.

    A block is in exactly one of three states:

    * **free**   — on the free list; the next ``allocate`` may return it.
    * **live**   — refcount ≥ 1: owned by one or more sequences.  ``fork``
      shares a live (or cached) block with another sequence read-only;
      ``free`` decrements and only releases at refcount 0.
    * **cached** — refcount 0 but content-addressable: ``publish`` gave it
      a chain hash, so when its last owner freed it, it was parked in an
      LRU instead of hard-freed.  ``lookup`` + ``fork`` revive it for a
      new sequence; ``allocate`` evicts from the LRU (oldest first,
      dropping the hash mapping) only when the true free list is empty.

    ``free`` rejects double-frees loudly: releasing a block more times
    than it has owners would hand the same block to two sequences on the
    next ``allocate`` and silently corrupt both KV streams (the failure
    mode is token garbage long after the actual bug).  Mid-flight release
    of a live request's blocks (eviction/preemption) is fine — that is
    the normal path for ``ServingEngine.evict``."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}          # live blocks only
        self._hash_of: Dict[int, str] = {}      # published block -> hash
        self._block_of: Dict[str, int] = {}     # hash -> published block
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref 0
        self.evictions = 0   # cached blocks dropped to satisfy allocate

    def can_allocate(self, n: int) -> bool:
        return len(self._free) + len(self._lru) >= n

    def allocate(self, n: int) -> List[int]:
        if not self.can_allocate(n):
            raise RuntimeError(f"block pool exhausted (need {n}, "
                               f"free {self.num_free})")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # true free list empty: evict the least-recently-cached
                # block (its KV becomes unreachable — drop the hash)
                b, _ = self._lru.popitem(last=False)
                h = self._hash_of.pop(b)
                del self._block_of[h]
                self.evictions += 1
            self._ref[b] = 1
            out.append(b)
        assert len(set(out)) == len(out), \
            f"free-list corruption: allocate returned duplicate ids {out}"
        return out

    def free(self, blocks: List[int]):
        counts = Counter(blocks)
        internal = sorted(b for b, c in counts.items() if c > 1)
        bad = sorted(b for b in counts if not 0 <= b < self.num_blocks)
        dup = sorted(b for b in counts
                     if 0 <= b < self.num_blocks and b not in internal
                     and self._ref.get(b, 0) < counts[b])
        if dup or internal or bad:
            raise RuntimeError(
                "BlockManager.free: "
                + "; ".join(filter(None, [
                    f"double-free of block ids {dup}" if dup else "",
                    f"ids repeated in the freed list {internal}"
                    if internal else "",
                    f"ids outside the pool {bad}" if bad else ""])))
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] > 0:
                continue          # still shared with another sequence
            del self._ref[b]
            if b in self._hash_of:
                self._lru[b] = None   # published: park evictable, reusable
            else:
                self._free.append(b)

    def fork(self, block: int):
        """Hand ``block`` to one more sequence read-only (refcount++).  A
        cached (refcount-0, LRU-parked) block is revived: pulled out of
        the LRU with refcount 1.  Forking a free block is a bug."""
        if not 0 <= block < self.num_blocks:
            raise RuntimeError(f"BlockManager.fork: id {block} outside the "
                               f"pool of {self.num_blocks}")
        if block in self._lru:
            del self._lru[block]
            self._ref[block] = 1
        elif self._ref.get(block, 0) > 0:
            self._ref[block] += 1
        else:
            raise RuntimeError(
                f"BlockManager.fork: block {block} is on the free list — "
                "only live or cached blocks can be shared")

    def lookup(self, h: str) -> Optional[int]:
        """Block currently holding the content with chain hash ``h``
        (live or cached), or None."""
        return self._block_of.get(h)

    def publish(self, block: int, h: str) -> bool:
        """Register ``block``'s content under chain hash ``h`` so a later
        ``free`` parks it in the LRU (reusable) instead of hard-freeing.
        No-op (False) when the hash is already mapped — first publisher
        wins; chained hashing guarantees the content is identical — or
        when the block already carries a hash."""
        if h in self._block_of or block in self._hash_of:
            return False
        if self._ref.get(block, 0) <= 0:
            raise RuntimeError(
                f"BlockManager.publish: block {block} is not live — publish "
                "before freeing (free() is what parks published blocks)")
        self._block_of[h] = block
        self._hash_of[block] = h
        return True

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def cached_hashes(self) -> Set[str]:
        """Chain hashes currently content-addressable (live or cached) —
        the engine's prefix-affinity summary shipped to the frontend."""
        return set(self._block_of)

    def drop_cached(self) -> int:
        """Invalidate the content-addressed cache: evictable (refcount-0)
        published blocks return to the free list and EVERY hash mapping
        is dropped (a live publisher keeps its block but loses the hash,
        so a later ``free`` hard-frees instead of parking).  The weight-
        swap path calls this — KV computed under the old weights must
        never be matched by a new-version prompt.  Returns the number of
        hashes invalidated."""
        n = len(self._block_of)
        for b in self._lru:
            self._free.append(b)
        self._lru.clear()
        self._block_of.clear()
        self._hash_of.clear()
        return n

    @property
    def num_free(self) -> int:
        """Blocks allocatable right now: truly free plus cached-evictable.
        (Admission headroom math must see cached blocks as capacity, or a
        warm cache would look like an exhausted pool.)"""
        return len(self._free) + len(self._lru)

    @property
    def num_cached(self) -> int:
        return len(self._block_of)

    @property
    def num_evictable(self) -> int:
        return len(self._lru)


@dataclass
class ServingRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # sample index of this request's FIRST new token: a preempted request
    # resumed with prompt+generated as its new prefill passes the number
    # of tokens already sampled here, so the seeded key stream continues
    # exactly where the evicted run stopped
    sample_offset: int = 0
    # tracing wire context: {"trace", "span", "parent", "rid"}
    # stamped by the frontend (rid = the FRONTEND rid); engine lifecycle
    # events (prefill done, megastep boundaries) are recorded under it
    trace: Optional[Dict] = None
    # absolute engine-clock deadline (None = no deadline): set from the
    # ``deadline_s`` admission kwarg; megastep launches convert it into
    # an in-graph iteration budget (see _deadline_budgets)
    deadline_t: Optional[float] = None
    # runtime state
    generated: List[int] = field(default_factory=list)
    logprob_values: List[float] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)
    prefill_pos: int = 0          # prompt tokens already cached
    cached_prefix_tokens: int = 0  # of those, tokens REUSED from the cache
    chunks_fed: int = 0           # prompt chunks fed so far (trace index)
    slot: int = -1                # batch row while active
    done: bool = False

    @property
    def in_prefill(self) -> bool:
        return self.prefill_pos < len(self.prompt)

    @property
    def context_len(self) -> int:
        return self.prefill_pos + len(self.generated)




def _dtype_name(dtype: torch.dtype) -> str:
    """A cache dtype as the reference's headers name it ("bfloat16",
    "float32")."""
    return str(dtype).split(".")[1]


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a cache's bytes travel as: int16 for bfloat16 (numpy
    has no bfloat16 of its own), else the dtype's own."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of ``_host_dtype`` (a view)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy()


def _block_tensor(a, dtype: torch.dtype, shape) -> torch.Tensor:
    """One layer's K or V of an imported block as a CPU tensor of the
    cache's ``dtype`` and ``shape``: a tensor, or a numpy array — a
    bfloat16 one (``ml_dtypes``, the reference's export) read through a
    16-bit integer view, without importing ``ml_dtypes``.  Anything else
    is a ValueError."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
    elif isinstance(a, np.ndarray):
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.int16)).view(
                torch.bfloat16)
        elif a.dtype.name == _dtype_name(dtype):
            t = torch.from_numpy(np.array(a))
        else:
            t = None
    else:
        raise ValueError(f"import_blocks: a block entry is "
                         f"{type(a).__name__}, not a tensor or an array")
    if t is None or t.dtype != dtype:
        raise ValueError(f"import_blocks: a block entry of dtype "
                         f"{a.dtype}, the cache's is {_dtype_name(dtype)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"import_blocks: a block entry of shape "
                         f"{tuple(t.shape)}, the cache's blocks are "
                         f"{tuple(shape)}")
    return t


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


class ServingEngine:
    """Continuous batching for a LlamaForCausalLM (single process).

    >>> eng = ServingEngine(model, max_batch_size=4, max_seq_len=256)
    >>> rid = eng.add_request([1, 5, 7], max_new_tokens=16)
    >>> outputs = eng.run()   # {rid: [token, ...]}
    """

    # data-plane listener endpoint ("host:port"), stamped by
    # blockwire.BlockWireServer when this engine serves direct
    # engine-to-engine block pulls; None = relay-only (KVFabric.pull's
    # degrade ladder skips the wire rung)
    wire_endpoint: Optional[str] = None

    def __init__(self, model, max_batch_size: int = 4, max_seq_len: int = 256,
                 block_size: int = 16, token_budget: int = 32,
                 num_blocks: Optional[int] = None, cache_dtype=None,
                 cache_quant: str = "none", prefix_cache="auto",
                 megastep_k: int = 8, fault_injector=None,
                 capture_sample_probs: bool = False,
                 trace_recorder=None,
                 deadline_token_seconds: Optional[float] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_k: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        from .faults import FaultInjector

        self.device = resolve_device(device)
        if cache_quant not in ("none", "int8"):
            raise ValueError("cache_quant must be 'none' or 'int8'")
        if int(spec_k) < 0:
            raise ValueError("spec_k must be >= 0")
        self.cache_quant = cache_quant
        # seeded failpoint registry (faults.py): None (the default, unless
        # PADDLE_TPU_FAULTS is set) keeps the step loop at a single
        # attribute test of cost
        self._faults = (fault_injector if fault_injector is not None
                        else FaultInjector.from_env())
        cfg = model.config
        self.cfg = cfg
        self.B = int(max_batch_size)
        self.T = int(token_budget)
        self.bs = int(block_size)
        self.P = (int(max_seq_len) + self.bs - 1) // self.bs  # blocks/seq
        self.max_seq_len = self.P * self.bs
        nb = num_blocks if num_blocks is not None else self.B * self.P
        self.blocks = BlockManager(int(nb))
        self.H = cfg.num_attention_heads
        self.KV = cfg.num_key_value_heads
        self.D = cfg.head_dim
        self.E = cfg.hidden_size
        self.L = cfg.num_hidden_layers
        if prefix_cache not in ("auto", True, False):
            raise ValueError("prefix_cache must be 'auto', True, or False")
        if cache_quant == "int8" and prefix_cache is True:
            raise ValueError(
                "prefix_cache cannot be combined with cache_quant='int8': "
                "the int8 cache dequantizes through per-(slot, kv-head) "
                "DYNAMIC scales frozen at each sequence's own prefill, so a "
                "block's uint8 payload is only meaningful under its writer's "
                "scales — a second sequence sharing the block would "
                "dequantize garbage. Use the unquantized cache with the "
                "prefix cache, or pass prefix_cache=False")
        # 'auto' = on wherever it is sound (everything but int8)
        self.prefix_cache_enabled = (cache_quant != "int8"
                                     and prefix_cache in ("auto", True))
        self.prefix_hit_blocks = 0      # full blocks reused from the cache
        self.prefix_miss_blocks = 0     # full prompt blocks that missed
        self.prefill_tokens_computed = 0  # prompt tokens actually fed
        if cache_quant == "int8" and cache_dtype is not None:
            raise ValueError(
                "cache_quant='int8' fixes the cache dtype to uint8 — don't "
                "pass cache_dtype with it")
        self._compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                               else torch.float32)
        if cache_quant == "int8":
            cache_dtype = torch.uint8
        elif cache_dtype is None:
            cache_dtype = self._compute_dtype
        else:
            cache_dtype = _torch_dtype(cache_dtype)

        self._weights = self._extract_weights(model)
        self.weights_version = "v0"
        self.model_id = "default"
        self._rope = self._build_rope(cfg)
        # one block past the pool: the drop block, where the K/V writes
        # the reference drops land (ops/paged_attention.py)
        self.key_caches = [torch.zeros((nb + 1, self.KV, self.bs, self.D),
                                       dtype=cache_dtype, device=self.device)
                           for _ in range(self.L)]
        self.value_caches = [torch.zeros_like(self.key_caches[0])
                             for _ in range(self.L)]
        # int8: each layer's per-(slot, kv-head) scales, set by a row's
        # prefill (blha_attention refreshes them in place) and read by its
        # decode steps; the megastep graph reads them at these addresses
        self.cache_scales = ([
            {k: torch.zeros((self.B, self.KV), dtype=torch.float32,
                            device=self.device)
             for k in ("kq", "vq", "kd", "vd")} for _ in range(self.L)]
            if cache_quant == "int8" else None)
        # blha_attention's quantization arguments, by layer
        self._layer_quant = [
            {} if sc is None else dict(
                cache_quant="dynamic", cache_k_quant_scales=sc["kq"],
                cache_v_quant_scales=sc["vq"],
                cache_k_dequant_scales=sc["kd"],
                cache_v_dequant_scales=sc["vd"])
            for sc in (self.cache_scales or [None] * self.L)]
        self.block_tables = np.full((self.B, self.P), -1, np.int32)

        # capture the renormalized post-top-k/top-p distribution each
        # drawn token was sampled from (engine-local debug/verification
        # knob: costs the [B,V] filter even for greedy batches)
        self.capture_sample_probs = bool(capture_sample_probs)
        self._queue: List[ServingRequest] = []
        self._active: Dict[int, ServingRequest] = {}
        self._finished: Dict[int, List[int]] = {}
        self._emitted_logprobs: Dict[int, List[float]] = {}
        self._emitted_sample_probs: Dict[int, List[np.ndarray]] = {}
        self._next_rid = 0
        self._free_slots = list(range(self.B - 1, -1, -1))
        # megastep decode: K device iterations per host round trip whenever
        # any scheduled row is decoding (1 = per-token stepping)
        if int(megastep_k) < 1:
            raise ValueError("megastep_k must be >= 1")
        self.megastep_k = int(megastep_k)
        self.megasteps = 0          # megastep launches (monotone)
        self.megastep_tokens = 0    # tokens emitted via the megastep path
        self.megasteps_mixed = 0    # of those launches, mixed-phase loops
        self.prefill_chunks = 0     # prompt chunks fed (all paths)
        # tokens per prompt chunk inside the mixed-phase loop (default
        # block_size); <= block_size keeps one chunk inside one KV block
        pc = self.bs if prefill_chunk_tokens is None else int(prefill_chunk_tokens)
        if not 1 <= pc <= self.bs:
            raise ValueError(
                f"prefill_chunk_tokens={pc} must be in [1, block_size="
                f"{self.bs}]")
        self.pc = pc
        # speculative decoding: n-gram drafts of up to spec_k tokens per
        # pure-decode row, verified (and committed) by ONE batched
        # forward.  0 (default) disarms the path entirely.
        self.spec_k = int(spec_k)
        self.spec_accepted_tokens = 0   # draft tokens committed (monotone)
        self.spec_draft_tokens = 0      # draft tokens proposed (monotone)
        self.spec_verify_forwards = 0   # rows scored by verify launches
        # in-graph deadline budgets: seconds one loop iteration costs.  An
        # explicit deadline_token_seconds pins it; None lets the engine
        # learn an EWMA from measured megastep execute time.
        if deadline_token_seconds is not None and deadline_token_seconds <= 0:
            raise ValueError("deadline_token_seconds must be > 0")
        self._tau_override = deadline_token_seconds is not None
        self._tau = (float(deadline_token_seconds)
                     if deadline_token_seconds is not None else None)
        # per-request tracing: an optional FlightRecorder ring (None keeps
        # every hook at a single attribute test)
        self.trace_recorder = trace_recorder
        self._clock = clock
        # cumulative host-side seconds per step phase (schedule = admission
        # + batch marshalling, execute = device work + the one read-back,
        # harvest = token/unblocking bookkeeping)
        self.phase_seconds = {"schedule": 0.0, "execute": 0.0, "harvest": 0.0}
        # the megastep loops, the verify and the single step as CUDA
        # graphs, one per (program, K, all_greedy), ("spec", all_greedy) or
        # ("step", mq, all_greedy, capture_sample_probs), counted in
        # compile_count; never on the CPU.  Only the tests and
        # chip_smoke.py set _graphs = False (the eager loops on CUDA, for
        # comparison)
        self._graphs = self.device.type == "cuda"
        self._graph_cache = GraphCache(self.device, counters=launch_counters)

    @property
    def compile_count(self) -> int:
        """CUDA graphs captured over the engine's life (the reference
        counts its new jit programs); 0 on the CPU."""
        return self._graph_cache.captures

    # ------------------------------------------------------------ weights
    def _extract_weights(self, model):
        dev, dt = self.device, self._compute_dtype

        def v(t):
            return t.detach().to(device=dev, dtype=dt)

        lm = model.llama
        w = {
            "embed": v(lm.embed_tokens.weight),
            "norm": v(lm.norm.weight),
        }
        if model.lm_head is None:
            w["head"] = w["embed"].t()
        else:
            w["head"] = v(model.lm_head.weight)
        w["layers"] = []
        for layer in lm.layers:
            a, m = layer.self_attn, layer.mlp
            w["layers"].append({
                "ln1": v(layer.input_layernorm.weight),
                "ln2": v(layer.post_attention_layernorm.weight),
                "wq": v(a.q_proj.weight), "wk": v(a.k_proj.weight),
                "wv": v(a.v_proj.weight), "wo": v(a.o_proj.weight),
                "wg": v(m.gate_proj.weight), "wu": v(m.up_proj.weight),
                "wd": v(m.down_proj.weight),
            })
        return w

    def load_weights(self, model, version: Optional[str] = None,
                     model_id: Optional[str] = None) -> str:
        """Swap in ``model``'s weights.  The caller drains the engine
        first.  The prefix cache is invalidated (cached KV was computed
        under the old weights).  Any fault (the ``weights.swap``
        failpoint, a geometry mismatch) raises BEFORE state changes.
        Returns the new version label."""
        if self._faults is not None:
            self._faults.fire(WEIGHTS_SWAP,
                              detail=str(version or model_id or ""))
        cfg = model.config
        if (cfg.num_attention_heads != self.H
                or cfg.num_key_value_heads != self.KV
                or cfg.head_dim != self.D
                or cfg.hidden_size != self.E
                or cfg.num_hidden_layers != self.L):
            raise ValueError(
                "load_weights: new model's geometry (heads/kv/head_dim/"
                "hidden/layers) must match the engine's — the KV caches are "
                "shaped by it; boot a fresh engine for a different "
                "architecture")
        new = self._extract_weights(model)   # raises before any mutation
        self._weights = new
        # the captured graphs read the old weights' memory
        self._graph_cache.clear()
        self.blocks.drop_cached()
        if model_id is not None:
            self.model_id = str(model_id)
        if version is not None:
            self.weights_version = str(version)
        elif model_id is not None:
            self.weights_version = str(model_id)
        return self.weights_version

    def _build_rope(self, cfg):
        d = cfg.head_dim
        inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
        t = np.arange(self.max_seq_len, dtype=np.float64)
        fr = np.outer(t, inv)
        # blha rope layout [2, Br=1, Smax, 1, D/2]; llama uses the
        # half-split (neox) rotation
        return torch.as_tensor(
            np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :],
            dtype=torch.float32, device=self.device)

    # ------------------------------------------------------- device side
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device."""
        return torch.as_tensor(a, device=self.device)

    def _program(self, name: str, fn, arrays, K: int, all_greedy: bool):
        """One megastep loop ``fn(*device arrays, K, all_greedy)``: through
        the CUDA graph of (name, K, all_greedy) (captured on the key's
        first call, which runs eagerly), or eagerly on the CPU and with
        ``_graphs`` off."""
        return self._graphed((name, K, all_greedy),
                             lambda *ins: fn(*ins, K, all_greedy), arrays)

    def _graphed(self, key, fn, arrays):
        """``fn(*device arrays)`` through the CUDA graph of ``key``, or
        eagerly on the CPU and with ``_graphs`` off."""
        if not self._graphs:
            return fn(*[self._dev(a) for a in arrays])
        return self._graph_cache.run(key, fn, arrays)

    def _trunk(self, token_ids, enc, dec, now, cu, bt, mq):
        """embed -> layers -> final RMSNorm over the packed buffer
        [T] -> [T, E]; writes this step's K/V into the caches in place.
        ``mq`` is the padded per-row query length (1 for pure decode).  The
        norms are K1: layer 0's ``ln1`` alone, then each residual add fused
        with the norm after it (``ln2``, the next ``ln1``, the final
        ``norm``), 2L+1 launches.  With the int8 cache the attention is
        blha_attention's dynamic mode over the layer's ``cache_scales``
        (``enc`` None: no row prefills, the scales pass through)."""
        w = self._weights
        eps = self.cfg.rms_norm_eps
        layers = w["layers"]
        plan = plan_step(cu, dec, now, bt, token_ids.shape[0], self.bs,
                         self.blocks.num_blocks, self._rope)
        hidden = w["embed"][token_ids.long()]              # [T, E]
        h = rms_norm_fused(hidden, layers[0]["ln1"], eps)
        for li, lw in enumerate(layers):
            qkv = torch.cat([h @ lw["wq"], h @ lw["wk"], h @ lw["wv"]],
                            dim=-1)
            out, _, _ = blha_attention(
                qkv, self.key_caches[li], self.value_caches[li], enc, dec,
                now, cu, bt, num_heads=self.H, kv_num_heads=self.KV,
                head_dim=self.D, block_size=self.bs, max_q_len=mq,
                use_neox_style=True, compute_dtype=hidden.dtype, plan=plan,
                **self._layer_quant[li])
            h2, hidden = rms_norm_residual_fused(out @ lw["wo"], hidden,
                                                 lw["ln2"], eps)
            mlp = swiglu_fused(h2 @ lw["wg"], h2 @ lw["wu"]) @ lw["wd"]
            nxt = layers[li + 1]["ln1"] if li + 1 < len(layers) else w["norm"]
            h, hidden = rms_norm_residual_fused(mlp, hidden, nxt, eps)
        return h

    def _forward(self, token_ids, enc, dec, now, cu, bt, mq):
        """-> logits [B, V] float-typed, one row per batch slot: its LAST
        packed token."""
        h = self._trunk(token_ids, enc, dec, now, cu, bt, mq)
        rows = torch.clamp(cu[1:].long() - 1, 0, token_ids.shape[0] - 1)
        return h[rows] @ self._weights["head"]

    def _run_step(self, tokens, enc, dec, now, cu, bt, temps, top_ks,
                  top_ps, seeds, spos, mq, all_greedy):
        """The single-step program: one forward + sampling (on CUDA a
        graph per ("step", mq, all_greedy, capture_sample_probs))."""
        logits = self._forward(tokens, enc, dec, now, cu, bt, mq)
        return _sample_tokens(logits, temps, top_ks, top_ps, seeds, spos,
                              return_probs=self.capture_sample_probs,
                              all_greedy=all_greedy)

    def _run_megastep(self, toks, dec, now, cu, occ_idx, bt, active,
                      remaining, dl, eos, temps, top_ks, top_ps, seeds,
                      sample_pos, K, all_greedy):
        """K pure-decode iterations over device tensors, no host sync
        inside: the reference's ``lax.scan`` (``_build_megastep``).  A row
        that finishes (EOS / budget) or runs out of deadline budget freezes
        its token, position and sample index, so every later iteration
        re-feeds the same token at the same position and rewrites the SAME
        KV bits, while its outputs are marked invalid.  Rows with ``now=0``
        (empty slots) never write.  No row prefills (``enc`` None), so the
        int8 cache's scales pass through unchanged, as the reference's
        scan carries them.  Returns stacked [K, B] (tokens, valid,
        logprobs) and [K, B, V] probs or None."""
        enc = None
        outs = []
        for _ in range(K):
            packed = toks[occ_idx.long()]     # slot-order -> packed layout
            logits = self._forward(packed, enc, dec, now, cu, bt, 1)
            nxt, lps, probs = _sample_tokens(
                logits, temps, top_ks, top_ps, seeds, sample_pos,
                return_probs=self.capture_sample_probs,
                all_greedy=all_greedy)
            # a row is ALIVE while unfinished and inside its deadline
            # budget; frozen rows emit nothing and advance nothing
            alive = active & (dl > 0)
            fin = alive & ((nxt == eos) | (remaining <= 1))
            adv = alive & ~fin
            step = alive.to(torch.int32)
            toks = torch.where(adv, nxt, toks)
            dec = dec + adv.to(torch.int32)
            remaining = remaining - step
            sample_pos = sample_pos + step
            dl = dl - step
            active = active & ~fin
            outs.append((nxt, alive, lps, probs))
        return self._stack(outs)

    def _run_mixed(self, toks, cached, pp, pp0, plen, prompt_buf, bt,
                   active, remaining, dl, eos, temps, top_ks, top_ps, seeds,
                   sample_pos, K, all_greedy):
        """K MIXED-PHASE iterations over device tensors, no host sync
        inside: the reference's ``_build_mixed_megastep`` scan.  Each
        iteration processes, per row, ONE decode token or ONE prompt chunk
        of up to ``pc`` tokens sliced from the host-staged ``prompt_buf``
        at ``pp - pp0``; the per-row counts are exact-packed into the
        [token_budget] buffer, so the last-packed-token logits extraction
        works unchanged, and the attention runs with ``mq = pc``.  A row
        emits on decode iterations and on the iteration whose chunk
        finishes its prompt.  Returns the final ``pp`` [B] and the stacked
        outputs as ``_run_megastep``."""
        B, T, C = self.B, self.T, self.pc
        dev = self.device
        enc = torch.zeros_like(cached)
        j = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        outs = []
        for _ in range(K):
            alive = active & (dl > 0)
            prefilling = pp < plen
            n_pre = torch.minimum(plen - pp, torch.full_like(pp, C))
            now_t = torch.where(alive, torch.where(prefilling, n_pre, 1),
                                0).to(torch.int32)
            cu = torch.cat([zero, torch.cumsum(now_t, 0).to(torch.int32)])
            # per-row tokens this iteration [B, C]: the next prompt chunk
            # for prefilling rows, the carried token at column 0 for
            # decode rows
            start = (pp - pp0).clamp(0, prompt_buf.shape[1] - C)
            chunk = prompt_buf.gather(1, (start[:, None] + j).long())
            dec_row = torch.zeros((B, C), dtype=torch.int32, device=dev)
            dec_row[:, 0] = toks
            row_toks = torch.where(prefilling[:, None], chunk, dec_row)
            # exact-pack into the [T] buffer; column T is the drop target
            flat = torch.where(j < now_t[:, None], cu[:-1][:, None] + j, T)
            flat = torch.clamp(flat, max=T)
            buf = torch.zeros((T + 1,), dtype=torch.int32, device=dev)
            buf[flat.reshape(-1).long()] = row_toks.reshape(-1)
            logits = self._forward(buf[:T], enc, cached, now_t, cu, bt, C)
            nxt, lps, probs = _sample_tokens(
                logits, temps, top_ks, top_ps, seeds, sample_pos,
                return_probs=self.capture_sample_probs,
                all_greedy=all_greedy)
            finishing = prefilling & (pp + n_pre >= plen)
            emits = alive & (~prefilling | finishing)
            fin = emits & ((nxt == eos) | (remaining <= 1))
            adv = emits & ~fin
            toks = torch.where(adv, nxt, toks)
            cached = cached + now_t
            pp = pp + torch.where(alive & prefilling, n_pre, 0).to(torch.int32)
            remaining = remaining - emits.to(torch.int32)
            sample_pos = sample_pos + emits.to(torch.int32)
            dl = dl - alive.to(torch.int32)
            active = active & ~fin
            outs.append((nxt, emits, lps, probs))
        return (pp,) + self._stack(outs)

    def _run_spec_verify(self, tokens, dec, now, cu, bt, dlen, draft, temps,
                         top_ks, top_ps, seeds, spos, all_greedy):
        """The verify program (the reference's ``_build_spec_verify``):
        score all ``spec_k + 1`` positions of every row's ``[last token,
        draft_0 .. draft_{d-1}]`` feed in ONE forward over the packed
        [B * (spec_k + 1)] buffer (``mq = spec_k + 1``), and redraw each
        position with the key stream the non-spec path would use (sample
        index ``spos + j``).  The redraw is deterministic, so the accept
        rule is prefix matching: position j accepts iff its redraw equals
        the draft, and the committed tokens are the redraw's first
        ``accepted + 1`` columns.

        Draft tokens write K/V at ``dec .. dec + d``; the host advances
        ``dec`` only by the committed count, and a cache write is a
        function of (token, position, weights), so rejected positions are
        overwritten by the next feed before any read reaches them.  Rows
        and positions sample independently, so all B * (spec_k + 1) rows
        go through ``_sample_tokens`` at once.  Returns ([B, 2 * (spec_k
        + 1) + 1] int32: the redraws, the float32 bits of their logprobs,
        the accepted count — one device-to-host copy), and the [B, spec_k
        + 1, V] probs or None."""
        B, sk = self.B, self.spec_k
        Kp1 = sk + 1
        h = self._trunk(tokens, torch.zeros_like(dec), dec, now, cu, bt, Kp1)
        # position j of row b is packed token cu[b] + j; a row whose draft
        # is shorter than spec_k clamps to its last fed token (masked out
        # of the accept below, so the garbage never commits)
        j = torch.arange(Kp1, dtype=torch.int32, device=dec.device)[None, :]
        idx = torch.clamp(cu[:-1, None] + torch.minimum(j, dlen[:, None]),
                          0, tokens.shape[0] - 1)
        lg = h[idx.reshape(-1).long()] @ self._weights["head"]
        def rep(a):
            return a.repeat_interleave(Kp1)

        nxt, lps, probs = _sample_tokens(
            lg, rep(temps), rep(top_ks), rep(top_ps), rep(seeds),
            (spos[:, None] + j).reshape(-1),
            return_probs=self.capture_sample_probs, all_greedy=all_greedy)
        nxt, lps = nxt.view(B, Kp1), lps.view(B, Kp1)
        # accepted = the longest draft prefix the redraw reproduces
        jk = j[:, :sk]
        match = (nxt[:, :sk] == draft) & (jk < dlen[:, None])
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        out = torch.cat([nxt, lps.view(torch.int32),
                         acc.to(torch.int32)[:, None]], dim=1)
        return out, (probs.view(B, Kp1, -1) if probs is not None else None)

    @staticmethod
    def _stack(outs):
        toks = torch.stack([o[0] for o in outs])
        valid = torch.stack([o[1] for o in outs])
        lps = torch.stack([o[2] for o in outs])
        probs = (torch.stack([o[3] for o in outs])
                 if outs[0][3] is not None else None)
        return toks, valid, lps, probs

    # ------------------------------------------------------------- serving
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    sampling=None, sample_offset: int = 0,
                    trace: Optional[Dict] = None,
                    deadline_s: Optional[float] = None) -> int:
        """Queue one request.  ``sampling`` is a :class:`SamplingParams`
        (or its dict wire form; None = greedy argmax).  ``sample_offset``
        is the sample index of the first NEW token — a resumed request
        (prompt+generated re-prefilled after preemption/failover) passes
        the number of tokens already sampled so the seeded key stream
        continues exactly where it stopped.  ``deadline_s`` (seconds
        from now, this engine's clock) arms the IN-GRAPH deadline
        budget: megastep launches convert the remaining time into a scan
        iteration budget and the row freezes in-graph the moment it is
        spent — zero tokens of overshoot once a per-iteration estimate
        exists.  The engine only ever FREEZES on deadline; the typed
        shed (DEADLINE_EXCEEDED) stays the control plane's job — an
        engine driven standalone with an expired deadline will hit
        ``run()``'s max_steps loudly rather than silently dropping the
        request."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if sample_offset < 0:
            raise ValueError("sample_offset must be >= 0")
        total = len(prompt) + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds "
                             f"max_seq_len={self.max_seq_len}")
        if self.cache_quant == "int8" and len(prompt) > self.T:
            # dynamic per-sequence scales are frozen by the (one-shot)
            # prefill — chunked prefills would quantize chunks under
            # different scales than the final dequant (the reference's
            # dynamic cache-quant mode has the same one-shot contract)
            raise ValueError(
                f"cache_quant='int8' needs the prompt ({len(prompt)} tokens) "
                f"to prefill in one step (token_budget={self.T}); raise the "
                "budget or use the unquantized cache")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServingRequest(
            rid, prompt, max_new_tokens, eos_token_id,
            sampling=SamplingParams.coerce(sampling),
            sample_offset=int(sample_offset),
            trace=dict(trace) if trace else None,
            deadline_t=(self._clock() + float(deadline_s)
                        if deadline_s is not None else None)))
        return rid

    def _match_cached_prefix(self, prompt: List[int]):
        """Longest run of consecutive full prompt blocks whose chain
        hashes are content-addressable in the pool ->
        ``[(block_id, hash), ...]``."""
        matched = []
        parent = None
        for i in range(len(prompt) // self.bs):
            parent = prefix_block_hash(
                parent, prompt[i * self.bs:(i + 1) * self.bs])
            b = self.blocks.lookup(parent)
            if b is None:
                break
            matched.append((b, parent))
        return matched

    def _copy_block(self, src: int, dst: int):
        """Device-side copy of one pool block across every layer's K and V
        cache (the copy-on-write fork: the writer gets a private copy, the
        shared original stays read-only for its other owners)."""
        for kc, vc in zip(self.key_caches, self.value_caches):
            kc[dst].copy_(kc[src])
            vc[dst].copy_(vc[src])

    def _try_admit(self):
        while self._queue and self._free_slots:
            req = self._queue[0]
            prompt = req.prompt
            need = (len(prompt) + req.max_new_tokens + self.bs - 1) // self.bs
            matched = (self._match_cached_prefix(prompt)
                       if self.prefix_cache_enabled else [])
            m = len(matched)
            # a fully-cached block-aligned prompt still needs ≥ 1 token of
            # real prefill (no compute = no logits for the first sampled
            # token): keep the whole match, but the final token re-feeds
            # into the LAST matched block — which is shared/read-only, so
            # that one block is copy-on-write-forked below
            full_match = m > 0 and m * self.bs == len(prompt)
            n_shared = m - 1 if full_match else m
            need_fresh = need - n_shared
            # pin the match first: the matched blocks may be sitting in the
            # reuse LRU, and allocating the tail could otherwise evict them
            for b, _ in matched:
                self.blocks.fork(b)
            if not self.blocks.can_allocate(need_fresh):
                self.blocks.free([b for b, _ in matched])  # unpin
                break  # head-of-line waits for retirements
            self._queue.pop(0)
            fresh = self.blocks.allocate(need_fresh)
            if full_match:
                # COW fork of the last matched block: the re-fed final
                # prompt token rewrites its own KV slot (same values) in a
                # private copy, never in the shared original
                cow_src = matched[-1][0]
                self._copy_block(cow_src, fresh[0])
                self.blocks.free([cow_src])   # drop the pin on the original
                req.blocks = [b for b, _ in matched[:-1]] + fresh
            else:
                req.blocks = [b for b, _ in matched] + fresh
            req.prefill_pos = min(m * self.bs, len(prompt) - 1)
            req.cached_prefix_tokens = req.prefill_pos
            if self.prefix_cache_enabled:
                self.prefix_hit_blocks += m
                self.prefix_miss_blocks += len(prompt) // self.bs - m
            req.slot = self._free_slots.pop()
            row = np.full((self.P,), -1, np.int32)
            row[:need] = req.blocks
            self.block_tables[req.slot] = row
            self._active[req.rid] = req

    def _publish_prefix(self, req: ServingRequest):
        """Make the request's full KV blocks content-addressable before
        they are freed, so the next request sharing the token prefix skips
        their prefill.  Only positions whose KV is actually WRITTEN count:
        the newest sampled token is fed (and cached) one step later, so it
        is excluded."""
        toks = req.prompt[:req.prefill_pos] + req.generated
        if req.generated:
            toks = toks[:-1]
        parent = None
        for i in range(len(toks) // self.bs):
            parent = prefix_block_hash(
                parent, toks[i * self.bs:(i + 1) * self.bs])
            self.blocks.publish(req.blocks[i], parent)

    def _release(self, req: ServingRequest):
        """Return a running request's blocks and batch slot to the pools
        (shared by retirement and mid-flight eviction).  With the prefix
        cache on, full blocks are published first: ``free`` then parks
        them reusable in the LRU instead of hard-freeing.  Idempotent:
        a deadline-frozen row is released at megastep harvest while
        staying in ``_active`` for the control plane's
        typed shed, so the later ``evict``/retire re-releases it."""
        if req.slot < 0:
            return
        if self.prefix_cache_enabled and req.blocks:
            self._publish_prefix(req)
        self.blocks.free(req.blocks)
        req.blocks = []
        self.block_tables[req.slot] = -1
        self._free_slots.append(req.slot)
        req.slot = -1

    def _retire(self, req: ServingRequest):
        req.done = True
        self._release(req)
        del self._active[req.rid]
        self._finished[req.rid] = list(req.generated)

    def evict(self, rid: int) -> ServingRequest:
        """Remove a queued or running request mid-flight (recompute
        preemption / cancellation hook for the control plane).

        Frees the request's blocks and batch slot immediately and returns
        the request object — ``prompt`` and ``generated`` are intact, so
        the caller can re-queue it with ``prompt + generated`` as the new
        prefill and get the identical greedy continuation.  ``prefill_pos``
        is reset; with the prefix cache on, the evicted request's full KV
        blocks are published before release, so a resume finds its own
        prefix cached and the recompute is nearly free (only the partial
        tail block and anything evicted under pool pressure re-prefills)."""
        req = self._active.get(rid)
        if req is not None:
            del self._active[rid]
            self._release(req)
            req.prefill_pos = 0
            return req
        for i, q in enumerate(self._queue):
            if q.rid == rid:
                return self._queue.pop(i)
        raise KeyError(f"no queued or active request with rid={rid}")

    def state_summary(self) -> Dict:
        """Host-side scheduling state, cheap and device-sync-free — the ONE
        probe shared by the fleet layer's heartbeat, the remote-replica
        state mirror, and the autoscaler (inference/fleet.py), so health
        checking and scaling decisions read the same numbers."""
        nb = self.blocks.num_blocks
        return {
            "queued": [(q.rid, len(q.prompt), q.max_new_tokens)
                       for q in self._queue],
            "active": {rid: len(r.blocks) for rid, r in self._active.items()},
            "free_slots": len(self._free_slots),
            "blocks_free": self.blocks.num_free,
            "blocks_total": nb,
            "queue_depth": len(self._queue),
            "num_active": len(self._active),
            "pool_utilization": (1.0 - self.blocks.num_free / nb) if nb else 0.0,
            # weight-swap attribution: the fleet mirror and
            # tenant routing read these off the same state reply
            "weights_version": self.weights_version,
            "model_id": self.model_id,
            # prefix-cache summary: the hash list is bounded by the pool
            # size (tens of entries), cheap enough to piggyback on every
            # RPC reply — the frontend's prefix-affinity routing matches
            # prompt hashes against it without an extra round trip
            "prefix_cache": {
                "enabled": self.prefix_cache_enabled,
                "hashes": sorted(self.blocks.cached_hashes())
                if self.prefix_cache_enabled else [],
                "cached_blocks": self.blocks.num_cached,
                "hit_blocks": self.prefix_hit_blocks,
                "miss_blocks": self.prefix_miss_blocks,
                "evictions": self.blocks.evictions,
            },
            # megastep decode counters (monotone; workers fold the deltas
            # into their registries, the frontend folds for in-process
            # engines) + the configured K for observability
            "megastep": {
                "k": self.megastep_k,
                "megasteps": self.megasteps,
                "tokens": self.megastep_tokens,
                "mixed": self.megasteps_mixed,
                "prefill_chunks": self.prefill_chunks,
            },
            # speculative-decode counters (the same monotone delta-fold
            # contract as the megastep block above)
            "spec": {
                "k": self.spec_k,
                "accepted": self.spec_accepted_tokens,
                "drafted": self.spec_draft_tokens,
                "verify_forwards": self.spec_verify_forwards,
            },
            # cumulative host seconds per step phase — megastep cost
            # attribution without a profiler
            "phase_seconds": dict(self.phase_seconds),
        }

    def pop_trace_events(self) -> List[Dict]:
        """Drain span events recorded by this engine's flight recorder
        since the last call (empty when tracing is off).  In-process
        frontends drain this directly; a worker host drains it into the
        ``_w_step`` reply so the frontend can graft engine-side spans
        (prefill done, megastep boundaries) onto the fleet-wide tree."""
        if self.trace_recorder is None:
            return []
        return self.trace_recorder.drain()

    def pop_finished(self) -> Dict[int, List[int]]:
        """Drain and return requests retired since the last call,
        {rid: generated tokens}.  The control plane harvests completions
        with this between ``step()`` calls; note it drains the same record
        ``run()`` returns, so mix the two styles per-engine, not both."""
        out = self._finished
        self._finished = {}
        return out

    def pop_token_logprobs(self) -> Dict[int, List[float]]:
        """Drain per-token logprobs recorded since the last call for
        requests with ``SamplingParams.logprobs=True`` — aligned 1:1 with
        the token lists ``step()`` emitted over the same window.  The
        control plane harvests this next to the emitted tokens; greedy
        default requests never appear here."""
        out = self._emitted_logprobs
        self._emitted_logprobs = {}
        return out

    def pop_sample_probs(self) -> Dict[int, List[np.ndarray]]:
        """Drain the renormalized post-top-k/top-p distributions each
        emitted token was drawn from (``capture_sample_probs=True``
        engines only) — {rid: [float32 [V], ...]} aligned 1:1 with the
        token lists ``step()`` emitted over the same window; greedy rows
        report a one-hot at the argmax.  This is the q(x) a speculative-
        decode verifier scores draft tokens against; harvested exactly
        like ``pop_token_logprobs``.  NB a
        ``ServingFrontend`` driving this engine drains (and discards)
        the buffer every step — it has no per-token consumer for [V]
        arrays and must not leak them — so verifiers harvest by driving
        the engine directly."""
        out = self._emitted_sample_probs
        self._emitted_sample_probs = {}
        return out

    def reap_orphans(self) -> int:
        """Evict EVERY queued and active request and drop any unharvested
        finished/logprob state; returns how many sequences were reaped.

        The crash-recovery hook: a restarted frontend
        reattaching to a still-live engine/worker must not leave the dead
        frontend's sequences decoding unobserved forever — recovery reaps
        them and re-admits from the journal (with the prefix cache on,
        the reaped requests' full blocks were published on eviction, so
        the re-prefill largely hits cache)."""
        rids = [q.rid for q in self._queue] + list(self._active)
        for rid in rids:
            self.evict(rid)
        self._finished.clear()
        self._emitted_logprobs.clear()
        self._emitted_sample_probs.clear()
        return len(rids)

    @staticmethod
    def _fill_sampling(req: ServingRequest, slot: int, temps, top_ks,
                       top_ps, seeds, spos):
        """Marshal one request's sampling params into the per-slot host
        arrays — the ONE fill both the single-step and megastep paths
        use, so a new knob cannot reach one program and not the other."""
        sp = req.sampling
        temps[slot] = sp.temperature
        top_ks[slot] = sp.top_k
        top_ps[slot] = sp.top_p
        seeds[slot] = sp.seed
        spos[slot] = req.sample_offset + len(req.generated)

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: schedule -> device step(s) -> retire.
        Returns tokens appended this step, {rid: [tok, ...]}.  Records no
        autograd graph (the weights are detached copies as well).

        ARMING: whenever any scheduled row is decoding (and
        ``megastep_k > 1``), up to ``megastep_k`` iterations run in ONE
        device loop — the pure-decode loop when every row is decoding, the
        MIXED loop when prefilling rows share the batch (each iteration
        feeds those rows one chunk).  The returned lists then carry up to
        K tokens per request and the host only observes the engine at
        megastep boundaries.  Prefill-only batches and ``megastep_k=1`` run
        the single-step program."""
        t0 = self._clock()
        self._try_admit()
        if not self._active:
            self.phase_seconds["schedule"] += self._clock() - t0
            return {}
        if self._faults is not None:
            from .faults import prompt_signature

            # detail carries each active request's prompt signature so a
            # poison spec (match="p<t0>-<t1>-...") fires exactly when its
            # request is scheduled — and keeps firing on whichever replica
            # the request is retried on (the resumed prefill keeps the
            # original prompt as its head)
            self._faults.fire(
                "engine.step",
                detail=" ".join(prompt_signature(r.prompt)
                                for r in self._active.values()))
        enc = np.zeros((self.B,), np.int32)
        dec = np.zeros((self.B,), np.int32)
        now = np.zeros((self.B,), np.int32)
        budget = self.T
        sched: List[tuple] = []  # (req, n_tokens, finishes_prefill)
        # decode first (latency), then fill with prefill chunks.  Rows
        # with slot < 0 are deadline-frozen and already released at a
        # megastep harvest — they stay in _active only until the control
        # plane finalizes the typed shed, and must never re-schedule.
        for req in self._active.values():
            if req.slot < 0:
                continue
            if not req.in_prefill and budget > 0:
                sched.append((req, 1, False))
                budget -= 1
        for req in self._active.values():
            if req.slot < 0:
                continue
            if req.in_prefill and budget > 0:
                need = len(req.prompt) - req.prefill_pos
                if self.cache_quant == "int8" and need > budget:
                    # int8 dynamic scales freeze at prefill: the prefill must
                    # land in ONE step, so wait for enough budget (bounded
                    # wait — decoding slots retire and free it)
                    continue
                n = min(need, budget)
                sched.append((req, n, req.prefill_pos + n >= len(req.prompt)))
                budget -= n
                if self._faults is not None:
                    from .faults import prompt_signature

                    # chunk-boundary failpoint, single-step path: fires
                    # before any device mutation, once per prompt chunk
                    self._faults.fire("engine.prefill_chunk",
                                      detail=prompt_signature(req.prompt))
        if not sched:
            self.phase_seconds["schedule"] += self._clock() - t0
            return {}
        # pure-decode steps run the tight [B]-token program (mq=1); steps
        # carrying prefill chunks run the [T]-token program (mq=T) — decide
        # first, allocate the one token buffer the program actually takes
        decode_only = all(not r.in_prefill for r, _, _ in sched)
        # SPECULATIVE arming: pure-decode batches on a spec_k > 0 engine
        # try n-gram drafting first; one verify forward then commits
        # accepted + 1 tokens per row.  int8 is excluded (a speculative
        # rewind would need a scale rewind), and a launch with NO
        # non-empty draft falls through — the megastep is strictly better
        # when there is nothing to verify.
        if (decode_only and self.spec_k > 0 and self.cache_quant != "int8"
                and any(r.sampling.spec for r, _, _ in sched)):
            spec_rows = [r for r, _, _ in sched]
            drafts = self._draft(spec_rows)
            if any(drafts.values()):
                armed = True
                if self._faults is not None:
                    from .faults import prompt_signature

                    try:
                        self._faults.fire(
                            SPEC_VERIFY,
                            detail=" ".join(prompt_signature(r.prompt)
                                            for r in spec_rows))
                    except _INJECTED:
                        # degrade: a verify fault sends this step down the
                        # non-spec megastep/single-step path — the same
                        # tokens, never a wrong one
                        armed = False
                if armed:
                    self.phase_seconds["schedule"] += self._clock() - t0
                    return self._spec_step(spec_rows, drafts)
        if (decode_only and self.megastep_k > 1
                and max(r.max_new_tokens - len(r.generated)
                        for r, _, _ in sched) > 1):
            self.phase_seconds["schedule"] += self._clock() - t0
            return self._megastep([s[0] for s in sched])
        # MIXED-PHASE arming: any decoding row + any prefilling row -> run
        # both phases inside one device loop instead of falling back to
        # per-token host stepping.  int8 keeps one-shot prefill (dynamic
        # scales freeze at prefill, chunking would violate it); bs > T
        # cannot exact-pack a full chunk into the token buffer.
        if (self.megastep_k > 1 and self.cache_quant != "int8"
                and self.pc <= self.T and not decode_only
                and any(not r.in_prefill for r, _, _ in sched)):
            dec_rows = [r for r, _, _ in sched if not r.in_prefill]
            pre_rows = []
            budget_m = self.T - len(dec_rows)
            for r, _, _ in sched:
                if r.in_prefill:
                    # worst-case packed tokens this row adds to any one
                    # iteration: its first chunk (chunks only shrink)
                    cost = min(self.pc, len(r.prompt) - r.prefill_pos)
                    if cost <= budget_m:
                        pre_rows.append(r)
                        budget_m -= cost
            if pre_rows:
                self.phase_seconds["schedule"] += self._clock() - t0
                return self._megastep_mixed(dec_rows, pre_rows)
        tokens = np.zeros((self.B if decode_only else self.T,), np.int32)
        # stable slot order so cu_seqlens is monotone over batch rows
        sched.sort(key=lambda s: s[0].slot)
        cu = np.zeros((self.B + 1,), np.int32)
        temps = np.zeros((self.B,), np.float32)
        top_ks = np.zeros((self.B,), np.int32)
        top_ps = np.ones((self.B,), np.float32)
        seeds = np.zeros((self.B,), np.int32)
        spos = np.zeros((self.B,), np.int32)
        per_slot = {s[0].slot: s for s in sched}
        pos = 0
        for slot in range(self.B):
            cu[slot + 1] = pos
            if slot not in per_slot:
                continue
            req, n, _ = per_slot[slot]
            self._fill_sampling(req, slot, temps, top_ks, top_ps, seeds,
                                spos)
            if req.in_prefill:
                chunk = req.prompt[req.prefill_pos:req.prefill_pos + n]
                enc[slot] = n
                dec[slot] = req.prefill_pos
                self.prefill_tokens_computed += n
            else:
                chunk = [req.generated[-1] if req.generated
                         else req.prompt[-1]]
                # cached tokens = prompt + generated[:-1]; the latest sampled
                # token is only being fed (and cached) THIS step
                dec[slot] = req.context_len - 1
            now[slot] = n
            tokens[pos:pos + n] = chunk
            pos += n
            cu[slot + 1] = pos

        t1 = self._clock()
        self.phase_seconds["schedule"] += t1 - t0
        mq = 1 if decode_only else self.T
        all_greedy = bool((temps <= 0).all())
        nxt, lps, probs = self._graphed(
            ("step", mq, all_greedy, self.capture_sample_probs),
            lambda *ins: self._run_step(*ins, mq, all_greedy),
            (tokens, enc, dec, now, cu, self.block_tables, temps, top_ks,
             top_ps, seeds, spos))
        nxt = nxt.cpu().numpy()
        lps = lps.cpu().numpy()
        probs = probs.cpu().numpy() if probs is not None else None
        t2 = self._clock()
        self.phase_seconds["execute"] += t2 - t1

        emitted: Dict[int, List[int]] = {}
        for req, n, finishes in sched:
            if req.in_prefill:
                req.prefill_pos += n
                req.chunks_fed += 1
                self.prefill_chunks += 1
                if self.trace_recorder is not None and req.trace is not None:
                    self.trace_recorder.record(
                        req.trace["trace"], req.trace["span"],
                        req.trace.get("parent"), "prefill_chunk",
                        rid=req.trace.get("rid"),
                        chunk=req.chunks_fed - 1, tokens=n)
                if not finishes:
                    continue  # mid-prompt chunk: sampled token is meaningless
                if self.trace_recorder is not None and req.trace is not None:
                    self.trace_recorder.record(
                        req.trace["trace"], req.trace["span"],
                        req.trace.get("parent"), "prefill",
                        rid=req.trace.get("rid"),
                        prompt_len=len(req.prompt))
            tok = int(nxt[req.slot])
            req.generated.append(tok)
            if req.sampling.logprobs:
                req.logprob_values.append(float(lps[req.slot]))
                self._emitted_logprobs.setdefault(req.rid, []).append(
                    float(lps[req.slot]))
            if probs is not None:
                # .copy(): probs[slot] is a view pinning the whole [B,V]
                # step array alive (the megastep path's fancy-indexing
                # already copies)
                self._emitted_sample_probs.setdefault(req.rid, []).append(
                    probs[req.slot].copy())
            emitted.setdefault(req.rid, []).append(tok)
            hit_eos = (req.eos_token_id is not None and tok == req.eos_token_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens:
                self._retire(req)
        self.phase_seconds["harvest"] += self._clock() - t2
        return emitted

    def _deadline_budgets(self, by_slot: Dict[int, "ServingRequest"]
                          ) -> np.ndarray:
        """Per-slot deadline budgets in LOOP ITERATIONS, computed on the
        host at megastep launch so the device loop checks deadlines as
        pure data (wall clock never enters the loop).  A row with
        no deadline — or no per-iteration time estimate yet — gets an
        effectively infinite budget; ``floor((deadline_t - now) / tau)``
        otherwise, so a conservative (large) tau freezes EARLY: that
        costs throughput, never correctness, and overshoot past the
        deadline stays zero."""
        dl = np.full((self.B,), 2 ** 30, np.int32)
        tau = self._tau
        if tau is None or tau <= 0:
            return dl
        now = self._clock()
        for slot, req in by_slot.items():
            if req.deadline_t is not None:
                dl[slot] = max(0, int((req.deadline_t - now) / tau))
        return dl

    def _update_tau(self, execute_s: float, k: int):
        """Fold one megastep's measured execute time into the EWMA
        per-iteration estimate (skipped when deadline_token_seconds was
        injected)."""
        if self._tau_override or k <= 0 or execute_s <= 0:
            return
        x = execute_s / k
        self._tau = x if self._tau is None else 0.8 * self._tau + 0.2 * x

    def _free_frozen(self, reqs: List[ServingRequest], dl: np.ndarray,
                     k: int):
        """A row whose deadline budget ran out inside this loop is FROZEN
        — it will never emit again.  Free its slot and blocks at harvest
        instead of at the control plane's typed shed at some later
        boundary: the request stays in ``_active`` (slot
        -1, never re-scheduled) so the DEADLINE_EXCEEDED shed still
        happens at the control plane, while the queue head admits into
        the freed slot THIS control step.  A launch budget ``dl <= k``
        means the loop drove it to 0; ``_release`` is idempotent, so
        the shed's ``evict`` re-release is safe."""
        freed = False
        for req in reqs:
            if not req.done and req.slot >= 0 and dl[req.slot] <= k:
                self._release(req)
                freed = True
        if freed:
            self._try_admit()

    def _draft(self, reqs: List[ServingRequest]) -> Dict[int, List[int]]:
        """Host-side n-gram drafts for one spec launch, {rid: [tok, ..]}.
        Each row drafts from its own ``prompt + generated`` only, at most
        ``min(spec_k, remaining - 1)`` tokens, so (a) speculative K/V
        writes stay inside the blocks ``_try_admit`` allocated for
        ``prompt + max_new_tokens`` and (b) a full accept commits at most
        ``remaining`` tokens.  An ``engine.spec_draft`` fault degrades
        that ROW to an empty draft: it rides the verify and commits
        exactly its one non-spec token."""
        drafts: Dict[int, List[int]] = {}
        for r in reqs:
            d: List[int] = []
            cap = min(self.spec_k, r.max_new_tokens - len(r.generated) - 1)
            if r.sampling.spec and cap > 0:
                try:
                    if self._faults is not None:
                        from .faults import prompt_signature

                        self._faults.fire(SPEC_DRAFT,
                                          detail=prompt_signature(r.prompt))
                    d = ngram_draft(r.prompt + r.generated, cap)
                except _INJECTED:
                    d = []   # degrade: this row rides undrafted
            drafts[r.rid] = d
        return drafts

    def _spec_step(self, reqs: List[ServingRequest],
                   drafts: Dict[int, List[int]]) -> Dict[int, List[int]]:
        """ONE batched verify over ``[last token] + draft`` per row
        (``_run_spec_verify``, a CUDA graph on CUDA); the host commits
        the redraw's first ``accepted + 1`` columns, truncated at EOS as
        the non-spec harvest stops.  Counters: ``spec_verify_forwards``
        counts ROWS scored (forwards ÷ committed tokens is 1.0 when
        nothing accepts and < 1.0 iff speculation pays),
        ``spec_draft_tokens`` the proposals, ``spec_accepted_tokens`` the
        committed draft tokens."""
        t0 = self._clock()
        B, sk = self.B, self.spec_k
        Kp1 = sk + 1
        tokens = np.zeros((B * Kp1,), np.int32)
        dec = np.zeros((B,), np.int32)
        now = np.zeros((B,), np.int32)
        cu = np.zeros((B + 1,), np.int32)
        dlen = np.zeros((B,), np.int32)
        draft_a = np.zeros((B, sk), np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        spos = np.zeros((B,), np.int32)
        reqs = sorted(reqs, key=lambda r: r.slot)
        by_slot = {r.slot: r for r in reqs}
        pos = 0
        for slot in range(B):
            cu[slot + 1] = pos
            req = by_slot.get(slot)
            if req is None:
                continue
            d = drafts.get(req.rid, [])
            row = [req.generated[-1] if req.generated else req.prompt[-1]]
            row.extend(int(t) for t in d)
            tokens[pos:pos + len(row)] = row
            dec[slot] = req.context_len - 1
            # now bounds the row's writes: the padding past a short draft
            # lands in the drop block
            now[slot] = len(row)
            dlen[slot] = len(d)
            draft_a[slot, :len(d)] = d
            self._fill_sampling(req, slot, temps, top_ks, top_ps, seeds,
                                spos)
            pos += len(row)
            cu[slot + 1] = pos
        all_greedy = bool((temps <= 0).all())
        t1 = self._clock()
        self.phase_seconds["schedule"] += t1 - t0
        out, probs = self._graphed(
            ("spec", all_greedy),
            lambda *ins: self._run_spec_verify(*ins, all_greedy),
            (tokens, dec, now, cu, self.block_tables, dlen, draft_a, temps,
             top_ks, top_ps, seeds, spos))
        out = out.cpu().numpy()      # the step's one device-to-host copy
        nxt = out[:, :Kp1]           # [B, spec_k + 1] redraws
        lps = out[:, Kp1:2 * Kp1].view(np.float32)
        acc = out[:, -1]             # [B] accepted draft-prefix lengths
        probs = probs.cpu().numpy() if probs is not None else None
        t2 = self._clock()
        self.phase_seconds["execute"] += t2 - t1

        emitted: Dict[int, List[int]] = {}
        for req in reqs:
            s = req.slot
            new = [int(t) for t in nxt[s, :int(acc[s]) + 1]]
            if req.eos_token_id is not None and req.eos_token_id in new:
                # the non-spec engine stops AT the EOS: accepted draft
                # tokens past it were never going to be generated
                new = new[:new.index(req.eos_token_id) + 1]
            d = int(dlen[s])
            req.generated.extend(new)
            if req.sampling.logprobs:
                row_lps = [float(v) for v in lps[s, :len(new)]]
                req.logprob_values.extend(row_lps)
                self._emitted_logprobs.setdefault(req.rid, []).extend(
                    row_lps)
            if probs is not None:
                self._emitted_sample_probs.setdefault(req.rid, []).extend(
                    probs[s, j].copy() for j in range(len(new)))
            emitted[req.rid] = new
            self.spec_verify_forwards += 1
            self.spec_draft_tokens += d
            self.spec_accepted_tokens += len(new) - 1
            if self.trace_recorder is not None and req.trace is not None:
                self.trace_recorder.record(
                    req.trace["trace"], req.trace["span"],
                    req.trace.get("parent"), "spec_verify",
                    rid=req.trace.get("rid"), drafted=d,
                    accepted=len(new) - 1, tokens=len(new))
            hit_eos = (req.eos_token_id is not None
                       and new[-1] == req.eos_token_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens:
                self._retire(req)
        self.phase_seconds["harvest"] += self._clock() - t2
        return emitted

    def _megastep(self, reqs: List[ServingRequest]) -> Dict[int, List[int]]:
        """Run up to ``megastep_k`` decode iterations in one device loop
        over the scheduled (all-decoding) requests.  K rounds up to a
        power of two capped at ``megastep_k`` (the reference's bucketing,
        kept so the per-launch iteration counts match it); rows that
        finish inside the loop are masked on the device and their trailing
        samples dropped here."""
        if self._faults is not None:
            from .faults import prompt_signature

            # same poison-routing contract as the engine.step site, on the
            # batched-decode path: chaos schedules arm this to cover the
            # one-RPC-per-K-tokens fleet plumbing
            self._faults.fire(
                "engine.megastep",
                detail=" ".join(prompt_signature(r.prompt) for r in reqs))
        t0 = self._clock()
        kmax = max(r.max_new_tokens - len(r.generated) for r in reqs)
        K = 1
        while K < min(self.megastep_k, kmax):
            K *= 2
        K = min(K, self.megastep_k)
        B = self.B
        toks = np.zeros((B,), np.int32)
        dec = np.zeros((B,), np.int32)
        now = np.zeros((B,), np.int32)
        occ_idx = np.zeros((B,), np.int32)
        cu = np.zeros((B + 1,), np.int32)
        active = np.zeros((B,), bool)
        remaining = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        spos = np.zeros((B,), np.int32)
        reqs = sorted(reqs, key=lambda r: r.slot)
        by_slot = {r.slot: r for r in reqs}
        pos = 0
        for slot in range(B):
            req = by_slot.get(slot)
            if req is not None:
                occ_idx[pos] = slot
                toks[slot] = (req.generated[-1] if req.generated
                              else req.prompt[-1])
                dec[slot] = req.context_len - 1
                now[slot] = 1
                active[slot] = True
                remaining[slot] = req.max_new_tokens - len(req.generated)
                if req.eos_token_id is not None:
                    eos[slot] = req.eos_token_id
                self._fill_sampling(req, slot, temps, top_ks, top_ps,
                                    seeds, spos)
                pos += 1
            cu[slot + 1] = pos
        dl = self._deadline_budgets(by_slot)
        t1 = self._clock()
        self.phase_seconds["schedule"] += t1 - t0
        toks_o, valid_o, lps_o, probs_o = self._program(
            "megastep", self._run_megastep,
            (toks, dec, now, cu, occ_idx, self.block_tables, active,
             remaining, dl, eos, temps, top_ks, top_ps, seeds, spos), K,
            bool((temps <= 0).all()))
        toks_o = toks_o.cpu().numpy()     # [K, B]
        valid_o = valid_o.cpu().numpy()
        lps_o = lps_o.cpu().numpy()
        probs_o = probs_o.cpu().numpy() if probs_o is not None else None
        self.megasteps += 1
        t2 = self._clock()
        self.phase_seconds["execute"] += t2 - t1
        self._update_tau(t2 - t1, K)

        emitted: Dict[int, List[int]] = {}
        for req in reqs:
            s = req.slot
            col = valid_o[:, s]
            new = [int(t) for t in toks_o[:, s][col]]
            req.generated.extend(new)
            if req.sampling.logprobs:
                row_lps = [float(v) for v in lps_o[:, s][col]]
                req.logprob_values.extend(row_lps)
                self._emitted_logprobs.setdefault(req.rid, []).extend(row_lps)
            if probs_o is not None and new:
                self._emitted_sample_probs.setdefault(req.rid, []).extend(
                    probs_o[:, s][col])   # [n_valid, V]
            emitted[req.rid] = new
            self.megastep_tokens += len(new)
            if self.trace_recorder is not None and req.trace is not None:
                self.trace_recorder.record(
                    req.trace["trace"], req.trace["span"],
                    req.trace.get("parent"), "megastep",
                    rid=req.trace.get("rid"), tokens=len(new), k=K)
            hit_eos = (req.eos_token_id is not None and new
                       and new[-1] == req.eos_token_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens:
                self._retire(req)
        self._free_frozen(reqs, dl, K)
        self.phase_seconds["harvest"] += self._clock() - t2
        return emitted

    def _megastep_mixed(self, dec_reqs: List[ServingRequest],
                        pre_reqs: List[ServingRequest]
                        ) -> Dict[int, List[int]]:
        """Run up to ``megastep_k`` MIXED-PHASE iterations in one device
        loop: ``dec_reqs`` decode one token per iteration while
        ``pre_reqs`` consume one chunk of up to ``pc`` prompt tokens per
        iteration (then decode in place once their prompt completes).  The
        caller guarantees the worst-case packed-token total fits the [T]
        buffer.  Mixed launches always run the full ``megastep_k``
        iterations, as the reference's do."""
        reqs = dec_reqs + pre_reqs
        if self._faults is not None:
            from .faults import prompt_signature

            self._faults.fire(
                "engine.megastep",
                detail=" ".join(prompt_signature(r.prompt) for r in reqs))
            for r in pre_reqs:
                # chunk-boundary failpoint: fires BEFORE the device loop
                # (a fault never leaves half-committed tokens), once per
                # prompt entering the loop chunked
                self._faults.fire("engine.prefill_chunk",
                                  detail=prompt_signature(r.prompt))
        t0 = self._clock()
        C = self.pc
        K = self.megastep_k
        B = self.B
        toks = np.zeros((B,), np.int32)
        cached = np.zeros((B,), np.int32)
        pp = np.zeros((B,), np.int32)
        pp0 = np.zeros((B,), np.int32)
        plen = np.zeros((B,), np.int32)
        prompt_buf = np.zeros((B, K * C), np.int32)
        active = np.zeros((B,), bool)
        remaining = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        spos = np.zeros((B,), np.int32)
        by_slot = {r.slot: r for r in reqs}
        for slot, req in by_slot.items():
            active[slot] = True
            remaining[slot] = req.max_new_tokens - len(req.generated)
            if req.eos_token_id is not None:
                eos[slot] = req.eos_token_id
            self._fill_sampling(req, slot, temps, top_ks, top_ps, seeds,
                                spos)
            if req.in_prefill:
                # the prompt window this scan can reach: K chunks of C
                pp[slot] = pp0[slot] = cached[slot] = req.prefill_pos
                plen[slot] = len(req.prompt)
                window = req.prompt[req.prefill_pos:
                                    req.prefill_pos + K * C]
                prompt_buf[slot, :len(window)] = window
            else:
                toks[slot] = (req.generated[-1] if req.generated
                              else req.prompt[-1])
                cached[slot] = req.context_len - 1
                # pp == plen marks the row as decoding from iteration 0
                pp[slot] = pp0[slot] = plen[slot] = len(req.prompt)
        dl = self._deadline_budgets(by_slot)
        t1 = self._clock()
        self.phase_seconds["schedule"] += t1 - t0
        pp_f, toks_o, emits_o, lps_o, probs_o = self._program(
            "mixed", self._run_mixed,
            (toks, cached, pp, pp0, plen, prompt_buf, self.block_tables,
             active, remaining, dl, eos, temps, top_ks, top_ps, seeds, spos),
            K, bool((temps <= 0).all()))
        pp_f = pp_f.cpu().numpy()         # [B] final prefill positions
        toks_o = toks_o.cpu().numpy()     # [K, B]
        emits_o = emits_o.cpu().numpy()
        lps_o = lps_o.cpu().numpy()
        probs_o = probs_o.cpu().numpy() if probs_o is not None else None
        self.megasteps += 1
        self.megasteps_mixed += 1
        t2 = self._clock()
        self.phase_seconds["execute"] += t2 - t1
        self._update_tau(t2 - t1, K)

        emitted: Dict[int, List[int]] = {}
        for req in sorted(reqs, key=lambda r: r.slot):
            s = req.slot
            col = emits_o[:, s]
            new = [int(t) for t in toks_o[:, s][col]]
            fed = int(pp_f[s]) - req.prefill_pos
            if fed > 0:
                # reconstruct the chunk boundaries the scan crossed (all
                # full C except a completing tail) for counters + spans
                req.prefill_pos += fed
                self.prefill_tokens_computed += fed
                nch = -(-fed // C)
                for i in range(nch):
                    ntok = min(C, fed - i * C)
                    req.chunks_fed += 1
                    self.prefill_chunks += 1
                    if (self.trace_recorder is not None
                            and req.trace is not None):
                        self.trace_recorder.record(
                            req.trace["trace"], req.trace["span"],
                            req.trace.get("parent"), "prefill_chunk",
                            rid=req.trace.get("rid"),
                            chunk=req.chunks_fed - 1, tokens=ntok)
                if (not req.in_prefill and self.trace_recorder is not None
                        and req.trace is not None):
                    self.trace_recorder.record(
                        req.trace["trace"], req.trace["span"],
                        req.trace.get("parent"), "prefill",
                        rid=req.trace.get("rid"),
                        prompt_len=len(req.prompt))
            req.generated.extend(new)
            if req.sampling.logprobs:
                row_lps = [float(v) for v in lps_o[:, s][col]]
                req.logprob_values.extend(row_lps)
                self._emitted_logprobs.setdefault(req.rid, []).extend(
                    row_lps)
            if probs_o is not None and new:
                self._emitted_sample_probs.setdefault(req.rid, []).extend(
                    probs_o[:, s][col])   # [n_valid, V]
            emitted[req.rid] = new
            self.megastep_tokens += len(new)
            if self.trace_recorder is not None and req.trace is not None:
                self.trace_recorder.record(
                    req.trace["trace"], req.trace["span"],
                    req.trace.get("parent"), "megastep",
                    rid=req.trace.get("rid"), tokens=len(new), k=K)
            hit_eos = (req.eos_token_id is not None and new
                       and new[-1] == req.eos_token_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens:
                self._retire(req)
        self._free_frozen(reqs, dl, K)
        self.phase_seconds["harvest"] += self._clock() - t2
        return emitted

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until every queued/active request retires.

        Raises ``RuntimeError`` when ``max_steps`` is exhausted with
        requests still queued or active — a truncated run must not be
        mistaken for completion (the returned dict would silently miss
        the unfinished requests' tokens).
        """
        for _ in range(max_steps):
            if not self._queue and not self._active:
                break
            self.step()
            if self._queue and not self._active:
                self._try_admit()  # retirements this step freed capacity
            if self._queue and not self._active:
                # nothing running, everything free, and the queue head still
                # could not be admitted: it can NEVER fit (pool/slot capacity
                # too small) — fail loudly instead of spinning no-ops
                head = self._queue[0]
                need = (len(head.prompt) + head.max_new_tokens
                        + self.bs - 1) // self.bs
                raise RuntimeError(
                    f"request {head.rid} needs {need} cache blocks but the "
                    f"pool only has {self.blocks.num_blocks} total "
                    f"({self.blocks.num_free} free with nothing running) — "
                    "raise num_blocks/max_seq_len or shrink the request")
        if self._queue or self._active:
            raise RuntimeError(
                f"ServingEngine.run: max_steps={max_steps} exhausted with "
                f"{len(self._active)} active and {len(self._queue)} queued "
                "request(s) unfinished — raise max_steps (or drain with "
                "step() and read partial results from the request objects)")
        return dict(self._finished)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def prefix_evictions(self) -> int:
        """Cached blocks dropped from the reuse LRU under allocation
        pressure (monotone; the control plane folds it into metrics)."""
        return self.blocks.evictions

    def cached_block_hashes(self) -> Set[str]:
        """Chain hashes content-addressable in this engine's pool right
        now — what prefix-affinity routing scores a prompt against
        (``fleet.RemoteReplica`` mirrors this from ``state_summary``)."""
        if not self.prefix_cache_enabled:
            return set()
        return self.blocks.cached_hashes()

    # ------------------------------------------------- block transfer
    # (disaggregated prefill/decode moves KV between engines as bit-exact
    # payloads keyed by chain hash)

    def _check_transferable(self, op: str):
        if self.cache_quant == "int8":
            raise ValueError(
                f"{op} cannot be used with cache_quant='int8': the int8 "
                "cache dequantizes through per-(slot, kv-head) DYNAMIC "
                "scales frozen at each sequence's own prefill, so a "
                "block's uint8 payload is only meaningful under its "
                "writer's scales. Disaggregated transfer requires the "
                "unquantized cache")

    def _geometry(self):
        """(block_size, layers, kv_heads, head_dim, dtype name): what a
        payload must match, the dtype as the reference writes it."""
        return (self.bs, self.L, self.KV, self.D,
                _dtype_name(self.key_caches[0].dtype))

    def _check_geometry(self, op: str, got):
        if tuple(got) != self._geometry():
            raise ValueError(
                f"{op}: payload geometry {tuple(got)} does not match this "
                f"engine's cache geometry {self._geometry()} (block_size, "
                "layers, kv_heads, head_dim, dtype) — transfers require "
                "identical cache layouts")

    def _held(self, hashes: Sequence[str]):
        """The chain's hashes up to the first one this pool no longer
        holds, and their block ids."""
        held: List[str] = []
        ids: List[int] = []
        for h in hashes:
            b = self.blocks.lookup(h)
            if b is None:
                break
            held.append(h)
            ids.append(int(b))
        return held, ids

    def _gather(self, ids: List[int]) -> torch.Tensor:
        """The blocks ``ids`` of every layer's K and V cache, stacked
        [2, L, n, KV, bs, D] on the device (one gather per cache), then
        brought to the host in one copy."""
        bids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return torch.stack([
            torch.stack([c.index_select(0, bids) for c in caches])
            for caches in (self.key_caches, self.value_caches)]).cpu()

    def export_blocks_packed(self, hashes: Sequence[str]
                             ) -> Tuple[Dict, bytes]:
        """Bit-exact KV payload for a chain of published block hashes
        (parent-first order) as ONE contiguous packed buffer.  Stops at
        the first hash this pool no longer holds — a chain is only usable
        up to its first gap.  Returns ``(header, raw)``: the reference's
        self-describing header (``shape`` = ``[2, layers, nblocks,
        kv_heads, block_size, head_dim]``, K/V stacked over the per-block
        cache slice; ``dtype`` "bfloat16" or "float32") and the raw bytes
        of one device gather and one device-to-host copy (bfloat16 leaves
        through an int16 view)."""
        self._check_transferable("export_blocks_packed")
        held, ids = self._held(hashes)
        header = {"block_size": self.bs, "layers": self.L,
                  "kv_heads": self.KV, "head_dim": self.D,
                  "dtype": self._geometry()[4], "hashes": held,
                  "shape": [2, self.L, len(held), self.KV, self.bs, self.D]}
        if not held:
            return header, b""
        return header, _host_array(self._gather(ids)).tobytes()

    def export_blocks(self, hashes: Sequence[str]) -> Dict:
        """The chain's payload in the dict form: ``{"block_size",
        "layers", "kv_heads", "head_dim", "dtype", "blocks": {hash: {"k":
        [per layer], "v": [per layer]}}}``, each entry a CPU tensor
        [KV, bs, D] of the cache's dtype (views into the one gathered
        buffer ``export_blocks_packed`` also reads)."""
        self._check_transferable("export_blocks")
        held, ids = self._held(hashes)
        blocks: Dict[str, Dict[str, list]] = {}
        if held:
            arr = self._gather(ids)
            for i, h in enumerate(held):
                blocks[h] = {"k": [arr[0, li, i] for li in range(self.L)],
                             "v": [arr[1, li, i] for li in range(self.L)]}
        return {"block_size": self.bs, "layers": self.L, "kv_heads": self.KV,
                "head_dim": self.D, "dtype": self._geometry()[4],
                "blocks": blocks}

    def import_blocks(self, payload: Dict) -> int:
        """Install an ``export_blocks`` payload (this engine's or the
        reference's: CPU tensors or numpy arrays, bfloat16 ones included)
        into this pool: allocate a block, ``publish`` it under its chain
        hash while live, then ``free`` it — which parks it in the reuse
        LRU, content-addressable exactly like a locally prefilled block —
        and write the bits on the device.  Already-cached hashes are
        skipped (first publisher wins); allocation pressure stops the
        import early (partial chains are still useful from the root).
        Every entry is checked before the pool or the cache changes.
        Returns the number of blocks imported."""
        self._check_transferable("import_blocks")
        self._check_geometry("import_blocks", (
            payload.get("block_size"), payload.get("layers"),
            payload.get("kv_heads"), payload.get("head_dim"),
            payload.get("dtype")))
        dt = self.key_caches[0].dtype
        shape = (self.KV, self.bs, self.D)
        items = []
        for h, kv in payload.get("blocks", {}).items():
            parts = []
            for side in ("k", "v"):
                layers = list(kv[side])
                if len(layers) != self.L:
                    raise ValueError(
                        f"import_blocks: block {h} holds {len(layers)} "
                        f"{side} layers, the engine {self.L}")
                parts.append([_block_tensor(a, dt, shape) for a in layers])
            items.append((h, torch.stack([torch.stack(p) for p in parts])))
        return self._install([h for h, _ in items],
                             lambda sel: torch.stack(
                                 [items[i][1] for i in sel], dim=2))

    def import_blocks_packed(self, header: Dict, raw: bytes) -> int:
        """Install an ``export_blocks_packed`` chain segment: the header's
        geometry, its shape and the byte count the geometry implies are
        checked BEFORE the cache is touched — a torn or truncated buffer
        is a typed ValueError, never a wrong or half-imported block — then
        allocate/publish/free/write as :meth:`import_blocks`.  Returns the
        imported count."""
        self._check_transferable("import_blocks_packed")
        self._check_geometry("import_blocks_packed", (
            header.get("block_size"), header.get("layers"),
            header.get("kv_heads"), header.get("head_dim"),
            header.get("dtype")))
        hashes = [str(h) for h in header.get("hashes") or ()]
        shape = [2, self.L, len(hashes), self.KV, self.bs, self.D]
        if list(header.get("shape") or ()) != shape:
            raise ValueError(
                f"import_blocks_packed: header shape {header.get('shape')} "
                f"does not match the geometry-implied {shape}")
        dt = self.key_caches[0].dtype
        host = _host_dtype(dt)
        expect = int(np.prod(shape)) * host.itemsize
        if len(raw) != expect:
            raise ValueError(
                f"import_blocks_packed: payload is {len(raw)} bytes but the "
                f"geometry implies {expect} — truncated or padded buffer "
                "rejected whole")
        arr = np.frombuffer(raw, dtype=host).reshape(shape)
        # fancy indexing copies the chosen blocks out of the read-only
        # buffer
        return self._install(
            hashes, lambda sel: torch.from_numpy(arr[:, :, sel]).view(dt))

    def _install(self, hashes: List[str], blocks_of) -> int:
        """The host half of an import, in the reference's order (skip a
        cached hash, stop when nothing can be allocated, else allocate,
        publish, free), then one write of the chosen payload blocks,
        ``blocks_of(payload indices)`` -> [2, L, n, KV, bs, D] on the
        host.  Returns the blocks imported."""
        dst: Dict[int, int] = {}     # block id -> payload index
        imported = 0
        for i, h in enumerate(hashes):
            if self.blocks.lookup(h) is not None:
                continue
            if not self.blocks.can_allocate(1):
                break
            (b,) = self.blocks.allocate(1)
            # an allocation may evict (and reuse) a block this import
            # parked earlier: the later write wins, as in the reference
            dst[b] = i
            self.blocks.publish(b, h)
            self.blocks.free([b])   # park published: reusable, evictable
            imported += 1
        if dst:
            self._write_blocks(list(dst), blocks_of(list(dst.values())))
        return imported

    def _write_blocks(self, ids: List[int], src: torch.Tensor):
        """Write ``src`` [2, L, n, KV, bs, D] (host) into blocks ``ids`` of
        every layer's caches, in place (the captured graphs read the
        caches by address): staged in pinned memory on CUDA, one
        host-to-device copy, then one ``index_copy_`` per cache."""
        if self.device.type == "cuda":
            staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            src = staged.copy_(src).to(self.device, non_blocking=True)
        bids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for li in range(self.L):
            self.key_caches[li].index_copy_(0, bids, src[0, li])
            self.value_caches[li].index_copy_(0, bids, src[1, li])

    def pull_blocks(self, peer_endpoint: str, hashes: Sequence[str], *,
                    epoch: Optional[int] = None,
                    timeout: float = 60.0) -> Tuple[int, int]:
        """Pull a chain segment straight off a peer's data-plane listener
        (inference/blockwire.py) and import it: the destination side of
        the one-hop transfer; the frontend only orchestrates it with
        directory-sized control messages.  The packed payload lands in
        the caches through ``import_blocks_packed`` (pinned staging, one
        host-to-device copy, one ``index_copy_`` per cache).  Returns
        ``(blocks_imported, payload_bytes)``.  Raises ``StaleEpoch`` when
        the peer fenced the handshake, ``WireError`` for transport faults:
        callers degrade to the frontend relay."""
        from .blockwire import default_pool

        header, raw = default_pool().pull(peer_endpoint, list(hashes),
                                          epoch=epoch, timeout=timeout)
        return self.import_blocks_packed(header, raw), len(raw)
