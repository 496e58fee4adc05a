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

There is no program cache and nothing compiles: ``compile_count`` stays 0.
Sampling draws with a counter-based function of ``(seed, sample index)``
on the device (``_uniform``), not with JAX's threefry, so seeded streams
replay across K, rebuilds and preemption but are not JAX's tokens.
``spec_k > 0`` and ``cache_quant="int8"`` are not ported yet and raise.

``ServingEngine(model, ..., device=None)`` runs on CUDA and raises
without it; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

import hashlib
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hopper.fused_norm import rms_norm_fused, rms_norm_residual_fused
from ..ops.hopper.fused_ops import swiglu_fused
from ..ops.paged_attention import blha_attention, plan_step
from .faults import register_failpoint

__all__ = ["BlockManager", "ServingRequest", "ServingEngine",
           "SamplingParams", "prefix_block_hash", "prompt_block_hashes"]

# fired at the top of load_weights, BEFORE any state is touched, so an
# injected swap fault leaves the old weights fully serving
WEIGHTS_SWAP = register_failpoint("weights.swap")


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
    # opt OUT of speculative decoding for this request (kept in the wire
    # form; speculative decoding is not ported yet, so it changes nothing
    # here)
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


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and c < 2**32, without
    leaving int64: multiply the 16-bit halves separately."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer: a bijective avalanche mix."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _uniform(seeds: torch.Tensor, sample_pos: torch.Tensor,
             V: int) -> torch.Tensor:
    """[B, V] float32 uniforms in (0, 1), a pure function of (seed, sample
    index, vocab id): the counter-based draw that stands in for the
    reference's ``fold_in(PRNGKey(seed), sample_pos)`` keys.  The same seed
    gives the same stream at any batch slot, megastep size or replica."""
    s = seeds.long()[:, None] & _M32
    p = sample_pos.long()[:, None] & _M32
    v = torch.arange(V, device=seeds.device)[None, :]
    h = _fmix32(_fmix32(s ^ 0x3C6EF372) ^ _mul32(p, 0x9E3779B1))
    h = _fmix32(h ^ _mul32(v, 0x27D4EB2F))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


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
    """Gumbel-max draw from the filtered logits: argmax(filt + G) with
    G = -log(-log(u)) is a categorical sample, as jax.random.categorical
    takes it."""
    g = -torch.log(-torch.log(_uniform(seeds, sample_pos, filt.shape[1])))
    return torch.argmax(filt + g, dim=-1).to(torch.int32)


def _sample_tokens(logits, temps, top_ks, top_ps, seeds, sample_pos,
                   return_probs: bool = False,
                   all_greedy: Optional[bool] = None):
    """Next-token selection for one batch of logits rows [B, V], on the
    logits' device.

    Greedy rows (``temps <= 0``) take the exact float32 argmax.  Sampled
    rows divide by temperature, apply top-k and top-p in sorted space and
    draw with the counter-based ``(seed, sample_pos)`` stream.  The caller
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
        if cache_quant == "int8":
            raise NotImplementedError(
                "cache_quant='int8' is not ported yet (a later slice of the "
                "port: the int8 paged cache and its scan-carried scales)")
        if int(spec_k) < 0:
            raise ValueError("spec_k must be >= 0")
        if int(spec_k) > 0:
            raise NotImplementedError(
                "spec_k > 0 is not ported yet (a later slice of the port: "
                "n-gram drafting and the batched verify program)")
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
        self.prefix_cache_enabled = prefix_cache in ("auto", True)
        self.prefix_hit_blocks = 0      # full blocks reused from the cache
        self.prefix_miss_blocks = 0     # full prompt blocks that missed
        self.prefill_tokens_computed = 0  # prompt tokens actually fed
        self._compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                               else torch.float32)
        cache_dtype = (self._compute_dtype if cache_dtype is None
                       else _torch_dtype(cache_dtype))

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
        # nothing is traced or compiled: kept for the reference's surface
        self.compile_count = 0

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

    def _trunk(self, token_ids, enc, dec, now, cu, bt, mq):
        """embed -> layers -> final RMSNorm over the packed buffer
        [T] -> [T, E]; writes this step's K/V into the caches in place.
        ``mq`` is the padded per-row query length (1 for pure decode).  The
        norms are K1: layer 0's ``ln1`` alone, then each residual add fused
        with the norm after it (``ln2``, the next ``ln1``, the final
        ``norm``), 2L+1 launches."""
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
                use_neox_style=True, compute_dtype=hidden.dtype, plan=plan)
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
        """The single-step program: one forward + sampling."""
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
        (empty slots) never write.  Returns stacked [K, B] (tokens, valid,
        logprobs) and [K, B, V] probs or None."""
        enc = torch.zeros_like(dec)
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

    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: schedule -> device step(s) -> retire.
        Returns tokens appended this step, {rid: [tok, ...]}.

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
        if (decode_only and self.megastep_k > 1
                and max(r.max_new_tokens - len(r.generated)
                        for r, _, _ in sched) > 1):
            self.phase_seconds["schedule"] += self._clock() - t0
            return self._megastep([s[0] for s in sched])
        # MIXED-PHASE arming: any decoding row + any prefilling row -> run
        # both phases inside one device loop instead of falling back to
        # per-token host stepping.  bs > T cannot exact-pack a full chunk
        # into the token buffer.
        if (self.megastep_k > 1
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
        nxt, lps, probs = self._run_step(
            self._dev(tokens), self._dev(enc), self._dev(dec),
            self._dev(now), self._dev(cu), self._dev(self.block_tables),
            self._dev(temps), self._dev(top_ks), self._dev(top_ps),
            self._dev(seeds), self._dev(spos),
            1 if decode_only else self.T, bool((temps <= 0).all()))
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
        toks_o, valid_o, lps_o, probs_o = self._run_megastep(
            self._dev(toks), self._dev(dec), self._dev(now), self._dev(cu),
            self._dev(occ_idx), self._dev(self.block_tables),
            self._dev(active), self._dev(remaining), self._dev(dl),
            self._dev(eos), self._dev(temps), self._dev(top_ks),
            self._dev(top_ps), self._dev(seeds), self._dev(spos), K,
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
        pp_f, toks_o, emits_o, lps_o, probs_o = self._run_mixed(
            self._dev(toks), self._dev(cached), self._dev(pp),
            self._dev(pp0), self._dev(plen), self._dev(prompt_buf),
            self._dev(self.block_tables), self._dev(active),
            self._dev(remaining), self._dev(dl), self._dev(eos),
            self._dev(temps), self._dev(top_ks), self._dev(top_ps),
            self._dev(seeds), self._dev(spos), K, bool((temps <= 0).all()))
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
