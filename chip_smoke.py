#!/usr/bin/env python3
"""Drive paddle_tpu_torch's paths — Llama serving through the paged
ServingEngine (with speculative decoding, KV block transfer, the int8
KV cache, a KV cache of the other float dtype, the serving control plane
over two engines, the serving fleet over worker processes and the
in-process chaos soaks), Llama
generation (forward, generate, greedy_decode) over the
static KV ring (also under AMP O1), Llama pretraining (TrainStep + AdamW,
and through static Programs, and under AMP with
a GradScaler, a gradient clip and a schedule, and under Lamb and the other
optimizers), bench_ladder.py's BERT-base finetune with dropout (also
through hapi.Model with DataLoader workers, checkpoints and a reload),
GPT-3 1.3B pretraining and generation over growing caches, the
Transformer base's training and cached decoding, and the inference
Predictor with weight-only int8 over bench_ladder.py's BERT-base classifier,
and its deployment (to_static, jit.save / jit.load over torch.export, the
artifact Predictor) — on one NVIDIA H100, and check every Hopper kernel on
them.

    python3 chip_smoke.py                  # all phases
    python3 chip_smoke.py --phases 1,2     # build + kernel checks only
    python3 chip_smoke.py --phases 2,9,10  # kernels + the int8 predictor
    python3 chip_smoke.py --phases 2,13    # kernels + block_multihead_attention
    python3 chip_smoke.py --phases 14      # the serving control plane
    python3 chip_smoke.py --phases 15      # the serving fleet
    python3 chip_smoke.py --phases 2,16    # kernels + the chaos soaks
    python3 chip_smoke.py --phases 2,8,17,18  # kernels + AMP and dropout
    python3 chip_smoke.py --phases 19,20   # Model.fit, the optimizers
    python3 chip_smoke.py --phases 2,21,22,23  # kernels + GPT, the decoder
    python3 chip_smoke.py --phases 24      # jit.save artifacts, to_static
    python3 chip_smoke.py --phases 7,25    # static Programs (beside phase 7)
    python3 chip_smoke.py --masked-rows PARENT_DIR  # masked K4 rows only
    python3 chip_smoke.py --decode-costs PARENT_DIR  # dispatch, decode
    python3 chip_smoke.py --phases 1,2 --k1-sweep   # + K1 under each plan

Phases (each prints its seconds):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), compute capability 9.0, and the kernel build from
     paddle_tpu_torch/csrc (nvcc, sm_90a); cuobjdump -sass of the build must
     show tensor-core instructions in every bf16 instance of B1, B8 and B7
     (HGMMA) and of B2 (HMMA);
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     in bfloat16 and float32, at the shapes the paths give it (B9 over
     three steps from one state; also with a TrainStep's clip scale and
     skip flag on the device, and with the flag set: parameter, master and
     moments bit for bit the inputs, and AdamW's step count t unchanged);
     then CUDA-event times (L2 flushed before each launch) of the kernel,
     the plain version and, where one exists, the one PyTorch call that
     computes the same function, beside the bound: the larger of bytes
     moved over 3.35 TB/s and operations over the peak rate of the type,
     and each row's TFLOP/s and share of its bound;
     K4 at serving's shapes: decode (8 rows; 32 / 32 heads at D 128, 8 / 2
     at D 256, 64 / 1), the single step's mixed batch (max_q_len 256), the
     mixed loop's program (T 256, max_q_len 16), a long-context decode
     (2 rows of ~4000 keys) and the speculative verify (8 rows of up to 9
     tokens, T 72, max_q_len 9, context <= 512, 32 / 32 and 32 / 8 heads),
     each with its GB/s, share of the bound and
     plan (query tile, key tile, ring, splits) (with --k4-sweep, each K4
     case also timed under other plans, informative); B2 at generation's
     shapes (8 rows over 512- and 4096-row rings, 32 / 32 and 32 / 8 heads,
     greedy_decode's pos 150, one row of 32 / 8 heads at pos 4000), each
     with its GB/s, share of the bound and plan (instance, key tile,
     splits) (with --b2-sweep, each B2 case also timed under every split
     count, informative); B7 at the predictor's shapes with and without
     the bias (the head on its strided rows), each with its plan (kind,
     token tile, weight rows, splits) and, informative, the time of
     torch.matmul with the dequantized weight (with --b7-sweep, each bf16
     B7 case also timed under every plan the instances take); K3 also on
     numel % 8 != 0 and at an odd storage offset; K1 at [8, 4096], [1,
     16384], [4, 16384], [2, 32768] and at an odd storage offset, each
     with its plan (with --k1-sweep, each bf16 K1 case also timed under
     every plan the instances take, informative); K2 at a decode step's
     packed [1, 8] rows, at greedy_decode's [8, 1] with the ring's pos on
     the device (32 / 32 and 32 / 8 heads) and at an offset the clamp
     moves; K2's ring mode (B3 folded in) at greedy_decode's decode step
     and [8, 128] prefill, held to the plain composition and, bit for bit,
     to rope_fused then kv_ring_write; B3 at pos -3 (C7: the start counts
     from the end, row 509), bit for bit against index_copy_ at
     dynamic_update_slice's start; B1, B8, B2, B3, K4 and the ring mode at
     head_dim 72, 100, 264, 512, 516, 640 and 1024 (8 / 2 heads; past 512
     the wide instances), SDPA at the same shape the library call; K1 and K2 under every plan their instances take
     (both bodies, rows past the registers, D 72 and 2, strided qkv
     columns, device offsets) against their plain versions, the rope backward's sign flag
     giving the bits of K2 with a -sin table, and apply_rotary_pos_emb
     with a device offset dispatching one K2 launch and nothing else; a
     shape past a kernel's limits is refused with an error, a head dim of
     520 (refused before Queue C8) is computed by B1, B8, B2 and K4 and
     held to the plain versions, and B7 refuses a float16 x and an int32
     weight; K4, B2 and B7 at the edges their
     tiles and splits add (K4 and B2 also at head_dim 72, 100, 264 and
     512, B2 at a negative pos)
     (every split count forced, K4 also every ring depth and several query
     tiles; B7 at M 1, 8, 9, 64, 65 and 4097, N 2 and 130, K 100 and 4096
     and the strided head, with and without a bias, the fused bias giving
     the two-step bits; in both types) against their plain versions, each
     cluster plan giving the same bits in five runs;
     K4-int8 over uint8 pools of random codes with random per-(row, KV
     head) scales: decode (8 rows, context <= 512, 32 / 32 and 32 / 8
     heads), the single step's mixed batch of 255 tokens with an
     out-of-pool block in a decode row's visible range, and decode at 8 /
     2 heads, head_dim 72, 100, 264, 512 and 640, each with its plan and,
     informative, K4's time over a cache of q's dtype at the same shape;
     the pre-caches (A4b): K4 and K4-int8 at decode with a 64-key prefix
     (8 rows, context <= 512, 32 / 32 and 32 / 8 heads; K4's library time
     SDPA over the concatenated context), and every K4 instance (tensor
     cores, SIMT, wide) and both K4-int8 ones with prefixes of 1, 64 and
     130 keys at decode and at the mixed 255-token step, one and four
     splits forced, against their plain versions;
     the additive masks (A4b): K4 and K4-int8 in their masked instances
     at decode (tgt_mask [8, H, 1, 512]) and at the mixed 255-token step
     (its prefill rows under mask [8, 1, 256, 512]), 32 / 32 and 32 / 8
     heads (K4's library time SDPA with a float attn_mask; the bound
     counts the masks' bytes), and every instance under masks of one and
     H heads, fewer and more rows and columns than the call's, with
     prefixes of 0, 1, 64 and 130 keys, splits forced, against their plain
     versions; rows whose visible logits all sit at or below -1e30
     (Queue C10: a decode row's visible keys all -inf or all
     finfo(float32).min, a prefill row's all -inf, every key -inf) in
     every masked instance, with and without a 64-key prefix, one and
     four splits forced: the kernels equal the plain versions (the
     reference's softmax over the invisible keys' -1e30 logits; NaN where
     every key is -inf);
     the entry refuses a mask without seq_lens_encoder or of a head count
     other than 1 and H;
     K4 over a cache whose dtype is not q's (Queue C12): a float32 q over
     bfloat16 pools (the SIMT and wide instances with the cache's element
     type) and a bfloat16 q over float32 pools (widened by the wrapper) at
     decode (8 rows, context <= 512, 32 / 32 and 32 / 8 heads), the
     single step's mixed batch of 255 tokens, a 64-key prefix in the
     cache's dtype, the masks and head_dim 640, each under the plan's
     split and 1 and 4 splits forced, the same bits twice, timed beside
     the float32 K4 over a float32 cache and SDPA over the context widened
     to float32 (rows of their own in the kernels line, "cache_dtype"
     set); the K4 entry refuses a bfloat16 q over float32 pools, and
     decode_attention a ring of another dtype than q's;
     K2's interleaved pairs at the serving step's [1, 256] rows;
     then (informative) B1 and B8 in bf16 at every compiled tile pair
     (autotune.tune), B8's two GQA modes, and whether two bf16 B8 runs
     agree bit for bit;
  3. Llama-2-7B geometry (32000 vocab, 4096 hidden, 11008 intermediate, 32
     layers, 32 heads) in bfloat16 with seeded random weights, served by
     ServingEngine(max_batch_size=8, max_seq_len=512, block_size=16,
     token_budget=256) with the default megastep_k=8 and prefix cache, in
     two waves (the first holds a sampled request); the megastep loops and
     the single step run as CUDA graphs (the engine's default on CUDA);
     the kernels' launch
     counters are zeroed just before and read just after, and the device
     loops and every graph replay run with CUDA sync debugging set to
     raise (no host sync inside a megastep); an eager engine
     (_graphs = False) over the same weights serves the same waves:
     tokens, logprobs and scheduling counters identical, compile_count the
     graphs captured (each one's first-call and capture times printed);
     then on each engine a decode wave (its captures), one timed and one
     under torch.profiler give the wall, the device's busy share, memory,
     K4's device time and kernel count in the traced wave (one kernel per
     wrapper call; a replay adds its captured counts), K1's and K2's
     device time, kernel count and time a launch, and each wave's single
     steps (their count, execute ms and eager runs: none in a timed wave
     on graphs); and the cost of the seeded threefry draw per sampled
     step;
  4. the same geometry at 2 layers in float32 served on cuda (kernels) and
     on the CPU (plain versions) from identical weights: first-step logits
     agree, greedy tokens agree up to the first position whose CPU top-2
     logit gap is below 1e-3, and prefix cache on/off agree on cuda; then
     the same for 2-layer float32 Llamas at head_dim 72 (hidden 576, 8
     heads), 264 (1056, 4) and 640 (1280, 2); and a graph engine after
     load_weights drops its graphs, captures again and serves the new
     weights' tokens; the 2-layer pair also serves repetitive prompts
     with spec_k 8 on cuda and on the CPU (the same top-2-gap rule), and
     a packed block export made on cuda, imported into a CPU engine,
     serves wave 2 with the CPU engine's tokens (the same rule); and the
     int8 cache (cache_quant="int8", K4-int8) on cuda against the CPU at
     head_dim 128, 72 and 640: greedy tokens equal up to the first top-2
     gap below 1e-3 of the CPU engine's own int8 decode, logprobs within
     1e-3 of the largest |logprob| + 1e-3 there; C12's engines: the
     2-layer float32 pair over a bfloat16 cache and a 2-layer bfloat16
     pair over a float32 cache, each against the CPU engine of the same
     cache_dtype (the bf16 pair's logits within 2^-5 of the largest
     |logit|, its tokens up to the first top-2 gap under 2^-6 of it); then the
     7B widths in float32 cut to 4 layers over a bfloat16 cache serve 8
     requests (one sampled) on CUDA graphs and eagerly, tokens and
     logprobs equal bit for bit (the "mixed_cache" path's launches), a
     profiled wave's K4 kernels the float-over-bf16 instance;
  5. generation at full width, on phase 3's model: the launch counters are
     zeroed, then (a) model(ids [2, 1024]) gives finite logits, (b) on the
     eager loop (_graphs = False), then on CUDA graphs (the default on
     CUDA: one decode step captured per (B, L), after a short call that
     warms the (8, 512) key, its first-call and capture times printed):
     greedy_decode of ids [8, 128], 128 new tokens over a 512-row ring runs
     with CUDA sync debugging set to raise (tokens/s printed, informative;
     then a 32-token greedy_decode untraced and one under torch.profiler
     give the device's busy share and time by kernel, the trace's kernel
     count, K1's and K2's device time, count and time a launch, and B2's
     device time and kernel count in the traced loop: one kernel per
     wrapper call; no B3 kernel, and as many K2 kernels as ring-mode calls,
     the plain rope mode uncalled; max_memory_allocated); the graph loop's
     tokens at + 128 and + 32, its counters and its trace's kernels by name
     and count equal the eager loop's, but for the fills (the eager loop
     zeroes fresh rings each call: 2 a layer and 1 more), (c)
     generate with the static ring equals greedy_decode; generate with
     growing caches (B1 for every step) gives greedy_decode's first
     token (the same prefill), its logits on greedy_decode's tokens agree
     with the ring path's (B2) within 5% of the largest logit, and its
     tokens agree up to the first position whose top-2 gap is below the
     larger of 1e-3 and twice that logit difference (in bfloat16 the two
     decode kernels' roundings compound over 32 layers: the 1e-3 rule of
     phase 4 holds in float32, phase 6), (d) generate(do_sample=True,
     top_p=0.9, generator=Generator(7)) gives tokens in the vocabulary;
     then the counters are read: every kernel of the path launched;
  6. phase 4's two 2-layer float32 models: forward logits on cuda and on
     the CPU agree, and greedy_decode and generate (ring and growing) on
     cuda agree with greedy_decode on the CPU up to the top-2-gap stop,
     greedy_decode on graphs bit for bit with the eager loop on cuda;
     then the same at head_dim 72, 100 (800 hidden, 8 heads), 264 and 640;
  7. training at bench.py's honest geometry (32000 vocab, 2560 hidden,
     8192 intermediate, 9 layers, 20 heads of 128, bfloat16, recompute)
     with seeded random weights: AdamW(1e-4, multi_precision=True),
     LlamaPretrainingCriterion and TrainStep on one [8, 2048] batch; the
     counters are zeroed, then 2 warm-up and 10 timed steps (finite losses,
     the last below the first; tokens/s, ms per step, peak memory and MFU
     against 989 TFLOP/s printed, informative), run_steps over a
     [4, 8, 2048] stack with CUDA sync debugging set to raise, one step
     untraced and one under torch.profiler (busy share, time by kernel,
     K1's and K2's time a launch, the copy kernels); then every
     kernel of the path launched;
  8. phase 4's float32 pair: one step's loss and every parameter's
     gradient, then the parameters after 3 AdamW(multi_precision) steps
     through TrainStep, kernels on cuda against the plain path on the CPU
     (1e-4 of each tensor's largest |value|); then the same at head_dim
     72, 264 and 640; then a 2-layer float32 pair at hidden 1024 (8
     heads of 128, vocab 8192; identical weights) through
     TrainStep under O1 bf16 with a GradScaler, ClipGradByGlobalNorm and a
     LinearWarmup schedule, 3 steps, one forced to overflow (the loss times
     inf), one more: cuda against the CPU at the bf16 tolerance
     ``training_amp_vs_plain`` states, the scaler's state equal, the
     overflow step leaving cuda's state bit for bit;
  9. bench_ladder.py's BERT-base classifier (vocab 30522, hidden 768, 12
     layers, 12 heads, FFN 3072, seq 128) in bfloat16 with seeded random
     weights, ids [32, 128]: (a) the float Predictor gives finite logits;
     (b) the weight-only int8 Predictor (a CUDA graph per input signature,
     the default on CUDA), with the counters zeroed just before one
     replayed run and read just after, launches B7 exactly 73 times and
     B1 12 times, adds every biased Int8Linear's bias in B7's epilogue (a
     counter) and gives finite logits (their distance from (a) printed,
     informative); (c) a full-width bf16 weight quantizes to the same int8
     values and scales on cuda and on the CPU; (d) at [32, 128] and [1,
     128], each predictor on graphs gives the eager predictor's
     (_graphs = False) outputs bit for bit, and ms per run, sequences/s
     and one run untraced and one under torch.profiler (busy share, time
     by kernel) of both predictors in both modes, informative; (e) one
     biased Int8Linear's forward is one B7
     launch with its bias and dispatches no add to PyTorch, and the int8
     run's profile holds no add kernels beyond the residual and
     position-embedding adds;
 10. the classifier at 2 layers in float32 with identical weights on cuda
     and on the CPU, ids [4, 128], through int8 Predictors (identical
     quantized weights) and float ones: logits within 1e-4 of the largest
     |logit|;
 11. speculative serving and block transfer on phase 3's model (run
     before the model is dropped for phase 7), phase 3's engine geometry:
     (a) engines with spec_k 8 (on CUDA graphs, and eager with
     _graphs = False) and spec_k 0 over the same weights serve 8 requests
     of repetitive 64-token prompts, 64 new tokens each, one seeded; the
     counters are zeroed just before the spec engine's wave and read just
     after (the "spec" path); the verify and every loop run under CUDA
     sync debugging set to raise; graphs == eager bit for bit (tokens,
     logprobs, spec and scheduling counters); spec-on == spec-off, or
     at the first position that differs spec-off's choice (teacher-forced)
     was within bfloat16's step, 2^-7 of the largest |logit|: its top-two
     logits, or for the seeded row the top two of its filtered, scaled
     logits plus its Gumbel noise (the margin printed); verify forwards, drafted, accepted, tokens per
     verify, each graph's first-call and capture ms; then for each mode a
     wave untraced and one under torch.profiler (wall, busy share, K1/K2),
     K4's kernels equal to its wrapper calls, and K4's device time per
     launch by the program that launched it (the verify, megasteps, the
     single step); (b) engine A prefills 8 prompts of 256 tokens and
     exports their chains (bytes, ms, GB/s), a fresh engine B imports
     them (ms, GB/s) and exports the same bytes, then serves the prompts
     on the imported prefix (hits = blocks imported) with the tokens of
     engine C, which warmed the same prompts itself, bit for bit;
 12. int8-cache serving on phase 3's model (run before the model is
     dropped for phase 7), phase 3's engine geometry with megastep_k 8 and
     cache_quant="int8": the KV bytes (pools and scales) against the bf16
     cache's; two waves of prompts up to token_budget (one sampled) on
     CUDA graphs, the counters zeroed just before and read just after (the
     "int8" path: K4-int8 launched, K4 over a bf16 cache not), every
     replay under CUDA sync debugging set to raise; an eager engine
     (_graphs = False) over the same weights gives identical tokens,
     logprobs, counters and every layer's cache_scales (each prefill a
     single step, on its graph); the share of tokens equal to a
     bf16-cache engine's (printed); then phase 3's decode wave on each
     engine, one untraced and one under torch.profiler (wall, busy share,
     K1/K2, K4-int8's device time and kernels, equal to its wrapper calls,
     each wave's single steps as phase 3's);
 13. the public incubate.nn.functional.block_multihead_attention (run
     before the 7B model is built) at the 7B attention geometry (32 heads
     of 128, batch 8, max_seq_len 512 in blocks of 64, a [64, KV, 64, 128]
     pool pair for each of 8 layers (the 7B's 32 cut to 8, for phase
     24's time), seeded random qkv): a prefill call a
     layer (prompts of 7-400 tokens under an ALiBi causal-plus-padding
     mask), then 32 decode steps of 8 layers under tgt_mask, over bf16,
     static-int8 and dynamic-int8 pools, with a 64-key pre-cache, and at
     32 / 8 heads; each run's outputs, pools and scales held against its
     plain twin on the card (K2, K4 and K4-int8 replaced by their plain
     versions), K4 / K4-int8 and K2 launches equal to the calls, all of
     them masked, the pools' data_ptr() unchanged, ms a call; then two
     float32 layers on cuda against the same calls on the CPU;
 14. the serving control plane on phase 3's model (run before the model is
     dropped for phase 7): a prefill-role and a decode-role engine of phase
     3's geometry (megastep_k 8, prefix cache, CUDA graphs, a flight
     recorder each), each with a BlockWireServer on 127.0.0.1, under one
     ServingFrontend with ServingMetrics, a Tracer, a RequestJournal in a
     temporary directory and a KVFabric over MemoryKV; 12 requests of 32
     new tokens (8 on a 256-token system prefix with 7-144 tokens of their
     own, 4 sharing nothing; HIGH, NORMAL and LOW; one seeded sampled, one
     cancelled after its first tokens, one with a deadline), the counters
     zeroed just before and read just after the graph pair's runs (the
     "control" path), every engine program and replay under CUDA sync
     debugging set to raise: every prefill pass on the prefill engine, its
     chain pulled over the wire by the decode engine (blocks, bytes and
     GB/s printed; informative, one pull split into export, wire pull and
     import), no fallback, relay pull, pull failure, recompute, replica
     death or failover requeue; then a second frontend dropped
     with requests in flight and ServingFrontend.recover over the same
     engines: the orphans reaped, every client retry answered with its
     first rid, one terminal record per admitted request; every trace
     tree complete; statuses, tokens and logprobs of both runs equal bit
     for bit to the same runs over eager twins (_graphs = False); TTFT,
     inter-token latency and tokens/s beside the card's name and power
     limit, the Prometheus text parsed; (informative) how many requests
     one engine without the frontend gives the same tokens; a profiled
     stretch through a frontend over the graph pair: K4 unmasked;
 15. the serving fleet across worker processes (run after the 7B model is
     dropped): a ServingFleet of three paddle_tpu_torch.tools.serving_worker
     processes on cuda (prefill, decode, decode), each Llama-2-7B width cut
     to 8 layers (bf16, seed 15, phase 3's engine geometry, megastep_k 8,
     prefix cache, CUDA graphs, a flight recorder and a blockwire
     listener), and a warm one booting beside them; phase 14's 12
     requests (no client keys, none cancelled) through the fleet and
     through an in-process twin (one ServingFrontend over three engines
     of the same roles on the parent's own model of the same spec, each
     stepped at begin_step as a worker is): statuses, tokens and logprobs
     equal bit for bit; every decode-role chain pulled worker to worker
     (_w_pull_blocks over blockwire: blocks, bytes and GB/s printed), no
     relay, fallback, pull failure or recompute; TTFT, inter-token latency
     and tokens/s of that first run (captures inside) and of a second one,
     each process's memory, beside the card's name and power limit; then
     the traffic again with worker2 SIGKILLed after its first tokens: the
     heartbeat finds it, every request completes, at least one requeued,
     the tokens held to the first run's (equal, or from the first position
     whose margin is under bf16's step: the exact-equality count
     printed); the warm worker claimed from the WarmPool; a rolling_swap
     to the same spec as "v1" and 4 requests after it (two over the
     shared prefix, two without it, so the claimed worker takes some)
     held the same way;
     the fleet's Prometheus page parsed with its replica labels; every
     worker's launch counts set to 0 over RPC before the first run (a
     warm worker zeroes its own after its warm-up), and after shutdown
     each surviving worker's WORKER_EXIT counts: each survivor took
     requests of the phase, K1-K4 launched in each, no masked K4;
  16. the in-process chaos soaks of paddle_tpu_torch.tools.chaos_serving
     on the card (run after the 7B model is dropped), at Llama-2-7B width
     cut to 2 layers in float32 (CHAOS_MODEL says why not bf16) with the
     soaks' own ENGINE, seeds and streams: run_chaos at seed 7 (poison)
     and with a brownout, run_chaos twice at seed 11 (equal reports:
     replay determinism on graphs), run_chaos_spec, run_chaos_disagg,
     run_chaos_multitenant,
     run_kill_frontend (its serve-phase child on cuda, a real SIGKILL)
     and run_standby, each with its own assertions (every request typed
     terminal, survivors equal to the fault-free run on the card, the
     faults fired); each mode's seconds and fault kinds printed;
 17. Llama pretraining as a user runs it (after phase 8): bench.py's
     geometry built in float32, amp.decorate(level="O2", bf16: every
     parameter bf16, float32 masters), AdamW(LinearWarmup(3) into
     CosineAnnealingDecay, ClipGradByGlobalNorm(1.0)), a dynamic
     GradScaler, TrainStep over LlamaPretrainingCriterion under
     auto_cast(O2) on [8, 2048], recompute on; every step under CUDA sync
     debugging set to raise, the learning rate held to the schedule
     written out in the script on each step: 8 steps (6 timed), one
     forced to overflow (every parameter, master, moment and step count
     bit for bit, the scale halved), 4 more; 12 finite losses, the last
     below the first; ms a step, tokens/s, peak memory, a profiled step's
     copy kernels (the AMP casts: their count and time beside phase
     7's); the "train_amp" path's launches (no fused residual K1);
 18. bench_ladder.py's BERT-base finetune (accelerator geometry, dropout
     0.1, gelu), model.bfloat16(), AdamW(2e-5, multi_precision), TrainStep
     over cross_entropy on ids [32, 128]: the same forward from one
     generator state twice gives the same loss bit for bit, another seed
     another; a [32, 12, 128, 128] mask keeps 0.9 +- 0.005; 12 steps under
     CUDA sync debugging set to raise, finite losses, ms a step,
     examples/s, the int64 (threefry) kernels' share of a profiled step's
     device time, and the step's masks drawn alone: their profiled
     device time as a share of the step's, and their CUDA-event time; the
     "finetune" path's launches (B9; no B1 at dropout 0.1); then a 2-layer
     BERT at hidden 128 on cuda against the CPU: the same masks bit for
     bit, 3 steps' losses and parameters within 1e-4;
 19. the same BERT-base finetune through hapi.Model as a user writes it:
     AdamW(LinearWarmup, multi_precision) prepared with cross_entropy and
     Accuracy; fit over a TensorDataset of 256 seeded examples (8 steps an
     epoch) and 64 for evaluation, batch 32, 2 epochs, shuffle off, two
     DataLoader worker processes (the shared-memory ring g++ builds from
     paddle_tpu_torch/native/shm_queue.cpp), ModelCheckpoint(save_freq=2),
     LRScheduler(by_step) and EarlyStopping("val_loss"); then evaluate,
     predict, save and load: finite losses, an evaluation after each
     epoch, fit's batches equal to an in-process loader's bit for bit,
     every sample read in a child forked from this CUDA process, two
     checkpoints (their sizes), a fresh model and optimizer loaded from
     the final one giving the trained model's eval logits and the saved
     optimizer state (dtypes and bits), predict's outputs equal to the
     evaluation's logits; the train step's ms (the step sync-free, its
     loss read once), examples/s, the evaluation's ms a batch and each
     checkpoint's seconds; the "fit" path's launches (B9 once a parameter
     a step, B1 once a layer an evaluation forward);
 20. the other optimizers: (i) phase 7's Llama (bf16, recompute) under
     Lamb(LinearWarmup into CosineAnnealingDecay, multi_precision,
     ClipGradByGlobalNorm(1.0)) through TrainStep, 5 steps under CUDA sync
     debugging set to raise: finite, falling losses, ms a step, tokens/s,
     a profiled step and the update alone (kernels and device time); the
     "optimizers" path's launches (K1-K3, B1, B8, B6b; no B9); (ii) a
     2-layer float32 Llama at hidden 256 on cuda and on the CPU from the
     same weights, 3 TrainSteps of each of the 12 optimizers TrainStep
     takes (a clip and a StepDecay schedule) and two LBFGS step(closure)
     calls: every parameter and state tensor within 1e-4 of the CPU's in
     L2 norm relative to the tensor's, the worst printed;
 21. (run right after phase 1, while no phase holds memory on the card)
     GPT-3 1.3B (gpt3_1_3b, seeded random weights on the card) under
     amp.decorate O2 bf16 with AdamW(multi_precision): a warm-up and 3
     timed TrainSteps on one [4, 2048] batch (finite, falling losses; B1
     and B8 24 launches a step, B9 293: counted exactly), ms a step,
     tokens/s, max_memory_allocated, a profiled step; then in eval under
     auto_cast O2 greedy generate of 8 prompts x 128 tokens, 32 new, over
     growing caches (ms a token, B1 exactly 24 x 32), and each cached
     step's logits against one full forward over prompt + generated
     tokens (4e-2 of the largest |logit|);
 22. GPT at gpt3_1_3b's width cut to 2 layers, float32 and O2 bf16, the
     same weights and CUDA tensors through B1 / B8 / B9 and through their
     plain versions: logits, loss, every gradient, every parameter and
     optimizer state after one AdamW step (1e-4 / 3e-2), generate's greedy
     tokens (float32 equal; bf16 up to a near tie), and in float32 the
     identity of tests/test_gpt.py (the last generated token is the full
     forward's argmax);
 23. the Transformer base (d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
     dropout 0.1) under O2 bf16: 3 TrainSteps on seeded embedded inputs,
     src and tgt [32, 128] under generate_square_subsequent_mask (B9 once
     a parameter a step, no B1 at dropout 0.1), ms a step, a profiled
     step; then in eval
     the encoder's memory, gen_cache and 64 cached steps (B1 at [32, 1,
     8, 64] over the growing Cache and the StaticCache), ms a step, each
     step against row t of the teacher-forced decoder (bf16 5e-2; float32
     on a twin with the initial weights 1e-4), B1 counted exactly;
 24. (after phase 10) deployment: BERT-base (phase 9's classifier, bf16,
     [32, 128]) saved by jit.save(jit.to_static(model), path,
     input_spec=[InputSpec([32, 128], "int32")]) (a torch.export program
     whose Hopper kernels are custom ops), served by Config(path) on CUDA
     graphs: its logits against the live Predictor's bit for bit (else
     the difference named and held to bf16's 1.6%), a replay's B1
     launches the live one's; the same for the int8-rewritten model (B7
     and its fused biases); enable_batch_padding at batch 20 of 32 (and
     batch 33 refused); a 2-layer Llama at 7B width (bf16, [1, 256]): a
     replay's K1, K2, K3 and B1 launches and logits against the live
     forward's; to_static on the card (one capture, a replay launching
     eager's kernels, dropout's masks new each call and bit for bit
     eager's for the same keys, a host read mid-forward giving 2 segments
     and eager's values, full_graph=True raising); the float32 2-layer
     Llama exported on cuda and on the CPU, logits within 1e-4 of the
     largest |logit|; export, save, load, first-run, capture and steady
     ms and each .pt2's bytes;
 25. (after phase 7) static Programs (paddle_tpu_torch.static): C16 first
     (a float32 2-layer 7B-width Llama under auto_cast O1 bf16: a decode
     step's new cache rows over growing caches and the ring against the
     CPU's plain versions, and generate (ring and growing) and
     greedy_decode's tokens against the CPU's); a 2-layer 7B-width bf16
     Llama recorded under program_guard with data("ids", [1, 256]) and
     replayed by Executor.run (the first run eager, then captured, later
     runs graph replays adding no cache entry) bit for bit and launch for
     launch against the eager forward, the same after DCE, CSE and
     constant folding, and through save_inference_model /
     load_inference_model; bench.py's Llama (phase 7's geometry, bf16,
     float32 masters, no recompute) at [8, 2048] trained by three
     Executor.run steps of AdamW.minimize(pretraining_loss) against an
     eager twin (step 0's loss bit for bit, later ones within 1e-5, the
     spread two eager twins show), each kernel's launches a step equal,
     the loss's checkpointed chunks replayed through checkpoint, ms a
     step and peak memory (above what was held before the model) beside
     the twin's, and phase 7's;
  then one JSON line {"kernels": [...]}, "launches" per path ({"serving",
  "int8", "spec", "generate", "train", "predict", "blha", "control",
  "fleet", "mixed_cache", "chaos", "train_amp", "finetune", "fit",
  "optimizers", "gpt", "decoder", "deploy", "static"}, null for a
  path whose phase did not run; "fleet" the sum over the surviving
  workers), then the card line, then {"ok": true, "device": {...}} as the
  last line.

Any failure raises and the script exits non-zero before the last line.  It
imports nothing of JAX or paddle_tpu.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor, fp32 SIMT
_PROFILE_MARKS = 2048   # spin kernels on each side of a profiled call
_PROFILE_TAKES = 3
_REPLAYS = [0]          # CUDA graph replays of the run (main's wrapper)
REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:47",
    "rms_norm_residual": "paddle_tpu/ops/pallas/fused_norm.py:61",
    "rope": "paddle_tpu/ops/pallas/fused_ops.py:65",
    # K2's ring mode: the rotation of fused_ops.py:65 with the ring write of
    # decode_attention.py:70 (B3) folded into its launch
    "rope_ring": "paddle_tpu/ops/pallas/fused_ops.py:65",
    # the same kernel rotating the cotangents by -theta
    "rope_bwd": "paddle_tpu/ops/pallas/fused_ops.py:121",
    "swiglu": "paddle_tpu/ops/pallas/fused_ops.py:164",
    "swiglu_bwd": "paddle_tpu/ops/pallas/fused_ops.py:178",
    # not a Pallas kernel: the jnp attention core XLA compiles
    "paged_attention": "paddle_tpu/ops/paged_attention.py:262",
    # not a Pallas kernel: the int8 cache's dequantization and
    # full-precision overlay (:239-254) before the same core
    "paged_attention_int8": "paddle_tpu/ops/paged_attention.py:239",
    "flash_attention": "paddle_tpu/ops/pallas/flash_attention.py:148",
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:155",
    "kv_ring_write": "paddle_tpu/ops/pallas/decode_attention.py:70",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:279",
    "fused_adamw": "paddle_tpu/ops/pallas/fused_adamw.py:53",
    "int8_matmul": "paddle_tpu/ops/pallas/int8_matmul.py:65",
}
SOURCES = {
    "rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rms_norm_residual": "paddle_tpu_torch/csrc/fused_norm.cu",
    "rope": "paddle_tpu_torch/csrc/fused_ops.cu",
    "rope_ring": "paddle_tpu_torch/csrc/fused_ops.cu",
    "rope_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu": "paddle_tpu_torch/csrc/fused_ops.cu",
    "swiglu_bwd": "paddle_tpu_torch/csrc/fused_ops.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_int8": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
    "decode_attention": "paddle_tpu_torch/csrc/decode_attention.cu",
    "kv_ring_write": "paddle_tpu_torch/csrc/decode_attention.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_adamw": "paddle_tpu_torch/csrc/fused_adamw.cu",
    "int8_matmul": "paddle_tpu_torch/csrc/int8_matmul.cu",
}
# the names of a kernel's outputs, where it has more than one
OUTPUTS = {
    "flash_attention": ("out", "lse"),
    "flash_attention_bwd": ("dq", "dk", "dv"),
    "rms_norm_residual": ("out", "residual"),
    "rope": ("q", "k"),
    "rope_ring": ("q", "k ring", "v ring"),
    "rope_bwd": ("gq", "gk"),
    "swiglu_bwd": ("da", "db"),
    "kv_ring_write": ("k ring", "v ring"),
}
# the kernels each path runs (phase 3 serving, phase 5 generation, phase 7
# training, phase 9 the int8 predictor, phase 11 speculative serving: the
# verify runs the serving trunk at max_q_len spec_k + 1; phase 12 serving
# over the int8 KV cache)
PATHS = {
    "serving": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                "paged_attention"),
    "int8": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
             "paged_attention_int8"),
    "spec": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
             "paged_attention"),
    "generate": ("rms_norm", "rms_norm_residual", "rope", "rope_ring",
                 "swiglu", "flash_attention", "decode_attention"),
    "train": ("rms_norm", "rms_norm_residual", "rope", "rope_bwd", "swiglu",
              "swiglu_bwd", "flash_attention", "flash_attention_bwd",
              "fused_adamw"),
    "predict": ("int8_matmul", "flash_attention"),
    # phase 13: the public block_multihead_attention over bf16 and int8
    # pools (K2's rope, K4 and K4-int8 in their masked instances)
    "blha": ("rope", "paged_attention", "paged_attention_int8"),
    # phase 14: the serving control plane over two engines (the serving
    # path's kernels, driven by ServingFrontend.step)
    "control": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                "paged_attention"),
    # phase 15: the serving fleet, each worker process's own counts
    # (WORKER_EXIT), summed over the surviving workers
    "fleet": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
              "paged_attention"),
    # phase 4's full-width float32 engine over a bfloat16 cache (C12)
    "mixed_cache": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                    "paged_attention"),
    # phase 16: the in-process chaos soaks (their replicas, the spec
    # verify and the soaks' own reference engines; not the kill-frontend
    # child, a process of its own)
    "chaos": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
              "paged_attention"),
    # phase 17: Llama pretraining under O2 bf16 with a GradScaler, a clip
    # and a schedule; under AMP the residual add and the black-listed
    # norm are two ops, so K1's fused residual variant does not run
    "train_amp": ("rms_norm", "rope", "rope_bwd", "swiglu", "swiglu_bwd",
                  "flash_attention", "flash_attention_bwd", "fused_adamw"),
    # phase 18: BERT-base finetune at dropout 0.1: the attention takes the
    # plain path (as the reference's), LayerNorm and gelu are torch ops
    "finetune": ("fused_adamw",),
    # phase 19: the same finetune through hapi.Model.fit, then evaluate and
    # predict in eval mode, where the attention runs B1
    "fit": ("fused_adamw", "flash_attention"),
    # phase 20: phase 7's Llama under Lamb (its plain update: no B9)
    "optimizers": ("rms_norm", "rms_norm_residual", "rope", "rope_bwd",
                   "swiglu", "swiglu_bwd", "flash_attention",
                   "flash_attention_bwd"),
    # phase 21: GPT-3 1.3B pretraining under O2 bf16 (its LayerNorm and
    # gelu are torch ops) and generate over growing caches
    "gpt": ("flash_attention", "flash_attention_bwd", "fused_adamw"),
    # phase 23: the Transformer base, trained at dropout 0.1 (the plain
    # attention) and decoded over gen_cache's caches (B1)
    "decoder": ("flash_attention", "fused_adamw"),
    # phase 24: the jit.save artifacts served by Config(path) Predictors
    # (BERT-base float and int8, a 2-layer 7B-width Llama): the kernels
    # as custom ops inside torch.export programs
    "deploy": ("rms_norm", "rms_norm_residual", "rope", "swiglu",
               "flash_attention", "int8_matmul"),
    # phase 25: static Programs replayed by the Executor: a 2-layer
    # 7B-width Llama's forward (a CUDA graph) and bench.py's Llama trained
    # through AdamW.minimize (the kernel ops' registered backwards, B9)
    "static": ("rms_norm", "rms_norm_residual", "rope", "rope_bwd",
               "swiglu", "swiglu_bwd", "flash_attention",
               "flash_attention_bwd", "fused_adamw"),
}
# phase 2's head dims beyond the tensor-core classes (72, 100, 264, 512)
# and past 512 (the wide instances, Queue C8)
HEAD_DIMS = (72, 100, 264, 512, 516, 640, 1024)
# the serving engine at full width (phases 3 and 11), and phase 11's and
# phase 4's speculation depth
SERVE_KW = dict(max_batch_size=8, max_seq_len=512, block_size=16,
                token_budget=256)
SPEC_K = 8
# bench_ladder.py's BERT-base classifier, accelerator branch (:103)
BERT = dict(vocab=30522, hidden=768, layers=12, heads=12, seq=128, batch=32)


def _phase(name):
    print(f"== phase {name}", flush=True)
    return time.perf_counter()


def _done(name, t0):
    print(f"phase {name} seconds: {time.perf_counter() - t0:.3f}", flush=True)


# --------------------------------------------------------------- phase 1
def environment(torch):
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, need (9, 0)")
    from paddle_tpu_torch.ops.hopper import _build

    t = time.perf_counter()
    _build.build(force=True, verbose=True)
    _build.lib()
    print(f"build seconds: {time.perf_counter() - t:.3f}")
    _sass_check(_build.LIB_PATH)
    return card


# bf16 B1, B8 and B7 run on the tensor cores: every instance of these
# kernels must hold warpgroup MMA instructions (HGMMA) in its SASS; bf16 B2
# and K4-int8's tensor-core instance run mma.sync, whose instructions are
# HMMA (the tags match by substring: "int8_tc_kernel" is B7's)
TENSOR_CORE_KERNELS = {"flash_fwd_tc_kernel": "HGMMA",
                       "flash_bwd_tc_kernel": "HGMMA",
                       "decode_tc_kernel": "HMMA",
                       "int8_tc_kernel": "HGMMA",
                       "paged_attention_int8_mma_kernel": "HMMA"}


def _sass_check(lib_path):
    """cuobjdump -sass of the built library: count tensor-core instructions
    per function; raise unless every instance of the bf16 B1, B8 and B7
    kernels has HGMMA and every instance of bf16 B2 and of K4-int8's
    tensor-core kernel has HMMA."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur is not None:
            for op in counts[cur]:   # "HGMMA" does not hold "HMMA"
                counts[cur][op] += op in line
    for tag, op in TENSOR_CORE_KERNELS.items():
        found = {f: n[op] for f, n in counts.items() if tag in f}
        print(f"sass {tag}: {len(found)} instances, {op} per instance "
              f"{sorted(found.values())}")
        if not found or min(found.values()) == 0:
            raise AssertionError(f"no {op} in the SASS of {tag}: {found}")


# --------------------------------------------------------------- phase 2
class Timer:
    """Mean CUDA-event time of fn over ``iters`` launches, each after a
    write of 1 GB that evicts the 50 MB L2 (the serving path meets its
    inputs cold) and keeps the card busy for ~0.3 ms, long enough for the
    host to enqueue fn, so the events time the device work alone."""

    def __init__(self, torch, iters):
        self.torch, self.iters = torch, iters
        self.flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / self.iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _err(torch, got, ref):
    if isinstance(got, tuple):
        return max(_err(torch, g, r) for g, r in zip(got, ref))
    return float((got.float() - ref.float()).abs().max())


def _scale(ref):
    if isinstance(ref, tuple):
        return max(_scale(r) for r in ref)
    return float(ref.float().abs().max())


def _tol(dtype_name, ref):
    # bfloat16: both sides round one float32 result to bf16 (8 mantissa
    # bits), so they differ by at most ~2 ulp of the largest output;
    # float32: summation order and rsqrt/exp/sigmoid approximations
    rel = 1.6e-2 if dtype_name == "bfloat16" else 1e-4
    return rel * _scale(ref) + 1e-5


def kernel_cases(torch, dtype):
    """(name, shape label, kernel fn, plain fn, library fn | None, bytes,
    ops[, check fn -> (kernel result, plain result)]) at the shapes the
    serving, generation and training paths give each kernel."""
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    dev = "cuda"
    es = torch.tensor([], dtype=dtype).element_size()
    F = torch.nn.functional

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device=dev, dtype=dt)

    cases = []
    # K1 at prefill's and decode's rows, then widths past the registers of
    # one block (16384 was refused before), and a view at an odd storage
    # offset (no 16-byte packs: the scalar body)
    for n, H, odd in ((256, 4096, False), (8, 4096, False),
                      (1, 16384, False), (4, 16384, False),
                      (2, 32768, False), (256, 4096, True)):
        if odd:
            x, r = (rnd(n * H + 1)[1:].view(n, H) for _ in range(2))
        else:
            x, r = rnd(n, H), rnd(n, H)
        w = rnd(H)
        label = f"[{n}, {H}]" + (" at an odd storage offset" if odd else "")
        _K1_PLANS[(label, str(dtype).split(".")[1])] = (
            fused_norm.rms_plan(n, H, dtype, not odd), (x, r, w))
        cases.append((
            "rms_norm", label,
            lambda x=x, w=w: fused_norm.rms_norm_fused(x, w, 1e-6),
            lambda x=x, w=w: fused_norm._ref_rms(x, w, 1e-6),
            lambda x=x, w=w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
            (2 * n * H + H) * es, 4 * n * H))
        cases.append((
            "rms_norm_residual", label,
            lambda x=x, r=r, w=w: fused_norm.rms_norm_residual_fused(
                x, r, w, 1e-6),
            lambda x=x, r=r, w=w: fused_norm._ref_rms_residual(x, r, w, 1e-6),
            None, (4 * n * H + H) * es, 5 * n * H))
    # rope over the q and k columns of a packed qkv buffer, per-token rows;
    # the 7B heads (32/32), then a GQA split (32/8)
    T, Hq, D = 256, 32, 128
    pos = torch.randint(0, 512, (T,), generator=g, device=dev)
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = pos[:, None].double() * inv[None, :].double()
    cos, sin = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for Tn, Hk in ((T, Hq), (T, 8), (8, Hq)):
        qkv = rnd(Tn, (Hq + 2 * Hk) * D)
        q = qkv[:, :Hq * D].view(1, Tn, Hq, D)
        k = qkv[:, Hq * D:(Hq + Hk) * D].view(1, Tn, Hk, D)
        cs, sn = cos[:Tn], sin[:Tn]
        label = (f"q [1, {Tn}, {Hq}, {D}], k [1, {Tn}, {Hk}, {D}]"
                 + (" (a decode step)" if Tn == 8 else ""))
        _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
            1, Tn, Hq, Hk, D, dtype, True)
        cases.append((
            "rope", label,
            lambda q=q, k=k, c=cs, s=sn: fused_ops.rope_fused(q, k, c, s),
            lambda q=q, k=k, c=cs, s=sn: fused_ops._rope_ref(q, k, c, s),
            None, 2 * Tn * (Hq + Hk) * D * es + 2 * Tn * (D // 2) * 4,
            6 * Tn * (Hq + Hk) * D // 2))
    # K2's interleaved pairs (blha_attention's use_neox_style=False) at the
    # serving step's [1, 256] packed rows
    qkv = rnd(T, 3 * Hq * D)
    q = qkv[:, :Hq * D].view(1, T, Hq, D)
    k = qkv[:, Hq * D:2 * Hq * D].view(1, T, Hq, D)
    label = f"interleaved q, k [1, {T}, {Hq}, {D}]"
    _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
        1, T, Hq, Hq, D, dtype, True)
    cases.append((
        "rope", label,
        lambda q=q, k=k: fused_ops.rope_fused(q, k, cos, sin,
                                              interleaved=True),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, sin, True),
        None, 4 * T * Hq * D * es + 2 * T * (D // 2) * 4,
        6 * T * 2 * Hq * D // 2))
    # generation's rope: the whole 4096-row table and the ring's pos on the
    # device (greedy_decode's decode step, a 32 / 8 split, and an offset the
    # clamp moves back to Smax - S)
    fr = (torch.arange(4096, device=dev)[:, None].double()
          * inv[None, :].double())
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for B, S, Hk, off in ((8, 1, Hq, 150), (8, 1, 8, 150), (8, 4, Hq, 5000)):
        q, k = rnd(B, S, Hq, D), rnd(B, S, Hk, D)
        o = torch.full((), off, dtype=torch.int32, device=dev)
        label = (f"q [{B}, {S}, {Hq}, {D}], k [{B}, {S}, {Hk}, {D}], "
                 f"device offset {off}"
                 + (" (clamped)" if off > 4096 - S else ""))
        _K2_PLANS[(label, str(dtype).split(".")[1])] = fused_ops.rope_plan(
            B, S, Hq, Hk, D, dtype, True)
        cases.append((
            "rope", label,
            lambda q=q, k=k, o=o: fused_ops.rope_fused(q, k, tc, ts, o),
            lambda q=q, k=k, o=o: fused_ops._rope_ref(
                q, k, *fused_ops._window(tc, ts, q.shape[1], o)), None,
            2 * B * S * (Hq + Hk) * D * es + 2 * S * (D // 2) * 4,
            6 * B * S * (Hq + Hk) * D // 2))
    a, b = rnd(256, 11008), rnd(256, 11008)
    cases.append((
        "swiglu", "[256, 11008]",
        lambda: fused_ops.swiglu_fused(a, b),
        lambda: fused_ops._swiglu_ref(a, b), None,
        3 * a.numel() * es, 5 * a.numel()))
    # K3's scalar tail (numel % 8 = 7 in bf16, 3 in float32) and its scalar
    # body (views at an odd storage offset: no 16-byte alignment)
    a7, b7 = rnd(257, 11007), rnd(257, 11007)
    ao = rnd(256 * 11008 + 1)[1:].view(256, 11008)
    bo = rnd(256 * 11008 + 1)[1:].view(256, 11008)
    for label, x, y in (("[257, 11007], numel % 8 = 7", a7, b7),
                        ("[256, 11008] at an odd storage offset", ao, bo)):
        cases.append((
            "swiglu", label,
            lambda x=x, y=y: fused_ops.swiglu_fused(x, y),
            lambda x=x, y=y: fused_ops._swiglu_ref(x, y), None,
            3 * x.numel() * es, 5 * x.numel()))

    cases += _generation_cases(torch, rnd, es, g, dtype)
    cases += _head_dim_cases(torch, rnd, es, g, dtype)
    cases += _training_cases(torch, rnd, es, g, dtype)
    cases += _predict_cases(torch, rnd, es, dtype)

    # paged attention: pool of 256 blocks of 16, 8 rows of up to 32 blocks
    # (max_seq_len 512); the 7B heads, and a head_dim-256 GQA geometry
    # (bench_ladder.py's 1B serving config has head_dim 256)
    B = 8
    for label, heads, kv_heads, hd, dec, now in (
            ("decode 8 rows, context <= 512", Hq, Hq, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B),
            ("mixed 255 tokens", Hq, Hq, D,
             torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
             [1, 100, 16, 1, 60, 0, 1, 76]),
            ("decode 8 rows, 8 heads / 2 KV, head_dim 256", 8, 2, 256,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B),
            # the former refusal: a 64-head group over one KV head
            ("decode 8 rows, 64 heads / 1 KV", 64, 1, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B)):
        cases.append(_paged_case(torch, rnd, es, g, label, heads, kv_heads,
                                 hd, dec.to(torch.int32), now))
    # the mixed loop's program: T = token_budget 256, max_q_len = the
    # 16-token prefill chunk, decode tokens beside 16-token chunks
    cases.append(_paged_case(
        torch, rnd, es, g, "mixed loop T 256, max_q_len 16", Hq, Hq, D,
        torch.tensor([310, 0, 48, 200, 16, 95, 0, 430], dtype=torch.int32,
                     device=dev), [1, 16, 16, 1, 16, 1, 9, 1], mq=16, T=256))
    # long-context decode: 2 rows of ~4000 visible keys (4096-key pool)
    cases.append(_paged_case(
        torch, rnd, es, g, "decode 2 rows, context ~4000", Hq, Hq, D,
        torch.tensor([3990, 4011], dtype=torch.int32, device=dev), [1, 1],
        P=256, NB=512))
    # the speculative verify (spec_k 8): 8 rows of [last token] + a draft
    # of up to 8 tokens packed into T = 8 * 9, max_q_len 9, context <= 512
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_case(
            torch, rnd, es, g, f"verify 8 rows x 9 tokens, context <= 512, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 503, (B,), generator=g, device=dev).to(
                torch.int32), [9, 9, 5, 9, 1, 9, 3, 9], mq=9, T=8 * 9))
    # the pre-caches (A4b): 64 prefix keys before each row's context of up
    # to 512 at decode, 32 / 32 and 32 / 8 heads (K4-int8's below)
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_case(
            torch, rnd, es, g, f"decode 8 rows, context <= 512, prefix 64, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 511, (B,), generator=g, device=dev).to(
                torch.int32), [1] * B, Lp=64))
    # K4-int8 (the int8 cache): decode over 512-token contexts at 32 / 32
    # and 32 / 8 heads, the single step's mixed batch with an out-of-pool
    # block in a decode row's visible range, and the head dims past the
    # tensor-core classes (8 / 2 heads)
    for label, heads, kv_heads, hd, dec, now, oob in (
            ("decode 8 rows, context <= 512", Hq, Hq, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B,
             False),
            ("decode 8 rows, context <= 512, 32 heads / 8 KV", Hq, 8, D,
             torch.randint(64, 511, (B,), generator=g, device=dev), [1] * B,
             False),
            ("mixed 255 tokens, an out-of-pool block", Hq, Hq, D,
             torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
             [1, 100, 16, 1, 60, 0, 1, 76], True),
            *((f"decode 8 rows, 8 heads / 2 KV, head_dim {d}", 8, 2, d,
               torch.randint(64, 511, (B,), generator=g, device=dev),
               [1] * B, False) for d in (72, 100, 264, 512, 640))):
        cases.append(_paged_int8_case(torch, rnd, es, g, label, heads,
                                      kv_heads, hd, dec.to(torch.int32), now,
                                      oob))
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        cases.append(_paged_int8_case(
            torch, rnd, es, g, f"decode 8 rows, context <= 512, prefix 64, "
            f"{heads} heads / {kv_heads} KV", heads, kv_heads, D,
            torch.randint(64, 511, (B,), generator=g, device=dev).to(
                torch.int32), [1] * B, False, Lp=64))
    # the additive masks (A4b): K4's and K4-int8's masked instances at
    # decode (tgt_mask [8, H, 1, 512]) and at the single step's mixed batch
    # (its prefill rows under mask [8, 1, 256, 512], the others under
    # tgt_mask), 32 / 32 and 32 / 8 heads
    for heads, kv_heads in ((Hq, Hq), (Hq, 8)):
        for what, dec, now in (
                ("decode 8 rows, context <= 512",
                 torch.randint(64, 511, (B,), generator=g, device=dev),
                 [1] * B),
                ("mixed 255 tokens",
                 torch.tensor([300, 0, 200, 450, 0, 0, 20, 64], device=dev),
                 [1, 100, 16, 1, 60, 0, 1, 76])):
            label = f"{what}, masks, {heads} heads / {kv_heads} KV"
            cases.append(_paged_case(torch, rnd, es, g, label, heads,
                                     kv_heads, D, dec.to(torch.int32), now,
                                     masked=True))
            cases.append(_paged_int8_case(torch, rnd, es, g, label, heads,
                                          kv_heads, D, dec.to(torch.int32),
                                          now, False, masked=True))
    return cases


def masked_rows(torch, root):
    """``--masked-rows``: the CUDA-event times (phase 2's timer) of the
    masked K4 and K4-int8 rows of ``kernel_cases`` in bfloat16, for the
    package at ``root`` (its kernels built there on first use)."""
    sys.path.insert(0, os.path.abspath(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.hopper import _build

    t = time.perf_counter()
    _build.lib()
    print(f"masked rows of {os.path.dirname(paddle_tpu_torch.__file__)} "
          f"(build or load {time.perf_counter() - t:.1f} s)")
    timer = Timer(torch, 20)
    for name, label, kern, *_ in kernel_cases(torch, torch.bfloat16):
        if ", masks, " in label:
            print(f"masked row {name} {label}: ms {timer(kern):.4f}",
                  flush=True)
    return 0


def decode_costs(torch, root):
    """``--decode-costs``: what the kernel ops' autograd registration and
    the decode step's one q/k/v product cost, for the package at ``root``
    (its kernels built there on first use); a change and its parent are
    measured in one call.

    (a) Host microseconds a call of the K1, K2, K3 and B1 wrappers, eager,
        at a [1, 16] token batch of Llama-2-7B (bf16): 200 calls back to
        back (the kernels take a few microseconds, so the host's enqueue time
        is what is timed), on inputs without a gradient and with one
        wanted (the forward only).
    (b) The eager no-grad forward of phase 24's 2-layer 7B-width Llama at
        [1, 256]: host ms a call (enqueue time) and ms to its end, and its
        kernel launches.
    (c) Llama-2-7B (bf16, 32 layers): ``greedy_decode`` of [8, 128] over a
        512-row ring, 64 tokens, on graphs (after a call that captures)
        and on the eager loop, and ``generate`` over growing caches, 32
        tokens: ms a token (the call less a one-token call, over the
        tokens after the first), the peak memory of the call above what
        was held before it, and what stays held after it (the rings and,
        from this tree on, the q/k/v concatenations the graphs read)."""
    sys.path.insert(0, os.path.abspath(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.models.generation import generate, greedy_decode
    from paddle_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        llama_7b,
    )
    from paddle_tpu_torch.ops.hopper import _build
    from paddle_tpu_torch.ops.hopper.flash_attention import (
        flash_attention_fwd,
    )
    from paddle_tpu_torch.ops.hopper.fused_norm import rms_norm_fused
    from paddle_tpu_torch.ops.hopper.fused_ops import rope_fused, swiglu_fused

    t = time.perf_counter()
    _build.lib()
    where = os.path.dirname(paddle_tpu_torch.__file__)
    print(f"decode costs of {where} (build or load "
          f"{time.perf_counter() - t:.1f} s)", flush=True)
    out = {"root": where}
    g = torch.Generator(device="cuda")
    g.manual_seed(26)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        return us

    S, E, H, D, F = 16, 4096, 32, 128, 11008
    for grad in (False, True):
        def leaf(*shape, dtype=bf):
            return rnd(*shape, dtype=dtype).requires_grad_(grad)

        x, w = leaf(1, S, E), leaf(E)
        q, k, v = leaf(1, S, H, D), leaf(1, S, H, D), leaf(1, S, H, D)
        cos, sin = rnd(S, D // 2, dtype=torch.float32), rnd(
            S, D // 2, dtype=torch.float32)
        a, b = leaf(1, S, F), leaf(1, S, F)
        row = {"K1 rms_norm": host_us(lambda: rms_norm_fused(x, w)),
               "K2 rope": host_us(lambda: rope_fused(q, k, cos, sin)),
               "K3 swiglu": host_us(lambda: swiglu_fused(a, b)),
               "B1 flash_attention": host_us(
                   lambda: flash_attention_fwd(q, k, v, causal=True))}
        out[f"host_us_a_call{'_grad' if grad else ''}"] = row
        print(f"(a) host us a wrapper call, {'a gradient wanted' if grad else 'no gradient'}: "
              + json.dumps({n: round(u, 2) for n, u in row.items()}),
              flush=True)
        del x, w, q, k, v, a, b

    m = LlamaForCausalLM(LlamaConfig(**{**llama_7b(**DEPLOY_LLAMA).__dict__,
                                        "dtype": "bfloat16"}), seed=25)
    ids = torch.randint(0, m.config.vocab_size, DEPLOY_IDS, generator=g,
                        device="cuda")
    counters = _zero_counters()
    with torch.no_grad():
        m(ids)
        torch.cuda.synchronize()
        before = _launch_snapshot()
        hosts, ends = [], []
        for _ in range(20):
            t = time.perf_counter()
            m(ids)
            hosts.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            ends.append(time.perf_counter() - t)
        n = {k: v // 20 for k, v in _launched_since(before).items() if v}
    del counters
    out["forward"] = {"host_ms": statistics.median(hosts) * 1e3,
                      "end_ms": statistics.median(ends) * 1e3,
                      "launches": n}
    print(f"(b) eager no-grad forward {list(DEPLOY_IDS)}, 2 layers: host "
          f"{out['forward']['host_ms']:.3f} ms, to its end "
          f"{out['forward']['end_ms']:.3f} ms (medians of 20), launches "
          f"{json.dumps(n)}", flush=True)
    del m
    gc.collect()
    torch.cuda.empty_cache()

    model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), seed=0)
    p8 = torch.randint(1, model.config.vocab_size, (8, 128), generator=g,
                       device="cuda")
    p4 = p8[:4]

    def timed(call, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = call(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t, toks

    for label, graphs, call, n in (
            ("greedy_decode graphs", True, lambda n: greedy_decode(
                model, p8, n, max_length=512), 64),
            ("greedy_decode eager", False, lambda n: greedy_decode(
                model, p8, n, max_length=512), 64),
            ("generate growing", False, lambda n: generate(
                model, p4, n), 32)):
        model._graphs = graphs
        gc.collect()
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        if graphs:
            timed(call, 2)    # the key's first call captures
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            full, toks = timed(call, n)
            peak = torch.cuda.max_memory_allocated() - base
            one, _ = timed(call, 1)
            times.append((full - one) / (n - 1) * 1e3)
        held = torch.cuda.memory_allocated() - held0
        out[label] = {"ms_a_token": times, "peak_above_held": peak,
                      "held_after": held}
        print(f"(c) {label} [{p8.shape[0] if 'greedy' in label else 4}, "
              f"128] -> {n} tokens: ms a token "
              f"{[round(x, 4) for x in times]}, peak {peak} bytes above "
              f"what was held, {held} bytes held after the calls", flush=True)
    print(json.dumps(out))
    return 0


def _generation_cases(torch, rnd, es, g, dtype):
    """B1, B2 and B3 at the generation path's shapes (Llama-2-7B heads,
    32 x 128, and a GQA split 32 / 8)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    dev = "cuda"
    cases = []
    # B1: (label, B, Sq, Sk, H, KVH, D, causal, q_off on the device | None)
    for label, B, Sq, Sk, H, KVH, D, causal, off in (
            ("causal [2, 1024, 32, 128]", 2, 1024, 1024, 32, 32, 128, True,
             None),
            ("GQA causal q [1, 512, 32, 128], k/v 8 heads", 1, 512, 512, 32,
             8, 128, True, None),
            ("growing-cache decode Sq 1, Sk 700", 4, 1, 700, 32, 32, 128,
             True, None),
            ("static prefill Sq 128 over a 512-row ring, q_off 0", 8, 128,
             512, 32, 32, 128, True, 0),
            ("static prefill Sq 128 over a 512-row ring, q_off 200", 8, 128,
             512, 32, 32, 128, True, 200),
            ("non-causal [1, 256, 8, 64]", 1, 256, 256, 8, 8, 64, False,
             None),
            ("causal head_dim 256 [1, 256, 8, 256]", 1, 256, 256, 8, 8, 256,
             True, None),
            ("causal Sq 96 > Sk 64: rows 0-31 see no key", 1, 96, 64, 8, 8,
             128, True, None),
            # GPT-3 1.3B (phase 21): training's forward, and a cached
            # decode step of generate's 8 prompts at its last key count
            ("GPT causal [4, 2048, 16, 128]", 4, 2048, 2048, 16, 16, 128,
             True, None),
            ("GPT decode Sq 1, Sk 160 [8, 1, 16, 128]", 8, 1, 160, 16, 16,
             128, True, None),
            # the Transformer base's cached decode (phase 23): one query
            # over the self-attention's 64 keys and the memory's 128
            ("decoder step non-causal [32, 1, 8, 64], Sk 64", 32, 1, 64, 8,
             8, 64, False, None),
            ("decoder step non-causal [32, 1, 8, 64], Sk 128", 32, 1, 128, 8,
             8, 64, False, None)):
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
        off_t = (None if off is None else
                 torch.full((), off, dtype=torch.int32, device=dev))
        off_i = Sk - Sq if off is None else off
        scale = 1.0 / D ** 0.5
        # visible (row, key) pairs: the bytes and operations this run needs
        vis = (sum(min(Sk, max(0, i + off_i + 1)) for i in range(Sq))
               if causal else Sq * Sk)
        nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * es \
            + B * H * Sq * 4
        # rows that see no key have lse -1e30 on both sides: compare the
        # outputs alone there, or the tolerance would scale with 1e30
        pick = (lambda r: r[0]) if Sq > Sk else (lambda r: r)
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal, o=off_t, p=pick: p(
                fa.flash_attention_fused(q, k, v, c, None, o)),
            lambda q=q, k=k, v=v, c=causal, o=off_t, s=scale, p=pick: p(
                fa._plain_bshd(q, k, v, c, s, o)),
            _sdpa_b1(torch, q, k, v, causal, off_i), nbytes,
            4 * B * H * vis * D))
    # B2: one token per row against the ring, cols <= pos; greedy_decode's
    # shape (phase 5: 8 rows, 512-row ring, positions 128-160) and a single
    # user's long GQA generation (8 (row, KV head) pairs)
    for label, B, L, H, KVH, D, pos in (
            ("[8, L=512, 32, 128] pos 300", 8, 512, 32, 32, 128, 300),
            ("[8, L=4096, 32, 128] pos 4000", 8, 4096, 32, 32, 128, 4000),
            ("GQA 32 / 8 [8, L=512] pos 300", 8, 512, 32, 8, 128, 300),
            ("greedy_decode [8, L=512, 32, 128] pos 150", 8, 512, 32, 32,
             128, 150),
            ("GQA 32 / 8 [1, L=4096] pos 4000", 1, 4096, 32, 8, 128, 4000)):
        q, kb, vb = rnd(B, 1, H, D), rnd(B, L, KVH, D), rnd(B, L, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        _B2_PLANS[(label, str(dtype).split(".")[1])] = (
            da.decode_plan(B, L, H, KVH, D, dtype), (q, kb, vb, p))
        cases.append((
            "decode_attention", label,
            lambda q=q, kb=kb, vb=vb, p=p: da.decode_attention(q, kb, vb, p),
            lambda q=q, kb=kb, vb=vb, p=p: da.ref_decode_attention(
                q, kb, vb, p),
            _sdpa_b2(torch, q, kb, vb, pos),
            (2 * B * H * D + 2 * B * (pos + 1) * KVH * D) * es,
            4 * B * H * (pos + 1) * D))
    # B3: rows written into [8, 512, 32, 128] rings in place; at -3 the
    # start counts from the end (C7: row 509)
    for label, S, pos in (("1 row into [8, 512, 32, 128] at 300", 1, 300),
                          ("128 rows into [8, 512, 32, 128] at 200", 128,
                           200),
                          ("1 row into [8, 512, 32, 128] at -3 (row 509)",
                           1, -3)):
        cases.append(_b3_case(torch, rnd, es, label, 8, 512, 32, 128, S,
                              pos))
    # K2's ring mode (B3 folded in): greedy_decode's decode step and its
    # [8, 128] prefill over 512-row rings, a 32 / 8 split
    for label, S, Hk, pos in (
            ("greedy_decode step [8, 1, 32 / 32, 128] into [8, 512] rings "
             "at pos 150", 1, 32, 150),
            ("greedy_decode step [8, 1, 32 / 8, 128] into [8, 512] rings "
             "at pos 150", 1, 8, 150),
            ("prefill [8, 128, 32 / 32, 128] into [8, 512] rings at pos 0",
             128, 32, 0)):
        cases.append(_ring_case(torch, rnd, es, dtype, label, 8, S, 32, Hk,
                                128, 512, pos))
    return cases


def _b3_case(torch, rnd, es, label, B, L, KVH, D, S, pos):
    """One B3 case: the rings the kernel writes equal, bit for bit, the
    plain version's and those of index_copy_ at dynamic_update_slice's
    start (a negative pos counted from the end, then clamped to [0, L - S];
    the library call, timed)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    kb, vb = rnd(B, L, KVH, D), rnd(B, L, KVH, D)
    (k1, v1), (k2, v2), (k3, v3) = ((kb.clone(), vb.clone())
                                    for _ in range(3))
    kn, vn = rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    p = torch.full((), pos, dtype=torch.int32, device="cuda")
    start = max(0, min(pos + L if pos < 0 else pos, L - S))
    rows = torch.arange(start, start + S, device="cuda")

    def kern():
        return da.kv_ring_write(k1, v1, kn, vn, p)

    def plain():
        return da._ref_ring_write(k2, v2, kn, vn, p)

    def lib():
        return k3.index_copy_(1, rows, kn), v3.index_copy_(1, rows, vn)

    def check():
        got, ref, dus = kern(), plain(), lib()
        torch.cuda.synchronize()
        parts = [(f"{n} ring{w}", _err(torch, a, b), 0.0)
                 for w, pair in (("", ref), (" vs the start's rows", dus))
                 for n, a, b in zip("kv", got, pair)]
        return max(e for _, e, _ in parts), parts

    return ("kv_ring_write", label, kern, plain, lib,
            4 * B * S * KVH * D * es, 0, check)


def _ring_case(torch, rnd, es, dtype, label, B, S, H, KVH, D, L, pos,
               smax=4096):
    """One case of K2's ring mode: q rotated, k rotated into kbuf and v
    copied into vbuf at the ring rows of the device's pos, one launch.
    Held to the plain composition (_rope_ref then _ref_ring_write, the
    `_tol` of phase 2 for each output) and, bit for bit, to the two
    launches it replaces (rope_fused then kv_ring_write); no one PyTorch
    call computes it."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import fused_ops as fo

    dname = str(dtype).split(".")[1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device="cuda") / D))
    fr = (torch.arange(smax, device="cuda")[:, None].double()
          * inv[None, :].double())
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
    kb, vb = rnd(B, L, KVH, D), rnd(B, L, KVH, D)
    (k1, v1), (k2, v2), (k3, v3) = ((kb.clone(), vb.clone())
                                    for _ in range(3))
    p = torch.full((), pos, dtype=torch.int32, device="cuda")
    _K2_PLANS[(label, dname)] = fo.rope_plan(B, S, H, 2 * KVH, D, dtype,
                                             True)

    def kern():
        return fo.rope_ring_fused(q, k, v, tc, ts, k1, v1, p), k1, v1

    def plain():
        qr, kr = fo._rope_ref(q, k, *fo._window(tc, ts, S, p))
        da._ref_ring_write(k2, v2, kr, v, p)
        return qr, k2, v2

    def two_launches():
        qr, kr = fo.rope_fused(q, k, tc, ts, p)
        da.kv_ring_write(k3, v3, kr, v, p)
        return qr, k3, v3

    def check():
        got, ref, two = kern(), plain(), two_launches()
        torch.cuda.synchronize()
        parts = [(n, _err(torch, a, b), _tol(dname, b))
                 for n, a, b in zip(OUTPUTS["rope_ring"], got, ref)]
        parts.append(("elements off rope_fused + kv_ring_write", float(sum(
            int((a != b).sum()) for a, b in zip(got, two))), 0.0))
        return max(e for _, e, _ in parts[:3]), parts

    return ("rope_ring", label, kern, plain, None,
            (2 * B * S * (H + 2 * KVH) * D * es + 2 * S * (D // 2) * 4),
            6 * B * S * (H + KVH) * D // 2, check)


def _head_dim_cases(torch, rnd, es, g, dtype):
    """B1, B8, B2, B3, K4 and K2's ring mode at head dims 72 (a multiple of
    8: the tensor-core classes zero-padded), 100 (not one of 8: B1/B8 pad
    in the wrapper, the others read rows in pieces), 264 and 512 (past the
    tensor-core tiles: the SIMT instances), 516, 640 and 1024 (past 512:
    the wide instances, Queue C8), at 8 / 2 heads; SDPA at the same shape
    as the library call."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    dev = "cuda"
    cases = []
    dname = str(dtype).split(".")[1]
    for D in HEAD_DIMS:
        B, S, H, KVH = 2, 512, 8, 2
        q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
        scale = 1.0 / D ** 0.5
        vis = S * (S + 1) // 2
        label = f"causal head_dim {D} [{B}, {S}, {H} / {KVH}, {D}]"
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v: fa.flash_attention_fused(q, k, v, True),
            lambda q=q, k=k, v=v, s=scale: fa._plain_bshd(q, k, v, True, s,
                                                          None),
            _sdpa_b1(torch, q, k, v, True, 0),
            (2 * B * S * H * D + 2 * B * S * KVH * D) * es + B * H * S * 4,
            4 * B * H * vis * D))
        o, lse = fa.flash_attention_fused(q, k, v, True)
        go = rnd(B, S, H, D)
        cases.append((
            "flash_attention_bwd", label,
            lambda q=q, k=k, v=v, o=o, l=lse, go=go:
                fa.flash_attention_bwd_fused(q, k, v, o, l, go, True),
            lambda q=q, k=k, v=v, o=o, l=lse, go=go, s=scale:
                fa._plain_bwd_bshd(q, k, v, o, l, go, True, s),
            _sdpa_b8(torch, q, k, v, go, True),
            (4 * B * S * H * D + 4 * B * S * KVH * D) * es + B * H * S * 4,
            10 * B * H * vis * D))
        Bd, L, pos = 8, 512, 300
        q1, kb, vb = rnd(Bd, 1, H, D), rnd(Bd, L, KVH, D), rnd(Bd, L, KVH, D)
        p = torch.full((), pos, dtype=torch.int32, device=dev)
        label = f"head_dim {D} [{Bd}, L={L}, {H} / {KVH}, {D}] pos {pos}"
        _B2_PLANS[(label, dname)] = (
            da.decode_plan(Bd, L, H, KVH, D, dtype), (q1, kb, vb, p))
        cases.append((
            "decode_attention", label,
            lambda q=q1, kb=kb, vb=vb, p=p: da.decode_attention(q, kb, vb, p),
            lambda q=q1, kb=kb, vb=vb, p=p: da.ref_decode_attention(
                q, kb, vb, p),
            _sdpa_b2(torch, q1, kb, vb, pos),
            (2 * Bd * H * D + 2 * Bd * (pos + 1) * KVH * D) * es,
            4 * Bd * H * (pos + 1) * D))
        cases.append(_b3_case(
            torch, rnd, es, f"1 row into [8, 512, 8, {D}] at -3 (row 509)",
            8, 512, 8, D, 1, -3))
        cases.append(_paged_case(
            torch, rnd, es, g, f"decode 8 rows, 8 heads / 2 KV, head_dim {D}",
            H, KVH, D, torch.randint(64, 511, (8,), generator=g,
                                     device=dev).to(torch.int32), [1] * 8))
        cases.append(_ring_case(
            torch, rnd, es, dtype,
            f"[8, 1, 8 / 2, {D}] into [8, 512] rings at pos -3 (row 509)", 8,
            1, H, KVH, D, 512, -3))
    return cases


def _training_cases(torch, rnd, es, g, dtype):
    """The training path's kernels at its shapes (bench.py's honest
    geometry: batch 8 x seq 2048, hidden 2560, 20 heads of 128,
    intermediate 8192): K1-K3 and B1 forward, the rope backward (K2 with
    -sin), B6b, B8 and B9."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    dev = "cuda"
    N, E, I, S, H, D = 8 * 2048, 2560, 8192, 2048, 20, 128
    cases = []
    x, r, w = rnd(N, E), rnd(N, E), rnd(E)
    dname = str(dtype).split(".")[1]
    _K1_PLANS[(f"train [{N}, {E}]", dname)] = (
        fused_norm.rms_plan(N, E, dtype, True), (x, r, w))
    cases.append((
        "rms_norm_residual", f"train [{N}, {E}]",
        lambda x=x, r=r, w=w: fused_norm.rms_norm_residual_fused(
            x, r, w, 1e-6),
        lambda x=x, r=r, w=w: fused_norm._ref_rms_residual(x, r, w, 1e-6),
        None, (4 * N * E + E) * es, 5 * N * E))
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = torch.arange(S, device=dev)[:, None].double() * inv[None].double()
    cos, sin = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    q, k = rnd(8, S, H, D), rnd(8, S, H, D)
    for label in (f"train q, k [8, {S}, {H}, {D}]",
                  f"train gq, gk [8, {S}, {H}, {D}]"):
        _K2_PLANS[(label, dname)] = fused_ops.rope_plan(8, S, H, H, D,
                                                        dtype, True)
    rope_bytes = 4 * 8 * S * H * D * es + 2 * S * (D // 2) * 4
    cases.append((
        "rope", f"train q, k [8, {S}, {H}, {D}]",
        lambda q=q, k=k: fused_ops.rope_fused(q, k, cos, sin),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, sin), None,
        rope_bytes, 6 * 8 * S * 2 * H * D // 2))
    cases.append((
        "rope_bwd", f"train gq, gk [8, {S}, {H}, {D}]",
        lambda q=q, k=k: fused_ops.rope_bwd_fused(q, k, cos, sin),
        lambda q=q, k=k: fused_ops._rope_ref(q, k, cos, -sin), None,
        rope_bytes, 6 * 8 * S * 2 * H * D // 2))
    a, b, gg = rnd(N, I), rnd(N, I), rnd(N, I)
    cases.append((
        "swiglu", f"train [{N}, {I}]",
        lambda a=a, b=b: fused_ops.swiglu_fused(a, b),
        lambda a=a, b=b: fused_ops._swiglu_ref(a, b), None,
        3 * a.numel() * es, 5 * a.numel()))
    cases.append((
        "swiglu_bwd", f"[{N}, {I}]",
        lambda a=a, b=b, g=gg: fused_ops.swiglu_bwd_fused(a, b, g),
        lambda a=a, b=b, g=gg: fused_ops._swiglu_bwd_ref(a, b, g), None,
        5 * a.numel() * es, 12 * a.numel()))
    # B1 and B8: (label, B, Sq, Sk, H, KVH, D, causal)
    for label, B, Sq, Sk, Hq, KVH, Dh, causal in (
            (f"causal [8, {S}, {H}, {D}]", 8, S, S, H, H, D, True),
            ("GQA causal q [1, 512, 32, 128], k/v 8 heads", 1, 512, 512, 32,
             8, 128, True),
            ("causal Sq 256 < Sk 512 [2, 8 heads, 128]", 2, 256, 512, 8, 8,
             128, True),
            ("non-causal [1, 256, 8, 64]", 1, 256, 256, 8, 8, 64, False),
            (f"causal head_dim 256 [8, {S}, 10, 256] (bench.py headline)", 8,
             S, S, 10, 10, 256, True),
            ("causal Sq 96 > Sk 64: rows 0-31 see no key", 1, 96, 64, 8, 8,
             128, True),
            ("GPT causal [4, 2048, 16, 128] (phase 21)", 4, 2048, 2048, 16,
             16, 128, True)):
        q, kk, v = rnd(B, Sq, Hq, Dh), rnd(B, Sk, KVH, Dh), rnd(B, Sk, KVH,
                                                                Dh)
        scale = 1.0 / Dh ** 0.5
        off = Sk - Sq
        vis = (sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))
               if causal else Sq * Sk)
        if label.startswith("causal [") or "head_dim 256" in label:
            cases.append((
                "flash_attention", f"train {label}",
                lambda q=q, k=kk, v=v: fa.flash_attention_fused(
                    q, k, v, True),
                lambda q=q, k=kk, v=v, s=scale: fa._plain_bshd(
                    q, k, v, True, s, None),
                _sdpa_b1(torch, q, kk, v, True, 0),
                (2 * B * Sq * Hq * Dh + 2 * B * Sk * KVH * Dh) * es
                + B * Hq * Sq * 4, 4 * B * Hq * vis * Dh))
        o, lse = fa.flash_attention_fused(q, kk, v, causal)
        go = rnd(B, Sq, Hq, Dh)
        cases.append((
            "flash_attention_bwd", label,
            lambda q=q, k=kk, v=v, o=o, l=lse, go=go, c=causal:
                fa.flash_attention_bwd_fused(q, k, v, o, l, go, c),
            lambda q=q, k=kk, v=v, o=o, l=lse, go=go, c=causal, s=scale:
                fa._plain_bwd_bshd(q, k, v, o, l, go, c, s),
            _sdpa_b8(torch, q, kk, v, go, causal),
            # q, k, v, o, dO and lse read once; dq, dk, dv written once
            (4 * B * Sq * Hq * Dh + 4 * B * Sk * KVH * Dh) * es
            + B * Hq * Sq * 4,
            # S, dP, dQ, dK, dV: 10 D per visible pair
            10 * B * Hq * vis * Dh))
    cases += [_adamw_case(torch, rnd, es, dtype, shape)
              for shape in ((2560, 8192), (2560,))]
    # a TrainStep's clip scale and skip flag on the device (A7b)
    cases += [_adamw_case(torch, rnd, es, dtype, (2560, 8192), mode)
              for mode in ("gmul", "skip")]
    return cases


def _predict_cases(torch, rnd, es, dtype):
    """B7 at the int8 predictor's shapes (BERT-base at [32, 128]: 4096
    token rows, hidden 768, FFN 3072, the 2-way head on the strided first
    token), an odd shape, and one decode-sized case off the path; B1
    non-causal at the classifier's heads."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    from paddle_tpu_torch.quantization import weight_quantize

    T, E, I, S, H = (BERT["batch"] * BERT["seq"], BERT["hidden"],
                     4 * BERT["hidden"], BERT["seq"], BERT["heads"])
    cases = []
    dname = str(dtype).split(".")[1]
    for label, x, K, N, bias in (
            (f"q/k/v/out [{T}, {E}] x [{E}, {E}]", rnd(T, E), E, E, False),
            (f"q/k/v/out [{T}, {E}] x [{E}, {E}] + bias", rnd(T, E), E, E,
             True),
            (f"linear1 [{T}, {E}] x [{E}, {I}]", rnd(T, E), E, I, False),
            (f"linear1 [{T}, {E}] x [{E}, {I}] + bias", rnd(T, E), E, I,
             True),
            (f"linear2 [{T}, {I}] x [{I}, {E}]", rnd(T, I), I, E, False),
            (f"head x[:, 0] [{BERT['batch']}, {E}] x [{E}, 2], rows "
             f"{S * E} apart", rnd(BERT["batch"], S, E)[:, 0], E, 2, False),
            (f"head x[:, 0] [{BERT['batch']}, {E}] x [{E}, 2], rows "
             f"{S * E} apart + bias", rnd(BERT["batch"], S, E)[:, 0], E, 2,
             True),
            ("odd [3, 100] x [100, 130]", rnd(3, 100), 100, 130, False),
            ("odd, 16-byte copies with tails: [64, 100 of 104] x [100, 144]",
             rnd(64, 104)[:, :100], 100, 144, False),
            ("off the path: decode-sized [8, 4096] x [4096, 11008]",
             rnd(8, 4096), 4096, 11008, False)):
        qw, sc = weight_quantize(rnd(K, N, dt=torch.float32) * 0.05)
        b = rnd(N) if bias else None
        M = x.shape[0]
        w = qw.to(dtype) * sc.to(dtype)
        _B7_PLANS[(label, dname)] = (im.int8_plan(M, N, K, dtype),
                                     (x, qw, sc, b), lambda x=x, w=w: x @ w)
        cases.append((
            "int8_matmul", label,
            lambda x=x, qw=qw, sc=sc, b=b: im.int8_linear(x, qw, sc, b),
            lambda x=x, qw=qw, sc=sc, b=b: im._int8_matmul_ref(x, qw, sc, b),
            None if bias else _int8pack_lib(torch, x, qw, sc),
            # x, qw, scale (and bias) read once, out written once
            M * K * es + K * N + 4 * N + M * N * es + (N * es if bias else 0),
            2 * M * N * K))
    B, D = BERT["batch"], E // H
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    cases.append((
        "flash_attention", f"predict non-causal [{B}, {S}, {H}, {D}]",
        lambda: fa.flash_attention_fused(q, k, v, False),
        lambda: fa._plain_bshd(q, k, v, False, 1.0 / D ** 0.5, None),
        _sdpa_b1(torch, q, k, v, False, 0),
        4 * B * S * H * D * es + B * H * S * 4, 4 * B * H * S * S * D))
    return cases


def _int8pack_lib(torch, x, qw, scale):
    """torch._weight_int8pack_mm (weight [N, K], scales in x's dtype) on
    copies made here, or None where this PyTorch has no CUDA version."""
    xc, wt, sc = x.contiguous(), qw.t().contiguous(), scale.to(x.dtype)
    try:
        got = torch._weight_int8pack_mm(xc, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        print(f"library torch._weight_int8pack_mm: none ({str(e)[:120]})")
        return None
    ref = ((xc.float() @ qw.float()) * scale).to(x.dtype)
    print(f"library torch._weight_int8pack_mm {tuple(xc.shape)} x "
          f"{tuple(qw.shape)}: max abs diff from the plain version "
          f"{float((got.float() - ref.float()).abs().max()):.3e}")
    return lambda: torch._weight_int8pack_mm(xc, wt, sc)


def _sdpa_b8(torch, q, k, v, go, causal):
    """The backward of F.scaled_dot_product_attention alone: its forward
    runs here, once, and each call is torch.autograd.grad of that output
    (graph retained) on [B, H, S, D] copies; causal with Sq != Sk takes
    the explicit bottom-right boolean mask (with Sq > Sk its first rows
    see no key: SDPA gives them NaN, which the timing does not read)."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = go.transpose(1, 2).contiguous()
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if causal and Sq != Sk:
        rows = torch.arange(Sq, device=q.device)[:, None] + Sk - Sq
        kw["attn_mask"] = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        kw["is_causal"] = causal
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def _adamw_case(torch, rnd, es, dtype, shape, mode=None):
    """B9 on one parameter (bf16 or f32, the case's type) with float32
    master and moments.  The check runs three steps (t = 1, 2, 3) on the
    kernel and on the plain version from one state, and holds each output
    to its own limit: the master within 1e-3 of the plain version's largest
    change over the steps (a missing or stale step is off by a whole
    change), m and v within 1e-4 of their own largest value, and a bf16
    parameter within one bf16 ulp of its own value everywhere (at least
    the master's limit: near zero that is the larger) and equal to
    the plain rounding in all but 1e-3 of the elements (the two masters may
    straddle a rounding midpoint; a skipped, stale or truncating store
    differs almost everywhere).  The times are of one step.  Library:
    torch.optim.AdamW(fused=True) over the float32 master, which writes no
    low-precision copy.

    ``mode`` "gmul": a TrainStep's controls, a clip scale of 0.3712 (the
    gradient times it rounds in the gradient's type) and a skip flag of 0,
    both one float32 on the device; the bound counts the two scalars too,
    the library call takes ``grad_scale`` = 1 / 0.3712.  ``mode`` "skip":
    the flag set; the check requires the kernel's and the plain version's
    outputs to equal the inputs bit for bit, and AdamW's update of a
    parameter under the flag (``optimizer.Skip``) to leave its step count
    t; the bound counts the flag's 4 bytes, all this run's data needs (the
    kernel returns before its loop); the library call takes
    ``found_inf`` = 1."""
    from paddle_tpu_torch.ops.hopper import fused_adamw as fad

    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    if mode == "gmul":
        kw.update(gmul=torch.full((1,), 0.3712, device="cuda"),
                  skip=torch.zeros(1, device="cuda"))
    elif mode == "skip":
        kw.update(skip=torch.ones(1, device="cuda"))
    w0 = rnd(*shape, dt=torch.float32) * 0.02
    grads = [rnd(*shape) * 0.01 for _ in range(3)]

    def state():
        w = w0.clone()
        p = w.to(dtype) if dtype != torch.float32 else w
        return [p, w, torch.zeros_like(w), torch.zeros_like(w),
                torch.ones(1, device="cuda")]

    def run(fn, st, steps):
        for i in range(steps):
            st[4].fill_(i + 1)
            fn(*st[:4], grads[i], 1e-4, st[4], **kw)
        return tuple(st[:4])

    def check():
        if mode == "skip":
            return _adamw_skip_check(torch, fad, state, run, grads)
        kp, kw, km, kv = run(fad.fused_adamw, state(), 3)
        rp, rw, rm, rv = run(fad._fused_adamw_ref, state(), 3)
        torch.cuda.synchronize()
        parts = [("master", _err(torch, kw, rw),
                  1e-3 * _scale(rw - w0) + 1e-12),
                 ("m", _err(torch, km, rm), 1e-4 * _scale(rm) + 1e-12),
                 ("v", _err(torch, kv, rv), 1e-4 * _scale(rv) + 1e-12)]
        err = max(e for _, e, _ in parts)
        if not own:
            rf, d = rp.float(), (kp.float() - rp.float()).abs()
            # an element's own ulp, but not below the masters' limit: a
            # value near zero rounds a master that may be off by that much
            ulp = torch.exp2(torch.floor(torch.log2(
                rf.abs().clamp_min(2.0 ** -126))) - 7).clamp_min(
                    parts[0][2])
            parts += [("p / own bf16 ulp", float((d / ulp).max()), 1.0),
                      ("p share off the plain rounding",
                       float((d > 0).float().mean()), 1e-3)]
            err = max(err, float(d.max()))
        return err, parts

    ks, ps = state(), state()
    lw = w0.clone().requires_grad_()
    lw.grad = grads[0].float()
    lib = torch.optim.AdamW([lw], lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=True)
    n = w0.numel()
    own = dtype == torch.float32
    # g read, w/m/v read and written, p written (no p: w is p)
    nbytes, ops = n * (es + 24 + (0 if own else es)), 15 * n
    label = f"{list(shape)} x 3 steps"
    if mode == "gmul":
        lib.grad_scale = torch.full((), 1 / 0.3712, device="cuda")
        nbytes, ops, label = nbytes + 8, ops + n, label + ", clip scale"
    elif mode == "skip":
        lib.found_inf = torch.ones((), device="cuda")
        nbytes, ops, label = 4, 0, f"{list(shape)}, skip set"
    return ("fused_adamw", label,
            lambda: fad.fused_adamw(*ks[:4], grads[0], 1e-4, ks[4], **kw),
            lambda: fad._fused_adamw_ref(*ps[:4], grads[0], 1e-4, ps[4],
                                         **kw),
            lib.step, nbytes, ops, check)


def _adamw_skip_check(torch, fad, state, run, grads):
    """Phase 2's B9 row with the skip flag set: three flagged steps on the
    kernel and on the plain version leave the parameter, master and
    moments bit for bit the inputs; then AdamW's update of a parameter
    under ``Skip`` leaves its step count t and its states, and under a
    clear flag advances t by one.  -> (0.0, parts)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.optimizer import Skip

    parts = []
    for label, fn in (("kernel", fad.fused_adamw),
                      ("plain", fad._fused_adamw_ref)):
        st = state()
        before = [x.clone() for x in st[:4]]
        run(fn, st, 3)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(st[:4], before))
        parts.append((f"{label} p/w/m/v changed under skip",
                      0.0 if same else 1.0, 0.0))
    p = torch.nn.Parameter(state()[0].clone())
    opt = AdamW(learning_rate=1e-4, parameters=[p], multi_precision=True)
    opt._ensure_state()
    t0 = opt._beta_pow(p).clone()
    snap = [x.clone() for x in (p.data, opt._master(p),
                                opt._acc("moment1", p))]
    with torch.no_grad():
        opt._apply_update(p, grads[0], 1e-4, 0.0, None,
                          Skip.of(torch.ones((), device="cuda")))
    torch.cuda.synchronize()
    kept = torch.equal(opt._beta_pow(p), t0) and all(
        torch.equal(a, b) for a, b in zip(
            snap, (p.data, opt._master(p), opt._acc("moment1", p))))
    with torch.no_grad():
        opt._apply_update(p, grads[0], 1e-4, 0.0, None,
                          Skip.of(torch.zeros((), device="cuda")))
    moved = float(opt._beta_pow(p)) == float(t0) + 1
    parts.append(("AdamW under skip: t or a state moved, or a clear flag "
                  "did not advance t", 0.0 if kept and moved else 1.0, 0.0))
    return max(v for _, v, _ in parts), parts


def _sdpa_b1(torch, q, k, v, causal, off):
    """F.scaled_dot_product_attention on [B, H, S, D] copies (transposes
    made here, not timed): is_causal when Sq == Sk and the offset is 0,
    else a boolean mask of cols <= row + off."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if causal and not (Sq == Sk and off == 0):
        rows = torch.arange(Sq, device=q.device)[:, None] + off
        kw["attn_mask"] = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def _sdpa_b2(torch, q, kb, vb, pos):
    """SDPA of the [B, H, 1, D] query over ring[:, :pos + 1] (sliced and
    transposed here, not timed)."""
    F = torch.nn.functional
    qt = q.transpose(1, 2).contiguous()
    kt = kb[:, :pos + 1].transpose(1, 2).contiguous()
    vt = vb[:, :pos + 1].transpose(1, 2).contiguous()
    kw = {"enable_gqa": True} if kb.shape[2] != q.shape[2] else {}
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


# K4's plan, arguments and pre-caches for each case, by (label, dtype
# name): the plan is printed beside its time, the arguments serve the
# --k4-sweep
_K4_PLANS = {}
_K4_ARGS = {}
_K4_PRE = {}
# B2's (plan, arguments) for each case, by (label, dtype name): the plan is
# printed beside its time, the arguments serve the --b2-sweep
_B2_PLANS = {}
# B7's (plan, arguments, dense yardstick) for each case, by (label, dtype
# name): the plan and the time of torch.matmul with the dequantized weight
# are printed beside its time, the arguments serve the --b7-sweep
_B7_PLANS = {}
# K1's (plan, arguments) and K2's plan for each case, by (label, dtype
# name): the plan is printed beside its time, K1's arguments serve the
# --k1-sweep
_K1_PLANS = {}
_K2_PLANS = {}


def _serving_masks(torch, g, H, dec, now, mq, L):
    """Additive masks of a serving step (blha_attention's): ``mask`` [B, 1,
    mq, L] on the rows in prefill (seq_lens_encoder = now where dec is 0,
    the rows that start their prompt), ``tgt_mask`` [B, H, 1, L] on the
    others, seeded values in [-2, 0] (a learned or positional bias)."""
    B = now.shape[0]
    dev = now.device
    enc = torch.where(dec == 0, now, 0).to(torch.int32)

    def bias(*shape):
        return -2 * torch.rand(*shape, generator=g, device=dev)

    return dict(mask=bias(B, 1, mq, L), tgt_mask=bias(B, H, 1, L),
                seq_lens_encoder=enc)


def _mask_bytes(masks, dec, live, Lp, ctx):
    """The bytes of the masks a call reads: for each attending token (local
    index s of its row) and each head of the row's mask, its visible keys'
    entries inside the mask (s below its rows, keys below its columns),
    float32."""
    enc = masks["seq_lens_encoder"].tolist()
    n = 0
    for b, (d, t) in enumerate(zip(dec.tolist(), live)):
        m = masks["mask"] if enc[b] > 0 else masks["tgt_mask"]
        if m is None:
            continue
        _, heads, sq, lm = m.shape
        for s in range(min(t, sq)):
            n += heads * min(Lp + min(d + s + 1, ctx), lm)
    return 4 * n


def _paged_case(torch, rnd, es, g, label, H, KV, D, dec, now, mq=None,
                T=None, P=32, NB=256, Lp=0, masked=False):
    """One K4 case: a decode batch (one token per row, T = B), a mixed
    batch in the single-step program's [256] buffer (max_q_len 256), or
    the given ``mq`` and ``T`` (the mixed loop's program); ``Lp`` > 0
    puts pre-caches [B, KV, Lp, D] in front of every row's context;
    ``masked`` adds ``_serving_masks`` (the masked instances)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    bs, B = 16, len(now)
    dev = "cuda"
    kc, vc = rnd(NB, KV, bs, D), rnd(NB, KV, bs, D)
    pre = (dict(pre_key=rnd(B, KV, Lp, D), pre_value=rnd(B, KV, Lp, D))
           if Lp else {})
    bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(B, P).to(
        torch.int32)
    now = torch.tensor(now, dtype=torch.int32, device=dev)
    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(now, 0)
    decode = int(now.max()) == 1
    if mq is None:
        T = int(cu[-1]) if decode else 256
        mq = 1 if decode else 256
    if masked:
        pre.update(_serving_masks(torch, g, H, dec, now, mq, Lp + P * bs))
    q = rnd(T, H, D)
    dname = str(q.dtype).split(".")[1]
    _K4_PLANS[(label, dname)] = pa.paged_plan(T, B, mq, P, bs, H, KV, D,
                                              q.dtype, pre_len=Lp)
    _K4_ARGS[(label, dname)] = (q, kc, vc, dec, now, cu, bt, mq)
    _K4_PRE[(label, dname)] = pre
    # the tokens that attend: a row's first min(now, max_q_len) (the rest,
    # and the padding past cu[B], are written as zeros, their q unread)
    live = [min(n, mq) for n in now.tolist()]
    # bytes: the q of the tokens that attend, the whole output, and each
    # row's visible K/V once, its prefix included (none for a row with no
    # token that attends)
    keys = sum(Lp + min(d + n, P * bs)
               for d, n in zip(dec.tolist(), live) if n)
    nbytes = ((sum(live) + T) * H * D + 2 * keys * KV * D) * es
    if masked:
        nbytes += _mask_bytes(pre, dec, live, Lp, P * bs)
    # QK^T and PV, 2 operations per multiply-add, over each attending
    # token's visible keys (the whole prefix, then its paged keys)
    vis = sum(Lp + min(d + j + 1, P * bs)
              for d, n in zip(dec.tolist(), live) for j in range(n))
    ops = 4 * vis * H * D
    return ("paged_attention", label,
            lambda: pa.paged_attention(q, kc, vc, dec, now, cu, bt, mq,
                                       **pre),
            lambda: pa._paged_attention_ref(q, kc, vc, dec, now, cu, bt, mq,
                                            **pre),
            _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq, **pre),
            nbytes, ops)


# K4-int8's plan, the K4 call over a cache of q's dtype at the same shape
# and the call's arguments (the SIMT instance forced beside the tensor
# cores), for each case, by (label, dtype name): printed
# beside its time
_K4I_PLANS = {}
_K4I_K4 = {}
_K4I_ARGS = {}


def _paged_int8_case(torch, rnd, es, g, label, H, KV, D, dec, now, oob,
                     P=32, NB=256, Lp=0, masked=False):
    """One K4-int8 case over uint8 pools of random codes and random
    per-(row, KV head) scales: a decode batch (T = B) or a mixed batch in
    the single step's [256] buffer (max_q_len 256); ``oob``: row 0's first
    block-table entry, visible, is outside the pool (uint8 0); ``Lp`` > 0
    puts full-precision pre-caches [B, KV, Lp, D] in front of every
    row's context; ``masked`` adds ``_serving_masks``."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    bs, B = 16, len(now)
    dev = "cuda"

    def codes():
        return torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                             device=dev, dtype=torch.uint8)

    kc, vc = codes(), codes()
    bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(B, P).to(
        torch.int32)
    if oob:
        bt[0, 0] = -1
    now = torch.tensor(now, dtype=torch.int32, device=dev)
    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(now, 0)
    decode = int(now.max()) == 1
    T = int(cu[-1]) if decode else 256
    mq = 1 if decode else 256
    q, k, v = rnd(T, H, D), rnd(T, KV, D), rnd(T, KV, D)
    kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    pre = (dict(pre_key=rnd(B, KV, Lp, D), pre_value=rnd(B, KV, Lp, D))
           if Lp else {})
    if masked:
        pre.update(_serving_masks(torch, g, H, dec, now, mq, Lp + P * bs))
    dname = str(q.dtype).split(".")[1]
    _K4I_PLANS[(label, dname)] = pa.paged_int8_plan(T, B, mq, P, bs, H, KV,
                                                    D, q.dtype, pre_len=Lp)
    kcf, vcf = rnd(NB, KV, bs, D), rnd(NB, KV, bs, D)
    _K4I_K4[(label, dname)] = lambda: pa.paged_attention(
        q, kcf, vcf, dec, now, cu, bt, mq, **pre)
    ctx = P * bs
    live = [min(n, mq) for n in now.tolist()]
    rows = [(d, n) for d, n in zip(dec.tolist(), live) if n]
    # bytes: the q of the tokens that attend, the whole output, each row's
    # cached keys and values (one byte an element) and its fresh and
    # prefix ones (of q's dtype) once, the scales; operations: QK^T and PV
    # over each attending token's visible keys, and the dequantization (a
    # subtract and a multiply) of every cached element read
    cached = sum(min(d, ctx) for d, _ in rows)
    fresh = sum(Lp + min(d + n, ctx) - min(d, ctx) for d, n in rows)
    nbytes = ((sum(live) + T) * H * D * es + 2 * cached * KV * D
              + 2 * fresh * KV * D * es + 2 * B * KV * 4)
    if masked:
        nbytes += _mask_bytes(pre, dec, live, Lp, ctx)
    vis = sum(Lp + min(d + j + 1, ctx) for d, n in rows for j in range(n))
    ops = 4 * vis * H * D + 4 * cached * KV * D
    args = (q, k, v, kc, vc, kd, vd, dec, now, cu, bt, mq)
    _K4I_ARGS[(label, dname)] = (args, pre)
    return ("paged_attention_int8", label,
            lambda: pa.paged_attention_int8(*args, **pre),
            lambda: pa._paged_attention_int8_ref(*args, **pre), None, nbytes,
            ops)


def _sdpa_case(torch, q, kc, vc, dec, now, cu, bt, mq, pre_key=None,
               pre_value=None, **masks):
    """F.scaled_dot_product_attention over the gathered, padded context,
    after the pre-caches where given (the library yardstick for K4; timed
    alone, gather and concatenation excluded); with ``masks`` (mask,
    tgt_mask, seq_lens_encoder) a float attn_mask: the masks' term on the
    visible keys, -inf elsewhere (made before the timing)."""
    from paddle_tpu_torch.ops.hopper.paged_attention import (
        _mask_bias,
        paged_gather_kv,
    )

    B = bt.shape[0]
    H, D = q.shape[1], q.shape[2]
    S = int(now.max())
    k_all = paged_gather_kv(kc, bt)              # [B, KV, L, D]
    v_all = paged_gather_kv(vc, bt)
    Lp = 0
    if pre_key is not None:
        Lp = pre_key.shape[2]
        k_all = torch.cat([pre_key, k_all], 2)
        v_all = torch.cat([pre_value, v_all], 2)
    L = k_all.shape[2]
    qp = torch.zeros(B, H, S, D, dtype=q.dtype, device=q.device)
    for b in range(B):
        n = int(now[b])
        if n:
            qp[b, :, :n] = q[int(cu[b]):int(cu[b]) + n].transpose(0, 1)
    qpos = dec.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :] - Lp
            <= qpos[:, :, None])[:, None]        # [B, 1, S, L]
    if masks:
        bias = _mask_bias((masks["mask"], masks["tgt_mask"],
                           masks["seq_lens_encoder"], now), H, S, L)
        mask = torch.where(mask, bias, float("-inf")).to(q.dtype)
    F = torch.nn.functional
    gqa = {"enable_gqa": True} if k_all.shape[1] != H else {}
    return lambda: F.scaled_dot_product_attention(
        qp, k_all, v_all, attn_mask=mask, **gqa)


# Queue C12: K4 over a cache whose dtype is not q's.  (q, cache) dtype
# pairs, and the cases: (label, heads, KV heads, head_dim, dec, now, prefix
# keys, masks), dec None for 8 random decode contexts under 512
MIXED_PAIRS = (("float32", "bfloat16"), ("bfloat16", "float32"))
MIXED_CASES = (
    ("decode 8 rows, context <= 512, 32 heads / 32 KV", 32, 32, 128, None,
     [1] * 8, 0, False),
    ("decode 8 rows, context <= 512, 32 heads / 8 KV", 32, 8, 128, None,
     [1] * 8, 0, False),
    ("mixed 255 tokens (single step), 32 heads / 32 KV", 32, 32, 128,
     [300, 0, 200, 450, 0, 0, 20, 64], [1, 100, 16, 1, 60, 0, 1, 76], 0,
     False),
    ("decode 8 rows, context <= 512, prefix 64, 32 heads / 32 KV", 32, 32,
     128, None, [1] * 8, 64, False),
    ("decode 8 rows, context <= 512, masks, 32 heads / 32 KV", 32, 32, 128,
     None, [1] * 8, 0, True),
    ("decode 8 rows, 8 heads / 2 KV, head_dim 640", 8, 2, 640, None, [1] * 8,
     0, False))


def _mixed_cache_rows(torch, timer):
    """Phase 2's C12 rows: K4 with a float32 q over bfloat16 pools and a
    bfloat16 q over float32 pools (``MIXED_PAIRS``) at ``MIXED_CASES``:
    decode (8 rows, contexts under 512, 32 / 32 and 32 / 8 heads), the
    single step's mixed batch of 255 tokens, a 64-key prefix (in the
    cache's dtype), the masks (``_serving_masks``), head_dim 640 (the wide
    instance).  Each is held to the plain version (``_tol`` of q's dtype)
    under the plan's split and under 1 and 4 splits forced (past 512
    columns: one), a plan with a cluster giving the same bits twice; then
    timed beside the plain version, the float32 K4 over a float32 cache
    at the same shape (q and the pools widened before the timing) and
    SDPA over the context widened to float32; its bound is the bytes at
    each operand's own width over the HBM rate, or its operations at the
    float32 rate.  Returns the kernels line's rows."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(1212)
    dev, bs, B, P, NB = "cuda", 16, 8, 32, 256
    rows = []
    edges = clusters = 0
    for qname, cname in MIXED_PAIRS:
        qdt, cdt = getattr(torch, qname), getattr(torch, cname)
        eq, ec = qdt.itemsize, cdt.itemsize
        for label, H, KV, D, dec, now, Lp, masked in MIXED_CASES:
            def rnd(*shape, dt):
                return torch.randn(*shape, generator=g, device=dev, dtype=dt)

            dec = (torch.randint(64, 511, (B,), generator=g, device=dev)
                   if dec is None else torch.tensor(dec, device=dev)).to(
                       torch.int32)
            now_t = torch.tensor(now, dtype=torch.int32, device=dev)
            cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
            cu[1:] = torch.cumsum(now_t, 0)
            decode = max(now) == 1
            T, mq = (B, 1) if decode else (256, 256)
            kc, vc = rnd(NB, KV, bs, D, dt=cdt), rnd(NB, KV, bs, D, dt=cdt)
            bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
                B, P).to(torch.int32)
            q = rnd(T, H, D, dt=qdt)
            extra = (dict(pre_key=rnd(B, KV, Lp, D, dt=cdt),
                          pre_value=rnd(B, KV, Lp, D, dt=cdt)) if Lp else {})
            if masked:
                extra.update(_serving_masks(torch, g, H, dec, now_t, mq,
                                            Lp + P * bs))
            args = (q, kc, vc, dec, now_t, cu, bt, mq)
            ref = pa._paged_attention_ref(*args, **extra)
            tol = _tol(qname, ref)
            what = f"{qname} q over a {cname} cache, {label}"
            runs = [("plan", lambda: pa.paged_attention(*args, **extra))]
            if D <= pa.MAX_HEAD_DIM:
                runs += [(f"{n} splits forced",
                          lambda n=n: pa._launch(*args, splits=n, **extra))
                         for n in (1, pa.SPLIT_CAP)]
            err = 0.0
            for how, run in runs:
                got = run()
                e = _err(torch, got, ref)
                edges += 1
                if got.dtype != qdt or not e <= tol:
                    raise AssertionError(f"C12 K4 {what}, {how}: {got.dtype}"
                                         f", kernel and plain differ by {e}"
                                         f" > {tol}")
                if not torch.equal(run(), got):
                    raise AssertionError(f"C12 K4 {what}, {how}: two runs "
                                         "differ")
                clusters += how != "plan"
                err = max(err, e)
            wide = {k: (v.float() if k.startswith("pre") else v)
                    for k, v in extra.items()}
            q32, k32, v32 = q.float(), kc.float(), vc.float()
            # q float32 (a bfloat16 q is widened first) over the pools
            plan = pa.paged_plan(T, B, mq, P, bs, H, KV, D, torch.float32,
                                 pre_len=Lp, cache_dtype=cdt)
            live = [min(n, mq) for n in now]
            keys = sum(Lp + min(d + n, P * bs)
                       for d, n in zip(dec.tolist(), live) if n)
            nbytes = (sum(live) + T) * H * D * eq + 2 * keys * KV * D * ec
            if masked:
                nbytes += _mask_bytes(extra, dec, live, Lp, P * bs)
            vis = sum(Lp + min(d + j + 1, P * bs)
                      for d, n in zip(dec.tolist(), live) for j in range(n))
            ops = 4 * vis * H * D
            ms = timer(runs[0][1])
            plain_ms = timer(lambda: pa._paged_attention_ref(*args, **extra))
            f32_ms = timer(lambda: pa.paged_attention(
                q32, k32, v32, dec, now_t, cu, bt, mq, **wide))
            lib_ms = timer(_sdpa_case(torch, q32, k32, v32, dec, now_t, cu,
                                      bt, mq, **wide))
            bound_ms, bound_by = _bound(nbytes, ops, "float32")
            print(f"kernel paged_attention C12 {what}: max_abs_err {err:.3e} "
                  f"tol {tol:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms:.4f} (SDPA over the float32 context)"
                  f" bound_ms {bound_ms:.4f} ({bound_by}) of_bound "
                  f"{bound_ms / ms:.3f}; float32 K4 over a float32 cache "
                  f"{f32_ms:.4f} ms; qt {plan.qt} kt {plan.kt} stages "
                  f"{plan.stages} splits {plan.splits} smem {plan.smem}",
                  flush=True)
            rows.append(dict(
                name="paged_attention", shape=f"C12: {what}", dtype=qname,
                cache_dtype=cname, route="cuda",
                source=SOURCES["paged_attention"],
                replaces=REPLACES["paged_attention"], max_abs_err=err,
                max_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                f32_cache_ms=f32_ms))
    torch.cuda.synchronize()
    print(f"C12 mixed-cache K4: {edges} calls (plans, 1 and 4 splits "
          f"forced; {clusters} forced) agree with the plain versions and "
          "give the same bits twice; no shape refused up to and past "
          "head_dim 512", flush=True)
    return rows


def kernels_vs_plain(torch, iters=20, k4_sweep=False, b2_sweep=False,
                     b7_sweep=False, k1_sweep=False):
    """Check every case in both types; time it; return the rows of the
    kernels line (bfloat16, the type the paths run in).  ``k4_sweep`` also
    times each K4 case under other plans (``_paged_sweep``), ``b2_sweep``
    each B2 case (``_decode_sweep``), ``b7_sweep`` each B7 case
    (``_int8_sweep``), ``k1_sweep`` each K1 case (``_norm_sweep``)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    timer = Timer(torch, iters)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name, label, kern, plain, lib, nbytes, ops, *check in \
                kernel_cases(torch, dtype):
            # a case may bring its own check (several steps from one state,
            # a limit for each output): (max abs error, [(output, value,
            # limit)])
            if check:
                err, parts = check[0]()
            else:
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                err = _err(torch, got, ref)
                # several outputs (B1's out and lse, B8's dq, dk, dv, two
                # rings): each is held to its own scale, so a small output
                # beside a large one gets a limit of its own size
                if isinstance(ref, tuple):
                    names = OUTPUTS.get(name) or [f"output {i}"
                                                  for i in range(len(ref))]
                    parts = [(n, _err(torch, a, b), _tol(dname, b))
                             for n, a, b in zip(names, got, ref)]
                else:
                    parts = [("", err, _tol(dname, ref))]
            tol = (parts[0][2] if len(parts) == 1
                   else {lab: lim for lab, _, lim in parts})
            ms, plain_ms = timer(kern), timer(plain)
            lib_ms = timer(lib) if lib is not None else None
            bound_ms, bound_by = _bound(nbytes, ops, dname)
            limits = " ".join(f"{lab + ' ' if lab else ''}{val:.3e} "
                              f"tol {lim:.3e}" for lab, val, lim in parts)
            print(f"kernel {name} {dname} {label}: max_abs_err {err:.3e} "
                  f"[{limits}] ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" bound_ms {bound_ms:.4f} ({bound_by}) TFLOP/s "
                  f"{ops / ms / 1e9:.1f} of_bound {bound_ms / ms:.3f}",
                  flush=True)
            plan = _K4_PLANS.get((label, dname)) if name == \
                "paged_attention" else None
            if plan is not None:
                print(f"k4 {dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; qt {plan.qt} kt "
                      f"{plan.kt} stages {plan.stages} splits {plan.splits} "
                      f"chunk {plan.chunk} blocks {plan.blocks} smem "
                      f"{plan.smem}", flush=True)
            if name == "paged_attention_int8":
                p8 = _K4I_PLANS[(label, dname)]
                simt = ""
                if p8.tc:   # the SIMT instance forced at the same shape
                    a8, pre8 = _K4I_ARGS[(label, dname)]
                    s_ms = timer(lambda: pa._launch_int8(*a8, tc=False,
                                                         **pre8))
                    simt = (f"; SIMT forced {s_ms:.4f} ms (tensor cores "
                            f"{'faster' if ms < s_ms else 'NOT faster'})")
                print(f"k4-int8 {dname} {label}: {nbytes / ms / 1e6:.1f} "
                      f"GB/s, {bound_ms / ms:.3f} of the bound; "
                      f"{'tensor cores' if p8.tc else 'SIMT'} qt {p8.qt} "
                      f"kt {p8.kt} splits {p8.splits} blocks {p8.blocks} "
                      f"smem {p8.smem}{simt}; K4 over a {dname} cache at the "
                      f"same shape {timer(_K4I_K4[(label, dname)]):.4f} ms "
                      "(informative)", flush=True)
            if name == "int8_matmul":
                b7, _, dense = _B7_PLANS[(label, dname)]
                print(f"b7 {dname} {label}: {ops / ms / 1e9:.1f} TFLOP/s, "
                      f"{bound_ms / ms:.3f} of the bound; kind {b7.kind} "
                      f"tile {b7.tile} rows {b7.rows} splits {b7.splits} "
                      f"blocks {b7.blocks} smem {b7.smem}; dense yardstick "
                      f"torch.matmul with the dequantized {dname} weight "
                      f"{timer(dense):.4f} ms (informative)", flush=True)
            k12 = (_K1_PLANS[(label, dname)][0] if name.startswith("rms")
                   else _K2_PLANS.get((label, dname)))
            if k12 is not None:
                print(f"{'k1' if name.startswith('rms') else 'k2'} {name} "
                      f"{dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; {k12}", flush=True)
            if name == "decode_attention":
                b2 = _B2_PLANS[(label, dname)][0]
                print(f"b2 {dname} {label}: {nbytes / ms / 1e6:.1f} GB/s, "
                      f"{bound_ms / ms:.3f} of the bound; tc {b2.tc} rows "
                      f"{b2.rows} kt {b2.kt} splits {b2.splits} blocks "
                      f"{b2.blocks} smem {b2.smem}", flush=True)
            for lab, val, lim in parts:
                if not val <= lim:
                    raise AssertionError(
                        f"{name} {dname} {label}: kernel and plain differ "
                        f"{'in ' + lab + ' ' if lab else ''}by {val} > {lim}")
            if plan is not None and k4_sweep:
                _paged_sweep(torch, timer, label, dname)
            if name == "decode_attention" and b2_sweep:
                _decode_sweep(torch, timer, label, dname)
            if name == "int8_matmul" and b7_sweep and dname == "bfloat16":
                _int8_sweep(torch, timer, label, dname)
            if name.startswith("rms") and k1_sweep and dname == "bfloat16":
                _norm_sweep(torch, timer, name, label, dname)
            if dtype == torch.bfloat16:
                rows.append(dict(
                    name=name, shape=label, dtype=dname, route="cuda",
                    source=SOURCES[name], replaces=REPLACES[name],
                    max_abs_err=err, max_err=err, tol=tol, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms))
    rows += _mixed_cache_rows(torch, timer)
    _refusals(torch)
    _norm_rope_edges(torch)
    _rope_sign_bits(torch)
    _rope_one_launch(torch)
    _paged_edges(torch)
    _paged_int8_edges(torch)
    _pre_edges(torch)
    _mask_edges(torch)
    _decode_edges(torch)
    _int8_edges(torch)
    _flash_tiles(torch)
    return rows


def _norm_sweep(torch, timer, name, label, dname):
    """Informative, for rms_plan's rules (``--k1-sweep``): one K1 case
    timed under every packs-a-thread instance at 32-1024 threads a row."""
    from paddle_tpu_torch.ops.hopper import fused_norm

    base, (x, r, w) = _K1_PLANS[(label, dname)]
    fn = (fused_norm.rms_norm_residual_fused if name.endswith("residual")
          else fused_norm.rms_norm_fused)
    r = r if name.endswith("residual") else None
    n, h = x.shape
    out = []
    for per in fused_norm.PERS:
        for tpr in (None, 32, 64, 128, 256, 512, 1024):
            kw = dict(per=per, tpr=tpr)
            try:
                plan = fused_norm.rms_plan(n, h, x.dtype,
                                           x.data_ptr() % 16 == 0, **kw)
            except ValueError:
                continue
            if tpr is not None and plan.tpr == base.tpr and \
                    plan.per == base.per:
                continue
            ms = timer(lambda kw=kw: fused_norm._launch(fn, x, r, w, 1e-6,
                                                        **kw))
            out.append((ms, f"p{plan.per}/t{plan.tpr}/r{plan.rows}"
                        + ("/wide" if plan.wide else "")))
    out.sort()
    print(f"k1 sweep {name} {dname} {label} (plan p{base.per}/t{base.tpr}/"
          f"r{base.rows}): " + ", ".join(f"{p} {ms:.4f}" for ms, p in
                                         out[:12])
          + f" ms (fastest 12 of {len(out)})", flush=True)


def _norm_rope_edges(torch):
    """K1 and K2 against their plain versions (the `_tol` of phase 2) in
    bfloat16 and float32 under every plan their instances take (forced).
    K1: rows of 2, 64, 4096, 4100 (no 16-byte packs), 2560, 16384, 32768
    and 65536 (past the registers: the rest of the row read twice), with
    and without the residual, aligned and at an odd storage offset; each
    packs-a-thread instance at its own threads and at 32 a row, both
    bodies.  K2: D 128, 64, 72 (D / 2 % 8 != 0) and 2, q and k as the
    columns of a packed qkv buffer, with and without the device offset
    (at 0, inside, and past Smax - S), both bodies."""
    from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(41)
    dev = "cuda"
    n_k1 = n_k2 = worst = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

        for n, h in ((3, 2), (5, 64), (7, 4096), (6, 4100), (33, 2560),
                     (2, 16384), (2, 32768), (1, 65536)):
            for odd in (False, True):
                if odd:
                    x, r = (rnd(n * h + 1)[1:].view(n, h) for _ in range(2))
                else:
                    x, r = rnd(n, h), rnd(n, h)
                w = rnd(h)
                refs = {None: fused_norm._ref_rms(x, w, 1e-6),
                        "res": fused_norm._ref_rms_residual(x, r, w, 1e-6)}
                for vec in (True, False):
                    for per in fused_norm.PERS:
                        for tpr in (None, 32):
                            kw = dict(vec=vec, per=per, tpr=tpr)
                            try:
                                plan = fused_norm.rms_plan(n, h, dtype,
                                                           not odd, **kw)
                            except ValueError:   # not an instance's plan
                                continue
                            for res, ref in refs.items():
                                fn = (fused_norm.rms_norm_residual_fused
                                      if res else fused_norm.rms_norm_fused)
                                got = fused_norm._launch(
                                    fn, x, r if res else None, w, 1e-6,
                                    **kw)
                                got = got if res else got[0]
                                for a, b in zip(got if res else (got,),
                                                ref if res else (ref,)):
                                    err, tol = _err(torch, a, b), _tol(
                                        dname, b)
                                    worst = max(worst, err / tol)
                                    if not err <= tol:
                                        raise AssertionError(
                                            f"K1 edge {dname} [{n}, {h}] "
                                            f"odd {odd} residual {bool(res)}"
                                            f" {plan}: kernel and plain "
                                            f"differ by {err} > {tol}")
                                n_k1 += 1
        inv = 1.0 / (10000.0 ** (torch.arange(0, 128, 2, device=dev) / 128))
        for B, S, H, KVH, D in ((2, 3, 4, 2, 128), (1, 5, 8, 8, 64),
                                (3, 2, 4, 1, 72), (2, 4, 2, 2, 2)):
            half = D // 2
            fr = (torch.arange(64, device=dev)[:, None].double()
                  * inv[None, :half].double())
            tc, ts = fr.cos().float().contiguous(), fr.sin().float()\
                .contiguous()
            qkv = rnd(B, S, (H + 2 * KVH) * D)
            q = qkv[..., :H * D].view(B, S, H, D)
            k = qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D)
            for off in (None, 0, 17, 63):
                o = (None if off is None else
                     torch.full((), off, dtype=torch.int64, device=dev))
                c, s = ((tc[:S], ts[:S]) if o is None else (tc, ts))
                ref = fused_ops._rope_ref(
                    q, k, *fused_ops._window(c, s, S, o))
                for vec in (True, False):
                    try:
                        plan = fused_ops.rope_plan(B, S, H, KVH, D, dtype,
                                                   True, vec=vec)
                    except ValueError:
                        continue
                    got = fused_ops._rope_launch(fused_ops.rope_fused, q, k,
                                                 c, s, o, vec=vec)
                    for a, b in zip(got, ref):
                        err, tol = _err(torch, a, b), _tol(dname, b)
                        worst = max(worst, err / tol)
                        if not err <= tol:
                            raise AssertionError(
                                f"K2 edge {dname} [{B}, {S}, {H} / {KVH}, "
                                f"{D}] offset {off} {plan}: kernel and "
                                f"plain differ by {err} > {tol}")
                    n_k2 += 1
    torch.cuda.synchronize()
    print(f"k1/k2 edges: {n_k1} K1 plans and {n_k2} K2 plans agree with "
          f"the plain versions (largest error {worst:.3f} of its "
          "tolerance)")


def _rope_sign_bits(torch):
    """The rope backward's sign flag gives the bits of K2 launched with an
    explicit -sin table, in both types and both bodies, at training's
    [8, 2048, 20, 128] and with generation's device offset."""
    from paddle_tpu_torch.ops.hopper import fused_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(43)
    dev, n = "cuda", 0
    D = 128
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    fr = torch.arange(4096, device=dev)[:, None].double() * inv[None].double()
    tc, ts = fr.cos().float().contiguous(), fr.sin().float().contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, KVH, off in ((8, 2048, 20, 20, None),
                                  (8, 1, 32, 8, 150)):
            gq = torch.randn(B, S, H, D, generator=g, device=dev, dtype=dtype)
            gk = torch.randn(B, S, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            o = (None if off is None else
                 torch.full((), off, dtype=torch.int32, device=dev))
            c, s = (tc[:S], ts[:S]) if o is None else (tc, ts)
            for vec in (True, False):
                flag = fused_ops._rope_launch(fused_ops.rope_bwd_fused, gq,
                                              gk, c, s, o, sign=-1.0, vec=vec)
                table = fused_ops._rope_launch(fused_ops.rope_fused, gq, gk,
                                               c, -s, o, vec=vec)
                if not all(torch.equal(a, b) for a, b in zip(flag, table)):
                    raise AssertionError(
                        f"K2 sign flag {dtype} [{B}, {S}, {H} / {KVH}] "
                        f"vec {vec}: not the bits of the -sin table")
                n += 1
    print(f"k2 sign flag: {n} backward launches give the bits of K2 with an "
          "explicit -sin table")


def _dispatches(torch, fn):
    """The PyTorch operators ``fn()`` dispatches under no_grad, by name (a
    ctypes kernel launch dispatches none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class _Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), _Log():
        fn()
    torch.cuda.synchronize()
    return ops


def _rope_one_launch(torch):
    """apply_rotary_pos_emb with the ring's pos on the device is one K2
    launch and dispatches nothing to PyTorch but K2's custom op
    (``paddle_tpu_torch::rope``, whose real implementation allocates the
    outputs and launches; the window's clamp, arange, add and gathers were
    six launches)."""
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    from paddle_tpu_torch.ops.hopper import fused_ops

    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(8, 1, 32, 128, device=dev, dtype=dt)
    k = torch.randn(8, 1, 32, 128, device=dev, dtype=dt)
    tc = torch.randn(4096, 64, device=dev)
    pos = torch.full((), 150, dtype=torch.int32, device=dev)
    n0 = fused_ops.rope_fused.launches
    ops = _dispatches(torch, lambda: apply_rotary_pos_emb(
        q, k, tc, tc, position_offset=pos))
    kernels = [op for op in ops if not op.startswith("aten.empty")
               and op != "paddle_tpu_torch.rope.default"]
    print(f"apply_rotary_pos_emb with a device offset: "
          f"{fused_ops.rope_fused.launches - n0} K2 launch, PyTorch "
          f"dispatches {ops}")
    if (kernels or ops.count("paddle_tpu_torch.rope.default") != 1
            or fused_ops.rope_fused.launches != n0 + 1):
        raise AssertionError(f"apply_rotary_pos_emb dispatched {ops} "
                             "beside one K2 launch")


def _int8_edges(torch):
    """B7 against its plain version (the `_tol` of phase 2) at the edges
    its plan adds, in bfloat16 and float32, with and without a bias: M 1,
    8, 9, 64, 65 and 4097 (token tiles 8-128, one row past each), N 2 (the
    narrow kind) and 130 (a ragged 64-row weight tile), K 100 (one ragged
    step) and 4096 (the plan splits K where the grid is small), and the
    classifier head's strided x[:, 0].  With a bias the kernel's epilogue
    must give the bits of the kernel's product plus a separate add (the
    two-step rounding).  In bfloat16 every split count the instance takes
    (forced) is held too, and a plan with a cluster must give the same bits
    in five runs (the merge has no atomics)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    from paddle_tpu_torch.quantization import weight_quantize

    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    dev = "cuda"
    n = worst = clusters = fused = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]

        def rnd(*shape, dt=dtype):
            return torch.randn(*shape, generator=g, device=dev, dtype=dt)

        xs = {(M, K): rnd(M, K) for M in (1, 8, 9, 64, 65, 4097)
              for K in (100, 4096)}
        xs[("head", 768)] = rnd(32, 128, 768)[:, 0]
        for (M, K), x in xs.items():
            for N in (2, 130):
                qw, sc = weight_quantize(rnd(K, N, dt=torch.float32) * 0.05)
                b = rnd(N)
                M = x.shape[0]
                splits = [None]
                if dtype == torch.bfloat16 and N >= im.NARROW_N:
                    splits += [s for s in im.SPLITS if s > 1]
                for bias in (None, b):
                    ref = im._int8_matmul_ref(x, qw, sc, bias)
                    tol = _tol(dname, ref)
                    for sp in splits:
                        kw = {} if sp is None else dict(splits=sp)
                        try:
                            plan = im.int8_plan(M, N, K, dtype, **kw)
                        except ValueError:   # a split left empty: refused
                            continue
                        got = im._launch(x, qw, sc, bias, **kw)
                        err = _err(torch, got, ref)
                        n += 1
                        worst = max(worst, err / tol)
                        if not err <= tol:
                            raise AssertionError(
                                f"B7 edge {dname} [{M}, {K}] x [{K}, {N}] "
                                f"bias {bias is not None} {plan}: kernel and "
                                f"plain differ by {err} > {tol}")
                        if bias is not None:
                            two = im._launch(x, qw, sc, **kw) + bias
                            if not torch.equal(got, two):
                                raise AssertionError(
                                    f"B7 edge {dname} [{M}, {K}] x [{K}, "
                                    f"{N}] {plan}: the fused bias differs "
                                    "from the two-step add")
                            fused += 1
                        for _ in range(4 if plan.splits > 1 else 0):
                            if not torch.equal(
                                    im._launch(x, qw, sc, bias, **kw), got):
                                raise AssertionError(
                                    f"B7 edge {dname} [{M}, {K}] x [{K}, "
                                    f"{N}] {plan}: two runs differ")
                        clusters += plan.splits > 1
    torch.cuda.synchronize()
    print(f"b7 edges: {n} plans agree with the plain version (largest error "
          f"{worst:.3f} of its tolerance); {fused} with a bias give the "
          f"two-step bits; the {clusters} with clusters gave the same bits "
          "in 5 runs each")


def _int8_sweep(torch, timer, label, dname):
    """Informative, for int8_plan's rules (``--b7-sweep``): one B7 case
    timed under every plan the instances take (the narrow kind, and every
    token tile, weight-row count and split count of the wgmma kind)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im

    base, (x, qw, sc, b), _ = _B7_PLANS[(label, dname)]
    M, K = x.shape
    N = qw.shape[1]
    plans = [dict(kind="narrow")] + [
        dict(kind="wgmma", tile=t, rows=r, splits=s)
        for t in im.TILES for r in im.ROWS for s in im.SPLITS]
    out = []
    for kw in plans:
        try:
            im.int8_plan(M, N, K, x.dtype, **kw)
        except ValueError:
            continue
        ms = timer(lambda kw=kw: im._launch(x, qw, sc, b, **kw))
        out.append((ms, "narrow" if kw["kind"] == "narrow" else
                    f"t{kw['tile']}/r{kw['rows']}/s{kw['splits']}"))
    out.sort()
    print(f"b7 sweep {dname} {label} (plan {base.kind} t{base.tile}/"
          f"r{base.rows}/s{base.splits}): " + ", ".join(
              f"{name} {ms:.4f}" for ms, name in out[:12]) + " ms (fastest "
          f"12 of {len(out)})", flush=True)


def _decode_edges(torch):
    """B2 against its plain version (the `_tol` of phase 2) at the edges
    its tiles and splits add, in bfloat16 and float32, under every split
    count (forced): pos 0 (one key), pos 1 (empty shares under 4 and 8
    splits), pos + 1 at and one past a multiple of the key tile, pos L - 1
    and past it (clamped), a negative pos (no key: zeros), a ring of 100
    rows; groups of 1, 2, 4, 8, 16 and 64 heads (a group past 16 takes
    several blocks), head_dim 48, 64, 72, 80 and 144 (zero-padded columns
    on the tensor cores), 128 and 256, and 100, 264 and 512 (the SIMT
    instance in both types: rows read in pieces, 16-key tiles in float32
    past 256).  A plan with a cluster must give the same bits in five runs
    (the merge has no atomics)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    dev, B = "cuda", 3
    n = worst = clusters = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for G, KVH, D, L in ((1, 2, 64, 100), (2, 2, 128, 300),
                             (4, 2, 80, 100), (8, 1, 256, 100),
                             (16, 1, 128, 200), (64, 1, 128, 100),
                             (1, 1, 48, 64), (2, 1, 144, 100),
                             (4, 1, 72, 100), (2, 2, 100, 100),
                             (16, 1, 264, 100), (1, 2, 512, 64)):
            H = G * KVH
            q = torch.randn(B, 1, H, D, generator=g, device=dev, dtype=dtype)
            kb = torch.randn(B, L, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            vb = torch.randn(B, L, KVH, D, generator=g, device=dev,
                             dtype=dtype)
            for pos in sorted({-3, 0, 1, 15, 16, 63, 64, 127, 128, L - 1,
                               L + 5}):
                p = torch.full((), pos, dtype=torch.int32, device=dev)
                ref = da.ref_decode_attention(q, kb, vb, p)
                tol = _tol(dname, ref)
                for splits in (1, 2, 4, da.SPLIT_CAP):
                    kw = dict(splits=splits)
                    try:
                        plan = da._plan(B, L, H, KVH, D, dtype, **kw)
                    except ValueError:   # past the limits: refused
                        continue
                    got = da._launch(q, kb, vb, p, **kw)
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"B2 edge {dname} G {G} D {D} L {L} pos {pos} "
                            f"{plan}: kernel and plain differ by {err} > "
                            f"{tol}")
                    # the cluster merge has no atomics: a plan's runs agree
                    # bit for bit, or blocks race
                    for _ in range(4 if plan.splits > 1 else 0):
                        if not torch.equal(da._launch(q, kb, vb, p, **kw),
                                           got):
                            raise AssertionError(
                                f"B2 edge {dname} G {G} D {D} L {L} pos "
                                f"{pos} {plan}: two runs differ")
                    clusters += plan.splits > 1
    torch.cuda.synchronize()
    print(f"b2 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          "with clusters gave the same bits in 5 runs each")


def _decode_sweep(torch, timer, label, dname):
    """Informative, for decode_plan's split rule (``--b2-sweep``): one B2
    case timed under every split count."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da

    base, (q, kb, vb, p) = _B2_PLANS[(label, dname)]
    out = []
    for splits in (1, 2, 4, da.SPLIT_CAP):
        try:
            ms = timer(lambda: da._launch(q, kb, vb, p, splits=splits))
            ms = f"{ms:.4f}"
        except ValueError:          # past the limits: refused
            ms = "refused"
        out.append(f"splits {splits} {ms}")
    print(f"b2 sweep {dname} {label} (plan splits {base.splits}): "
          + ", ".join(out) + " ms", flush=True)


def _paged_edges(torch):
    """K4 against its plain version (the `_tol` of phase 2) at the edges
    its tiles and splits add, in bfloat16 and float32, under every split
    count and several query tiles (the plan forced): visible key counts at
    0, 1 and -1 mod 16 and mod the split chunk, a position past the pool
    (clamped), a row with now = 0, now > max_q_len, block ids -1 and past
    the pool, padding tokens; GQA groups 1, 4 and 8, head_dim 64, 128 and
    256, 80 and 72 (bf16: tensor cores on zero-padded columns), and 100,
    264 and 512 (the SIMT instance in both types: rows read in pieces,
    16-key tiles past 256 where larger rings do not fit).  A plan with a
    cluster must give the same bits in five runs (the merge has no
    atomics)."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    dev, bs, P, NB, B = "cuda", 16, 12, 128, 8
    batches = (  # (max_q_len, dec, now)
        (1, [0, 14, 15, 126, 127, 63, 200, 0], [1, 1, 1, 1, 1, 1, 1, 0]),
        (16, [0, 17, 31, 5, 100, 0, 64, 150], [16, 1, 20, 0, 9, 3, 1, 16]))
    n = worst = clusters = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for G, D in ((1, 64), (4, 128), (8, 256), (1, 128), (8, 64),
                     (2, 80), (1, 72), (2, 100), (4, 264), (1, 512)):
            KV, H = 2, 2 * G
            kc = torch.randn(NB, KV, bs, D, generator=g, device=dev,
                             dtype=dtype)
            vc = torch.randn(NB, KV, bs, D, generator=g, device=dev,
                             dtype=dtype)
            bt = torch.randperm(NB, generator=g, device=dev)[:B * P]
            bt = bt.view(B, P).to(torch.int32)
            bt[2, 1], bt[5, 0] = -1, NB + 3
            for mq, dec, now in batches:
                dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                cu[1:] = torch.cumsum(now_t, 0)
                q = torch.randn(sum(now) + 5, H, D, generator=g, device=dev,
                                dtype=dtype)
                args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
                ref = pa._paged_attention_ref(*args)
                tol = _tol(dname, ref)
                T = q.shape[0]
                for qt, splits, stages in itertools.product(
                        (1, 5, 16) if mq > 1 else (1,),
                        (1, 2, pa.SPLIT_CAP), pa.STAGES[pa._tc(dtype, D)]):
                    kw = dict(qt=qt, splits=splits, stages=stages)
                    try:
                        p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype, **kw)
                    except ValueError:   # past the limits: refused
                        continue
                    got = pa._launch(*args, **kw)
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"K4 edge {dname} G {G} D {D} mq {mq} {p}: "
                            f"kernel and plain differ by {err} > {tol}")
                    # the cluster merge has no atomics: a plan's runs agree
                    # bit for bit, or blocks race
                    for _ in range(4 if p.splits > 1 else 0):
                        if not torch.equal(pa._launch(*args, **kw), got):
                            raise AssertionError(
                                f"K4 edge {dname} G {G} D {D} mq {mq} {p}: "
                                "two runs differ")
                    clusters += p.splits > 1
    torch.cuda.synchronize()
    print(f"k4 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          "with clusters gave the same bits in 5 runs each")


def _paged_int8_edges(torch):
    """K4-int8 against its plain version (the `_tol` of phase 2) at the
    edges of its two instances, in bfloat16 (the tensor cores where the
    shape allows, and SIMT forced) and float32 (SIMT), under every split
    count 1-4: head_dim 8, 64, 72 (8-byte code pieces), 128 and 256 at 1,
    4, 8, 16 and 64 query heads a KV head; a decode batch (visible key
    counts at 0, 1 and -1 mod 64, a position past the pool, a row with now
    0) and a prefill batch (dec 0 rows, tiles straddling cached and fresh
    keys, now > max_q_len); block ids -1 and past the pool inside the
    visible range; block size 16 and, at some shapes, 48 (a split's chunk
    of 64 keys then starts inside a block); k and v as views of a packed
    qkv buffer.  A plan with a cluster must give the same bits in three
    runs.  float32 outputs (``out_dtype``) of both K4-int8 instances and
    of K4's three (tensor cores, SIMT, wide) against the plain versions'."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    dev, B, f32 = "cuda", 8, torch.float32
    batches = (  # (max_q_len, dec, now)
        (1, [0, 63, 64, 127, 128, 200, 500, 0], [1, 1, 1, 1, 1, 1, 1, 0]),
        (16, [0, 17, 60, 5, 100, 0, 64, 150], [16, 1, 20, 0, 9, 3, 1, 16]))
    n = worst = clusters = wides = 0
    for dtype in (torch.bfloat16, f32):
        dname = str(dtype).split(".")[1]
        for G, D in itertools.product((1, 4, 8, 16, 64),
                                      (8, 64, 72, 128, 256)):
            KV, H = 2, 2 * G
            for bs in ((16, 48) if (G, D) in ((4, 128), (1, 72), (16, 256))
                       else (16,)):
                P = -(-192 // bs)
                NB = B * P + 4
                kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                        device=dev, dtype=torch.uint8)
                          for _ in range(2))
                bt = torch.randperm(NB, generator=g, device=dev)[:B * P]
                bt = bt.view(B, P).to(torch.int32)
                bt[1, 1], bt[4, 0] = -1, NB + 3
                kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
                vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
                for mq, dec, now in batches:
                    dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                    now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                    cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                    cu[1:] = torch.cumsum(now_t, 0)
                    T = sum(now) + 5
                    qkv = torch.randn(T, (H + 2 * KV) * D, generator=g,
                                      device=dev, dtype=dtype)
                    q = qkv[:, :H * D].reshape(T, H, D).contiguous()
                    k = qkv[:, H * D:(H + KV) * D].view(T, KV, D)
                    v = qkv[:, (H + KV) * D:].view(T, KV, D)
                    args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
                    ref = pa._paged_attention_int8_ref(*args)
                    ref32 = pa._paged_attention_int8_ref(*args,
                                                         out_dtype=f32)
                    tol = _tol(dname, ref)
                    can_tc = pa._tc(dtype, D) and G <= pa.TC_ROWS
                    for tc in ((True, False) if can_tc else (False,)):
                        for splits in (1, 2, 3, 4):
                            try:
                                p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                                  dtype, tc, splits)
                            except ValueError:   # past the limits: refused
                                continue
                            got = pa._launch_int8(*args, tc=tc,
                                                  splits=splits)
                            err = _err(torch, got, ref)
                            n += 1
                            worst = max(worst, err / tol)
                            if not err <= tol:
                                raise AssertionError(
                                    f"K4-int8 edge {dname} G {G} D {D} bs "
                                    f"{bs} mq {mq} {p}: kernel and plain "
                                    f"differ by {err} > {tol}")
                            for _ in range(2 if p.splits > 1 else 0):
                                if not torch.equal(pa._launch_int8(
                                        *args, tc=tc, splits=splits), got):
                                    raise AssertionError(
                                        f"K4-int8 edge {dname} G {G} D {D} "
                                        f"mq {mq} {p}: two runs differ")
                            clusters += p.splits > 1
                        try:
                            got = pa._launch_int8(*args, out_dtype=f32,
                                                  tc=tc)
                        except ValueError:
                            continue
                        err = _err(torch, got, ref32)
                        if got.dtype != f32 or not err <= _tol(dname, ref32):
                            raise AssertionError(
                                f"K4-int8 edge {dname} G {G} D {D} tc {tc}: "
                                f"float32 output {got.dtype} differs by "
                                f"{err}")
                        wides += 1
    # bf16 k and v one element past 16-byte alignment: the launch's own
    # plan takes SIMT, gives the forced SIMT instance's bits and agrees
    # with the plain version
    KV, H, D, bs, P = 2, 8, 128, 16, 12
    NB = B * P
    kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                            device=dev, dtype=torch.uint8) for _ in range(2))
    bt = torch.randperm(NB, generator=g, device=dev).view(B, P).to(
        torch.int32)
    kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
    misaligned = 0
    for mq, dec, now in batches:
        dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
        now_t = torch.tensor(now, dtype=torch.int32, device=dev)
        cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
        cu[1:] = torch.cumsum(now_t, 0)
        T = sum(now) + 5
        qkv = torch.randn(T, (H + 2 * KV) * D + 1, generator=g, device=dev,
                          dtype=torch.bfloat16)[:, 1:]
        q = qkv[:, :H * D].reshape(T, H, D).contiguous()
        k = qkv[:, H * D:(H + KV) * D].view(T, KV, D)
        v = qkv[:, (H + KV) * D:].view(T, KV, D)
        args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
        plan = pa._int8_launch_plan(q, k, v, kc, vc, bt, mq)
        ref = pa._paged_attention_int8_ref(*args)
        got = pa._launch_int8(*args)
        err = _err(torch, got, ref)
        if (plan.tc or not torch.equal(got, pa._launch_int8(*args, tc=False))
                or not err <= _tol("bfloat16", ref)):
            raise AssertionError(f"K4-int8 misaligned k/v mq {mq}: {plan}, "
                                 f"error {err}")
        misaligned += 1
    # K4's three instances with a float32 output
    k4 = 0
    for dtype, D in ((torch.bfloat16, 128), (torch.bfloat16, 100),
                     (f32, 64), (torch.bfloat16, 640)):
        dname = str(dtype).split(".")[1]
        bs, P, KV, H = 16, 12, 2, 8
        NB = B * P
        kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                              dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        for mq, dec, now in batches:
            dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
            now_t = torch.tensor(now, dtype=torch.int32, device=dev)
            cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
            cu[1:] = torch.cumsum(now_t, 0)
            q = torch.randn(sum(now) + 5, H, D, generator=g, device=dev,
                            dtype=dtype)
            args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
            ref32 = pa._paged_attention_ref(*args, out_dtype=f32)
            got = pa.paged_attention(*args, out_dtype=f32)
            err = _err(torch, got, ref32)
            if got.dtype != f32 or not err <= _tol(dname, ref32):
                raise AssertionError(f"K4 {dname} D {D} mq {mq}: float32 "
                                     f"output {got.dtype} differs by {err}")
            k4 += 1
    torch.cuda.synchronize()
    print(f"k4-int8 edges: {n} forced plans agree with the plain version "
          f"(largest error {worst:.3f} of its tolerance); the {clusters} "
          f"with clusters gave the same bits in 3 runs each; {wides} "
          f"float32 outputs of K4-int8 and {k4} of K4 (tensor cores, SIMT, "
          f"wide) agree with the plain versions'; {misaligned} misaligned "
          "bf16 k/v calls took SIMT")


def _pre_edges(torch):
    """The pre-caches (A4b) in every K4 and K4-int8 instance against the
    plain versions (the `_tol` of phase 2): K4's tensor cores (bf16 D 128),
    its SIMT instance (float32 D 128, bf16 D 100) and its wide one (bf16
    and float32 D 640), K4-int8's tensor cores (bf16 D 128) and SIMT
    (forced on bf16 D 128, float32 D 128, bf16 D 100); prefixes of 1, 64
    and 130 keys (within a tile, one whole tile, straddling three); at
    decode (8 rows, context <= 512, a row with now 0, an out-of-pool block)
    and at the single step's mixed batch of 255 tokens (max_q_len 256);
    32 / 8 heads (16 / 2 past 512 columns); the plan's own split and one
    and four splits forced where the instance takes them.  Each plan with
    a cluster gives the same bits in three runs.  No instance refuses a
    prefix: the unforced call of each case must run."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    dev, bs, P, B = "cuda", 16, 32, 8
    NB = B * P + 4
    batches = (  # (max_q_len, T, dec, now)
        (1, B, [300, 0, 200, 450, 17, 63, 511, 64], [1, 1, 1, 1, 1, 1, 0, 1]),
        (256, 256, [300, 0, 200, 450, 0, 0, 20, 64],
         [1, 100, 16, 1, 60, 0, 1, 76]))
    instances = (  # (kernel, dtype, D, tensor cores forced)
        ("k4", torch.bfloat16, 128, None), ("k4", torch.float32, 128, None),
        ("k4", torch.bfloat16, 100, None), ("k4", torch.bfloat16, 640, None),
        ("k4", torch.float32, 640, None),
        ("k4-int8", torch.bfloat16, 128, None),
        ("k4-int8", torch.bfloat16, 128, False),
        ("k4-int8", torch.float32, 128, None),
        ("k4-int8", torch.bfloat16, 100, None))
    n = worst = clusters = 0
    for kern, dtype, D, tc in instances:
        dname = str(dtype).split(".")[1]
        KV, H = (2, 16) if D > 512 else (8, 32)
        int8 = kern == "k4-int8"
        if int8:
            kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                    device=dev, dtype=torch.uint8)
                      for _ in range(2))
            kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
            vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
        else:
            kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                                  dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        bt[3, 2] = -1                   # visible to row 3, outside the pool
        for Lp in (1, 64, 130):
            pre = dict(pre_key=torch.randn(B, KV, Lp, D, generator=g,
                                           device=dev, dtype=dtype),
                       pre_value=torch.randn(B, KV, Lp, D, generator=g,
                                             device=dev, dtype=dtype))
            for mq, T, dec, now in batches:
                dec_t = torch.tensor(dec, dtype=torch.int32, device=dev)
                now_t = torch.tensor(now, dtype=torch.int32, device=dev)
                cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                cu[1:] = torch.cumsum(now_t, 0)
                q = torch.randn(T, H, D, generator=g, device=dev,
                                dtype=dtype)
                if int8:
                    k, v = (torch.randn(T, KV, D, generator=g, device=dev,
                                        dtype=dtype) for _ in range(2))
                    args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt,
                            mq)
                    ref = pa._paged_attention_int8_ref(*args, **pre)
                    own = pa.paged_attention_int8(*args, **pre)
                else:
                    args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
                    ref = pa._paged_attention_ref(*args, **pre)
                    own = pa.paged_attention(*args, **pre)
                tol = _tol(dname, ref)
                outs = [("plan", own, None)]
                for splits in (1, pa.SPLIT_CAP):
                    try:
                        if int8:
                            p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                              dtype, tc, splits, Lp)
                            run = (lambda s=splits: pa._launch_int8(
                                *args, tc=tc, splits=s, **pre))
                        else:
                            p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype,
                                         splits=splits, pre_len=Lp)
                            run = (lambda s=splits: pa._launch(
                                *args, splits=s, **pre))
                    except ValueError:   # the wide instance: one split
                        continue
                    got = run()
                    outs.append((p, got, run))
                for p, got, run in outs:
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"{kern} prefix {Lp} {dname} D {D} tc {tc} mq "
                            f"{mq} {p}: kernel and plain differ by {err} > "
                            f"{tol}")
                    if run is not None and p.splits > 1:
                        clusters += 1
                        for _ in range(2):
                            if not torch.equal(run(), got):
                                raise AssertionError(
                                    f"{kern} prefix {Lp} {dname} D {D} mq "
                                    f"{mq} {p}: two runs differ")
    torch.cuda.synchronize()
    print(f"prefix edges: {n} calls of K4 and K4-int8 with pre-caches agree "
          f"with the plain versions (largest error {worst:.3f} of its "
          f"tolerance); the {clusters} with clusters gave the same bits in 3 "
          "runs each")


def _mask_configs(H, mq, Lf):
    """The masks of ``_mask_edges``, as ((heads, rows, columns) of ``mask``
    | None, the same of ``tgt_mask`` | None): one head and H heads, fewer
    and more rows than ``max_q_len``, fewer and more columns than the
    combined key axis Lf, each mask alone and both together."""
    return (((1, mq, Lf), (H, 1, Lf)),
            ((H, max(1, mq // 2), Lf - 37), (1, 1, Lf + 9)),
            ((1, mq + 7, Lf + 20), None),
            (None, (H, 3, Lf - 100)))


def _c10_case(torch, g, case, B, H, Lp, L):
    """One of Queue C10's rows for ``_mask_edges``: (the batch, the masks,
    (row, local token) of the case's query).  (a) The decode row 0 at
    position 300 whose visible keys all carry -inf under ``tgt_mask``; (b)
    the same row under finfo(float32).min over Lp + 320 columns (every
    visible key, not the whole axis of Lp + L: the keys past them carry
    the row); (c) token 40 of the mixed step's prefill row 1 whose visible
    keys all carry -inf under ``mask`` (in K4-int8 its invisible keys hold
    the step's later tokens); (d) token 70 of that row with every key
    -inf.  The other entries are uniform in [-3, 1]."""
    Lf = Lp + L

    def rand(*shape):
        return torch.rand(B, *shape, generator=g, device="cuda") * 4 - 3

    if case in "ab":
        tgt = rand(1, 1, Lf if case == "a" else Lp + 320)
        if case == "a":
            tgt[0, :, :, :Lp + 301] = -float("inf")
        else:
            tgt[0] = torch.finfo(torch.float32).min
        return 0, dict(mask=None, tgt_mask=tgt), (0, 0)
    mask, tok = rand(1, 256, Lf), 40 if case == "c" else 70
    mask[1, :, tok, :Lp + tok + 1 if case == "c" else Lf] = -float("inf")
    return 1, dict(mask=mask, tgt_mask=rand(1, 1, Lf)), (1, tok)


def _mask_edges(torch):
    """The additive masks (A4b) in every K4 and K4-int8 instance against the
    plain versions (the `_tol` of phase 2): the instances of `_pre_edges`
    (K4's tensor cores, SIMT and wide; K4-int8's tensor cores and SIMT,
    forced and by dtype / head dim), without a prefix and with prefixes of
    1, 64 and 130 keys, at decode (two rows in prefill under ``mask``, the
    others under ``tgt_mask``, a row with now 0, an out-of-pool block) and
    at the single step's mixed batch of 255 tokens (its prefill rows under
    ``mask``, the rest under ``tgt_mask``), under the masks of
    `_mask_configs` in turn (values in [-3, 1], 5% of them -inf, column 0
    finite so that every query keeps a key); the plan's own split and one
    and four splits forced.  Each plan with a cluster gives the same bits
    in three runs.  Then ROADMAP Queue C10 in every instance, without a
    prefix and with 64 keys, under the plan's split and one and four
    splits forced: the rows of `_c10_case`, whose visible logits all sit
    at or below -1e30, equal the plain versions' (the reference's softmax
    over the -1e30 logits of their invisible keys; NaN where every key is
    -inf), and so do the calls' other rows."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    g = torch.Generator(device="cuda")
    g.manual_seed(18)
    dev, bs, P, B = "cuda", 16, 32, 8
    NB = B * P + 4
    batches = (  # (max_q_len, T, dec, now, enc)
        (1, B, [300, 0, 200, 450, 17, 63, 511, 64], [1, 1, 1, 1, 1, 1, 0, 1],
         [0, 1, 0, 0, 1, 0, 0, 0]),
        (256, 256, [300, 0, 200, 450, 0, 0, 20, 64],
         [1, 100, 16, 1, 60, 0, 1, 76], [0, 100, 0, 0, 60, 0, 0, 76]))
    instances = (  # (kernel, dtype, D, tensor cores forced)
        ("k4", torch.bfloat16, 128, None), ("k4", torch.float32, 128, None),
        ("k4", torch.bfloat16, 100, None), ("k4", torch.bfloat16, 640, None),
        ("k4", torch.float32, 640, None),
        ("k4-int8", torch.bfloat16, 128, None),
        ("k4-int8", torch.bfloat16, 128, False),
        ("k4-int8", torch.float32, 128, None),
        ("k4-int8", torch.bfloat16, 100, None))

    def rand_mask(shape):
        if shape is None:
            return None
        m = torch.rand(B, *shape, generator=g, device=dev) * 4 - 3
        m[torch.rand(m.shape, generator=g, device=dev) < 0.05] = -float("inf")
        m[..., 0] = 0.0
        return m

    n = worst = clusters = turn = c10 = 0
    edge = []
    for kern, dtype, D, tc in instances:
        dname = str(dtype).split(".")[1]
        KV, H = (2, 16) if D > 512 else (8, 32)
        int8 = kern == "k4-int8"
        if int8:
            kc, vc = (torch.randint(0, 256, (NB, KV, bs, D), generator=g,
                                    device=dev, dtype=torch.uint8)
                      for _ in range(2))
            kd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
            vd = (torch.rand(B, KV, generator=g, device=dev) + 0.5) / 64
        else:
            kc, vc = (torch.randn(NB, KV, bs, D, generator=g, device=dev,
                                  dtype=dtype) for _ in range(2))
        bt = torch.randperm(NB, generator=g, device=dev)[:B * P].view(
            B, P).to(torch.int32)
        bt[3, 2] = -1                   # visible to row 3, outside the pool

        def call(mq, T, dec, now, enc, Lp, masks):
            """(args, kwargs, plain output, kernel output) of one case."""
            dec_t, now_t, enc_t = (torch.tensor(x, dtype=torch.int32,
                                                device=dev)
                                   for x in (dec, now, enc))
            cu = torch.zeros(B + 1, dtype=torch.int32, device=dev)
            cu[1:] = torch.cumsum(now_t, 0)
            q = torch.randn(T, H, D, generator=g, device=dev, dtype=dtype)
            kw = dict(seq_lens_encoder=enc_t, **masks)
            if Lp:
                kw.update({n_: torch.randn(B, KV, Lp, D, generator=g,
                                           device=dev, dtype=dtype)
                           for n_ in ("pre_key", "pre_value")})
            if int8:
                k, v = (torch.randn(T, KV, D, generator=g, device=dev,
                                    dtype=dtype) for _ in range(2))
                args = (q, k, v, kc, vc, kd, vd, dec_t, now_t, cu, bt, mq)
                return (args, kw, pa._paged_attention_int8_ref(*args, **kw),
                        pa.paged_attention_int8(*args, **kw))
            args = (q, kc, vc, dec_t, now_t, cu, bt, mq)
            return (args, kw, pa._paged_attention_ref(*args, **kw),
                    pa.paged_attention(*args, **kw))

        for Lp in (0, 1, 64, 130):
            for mq, T, dec, now, enc in batches:
                cfg = _mask_configs(H, mq, Lp + P * bs)
                mk, tk = cfg[turn % len(cfg)]
                turn += 1
                masks = dict(mask=rand_mask(mk), tgt_mask=rand_mask(tk))
                args, kw, ref, own = call(mq, T, dec, now, enc, Lp, masks)
                tol = _tol(dname, ref)
                outs = [("plan", own, None)]
                for splits in (1, pa.SPLIT_CAP):
                    try:
                        if int8:
                            p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                              dtype, tc, splits, Lp)
                            run = (lambda s=splits: pa._launch_int8(
                                *args, tc=tc, splits=s, **kw))
                        else:
                            p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype,
                                         splits=splits, pre_len=Lp)
                            run = (lambda s=splits: pa._launch(
                                *args, splits=s, **kw))
                    except ValueError:   # the wide instance: one split
                        continue
                    outs.append((p, run(), run))
                for p, got, run in outs:
                    err = _err(torch, got, ref)
                    n += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"{kern} masks {mk} / {tk} prefix {Lp} {dname} D "
                            f"{D} tc {tc} mq {mq} {p}: kernel and plain "
                            f"differ by {err} > {tol}")
                    if run is not None and p.splits > 1:
                        clusters += 1
                        for _ in range(2):
                            if not torch.equal(run(), got):
                                raise AssertionError(
                                    f"{kern} masks prefix {Lp} {dname} D {D} "
                                    f"mq {mq} {p}: two runs differ")
        # Queue C10: rows whose visible logits all sit at or below -1e30
        # take the reference's softmax over the -1e30 logits of their
        # invisible keys (NaN where every key is -inf), in every instance,
        # with and without a prefix, under the plan's split and one and
        # four splits forced; the calls' other rows as before
        for Lp in (0, 64):
            for case in "abcd":
                bi, masks, (row, tok) = _c10_case(torch, g, case, B, H,
                                                  Lp, P * bs)
                mq, T, dec, now, enc = batches[bi]
                args, kw, ref, own = call(mq, T, dec, now, enc, Lp, masks)
                outs = [("plan", own)]
                for splits in (1, pa.SPLIT_CAP):
                    try:
                        if int8:
                            p = pa._int8_plan(T, B, mq, P, bs, H, KV, D,
                                              dtype, tc, splits, Lp)
                            got = pa._launch_int8(*args, tc=tc,
                                                  splits=splits, **kw)
                        else:
                            p = pa._plan(T, B, mq, P, bs, H, KV, D, dtype,
                                         splits=splits, pre_len=Lp)
                            got = pa._launch(*args, splits=splits, **kw)
                    except ValueError:   # the wide instance: one split
                        continue
                    outs.append((p, got))
                tol = _tol(dname, ref.nan_to_num(0.0))
                i = (int(torch.tensor([0] + list(now))[:row + 1].sum())
                     + tok)              # the case's token
                want = ref[i].float()
                if case == "d":
                    if not bool(want.isnan().all()):
                        raise AssertionError(f"{kern} C10 (d): the plain "
                                             "version's row is not NaN")
                elif not (bool(want.isfinite().all())
                          and float(want.abs().max()) > 0):
                    raise AssertionError(f"{kern} C10 ({case}): the plain "
                                         "version's row is not a mean")
                for p, got in outs:
                    same_nan = torch.equal(got.isnan(), ref.isnan())
                    err = float((got.float() - ref.float()).nan_to_num(
                        0.0).abs().max())
                    n += 1
                    c10 += 1
                    worst = max(worst, err / tol)
                    if not (same_nan and err <= tol):
                        raise AssertionError(
                            f"{kern} C10 ({case}) prefix {Lp} {dname} D {D} "
                            f"tc {tc} {p}: NaN where the plain version has "
                            f"it {same_nan}, error {err} > {tol}")
                if case == "a":
                    edge.append(f"{kern} {dname} D {D} tc {tc} prefix {Lp}:"
                                f" (a) |max| {float(want.abs().max()):.4f}")
    torch.cuda.synchronize()
    print(f"mask edges: {n} calls of K4 and K4-int8 under masks agree with "
          f"the plain versions (largest error {worst:.3f} of its "
          f"tolerance); the {clusters} with clusters gave the same bits in 3 "
          f"runs each; mask launches {pa.paged_attention.mask_launches} "
          f"(K4) {pa.paged_attention_int8.mask_launches} (K4-int8)")
    print(f"mask edges, Queue C10: {c10} of those calls carry rows whose "
          "visible logits all sit at or below -1e30 ((a) a decode row's "
          "visible keys all -inf, (b) finfo.min over them, (c) a prefill "
          "row's, (d) every key -inf: NaN), kernels equal to the plain "
          "versions, NaN where they have it; " + "; ".join(edge))


def _paged_sweep(torch, timer, label, dname):
    """Informative, for paged_plan's rules (``--k4-sweep``): one K4 case
    timed under every split count, ring depth and, for prefill tiles,
    several query tiles (bfloat16 on the tensor cores takes up to 64 query
    rows a tile)."""
    import itertools

    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    base = _K4_PLANS[(label, dname)]
    args = _K4_ARGS[(label, dname)]
    pre = _K4_PRE[(label, dname)]
    tc = pa._tc(args[0].dtype, args[0].shape[2])
    qts = ((base.qt,) if base.qt == 1 else (8, 16, 32, 64) if tc
           else (1, 2, 4, 8, 16))
    out = []
    for qt, stages, splits in itertools.product(
            qts, pa.STAGES[tc], (1, 2, pa.SPLIT_CAP)):
        kw = dict(qt=qt, splits=splits, stages=stages, **pre)
        try:
            ms = f"{timer(lambda: pa._launch(*args, **kw)):.4f}"
        except ValueError:          # past the limits: refused
            ms = "refused"
        out.append(f"qt {qt} stages {stages} splits {splits} {ms}")
    print(f"k4 sweep {dname} {label} (plan qt {base.qt} stages "
          f"{base.stages} splits {base.splits}): " + ", ".join(out) + " ms",
          flush=True)


def _flash_tiles(torch):
    """Informative, for autotune's table (bf16, CUDA events): B1 and B8 at
    every compiled tile pair, by autotune.tune (causal, 16 heads, ~8192
    rows) and at the training shapes (L2 flushed); B8's two GQA modes at
    four grid sizes beside the pair the selector picks; whether two B8 runs
    agree bit for bit (dQ is summed with atomics)."""
    from paddle_tpu_torch.ops.hopper import autotune
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    autotune.tune(seqs=(512, 2048), head_dims=(64, 128, 256))
    autotune.clear_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    timer = Timer(torch, 10)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    for B, S, H, D in ((8, 2048, 20, 128), (8, 2048, 10, 256)):
        q, k, v, go = (rnd(B, S, H, D) for _ in range(4))
        o, lse = fa.flash_attention_fused(q, k, v, True)
        dc = autotune.head_dim_class(D)
        for pair in autotune.INSTANCES[("fwd", dc)]:
            ms = timer(lambda p=pair: fa.flash_attention_fused(
                q, k, v, True, blocks=p))
            print(f"tiles fwd causal [{B}, {S}, {H}, {D}] {pair}: {ms:.4f} ms")
        for pair in autotune.INSTANCES[("bwd", dc)]:
            ms = timer(lambda p=pair: fa.flash_attention_bwd_fused(
                q, k, v, o, lse, go, True, blocks=p))
            print(f"tiles bwd causal [{B}, {S}, {H}, {D}] {pair}: {ms:.4f} ms")
    pick = fa._gqa_heads_per_block
    try:
        for B, S in ((1, 512), (2, 512), (4, 1024), (8, 2048)):
            q, go = rnd(B, S, 32, 128), rnd(B, S, 32, 128)
            k, v = rnd(B, S, 8, 128), rnd(B, S, 8, 128)
            o, lse = fa.flash_attention_fused(q, k, v, True)
            times = {}
            for hpb in (1, 4):  # the two modes, the selector substituted
                fa._gqa_heads_per_block = lambda *_, h=hpb: h
                times[hpb] = timer(lambda: fa.flash_attention_bwd_fused(
                    q, k, v, o, lse, go, True))
            print(f"B8 GQA causal [{B}, {S}, 32 / 8, 128]: one head per "
                  f"block {times[1]:.4f} ms, a block per group "
                  f"{times[4]:.4f} ms; the selector picks "
                  f"{pick(B, 8, S, 4)} head(s) per block")
    finally:
        fa._gqa_heads_per_block = pick
    q, go = rnd(1, 512, 32, 128), rnd(1, 512, 32, 128)
    k, v = rnd(1, 512, 8, 128), rnd(1, 512, 8, 128)
    o, lse = fa.flash_attention_fused(q, k, v, True)
    a = fa.flash_attention_bwd_fused(q, k, v, o, lse, go, True)
    b = fa.flash_attention_bwd_fused(q, k, v, o, lse, go, True)
    print("B8 bf16 GQA [1, 512] two runs bit for bit: " + ", ".join(
        f"{n} {bool(torch.equal(x, y))}" for n, x, y in zip(
            ("dq", "dk", "dv"), a, b)))


def _refusals(torch):
    """Shapes past a kernel's shared memory are refused and raise, naming
    the limit: a 128-head group over one KV head at head_dim 256 past the
    64 query rows of K4's bfloat16 tensor-core tile and, in float32, past
    the 227 KB a K4 block may use (by its plan, before any launch); the K4
    entry refuses a plan it has no instance for, a chunk short of the
    prefix and the context, and a prefix without its rows or off 16-byte
    alignment; the entry refuses a mask
    without seq_lens_encoder or of neither 1 nor H heads.  A head dim of
    520, which
    B1, B8, B2 and K4 refused here before (Queue C8), is computed and held
    to the plain versions in both dtypes.  (K1 refused a 16384-wide row
    here before its rows moved to registers, and B2 a head dim of 72
    before every head dim up to 512 had an instance: phase 2 now holds
    [1, 16384] and head dims 72 to 1024 against the plain versions.)"""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    dev, dt = "cuda", torch.bfloat16
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    cu = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    bt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    for kdt, limit in ((dt, "64 query rows"), (torch.float32, "227 KB")):
        big = torch.ones(1, 128, 256, dtype=kdt, device=dev)
        kv = torch.ones(1, 1, 16, 256, dtype=kdt, device=dev)
        try:
            pa.paged_attention(big, kv, kv, z, one, cu, bt, 1)
        except ValueError as e:
            if limit not in str(e):
                raise
            print(f"refused paged_attention {kdt} 128 heads / 1 KV, "
                  f"head_dim 256: {e}")
        else:
            raise AssertionError(f"paged_attention {kdt} 128 heads / 1 KV "
                                 "was not refused")
    from paddle_tpu_torch.ops.hopper import _build
    q = torch.ones(1, 8, 128, dtype=dt, device=dev)
    kv = torch.ones(1, 8, 16, 128, dtype=dt, device=dev)
    bt = torch.zeros(1, 32, dtype=torch.int32, device=dev)
    # (query tile, key tile, stages, splits, chunk, blocks of the row,
    # prefix keys, the prefix's pointers)
    pre = kv.data_ptr()
    for what, (qt, kt, stages, splits, chunk, P, Lp, pk) in {
            "key tile 48": (1, 48, 2, 1, 48, 1, 0, None),
            "8 splits": (1, 64, 2, 8, 64, 32, 0, None),
            "a chunk short of the context": (1, 64, 2, 1, 0, 1, 0, None),
            "a ring of 3 on the tensor cores": (1, 64, 3, 1, 64, 1, 0, None),
            "a chunk short of the prefix and the context": (
                1, 64, 2, 1, 64, 4, 16, pre),
            "a prefix without its rows": (1, 64, 2, 1, 128, 4, 16, None),
            "a prefix off 16-byte alignment": (1, 64, 2, 1, 128, 4, 16,
                                               pre + 2)}.items():
        err = _build.lib().ptt_paged_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), one.data_ptr(), cu.data_ptr(), bt.data_ptr(), pk,
            pk, 1, 1, P, 1, 8, 8, 128, 16, Lp, 1, 0.1, qt, kt, stages,
            splits, chunk, 0, *(0,) * 9, 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"paged_attention {what} not refused: "
                                 f"{err}")
        print(f"refused paged_attention plan with {what}: cudaError_t 1")
    # the masks' arguments (mask, heads, rows, columns, tgt_mask, ...,
    # seq_lens_encoder) under a plan the entry takes
    m = torch.zeros(1, 1, 1, 16, device=dev).data_ptr()
    for what, mk in (
            ("a mask without seq_lens_encoder", (m, 1, 1, 16, 0, 0, 0, 0, 0)),
            ("a mask of 2 heads for 8",
             (0, 0, 0, 0, m, 2, 1, 16, z.data_ptr()))):
        err = _build.lib().ptt_paged_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), one.data_ptr(), cu.data_ptr(), bt.data_ptr(), None,
            None, 1, 1, 1, 1, 8, 8, 128, 16, 0, 1, 0.1, 1, 64, 2, 1, 64, 0,
            *mk, 1, 1, torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"paged_attention {what} not refused: "
                                 f"{err}")
        print(f"refused paged_attention with {what}: cudaError_t 1")
    # the entry takes a cache of q's dtype or bfloat16 under float32 (C12);
    # a bfloat16 q over float32 pools is the wrapper's to widen
    kv32 = kv.float()
    err = _build.lib().ptt_paged_attention(
        q.data_ptr(), kv32.data_ptr(), kv32.data_ptr(), q.data_ptr(),
        z.data_ptr(), one.data_ptr(), cu.data_ptr(), bt.data_ptr(), None,
        None, 1, 1, 1, 1, 8, 8, 128, 16, 0, 1, 0.1, 1, 64, 2, 1, 64, 0,
        *(0,) * 9, 1, 0, torch.cuda.current_stream().cuda_stream)
    if err != 1:
        raise AssertionError(f"paged_attention's entry took a bfloat16 q "
                             f"over float32 pools: {err}")
    print("refused paged_attention's entry with a bfloat16 q over float32 "
          "pools: cudaError_t 1 (the wrapper widens q)")
    # every other kernel keeps launch_args' one dtype for all its inputs
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    try:
        ring = torch.ones(1, 16, 8, 128, device=dev)
        da.decode_attention(q.view(1, 1, 8, 128), ring, ring,
                            torch.zeros((), dtype=torch.int32, device=dev))
    except ValueError as e:
        if "one device and dtype" not in str(e):
            raise
        print(f"refused decode_attention bfloat16 q over a float32 ring: "
              f"{e}")
    else:
        raise AssertionError("decode_attention took a float32 ring under a "
                             "bfloat16 q")
    # a head dim past 512 (C8, closed): every attention kernel computes
    # it (the wide instances), held to its plain version
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(520)
    pos = torch.full((), 40, dtype=torch.int32, device=dev)
    for kdt in (dt, torch.float32):
        dname = str(kdt).split(".")[1]

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev, dtype=kdt)

        wide, go = rnd(1, 16, 2, 520), rnd(1, 16, 2, 520)
        ring, pool = rnd(1, 64, 2, 520), rnd(1, 2, 16, 520)
        o, lse = fa.flash_attention_fused(wide, wide, wide, True)
        s = 1.0 / 520 ** 0.5
        paged = (wide[0, :1], pool, pool, z, one, cu, bt[:, :1], 1)
        for label, kern, plain in (
                ("flash_attention",
                 lambda: fa.flash_attention_fused(wide, wide, wide, True),
                 lambda: fa._plain_bshd(wide, wide, wide, True, s, None)),
                ("flash_attention_bwd",
                 lambda: fa.flash_attention_bwd_fused(wide, wide, wide, o,
                                                      lse, go, True),
                 lambda: fa._plain_bwd_bshd(wide, wide, wide, o, lse, go,
                                            True, s)),
                ("decode_attention",
                 lambda: da.decode_attention(wide[:, :1], ring, ring, pos),
                 lambda: da.ref_decode_attention(wide[:, :1], ring, ring,
                                                 pos)),
                ("paged_attention", lambda: pa.paged_attention(*paged),
                 lambda: pa._paged_attention_ref(*paged))):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if not isinstance(ref, tuple):
                got, ref = (got,), (ref,)
            for a, b in zip(got, ref):
                err, tol = _err(torch, a, b), _tol(dname, b)
                if not err <= tol:
                    raise AssertionError(f"{label} {dname} head_dim 520: "
                                         f"kernel and plain differ by {err}"
                                         f" > {tol}")
            print(f"computed {label} {dname} head_dim 520 (refused before "
                  "Queue C8): within the tolerance of the plain version")
    q = torch.ones(1, 1, 8, 128, dtype=dt, device=dev)
    kv = torch.ones(1, 512, 8, 128, dtype=dt, device=dev)
    # (splits, ring rows, dtype code)
    for what, (splits, L, code) in {
            "16 splits": (16, 512, 1),
            "3 splits": (3, 512, 1),
            "more splits than key tiles": (8, 448, 1),
            "float16": (1, 512, 2)}.items():
        err = _build.lib().ptt_decode_attention(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
            z.data_ptr(), 1, L, 8, 8, 128, 0.1, splits, code,
            torch.cuda.current_stream().cuda_stream)
        if err != 1:
            raise AssertionError(f"decode_attention {what} not refused: "
                                 f"{err}")
        print(f"refused decode_attention plan with {what}: cudaError_t 1")
    # the C dispatch refuses a flash tile pair it has no instance for
    # (cudaErrorInvalidValue, 1; the wrapper refuses it first, so the entry
    # is called directly)
    from paddle_tpu_torch.ops.hopper import _build
    x = torch.zeros(1, 64, 1, 64, dtype=dt, device=dev)
    lse = torch.zeros(1, 1, 64, device=dev)
    err = _build.lib().ptt_flash_attention(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), None, 1, 64, 64, 1, 1, 64, *x.stride()[:3],
        *x.stride()[:3], *x.stride()[:3], 0, 0, 0.125, 32, 32, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 1:
        raise AssertionError(f"flash tiles (32, 32) not refused: {err}")
    print("refused flash_attention bf16 tiles (32, 32): cudaError_t 1")
    # B7 takes float32 or bfloat16 x and int8 weights, nothing else
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul
    q8 = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    s8 = torch.ones(32, device=dev)
    for label, call in {
            "int8_matmul float16 x": lambda: int8_matmul(
                torch.ones(4, 64, dtype=torch.float16, device=dev), q8, s8),
            "int8_matmul int32 qw": lambda: int8_matmul(
                torch.ones(4, 64, dtype=dt, device=dev), q8.int(), s8)
    }.items():
        try:
            call()
        except TypeError as e:
            print(f"refused {label}: {e}")
        else:
            raise AssertionError(f"{label} was not refused")
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 3
def _counters():
    """The kernel wrappers that count their launches, from the package (a
    CUDA graph's replay adds its captured counts to the same ones)."""
    from paddle_tpu_torch.ops.hopper import launch_counters

    return launch_counters()


def _zero_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["int8_matmul"].bias_launches = 0   # B7 with the bias fused
    for name in ("paged_attention", "paged_attention_int8"):
        counters[name].mask_launches = 0        # the masked instances
    return counters


def _path_launches(path, counters):
    """Read the counters after a path's run; raise if one of its kernels
    never launched."""
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"launches {path} {json.dumps(launches)}")
    for k in PATHS[path]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 f"{path} path")
    return launches


def _serve_waves(eng, waves, logprobs=None):
    """Run each wave of (prompt, max_new_tokens, sampling) to completion;
    check every request returned its token count.  ``logprobs``, a list,
    gets each request's logprobs (None where it asked for none)."""
    out = []
    for wave in waves:
        rids = [eng.add_request(p, max_new_tokens=n, sampling=s)
                for p, n, s in wave]
        done = eng.run()
        eng.pop_finished()
        lps = eng.pop_token_logprobs()
        for rid, (_, n, _) in zip(rids, wave):
            if len(done[rid]) != n:
                raise AssertionError(f"request {rid} returned "
                                     f"{len(done[rid])} of {n} tokens")
            out.append(done[rid])
            if logprobs is not None:
                logprobs.append(lps.get(rid))
    return out


def _step_meter(torch, eng):
    """Meter ``eng``'s single steps: a dict that counts the ``step()``
    calls that ran the single-step program (``steps``), their
    ``phase_seconds["execute"]`` (``execute``, seconds: the program and
    its one read-back) and the runs of ``_run_step`` outside a CUDA graph
    capture (``eager``: on graphs only a key's first call; on the eager
    loops every step)."""
    meter = {"steps": 0, "execute": 0.0, "eager": 0}
    step, graphed, run_step = eng.step, eng._graphed, eng._run_step
    ran = [False]

    def graphed_(key, fn, arrays):
        ran[0] = ran[0] or key[0] == "step"
        return graphed(key, fn, arrays)

    def run_step_(*args):
        if not torch.cuda.is_current_stream_capturing():
            meter["eager"] += 1
        return run_step(*args)

    def step_():
        ran[0] = False
        t0 = eng.phase_seconds["execute"]
        out = step()
        if ran[0]:
            meter["steps"] += 1
            meter["execute"] += eng.phase_seconds["execute"] - t0
        return out

    eng.step, eng._graphed, eng._run_step = step_, graphed_, run_step_
    return meter


def _metered(meter, fn, out):
    """``fn`` wrapped: each call leaves in ``out`` how far ``meter`` moved
    over it."""
    def run():
        m0 = dict(meter)
        fn()
        out.update({k: meter[k] - m0[k] for k in meter})
    return run


def _step_report(where, label, waves, graphs):
    """Print each wave's single steps (their count, execute ms, eager runs
    of ``_run_step``); on graphs a timed wave must run none eagerly (every
    step key was captured in an earlier wave)."""
    for name, d in waves.items():
        print(f"single steps in the {name} {where}, {label}: {d['steps']} "
              f"steps, execute {d['execute'] * 1e3:.2f} ms "
              f"({d['execute'] * 1e3 / max(d['steps'], 1):.2f} ms a step), "
              f"{d['eager']} eager runs of the step program")
        if graphs and name != "first" and d["eager"]:
            raise AssertionError(f"{where}, {label}: {d['eager']} eager "
                                 f"single steps in the {name} wave")


def _sync_free(torch, loop):
    """Run ``loop`` with CUDA sync debugging set to raise: any operation
    that waits for the device inside it (``.item()``, a device-to-host
    copy) is an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def full_width_model(torch):
    """Llama-2-7B geometry in bfloat16, seeded random weights, on cuda."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    t = time.perf_counter()
    model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama_7b: {n_params} parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16, init seconds "
          f"{time.perf_counter() - t:.3f}")
    return model


def full_width_serving(torch, model):
    """Phase 3: the 7B geometry served through CUDA graphs (the engine's
    default on CUDA) and, over the same model (the same weight tensors, a
    KV pool of its own), through the eager loops (``_graphs = False``):
    the same waves give identical tokens, logprobs and scheduling
    counters; then the decode wave on each, untraced and profiled."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    eng = ServingEngine(model, **SERVE_KW)
    eager = ServingEngine(model, **SERVE_KW)
    eager._graphs = False
    kv_gb = sum(c.numel() * c.element_size()
                for c in eng.key_caches + eng.value_caches) / 1e9
    print(f"KV pool {eng.blocks.num_blocks} blocks, {kv_gb:.2f} GB (one "
          "for each engine)")
    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    greedy = dict(logprobs=True)
    sampled = dict(temperature=0.8, top_p=0.9, seed=7, logprobs=True)
    lens = [7, 40, 128, 200, 260, 33, 400, 90, 150]
    news = [48, 32, 64, 40, 56, 1, 36, 60, 44]
    wave1 = [(prompt(n), m, sampled if i == 3 else greedy)
             for i, (n, m) in enumerate(zip(lens, news))]
    wave2 = [(wave1[2][0], 32, greedy), (prompt(70), 40, greedy)]
    # no host sync inside a device program (the eager loops and steps, a
    # key's first call and its capture) or a replay (main): each raises on
    # one
    for e in (eng, eager):
        for name in ("_run_megastep", "_run_mixed", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    replays0 = _REPLAYS[0]
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(eng, [wave1], lps)
    torch.cuda.synchronize()
    wave1_s = time.perf_counter() - t
    outs += _serve_waves(eng, [wave2], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("serving", counters)
    st = eng.state_summary()
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {n_tok} tokens in {secs:.3f} s "
          f"({n_tok / secs:.1f} tokens/s, informative); wave 1 (one "
          f"sampled request) {wave1_s:.3f} s; {_REPLAYS[0] - replays0} "
          "graph replays, each under CUDA sync debugging set to raise")
    print(f"megastep {st['megastep']} prefill_tokens_computed "
          f"{eng.prefill_tokens_computed} prefix_hit_blocks "
          f"{eng.prefix_hit_blocks}")
    print(f"phase_seconds {json.dumps(st['phase_seconds'])}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    if not (eng.megasteps > 0 and eng.megasteps_mixed > 0
            and eng.prefix_hit_blocks > 0):
        raise AssertionError("the serving run did not arm the megastep, the "
                             "mixed loop and the prefix cache")
    for o in outs:
        if any(not 0 <= t < cfg.vocab_size for t in o):
            raise AssertionError("token outside the vocabulary")
    cache = eng._graph_cache
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not (eng.compile_count == cache.captures == len(cache.seconds)
            == len(cache.graphs) > 0 and eager.compile_count == 0):
        raise AssertionError(f"compile_count {eng.compile_count} is not the "
                             f"{len(cache.seconds)} graphs captured")
    # the eager loops over the same waves: identical
    e_lps = []
    t = time.perf_counter()
    e_outs = _serve_waves(eager, [wave1, wave2], e_lps)
    torch.cuda.synchronize()
    e_secs = time.perf_counter() - t
    names = ("megasteps", "megasteps_mixed", "prefill_chunks",
             "prefix_hit_blocks")
    got = [getattr(eng, n) for n in names]
    want = [getattr(eager, n) for n in names]
    if outs != e_outs or lps != e_lps or got != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"graphs and eager loops differ: tokens of "
                             f"requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}")
    print(f"graphs == eager: tokens, logprobs and {names} {got} identical "
          f"over {len(outs)} requests (the sampled one too); compile_count "
          f"{eng.compile_count} (eager 0); served in {secs:.3f} s with "
          f"graphs, {e_secs:.3f} s eager (informative)")
    # the decode-heavy wave on each engine (8 rows, 64-token prompts, 32 new
    # tokens each): a first wave captures the keys it adds (its wall
    # printed), then the untraced wall of the next, then K4's kernels in
    # the traced one against its wrapper's count there (one launch per
    # call; a replay adds its captured count)
    waves = [[(prompt(64), 32, None) for _ in range(8)] for _ in range(3)]
    for label, e in (("graphs", eng), ("eager", eager)):
        calls = []
        meter = _step_meter(torch, e)
        stepped = {"first": {}, "untraced": {}, "traced": {}}

        def traced(e=e):
            n0 = pa.paged_attention.launches
            _serve_waves(e, [waves[2]])
            calls.append(pa.paged_attention.launches - n0)

        n_cap = e.compile_count
        torch.cuda.synchronize()
        t = time.perf_counter()
        _metered(meter, lambda e=e: _serve_waves(e, [waves[0]]),
                 stepped["first"])()
        torch.cuda.synchronize()
        print(f"decode wave, {label}, first: wall "
              f"{(time.perf_counter() - t) * 1e3:.2f} ms, "
              f"{e.compile_count - n_cap} graphs captured in it")
        n_cap = e.compile_count
        torch.cuda.reset_peak_memory_stats()
        evs = _profile(torch, f"decode wave, {label} (8 rows, 64-token "
                       "prompts, 32 new tokens)",
                       _metered(meter, lambda e=e: _serve_waves(e, [waves[1]]),
                                stepped["untraced"]),
                       _metered(meter, traced, stepped["traced"]), top=15)
        _step_report("decode wave", label, stepped, e is eng)
        print(f"memory decode wave, {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, memory_reserved "
              f"{torch.cuda.memory_reserved()} bytes; graphs captured in "
              f"the measured waves {e.compile_count - n_cap}")
        _k1_k2(evs, f"the decode wave, {label}")
        k4 = [ev for ev in evs if "paged_attention" in ev.key]
        k4_n = sum(ev.count for ev in k4)
        k4_ms = sum(ev.self_device_time_total for ev in k4) / 1e3
        print(f"profile K4 in the decode wave, {label}: {k4_ms:.3f} ms "
              f"device, {k4_n} kernels, {calls[-1]} wrapper calls")
        if k4_n != calls[-1]:
            raise AssertionError(f"K4 ({label}): {k4_n} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([ev.key for ev in k4], f"K4 in the decode wave, {label}")
    _draw_cost(torch, cfg.vocab_size)
    return launches


def _draw_cost(torch, V):
    """CUDA-event time of one sampling step of the engine (8 rows of
    float32 logits, V wide) with one seeded sampled row (top-k 0, top-p
    0.9, temperature 0.8) against the same step all greedy, and of the
    threefry draw alone."""
    from paddle_tpu_torch.inference.serving import _draw, _sample_tokens

    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    B = 8
    lg = torch.randn(B, V, generator=g, device="cuda") * 3
    temps = torch.zeros(B, device="cuda")
    temps[3] = 0.8
    top_ks = torch.zeros(B, dtype=torch.int32, device="cuda")
    top_ps = torch.full((B,), 0.9, device="cuda")
    seeds = torch.arange(B, dtype=torch.int32, device="cuda")
    spos = torch.full((B,), 17, dtype=torch.int32, device="cuda")
    timer = Timer(torch, 20)
    sampled = timer(lambda: _sample_tokens(lg, temps, top_ks, top_ps, seeds,
                                           spos, all_greedy=False))
    greedy = timer(lambda: _sample_tokens(lg, temps, top_ks, top_ps, seeds,
                                          spos, all_greedy=True))
    draw = timer(lambda: _draw(lg, seeds, spos))
    print(f"sampling step [{B}, {V}]: one sampled row {sampled:.4f} ms, all "
          f"greedy {greedy:.4f} ms, threefry draw alone {draw:.4f} ms")


def _unmasked(names, label):
    """Raise unless each of the profiled K4 / K4-int8 kernel ``names`` is
    an unmasked instance, its last template argument (kMask) false: the
    serving engines pass no mask, so they launch what they did before the
    masks."""
    import re

    instances = set()
    for name in names:
        m = re.search(r"paged_attention\w*<([^<>]*)>", name)
        if m is None or m.group(1).rsplit(",", 1)[-1].strip() != "false":
            raise AssertionError(f"{label}: not an unmasked instance: "
                                 f"{name[:200]}")
        instances.add(m.group(0))
    print(f"{label}: every kernel unmasked (kMask false): "
          f"{', '.join(sorted(instances))}")


def _profile(torch, label, untraced, traced=None, top=12, trace=None):
    """Run ``untraced()`` on the host clock (wall time), then ``traced()``
    (the same call by default) under torch.profiler: the device's busy share
    of the untraced wall time (one stream, so kernel times do not overlap;
    the trace's own wall time is inflated by the profiler) and device time
    by kernel.

    The profiler can lose a run of device records at the start or the end
    of a session (on an H100: all 64 marker kernels and the next 14 of a
    process's second session; 14 of 992 B2 kernels of phase 5's
    greedy_decode; 132 trailing markers of phase 3's wave).  So the
    traced call sits between ``_PROFILE_MARKS`` spin kernels on each side,
    synchronized, and a trace counts only when some of the markers on each
    side were recorded: then no kernel of the call was lost at an end.
    Otherwise the trace is taken again, ``_PROFILE_TAKES`` times at most.
    ``trace``, a list, gets the kept trace's device kernels (markers
    excluded) in the order they started."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA

    def marks():
        for _ in range(_PROFILE_MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t = time.perf_counter()
    untraced()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    for take in range(1, _PROFILE_TAKES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marks()
            (traced or untraced)()
            torch.cuda.synchronize()
            marks()
        kernels = [e for e in prof.events() if e.device_type == cuda]
        spins = [e.time_range.start for e in kernels
                 if "spin_kernel" in e.name]
        work = [e.time_range.start for e in kernels
                if "spin_kernel" not in e.name]
        before = sum(s < min(work) for s in spins) if work else 0
        after = sum(s > max(work) for s in spins) if work else 0
        print(f"profile {label}, take {take}: {before} and {after} of "
              f"{_PROFILE_MARKS} marker kernels recorded before and after "
              "the call")
        if before and after:
            break
    else:
        raise AssertionError(f"profile {label}: the profiler lost the "
                             f"markers at an end of {_PROFILE_TAKES} traces")
    if trace is not None:
        trace.extend(sorted((e for e in prof.events()
                               if e.device_type == cuda
                               and "spin_kernel" not in e.name),
                              key=lambda e: e.time_range.start))
    evs = [e for e in prof.key_averages()
           if e.device_type == cuda and "spin_kernel" not in e.key]
    dev_us = sum(e.self_device_time_total for e in evs)
    print(f"profile {label}: untraced wall {wall_us / 1e3:.2f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms ({100 * dev_us / wall_us:.1f}%), "
          f"{sum(e.count for e in evs)} device kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d}  {e.key[:90]}")
    return evs


def _k1_k2(evs, where):
    """K1's and K2's device time, kernel count and time a launch in a
    profile, by kernel name (also where they miss the top of the list)."""
    for name, kernel in (("K1", "rms_kernel"), ("K2", "rope_kernel")):
        mine = [e for e in evs if kernel in e.key]
        n = sum(e.count for e in mine)
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        print(f"profile {name} ({kernel}) in {where}: {ms:.3f} ms device, "
              f"{n} kernels, {1e3 * ms / max(n, 1):.2f} us a launch")


# --------------------------------------------------------------- phase 4
def _first_step_logits(torch, eng, prompts):
    """Logits of the first (all-prefill) step of ``prompts`` on a fresh
    engine: one packed buffer, every row prefilled from position 0."""
    import numpy as np

    for p in prompts:
        eng.add_request(p, max_new_tokens=1)
    eng._try_admit()
    B = eng.B
    now = np.zeros(B, np.int32)
    for req in eng._active.values():
        now[req.slot] = len(req.prompt)
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    tokens = np.zeros(eng.T, np.int32)
    for req in eng._active.values():
        tokens[cu[req.slot]:cu[req.slot + 1]] = req.prompt
    d = eng._dev
    with torch.no_grad():
        return eng._forward(d(tokens), d(now), d(np.zeros(B, np.int32)),
                            d(now), d(cu), d(eng.block_tables),
                            eng.T).float().cpu()


def _forced_trunk(torch, eng, seq):
    """The trunk's output [T, E] with ``seq`` prefilled from position 0 on
    a fresh engine (teacher forcing)."""
    import numpy as np

    eng.add_request(seq, max_new_tokens=1)
    eng._try_admit()
    n = len(seq)
    z = np.zeros(eng.B, np.int32)
    now = z.copy()
    now[0] = n
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    tokens = np.zeros(eng.T, np.int32)
    tokens[:n] = seq
    d = eng._dev
    return eng._trunk(d(tokens), d(now), d(z), d(now), d(cu),
                      d(eng.block_tables), eng.T)


def _top2_gaps(torch, eng, prompt, gen):
    """CPU teacher-forced logits of prompt + gen[:-1] on a fresh engine ->
    the top-2 logit gap at each generated position."""
    seq = list(prompt) + list(gen[:-1])
    h = _forced_trunk(torch, eng, seq)
    lg = (h[len(prompt) - 1:len(seq)] @ eng._weights["head"]).float()
    top2 = torch.topk(lg, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _logits_at(torch, eng, prompt, gen):
    """The float32 logits [V] after prompt + gen, teacher-forced on a fresh
    engine: the row from which the next token is chosen."""
    seq = list(prompt) + list(gen)
    with torch.no_grad():
        h = _forced_trunk(torch, eng, seq)
        return (h[len(seq) - 1] @ eng._weights["head"]).float().cpu()


def _agree(a, b, gaps, what, thresh=1e-3):
    """Tokens equal up to the first position whose top-2 gap < thresh."""
    stop = next((i for i, g in enumerate(gaps) if g < thresh), len(gaps))
    if stop < len(gaps):
        print(f"{what}: top-2 gap {gaps[stop]:.2e} < {thresh:.1e} at "
              f"position {stop}; compared positions 0..{stop - 1}")
    if a[:stop] != b[:stop]:
        raise AssertionError(f"{what}: tokens differ before position {stop}:"
                             f" {a[:stop]} vs {b[:stop]}")


# the head dims the tensor-core classes do not hold (640: past 512, the
# wide instances): head_dim -> (hidden, heads, intermediate) of a 2-layer
# float32 Llama (phases 4, 6 and 8), with
# a 4096-token vocabulary: random weights at these widths give logits
# below 1, and over 32000 tokens the top-2 gaps fall under the 1e-3 at
# which the token comparisons stop
HEAD_DIM_LLAMAS = {72: (576, 8, 1536), 100: (800, 8, 2048),
                   264: (1056, 4, 2816), 640: (1280, 2, 3456)}


def two_layer_models(torch, head_dim=None, seed=1):
    """The 7B geometry at 2 layers in float32 (or, with ``head_dim``, the
    2-layer Llama of ``HEAD_DIM_LLAMAS``), on cuda and on the CPU, with
    identical weights from ``seed`` (phases 4, 6 and 8)."""
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        llama_7b,
        load_numpy_state_dict,
    )

    if head_dim is None:
        cfg = llama_7b(dtype="float32", num_hidden_layers=2)
    else:
        hidden, heads, inter = HEAD_DIM_LLAMAS[head_dim]
        cfg = llama_7b(dtype="float32", num_hidden_layers=2,
                       hidden_size=hidden, num_attention_heads=heads,
                       intermediate_size=inter, vocab_size=4096)
        assert cfg.head_dim == head_dim
    gpu_model = LlamaForCausalLM(cfg, seed=seed)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    load_numpy_state_dict(cpu_model, {k: v.cpu().numpy() for k, v in
                                      gpu_model.state_dict().items()})
    return gpu_model, cpu_model


def kernels_vs_plain_path(torch, gpu_model, cpu_model, cache_dtype=None):
    """Engines on cuda (kernels) against engines on the CPU (plain
    versions) over the same weights: first-step logits and greedy tokens;
    ``cache_dtype`` gives every engine a KV cache of that dtype (C12)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = gpu_model.config
    engine_kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
                     token_budget=128)
    if cache_dtype is not None:
        engine_kw["cache_dtype"] = cache_dtype
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 48, 20)]
    # first-step logits: kernels on cuda vs plain on the CPU.  float32
    # logits of magnitude ~50 after two layers: XLA-free but differently
    # ordered sums (cuBLAS vs MKL, the kernels' reductions)
    lg_gpu = _first_step_logits(torch, ServingEngine(gpu_model, **engine_kw),
                                prompts)
    lg_cpu = _first_step_logits(
        torch, ServingEngine(cpu_model, device="cpu", **engine_kw), prompts)
    err = float((lg_gpu - lg_cpu).abs().max())
    scale = float(lg_cpu.abs().max())
    # bfloat16: both sides round every projection to bf16 after summing in
    # their own orders; logits within four bf16 steps of the largest
    # |logit|, tokens compared up to the first position whose CPU top-2
    # gap is under two such steps
    bf16 = cfg.dtype == "bfloat16"
    tol = 2 ** -5 * scale if bf16 else 1e-3 * scale + 1e-3
    thresh = 2 ** -6 * scale if bf16 else 1e-3
    print(f"first-step logits: max_abs_err {err:.3e} tol {tol:.3e} "
          f"(max |logit| {scale:.3f})")
    if not err <= tol:
        raise AssertionError("first-step logits differ beyond tolerance")
    # greedy serving, 16 new tokens each; the repeat of prompt 1 comes
    # after the first wave retired, so it hits the prefix cache
    waves = [[(p, 16, None) for p in prompts], [(prompts[1], 16, None)]]
    gpu = _serve_waves(ServingEngine(gpu_model, **engine_kw), waves)
    cpu = _serve_waves(ServingEngine(cpu_model, device="cpu", **engine_kw),
                       waves)
    off_eng = ServingEngine(gpu_model, prefix_cache=False, **engine_kw)
    gpu_off = _serve_waves(off_eng, waves)
    flat = [p for w in waves for p, _, _ in w]
    for i, p in enumerate(flat):
        gaps = _top2_gaps(torch, ServingEngine(cpu_model, device="cpu",
                                               **engine_kw), p, cpu[i])
        _agree(gpu[i], cpu[i], gaps, f"request {i} cuda vs cpu", thresh)
        _agree(gpu[i], gpu_off[i], gaps,
               f"request {i} prefix cache on vs off", thresh)
    print(f"kernel path == plain path on {len(flat)} requests "
          f"(prefix hit blocks on cuda: repeat served)")


def _bf16_pair(torch, seed=3):
    """The 7B geometry at 2 layers in bfloat16, on cuda and on the CPU,
    with identical weights from ``seed`` (phase 4's C12 engines)."""
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        llama_7b,
        load_numpy_state_dict,
    )

    cfg = llama_7b(dtype="bfloat16", num_hidden_layers=2)
    gpu_model = LlamaForCausalLM(cfg, seed=seed)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    # bf16 values widen to float32 exactly and narrow back unchanged
    load_numpy_state_dict(cpu_model, {k: v.float().cpu().numpy() for k, v in
                                      gpu_model.state_dict().items()})
    return gpu_model, cpu_model


def mixed_cache_vs_plain(torch, f32_pair):
    """Phase 4's C12 engines: the 2-layer float32 pair over a bfloat16
    cache (K4's float32 q over bf16 pools) and a 2-layer bfloat16 pair over
    a float32 cache (a bf16 q widened by the wrapper), each on cuda held to
    the CPU engine of the same cache_dtype (``kernels_vs_plain_path``)."""
    print("-- float32 engine over a bfloat16 cache")
    kernels_vs_plain_path(torch, *f32_pair, cache_dtype="bfloat16")
    print("-- bfloat16 engine over a float32 cache")
    kernels_vs_plain_path(torch, *_bf16_pair(torch), cache_dtype="float32")


# phase 4's full-width C12 run: Llama-2-7B widths in float32 cut to 4
# layers (32 float32 layers take 27 GB), over a bfloat16 cache
MIXED_LAYERS = 4


def full_width_mixed_cache(torch, card):
    """Phase 4's C12 run at full width: the 7B widths in float32 at
    ``MIXED_LAYERS`` layers (seed 4) over a bfloat16 KV cache, 8 requests
    (one sampled, each with logprobs) served through CUDA graphs and by
    an eager twin over the same weights (``_graphs = False``): tokens and
    logprobs equal bit for bit; the kernel launches of the graph run are
    the "mixed_cache" path; a profiled wave's K4 kernels are the mixed
    instance (float q over __nv_bfloat16 pools) and unmasked."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b

    model = LlamaForCausalLM(llama_7b(dtype="float32",
                                      num_hidden_layers=MIXED_LAYERS), seed=4)
    eng = ServingEngine(model, cache_dtype="bfloat16", **SERVE_KW)
    eager = ServingEngine(model, cache_dtype="bfloat16", **SERVE_KW)
    eager._graphs = False
    kv = sum(c.numel() * c.element_size()
             for c in eng.key_caches + eng.value_caches)
    print(f"mixed cache: float32 model ({MIXED_LAYERS} layers), bfloat16 "
          f"KV pool of {kv / 1e9:.3f} GB (a float32 pool: "
          f"{2 * kv / 1e9:.3f} GB)")
    for e in (eng, eager):
        for name in ("_run_megastep", "_run_mixed", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    rng = np.random.default_rng(12)
    greedy = dict(logprobs=True)
    sampled = dict(temperature=0.8, top_p=0.9, seed=12, logprobs=True)
    lens = [9, 33, 64, 120, 200, 17, 80, 300]
    news = [32, 24, 40, 16, 32, 8, 28, 20]
    wave = [(rng.integers(1, model.config.vocab_size, n).tolist(), m,
             sampled if i == 2 else greedy)
            for i, (n, m) in enumerate(zip(lens, news))]
    counters = _zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(eng, [wave], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("mixed_cache", counters)
    if counters["paged_attention"].mask_launches:
        raise AssertionError("mixed cache: a masked K4 instance launched")
    e_lps = []
    t = time.perf_counter()
    e_outs = _serve_waves(eager, [wave], e_lps)
    torch.cuda.synchronize()
    e_secs = time.perf_counter() - t
    if outs != e_outs or lps != e_lps:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"mixed cache: graphs and eager differ: tokens "
                             f"of requests {bad}, logprobs equal "
                             f"{lps == e_lps}")
    n_tok = sum(len(o) for o in outs)
    print(f"mixed cache graphs == eager: tokens and logprobs identical over "
          f"{len(outs)} requests ({n_tok} tokens, one sampled); "
          f"{eng.compile_count} graphs captured; {secs:.3f} s on graphs "
          f"(captures inside), {e_secs:.3f} s eager ({card}, informative)")
    probe = [[(rng.integers(1, model.config.vocab_size, 64).tolist(), 16,
               None) for _ in range(8)]]
    _serve_waves(eng, probe)            # the keys this wave takes, captured
    evs = _profile(torch, "mixed cache decode wave (8 rows, 64-token "
                   "prompts, 16 new tokens, graphs)",
                   lambda: _serve_waves(eng, probe),
                   lambda: _serve_waves(eng, probe), top=8)
    k4 = [ev.key for ev in evs if "paged_attention" in ev.key]
    if not k4 or not all("float, __nv_bfloat16" in k for k in k4):
        raise AssertionError(f"mixed cache: K4 kernels {k4}")
    _unmasked(k4, "K4 in the mixed-cache wave")
    return launches


def _load_weights_on_graphs(torch, gpu_model, other):
    """A graph engine that served ``gpu_model``, after ``load_weights(other)``
    (the same geometry, other weights): its graphs are dropped (they read
    the old weights), it captures again, and it serves ``other``'s tokens,
    those of a fresh graph engine over ``other`` (the same kernels on the
    same card: identical)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128)
    rng = np.random.default_rng(23)
    V = gpu_model.config.vocab_size
    waves = [[(rng.integers(1, V, n).tolist(), 16, None)
              for n in (9, 33, 48)], [(rng.integers(1, V, 5).tolist(), 16,
                                       None)]]
    eng = ServingEngine(gpu_model, **kw)
    old = _serve_waves(eng, waves)
    n = eng.compile_count
    eng.load_weights(other, version="v1")
    if eng._graph_cache.graphs or eng.compile_count != n or not n:
        raise AssertionError(f"load_weights kept "
                             f"{len(eng._graph_cache.graphs)} "
                             f"graphs (compile_count {n} -> "
                             f"{eng.compile_count})")
    got = _serve_waves(eng, waves)
    want = _serve_waves(ServingEngine(other, **kw), waves)
    if got != want or got == old or eng.compile_count <= n:
        raise AssertionError("after load_weights the graph engine does not "
                             "serve the new weights' tokens")
    print(f"load_weights: graphs dropped and captured again (compile_count "
          f"{n} -> {eng.compile_count}); the new weights' tokens on "
          f"{len(got)} requests")


# --------------------------------------------------------------- phase 5
def _forced_logits(torch, model, ids, toks, static):
    """Last-position logits [B, n, V] (float32) of the prefill and of each
    decode step fed ``toks[:, :-1]``: the logits from which a decode loop
    picked ``toks``, through the ring (static) or growing caches."""
    from paddle_tpu_torch.models.generation import _QKV, _ring_length, _Rings

    B, S = ids.shape
    n = toks.shape[1]
    cfg = model.config
    if static:
        rings = _Rings(model, B, _ring_length(model, S, n, None),
                       _QKV(model))

        def fwd(x):
            return rings.forward(model, x)
    else:
        dt = model.llama.embed_tokens.weight.dtype
        z = torch.zeros((B, 0, cfg.num_key_value_heads, cfg.head_dim),
                        dtype=dt, device=ids.device)
        caches = [(z, z) for _ in range(cfg.num_hidden_layers)]

        def fwd(x):
            nonlocal caches
            logits, caches = model(x, caches=caches)
            return logits
    out = []
    with torch.no_grad():
        out.append(fwd(ids)[:, -1].float())
        for i in range(n - 1):
            out.append(fwd(toks[:, i:i + 1])[:, -1].float())
    return torch.stack(out, dim=1)


def _gaps(torch, logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().tolist()


def full_width_generation(torch, model):
    """Phase 5 on the 7B model; returns the generation path's launches."""
    from paddle_tpu_torch.framework.random import Generator
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    V = model.config.vocab_size
    g = torch.Generator(device="cuda")
    g.manual_seed(5)

    def ids(B, S):
        return torch.randint(1, V, (B, S), generator=g, device="cuda")

    def in_vocab(toks, what):
        if not bool(((toks >= 0) & (toks < V)).all()):
            raise AssertionError(f"{what}: token outside the vocabulary")

    p2, p8, p4 = ids(2, 1024), ids(8, 128), ids(4, 200)
    torch.cuda.synchronize()
    counters = _zero_counters()
    t = time.perf_counter()
    with torch.no_grad():
        logits = model(p2)
    if logits.shape != (2, 1024, V) or not bool(torch.isfinite(
            logits).all()):
        raise AssertionError(f"forward logits {tuple(logits.shape)} are not "
                             "finite [2, 1024, V]")
    print(f"(a) forward [2, 1024]: {time.perf_counter() - t:.3f} s, "
          f"logits finite")
    del logits
    # B2's kernels in the traced loop, against its wrapper's count there
    # (one launch per call; a replay adds its captured count)
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import fused_ops as fo

    runs = {}
    for mode in ("eager", "graphs"):
        model._graphs = mode == "graphs"
        # earlier phases' objects held in reference cycles go now, not
        # during the loop (the peak is measured from here)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if model._graphs:
            # the key's first call synchronises and captures: warm it
            # before the sync-free loop and the untraced timing
            t = time.perf_counter()
            greedy_decode(model, p8, max_new_tokens=2, max_length=512)
            torch.cuda.synchronize()
            first, cap = model._decode_graphs.seconds[("decode", 8, 512)]
            print(f"(b) graphs: key (8, 512) warmed in "
                  f"{time.perf_counter() - t:.3f} s: first call (eager "
                  f"step) {first * 1e3:.1f} ms, capture {cap * 1e3:.1f} ms")
        t = time.perf_counter()
        toks = _sync_free(torch, greedy_decode)(model, p8,
                                               max_new_tokens=128,
                                               max_length=512)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        in_vocab(toks, "greedy_decode")
        print(f"(b) {mode}: greedy_decode [8, 128] + 128 tokens, ring 512: "
              f"{secs:.3f} s ({8 * 128 / secs:.1f} tokens/s, informative), "
              "no host sync inside the loop")
        calls = []

        def traced():
            n0 = (da.decode_attention.launches, fo.rope_ring_fused.launches,
                  fo.rope_fused.launches, da.kv_ring_write.launches)
            out = greedy_decode(model, p8, max_new_tokens=32, max_length=512)
            calls.append([n - m for n, m in zip(
                (da.decode_attention.launches, fo.rope_ring_fused.launches,
                 fo.rope_fused.launches, da.kv_ring_write.launches), n0)]
                + [out])

        evs = _profile(torch, f"greedy_decode [8, 128] + 32 tokens, {mode}",
                       lambda: greedy_decode(model, p8, max_new_tokens=32,
                                             max_length=512), traced)
        n_kernels = sum(e.count for e in evs)
        print(f"profile greedy_decode, {mode}: {n_kernels} kernels in the "
              f"trace; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, memory_allocated "
              f"after {torch.cuda.memory_allocated()} bytes")
        _k1_k2(evs, f"greedy_decode, {mode}")
        b2 = [e for e in evs if "decode_tc_kernel" in e.key
              or "decode_simt_kernel" in e.key]
        b2_n = sum(e.count for e in b2)
        b2_ms = sum(e.self_device_time_total for e in b2) / 1e3
        b2_calls, ring_calls, rope_calls, b3_calls, toks32 = calls[-1]
        print(f"profile B2 in greedy_decode, {mode}: {b2_ms:.3f} ms device, "
              f"{b2_n} kernels, {b2_calls} wrapper calls")
        if b2_n != b2_calls:
            raise AssertionError(f"B2 ({mode}): {b2_n} kernels for "
                                 f"{b2_calls} calls")
        # B3 is folded into K2's ring mode: no ring-write kernel, and every
        # K2 kernel of the loop is a ring-mode call (the plain mode is not
        # called)
        b3_n = sum(e.count for e in evs if "ring_write_kernel" in e.key)
        k2 = [e for e in evs if "rope_kernel" in e.key]
        k2_n = sum(e.count for e in k2)
        k2_ms = sum(e.self_device_time_total for e in k2) / 1e3
        print(f"profile K2 ring mode in greedy_decode, {mode}: {k2_ms:.3f} "
              f"ms device, {k2_n} kernels, {ring_calls} ring-mode calls, "
              f"{rope_calls} plain rope calls; B3: {b3_n} kernels, "
              f"{b3_calls} calls")
        if b3_n or b3_calls:
            raise AssertionError(f"greedy_decode launched B3 ({b3_n} "
                                 f"kernels, {b3_calls} calls): it is "
                                 "folded into K2")
        if rope_calls or k2_n != ring_calls:
            raise AssertionError(f"K2 in greedy_decode ({mode}): {k2_n} "
                                 f"kernels for {ring_calls} ring-mode and "
                                 f"{rope_calls} plain calls")
        runs[mode] = (toks, toks32, calls[-1][:4],
                      {e.key: e.count for e in evs})
    model._graphs = True
    (e128, e32, e_calls, e_n), (g128, g32, g_calls, g_n) = (runs["eager"],
                                                            runs["graphs"])
    cache = model._decode_graphs
    if not (torch.equal(g128, e128) and torch.equal(g32, e32)):
        raise AssertionError(
            f"greedy_decode on graphs differs from the eager loop: "
            f"{int((g128 != e128).sum())} of {g128.numel()} tokens at + 128, "
            f"{int((g32 != e32).sum())} of {g32.numel()} at + 32")
    # the same kernels by name and count, but for the fills: the eager
    # loop zeroes fresh rings each call (2 a layer, pos and the token
    # buffer), the graph loop only resets its key's pos
    fills = [sum(n for k, n in d.items() if "FillFunctor" in k)
             for d in (e_n, g_n)]
    differ = {k for k in set(e_n) | set(g_n) if "FillFunctor" not in k
              and e_n.get(k) != g_n.get(k)}
    layers = model.config.num_hidden_layers
    if (differ or e_calls != g_calls or fills[0] - fills[1] != 2 * layers + 1
            or cache.captures != 1):
        raise AssertionError(f"greedy_decode's traces differ: {sorted(differ)}"
                             f", counters {e_calls} / {g_calls}, fills "
                             f"{fills}; {cache.captures} captures")
    print(f"(b) greedy_decode graphs == eager: tokens at + 128 and + 32 bit "
          f"for bit; kernels by name and count equal ({sum(g_n.values())} "
          f"on graphs, {sum(e_n.values())} eager: fill kernels {fills[1]} / "
          f"{fills[0]}, the eager loop's fresh rings), 1 capture")
    ref = greedy_decode(model, p4, max_new_tokens=32)
    ring = generate(model, p4, max_new_tokens=32, use_static_cache=True)
    grow = generate(model, p4, max_new_tokens=32)
    if not torch.equal(ring, ref):
        raise AssertionError("generate(use_static_cache=True) differs from "
                             "greedy_decode (the same kernels and shapes)")
    if not torch.equal(grow[:, 0], ref[:, 0]):
        raise AssertionError("generate with growing caches differs from "
                             "greedy_decode at the first token (one prefill)")
    f_ring = _forced_logits(torch, model, p4, ref, True)
    f_grow = _forced_logits(torch, model, p4, ref, False)
    noise = float((f_ring - f_grow).abs().max())
    scale = float(f_ring.abs().max())
    print(f"(c) generate ring == greedy_decode; ring vs growing caches on "
          f"the same tokens: max logit difference {noise:.3e} (max |logit| "
          f"{scale:.3f})")
    # bf16 activations through 32 layers; each layer's output is rounded
    # to 8 mantissa bits (0.4%) on paths that sum in different orders
    if not noise <= 0.05 * scale:
        raise AssertionError(f"ring and growing-cache decode logits differ by "
                             f"{noise} > 5% of {scale}")
    thresh = max(1e-3, 2 * noise)
    gaps = _gaps(torch, f_ring)
    for r in range(p4.shape[0]):
        _agree(grow[r].tolist(), ref[r].tolist(), gaps[r],
               f"row {r} growing vs ring", thresh)
    sampled = generate(model, p4, max_new_tokens=32, do_sample=True,
                       top_p=0.9, use_static_cache=True,
                       generator=Generator(7))
    in_vocab(sampled, "generate(do_sample=True)")
    print(f"(d) sampled {tuple(sampled.shape)} tokens, "
          f"{int((sampled != ref).sum())} of {sampled.numel()} differ from "
          "greedy")
    # greedy_decode, generate and the sampled generate on [4, 200] share
    # the (4, 232) key: one more capture
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager step) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if cache.captures != 2 or set(cache.graphs) != {("decode", 8, 512),
                                                    ("decode", 4, 232)}:
        raise AssertionError(f"{cache.captures} captures, keys "
                             f"{sorted(cache.graphs)}")
    return _path_launches("generate", counters)


# --------------------------------------------------------------- phase 6
def generation_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4's float32 pair: forward logits, and greedy tokens of
    greedy_decode / generate on cuda against greedy_decode on the CPU."""
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    g = torch.Generator()
    g.manual_seed(13)
    V = gpu_model.config.vocab_size
    ids = torch.randint(1, V, (2, 64), generator=g)
    with torch.no_grad():
        lg_gpu = gpu_model(ids.cuda()).cpu()
        lg_cpu = cpu_model(ids)
    err = float((lg_gpu - lg_cpu).abs().max())
    tol = 1e-3 * float(lg_cpu.abs().max()) + 1e-3
    print(f"forward logits [2, 64]: max_abs_err {err:.3e} tol {tol:.3e}")
    if not err <= tol:
        raise AssertionError("forward logits differ beyond tolerance")
    p = ids[:, :32]
    cpu = greedy_decode(cpu_model, p, 16, max_length=64)
    gaps = _gaps(torch, _forced_logits(torch, cpu_model, p, cpu, True))
    for what, got in (
            ("greedy_decode", greedy_decode(gpu_model, p.cuda(), 16,
                                            max_length=64)),
            ("generate ring", generate(gpu_model, p.cuda(), 16,
                                       use_static_cache=True)),
            ("generate growing", generate(gpu_model, p.cuda(), 16))):
        got = got.cpu()
        for r in range(p.shape[0]):
            _agree(got[r].tolist(), cpu[r].tolist(), gaps[r],
                   f"{what} row {r} cuda vs cpu")
    # the same call on the eager loop: the graph path's bits
    gpu_model._graphs = False
    eager = greedy_decode(gpu_model, p.cuda(), 16, max_length=64)
    gpu_model._graphs = True
    graph = greedy_decode(gpu_model, p.cuda(), 16, max_length=64)
    if not torch.equal(graph, eager):
        raise AssertionError("greedy_decode on graphs differs from the eager "
                             "loop on cuda")
    print("generation kernel path == plain path (greedy_decode, generate "
          "ring and growing); greedy_decode on graphs == the eager loop on "
          f"cuda, bit for bit ({gpu_model._decode_graphs.captures} "
          "captures)")


# --------------------------------------------------------------- phase 7
def _train_setup(torch, model, lr):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=True)
    crit = LlamaPretrainingCriterion()
    return TrainStep(model, lambda m, ids: crit(m(ids), ids), opt)


def full_width_training(torch):
    """Phase 7: bench.py's honest geometry in bfloat16 with recompute,
    AdamW(1e-4, multi_precision) through TrainStep on one [8, 2048] batch;
    returns the training path's launches."""
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=2560,
                      intermediate_size=8192, num_hidden_layers=9,
                      num_attention_heads=20, max_position_embeddings=2048,
                      dtype="bfloat16", recompute=True)
    B, S = 8, 2048
    before = torch.cuda.memory_allocated()    # held over from earlier phases
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    step = _train_setup(torch, model, 1e-4)
    torch.cuda.synchronize()
    n_params = model.num_params
    print(f"train model: {n_params} parameters, {len(list(model.parameters()))}"
          f" tensors, setup seconds {time.perf_counter() - t:.3f}")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device="cuda")
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        losses.append(step(ids))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 10
    lv = torch.stack(losses).float().cpu()
    print(f"losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()) or not lv[-1] < lv[0]:
        raise AssertionError(f"training losses not finite and falling: {lv}")
    tok_s = B * S / dt
    _TRAIN_STEP.update(ms=dt * 1e3, peak=torch.cuda.max_memory_allocated())
    # bench.py:96: 6 N per token (forward + backward) + the attention term
    flops_tok = 6 * n_params + 12 * cfg.num_hidden_layers \
        * cfg.hidden_size * S * 0.5
    print(f"train step [{B}, {S}]: {dt * 1e3:.1f} ms, {tok_s:.1f} tokens/s, "
          f"MFU {tok_s * flops_tok / 989e12:.4f} against 989 TFLOP/s "
          f"(informative), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes, {before} of them "
          "allocated before the phase")
    # run_steps: 4 steps over a stacked window, no host sync inside
    stack = ids[None].expand(4, B, S)
    torch.cuda.synchronize()
    t = time.perf_counter()
    l4 = _sync_free(torch, step.run_steps)(stack)
    torch.cuda.synchronize()
    l4 = l4.float().cpu()
    if l4.shape != (4,) or not bool(torch.isfinite(l4).all()):
        raise AssertionError(f"run_steps losses {l4}")
    print(f"run_steps [4, {B}, {S}]: {time.perf_counter() - t:.3f} s, "
          f"losses {[round(float(x), 4) for x in l4]}, no host sync inside")
    evs = _profile(torch, "train step", lambda: step(ids), top=20)
    _k1_k2(evs, "the train step")
    _COPIES["train"] = _copies(evs)
    print(f"profile train: {_COPIES['train'][0]} copy kernels, "
          f"{_COPIES['train'][1]:.3f} ms a step")
    n_steps = 12 + 4 + 2
    launches = _path_launches("train", counters)
    print("launches per train step: " + json.dumps(
        {k: launches[k] / n_steps for k in PATHS["train"]}))
    return launches


# --------------------------------------------------------------- phase 8
def _grads_of(torch, model, ids):
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    model.zero_grad(set_to_none=True)
    loss = LlamaPretrainingCriterion()(model(ids), ids)
    loss.backward()
    return float(loss.detach())


def training_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 8 on phase 4's float32 pair: one step's loss and every
    gradient, then the parameters after 3 AdamW(multi_precision) steps
    through TrainStep, kernels on cuda against plain versions on the CPU;
    1e-4 of each tensor's largest |value|."""
    g = torch.Generator()
    g.manual_seed(17)
    V = gpu_model.config.vocab_size
    ids = torch.randint(1, V, (2, 64), generator=g)
    lg = _grads_of(torch, gpu_model, ids.cuda())
    lc = _grads_of(torch, cpu_model, ids)
    print(f"loss: cuda {lg:.6f} cpu {lc:.6f}")
    if not abs(lg - lc) <= 1e-4 * abs(lc):
        raise AssertionError("losses differ beyond 1e-4")
    worst = 0.0
    for (n, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                cpu_model.named_parameters()):
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        scale = float(pc.grad.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= 1e-4 * scale + 1e-9:
            raise AssertionError(f"grad of {n}: {err} > 1e-4 of {scale}")
    print(f"gradients: every parameter within {worst:.2e} of its largest "
          f"|grad|")
    gpu_model.zero_grad(set_to_none=True)
    cpu_model.zero_grad(set_to_none=True)
    lr, steps = 1e-4, 3
    sg, sc = _train_setup(torch, gpu_model, lr), _train_setup(
        torch, cpu_model, lr)
    for i in range(steps):
        a, b = float(sg(ids.cuda())), float(sc(ids))
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"step {i} loss cuda {a} cpu {b}")
    # Adam moves an element by ~lr a step whatever its gradient's size:
    # where a gradient is within float noise of zero its sign, and the
    # step, may differ; such elements stay within 2 lr steps
    n_out = n_all = 0
    for (n, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                cpu_model.named_parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs()
        tol = 1e-4 * float(pc.detach().abs().max())
        n_out += int((err > tol).sum())
        n_all += err.numel()
        if not float(err.max()) <= tol + 2 * lr * steps:
            raise AssertionError(f"{n} after {steps} steps: "
                                 f"{float(err.max())}")
    print(f"parameters after {steps} AdamW steps: {n_out} of {n_all} "
          f"elements beyond 1e-4 of their tensor's largest |w| (all within "
          f"2 lr steps)")
    if n_out > 1e-4 * n_all:
        raise AssertionError("too many parameters differ after AdamW")
    print("training kernel path == plain path (loss, gradients, AdamW)")


# --------------------------------------------------------- phase 8 (AMP)
def _amp_train_setup(torch, model, lr, level, scale, decorate=False):
    """TrainStep under ``auto_cast(level)`` bf16 with a dynamic GradScaler
    (doubling after 2 good steps), AdamW(multi_precision) with
    ClipGradByGlobalNorm(1.0) and LinearWarmup(3 steps) into
    CosineAnnealingDecay(T_max 12); O2 also ``amp.decorate``s the model.
    The loss is multiplied by the batch's ``poison`` (1, or inf to force
    an overflow).  -> (step, scheduler, scaler, optimizer)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (
        CosineAnnealingDecay,
        LinearWarmup,
    )

    sched = LinearWarmup(CosineAnnealingDecay(lr, T_max=12), 3, 0.0, lr)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    if decorate:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=scale, incr_every_n_steps=2)
    crit = LlamaPretrainingCriterion()

    def loss_fn(m, ids, poison):
        with amp.auto_cast(level=level, dtype="bfloat16"):
            return crit(m(ids), ids) * poison

    return TrainStep(model, loss_fn, opt, scaler=scaler), sched, scaler, opt


def _schedule_lr(lr, epoch, warm=3, t_max=12):
    """LinearWarmup(CosineAnnealingDecay(lr, t_max), warm, 0, lr) at
    ``epoch``, written out here apart from optimizer/lr.py."""
    if epoch < warm:
        return lr * epoch / warm
    return lr * (1 + math.cos(math.pi * (epoch - warm) / t_max)) / 2


def _state_snapshot(model, opt):
    """Clones of every parameter and every optimizer state tensor (masters,
    moments, step counts)."""
    sd = opt.state_dict()
    return ([p.detach().clone() for p in model.parameters()],
            {k: v.clone() for k, v in sd.items() if hasattr(v, "clone")})


def _unchanged(torch, model, opt, snap, what):
    params, states = snap
    sd = opt.state_dict()
    moved = [n for (n, p), q in zip(model.named_parameters(), params)
             if not torch.equal(p.detach(), q)]
    moved += [k for k, v in states.items() if not torch.equal(sd[k], v)]
    if moved:
        raise AssertionError(f"{what}: the overflow step changed "
                             f"{len(moved)} tensors, e.g. {moved[:4]}")
    print(f"{what}: the overflow step left {len(params)} parameters and "
          f"{len(states)} optimizer tensors (masters, moments, step counts) "
          "bit for bit")


# phase 8's AMP pair: 2 float32 layers of 8 heads of 128 (the paths' head
# dim) at hidden 1024: its CPU side's bf16 products take ~1 s a step, where
# phase 4's 7B-width pair took 20-50 s a step on the card's host
AMP_LLAMA = dict(hidden_size=1024, num_attention_heads=8,
                 intermediate_size=2816, vocab_size=8192)


def amp_pair(torch, seed=4):
    """Two 2-layer float32 Llamas of ``AMP_LLAMA``'s widths with identical
    weights, on cuda and on the CPU (phase 8's AMP run)."""
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        llama_7b,
        load_numpy_state_dict,
    )

    cfg = llama_7b(dtype="float32", num_hidden_layers=2, **AMP_LLAMA)
    gpu_model = LlamaForCausalLM(cfg, seed=seed)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    load_numpy_state_dict(cpu_model, {k: v.cpu().numpy() for k, v in
                                      gpu_model.state_dict().items()})
    return gpu_model, cpu_model


def training_amp_vs_plain(torch, gpu_model, cpu_model):
    """Phase 8 under AMP: a float32 pair with identical weights
    (``amp_pair``), each through TrainStep under O1 bf16 with a GradScaler,
    ClipGradByGlobalNorm and a LinearWarmup schedule (``_amp_train_setup``):
    3 steps, one forced to overflow (the loss times inf), one more; kernels
    on cuda against plain versions on the CPU.  The gradient's global norm
    is checked to exceed the clip's 1.0 first, so the clip's factor (B9's
    ``gmul`` on cuda) scales every update.  The bf16 tolerance: the two
    sides round the white-listed products to bf16 at other places, so each
    finite loss within 2e-2 of the CPU's; the scaler's state equal after
    every step; the overflow step leaves cuda's parameters and optimizer
    state bit for bit; after the 4 updates every parameter within 2^-7 of
    its largest |w| plus 2 lr steps of the CPU's, AdamW's step count equal,
    moment1 and moment2 within 5e-2 of the CPU's in L2 norm (they carry
    the unscale and the clip's factor: a lost factor moves them by the
    factor itself), and each tensor's change within 0.1 of the CPU's
    change in L2 norm.  Adam divides the moments' scale out of the update,
    so the change tells little of the factor; it shows an update that is
    missing or doubled."""
    w0 = [p.detach().clone() for p in cpu_model.parameters()]
    lr = 1e-4
    sg, schg, scg, og = _amp_train_setup(torch, gpu_model, lr, "O1", 2.0 ** 16)
    sc, schc, scc, oc = _amp_train_setup(torch, cpu_model, lr, "O1", 2.0 ** 16)
    g = torch.Generator()
    g.manual_seed(18)
    ids = torch.randint(1, gpu_model.config.vocab_size, (2, 64), generator=g)
    dev = gpu_model.device
    gn = _amp_grad_norm(torch, cpu_model, ids)
    print(f"O1 global gradient norm before the first step {gn:.4f} "
          f"(clip scale {min(1.0, 1.0 / gn):.4f})")
    if not gn > 1.0:
        raise AssertionError("phase 8 O1: the clip would not act")
    poison = [1.0, 1.0, 1.0, math.inf, 1.0]
    for i, f in enumerate(poison):
        snap = _state_snapshot(gpu_model, og) if f != 1.0 else None
        a = float(sg(ids.to(dev), torch.full((), f, device=dev)))
        b = float(sc(ids, torch.tensor(f)))
        print(f"O1 step {i} (lr {schg():.3e}, poison {f}): loss cuda {a:.6f} "
              f"cpu {b:.6f}, scale {scg.get_loss_scaling()}")
        if scg.state_dict() != scc.state_dict():
            raise AssertionError(f"O1 step {i}: scaler cuda "
                                 f"{scg.state_dict()} cpu {scc.state_dict()}")
        if f == 1.0 and not abs(a - b) <= 2e-2 * abs(b):
            raise AssertionError(f"O1 step {i}: losses differ beyond 2e-2")
        if f != 1.0:
            if math.isfinite(a) or math.isfinite(b):
                raise AssertionError("the poisoned loss is finite")
            _unchanged(torch, gpu_model, og, snap, "phase 8 O1")
        schg.step()
        schc.step()
    worst, worst_m = 0.0, 0.0
    for (n, pg), pc, p0 in zip(gpu_model.named_parameters(),
                               cpu_model.parameters(), w0):
        for acc in ("beta_pow", "moment1", "moment2"):
            mg = og._accumulators[acc][id(pg)].cpu()
            mc = oc._accumulators[acc][id(pc)]
            if acc == "beta_pow":
                if not torch.equal(mg, mc):
                    raise AssertionError(f"O1 {n}: t {mg} cuda, {mc} CPU")
                continue
            rel = float(torch.linalg.vector_norm(mg - mc)
                        / torch.linalg.vector_norm(mc))
            worst_m = max(worst_m, rel)
            if not rel <= 5e-2:
                raise AssertionError(f"O1 {n}: {acc} off by {rel:.4f} of "
                                     "the CPU's")
        pg, pc = pg.detach().cpu(), pc.detach()
        err = float((pg - pc).abs().max())
        if not err <= 2 ** -7 * float(pc.abs().max()) + 2 * lr * 4:
            raise AssertionError(f"O1 {n}: {err}")
        dc = torch.linalg.vector_norm(pc - p0)
        ratio = float(torch.linalg.vector_norm((pg - p0) - (pc - p0)) / dc)
        worst = max(worst, ratio)
        if not ratio <= 0.1:
            raise AssertionError(f"O1 {n}: change off by {ratio:.3f} of "
                                 "the CPU's")
    print(f"O1 + GradScaler + clip + schedule: cuda == CPU (each tensor's "
          f"change within {worst:.4f} of the CPU's, the moments within "
          f"{worst_m:.4f}; the overflow step skipped on both)")


def _amp_grad_norm(torch, model, ids):
    """The global L2 norm of ``model``'s gradients of the pretraining loss
    on ``ids`` under O1 bf16, without a step (the gradients are dropped)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    with amp.auto_cast(level="O1", dtype="bfloat16"):
        LlamaPretrainingCriterion()(model(ids), ids).backward()
    grads = [p.grad.float() for p in model.parameters() if p.grad is not None]
    gn = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])))
    model.zero_grad(set_to_none=True)
    return gn


# -------------------------------------------------------------- phase 17
def _copies(evs):
    """(kernels, ms) of PyTorch's copy kernels in a profile
    (``direct_copy_kernel_cuda``, ``bfloat16_copy_kernel_cuda``): the AMP
    casts, and any other copy."""
    mine = [e for e in evs if "copy_kernel" in e.key]
    return (sum(e.count for e in mine),
            sum(e.self_device_time_total for e in mine) / 1e3)


_COPIES = {}    # phase 7's copy kernels a step, for phase 17's difference


# phase 17's model: bench.py's geometry (phase 7's), built in float32
TRAIN_AMP_MODEL = dict(vocab_size=32000, hidden_size=2560,
                       intermediate_size=8192, num_hidden_layers=9,
                       num_attention_heads=20, max_position_embeddings=2048)


def full_width_train_amp(torch, card, model_kw=TRAIN_AMP_MODEL,
                         batch=(8, 2048), device="cuda"):
    """Phase 17: path (a), Llama pretraining as a user runs it at bench.py's
    geometry (phase 7's), the model built in float32 and
    ``amp.decorate``d to O2 bf16 (``_amp_train_setup``: GradScaler, clip,
    LinearWarmup + cosine schedule), [8, 2048]; returns the "train_amp"
    path's launches.  ``model_kw``, ``batch`` and ``device`` cut it to a
    rehearsal on the CPU."""
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**model_kw, dtype="float32", recompute=True)
    (B, S), lr = batch, 1e-4
    before = torch.cuda.memory_allocated()    # held over from earlier phases
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    step, sched, scaler, opt = _amp_train_setup(
        torch, model, lr, "O2", 2.0 ** 15, decorate=True)
    torch.cuda.synchronize()
    dts = sorted({str(p.dtype) for p in model.parameters()})
    print(f"train_amp model: {model.num_params} parameters in {dts} after "
          f"decorate, multi_precision {opt._multi_precision}, setup seconds "
          f"{time.perf_counter() - t:.3f}")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device=device)
    one = torch.ones((), device=device)
    inf = torch.full((), math.inf, device=device)
    free = _sync_free(torch, step)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs, calls = [], [], 0

    def run(poison):
        nonlocal calls
        want = _schedule_lr(lr, sched.last_epoch)
        if abs(opt.get_lr() - want) > 1e-12 * lr:
            raise AssertionError(f"lr {opt.get_lr()} at epoch "
                                 f"{sched.last_epoch}, the schedule {want}")
        lrs.append(opt.get_lr())
        out = free(ids, poison)
        sched.step()
        calls += 1
        return out

    for _ in range(2):                         # warm-up
        losses.append(run(one))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(6):
        losses.append(run(one))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 6
    peak = torch.cuda.max_memory_allocated()    # before the snapshot's clones
    scale = scaler.get_loss_scaling()
    snap = _state_snapshot(model, opt)
    bad = run(inf)
    torch.cuda.synchronize()
    if math.isfinite(float(bad)):
        raise AssertionError("phase 17: the poisoned loss is finite")
    _unchanged(torch, model, opt, snap, "phase 17")
    snap = None
    if scaler.get_loss_scaling() != scale / 2:
        raise AssertionError(f"phase 17: scale {scale} -> "
                             f"{scaler.get_loss_scaling()}, not halved")
    print(f"overflow step: scale {scale} -> {scaler.get_loss_scaling()}")
    for _ in range(4):
        losses.append(run(one))
    lv = torch.stack(losses).float().cpu()
    print(f"train_amp losses {[round(float(x), 4) for x in lv]}, learning "
          f"rates {[f'{x:.3e}' for x in lrs]}")
    if len(lv) != 12 or not bool(torch.isfinite(lv).all()) \
            or not lv[-1] < lv[0]:
        raise AssertionError(f"phase 17 losses not finite and falling: {lv}")
    tok_s = B * S / dt
    print(f"train_amp step [{B}, {S}] (O2 bf16, scaler, clip): "
          f"{dt * 1e3:.1f} ms, {tok_s:.1f} tokens/s, max_memory_allocated "
          f"{peak} bytes ({before} allocated before the phase), scale "
          f"{scaler.get_loss_scaling()} ({card}); no host sync inside a "
          "step")
    evs = _profile(torch, "train_amp step", lambda: run(one), top=20)
    n, ms = _copies(evs)
    base = _COPIES.get("train")
    print(f"profile train_amp: {n} copy kernels, {ms:.3f} ms a step"
          + ("" if base is None else
             f"; phase 7's bf16 step {base[0]} ({base[1]:.3f} ms): AMP adds "
             f"{n - base[0]} launches, {ms - base[1]:.3f} ms"))
    _k1_k2(evs, "the train_amp step")
    launches = _path_launches("train_amp", counters)
    if launches["rms_norm_residual"]:
        raise AssertionError("phase 17: K1's fused residual add ran under "
                             "AMP (the reference adds, then norms)")
    print("launches per train_amp step: " + json.dumps(
        {k: launches[k] / calls for k in PATHS["train_amp"]}))
    return launches


# -------------------------------------------------------------- phase 18
def _finetune_step(torch, model, lr=2e-5):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=True)
    return TrainStep(model, lambda m, ids, y: F.cross_entropy(m(ids), y),
                     opt)


def _forward_loss(torch, model, ids, y, seed):
    """The finetune step's loss from the default generator at ``seed``
    (the step's key chain, dropout on), without a gradient."""
    from paddle_tpu_torch.framework import random as prand
    from paddle_tpu_torch.jit import trace_state
    from paddle_tpu_torch.nn import functional as F

    prand.seed(seed)
    ctx = trace_state.TraceContext(prand.default_generator().next_key(
        ids.device))
    with torch.no_grad(), trace_state.activate(ctx):
        return F.cross_entropy(model(ids), y).float().cpu()


def _mask_ms(torch, layers, B, S, h, heads, ffn, device):
    """One step's dropout draws replayed alone: per layer the attention's
    [B, H, S, S] mask and the hidden, activation and hidden masks ([B, S,
    h], [B, S, ffn], [B, S, h]), each from its own key.  -> (CUDA-event
    ms, traced device ms, elements): the event time is wall time on the
    device's clock and takes in the gaps between launches; the traced time
    sums the draws' kernels (threefry's int64 ops, the uniform's
    conversions, the compare) alone."""
    from paddle_tpu_torch.framework import random as prand

    shapes = [(B, heads, S, S), (B, S, h), (B, S, ffn), (B, S, h)] * layers
    base = prand.key(3, device)

    def draws():
        for i, shp in enumerate(shapes):
            prand.bernoulli(prand.fold_in(base, i + 1), 0.9, shp)

    draws()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    draws()
    e.record()
    e.synchronize()
    evs = _profile(torch, "finetune masks alone", draws, top=8)
    dev = sum(ev.self_device_time_total for ev in evs) / 1e3
    return s.elapsed_time(e), dev, sum(math.prod(x) for x in shapes)


def full_width_finetune(torch, card, geo=BERT, device="cuda"):
    """Phase 18: path (b), bench_ladder's BERT-base finetune (h 768, 12
    layers, 12 heads, seq 128, batch 32, dropout 0.1, gelu) built in
    float32, then ``model.bfloat16()``, AdamW(2e-5, multi_precision),
    TrainStep over cross_entropy; then the 2-layer narrow BERT on cuda
    against the CPU.  Returns the "finetune" path's launches.  ``geo``
    (``BERT``'s keys) and ``device`` cut it to a rehearsal on the CPU."""
    from paddle_tpu_torch.framework import random as prand

    B, S = geo["batch"], BERT["seq"]
    before = torch.cuda.memory_allocated()    # held over from earlier phases
    model = bert_classifier(torch, geo["layers"], torch.float32,
                            device=device, seed=4, hidden=geo["hidden"],
                            heads=geo["heads"], vocab=geo["vocab"])
    model.bfloat16()
    model.train()
    step = _finetune_step(torch, model)
    g = torch.Generator(device=device)
    g.manual_seed(5)
    ids = torch.randint(0, geo["vocab"], (B, S), device=device, generator=g)
    y = torch.randint(0, 2, (B,), device=device, generator=g)
    # the same step from one generator state twice, then another seed
    la, lb, lc = (_forward_loss(torch, model, ids, y, s) for s in (7, 7, 8))
    if not torch.equal(la, lb) or torch.equal(la, lc):
        raise AssertionError(f"phase 18: seed 7 gave {la} and {lb}, seed 8 "
                             f"{lc}")
    print(f"finetune loss from seed 7 twice: {float(la)} == {float(lb)}; "
          f"seed 8: {float(lc)}")
    kept = float(prand.bernoulli(prand.key(11, device), 0.9,
                                 (B, geo["heads"], S, S)).float().mean())
    print(f"kept share of a [{B}, {geo['heads']}, {S}, {S}] mask at "
          f"p 0.1: {kept:.5f}")
    if not abs(kept - 0.9) <= 0.005:
        raise AssertionError(f"phase 18: kept share {kept}")
    prand.seed(0)
    free = _sync_free(torch, step)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [free(ids, y) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        losses.append(free(ids, y))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 10
    lv = torch.stack(losses).float().cpu()
    print(f"finetune losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()):
        raise AssertionError(f"phase 18 losses not finite: {lv}")
    print(f"finetune step [{B}, {S}]: {dt * 1e3:.1f} ms, {B / dt:.1f} "
          f"examples/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes ({before} allocated "
          f"before the phase; {card}); no host sync inside a step")
    evs = _profile(torch, "finetune step", lambda: step(ids, y), top=16)
    dev = sum(e.self_device_time_total for e in evs) / 1e3
    mask = sum(e.self_device_time_total for e in evs
               if "<long" in e.key or "int64" in e.key) / 1e3
    print(f"profile finetune: int64 kernels (threefry's part of the draws) "
          f"{mask:.3f} of {dev:.3f} ms device time a step "
          f"({100 * mask / max(dev, 1e-9):.1f}%)")
    m_ms, m_dev, n_el = _mask_ms(torch, geo["layers"], B, S,
                                 geo["hidden"], geo["heads"],
                                 4 * geo["hidden"], device)
    print(f"the step's {4 * geo['layers']} masks ({n_el} elements) drawn "
          f"alone: {m_dev:.3f} ms device time (profile), "
          f"{100 * m_dev / max(dev, 1e-9):.1f}% of the step's {dev:.3f} ms "
          f"device time; {m_ms:.3f} ms by CUDA events (wall on the device's "
          "clock, the gaps between launches included)")
    launches = _path_launches("finetune", counters)
    if launches["flash_attention"]:
        raise AssertionError("phase 18: B1 launched at dropout 0.1")
    model = step = None
    torch.cuda.empty_cache()
    _finetune_vs_plain(torch, device)
    return launches


def _finetune_vs_plain(torch, device="cuda"):
    """The 2-layer BERT at narrow width (hidden 128, 4 heads, vocab 1024) in
    float32 with identical weights on cuda and on the CPU: the same masks
    (a [4, 4, 128, 128] draw equal bit for bit), then 3 TrainSteps from
    the same seed: losses within 1e-4 relative, every parameter within 1e-4
    of its largest |w| plus 2 lr steps (Adam's sign of a near-zero
    gradient), all but 1e-3 of the elements within the 1e-4 alone."""
    from paddle_tpu_torch.framework import random as prand
    from paddle_tpu_torch.nn import load_numpy_state_dict

    narrow = dict(hidden=128, heads=4, vocab=1024)
    gm = bert_classifier(torch, 2, torch.float32, device=device, seed=6,
                         **narrow)
    cm = bert_classifier(torch, 2, torch.float32, device="cpu", seed=6,
                         **narrow)
    load_numpy_state_dict(cm, {k: v.cpu().numpy()
                               for k, v in gm.state_dict().items()})
    mk = [prand.bernoulli(prand.key(9, d), 0.9, (4, 4, 128, 128)).cpu()
          for d in (device, "cpu")]
    if not torch.equal(*mk):
        raise AssertionError("phase 18: masks differ on cuda and the CPU")
    lr = 1e-3
    sg, sc = _finetune_step(torch, gm, lr), _finetune_step(torch, cm, lr)
    g = torch.Generator()
    g.manual_seed(12)
    ids = torch.randint(0, 1024, (4, BERT["seq"]), generator=g)
    y = torch.randint(0, 2, (4,), generator=g)
    for i in range(3):
        prand.seed(30 + i)
        a = float(sg(ids.to(device), y.to(device)))
        prand.seed(30 + i)
        b = float(sc(ids, y))
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"finetune step {i}: cuda {a} cpu {b}")
    n_out = n_all = 0
    for (n, pg), pc in zip(gm.named_parameters(), cm.parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs()
        tol = 1e-4 * float(pc.detach().abs().max())
        if not float(err.max()) <= tol + 2 * lr * 3:
            raise AssertionError(f"finetune {n}: {float(err.max())}")
        if not n.endswith("k_proj.bias"):   # its gradient is rounding noise
            n_out += int((err > tol).sum())
            n_all += err.numel()
    if n_out > 1e-3 * n_all:
        raise AssertionError(f"finetune: {n_out} of {n_all} elements off")
    print(f"finetune 2-layer narrow BERT: cuda == CPU over 3 steps with "
          f"dropout ({n_out} of {n_all} elements beyond 1e-4)")


# -------------------------------------------------------------- phase 19
FIT_TRAIN, FIT_EVAL = 256, 64


def _fit_data(n, vocab, seed):
    """n seeded examples: ids [n, 128] and 0/1 labels, int64 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n, BERT["seq"])),
            rng.integers(0, 2, (n,))]


def _host_dataset(torch, arrays):
    """A TensorDataset whose samples, read in a DataLoader worker, must be
    read in a child forked from this CUDA process (where a CUDA call
    raises: the sample then fails the batch in the parent)."""
    from paddle_tpu_torch import io as pio

    class Forked(pio.TensorDataset):
        def __getitem__(self, idx):
            if pio.get_worker_info() is not None \
                    and not torch.cuda._is_in_bad_fork():
                raise AssertionError("a DataLoader worker that is not a "
                                     "fork of the CUDA process")
            return super().__getitem__(idx)

    return Forked(arrays)


def _same_batches(torch, got, want, what):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches, not {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if not all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(a, b)):
            raise AssertionError(f"{what}: batch {i} differs")


def full_width_fit(torch, card, geo=BERT, device="cuda", n=(FIT_TRAIN,
                                                           FIT_EVAL)):
    """Phase 19: phase 18's BERT-base finetune through ``hapi.Model``: fit
    with two DataLoader workers, callbacks and checkpoints, then evaluate,
    predict, save and load.  Returns the "fit" path's launches.  ``geo``,
    ``device`` and ``n`` cut it to a rehearsal on the CPU."""
    import shutil
    import tempfile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import callbacks as pcb
    from paddle_tpu_torch import framework_io
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.framework import random as prand
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup

    B = geo["batch"]
    train = _host_dataset(torch, _fit_data(n[0], geo["vocab"], 19))
    evald = _host_dataset(torch, _fit_data(n[1], geo["vocab"], 20))
    in_process = list(pio.DataLoader(train, batch_size=B))

    def make(seed):
        net = bert_classifier(torch, geo["layers"], torch.float32,
                              device=device, seed=seed, hidden=geo["hidden"],
                              heads=geo["heads"], vocab=geo["vocab"])
        net.bfloat16()
        opt = AdamW(learning_rate=LinearWarmup(2e-5, 4, 0.0, 2e-5),
                    parameters=net.parameters(), multi_precision=True)
        return net, ptt.Model(net).prepare(opt, F.cross_entropy, Accuracy())

    net, model = make(4)
    # what fit hands train_batch (the loader's CPU batches), the steps'
    # times, each evaluation's time and outputs, each checkpoint's time
    seen, step_s, evals, outs, saves, forwards = [], [], [], [], [], [0]
    train_batch, evaluate, eval_batch, save = (
        model.train_batch, model.evaluate, model.eval_batch, model.save)

    def train_batch_(xs, y):
        seen.append([x.clone() for x in xs] + [y.clone()])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_batch(xs, y)        # its loss read to the host: a sync
        step_s.append(time.perf_counter() - t0)
        ts = model._train_step
        if not getattr(ts, "_checked", False):   # the step itself: no sync
            ts._one, ts._checked = _sync_free(torch, ts._one), True
        return out

    def evaluate_(*a, **k):
        outs.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(*a, **k)
        evals.append((res, time.perf_counter() - t0))
        return res

    def eval_batch_(xs, y):
        loss, out = eval_batch(xs, y)
        outs.append(out)
        return loss, out

    def save_(path, training=True):
        t0 = time.perf_counter()
        save(path, training)
        torch.cuda.synchronize()
        saves.append((path, time.perf_counter() - t0))

    model.train_batch, model.evaluate = train_batch_, evaluate_
    model.eval_batch, model.save = eval_batch_, save_

    def count_forwards(module, args):
        if not module.training:
            forwards[0] += 1

    tmp = tempfile.mkdtemp(prefix="ptt_fit_")
    hooks = [net.encoder.register_forward_pre_hook(count_forwards)]
    try:
        prand.seed(0)
        counters = _zero_counters()
        t = time.perf_counter()
        hist = model.fit(train, evald, batch_size=B, epochs=2,
                         shuffle=False, num_workers=2, verbose=1, log_freq=4,
                         callbacks=[pcb.ModelCheckpoint(save_freq=2,
                                                        save_dir=tmp),
                                    pcb.LRScheduler(by_step=True),
                                    pcb.EarlyStopping("val_loss",
                                                      patience=5)])
        fit_s = time.perf_counter() - t
        losses = hist["loss"]
        print(f"fit: epoch losses {losses}, evaluations "
              f"{[r for r, _ in evals]}, {fit_s:.3f} s")
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 19: epoch losses {losses}")
        if len(evals) != 2:
            raise AssertionError(f"phase 19: {len(evals)} evaluations in "
                                 "fit, not one after each of 2 epochs")
        _same_batches(torch, seen, in_process * 2,
                      "phase 19, fit's batches through two workers")
        print(f"fit: {len(seen)} batches through two DataLoader workers "
              "equal an in-process loader's bit for bit, every sample read "
              "in a child forked from this CUDA process")
        names = sorted(os.listdir(tmp))
        want = ["1.pdopt", "1.pdparams", "final.pdopt", "final.pdparams"]
        if names != want or len(saves) != 2:
            raise AssertionError(f"phase 19: checkpoints {names}")
        for path, secs in saves:
            size = sum(os.path.getsize(path + ext)
                       for ext in (".pdparams", ".pdopt"))
            print(f"checkpoint {os.path.basename(path)}: {size} bytes in "
                  f"{secs:.3f} s")
        res = evaluate_(evald, batch_size=B, verbose=0)
        logits = torch.cat(outs)
        preds = torch.cat(model.predict(evald, batch_size=B))
        if not torch.equal(preds, logits):
            raise AssertionError("phase 19: predict's outputs are not the "
                                 "evaluation's logits")
        model.save(os.path.join(tmp, "again"))
        fresh, fm = make(99)
        hooks.append(fresh.encoder.register_forward_pre_hook(
            count_forwards))
        fm.load(os.path.join(tmp, "final"))
        ids = torch.as_tensor(evald.tensors[0][:B])
        a, b = fm.predict_batch([ids]), model.predict_batch([ids])
        if not torch.equal(a, b):
            raise AssertionError("phase 19: the reloaded model's logits "
                                 "differ from the trained model's")
        saved = framework_io.load(os.path.join(tmp, "final.pdopt"))
        got = fm._optimizer.state_dict()
        bad = [k for k, v in saved.items() if isinstance(v, torch.Tensor)
               and not (got[k].dtype == v.dtype
                        and torch.equal(got[k].cpu(), v))]
        if set(got) != set(saved) or bad:
            raise AssertionError(f"phase 19: the reloaded optimizer state "
                                 f"differs: {bad[:4]}")
        dts = sorted({str(v.dtype) for v in got.values()
                      if isinstance(v, torch.Tensor)})
        print(f"reload: eval logits bit for bit; {len(got)} optimizer "
              f"entries with their saved dtypes {dts} and bits; evaluate "
              f"{res}; predict == the evaluation's logits")
    finally:
        for h in hooks:
            h.remove()
        shutil.rmtree(tmp)
    n_tensors = len(list(net.parameters()))
    steps = len(step_s)
    ms = sorted(step_s[2:])[len(step_s[2:]) // 2] * 1e3
    eval_ms = evals[-1][1] * 1e3 / (n[1] // B)
    print(f"fit step [{B}, {BERT['seq']}] through Model.train_batch: "
          f"median {ms:.1f} ms of steps 3-{steps} (the loss read to the "
          f"host once a step), {B / ms * 1e3:.1f} examples/s; evaluation "
          f"{eval_ms:.1f} ms a batch; {card}")
    launches = _path_launches("fit", counters)
    if launches["fused_adamw"] != n_tensors * steps:
        raise AssertionError(f"phase 19: B9 launched "
                             f"{launches['fused_adamw']} times for "
                             f"{n_tensors} parameters x {steps} steps")
    if launches["flash_attention"] != geo["layers"] * forwards[0]:
        raise AssertionError(f"phase 19: B1 launched "
                             f"{launches['flash_attention']} times for "
                             f"{forwards[0]} eval forwards of "
                             f"{geo['layers']} layers")
    print(f"fit: B9 {n_tensors} x {steps}, B1 {geo['layers']} x "
          f"{forwards[0]} eval forwards")
    return launches


# -------------------------------------------------------------- phase 20
LAMB_LR = 5e-3


def full_width_lamb(torch, card, model_kw=TRAIN_AMP_MODEL, batch=(8, 2048),
                    device="cuda"):
    """Phase 20 (i): phase 7's Llama (bf16, recompute) under Lamb with
    master weights, a LinearWarmup into CosineAnnealingDecay and
    ClipGradByGlobalNorm(1.0), 5 TrainSteps; returns the "optimizers"
    path's launches.  ``model_kw``, ``batch`` and ``device`` cut it to a
    rehearsal on the CPU."""
    import numpy as np

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Lamb
    from paddle_tpu_torch.optimizer.lr import (
        CosineAnnealingDecay,
        LinearWarmup,
    )

    cfg = LlamaConfig(**model_kw, dtype="bfloat16", recompute=True)
    B, S = batch
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    sched = LinearWarmup(CosineAnnealingDecay(LAMB_LR, T_max=12), 2,
                         LAMB_LR / 4, LAMB_LR)
    opt = Lamb(learning_rate=sched, parameters=model.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, lambda m, ids: crit(m(ids), ids), opt)
    torch.cuda.synchronize()
    print(f"lamb model: {model.num_params} parameters, setup seconds "
          f"{time.perf_counter() - t:.3f}")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device=device)
    free = _sync_free(torch, step)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [free(ids)]
    sched.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(4):
        losses.append(free(ids))
        sched.step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 4
    lv = torch.stack(losses).float().cpu()
    print(f"lamb losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()) or not lv[-1] < lv[0]:
        raise AssertionError(f"phase 20: Lamb losses not finite and "
                             f"falling: {lv}")
    print(f"lamb step [{B}, {S}] (bf16, masters, clip, schedule): "
          f"{dt * 1e3:.1f} ms, {B * S / dt:.1f} tokens/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} "
          f"bytes; {card}; no host sync inside a step")
    launches = _path_launches("optimizers", counters)
    if launches["fused_adamw"]:
        raise AssertionError("phase 20: B9 launched under Lamb")
    _profile(torch, "lamb step", lambda: step(ids), top=16)
    # the update alone over the last step's gradients: Lamb's plain passes
    crit(model(ids), ids).backward()
    lr = opt.get_lr()
    evs = _profile(torch, "lamb update", lambda: opt._step(lr), top=8)
    n_k = sum(e.count for e in evs)
    n_p = len(list(model.parameters()))
    print(f"lamb update: {n_k} kernels for {n_p} parameters "
          f"({n_k / n_p:.1f} a parameter), "
          f"{sum(e.self_device_time_total for e in evs) / 1e3:.3f} ms "
          "device time")
    opt.clear_grad()
    return launches


NARROW_LLAMA = dict(hidden_size=256, num_attention_heads=2,
                    intermediate_size=688, vocab_size=4096)
# the optimizers TrainStep takes, each with its rate; LBFGS apart
STEP_OPTS = {"SGD": 0.1, "Momentum": 0.05, "Adamax": 1e-3, "Adagrad": 0.01,
             "Adadelta": 1.0, "RMSProp": 1e-3, "Lamb": 1e-3, "Lars": 0.5,
             "ASGD": 0.1, "Rprop": 1e-3, "NAdam": 1e-3, "RAdam": 1e-3}


def _rel(torch, a, b, keep=None) -> float:
    """|a - b| / |b| in L2 (0 where both are 0), over the elements where
    ``keep`` (a bool mask of b's shape) holds, if given."""
    a, b = a.detach().float().cpu(), b.detach().float()
    if keep is not None:
        a, b = a[keep], b[keep]
    nb = float(torch.linalg.vector_norm(b))
    diff = float(torch.linalg.vector_norm(a - b))
    return diff / nb if nb else diff


def _rprop_agreed(torch, mine, ref):
    """Rprop's state on cuda against the CPU's.  Rprop moves each step size
    by the sign of g * g_prev, and where that product lies within
    float32's rounding of 0 the sign is rounding's choice (float32 against
    float64 on the CPU alone leaves 5e-3 of a step-size tensor's norm
    apart).  An element is agreed where its step sizes agree within 1e-4
    and its last gradients (``prev_grad``, whose sign is all Rprop reads
    of it) have one sign; at most 1e-3 of each tensor's elements may
    disagree.  The last gradients' values are taken at parameters that
    differ in the disagreeing elements by a step each, so they are printed
    and not held.  -> ({parameter index: agreed mask}, prev_grad's
    largest relative L2 gap over the agreed elements)."""
    keep, gap = {}, 0.0
    for k, v in mine.items():
        if not k.endswith("__step_size"):
            continue
        i, grad = k[:-len("step_size")], k[:-len("step_size")] + "prev_grad"
        a, b = v.float().cpu(), ref[k].float()
        ok = ((a - b).abs() <= 1e-4 * b.abs()) & (
            torch.sign(mine[grad].cpu()) == torch.sign(ref[grad]))
        off = int((~ok).sum())
        if off > 1e-3 * ok.numel():
            raise AssertionError(f"phase 20 Rprop: {i}: {off} of "
                                 f"{ok.numel()} elements disagree")
        keep[int(k[6:].split("__")[0])] = ok
        gap = max(gap, _rel(torch, mine[grad], ref[grad], ok))
    print(f"optimizer Rprop: elements whose step or last gradient's sign "
          f"differ (a sign within rounding of 0): "
          f"{sum(int((~m).sum()) for m in keep.values())} of "
          f"{sum(m.numel() for m in keep.values())}; the last gradients' "
          f"largest relative L2 gap over the rest {gap:.3e} (not held)")
    return keep


def optimizers_vs_plain(torch, device="cuda"):
    """Phase 20 (ii): a 2-layer float32 Llama at hidden 256 on ``device``
    and on the CPU from the same weights, 3 TrainSteps of each optimizer
    of ``STEP_OPTS`` (ClipGradByGlobalNorm(1.0), StepDecay), then two
    LBFGS step(closure) calls: every parameter and state tensor within
    1e-4 of the CPU's (L2, relative to the CPU tensor's norm); for Rprop
    its parameters and step sizes over the elements whose sign decisions
    agree, at most 1e-3 of them apart (``_rprop_agreed``)."""
    import numpy as np

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
        llama_7b,
        load_numpy_state_dict,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import StepDecay

    cfg = llama_7b(dtype="float32", num_hidden_layers=2, **NARROW_LLAMA)
    base = LlamaForCausalLM(cfg, device=device, seed=7)
    weights = {k: v.cpu().numpy() for k, v in base.state_dict().items()}
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 128))
    crit = LlamaPretrainingCriterion()

    def pair():
        return [load_numpy_state_dict(LlamaForCausalLM(cfg, device=d,
                                                       seed=7), weights)
                for d in (device, "cpu")]

    # one backward from the same weights: the gap the kernels alone leave
    # in each gradient
    grads = []
    for m in pair():
        x = torch.as_tensor(ids, device=next(m.parameters()).device)
        crit(m(x), x).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    gaps = {n: _rel(torch, g, grads[1][n]) for n, g in grads[0].items()}
    print("gradients from the same weights, cuda vs CPU, the largest "
          "relative L2 gaps: " + ", ".join(
              f"{n} {e:.3e}" for n, e in sorted(gaps.items(),
                                                 key=lambda kv: -kv[1])[:4]))
    worst, failed = {}, []
    for name, lr in list(STEP_OPTS.items()) + [("LBFGS", 0.05)]:
        models, opts = pair(), []
        for m in models:
            x = torch.as_tensor(ids, device=next(m.parameters()).device)
            if name == "LBFGS":
                opt = popt.LBFGS(learning_rate=lr, max_iter=5,
                                 parameters=m.parameters())

                def closure(m=m, x=x):
                    loss = crit(m(x), x)
                    loss.backward()
                    return loss

                for _ in range(2):
                    opt.step(closure)
            else:
                opt = getattr(popt, name)(
                    learning_rate=StepDecay(lr, 1, 0.7),
                    parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
                step = TrainStep(m, lambda m, x: crit(m(x), x), opt)
                for _ in range(3):
                    step(x)
                    opt._learning_rate.step()
            opts.append(opt)
        mine, ref = opts[0].state_dict(), opts[1].state_dict()
        if set(mine) != set(ref):
            raise AssertionError(f"phase 20 {name}: state keys differ")
        keep = _rprop_agreed(torch, mine, ref) if name == "Rprop" else {}
        errs = {n: _rel(torch, p, q, keep.get(i)) for i, ((n, p), q) in
                enumerate(zip(models[0].named_parameters(),
                              models[1].parameters()))}
        errs.update({k: _rel(torch, v, ref[k],
                             keep.get(int(k[6:].split("__")[0])))
                     for k, v in mine.items() if isinstance(v, torch.Tensor)
                     and not (keep and k.endswith("__prev_grad"))})
        moved = max(_rel(torch, p, torch.as_tensor(weights[n]))
                    for n, p in models[1].named_parameters())
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        worst[name] = top[0][1]
        print(f"optimizer {name}: cuda vs CPU over {len(errs)} tensors, the "
              "largest relative L2 gaps " + ", ".join(
                  f"{k} {e:.3e}" for k, e in top)
              + f"; the CPU's largest relative move {moved:.3e}")
        if not top[0][1] <= 1e-4 or not moved > 0:
            failed.append(f"{name}: {top[0][0]} off by {top[0][1]} (moved "
                          f"{moved})")
    if failed:
        raise AssertionError("phase 20: " + "; ".join(failed))
    print(f"optimizers: cuda == CPU within {max(worst.values()):.3e} for "
          f"{len(worst)} optimizers")


# --------------------------------------------------------------- phase 9
def bert_classifier(torch, layers, dtype, device=None, seed=0, hidden=None,
                    heads=None, vocab=None):
    """bench_ladder.py's BertClassifier (bench_ladder.py:107-123) from the
    port's layers: token and learned position embeddings, a post-norm gelu
    TransformerEncoder (FFN 4 x hidden, dropout 0.1: the identity in eval,
    the seeded masks while training), a 2-way Linear head on the first
    token.  Random weights from a generator seeded with ``seed`` on
    ``device`` (None: CUDA); ``hidden``, ``heads`` and ``vocab`` narrow it
    (default BERT-base's)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.nn.transformer import (
        TransformerEncoder,
        TransformerEncoderLayer,
    )

    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h, seq = hidden or BERT["hidden"], BERT["seq"]
    kw = dict(device=dev, dtype=dtype, generator=g)

    class BertClassifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = pnn.Embedding(vocab or BERT["vocab"], h, **kw)
            self.pos = pnn.Embedding(seq, h, **kw)
            self.encoder = TransformerEncoder(TransformerEncoderLayer(
                h, heads or BERT["heads"], 4 * h, dropout=0.1,
                activation="gelu", **kw), layers)
            self.cls = pnn.Linear(h, 2, **kw)

        def forward(self, ids):
            x = self.embed(ids) + self.pos(torch.arange(seq,
                                                        device=ids.device))
            return self.cls(self.encoder(x)[:, 0])

    return BertClassifier()


def _predictor(model, int8):
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = Config()
    cfg.set_layer(model)
    if int8:
        cfg.enable_weight_only_quant("int8")
    return create_predictor(cfg)


def _ms_per_run(torch, pred, ids, n=10):
    """Host time of ``pred.run`` (each run ends in the logits' copy to the
    host, which waits for the card), after one warm-up run."""
    pred.run([ids])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        pred.run([ids])
    return (time.perf_counter() - t) / n * 1e3


def full_width_predictor(torch, card):
    """Phase 9: BERT-base in bfloat16 through the float and the
    weight-only int8 Predictor; returns the predict path's launches."""
    import numpy as np

    from paddle_tpu_torch.inference import Int8Linear
    from paddle_tpu_torch.quantization import weight_quantize

    t = time.perf_counter()
    model = bert_classifier(torch, BERT["layers"], torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, BERT["vocab"], (BERT["batch"], BERT["seq"])
                       ).astype(np.int32)
    ids1 = ids[:1]
    fp = _predictor(model, int8=False)
    q8 = _predictor(model, int8=True)
    torch.cuda.synchronize()
    # the same predictors on the eager path, for the comparison
    fp_e = _predictor(model, int8=False)
    q8_e = _predictor(model, int8=True)
    fp_e._graphs = q8_e._graphs = False
    torch.cuda.synchronize()
    print(f"bert_base: {n_params} parameters, bf16; four predictors (float "
          f"and int8, graphs and eager) built in "
          f"{time.perf_counter() - t:.3f} s")
    ref = fp.run([ids])[0]
    if ref.shape != (BERT["batch"], 2) or not np.isfinite(ref).all():
        raise AssertionError(f"float logits {ref.shape} not finite [32, 2]")
    print(f"(a) float predictor: logits {ref.shape} {ref.dtype}, finite")
    q8.run([ids])           # the signature's first run: eager, captured
    torch.cuda.synchronize()
    counters = _zero_counters()
    got = q8.run([ids])[0]  # a replay
    launches = _path_launches("predict", counters)
    want = {"int8_matmul": 6 * BERT["layers"] + 1,
            "flash_attention": BERT["layers"]}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"one int8 run launched {launches}, "
                             f"expected {want}")
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError("int8 logits not finite")
    # every Int8Linear with a bias added it in B7's epilogue
    biased = sum(1 for m in q8._layer.modules()
                 if isinstance(m, Int8Linear) and m.bias is not None)
    fused = counters["int8_matmul"].bias_launches
    if fused != biased or biased != want["int8_matmul"]:
        raise AssertionError(f"{fused} B7 launches fused a bias, the run "
                             f"has {biased} biased Int8Linears")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"(b) int8 predictor, a replayed run: B7 "
          f"{launches['int8_matmul']} and B1 {launches['flash_attention']} "
          f"launches, all {fused} biased Int8Linears with the bias in B7's "
          f"epilogue, logits finite; largest difference from (a) {rel:.4f} "
          f"of the largest |logit| {float(np.abs(ref).max()):.4f} "
          "(informative)")
    w = model.encoder.layers[0].linear1.weight
    qg, sg = weight_quantize(w)
    qc, sc = weight_quantize(w.detach().cpu())
    if not (torch.equal(qg.cpu(), qc)
            and torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))):
        raise AssertionError("weight_quantize differs between cuda and cpu")
    print(f"(c) weight_quantize of a bf16 {list(w.shape)} weight: int8 "
          f"values and scales identical on cuda and the CPU")
    q8_evs = None
    for x in (ids, ids1):
        shape = f"[{x.shape[0]}, {x.shape[1]}]"
        for name, pred, eager in (("float", fp, fp_e), ("int8", q8, q8_e)):
            pred.run([x])               # [1, 128]: eager, captured
            a, b = pred.run([x])[0], eager.run([x])[0]   # a replay
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"{name} predictor {shape}: graphs differ from eager by "
                    f"{float(np.abs(a - b).max())}")
            for mode, p in (("graphs", pred), ("eager", eager)):
                ms = _ms_per_run(torch, p, x)
                print(f"(d) {name} predictor {shape}, {mode}: {ms:.3f} ms "
                      f"per run, {x.shape[0] / ms * 1e3:.1f} sequences/s "
                      f"({card}; informative)")
                evs = _profile(torch, f"{name} predictor {shape}, {mode}",
                               lambda p=p: p.run([x]))
                if name == "int8" and mode == "graphs" and x is ids:
                    q8_evs = evs
        print(f"(d) predictors {shape}: graphs == eager, bit for bit (float "
              "and int8)")
    for name, pred in (("float", fp), ("int8", q8)):
        cache = pred._graph_cache
        for key, (first, cap) in cache.seconds.items():
            print(f"graph {name} {key}: first run (eager) "
                  f"{first * 1e3:.1f} ms, capture {cap * 1e3:.1f} ms")
        if cache.captures != 2:
            raise AssertionError(f"{name} predictor: {cache.captures} "
                                 "captures for 2 input signatures")
    _no_bias_add(torch, q8, q8_evs)
    return launches


def _no_bias_add(torch, q8, evs):
    """No separate bias add in the int8 run: one biased Int8Linear's
    forward dispatches no aten add (its bias rides B7's epilogue; the
    launch is B7's custom op ``paddle_tpu_torch::int8_linear``, whose real
    implementation launches through ctypes), and the run's profile holds no
    more elementwise add kernels than the encoder's residual adds (2 a
    layer) and the position embedding's (the parent's 73 bias adds ran as
    adds of their own).  CUPTI may drop a session's first records, so the
    profile's count is a ceiling check, not an exact one."""
    lin = q8._layer.encoder.layers[0].linear1
    x = torch.randn(BERT["batch"], BERT["seq"], BERT["hidden"],
                    device="cuda", dtype=lin.bias.dtype)
    b7 = _counters()["int8_matmul"]
    n0, f0 = b7.launches, b7.bias_launches
    ops = _dispatches(torch, lambda: lin(x))
    adds = [op for op in ops if op.startswith("aten.") and "add" in op]
    if (adds or ops.count("paddle_tpu_torch.int8_linear.default") != 1
            or (b7.launches, b7.bias_launches) != (n0 + 1, f0 + 1)):
        raise AssertionError(f"one biased Int8Linear dispatched {ops} "
                             "beside one B7 launch with its bias")
    n_adds = sum(e.count for e in evs if "add" in e.key.lower()
                 and "int8" not in e.key)
    limit = 2 * BERT["layers"] + 1
    print(f"(e) a biased Int8Linear [{BERT['batch']}, {BERT['seq']}, "
          f"{BERT['hidden']}] is one B7 launch with its bias and dispatches "
          f"no add ({', '.join(sorted(set(ops))) or 'nothing else'}); "
          f"the int8 run's profile holds {n_adds} elementwise add kernels "
          f"(residuals and the position embedding: at most {limit})")
    if n_adds > limit:
        raise AssertionError(f"{n_adds} add kernels in the int8 run, more "
                             f"than its {limit} residual and embedding adds")


# -------------------------------------------------------------- phase 10
def predictor_kernels_vs_plain(torch):
    """Phase 10: a 2-layer BERT-width float32 classifier with identical
    weights on cuda and on the CPU, through int8 and float Predictors:
    identical quantized weights, logits within 1e-4 of the largest
    |logit|."""
    import numpy as np

    from paddle_tpu_torch.inference import Int8Linear
    from paddle_tpu_torch.nn import load_numpy_state_dict

    gm = bert_classifier(torch, 2, torch.float32, seed=1)
    cm = bert_classifier(torch, 2, torch.float32, device="cpu", seed=2)
    # biases start at zero and the encoder's layers are copies of one: give
    # every bias and norm weight its own seeded values, so B7's bias add
    # and each layer's own norms carry something
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    with torch.no_grad():
        for name, p in gm.named_parameters():
            r = torch.randn(p.shape, generator=g, device="cuda")
            if name.endswith("bias"):
                p.copy_(0.1 * r)
            elif "norm" in name:
                p.copy_(1.0 + 0.1 * r)
    load_numpy_state_dict(cm, {k: v.cpu().numpy()
                               for k, v in gm.state_dict().items()})
    ids = np.random.default_rng(3).integers(
        0, BERT["vocab"], (4, BERT["seq"])).astype(np.int32)
    for int8 in (True, False):
        pg, pc = _predictor(gm, int8), _predictor(cm, int8)
        if int8:
            mods = [(a, b) for a, b in zip(pg._layer.modules(),
                                           pc._layer.modules())
                    if isinstance(a, Int8Linear)]
            if len(mods) != 13 or not all(
                    torch.equal(a.qweight.cpu(), b.qweight)
                    and torch.equal(a.scale.cpu(), b.scale)
                    for a, b in mods):
                raise AssertionError("quantized weights differ between "
                                     "cuda and the CPU")
        lg, lc = pg.run([ids])[0], pc.run([ids])[0]
        err = float(np.abs(lg - lc).max())
        tol = 1e-4 * float(np.abs(lc).max())
        what = "int8" if int8 else "float"
        print(f"{what} predictor [4, {BERT['seq']}] cuda vs cpu: "
              f"max_abs_err {err:.3e} tol {tol:.3e}"
              + (" (13 qweights and scales identical)" if int8 else ""))
        if not err <= tol:
            raise AssertionError(f"{what} predictor logits differ beyond "
                                 "1e-4 of the largest |logit|")
    print("predictor kernel path == plain path (int8 and float)")


# -------------------------------------------------------------- phase 24
# phase 24's Llama: Llama-2-7B widths cut to 2 layers, [1, 256] in bf16;
# its float32 twin exported on cuda and on the CPU at [1, 128]
DEPLOY_LLAMA = dict(num_hidden_layers=2)
DEPLOY_IDS = (1, 256)
DEPLOY_F32_IDS = (1, 128)


def _launch_snapshot():
    """Every launch counter, and B7's fused-bias count as "int8_bias"."""
    c = _counters()
    snap = {k: fn.launches for k, fn in c.items()}
    snap["int8_bias"] = c["int8_matmul"].bias_launches
    return snap


def _launched_since(before):
    now = _launch_snapshot()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _replay_of(torch, pred, xs):
    """One more run of a predictor whose signature is captured (a replay):
    (its outputs, the launches it added)."""
    torch.cuda.synchronize()
    before = _launch_snapshot()
    out = pred.run(xs)[0]
    return out, _launched_since(before)


def _same_logits(np, what, got, ref):
    """Bit for bit; otherwise name the difference and hold bf16's 1.6% of
    the largest |logit| (the export would then have changed an op)."""
    if np.array_equal(got, ref):
        print(f"{what}: logits equal bit for bit")
        return
    err = float(np.abs(got - ref).max())
    tol = 1.6e-2 * float(np.abs(ref).max())
    print(f"{what}: logits differ by {err:.4e} (tol {tol:.4e}): the "
          "exported program changed an op")
    if not err <= tol:
        raise AssertionError(f"{what}: logits differ beyond bf16's 1.6%")


def _saved(torch, jit, layer, path, spec):
    """``jit.save`` of ``to_static(layer)`` -> (seconds, the export's
    seconds inside it, .pt2 bytes); an export error raises."""
    from paddle_tpu_torch.jit import serialization

    export, spent = serialization._export, []

    def timed(*args):
        t = time.perf_counter()
        try:
            return export(*args)
        finally:
            spent.append(time.perf_counter() - t)

    serialization._export = timed
    t = time.perf_counter()
    try:
        jit.save(jit.to_static(layer), path, input_spec=spec)
    finally:
        serialization._export = export
    secs = time.perf_counter() - t
    with open(path + ".pdmodel.json") as f:
        meta = json.load(f)
    if "export_error" in meta or not os.path.exists(path + ".pt2"):
        raise AssertionError(f"jit.save {path}: {meta.get('export_error')}")
    return secs, spent[0], os.path.getsize(path + ".pt2")


def _artifact(torch, path):
    """``Config(path)`` -> (the predictor, its load seconds)."""
    from paddle_tpu_torch.inference import Config, create_predictor

    t = time.perf_counter()
    pred = create_predictor(Config(path))
    torch.cuda.synchronize()
    return pred, time.perf_counter() - t


def _first_runs(torch, pred, xs):
    """A signature's first run (eager) and second (captured): their ms."""
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.run(xs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def full_width_deploy(torch, card, geo=BERT, llama_kw=None, device="cuda"):
    """Phase 24: jit.save / jit.load and the artifact Predictor at BERT-base
    and 2-layer 7B-width Llama widths, then to_static on the card; returns
    the deploy path's launches (the artifacts' runs).  ``geo`` (BERT's
    keys), ``llama_kw`` (LlamaConfig fields) and ``device`` let the phase
    be rehearsed on the CPU at a small width."""
    import copy
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.inference.predictor import (
        _rewrite_weight_only_int8,
    )
    from paddle_tpu_torch.jit import trace_state
    from paddle_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        llama_7b,
    )
    from paddle_tpu_torch.nn import functional as F

    tmp = tempfile.mkdtemp(prefix="deploy_")
    try:
        # the live paths: BERT-base's float and int8 predictors (a replay
        # each) and the Llama's eager forward, before the counts start
        model = bert_classifier(torch, geo["layers"], torch.bfloat16,
                                device=device, hidden=geo["hidden"],
                                heads=geo["heads"], vocab=geo["vocab"])
        rng = np.random.default_rng(24)
        ids = rng.integers(0, geo["vocab"], (geo["batch"], geo["seq"])
                           ).astype(np.int32)
        n_pad = geo["batch"] * 5 // 8          # 20 of 32
        padded = np.concatenate([ids[:n_pad], np.zeros_like(ids[n_pad:])])
        live = {}
        fp, q8 = _predictor(model, False), _predictor(model, True)
        for name, pred, x in (("float", fp, ids), ("int8", q8, ids),
                              ("padded", fp, padded)):
            _first_runs(torch, pred, [x])
            live[name] = _replay_of(torch, pred, [x])
        llama_kw = llama_kw or llama_7b(**DEPLOY_LLAMA).__dict__
        lm = LlamaForCausalLM(LlamaConfig(**{**llama_kw,
                                             "dtype": "bfloat16"}),
                              device=device, seed=24)
        lids = rng.integers(0, lm.config.vocab_size, DEPLOY_IDS
                            ).astype(np.int32)
        lids_t = torch.from_numpy(lids).to(device)
        with torch.no_grad():
            lm(lids_t)
            torch.cuda.synchronize()
            before = _launch_snapshot()
            lref = lm(lids_t)
            l_launches = _launched_since(before)
            lref = lref.float().cpu().numpy()

        # the artifacts: save (export + write), load
        spec = [jit.InputSpec([geo["batch"], geo["seq"]], "int32")]
        paths = {k: os.path.join(tmp, k) for k in ("float", "int8", "llama")}
        saves = {"float": _saved(torch, jit, model, paths["float"], spec),
                 "int8": _saved(torch, jit, _rewrite_weight_only_int8(model),
                                paths["int8"], spec),
                 "llama": _saved(torch, jit, lm, paths["llama"], [
                     jit.InputSpec(list(DEPLOY_IDS), "int32")])}
        preds = {name: _artifact(torch, paths[name])
                 for name in ("float", "int8", "llama")}
        print(f"(a) save (export + write; the export's ms; .pt2 bytes), then "
              f"load (Config(path) + create_predictor), {card}: "
              + "; ".join(f"{k} {v[0] * 1e3:.1f} ms ({v[1] * 1e3:.1f} ms; "
                          f"{v[2]} bytes), load {preds[k][1] * 1e3:.1f} ms"
                          for k, v in saves.items())
              + f" (BERT-base bf16 {list(ids.shape)}, its int8 rewrite, "
              f"Llama 2 layers at 7B width bf16 {DEPLOY_IDS})")

        # the deploy path: the artifacts' runs, counted from 0; the float
        # artifact's predictor then pads a batch of 20 (its config's
        # enable_batch_padding, read at each run)
        counters = _zero_counters()
        runs = {}
        for name, x in (("float", ids), ("int8", ids), ("llama", lids),
                        ("padded", ids[:n_pad])):
            pred = preds["float" if name == "padded" else name][0]
            if name == "padded":
                pred.config.enable_batch_padding()
            first = _first_runs(torch, pred, [x])
            runs[name] = (first, *_replay_of(torch, pred, [x]))
            if name == "float":
                steady = _ms_per_run(torch, pred, ids)
        launches = _path_launches("deploy", counters)
        for name, (first, _, _) in runs.items():
            print(f"(b) {name} artifact: first run {first[0]:.1f} ms, second "
                  f"{first[1]:.1f} ms "
                  + ("(replays of the float signature's graph)"
                     if name == "padded" else "(eager, then the capture)"))
        print(f"(b) float artifact {list(ids.shape)} steady: {steady:.3f} ms "
              f"per run "
              f"({card})")

        # the artifacts against the live paths
        for name, keys in (("float", ("flash_attention",)),
                           ("int8", ("int8_matmul", "int8_bias",
                                     "flash_attention")),
                           ("padded", ("flash_attention",))):
            got, n = runs[name][1], runs[name][2]
            ref, m = live[name]
            if name == "padded":
                ref = ref[:n_pad]
                if got.shape != (n_pad, 2):
                    raise AssertionError(f"padded run gave {got.shape}")
            _same_logits(np, f"(c) {name} artifact vs the live Predictor",
                         got, ref)
            if any(n.get(k, 0) != m.get(k, 0) or not n.get(k) for k in keys):
                raise AssertionError(f"{name} artifact launched {n}, the live "
                                     f"Predictor {m}")
            print(f"(c) {name}: a replay launched "
                  + ", ".join(f"{k} {n[k]}" for k in keys)
                  + ", as the live Predictor's")
        with_pad = preds["float"][0]
        try:
            with_pad.run([np.concatenate([ids, ids[:1]])])
        except ValueError as e:
            print(f"(c) batch {len(ids) + 1} with padding to {len(ids)}: "
                  f"ValueError ({e})")
        else:
            raise AssertionError("a batch past the artifact's ran")
        got, n = runs["llama"][1], runs["llama"][2]
        _same_logits(np, "(d) Llama artifact vs its live forward", got, lref)
        keys = ("rms_norm", "rms_norm_residual", "rope", "swiglu",
                "flash_attention")
        if {k: n.get(k) for k in keys} != {k: l_launches.get(k)
                                           for k in keys}:
            raise AssertionError(f"Llama artifact launched {n}, the live "
                                 f"forward {l_launches}")
        print("(d) Llama: a replay launched "
              + ", ".join(f"{k} {n[k]}" for k in keys)
              + ", as the live forward")
        del preds, runs, live, fp, q8

        # to_static on the card: one capture per key, replays launching
        # what eager launched
        st = jit.to_static(lm)
        with torch.no_grad():
            outs = []
            for _ in range(3):
                torch.cuda.synchronize()
                before = _launch_snapshot()
                outs.append(st(lids_t).float().cpu().numpy())
            n = _launched_since(before)
        cache = st._graph_cache
        if cache.captures != 1 or len(st._cache) != 1:
            raise AssertionError(f"to_static: {cache.captures} captures for "
                                 f"{len(st._cache)} keys")
        if n != l_launches:
            raise AssertionError(f"to_static replay launched {n}, eager "
                                 f"{l_launches}")
        for o in outs:
            _same_logits(np, "(e) to_static(Llama) vs its eager forward", o,
                         lref)
        print(f"(e) to_static(Llama): 1 capture, the replay launched {n}")

        def drop(x):
            return F.dropout(x, 0.5, training=True) * 2.0

        x = torch.randn(64, 1024, device=device)
        prandom.seed(24)
        sd = jit.to_static(drop)
        with torch.no_grad():
            got = [sd(x).clone() for _ in range(4)]
        prandom.seed(24)
        for i, g in enumerate(got):
            k = prandom.default_generator().next_key(device)
            with trace_state.activate(trace_state.TraceContext(k)):
                want = drop(x)
            if not torch.equal(g, want):
                raise AssertionError(f"to_static dropout call {i}: masks "
                                     "differ from eager's for the same key")
        if any(torch.equal(got[i], got[i + 1]) for i in range(3)):
            raise AssertionError("to_static dropout repeated a mask")
        if sd._graph_cache.captures != 1:
            raise AssertionError("to_static dropout captured more than once")
        print("(e) to_static dropout: 4 calls (eager, eager + capture, 2 "
              "replays), new masks each call, bit for bit eager's for the "
              "same keys")

        g = torch.Generator(device=device)
        g.manual_seed(24)
        from paddle_tpu_torch import nn as pnn

        class MidBreak(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.fc1 = pnn.Linear(1024, 1024, device=device, generator=g)
                self.fc2 = pnn.Linear(1024, 256, device=device, generator=g)

            def forward(self, x):
                h = self.fc1(x)
                s = float(h.detach().cpu().numpy().std()) + 1.0
                return self.fc2(h / s)

        net = MidBreak()
        sb = jit.to_static(net)
        with torch.no_grad():
            want = net(x)
            import warnings

            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                a, b = sb(x), sb(x)
        if (sb.last_segment_count != 2 or len(sb._fallback_keys) != 1
                or not any("graph break" in str(m.message) for m in w)
                or not (torch.equal(a, want) and torch.equal(b, want))):
            raise AssertionError(f"graph break: {sb.last_segment_count} "
                                 "segments, or values differ from eager")
        try:
            with torch.no_grad():
                jit.to_static(net, full_graph=True)(x)
        except RuntimeError as e:
            print(f"(e) a .numpy() mid-forward: 2 segments, eager's values; "
                  f"full_graph=True raises ({str(e)[:60]}...)")
        else:
            raise AssertionError("full_graph=True ran through a host read")

        # against the plain path: the float32 Llama exported on cuda and on
        # the CPU (its kernels' plain versions)
        lf = LlamaForCausalLM(LlamaConfig(**llama_kw), device=device,
                              seed=25)
        lc = copy.deepcopy(lf).to("cpu")
        fids = rng.integers(0, lf.config.vocab_size, DEPLOY_F32_IDS
                            ).astype(np.int32)
        fspec = [jit.InputSpec(list(DEPLOY_F32_IDS), "int32")]
        outs = {}
        for dev, m in ((device, lf), ("cpu", lc)):
            path = os.path.join(tmp, f"f32_{dev}")
            secs, _, size = _saved(torch, jit, m, path, fspec)
            t = time.perf_counter()
            loaded = jit.load(path)
            outs[dev] = loaded(fids).float().cpu().numpy()
            print(f"(f) float32 Llama artifact on {dev}: save {secs:.2f} s, "
                  f"{size} bytes, load + one run "
                  f"{time.perf_counter() - t:.2f} s")
            del loaded
        err = float(np.abs(outs[device] - outs["cpu"]).max())
        tol = 1e-4 * float(np.abs(outs["cpu"]).max())
        print(f"(f) float32 artifacts cuda vs cpu: max_abs_err {err:.3e} "
              f"tol {tol:.3e}")
        if not err <= tol:
            raise AssertionError("float32 artifacts differ beyond 1e-4 of the "
                                 "largest |logit|")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------------- phase 25
STATIC_TRAIN = (8, 2048)        # bench.py's batch, phase 7's
_TRAIN_STEP = {}                # phase 7's ms a step and peak bytes


def _steps_ms(torch, fn, n):
    """``fn()`` n times after a sync: (host ms a call, the results)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3, outs


def _c16_rows(torch, card, pair, prompt=(2, 7), new=8):
    """Phase 25 (c): C16 on the card.  A float32 2-layer Llama under
    ``auto_cast(O1, bf16)``: a 7-token prefill and one decode step over
    growing caches and over the static ring (the rows the step writes,
    cuda against the CPU's plain versions), then ``generate`` over the
    ring and over growing caches and ``greedy_decode`` (on graphs) for
    ``new`` tokens, against the same calls on the CPU."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.generation import generate, greedy_decode

    gpu, cpu = pair
    cfg = gpu.config
    rng = np.random.default_rng(25)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (prompt[0],
                                                            prompt[1] + 1)))
    B, S = prompt
    shape = (B, 0, cfg.num_key_value_heads, cfg.head_dim)
    for static in (False, True):
        rows = {}
        for name, m in (("cuda", gpu), ("cpu", cpu)):
            dev = next(m.parameters()).device
            if static:
                L = S + new
                caches = [(torch.zeros(B, L, *shape[2:], device=dev),
                           torch.zeros(B, L, *shape[2:], device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev))
                          for _ in range(cfg.num_hidden_layers)]
            else:
                caches = [(torch.zeros(shape, device=dev),
                           torch.zeros(shape, device=dev))
                          for _ in range(cfg.num_hidden_layers)]
            with torch.no_grad(), amp.auto_cast(level="O1",
                                                dtype="bfloat16"):
                for lo, hi in ((0, S), (S, S + 1)):
                    _, caches = m(ids[:, lo:hi].to(dev), caches=caches)
            rows[name] = [[t[:, S].float().cpu() for t in c[:2]]
                          for c in caches]
            if any(t.dtype != torch.float32 for c in caches for t in c[:2]):
                raise AssertionError("C16: a float32 cache changed dtype")
        for layer, (a, b) in enumerate(zip(rows["cuda"], rows["cpu"])):
            for kind, x, y in zip("kv", a, b):
                err = float((x - y).abs().max())
                ref = float(y.abs().max())
                # the first layer reads the embedding (the same bits on
                # both devices): the suite's float32 rule; the second one
                # the first one's bf16 products: bf16's rule
                tol = (1e-5 * ref + 1e-5 if layer == 0 else 2 ** -6 * ref)
                print(f"(c) C16 {'ring' if static else 'growing'} decode "
                      f"row, layer {layer} {kind}: max_abs_err {err:.3e} "
                      f"tol {tol:.3e}")
                if not err <= tol:
                    raise AssertionError("C16: the decode step's cache row "
                                         "differs from the CPU's")
    # the logits are bf16 under O1: ties one bf16 ulp apart are common at
    # this width, and the two devices round the products at other places;
    # so the tokens must equal the CPU's up to its first top-2 gap under
    # two ulps (2^-6 of the largest |logit|), and each token must be, on
    # the CPU over the card's own prefix, within two ulps of the argmax
    p = ids[:, :S]
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        want = greedy_decode(cpu, p, new)
        for what, static, call in (
                ("greedy_decode", True,
                 lambda x: greedy_decode(gpu, x, new)),
                ("generate ring", True, lambda x: generate(
                    gpu, x, new, use_static_cache=True)),
                ("generate growing", False,
                 lambda x: generate(gpu, x, new))):
            t = time.perf_counter()
            got = call(p.to(next(gpu.parameters()).device)).cpu()
            ms = (time.perf_counter() - t) * 1e3
            lg = _forced_logits(torch, cpu, p, want, static)
            gaps, thresh = _gaps(torch, lg), 2 ** -6 * float(lg.abs().max())
            own = _forced_logits(torch, cpu, p, got, static)
            picked = own.gather(-1, got.long()[..., None])[..., 0]
            worst = float((own.max(-1).values - picked).max())
            if not worst <= thresh:
                raise AssertionError(f"C16 {what}: a token {worst:.3e} "
                                     "below the CPU's argmax")
            same = []
            for r in range(B):
                _agree(got[r].tolist(), want[r].tolist(), gaps[r],
                       f"(c) C16 {what} O1 row {r} cuda vs cpu", thresh)
                same.append(next((i for i, (a, b) in enumerate(zip(
                    got[r].tolist(), want[r].tolist())) if a != b), new))
            print(f"(c) C16 {what} under O1 bf16 (no ValueError): tokens "
                  f"equal the CPU's for the first {same} of {new} a row, "
                  f"every token within {worst:.3e} of the CPU's argmax "
                  f"over its prefix (two bf16 ulps: {thresh:.3e}); "
                  f"{ms:.1f} ms host, {card}")


def full_width_static(torch, card, serve_kw=None, train_kw=TRAIN_AMP_MODEL,
                      batch=STATIC_TRAIN, pair=None, capture=None,
                      device="cuda"):
    """Phase 25: the ``static`` core at full width; returns the "static"
    path's launches: the serving program's runs (before and after the
    passes) and the training program's steps, counted from 0 (the eager
    references, the timings and the artifact's run are outside the
    count).

    (a) A 2-layer Llama-2-7B-width bf16 model recorded under
        ``program_guard`` with ``data("ids", [1, 256], "int32")``: the
        Executor's first run (eager, then the capture) and two replays
        equal the eager forward bit for bit and launch for launch; the
        later runs add no cache entry; DCE, CSE and constant folding leave
        the logits bit for bit; ``save_inference_model`` ->
        ``load_inference_model`` gives the same logits.
    (b) bench.py's Llama (phase 7's geometry, bf16 weights, float32
        masters, no recompute) at ``batch``:
        ``AdamW(...).minimize(model.pretraining_loss(ids, labels))`` and
        three ``Executor.run`` steps against an eager twin of the same
        weights, data and optimizer (run first, twice): step 0's loss bit
        for bit, later steps within 1e-5 (the backward's scatter-adds sum
        in atomics' order: two eager twins differ too), each kernel's
        launches a step equal; the program's checkpointed regions (the
        loss's chunks) replayed through ``checkpoint``; ms a step and
        peak memory above what was held before the model beside the
        twin's, and phase 7's.
    (c) C16's rows (``_c16_rows``) over ``pair`` (the float32 2-layer
        7B-width pair of phases 4, 6 and 8; made here when None).

    ``serve_kw`` (LlamaConfig fields), ``train_kw``, ``batch``, ``pair``,
    ``capture`` (a stand-in for ``jit.graphs``' capture) and ``device``
    let the phase be rehearsed on the CPU at a small width."""
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.jit.graphs import GraphCache
    from paddle_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        llama_7b,
    )
    from paddle_tpu_torch.ops.hopper import launch_counters
    from paddle_tpu_torch.optimizer import AdamW

    def executor():
        exe = static.Executor()
        if capture is not None:
            exe._graphs = True
            exe._graph_cache = GraphCache(device, counters=launch_counters,
                                          capture=capture,
                                          weights=exe._weights)
        return exe

    def record(build):
        pt.enable_static()
        try:
            prog = static.Program()
            t = time.perf_counter()
            with static.program_guard(prog), static.device_guard(device):
                out = build()
            return prog, out, time.perf_counter() - t
        finally:
            pt.disable_static()

    _c16_rows(torch, card, pair or two_layer_models(torch, seed=26))
    gc.collect()

    # (b)'s eager twin first, alone on the card, twice: the run-to-run
    # spread of eager training itself
    cfg = LlamaConfig(**{**train_kw, "dtype": "bfloat16"})
    B, S = batch
    data = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    tids = data.astype(np.int32)
    labels = np.roll(data, -1, axis=1).astype(np.int32)
    step_keys = ("rope_bwd", "swiglu_bwd", "flash_attention_bwd",
                 "fused_adamw", "rms_norm", "rms_norm_residual", "rope",
                 "swiglu", "flash_attention")

    def opt_for(m):
        return AdamW(learning_rate=1e-4, parameters=m.parameters(),
                     multi_precision=True)

    tids_t = torch.from_numpy(tids).to(device)
    lab_t = torch.from_numpy(labels).to(device)

    def eager_twin():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        twin = LlamaForCausalLM(cfg, device=device, seed=0)
        opt = opt_for(twin)

        def step():
            loss = twin.pretraining_loss(tids_t, lab_t)
            opt.minimize(loss)
            opt.clear_grad()
            return loss.detach()

        out, n = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            before = _launch_snapshot()
            ms, (lv,) = _steps_ms(torch, step, 1)
            out.append((float(lv), ms))
            n.append(_launched_since(before))
        # the training's own peak: above what was held before its model
        # was made (earlier phases' memory not counted)
        peak = torch.cuda.max_memory_allocated() - held
        del twin, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return out, n, peak

    eager, eager_n, eager_peak = eager_twin()
    again = eager_twin()[0]

    # (a)'s model and its eager forward
    serve_kw = serve_kw or llama_7b(**DEPLOY_LLAMA).__dict__
    lm = LlamaForCausalLM(LlamaConfig(**{**serve_kw, "dtype": "bfloat16"}),
                          device=device, seed=25)
    rng = np.random.default_rng(25)
    ids = rng.integers(0, lm.config.vocab_size, DEPLOY_IDS).astype(np.int32)
    ids_t = torch.from_numpy(ids).to(device)
    with torch.no_grad():
        lm(ids_t)
        torch.cuda.synchronize()
        before = _launch_snapshot()
        ref = lm(ids_t)
        eager_launches = _launched_since(before)
        ref = ref.float().cpu().numpy()

    def build_serving():
        x = static.data("ids", list(DEPLOY_IDS), "int32")
        with torch.no_grad():
            return x, lm(x)

    prog, (x_var, logits), secs = record(build_serving)
    print(f"(a) recorded the serving program: {len(prog.ops)} ops in "
          f"{secs:.2f} s, kernel ops "
          + json.dumps({k: sum(1 for *_, n in prog.ops
                               if f"paddle_tpu_torch.{k}." in n)
                        for k in ("rms_norm", "rms_norm_residual", "rope",
                                  "swiglu", "flash_attention")}))

    # the static path, counted from 0
    counters = _zero_counters()
    exe = executor()
    runs = []
    for i in range(3):
        n_keys = len(exe._cache)
        torch.cuda.synchronize()
        before = _launch_snapshot()
        replays = _REPLAYS[0]
        (got,) = exe.run(prog, feed={"ids": ids}, fetch_list=[logits])
        runs.append((got, _launched_since(before), _REPLAYS[0] - replays))
        if i and len(exe._cache) != n_keys:
            raise AssertionError("a second run at the same shape added an "
                                 "Executor cache entry")
    if exe._graph_cache is None or exe._graph_cache.captures != 1:
        raise AssertionError("the serving program was not captured once")
    keys = ("rms_norm", "rms_norm_residual", "rope", "swiglu",
            "flash_attention")
    for i, (got, n, replayed) in enumerate(runs):
        if not np.array_equal(got, ref):
            raise AssertionError(f"Executor run {i} differs from the eager "
                                 "forward")
        if {k: n.get(k) for k in keys} != {k: eager_launches.get(k)
                                           for k in keys}:
            raise AssertionError(f"Executor run {i} launched {n}, the eager "
                                 f"forward {eager_launches}")
        if i and capture is None and replayed != 1:
            raise AssertionError(f"Executor run {i} was not a graph replay")
    print(f"(a) Executor.run {list(DEPLOY_IDS)}: runs 1-3 equal the eager "
          "forward bit for bit and launched "
          + ", ".join(f"{k} {runs[1][1][k]}" for k in keys)
          + f" each, as eager; {len(exe._cache)} cache entry, "
          f"{exe._graph_cache.captures} capture, runs 2-3 graph replays")
    p2 = prog.clone()
    stats = static.PassManager([
        static.DeadCodeEliminationPass(keep=[logits]),
        static.CommonSubexpressionEliminationPass(),
        static.ConstantFoldingPass()]).run(p2)
    (got,) = exe.run(p2, feed={"ids": ids}, fetch_list=[logits])
    if not np.array_equal(got, ref):
        raise AssertionError("the passes changed the serving program's "
                             "logits")
    print(f"(a) passes {stats}: {len(prog.ops)} -> {len(p2.ops)} ops, "
          "logits bit for bit")

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model = LlamaForCausalLM(cfg, device=device, seed=0)

    def build_train():
        xi = static.data("ids", [B, S], "int32")
        xl = static.data("labels", [B, S], "int32")
        loss = model.pretraining_loss(xi, xl)
        opt_for(model).minimize(loss)
        return loss

    tprog, loss_var, secs = record(build_train)
    print(f"(b) recorded the training program: {len(tprog.ops)} ops in "
          f"{secs:.2f} s")
    from paddle_tpu_torch.static import _Region
    texe = executor()
    feed = {"ids": tids, "labels": labels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, step_n = [], []
    for _ in range(3):
        before = _launch_snapshot()
        ms, ((lv,),) = _steps_ms(torch, lambda: texe.run(
            tprog, feed=feed, fetch_list=[loss_var]), 1)
        steps.append((float(lv), ms))
        step_n.append(_launched_since(before))
    peak = torch.cuda.max_memory_allocated() - held
    launches = _path_launches("static", counters)
    n_regions = sum(isinstance(fn, _Region) for plan in texe._cache.values()
                    for fn, *_ in plan.ops)
    if not n_regions:
        raise AssertionError("the training program replayed no "
                             "checkpointed region (pretraining_loss's "
                             "chunks)")

    def spread(x, y):
        return max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(x, y))

    for i, ((a, _), (b, _), n, m) in enumerate(zip(steps, eager, step_n,
                                                    eager_n)):
        # step 0 is a forward of the same weights: bit for bit; later
        # steps carry the update from a backward whose scatter-adds (the
        # embedding's and the loss's gather) sum in atomics' order, which
        # moves between any two runs, eager ones too (``again``)
        if (a != b) if i == 0 else not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"static step {i} loss {a!r} differs from "
                                 f"the eager twin's {b!r}")
        if {k: n.get(k) for k in step_keys} != {k: m.get(k)
                                                for k in step_keys}:
            raise AssertionError(f"static step {i} launched {n}, the eager "
                                 f"twin {m}")
        if any(not n.get(k) for k in ("rope_bwd", "swiglu_bwd",
                                      "flash_attention_bwd", "fused_adamw")):
            raise AssertionError(f"static step {i} launched {n}: a backward "
                                 "kernel or B9 missing")
    if not steps[2][0] < steps[0][0]:
        raise AssertionError(f"static losses {steps} do not fall")
    seven = _TRAIN_STEP.get("ms")
    print(f"(b) static AdamW.minimize {[B, S]}: losses "
          f"{[s[0] for s in steps]}, the eager twin's "
          f"{[e[0] for e in eager]} and again {[e[0] for e in again]}: step "
          f"0 bit for bit, at most {spread(steps, eager):.2e} of the twin's "
          f"(tolerance 1e-5; twin against twin {spread(again, eager):.2e}); "
          "launches a step "
          + ", ".join(f"{k} {step_n[1].get(k)}" for k in step_keys)
          + f" == the twin's; ms a step {[round(s[1], 1) for s in steps]} "
          f"(eager twin {[round(e[1], 1) for e in eager]}), peak memory "
          f"{peak} bytes above what was held before the model (eager twin "
          f"{eager_peak}); {n_regions} checkpointed regions replayed "
          "through checkpoint; phase 7 (recompute, "
          + (f"TrainStep): {seven:.1f} ms a step, peak "
             f"{_TRAIN_STEP['peak']} bytes" if seven is not None
             else "TrainStep): not run")
          + f"; {card}")
    del model, tprog, texe
    gc.collect()
    torch.cuda.empty_cache()

    # outside the count: times and the artifact
    with torch.no_grad():
        eager_ms, _ = _steps_ms(torch, lambda: lm(ids_t), 20)
    run_ms, _ = _steps_ms(torch, lambda: exe.run(
        prog, feed={"ids": ids}, fetch_list=[logits], return_numpy=False),
        20)
    print(f"(a) {run_ms:.3f} ms an Executor.run {list(DEPLOY_IDS)} (the "
          "feed's copy, the replay, the output's clone) vs the eager "
          f"forward's {eager_ms:.3f} ms (host clock, 20 runs), {card}")
    tmp = tempfile.mkdtemp(prefix="static_")
    try:
        path = os.path.join(tmp, "llama")
        t = time.perf_counter()
        static.save_inference_model(path, [x_var], [logits], program=prog)
        saved = time.perf_counter() - t
        loaded, _, _ = static.load_inference_model(path)
        got = loaded(ids_t).float().cpu().numpy()
        _same_logits(np, f"(a) load_inference_model (saved in {saved:.2f} "
                     "s) vs the eager forward", got, ref)
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ main
# -------------------------------------------------------------- phase 11
def _repetitive_prompts(rng, V, n, length, period=8):
    """``n`` prompts of ``length`` tokens, each a random ``period``-token
    pattern repeated: n-gram drafting finds their tails in the history."""
    out = []
    for _ in range(n):
        pat = rng.integers(1, V, period).tolist()
        out.append((pat * (length // period + 1))[:length])
    return out


def _drafting_prompts(eng, prompts, rounds=6):
    """``prompts`` changed so that each one's greedy next token (served by
    ``eng``, a spec-off engine) is already one of its tokens: n-gram
    drafting then proposes a draft at the first decode step (random
    weights rarely repeat a token of the history on their own).  Each
    round writes a prompt's prediction over its next leading token, far
    from the end, until the prediction is in the prompt."""
    prompts = [list(p) for p in prompts]
    for r in range(rounds):
        nxt = _serve_waves(eng, [[(p, 1, None) for p in prompts]])
        todo = [(p, g) for p, (g,) in zip(prompts, nxt) if g not in p]
        if not todo:
            break
        for p, g in todo:
            p[r] = g
    print(f"drafting prompts: {len(prompts) - len(todo)} of {len(prompts)} "
          f"hold their next token after {r + 1} rounds")
    return prompts


def _spec_counts(eng):
    st = eng.state_summary()["spec"]
    vf = st["verify_forwards"]
    return (f"verify forwards (rows scored) {vf}, drafted {st['drafted']}, "
            f"accepted {st['accepted']}, tokens per verify "
            f"{(vf + st['accepted']) / max(vf, 1):.3f}")


def _logged_programs(eng, log):
    """Log each device program ``eng`` runs as (name, iterations): the
    single step, a megastep loop of K, the verify (K4 launches one kernel
    per layer per iteration); all go through ``_graphed``, on graphs and
    eagerly."""
    graphed = eng._graphed

    def run_graphed(key, fn, arrays):
        log.append((key[0], 1) if key[0] in ("spec", "step")
                   else (key[0], key[1]))
        return graphed(key, fn, arrays)

    eng._graphed = run_graphed


def _draw_margin(torch, lg, sampling, pos):
    """(margin, bfloat16 step) of the choice at sample index ``pos`` from
    the logits row ``lg`` [V]: the top-two logits of a greedy row, the
    top-two of the filtered, scaled logits plus the row's threefry Gumbel
    noise for a sampled one (the draw's argmax); the step is 2^-7 of the
    largest |logit|, scaled as the logits are."""
    from paddle_tpu_torch.framework.random import fold_in, gumbel, key
    from paddle_tpu_torch.inference.serving import _filtered

    step = 2.0 ** -7 * float(lg.abs().max())
    t = (sampling or {}).get("temperature", 0.0)
    score = lg
    if t > 0:
        filt = _filtered(lg[None] / t, torch.zeros(1, dtype=torch.int32),
                         torch.tensor([sampling.get("top_p", 1.0)]))[0]
        g = gumbel(fold_in(key(sampling["seed"]), pos), (lg.shape[0],))
        score, step = filt + g, step / t
    top2 = torch.topk(score, 2).values
    return float(top2[0] - top2[1]), step


def _spec_vs_off(torch, model, on, off, reqs):
    """Spec-on tokens against spec-off's: equal, or, from the first
    position where they differ, spec-off's choice there within
    bfloat16's step (``_draw_margin`` over spec-off's logits,
    teacher-forced on a fresh spec-off engine)."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    for i, ((prompt, _, sampling), a, b) in enumerate(zip(reqs, on, off)):
        if a == b:
            continue
        pos = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = _logits_at(torch, ServingEngine(model, **SERVE_KW), prompt,
                        b[:pos])
        margin, step = _draw_margin(torch, lg, sampling, pos)
        print(f"spec on vs off, request {i}: first differ at generated "
              f"position {pos} ({a[pos]} vs {b[pos]}); spec-off's margin "
              f"{margin:.4e}, bf16 step {step:.4e}")
        if not margin <= step:
            raise AssertionError(f"spec on and off differ at request {i} "
                                 f"position {pos} with a margin {margin} "
                                 f"past bf16's step {step}")


def full_width_spec(torch, model):
    """Phase 11a: speculative serving at 7B width (module docstring);
    returns the spec path's launches."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(11)
    probe = ServingEngine(model, prefix_cache=False, **SERVE_KW)

    def wave():
        sampled = dict(temperature=0.8, top_p=0.9, seed=5, logprobs=True)
        prompts = _drafting_prompts(probe, _repetitive_prompts(
            rng, cfg.vocab_size, 8, 64))
        return [(p, 64, sampled if i == 5 else dict(logprobs=True))
                for i, p in enumerate(prompts)]

    # checked, two warm waves (the keys they add captured), untraced,
    # traced
    waves = [wave() for _ in range(5)]
    probe = None
    on = ServingEngine(model, spec_k=SPEC_K, **SERVE_KW)
    eager = ServingEngine(model, spec_k=SPEC_K, **SERVE_KW)
    eager._graphs = False
    off = ServingEngine(model, **SERVE_KW)
    # no host sync inside a device program (the eager programs, a key's
    # first call and its capture) or a replay (main)
    for e in (on, eager, off):
        for name in ("_run_megastep", "_run_mixed", "_run_spec_verify"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    counters = _zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(on, waves[:1], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("spec", counters)
    if not on.spec_verify_forwards:
        raise AssertionError("the spec engine never ran its verify")
    print(f"spec_k {SPEC_K}, on graphs: {_spec_counts(on)}; wave of 8 x 64 "
          f"tokens in {secs:.3f} s (its captures included)")
    for key, (first, cap) in on._graph_cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not {("spec", True), ("spec", False)} & set(on._graph_cache.graphs):
        raise AssertionError("the verify was not captured")
    e_lps = []
    e_outs = _serve_waves(eager, waves[:1], e_lps)
    names = ("spec_verify_forwards", "spec_draft_tokens",
             "spec_accepted_tokens", "megasteps", "prefill_chunks")
    got = [getattr(on, n) for n in names]
    want = [getattr(eager, n) for n in names]
    if outs != e_outs or lps != e_lps or got != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"spec graphs and eager differ: tokens of "
                             f"requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}")
    print(f"spec graphs == eager: tokens, logprobs and {names} {got} "
          "identical over 8 requests (the seeded one too)")
    off_outs = _serve_waves(off, waves[:1])
    _spec_vs_off(torch, model, outs, off_outs, waves[0])
    same = sum(a == b for a, b in zip(outs, off_outs))
    print(f"spec on vs off: {same} of 8 requests token for token equal")
    # the decode-heavy waves: a warm one (the keys it adds captured), then
    # the untraced wall and busy share in each mode, and K4 in each trace:
    # kernels against wrapper calls, and each program's K4 kernels (tagged
    # by the order the programs ran)
    for label, e in (("spec on", on), ("spec off", off)):
        calls, log, kernels, caps = [], [], [], []
        _serve_waves(e, waves[1:3])

        def untraced(e=e, caps=caps):
            n_cap = e.compile_count
            _serve_waves(e, [waves[3]])
            caps.append(e.compile_count - n_cap)

        def traced(e=e, calls=calls, log=log):
            log.clear()             # a trace taken again logs again
            n0 = pa.paged_attention.launches
            _logged_programs(e, log)
            try:
                _serve_waves(e, [waves[4]])
            finally:
                del e._graphed
            calls.append(pa.paged_attention.launches - n0)

        evs = _profile(torch, f"decode wave, {label} (8 rows, repetitive "
                       "64-token prompts, 64 new tokens)", untraced, traced,
                       top=10, trace=kernels)
        print(f"{label}, over its 5 waves: {_spec_counts(e)}; megasteps "
              f"{e.megasteps}; "
              f"graphs captured in the untraced wave {caps[0]}")
        _k1_k2(evs, f"the decode wave, {label}")
        k4 = [k for k in kernels if "paged_attention" in k.name]
        if len(k4) != calls[-1]:
            raise AssertionError(f"K4 ({label}): {len(k4)} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([k.name for k in k4], f"K4 in the decode wave, {label}")
        tags = [name for name, n in log for _ in range(n * L)]
        if len(tags) != len(k4):
            raise AssertionError(f"K4 ({label}): {len(k4)} kernels for "
                                 f"{len(tags)} by the programs run")
        for name in sorted(set(tags)):
            us = [k.time_range.end - k.time_range.start
                  for k, tag in zip(k4, tags) if tag == name]
            print(f"profile K4 in the decode wave, {label}, {name}: "
                  f"{len(us)} kernels, {sum(us) / 1e3:.3f} ms, "
                  f"{sum(us) / len(us):.2f} us a launch")
    return launches


def full_width_transfer(torch, model):
    """Phase 11b: block transfer at 7B width (module docstring)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                     prompt_block_hashes)

    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, model.config.vocab_size, 256).tolist()
               for _ in range(8)]
    chains = [prompt_block_hashes(p, SERVE_KW["block_size"])
              for p in prompts]
    warm = [[(p, 1, None) for p in prompts]]
    a = ServingEngine(model, **SERVE_KW)
    _serve_waves(a, warm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    payloads = [a.export_blocks_packed(c) for c in chains]
    export_s = time.perf_counter() - t
    nbytes = sum(len(raw) for _, raw in payloads)
    if any(h["hashes"] != c for (h, _), c in zip(payloads, chains)):
        raise AssertionError("an export stopped short of its chain")
    a = None
    b = ServingEngine(model, **SERVE_KW)
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = sum(b.import_blocks_packed(h, raw) for h, raw in payloads)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    print(f"block transfer: 8 chains of {len(chains[0])} blocks, {nbytes} "
          f"bytes; export {export_s * 1e3:.2f} ms "
          f"({nbytes / export_s / 1e9:.2f} GB/s), import {n} blocks "
          f"{import_s * 1e3:.2f} ms ({nbytes / import_s / 1e9:.2f} GB/s)")
    if n != sum(len(c) for c in chains):
        raise AssertionError(f"imported {n} blocks")
    if [b.export_blocks_packed(c) for c in chains] != payloads:
        raise AssertionError("the importer's export differs from the "
                             "exported bytes")
    c = ServingEngine(model, **SERVE_KW)
    _serve_waves(c, warm)
    wave = [[(p, 32, None) for p in prompts]]
    got, want = _serve_waves(b, wave), _serve_waves(c, wave)
    if b.prefix_hit_blocks != n or c.prefix_hit_blocks != n:
        raise AssertionError(f"prefix hits {b.prefix_hit_blocks} on the "
                             f"imported blocks, {c.prefix_hit_blocks} warm")
    if got != want:
        raise AssertionError("serving on imported blocks differs from "
                             "serving on locally warmed ones")
    print(f"block transfer: the importer's export is the exported bytes; "
          f"served on {n} imported blocks (prefix hits {n}) == served on "
          "locally warmed ones, bit for bit, 8 x 32 tokens")


def spec_and_transfer_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4's float32 pair: speculative serving (spec_k 8) on cuda
    against the CPU plain path, then a packed export made on the card
    imported into a CPU engine, serving wave 2 on it."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                     prompt_block_hashes)

    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128)
    rng = np.random.default_rng(17)
    prompts = _drafting_prompts(
        ServingEngine(gpu_model, prefix_cache=False, **kw),
        _repetitive_prompts(rng, gpu_model.config.vocab_size, 4, 40))
    waves = [[(p, 16, None) for p in prompts], [(prompts[1], 16, None)]]
    gpu_eng = ServingEngine(gpu_model, spec_k=SPEC_K, **kw)
    gpu = _serve_waves(gpu_eng, waves)
    cpu_eng = ServingEngine(cpu_model, spec_k=SPEC_K, device="cpu", **kw)
    cpu = _serve_waves(cpu_eng, waves)
    if not gpu_eng.spec_verify_forwards:
        raise AssertionError("the spec engine never ran its verify")
    flat = [p for w in waves for p, _, _ in w]
    gaps = [_top2_gaps(torch, ServingEngine(cpu_model, device="cpu", **kw),
                       p, cpu[i]) for i, p in enumerate(flat)]
    for i in range(len(flat)):
        _agree(gpu[i], cpu[i], gaps[i], f"spec request {i} cuda vs cpu")
    print(f"spec_k {SPEC_K}: kernel path == plain path on {len(flat)} "
          f"requests; cuda {_spec_counts(gpu_eng)}; cpu "
          f"{_spec_counts(cpu_eng)}")
    src = ServingEngine(gpu_model, **kw)
    _serve_waves(src, waves[:1])
    hashes = prompt_block_hashes(prompts[1], kw["block_size"])
    header, raw = src.export_blocks_packed(hashes)
    dst = ServingEngine(cpu_model, device="cpu", **kw)
    n = dst.import_blocks_packed(header, raw)
    got = _serve_waves(dst, waves[1:])
    if n != len(hashes) or dst.prefix_hit_blocks != n:
        raise AssertionError(f"imported {n} of {len(hashes)} blocks, "
                             f"prefix hits {dst.prefix_hit_blocks}")
    _agree(got[0], cpu[-1], gaps[-1], "wave 2 on blocks from cuda vs cpu")
    print(f"block transfer cuda -> cpu: {n} blocks, {len(raw)} bytes; "
          "wave 2 on them == the CPU engine's wave 2")


# --------------------------------------------------------- phases 4, 12
def _int8_gaps(torch, cpu_model, kw, prompt, n):
    """The top-2 logit gap at each of the ``n`` greedy tokens a CPU int8
    engine (``kw``) gives ``prompt`` served alone: its own quantized
    decode, read off each logits row it samples from (slot 0; the frozen
    iterations after the last token come after these)."""
    from paddle_tpu_torch.inference import serving

    eng = serving.ServingEngine(cpu_model, device="cpu", **kw)
    gaps = []
    sample = serving._sample_tokens

    def recording(logits, *args, **kwargs):
        top2 = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top2[0] - top2[1]))
        return sample(logits, *args, **kwargs)

    serving._sample_tokens = recording
    try:
        rid = eng.add_request(prompt, max_new_tokens=n)
        eng.run()[rid]
    finally:
        serving._sample_tokens = sample
    return gaps[:n]


def int8_kernels_vs_plain(torch, gpu_model, cpu_model):
    """Phase 4: the int8 engine (K4-int8) on cuda against the CPU plain
    path from identical weights: greedy tokens equal up to the first
    position whose top-2 gap on the CPU (its own int8 decode) is below
    1e-3, logprobs there within 1e-3 of the largest |logprob| + 1e-3."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg = gpu_model.config
    kw = dict(max_batch_size=4, max_seq_len=128, block_size=16,
              token_budget=128, cache_quant="int8")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 48, 20)]
    lp = dict(logprobs=True)
    waves = [[(p, 16, lp) for p in prompts], [(prompts[1], 16, lp)]]
    g_lps, c_lps = [], []
    gpu_eng = ServingEngine(gpu_model, **kw)
    gpu = _serve_waves(gpu_eng, waves, g_lps)
    cpu = _serve_waves(ServingEngine(cpu_model, device="cpu", **kw), waves,
                       c_lps)
    if gpu_eng.megasteps_mixed or not gpu_eng.megasteps:
        raise AssertionError("the int8 engine ran a mixed loop or no "
                             "megastep")
    worst = 0.0
    flat = [p for w in waves for p, _, _ in w]
    for i, p in enumerate(flat):
        gaps = _int8_gaps(torch, cpu_model, kw, p, len(cpu[i]))
        _agree(gpu[i], cpu[i], gaps, f"int8 request {i} cuda vs cpu")
        stop = next((j for j, g_ in enumerate(gaps) if g_ < 1e-3),
                    len(gaps))
        a, b = np.array(g_lps[i][:stop]), np.array(c_lps[i][:stop])
        err = float(np.abs(a - b).max()) if stop else 0.0
        tol = 1e-3 * float(np.abs(b).max()) + 1e-3 if stop else 0.0
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"int8 request {i}: logprobs differ by "
                                 f"{err} > {tol}")
    print(f"int8 cache: kernel path == plain path on {len(flat)} requests "
          f"(logprobs max_abs_err {worst:.3e}); megasteps "
          f"{gpu_eng.megasteps}, mixed 0, prefill chunks "
          f"{gpu_eng.prefill_chunks}")


def _cache_bytes(eng):
    """The bytes of an engine's KV pools (drop block included) and, for
    the int8 cache, its scales."""
    n = sum(c.numel() * c.element_size()
            for c in eng.key_caches + eng.value_caches)
    for sc in eng.cache_scales or ():
        n += sum(t.numel() * t.element_size() for t in sc.values())
    return n


def full_width_int8(torch, model):
    """Phase 12: the 7B geometry served over the int8 KV cache on CUDA
    graphs and on the eager loops (identical tokens, logprobs and
    counters), its tokens beside a bf16-cache engine's (printed), cache
    bytes, and the decode wave profiled on each with K4-int8's kernels
    against its wrapper's count."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    cfg = model.config
    eng = ServingEngine(model, cache_quant="int8", megastep_k=8, **SERVE_KW)
    eager = ServingEngine(model, cache_quant="int8", megastep_k=8,
                          **SERVE_KW)
    eager._graphs = False
    bf16 = ServingEngine(model, megastep_k=8, **SERVE_KW)
    print(f"KV cache bytes: int8 {_cache_bytes(eng)} (pools and scales), "
          f"bf16 {_cache_bytes(bf16)}, ratio "
          f"{_cache_bytes(eng) / _cache_bytes(bf16):.4f}")
    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    greedy = dict(logprobs=True)
    sampled = dict(temperature=0.8, top_p=0.9, seed=7, logprobs=True)
    # prompts up to token_budget (int8 prefills in one step)
    lens = [7, 40, 128, 200, 256, 33, 250, 90, 150]
    news = [48, 32, 64, 40, 56, 1, 36, 60, 44]
    wave1 = [(prompt(n), m, sampled if i == 3 else greedy)
             for i, (n, m) in enumerate(zip(lens, news))]
    wave2 = [(wave1[2][0], 32, greedy), (prompt(70), 40, greedy)]
    for e in (eng, eager):
        for name in ("_run_megastep", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
    replays0 = _REPLAYS[0]
    counters = _zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lps = []
    outs = _serve_waves(eng, [wave1, wave2], lps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _path_launches("int8", counters)
    if launches["paged_attention"]:
        raise AssertionError("the int8 engine launched K4 over a bf16 cache")
    n_tok = sum(len(o) for o in outs)
    print(f"int8 served {len(outs)} requests, {n_tok} tokens in {secs:.3f} "
          f"s ({n_tok / secs:.1f} tokens/s, informative); "
          f"{_REPLAYS[0] - replays0} graph replays under CUDA sync "
          f"debugging set to raise; megasteps {eng.megasteps}, mixed "
          f"{eng.megasteps_mixed}, prefill chunks {eng.prefill_chunks}")
    if not eng.megasteps or eng.megasteps_mixed or eng.prefix_hit_blocks:
        raise AssertionError("the int8 run did not arm the megastep, or "
                             "armed the mixed loop or the prefix cache")
    kd = eng.cache_scales[0]["kd"]
    if not bool(torch.isfinite(kd).all()):
        raise AssertionError("non-finite int8 cache scales")
    e_lps = []
    e_outs = _serve_waves(eager, [wave1, wave2], e_lps)
    names = ("megasteps", "megasteps_mixed", "prefill_chunks")
    got = [getattr(eng, n) for n in names]
    want = [getattr(eager, n) for n in names]
    # every layer's dynamic scales, refreshed in place by the steps'
    # graphs on one engine and eagerly on the other
    scales = all(torch.equal(a[n], b[n]) for a, b in
                 zip(eng.cache_scales, eager.cache_scales) for n in a)
    if outs != e_outs or lps != e_lps or got != want or not scales:
        bad = [i for i, (a, b) in enumerate(zip(outs, e_outs)) if a != b]
        raise AssertionError(f"int8 graphs and eager loops differ: tokens "
                             f"of requests {bad}, logprobs equal "
                             f"{lps == e_lps}, {names} {got} vs {want}, "
                             f"cache_scales equal {scales}")
    cache = eng._graph_cache
    for key, (first, cap) in cache.seconds.items():
        print(f"graph {key}: first call (eager) {first * 1e3:.1f} ms, "
              f"capture {cap * 1e3:.1f} ms")
    if not any(k[0] == "step" for k in cache.graphs):
        raise AssertionError("the int8 single step was not captured")
    print(f"int8 graphs == eager: tokens, logprobs, {names} {got} and the "
          f"{len(eng.cache_scales)} layers' cache_scales identical over "
          f"{len(outs)} requests (the sampled one too); compile_count "
          f"{eng.compile_count}, step keys "
          f"{sorted(k for k in cache.graphs if k[0] == 'step')}")
    b_outs = _serve_waves(bf16, [wave1, wave2])
    same = sum(a == b for o, r in zip(outs, b_outs) for a, b in zip(o, r))
    first = [next((j for j, (a, b) in enumerate(zip(o, r)) if a != b),
                  len(o)) for o, r in zip(outs, b_outs)]
    print(f"int8 vs bf16 cache: {same} of {n_tok} tokens agree by position "
          f"({same / n_tok:.4f}); first difference per request {first} "
          "(informative)")
    waves = [[(prompt(64), 32, None) for _ in range(8)] for _ in range(3)]
    for label, e in (("graphs", eng), ("eager", eager)):
        calls = []
        meter = _step_meter(torch, e)
        stepped = {"first": {}, "untraced": {}, "traced": {}}

        def traced(e=e):
            n0 = pa.paged_attention_int8.launches
            _serve_waves(e, [waves[2]])
            calls.append(pa.paged_attention_int8.launches - n0)

        n_cap = e.compile_count
        _metered(meter, lambda e=e: _serve_waves(e, [waves[0]]),
                 stepped["first"])()
        print(f"int8 decode wave, {label}, first: "
              f"{e.compile_count - n_cap} graphs captured in it")
        n_cap = e.compile_count
        evs = _profile(torch, f"int8 decode wave, {label} (8 rows, 64-token "
                       "prompts, 32 new tokens)",
                       _metered(meter, lambda e=e: _serve_waves(e, [waves[1]]),
                                stepped["untraced"]),
                       _metered(meter, traced, stepped["traced"]), top=15)
        _step_report("int8 decode wave", label, stepped, e is eng)
        print(f"int8 decode wave, {label}: graphs captured in the measured "
              f"waves {e.compile_count - n_cap}")
        _k1_k2(evs, f"the int8 decode wave, {label}")
        k4 = [ev for ev in evs if "paged_attention_int8" in ev.key]
        k4_n = sum(ev.count for ev in k4)
        k4_ms = sum(ev.self_device_time_total for ev in k4) / 1e3
        print(f"profile K4-int8 in the int8 decode wave, {label}: "
              f"{k4_ms:.3f} ms device, {k4_n} kernels "
              f"({1e3 * k4_ms / max(k4_n, 1):.2f} us a launch), "
              f"{calls[-1]} wrapper calls")
        if k4_n != calls[-1] or not k4_n:
            raise AssertionError(f"K4-int8 ({label}): {k4_n} kernels for "
                                 f"{calls[-1]} calls")
        _unmasked([ev.key for ev in k4],
                  f"K4-int8 in the int8 decode wave, {label}")
    return launches


# -------------------------------------------------------------- phase 13
# the public block_multihead_attention at the Llama-2-7B attention
# geometry (phases 3 and 12): 32 heads of 128, batch 8, max_seq_len 512 in
# blocks of 64 (8 a row), one [64, KV, 64, 128] pool pair a layer; depth
# cut to 8 of the 32 layers (each layer's calls are checked alone), so
# that the full run keeps its limit with phase 24
BLHA = dict(batch=8, max_seq_len=512, block_size=64, layers=8, heads=32,
            head_dim=128, decode_steps=32,
            prompts=(7, 400, 128, 256, 33, 300, 90, 150))


class _PlainKernels:
    """Within the block, ``ops.paged_attention`` (what blha_attention
    calls) runs the plain PyTorch versions of K2, K4 and K4-int8 on the
    card's tensors: the wrapper's plain twin."""

    def __enter__(self):
        from paddle_tpu_torch.ops import paged_attention as blha
        from paddle_tpu_torch.ops.hopper import fused_ops
        from paddle_tpu_torch.ops.hopper import paged_attention as pa

        self.mod = blha
        self.saved = {n: getattr(blha, n) for n in (
            "rope_fused", "paged_attention", "paged_attention_int8")}
        blha.rope_fused = (lambda q, k, cos, sin, interleaved=False:
                           fused_ops._rope_ref(q, k, cos, sin, interleaved))
        blha.paged_attention = pa._paged_attention_ref
        blha.paged_attention_int8 = pa._paged_attention_int8_ref
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)


def _alibi_masks(torch, H, lens, Lp, L, decode_pos=None):
    """Additive masks of a model with linear position biases, float32 on the
    card: head h's slope 2^(-8 (h + 1) / H) times the distance s - j on
    visible keys, -1e4 on padding.  A prefill (``decode_pos`` None): mask
    [B, H, max, Lp + L], row s of row b live while s < its length, its
    visible keys the prefix (bias 0) and paged keys j <= s.  A decode step:
    tgt_mask [B, H, 1, Lp + L] at each row's position."""
    dev = "cuda"
    slope = 2.0 ** (-8.0 * torch.arange(1, H + 1, device=dev) / H)
    j = torch.arange(Lp + L, device=dev) - Lp            # paged key index
    if decode_pos is None:
        n = torch.tensor(lens, device=dev)
        s = torch.arange(int(n.max()), device=dev)
        dist = (s[:, None] - j[None, :]).clamp(min=0).float()   # [S, Lk]
        ok = ((j[None, None, :] <= s[None, :, None])
              & (s[None, :, None] < n[:, None, None]))            # [B, S, Lk]
        ok = ok | (j < 0)[None, None, :]
        m = -slope[None, :, None, None] * dist[None, None]
        return torch.where(ok[:, None], m, -1e4).contiguous()
    pos = torch.tensor(decode_pos, device=dev)
    dist = (pos[:, None] - j[None, :]).clamp(min=0).float()       # [B, Lk]
    ok = (j[None, :] <= pos[:, None]) | (j < 0)[None, :]
    m = -slope[None, :, None] * dist[:, None, :]                  # [B, H, Lk]
    return torch.where(ok[:, None], m, -1e4)[:, :, None].contiguous()


def _blha_run(torch, KV, quant, Lp, layers=None, dtype=None, device="cuda",
              plain=False, seed=13):
    """One run of the wrapper: a prefill call a layer (prompts of 7-400
    tokens under an ALiBi causal-plus-padding ``mask``), then
    ``decode_steps`` decode calls a layer under ``tgt_mask``, over fresh
    pools per layer (``quant`` "none": q's dtype, else uint8 with static
    [KV] or dynamic [B, KV] scales), rope at absolute positions (neox), a
    ``Lp``-key pre-cache per layer where Lp > 0.  Seeded on the card, the
    same inputs for the same ``seed`` on either device.  ``plain`` runs the
    plain twin (``_PlainKernels``).  Returns (the outputs of every call,
    the pools, the scale tensors, wall seconds of the prefill and decode
    calls, the number of calls, the pools' data_ptr() before and after)."""
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention,
    )

    c = BLHA
    dtype = dtype or torch.bfloat16
    layers = layers or c["layers"]
    B, bs, H, D = c["batch"], c["block_size"], c["heads"], c["head_dim"]
    P = c["max_seq_len"] // bs
    NB = B * P
    lens = list(c["prompts"])
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    bt = torch.randperm(NB, generator=g, device="cuda").view(B, P).to(
        torch.int32)
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device="cuda") / D))
    fr = torch.arange(c["max_seq_len"], device="cuda")[:, None] * inv
    rope = torch.stack([fr.cos(), fr.sin()])[:, None, :, None, :].float()
    cdt = torch.uint8 if quant != "none" else dtype
    pools = [[torch.zeros(NB, KV, bs, D, dtype=cdt, device="cuda")
              for _ in range(2)] for _ in range(layers)]
    pre = [dict(pre_key_cache=rnd(B, KV, Lp, D),
                pre_value_cache=rnd(B, KV, Lp, D)) if Lp else {}
           for _ in range(layers)]
    names = ("cache_k_quant_scales", "cache_v_quant_scales",
             "cache_k_dequant_scales", "cache_v_dequant_scales")
    if quant == "static":
        kq = torch.full((KV,), 127.0 / 4, device="cuda")
        scales = [dict(zip(names, (kq, kq.clone(), 1 / kq, 1 / kq)))
                  for _ in range(layers)]
    elif quant == "dynamic":
        scales = [{n: torch.zeros(B, KV, device="cuda") for n in names}
                  for _ in range(layers)]
    else:
        scales = [{} for _ in range(layers)]
    mask = _alibi_masks(torch, H, lens, Lp, P * bs)
    W = (H + 2 * KV) * D
    steps = [(lens, [0] * B, lens, dict(mask=mask))]
    for t in range(c["decode_steps"]):
        pos = [n + t for n in lens]
        steps.append(([0] * B, pos, [1] * B, dict(
            tgt_mask=_alibi_masks(torch, H, lens, Lp, P * bs, pos))))
    # every call's qkv, made up front from the seed
    qkvs = [[rnd(sum(now), W) for _ in range(layers)]
            for _, _, now, _ in steps]
    dev = torch.device(device)
    move = (lambda t: t.to(dev)) if dev.type == "cpu" else (lambda t: t)
    pools = [[move(t) for t in pr] for pr in pools]
    pre = [{k: move(v) for k, v in d.items()} for d in pre]
    scales = [{k: move(v) for k, v in d.items()} for d in scales]
    rope, bt = move(rope), move(bt)
    ptrs = [[t.data_ptr() for t in pr] for pr in pools]
    outs, secs = [], [0.0, 0.0]
    with _PlainKernels() if plain else contextlib.nullcontext():
        for i, (enc, dec, now, masks) in enumerate(steps):
            cu = [0]
            for n in now:
                cu.append(cu[-1] + n)
            ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                    for x in (enc, dec, now, cu)]
            kw = {k: move(v) for k, v in masks.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for layer in range(layers):
                out = block_multihead_attention(
                    move(qkvs[i][layer]), *pools[layer], *ints[:3], None,
                    None, ints[3], ints[3], bt, rope_emb=rope,
                    block_size=bs, use_neox_style=True,
                    use_dynamic_cachekv_quant=quant == "dynamic",
                    **pre[layer], **scales[layer], **kw)[0]
                outs.append(out)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs[min(i, 1)] += time.perf_counter() - t0
    after = [[t.data_ptr() for t in pr] for pr in pools]
    return (outs, pools, scales, secs, len(steps) * layers, ptrs, after)


def full_width_blha(torch):
    """Phase 13: the public incubate.nn.functional.block_multihead_attention
    at full width (``BLHA``, 8 layers): per run, a prefill call a layer
    and 32 decode steps of every layer; bf16, static and dynamic int8
    pools, a 64-key pre-cache, GQA 32 / 8.  Each run's outputs held against
    its plain
    twin on the card (K2, K4 and K4-int8 replaced by their plain
    versions), the pools and scales after the run too; K4 / K4-int8 and K2
    launches equal to the wrapper's calls, every one a masked launch; the
    pools written in place; ms a call.  Then a float32 two-layer run
    against the same wrapper on the CPU."""
    from paddle_tpu_torch.ops.hopper import fused_ops
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    counters = _zero_counters()
    runs = (("bf16", 32, "none", 0), ("static int8", 32, "static", 0),
            ("dynamic int8", 32, "dynamic", 0),
            ("bf16, 64-key pre-cache", 32, "none", 64),
            ("bf16, GQA 32 / 8", 8, "none", 0))
    for label, KV, quant, Lp in runs:
        kern = (pa.paged_attention_int8 if quant != "none"
                else pa.paged_attention)
        n0, m0, r0 = kern.launches, kern.mask_launches, \
            fused_ops.rope_fused.launches
        outs, pools, scales, secs, calls, ptrs, after = _blha_run(
            torch, KV, quant, Lp)
        launched = (kern.launches - n0, kern.mask_launches - m0,
                    fused_ops.rope_fused.launches - r0)
        if launched != (calls, calls, calls) or ptrs != after:
            raise AssertionError(
                f"blha {label}: {launched} kernel / masked / K2 launches for "
                f"{calls} calls, or a pool moved ({ptrs != after})")
        p_outs, p_pools, p_scales, *_ = _blha_run(torch, KV, quant, Lp,
                                                  plain=True)
        worst = 0.0
        for got, ref in zip(outs, p_outs):
            err, tol = _err(torch, got, ref), _tol("bfloat16", ref)
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"blha {label}: the wrapper and its "
                                     f"plain twin differ by {err} > {tol}")
        codes = 1.0
        for pr, qr in zip(pools, p_pools):
            for a, b in zip(pr, qr):
                if quant == "none":
                    if not _err(torch, a, b) <= _tol("bfloat16", b):
                        raise AssertionError(f"blha {label}: pools differ")
                else:
                    d = (a.int() - b.int()).abs()
                    codes = min(codes, float((d == 0).float().mean()))
                    if int(d.max()) > 1:
                        raise AssertionError(f"blha {label}: codes differ "
                                             "by more than 1")
        for sa, sb in zip(scales, p_scales):
            for n in sa:
                if not torch.allclose(sa[n], sb[n], rtol=1e-2) or not bool(
                        (sa[n] > 0).all()):
                    raise AssertionError(f"blha {label}: scales {n} differ "
                                         "from the plain twin's or are 0")
        if codes < 0.99:
            raise AssertionError(f"blha {label}: {codes:.4f} of the codes "
                                 "equal the plain twin's")
        n_dec = calls - BLHA["layers"]
        print(f"blha {label}: {calls} calls ({BLHA['layers']} prefill of "
              f"{sum(BLHA['prompts'])} tokens, {n_dec} decode), "
              f"{launched[0]} {kern.__name__} launches, all masked, "
              f"{launched[2]} K2; prefill {1e3 * secs[0] / BLHA['layers']:.3f}"
              f" ms a call, decode {1e3 * secs[1] / n_dec:.3f} ms a call "
              f"(host wall, a host read each); outputs within "
              f"{worst:.3f} of the tolerance of the plain twin, pools in "
              f"place" + ("" if quant == "none" else
                          f", {codes:.4f} of the codes equal"), flush=True)
    launches = _path_launches("blha", counters)
    # float32, two layers: the wrapper on the card against the CPU
    kw = dict(KV=32, quant="none", Lp=0, layers=2, dtype=torch.float32)
    gpu = _blha_run(torch, **kw)
    cpu = _blha_run(torch, device="cpu", **kw)
    err = max(_err(torch, a.cpu(), b) for a, b in zip(gpu[0], cpu[0]))
    scale = max(_scale(b) for b in cpu[0])
    perr = max(_err(torch, a.cpu(), b) for pa_, pb in zip(gpu[1], cpu[1])
               for a, b in zip(pa_, pb))
    if not (err <= 1e-4 * scale + 1e-5 and perr <= 1e-5):
        raise AssertionError(f"blha float32: cuda and the CPU differ by "
                             f"{err} (outputs) / {perr} (pools)")
    print(f"blha float32, 2 layers: cuda == CPU within {err:.3e} of "
          f"{scale:.3e} (outputs), {perr:.3e} (pools) over {len(cpu[0])} "
          "calls")
    return launches



# -------------------------------------------------------------- phase 14
# phase 14's traffic: 8 prompts of the 256-token system prefix and 7-144
# tokens of their own, 4 sharing nothing; request 3 sampled, request 5
# cancelled after its first tokens, request 9 with a deadline
CP_OWN = (7, 30, 55, 80, 100, 120, 144, 16)
CP_SOLO = (24, 60, 130, 200)
CP_SAMPLED, CP_CANCEL, CP_DEADLINE = 3, 5, 9


def _cp_traffic(vocab):
    """Phase 14's 12 requests as (prompt, submit kwargs): 32 new tokens
    each, logprobs, priorities HIGH / NORMAL / LOW in turn, a client key
    each (the retry after recovery)."""
    import numpy as np

    from paddle_tpu_torch.inference import Priority

    rng = np.random.default_rng(14)
    system = rng.integers(1, vocab, 256).tolist()
    prompts = ([system + rng.integers(1, vocab, n).tolist() for n in CP_OWN]
               + [rng.integers(1, vocab, n).tolist() for n in CP_SOLO])
    prios = (Priority.HIGH, Priority.NORMAL, Priority.LOW)
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(max_new_tokens=32, priority=prios[i % 3], logprobs=True,
                  idempotency_key=f"client-{i}")
        if i == CP_SAMPLED:
            kw.update(temperature=0.8, top_p=0.9, seed=7)
        if i == CP_DEADLINE:
            kw.update(deadline_s=600.0)
        reqs.append((p, kw))
    return reqs


def _cp_engines(torch, model, graphs, pulls):
    """The prefill-role and the decode-role engine over ``model`` (phase
    3's geometry, megastep_k 8, prefix cache, a flight recorder each), on
    the model's device, each with a ``BlockWireServer`` on 127.0.0.1 (it
    sets the engine's ``wire_endpoint``); ``graphs`` False: the eager
    twins (``_graphs = False``).  Every device program of an engine runs
    with CUDA sync debugging set to raise (main wraps the replays); a
    pull's blocks, bytes and seconds (synchronized on both sides) go to
    ``pulls``."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.blockwire import BlockWireServer
    from paddle_tpu_torch.inference.tracing import FlightRecorder

    device = next(model.parameters()).device
    engines, servers = [], []
    for role in ("prefill", "decode"):
        e = ServingEngine(model, megastep_k=8, device=device,
                          trace_recorder=FlightRecorder(
                              proc=f"engine-{role}"), **SERVE_KW)
        e.role = role
        if not graphs:
            e._graphs = False
        for name in ("_run_megastep", "_run_mixed", "_run_step"):
            setattr(e, name, _sync_free(torch, getattr(e, name)))
        pull = e.pull_blocks

        def timed(*args, pull=pull, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            n, nbytes = pull(*args, **kwargs)
            torch.cuda.synchronize()
            pulls.append((n, nbytes, time.perf_counter() - t))
            return n, nbytes

        e.pull_blocks = timed
        servers.append(BlockWireServer(e))
        engines.append(e)
    return engines, servers


def _cp_frontend(engines, journal_path, proc):
    """A ServingFrontend over ``engines`` with its own ServingMetrics,
    Tracer, RequestJournal (no fsync) and KVFabric over MemoryKV; returns
    (frontend, fabric)."""
    from paddle_tpu_torch.inference import (RequestJournal, ServingFrontend,
                                            ServingMetrics, Tracer)
    from paddle_tpu_torch.inference.kv_fabric import KVFabric, MemoryKV

    fab = KVFabric(MemoryKV())
    fe = ServingFrontend(engines, kv_fabric=fab, metrics=ServingMetrics(),
                         tracer=Tracer(proc=proc),
                         journal=RequestJournal(journal_path, fsync=False))
    return fe, fab


def _cp_outcome(res):
    """{rid: (status, tokens, logprobs, detail)} of a run's results."""
    return {rid: (r.status.value, [int(t) for t in r.tokens],
                  None if r.logprobs is None else list(r.logprobs), r.detail)
            for rid, r in sorted(res.items())}


def _cp_traces(fe, rids, label):
    """Raise unless every request's trace tree is complete."""
    from paddle_tpu_torch.inference.tracing import TraceContext, tree_complete

    for rid in rids:
        ok, why = tree_complete(fe.tracer.tree_for(
            TraceContext.mint(rid).trace_id))
        if not ok:
            raise AssertionError(f"{label}: request {rid}'s trace: {why}")


def _cp_run(torch, engines, reqs, jdir, tag):
    """The crash-free run, then the crash-and-recover run, over one pair of
    engines.  Returns (outcome, recovered outcome, facts): the crash-free
    frontend cancels request CP_CANCEL at the first step that finds
    tokens of it; the second frontend is dropped, with requests in
    flight, at the first step after which a request is done and the
    engines hold others, and ``ServingFrontend.recover`` takes its
    journal over the same engines (reaping the orphans they hold), the
    clients retry with their keys, and the run ends."""
    from paddle_tpu_torch.inference import (RequestJournal, ServingFrontend,
                                            ServingMetrics, Tracer)
    from paddle_tpu_torch.inference.kv_fabric import KVFabric, MemoryKV

    facts = {}
    fe, fab = _cp_frontend(engines, os.path.join(jdir, f"{tag}-a.wal"),
                           "frontend-a")
    rids = [fe.submit(p, **kw) for p, kw in reqs]
    cancelled = False
    t = time.perf_counter()
    while fe.pending:
        fe.step()
        req = fe._requests.get(rids[CP_CANCEL])
        if not cancelled and req is not None and req.generated:
            cancelled = fe.cancel(rids[CP_CANCEL])
    torch.cuda.synchronize()
    facts["seconds"] = time.perf_counter() - t
    res = fe.results()
    _cp_traces(fe, rids, f"{tag}, the crash-free run")
    facts.update(fabric=dict(fab.counters), metrics=fe.metrics.snapshot(),
                 prometheus=fe.metrics.prometheus_text(),
                 alive=[r.alive for r in fe.replicas],
                 errors=[r.last_error for r in fe.replicas])
    fe.journal.close()
    # the crash: the first frontend is dropped with requests in flight
    path = os.path.join(jdir, f"{tag}-b.wal")
    fe, _ = _cp_frontend(engines, path, "frontend-b")
    rids_b = [fe.submit(p, **kw) for p, kw in reqs]
    while True:
        fe.step()
        held = sum(e.num_active + len(e._queue) for e in engines)
        if fe.results() and held:
            break
        if not fe.pending:
            raise AssertionError(f"{tag}: no step left a request done and "
                                 "others on the engines")
    first = {rid: r.status.value for rid, r in fe.results().items()}
    fe.journal.close()
    fe = None
    fe2 = ServingFrontend.recover(
        path, engines, kv_fabric=KVFabric(MemoryKV()),
        metrics=ServingMetrics(), tracer=Tracer(proc="frontend-c"))
    reaped = fe2.metrics.counter("orphans_reaped_total")
    retries = [fe2.submit(p, **kw) for p, kw in reqs]
    res2 = fe2.run()
    _cp_traces(fe2, rids_b, f"{tag}, the recovered run")
    fe2.journal.close()
    snap, recs = RequestJournal(path).replay()
    terminals = ([r["rid"] for r in recs if r["t"] == "terminal"]
                 + [d["rid"] for d in (snap or {}).get("done", [])])
    if not (retries == rids_b and sorted(res2) == sorted(rids_b)
            and sorted(terminals) == sorted(rids_b)
            and all(res2[rid].status.value == s for rid, s in first.items())
            and 0 < len(first) < len(rids_b) and reaped == held > 0):
        raise AssertionError(
            f"{tag}, recovery: retries {retries} for {rids_b}, results "
            f"{sorted(res2)}, terminal records {sorted(terminals)}, "
            f"{len(first)} done before the crash, reaped {reaped} of "
            f"{held} held")
    facts.update(pre_crash=len(first), reaped=reaped,
                 recovered=fe2.metrics.counter("recovered_requests_total"))
    return _cp_outcome(res), _cp_outcome(res2), facts


def full_width_control_plane(torch, model, card):
    """Phase 14: the serving control plane (ServingFrontend, ServingMetrics,
    Tracer, RequestJournal, KVFabric over blockwire) over a prefill-role
    and a decode-role engine of phase 3's geometry on one 7B model, on
    CUDA graphs, against the same runs over eager twins."""
    import tempfile

    from paddle_tpu_torch.inference import ServingEngine, ServingFrontend

    reqs = _cp_traffic(model.config.vocab_size)
    pulls = []
    graphs, servers = _cp_engines(torch, model, True, pulls)
    with tempfile.TemporaryDirectory() as jdir:
        replays0 = _REPLAYS[0]
        counters = _zero_counters()
        out, rec, facts = _cp_run(torch, graphs, reqs, jdir, "graphs")
        launches = _path_launches("control", counters)
        replays = _REPLAYS[0] - replays0
        twins, twin_servers = _cp_engines(torch, model, False, [])
        e_out, e_rec, _ = _cp_run(torch, twins, reqs, jdir, "eager")
    if out != e_out or rec != e_rec:
        bad = sorted({rid for a, b in ((out, e_out), (rec, e_rec))
                      for rid in a if a[rid] != b.get(rid)})
        raise AssertionError(f"phase 14: graphs and eager twins differ on "
                             f"requests {bad}")
    fab, snap = facts["fabric"], facts["metrics"]
    fe_counters = snap["counters"]
    status = [s for s, *_ in out.values()]
    cancelled = out[sorted(out)[CP_CANCEL]]
    if (status.count("completed") != len(reqs) - 1
            or cancelled[0] != "cancelled" or not 0 < len(cancelled[1]) < 32
            or any(len(t) != 32 for s, t, *_ in out.values()
                   if s == "completed")):
        raise AssertionError(f"phase 14: statuses {status}, the cancelled "
                             f"request {cancelled[0]} with "
                             f"{len(cancelled[1])} tokens")
    print(f"control plane, graphs == eager twins: statuses, tokens and "
          f"logprobs identical over {len(out)} requests (11 completed, the "
          f"cancelled one with its {len(cancelled[1])} partial tokens) and "
          f"over the {len(rec)} of the crash-and-recover run; "
          f"{replays} graph replays in the graph runs")
    quiet = ("wire_fallbacks_total", "relay_pulls_total")
    quiet_fe = ("fabric_pull_failures_total", "fabric_recomputes_total",
                "replica_deaths_total", "requeued_on_failover_total")
    if not (fab["wire_pulls_total"] > 0 and pulls
            and all(fab[k] == 0 for k in quiet)
            and all(fe_counters.get(k, 0) == 0 for k in quiet_fe)
            and all(facts["alive"])):
        raise AssertionError(
            f"phase 14: the fabric fell back or a replica died: fabric "
            f"{fab}, frontend {[(k, fe_counters.get(k)) for k in quiet_fe]}, "
            f"alive {facts['alive']}, last errors {facts['errors']}")
    n_blk = sum(n for n, _, _ in pulls)
    n_b = sum(b for _, b, _ in pulls)
    secs = sum(s for _, _, s in pulls)
    print(f"control plane fabric: {fab['wire_pulls_total']} wire pulls, "
          f"{n_blk} blocks, {n_b} bytes in {secs * 1e3:.2f} ms of pulls "
          f"({n_b / secs / 1e9:.2f} GB/s, synchronized on both sides, "
          f"listener on 127.0.0.1); fallbacks, relay pulls, pull failures, "
          f"recomputes, replica deaths and failover requeues all 0; "
          f"prefill passes {fe_counters.get('fabric_prefill_passes_total')}")
    _pull_breakdown(torch, model, graphs[0], reqs)
    print(f"control plane recovery: {facts['pre_crash']} requests done "
          f"before the crash, {facts['recovered']} recovered, "
          f"{facts['reaped']} orphans reaped, every client retry returned "
          f"its first rid, one terminal record per admitted request; the "
          f"recovered tokens equal the eager twins' run")
    lat = snap["latency"]
    print(f"control plane metrics ({card}): TTFT p50 "
          f"{lat['ttft_seconds']['p50'] * 1e3:.1f} ms p95 "
          f"{lat['ttft_seconds']['p95'] * 1e3:.1f} ms, inter-token p50 "
          f"{lat['token_latency_seconds']['p50'] * 1e3:.2f} ms p95 "
          f"{lat['token_latency_seconds']['p95'] * 1e3:.2f} ms, "
          f"{snap['tokens_per_sec']:.1f} tokens/s; the crash-free run "
          f"{facts['seconds']:.3f} s")
    for line in facts["prometheus"].splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            if not name.startswith("paddle_tpu_serving_"):
                raise AssertionError(f"prometheus line {line!r}")
    # informative: the requests whose tokens one engine gives without the
    # frontend (a row's bits may depend on its batch on the card)
    one = ServingEngine(model, megastep_k=8,
                        device=next(model.parameters()).device, **SERVE_KW)
    rids = [one.add_request(p, max_new_tokens=32, sampling=_cp_sampling(kw))
            for p, kw in reqs]
    done = one.run()
    same = sum(done[rid] == out[k][1] for rid, k in zip(rids, sorted(out))
               if out[k][0] == "completed")
    print(f"control plane vs one engine without the frontend: {same} of "
          f"{len(reqs) - 1} completed requests give the same tokens "
          "(informative)")
    one = None
    # a profiled stretch through a frontend over the graph pair: K4
    # unmasked, the device's busy share
    fe = ServingFrontend(graphs, kv_fabric=None)
    extra = [(p[:200] + p[-20:], 16) for p, _ in reqs[:8]]

    def wave(part):
        for p, n in part:
            fe.submit(p, max_new_tokens=n)
        fe.run()

    evs = _profile(torch, "control plane, a frontend over the graph pair "
                   "(4 requests, 16 new tokens)", lambda: wave(extra[:4]),
                   lambda: wave(extra[4:]), top=10)
    k4 = [ev.key for ev in evs if "paged_attention" in ev.key]
    if not k4:
        raise AssertionError("phase 14: no K4 kernel in the profile")
    _unmasked(k4, "K4 under the control plane")
    for s in servers + twin_servers:
        s.close()
    return launches


def _pull_breakdown(torch, model, src, reqs):
    """Informative: one pull of the longest prompt's chain off ``src``'s
    listener split into its parts, each synchronized: the export alone
    (device gather, device-to-host copy), the wire pull (the listener's
    export, framing, CRC and the loopback socket), and the import into a
    fresh engine (pinned staging, host-to-device copy, ``index_copy_``)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.blockwire import default_pool
    from paddle_tpu_torch.inference.serving import prompt_block_hashes

    hashes = prompt_block_hashes(max((p for p, _ in reqs), key=len),
                                 SERVE_KW["block_size"])
    fresh = ServingEngine(model, device=next(model.parameters()).device,
                          **SERVE_KW)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, export_s = timed(lambda: src.export_blocks_packed(hashes))
    (header, raw), wire_s = timed(
        lambda: default_pool().pull(src.wire_endpoint, hashes))
    n, import_s = timed(lambda: fresh.import_blocks_packed(header, raw))
    if n != len(hashes):
        raise AssertionError(f"phase 14: {n} of {len(hashes)} blocks "
                             "imported")
    gbs = len(raw) / 1e9
    print(f"control plane pull of {n} blocks, {len(raw)} bytes: export "
          f"{export_s * 1e3:.2f} ms ({gbs / export_s:.2f} GB/s), wire pull "
          f"{wire_s * 1e3:.2f} ms ({gbs / wire_s:.2f} GB/s), import "
          f"{import_s * 1e3:.2f} ms ({gbs / import_s:.2f} GB/s) "
          "(informative)")


def _cp_sampling(kw):
    from paddle_tpu_torch.inference import SamplingParams

    return SamplingParams(temperature=kw.get("temperature", 0.0),
                          top_p=kw.get("top_p", 1.0), seed=kw.get("seed", 0))


# -------------------------------------------------------------- phase 15
# the fleet's model: Llama-2-7B width at 8 layers (three worker processes,
# the warm one and the parent's twin share the card), bf16, seed 15
FLEET_MODEL = dict(num_hidden_layers=8, dtype="bfloat16")
FLEET_SEED = 15
FLEET_ROLES = ("prefill", "decode", "decode")


def _fleet_spec(model_kw):
    """The workers' spec: phase 3's engine geometry, megastep_k 8, prefix
    cache (the default), a flight recorder and a blockwire listener."""
    return {"seed": FLEET_SEED, "model": dict(model_kw),
            "engine": dict(SERVE_KW, megastep_k=8), "tracing": True,
            "wire": True}


def _fleet_traffic(vocab):
    """Phase 14's 12 requests without their client keys (the fleet serves
    the traffic twice) and with phase 14's sampling; as (prompt, kw)."""
    return [(p, {k: v for k, v in kw.items() if k != "idempotency_key"})
            for p, kw in _cp_traffic(vocab)]


def _fleet_frontend_kwargs(proc):
    from paddle_tpu_torch.inference import ServingMetrics, Tracer
    from paddle_tpu_torch.inference.kv_fabric import KVFabric, MemoryKV

    return dict(kv_fabric=KVFabric(MemoryKV()), metrics=ServingMetrics(),
                tracer=Tracer(proc=proc))


class _BeginStep:
    """An in-process engine with a ``RemoteReplica``'s step timing: the
    frontend's ``begin_step()`` runs the step then, before the frontend
    harvests the replicas stepped ahead of it, and ``step()`` hands the
    result over (a worker's step RPC goes out at ``begin_step``, and the
    replica's later calls wait for it)."""

    def __init__(self, eng):
        self._eng = eng
        self._done = None

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def begin_step(self):
        if self._done is None:
            self._done = self._eng.step()

    def step(self):
        out, self._done = self._done, None
        return self._eng.step() if out is None else out


def _fleet_twin(model, device):
    """The in-process twin: a ServingFrontend over three engines of the
    fleet's roles on the parent's own model of the same spec, each with a
    flight recorder and a BlockWireServer on 127.0.0.1, stepped as the
    fleet's replicas are (``_BeginStep``)."""
    from paddle_tpu_torch.inference import ServingEngine, ServingFrontend
    from paddle_tpu_torch.inference.blockwire import BlockWireServer
    from paddle_tpu_torch.inference.tracing import FlightRecorder

    engines, servers = [], []
    for i, role in enumerate(FLEET_ROLES):
        e = ServingEngine(model, megastep_k=8, device=device,
                          trace_recorder=FlightRecorder(proc=f"twin{i}"),
                          **SERVE_KW)
        e.role = role
        servers.append(BlockWireServer(e))
        engines.append(_BeginStep(e))
    return (ServingFrontend(engines, **_fleet_frontend_kwargs("twin")),
            servers)


def _fleet_serve(fe, reqs, step, on_step=None, served=None):
    """Submit ``reqs`` to ``fe``, drive ``step()`` until none is pending
    (``on_step()`` after each step); returns (outcome, seconds).
    ``served``: a set that gains the worker of every replica handed a
    request (a prefill pass or a decode placement) in this run."""
    if served is not None:
        for rep in fe.replicas:
            _note_served(rep.engine, served)
    rids = [fe.submit(p, **kw) for p, kw in reqs]
    t = time.perf_counter()
    while fe.pending:
        step()
        if on_step is not None:
            on_step()
    secs = time.perf_counter() - t
    res = fe.results()
    return _cp_outcome({rid: res[rid] for rid in rids}), secs


def _note_served(eng, served):
    """Wrap a RemoteReplica's ``add_request`` (once) so that it adds the
    worker's name to ``served``."""
    if getattr(eng, "_served", None) is served:
        return
    add = eng.add_request

    def noted(*args, **kwargs):
        served.add(eng.worker)
        return add(*args, **kwargs)

    eng.add_request, eng._served = noted, served


def _fleet_margins(torch, model, device, prompt, gen, sampling):
    """Per generated position of ``gen``: (margin, bf16 step) of the choice
    there, teacher-forced over prompt + gen on a fresh engine of the
    fleet's geometry (``_draw_margin``: the top-two logits of a greedy
    row, of the filtered, scaled logits plus the Gumbel noise of a
    sampled one)."""
    from paddle_tpu_torch.inference import ServingEngine

    # one pass over the whole sequence: a token budget of max_seq_len
    eng = ServingEngine(model, device=device, **dict(
        SERVE_KW, token_budget=SERVE_KW["max_seq_len"]))
    seq = list(prompt) + list(gen[:-1])
    with torch.no_grad():
        h = _forced_trunk(torch, eng, seq)
        lg = (h[len(prompt) - 1:len(seq)]
              @ eng._weights["head"]).float().cpu()
    return [_draw_margin(torch, lg[j], sampling, j)
            for j in range(len(gen))]


def _fleet_agree(torch, model, device, reqs, got, want, what):
    """Phase 4's ``_agree`` rule at bf16: each request's tokens equal up
    to the first position whose margin is under bf16's step (phase 11's
    threshold, 2^-7 of the largest |logit|); prints the exact-equality
    count and every divergence.  ``got`` / ``want``: _cp_outcome's."""
    exact = 0
    for (prompt, kw), k in zip(reqs, sorted(want)):
        a, b = got[k][1], want[k][1]
        if a == b:
            exact += 1
            continue
        sampling = ({"temperature": kw["temperature"],
                     "top_p": kw.get("top_p", 1.0), "seed": kw["seed"]}
                    if kw.get("temperature") else None)
        margins = _fleet_margins(torch, model, device, prompt, b, sampling)
        stop = next((j for j, (m, st) in enumerate(margins) if m < st),
                    len(b))
        if a[:stop] != b[:stop]:
            raise AssertionError(f"{what}: request {k} differs before "
                                 f"position {stop}: {a[:stop]} vs "
                                 f"{b[:stop]}")
        print(f"{what}: request {k} diverges at position {stop} (margin "
              f"{margins[stop][0]:.4e} under bf16's step "
              f"{margins[stop][1]:.4e})")
    print(f"{what}: {exact} of {len(want)} requests equal bit for bit")


def _fleet_pulls(fleet, pulls):
    """Time every decode replica's ``pull_blocks`` RPC (the worker's wire
    pull off its peer's listener and its import, enqueued) into
    ``pulls``, from the end of the step the replica has in flight (which
    the RPC waits for first)."""
    import concurrent.futures

    for rep in fleet.frontend.replicas:
        eng = rep.engine
        if eng.role != "decode":
            continue
        pull = eng.pull_blocks

        def timed(*args, pull=pull, eng=eng, **kwargs):
            if eng._pending_step is not None:
                concurrent.futures.wait([eng._pending_step])
            t = time.perf_counter()
            n, nbytes = pull(*args, **kwargs)
            pulls.append((n, nbytes, time.perf_counter() - t))
            return n, nbytes

        eng.pull_blocks = timed


def _fleet_memory(torch, fleet):
    """{worker: (max allocated GB, reserved GB)} over RPC: the caching
    allocator's figures, read in the worker (no device work)."""
    out = {}
    for name in fleet.workers:
        out[name] = tuple(
            fleet._rpc.rpc_sync(name, fn, timeout=30) / 1e9
            for fn in (torch.cuda.max_memory_allocated,
                       torch.cuda.memory_reserved))
    return out


def _fleet_metrics(card, label, snap, secs):
    lat = snap["latency"]
    print(f"fleet metrics, {label} ({card}): TTFT p50 "
          f"{lat['ttft_seconds']['p50'] * 1e3:.1f} ms p95 "
          f"{lat['ttft_seconds']['p95'] * 1e3:.1f} ms, inter-token p50 "
          f"{lat['token_latency_seconds']['p50'] * 1e3:.2f} ms p95 "
          f"{lat['token_latency_seconds']['p95'] * 1e3:.2f} ms, "
          f"{snap['tokens_per_sec']:.1f} tokens/s; {secs:.3f} s, "
          f"{snap['counters']['tokens_emitted_total']} tokens")


def _fleet_exit_launches(fleet, names, served):
    """Each surviving worker's kernel launch counts from its WORKER_EXIT
    line (read after shutdown; every count was set to 0 before the
    phase's traffic).  Raises unless each survivor took requests of the
    phase (``served``), launched every kernel of the fleet path and no
    masked K4 instance; returns the sum over the survivors."""
    idle = [n for n in names if n not in served]
    if idle:
        raise AssertionError(f"phase 15: survivors {idle} took no request "
                             f"of the phase")
    per = {}
    for name in names:
        line = next((ln for ln in fleet.worker_log(name, 1 << 16)
                     .splitlines() if ln.startswith(f"WORKER_EXIT {name} ")),
                    None)
        if line is None:
            raise AssertionError(f"phase 15: no WORKER_EXIT line from "
                                 f"{name}:\n{fleet.worker_log(name)}")
        per[name] = json.loads(line.split("launches=", 1)[1])
        print(f"launches fleet {name} {json.dumps(per[name])}")
        for k in PATHS["fleet"]:
            if per[name][k] <= 0:
                raise AssertionError(f"kernel {k} was never launched in "
                                     f"worker {name}")
        if per[name]["paged_attention.mask_launches"]:
            raise AssertionError(f"phase 15: {name} launched a masked K4 "
                                 "instance")
    total = {k: sum(p[k] for p in per.values()) for k in per[names[0]]}
    print(f"launches fleet {json.dumps(total)}")
    return total


def full_width_fleet(torch, card, model_kw=FLEET_MODEL, device="cuda"):
    """Phase 15: the serving fleet across worker processes (module
    docstring).  Cut: 8 of the 32 layers, so that three workers, a warm
    one and the parent's twin (each with its own model, KV pool, graph
    pool and CUDA context) fit on one card; widths are Llama-2-7B's.
    ``model_kw`` / ``device`` let the phase be rehearsed on the CPU at a
    small width (``device="cpu"``: CPU workers; the kernel check then has
    nothing to count)."""
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.inference.fleet import build_spec_model

    spec = _fleet_spec(model_kw)
    os.environ["PADDLE_LOCAL_IP"] = "127.0.0.1"   # loopback only
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()      # the twin's peak alone
    t = time.perf_counter()
    fleet = ServingFleet(spec, num_workers=len(FLEET_ROLES),
                         worker_roles=list(FLEET_ROLES),
                         frontend_kwargs=_fleet_frontend_kwargs("fleet"),
                         cpu_workers=device == "cpu", spawn_timeout=300.0,
                         rpc_timeout=300.0, warm_pool_size=1)
    try:
        boot = time.perf_counter() - t
        print(f"fleet: {len(FLEET_ROLES)} workers ({', '.join(FLEET_ROLES)})"
              f" booted in {boot:.3f} s, in parallel, with a warm one "
              f"booting beside them")
        model = build_spec_model(spec["model"], spec["seed"], device=device)
        reqs = _fleet_traffic(model.config.vocab_size)
        pulls = []
        _fleet_pulls(fleet, pulls)
        fe = fleet.frontend
        if device == "cuda":
            # the counts of this run only: every worker's set to 0 in
            # the worker (the warm one zeroes its own after its warm-up)
            from paddle_tpu_torch.tools.serving_worker import \
                reset_launch_counts

            for name in fleet.workers:
                fleet._rpc.rpc_sync(name, reset_launch_counts, timeout=60)
        served = set()
        out, secs = _fleet_serve(fe, reqs, fleet.step, served=served)
        cold = fe.metrics.snapshot()
        fab = dict(fe.fabric.counters)
        twin, servers = _fleet_twin(model, device)
        t_out, _ = _fleet_serve(twin, reqs, twin.step)
        for srv in servers:
            srv.close()
        twin = servers = None
        if out != t_out:
            bad = {k: (out[k], t_out.get(k)) for k in out
                   if out[k] != t_out.get(k)}
            raise AssertionError(f"phase 15: the fleet and its in-process "
                                 f"twin differ on requests {bad}")
        status = [s for s, *_ in out.values()]
        if status != ["completed"] * len(reqs) or any(
                len(tk) != 32 for _, tk, *_ in out.values()):
            raise AssertionError(f"phase 15: statuses {status}")
        print(f"fleet == in-process twin: statuses, tokens and logprobs "
              f"identical over {len(out)} requests")
        fe_c = cold["counters"]
        quiet = ("wire_fallbacks_total", "relay_pulls_total")
        quiet_fe = ("fabric_pull_failures_total", "fabric_recomputes_total",
                    "replica_deaths_total", "requeued_on_failover_total")
        if not (fab["wire_pulls_total"] > 0 and pulls
                and fab["wire_pulls_total"] == len(pulls)
                and all(fab[k] == 0 for k in quiet)
                and all(fe_c.get(k, 0) == 0 for k in quiet_fe)):
            raise AssertionError(
                f"phase 15: a chain did not arrive worker to worker: "
                f"fabric {fab}, pull RPCs {len(pulls)}, frontend "
                f"{[(k, fe_c.get(k)) for k in quiet_fe]}")
        n_blk = sum(n for n, _, _ in pulls)
        n_b = sum(b for _, b, _ in pulls)
        p_s = sum(s for _, _, s in pulls)
        print(f"fleet fabric: {len(pulls)} worker-to-worker pulls "
              f"(_w_pull_blocks over blockwire, 127.0.0.1), {n_blk} blocks,"
              f" {n_b} bytes in {p_s * 1e3:.2f} ms of pull RPCs "
              f"({n_b / p_s / 1e9:.3f} GB/s: the RPC round trip, the wire "
              f"pull and the import's enqueue); relay pulls, fallbacks, "
              f"pull failures and recomputes 0")
        _fleet_metrics(card, "the first run (each worker's first calls "
                       "and graph captures inside)", cold, secs)
        # the same traffic again: the graphs captured, the prefix warm
        fe.metrics.reset()
        w_out, w_secs = _fleet_serve(fe, reqs, fleet.step, served=served)
        _fleet_metrics(card, "the second run (graphs captured, the "
                       "prefix cache warm)", fe.metrics.snapshot(), w_secs)
        _fleet_agree(torch, model, device, reqs, dict(
            zip(sorted(out), w_out.values())), out,
            "fleet second run vs first")
        if device == "cuda":
            for name, (peak, res) in sorted(
                    _fleet_memory(torch, fleet).items()):
                print(f"fleet memory {name}: max allocated {peak:.3f} GB, "
                      f"reserved {res:.3f} GB ({card})")
            print(f"fleet memory parent (the twin's model and engines): "
                  f"max allocated "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
            used = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()
            print(f"fleet memory on the card, every process with its CUDA "
                  f"context: {used}")

        # the crash run: worker2 SIGKILLed after its first tokens
        fe.metrics.reset()
        doomed = fe.replicas[2]
        victim = doomed.engine.worker
        killed = []

        def kill():
            if killed or not any(r.generated
                                 for r in doomed.requests.values()):
                return
            os.kill(doomed.engine.pid, signal.SIGKILL)
            fleet._procs[victim].wait(timeout=60)
            fleet.heartbeat()          # the heartbeat finds it dead
            killed.append(doomed.alive)

        c_out, _ = _fleet_serve(fe, reqs, fleet.step, on_step=kill,
                                served=served)
        c = fe.metrics.snapshot()["counters"]
        if not (killed == [False] and victim not in fleet.workers
                and c.get("requeued_on_failover_total", 0) >= 1
                and c.get("replica_deaths_total", 0) == 1
                and [s for s, *_ in c_out.values()]
                == ["completed"] * len(reqs)):
            raise AssertionError(
                f"phase 15 crash run: killed {killed}, workers "
                f"{fleet.workers}, statuses "
                f"{[s for s, *_ in c_out.values()]}, counters "
                f"{[(k, c.get(k)) for k in quiet_fe]}")
        print(f"fleet crash run: {victim} SIGKILLed after its first tokens,"
              f" found by the heartbeat; {len(c_out)} requests completed, "
              f"{c['requeued_on_failover_total']} requeued on failover, "
              f"none dropped")
        _fleet_agree(torch, model, device, reqs, dict(
            zip(sorted(out), c_out.values())), out,
            "fleet crash run vs crash-free")

        # a warm worker claimed, then a rolling swap to the same spec
        wait = time.perf_counter()
        while not fleet.warm_pool.ready_names():
            if time.perf_counter() - wait > 300:
                raise AssertionError(f"phase 15: the warm worker never got "
                                     f"ready: {fleet.spawn_errors}")
            time.sleep(0.1)
        fleet.warm_pool.size = 0       # no refill behind the claim
        warm = fleet.spawn_worker_async()
        while fleet.num_pending_spawns:
            fleet.step()
            time.sleep(0.01)
        if (warm not in fleet.workers or warm in fleet.spawn_errors
                or fe.metrics.counter("pool_attaches_total") != 1):
            raise AssertionError(f"phase 15: warm claim of {warm}: workers "
                                 f"{fleet.workers}, {fleet.spawn_errors}")
        print(f"fleet warm pool: {warm} claimed and attached in "
              f"{time.perf_counter() - wait:.3f} s after its boot")
        n = fleet.rolling_swap(spec, "v1")
        if n != len(fleet.workers) or {
                r.engine.weights_version for r in fe.replicas} != {"v1"}:
            raise AssertionError(f"phase 15: rolling swap gave {n}")
        # two requests over the shared prefix and two without it, so the
        # claimed worker takes some (the prefix's holder takes the first)
        pick = (0, 1, 8, 9)
        after = [reqs[i] for i in pick]
        keys = [sorted(out)[i] for i in pick]
        s_out, _ = _fleet_serve(fe, after, fleet.step, served=served)
        if [st for st, *_ in s_out.values()] != ["completed"] * len(pick):
            raise AssertionError(
                f"phase 15 after the swap: "
                f"{[(st, d) for st, _, _, d in s_out.values()]}, spawn "
                f"errors {dict(fleet.spawn_errors)}")
        _fleet_agree(torch, model, device, after, dict(
            zip(keys, s_out.values())), {k: out[k] for k in keys},
            f"fleet after the rolling swap to v1 ({n} workers)")
        text = fleet.prometheus_text()
        for name in fleet.workers + ["frontend"]:
            if f'replica="{name}"' not in text:
                raise AssertionError(f"phase 15: no replica={name} series")
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
                if not name.startswith("paddle_tpu_serving_"):
                    raise AssertionError(f"prometheus line {line!r}")
        print(f"fleet prometheus page parsed: {len(text.splitlines())} "
              f"lines, replica labels {sorted(fleet.workers)} + frontend")
        survivors = list(fleet.workers)
        print(f"fleet survivors {survivors}; took requests of the phase: "
              f"{sorted(served)}")
    finally:
        fleet.shutdown()
    return _fleet_exit_launches(fleet, survivors, served) \
        if device == "cuda" else None


# -------------------------------------------------------------- phase 16
# the in-process soaks' model: Llama-2-7B widths (LlamaConfig's defaults)
# cut to 2 layers, with the soaks' own ENGINE, seeds and streams, in
# float32 (the reference soaks' dtype).  The soaks hold their survivors
# to fresh engines bit for bit although the batches differ (failover
# re-prefills, spec verifies, swaps); bf16 logits at this width tie or
# nearly tie (a top-2 gap of 0 in phase 4's bf16 pair), and in bf16 runs
# on an H100 the spec soak lost 3 of 12 requests and the multitenant one
# 1 of 15 to such ties
CHAOS_MODEL = dict(num_hidden_layers=2, dtype="float32")


def full_width_chaos(torch, card, model_kw=CHAOS_MODEL, device=None):
    """Phase 16: the in-process chaos soaks of
    ``paddle_tpu_torch.tools.chaos_serving`` on the card (module
    docstring), each with its own assertions: every request typed
    terminal, the survivors equal to the soak's fault-free run over fresh
    engines on the card, the faults fired.  ``run_chaos`` at seed 11 runs
    twice and must give equal reports (replay determinism on graphs).
    Prints each mode's seconds and the fault kinds fired; returns the
    launches of the phase (its soaks' engines in this process; the
    kill-frontend child is a process of its own).  ``model_kw`` /
    ``device`` let the phase be rehearsed on the CPU at a small width."""
    from paddle_tpu_torch.tools import chaos_serving as cs

    kw = dict(model_kw=model_kw, device=device)
    modes = (
        ("run_chaos, seed 7, poison", lambda: cs.run_chaos(seed=7, **kw)),
        ("run_chaos, seed 7, brownout",
         lambda: cs.run_chaos(seed=7, brownout=True, **kw)),
        ("run_chaos, seed 11", lambda: cs.run_chaos(seed=11, **kw)),
        ("run_chaos, seed 11 again", lambda: cs.run_chaos(seed=11, **kw)),
        ("run_chaos_spec", lambda: cs.run_chaos_spec(seed=0, **kw)),
        ("run_chaos_disagg", lambda: cs.run_chaos_disagg(seed=0, **kw)),
        ("run_chaos_multitenant",
         lambda: cs.run_chaos_multitenant(seed=0, **kw)),
        ("run_kill_frontend", lambda: cs.run_kill_frontend(seed=0, **kw)),
        ("run_standby", lambda: cs.run_standby(seed=0, **kw)))
    counters = _zero_counters() if device is None else None
    reports = {}
    for label, run in modes:
        t = time.perf_counter()
        rep = run()
        secs = time.perf_counter() - t
        reports[label] = rep
        print(f"chaos {label}: {secs:.3f} s, {rep.get('steps', '-')} steps, "
              f"statuses {json.dumps(rep['statuses'], sort_keys=True)}, "
              f"fault kinds fired {rep.get('fault_kinds_fired')}, "
              f"{len(rep['survivors'])} survivors equal to the fault-free "
              f"run on {rep['device']} ({card})", flush=True)
    if reports["run_chaos, seed 11"] != reports["run_chaos, seed 11 again"]:
        raise AssertionError("phase 16: run_chaos at seed 11 did not replay "
                             "to an equal report")
    print("chaos run_chaos seed 11 replayed to an equal report (trace "
          f"digest {reports['run_chaos, seed 11']['trace_digest']})")
    if counters is None:
        return None
    launches = _path_launches("chaos", counters)
    if counters["paged_attention"].mask_launches:
        raise AssertionError("phase 16: a masked K4 instance launched")
    return launches


# -------------------------------------------------------- phases 21-23
class _PlainAttentionAdamW:
    """Within the block, B1 (``flash_attention_fused``), B8
    (``flash_attention_bwd_fused``) and B9 (AdamW's ``fused_adamw``) run
    their plain PyTorch versions on the card's tensors: the kernel path's
    plain twin over the same CUDA tensors (phase 22)."""

    def __enter__(self):
        from paddle_tpu_torch.ops.hopper import fused_adamw as fad
        from paddle_tpu_torch.ops.hopper import flash_attention as fa
        from paddle_tpu_torch.optimizer import optimizers

        def fwd(q, k, v, causal=False, scale=None, q_offset=None,
                blocks=None):
            s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
            return fa._plain_bshd(q, k, v, causal, s, q_offset)

        def bwd(q, k, v, out, lse, g, causal=False, scale=None,
                blocks=None):
            s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
            return fa._plain_bwd_bshd(q, k, v, out, lse, g, causal, s)

        def adamw(param, master, m, v, grad, lr, t, *, b1, b2, eps, wd,
                  gmul=None, skip=None):
            fad._fused_adamw_ref(param, master, m, v, grad, float(lr), t,
                                 b1, b2, eps, wd, gmul, skip)
            return param, master, m, v

        self.saved = [(fa, "flash_attention_fused", fa.flash_attention_fused),
                      (fa, "flash_attention_bwd_fused",
                       fa.flash_attention_bwd_fused),
                      (optimizers, "fused_adamw", optimizers.fused_adamw)]
        fa.flash_attention_fused, fa.flash_attention_bwd_fused = fwd, bwd
        optimizers.fused_adamw = adamw
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


GPT_LR = 1e-4      # AdamW's rate in phases 21 and 22


def _gpt_config(**kw):
    """``gpt3_1_3b()`` with the fields of ``kw`` replaced (a cut depth, or
    a rehearsal's sizes on the CPU)."""
    import dataclasses

    from paddle_tpu_torch.models import gpt3_1_3b

    return dataclasses.replace(gpt3_1_3b(), **kw)


def _gpt_setup(torch, model, lr):
    """AdamW(multi_precision) and ``amp.decorate`` to O2 bfloat16 (the
    norms' parameters stay float32), a TrainStep whose loss runs under
    ``auto_cast(O2)`` -> (step, optimizer)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return crit(m(ids), ids)

    return TrainStep(model, loss_fn, opt), opt


def _gpt_cached_logits(torch, model, ids, toks):
    """The growing-cache steps ``generate`` takes, fed ``toks`` [B, n]:
    the last row's logits of the prefill and of each of the n - 1 decode
    steps -> [B, n, V] float32."""
    cfg = model.config
    B = ids.shape[0]
    shape = (B, 0, cfg.num_key_value_heads, cfg.head_dim)
    caches = [(torch.zeros(shape, device=ids.device),
               torch.zeros(shape, device=ids.device))
              for _ in range(cfg.num_hidden_layers)]
    out = []
    with torch.no_grad():
        lg, caches = model(ids, caches=caches)
        out.append(lg[:, -1].float())
        for i in range(toks.shape[1] - 1):
            lg, caches = model(toks[:, i:i + 1], caches=caches)
            out.append(lg[:, -1].float())
    return torch.stack(out, dim=1)


def _gpt_forced_logits(torch, model, ids, toks):
    """One full forward over prompt + toks[:, :-1] -> the logits [B, n, V]
    float32 at the rows from which each generated token was chosen."""
    full = torch.cat([ids, toks[:, :-1].to(ids.dtype)], dim=1)
    with torch.no_grad():
        lg = model(full)
    return lg[:, ids.shape[1] - 1:].float()


def full_width_gpt(torch, card, model_kw=None, batch=(4, 2048),
                   prompts=(8, 128), new=32, device="cuda"):
    """Phase 21: GPT-3 1.3B (``gpt3_1_3b``: 24 layers, hidden 2048, 16
    heads of 128, vocab 50304) with seeded random weights made on the card,
    ``amp.decorate``d to O2 bf16 with AdamW(multi_precision): a warm-up and
    three timed TrainSteps on one [4, 2048] batch (B1 and B8 once a layer a
    step, B9 once a parameter a step, counted exactly), one profiled step;
    then in eval under auto_cast O2 greedy ``generate`` of 8 prompts x 128
    tokens, 32 new, over growing caches (B1 once a layer a forward: 24 x
    32), and each cached step's logits against one full forward over
    prompt + generated tokens.  Returns the "gpt" path's launches.
    ``model_kw``, ``batch``, ``prompts``, ``new`` and ``device`` cut it to
    a rehearsal on the CPU."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, generate

    cfg = _gpt_config(**(model_kw or {}))
    (B, S), L = batch, cfg.num_hidden_layers
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, seed=21)
    step, opt = _gpt_setup(torch, model, GPT_LR)
    torch.cuda.synchronize()
    n_params, n_tensors = model.num_params, len(list(model.parameters()))
    dts = sorted({str(p.dtype) for p in model.parameters()})
    print(f"gpt model: {n_params} parameters in {n_tensors} tensors "
          f"({dts} after decorate), recompute {cfg.recompute}, setup "
          f"seconds {time.perf_counter() - t:.3f}")
    if model_kw is None and (n_params, n_tensors) != (1_418_842_112, 293):
        raise AssertionError(f"phase 21: gpt3_1_3b has {n_params} "
                             f"parameters in {n_tensors} tensors")
    ids = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device=device)
    free = _sync_free(torch, step)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [free(ids)]                        # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        losses.append(free(ids))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 3
    peak = torch.cuda.max_memory_allocated()
    lv = torch.stack(losses).float().cpu()
    print(f"gpt losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()) or not lv[-1] < lv[0]:
        raise AssertionError(f"phase 21 losses not finite and falling: {lv}")
    train = {k: fn.launches for k, fn in counters.items()}
    # B1 once a layer a forward (twice under recompute), B8 once a layer
    # a backward, B9 once a parameter a step: every parameter has a master
    want = {"flash_attention": 4 * L * (2 if cfg.recompute else 1),
            "flash_attention_bwd": 4 * L, "fused_adamw": 4 * n_tensors}
    got = {k: train[k] for k in want}
    print("gpt launches a step: " + json.dumps(
        {k: v / 4 for k, v in got.items()}))
    if got != want:
        raise AssertionError(f"phase 21: launches in 4 steps {got}, "
                             f"expected {want}")
    flops_tok = 6 * n_params + 12 * L * cfg.hidden_size * S * 0.5
    print(f"gpt train step [{B}, {S}] (O2 bf16, AdamW multi_precision): "
          f"{dt * 1e3:.1f} ms, {B * S / dt:.1f} tokens/s, MFU "
          f"{B * S / dt * flops_tok / 989e12:.4f} against 989 TFLOP/s "
          f"(informative), max_memory_allocated {peak} bytes ({before} "
          f"allocated before the phase; {card}); no host sync inside a step")
    _profile(torch, "gpt train step", lambda: free(ids), top=16)
    # generation over growing caches, in eval under auto_cast O2
    model.eval()
    P, Sp = prompts
    prompt = torch.as_tensor(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (P, Sp)), dtype=torch.int64, device=device)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        generate(model, prompt[:, :8], max_new_tokens=2)      # warm-up
        torch.cuda.synchronize()
        counters = _zero_counters()
        t = time.perf_counter()
        toks = generate(model, prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        gen = {k: fn.launches for k, fn in counters.items()}
        cached = _gpt_cached_logits(torch, model, prompt, toks)
        forced = _gpt_forced_logits(torch, model, prompt, toks)
    if tuple(toks.shape) != (P, new) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"phase 21: generated {tuple(toks.shape)}, "
                             "or a token out of the vocabulary")
    print(f"gpt generate [{P}, {Sp}] + {new} (growing caches, O2 bf16): "
          f"{gen_s * 1e3 / new:.2f} ms a token ({gen_s:.3f} s, the prefill "
          f"included), B1 launches {gen['flash_attention']} ({card})")
    if gen["flash_attention"] != L * new:
        raise AssertionError(f"phase 21: generate launched B1 "
                             f"{gen['flash_attention']} times, expected "
                             f"{L} x {new}")
    if not torch.equal(cached.argmax(-1), toks.to(torch.int64)):
        raise AssertionError("phase 21: the cached steps' argmaxes are not "
                             "generate's tokens")
    err = float((cached - forced).abs().max())
    scale = float(forced.abs().max())
    print(f"gpt cached steps vs the full forward: max_abs_err {err:.4e} of "
          f"max |logit| {scale:.4e} ({err / scale:.2e}), tol 4e-2")
    if not err <= 4e-2 * scale:
        raise AssertionError("phase 21: cached logits differ from the full "
                             "forward's beyond bf16 tolerance")
    launches = {k: train[k] + gen[k] for k in train}
    for k in PATHS["gpt"]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 "gpt path")
    print(f"launches gpt {json.dumps(launches)}")
    return launches


def _rel_l2(torch, got, ref):
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def _gpt_pair(torch, dtype, layers=2, model_kw=None, device="cuda"):
    """Two ``gpt3_1_3b``-width models cut to ``layers`` with the same
    seeded weights on the card; bf16: both O2-decorated, with the step's
    optimizer -> (kernel model, plain model, kernel step, plain step)."""
    import copy

    from paddle_tpu_torch.models import GPTForCausalLM

    cfg = _gpt_config(num_hidden_layers=layers, **(model_kw or {}))
    a = GPTForCausalLM(cfg, device=device, seed=22)
    b = copy.deepcopy(a)
    if dtype == "bfloat16":
        (sa, _), (sb, _) = (_gpt_setup(torch, a, GPT_LR),
                            _gpt_setup(torch, b, GPT_LR))
    else:
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.models import GPTPretrainingCriterion
        from paddle_tpu_torch.optimizer import AdamW

        crit = GPTPretrainingCriterion()

        def make(m):
            return TrainStep(m, lambda mm, x: crit(mm(x), x), AdamW(
                learning_rate=GPT_LR, parameters=m.parameters(),
                multi_precision=True))
        sa, sb = make(a), make(b)
    return a, b, sa, sb


def gpt_kernels_vs_plain(torch, layers=2, model_kw=None, batch=(2, 512),
                         prompts=(2, 64), new=16, device="cuda"):
    """Phase 22: ``gpt3_1_3b``'s width at ``layers`` layers, float32 and
    O2 bf16, the same weights and CUDA tensors through the kernels (B1,
    B8, B9) and through their plain versions (``_PlainAttentionAdamW``):
    logits and loss, every gradient, every parameter and optimizer state
    after one AdamW step, and greedy ``generate`` tokens (float32: equal;
    bf16: equal up to a top-2 gap within the logits' tolerance); then, in
    float32 on the kernel path, the identity of ``tests/test_gpt.py``:
    the last generated token is the argmax of a full forward over prompt
    + the tokens before it."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTPretrainingCriterion, generate

    rng = np.random.default_rng(23)
    lr = GPT_LR
    for dname in ("float32", "bfloat16"):
        a, b, sa, sb = _gpt_pair(torch, dname, layers, model_kw, device)
        V = a.config.vocab_size
        ids = torch.as_tensor(rng.integers(0, V, batch), dtype=torch.int64,
                              device=device)
        ctx = (amp.auto_cast(level="O2", dtype="bfloat16")
               if dname == "bfloat16" else contextlib.nullcontext())
        rel = 1e-4 if dname == "float32" else 3e-2
        crit = GPTPretrainingCriterion()
        outs = []
        for m, plain in ((a, False), (b, True)):
            with (_PlainAttentionAdamW() if plain
                  else contextlib.nullcontext()):
                m.zero_grad(set_to_none=True)
                with ctx:
                    lg = m(ids)
                    loss = crit(lg, ids)
                loss.backward()
                outs.append((lg.detach().float(), float(loss.detach()),
                             [p.grad.float() for p in m.parameters()]))
        (lk, sk_, gk), (lp, sp_, gp) = outs
        err = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        print(f"gpt {dname} [{batch[0]}, {batch[1]}] logits: max_abs_err "
              f"{err:.3e} of {scale:.3e}; loss kernel {sk_:.6f} plain "
              f"{sp_:.6f}")
        if not err <= rel * scale or not abs(sk_ - sp_) <= rel * abs(sp_):
            raise AssertionError(f"phase 22 {dname}: logits or loss differ")
        worst = max(_rel_l2(torch, x, y) for x, y in zip(gk, gp))
        print(f"gpt {dname} gradients: worst relative L2 {worst:.3e} over "
              f"{len(gk)} tensors")
        if not worst <= rel:
            raise AssertionError(f"phase 22 {dname}: gradients differ")
        a.zero_grad(set_to_none=True)
        b.zero_grad(set_to_none=True)
        sa(ids)
        with _PlainAttentionAdamW():
            sb(ids)
        # moments and step counts: relative L2.  A master weight moves by
        # lr m / sqrt(v) ~ +-lr on Adam's first step whatever the
        # gradient's size, so an element whose gradient is rounding noise
        # (the k third of qkv.bias: 0 in exact arithmetic) may move the
        # other way: each element within 2 lr of the plain one's
        worst, worst_w, n = 0.0, 0.0, 0
        sda, sdb = sa.optimizer.state_dict(), sb.optimizer.state_dict()
        for key, va in sda.items():
            if not isinstance(va, torch.Tensor):
                continue
            n += 1
            vb = sdb[key]
            if key.endswith("__master_weight"):
                e = float((va - vb).abs().max())
                worst_w = max(worst_w, e)
                if not e <= rel * float(vb.abs().max()) + 2 * lr:
                    raise AssertionError(f"phase 22 {dname}: {key} differs "
                                         f"by {e} after one step")
            else:
                worst = max(worst, _rel_l2(torch, va, vb))
        print(f"gpt {dname} after one AdamW step: {n} optimizer tensors; "
              f"moments and step counts within relative L2 {worst:.3e}, "
              f"master weights within {worst_w:.3e} (2 lr = {2 * lr:.0e})")
        if not worst <= rel or n == 0:
            raise AssertionError(f"phase 22 {dname}: optimizer states "
                                 "differ after one step")
        for (na, pa), pb in zip(a.named_parameters(), b.parameters()):
            e = float((pa.detach().float() - pb.detach().float()).abs()
                      .max())
            lim = rel * float(pb.detach().float().abs().max()) + 2 * lr
            if not e <= lim:
                raise AssertionError(f"phase 22 {dname}: {na} differs by "
                                     f"{e} > {lim} after one step")
        a.eval()
        b.eval()
        P, Sp = prompts
        prompt = torch.as_tensor(rng.integers(0, V, (P, Sp)),
                                 dtype=torch.int64, device=device)
        with ctx:
            tk = generate(a, prompt, max_new_tokens=new)
            with _PlainAttentionAdamW():
                tp = generate(b, prompt, max_new_tokens=new)
                gaps = torch.topk(_gpt_forced_logits(torch, b, prompt, tp),
                                  2, dim=-1).values
        gaps = (gaps[..., 0] - gaps[..., 1]).cpu()
        if dname == "float32":
            if not torch.equal(tk, tp):
                raise AssertionError("phase 22 float32: generate's tokens "
                                     "differ between the kernel and plain "
                                     "paths")
            print(f"gpt float32 generate [{P}, {Sp}] + {new}: kernel == "
                  "plain tokens")
            full = torch.cat([prompt, tk[:, :-1].to(prompt.dtype)], dim=1)
            with torch.no_grad():
                last = a(full)[:, -1].float().argmax(-1)
            if not torch.equal(last, tk[:, -1].to(torch.int64)):
                raise AssertionError("phase 22: the last generated token is "
                                     "not the full forward's argmax")
            print("gpt float32: generate's last token == the full "
                  "forward's argmax (tests/test_gpt.py's identity)")
        else:
            # a near tie: a top-2 gap within 3x the logits' error measured
            # above may break either way
            for r in range(P):
                _agree(tk[r].tolist(), tp[r].tolist(), gaps[r].tolist(),
                       f"gpt bf16 generate row {r} kernel vs plain",
                       thresh=3 * err)
            print(f"gpt bf16 generate [{P}, {Sp}] + {new}: kernel == plain "
                  f"tokens up to a top-2 gap under {3 * err:.3e}")
        a = b = sa = sb = None
        gc.collect()
        torch.cuda.empty_cache()
    print("gpt kernel path == plain path (logits, loss, gradients, one "
          "AdamW step, generate)")


# phase 23: the reference's Transformer defaults (transformer.py:237-239)
TRANSFORMER_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
                        num_decoder_layers=6, dim_feedforward=2048,
                        dropout=0.1)


def _decode_vs_forced(torch, model, src, tgt, n):
    """The encoder's memory, ``decoder.gen_cache(memory)`` and ``n`` cached
    steps fed ``tgt[:, t]`` -> (steps [B, n, d], the teacher-forced
    ``decoder(tgt[:, :n], memory, causal mask)`` [B, n, d], seconds a step,
    each float32)."""
    from paddle_tpu_torch.nn.transformer import Transformer

    with torch.no_grad():
        memory = model.encoder(src)
        caches = model.decoder.gen_cache(memory)
        outs = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n):
            out, caches = model.decoder(tgt[:, i:i + 1], memory, None, None,
                                        caches)
            outs.append(out)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t) / n
        mask = Transformer.generate_square_subsequent_mask(
            n, device=src.device)
        forced = model.decoder(tgt[:, :n], memory, mask)
    return torch.cat(outs, dim=1).float(), forced.float(), step_s


def full_width_transformer(torch, card, geo=TRANSFORMER_BASE,
                           batch=(32, 128, 128), n=64, device="cuda"):
    """Phase 23: the Transformer base (d_model 512, 8 heads, 6 + 6 layers,
    FFN 2048, dropout 0.1) built in float32 from a seeded generator on the
    card and ``amp.decorate``d to O2 bf16: three TrainSteps of
    AdamW(multi_precision) on seeded embedded inputs, src [32, 128] and tgt
    [32, 128] under ``generate_square_subsequent_mask``, the outputs' d
    scores against seeded labels (dropout on: the attention takes the plain
    path, no B1; B9 once a parameter a step), one profiled step; then in
    eval under auto_cast
    O2 the encoder's memory, ``gen_cache`` and 64 cached steps (B1 non-
    causal at D 64: self-attention over the growing Cache, cross-attention
    over the StaticCache), each step against row t of the teacher-forced
    decoder (its self-attention the plain masked path); the same in
    float32 on a twin with the initial weights, tight.  Returns the
    "decoder" path's launches."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as prand
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.transformer import Transformer
    from paddle_tpu_torch.optimizer import AdamW

    def build():
        g = torch.Generator(device=device)
        g.manual_seed(23)
        return Transformer(**geo, device=device, generator=g)

    B, Ss, St = batch
    d = geo["d_model"]
    L = geo["num_decoder_layers"]
    t = time.perf_counter()
    model = build()
    twin = build()                       # float32, the initial weights
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    n_tensors = len(list(model.parameters()))
    mask = Transformer.generate_square_subsequent_mask(St, device=device)

    def loss_fn(m, src, tgt, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            out = m(src, tgt, None, mask)
            return F.cross_entropy(out.reshape(-1, d), y)

    step = TrainStep(model, loss_fn, opt)
    prand.seed(23)                 # the steps' dropout keys
    rng = np.random.default_rng(23)
    src = torch.as_tensor(rng.standard_normal((B, Ss, d)),
                          dtype=torch.float32, device=device)
    tgt = torch.as_tensor(rng.standard_normal((B, St, d)),
                          dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.integers(0, d, (B * St,)), dtype=torch.int64,
                        device=device)
    torch.cuda.synchronize()
    print(f"transformer: {sum(p.numel() for p in model.parameters())} "
          f"parameters in {n_tensors} tensors, setup seconds "
          f"{time.perf_counter() - t:.3f}")
    free = _sync_free(torch, step)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    losses = [free(src, tgt, y)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2):
        losses.append(free(src, tgt, y))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / 2
    lv = torch.stack(losses).float().cpu()
    print(f"transformer losses {[round(float(x), 4) for x in lv]}")
    if not bool(torch.isfinite(lv).all()) or not lv[-1] < lv[0]:
        raise AssertionError(f"phase 23 losses not finite and falling: {lv}")
    train = {k: fn.launches for k, fn in counters.items()}
    print(f"transformer train step [{B}, {Ss} / {St}] (O2 bf16, dropout "
          f"0.1): {dt * 1e3:.1f} ms, {B * St / dt:.1f} target tokens/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
          f"({card}); B9 {train['fused_adamw']} launches in 3 steps, B1 "
          f"{train['flash_attention']}")
    if train["fused_adamw"] != 3 * n_tensors or train["flash_attention"]:
        raise AssertionError(f"phase 23: training launched B9 "
                             f"{train['fused_adamw']} times (expected "
                             f"{3 * n_tensors}) and B1 "
                             f"{train['flash_attention']} (expected 0 at "
                             "dropout 0.1)")
    _profile(torch, "transformer train step", lambda: free(src, tgt, y),
             top=12)
    model.eval()
    counters = _zero_counters()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        steps, forced, step_s = _decode_vs_forced(torch, model, src, tgt, n)
    dec = {k: fn.launches for k, fn in counters.items()}
    # the encoder's L self-attentions, 2 L a cached step, and the
    # teacher-forced decoder's L cross-attentions (its self-attention is
    # masked: the plain path)
    want = geo["num_encoder_layers"] + 2 * L * n + L
    err = float((steps - forced).abs().max())
    scale = float(forced.abs().max())
    print(f"transformer decode [{B}, {n} steps] over gen_cache (O2 bf16): "
          f"{step_s * 1e3:.3f} ms a step; vs the teacher-forced decoder "
          f"max_abs_err {err:.4e} of {scale:.4e} ({err / scale:.2e}), tol "
          f"5e-2; B1 launches {dec['flash_attention']} (expected {want})")
    if dec["flash_attention"] != want:
        raise AssertionError("phase 23: B1 launches in the decode")
    if not err <= 5e-2 * scale:
        raise AssertionError("phase 23 bf16: cached steps differ from the "
                             "teacher-forced decoder")
    twin.eval()
    steps, forced, step_s = _decode_vs_forced(torch, twin, src, tgt, n)
    err = float((steps - forced).abs().max())
    scale = float(forced.abs().max())
    print(f"transformer decode float32: {step_s * 1e3:.3f} ms a step; vs "
          f"the teacher-forced decoder max_abs_err {err:.4e} of "
          f"{scale:.4e}, tol 1e-4")
    if not err <= 1e-4 * scale:
        raise AssertionError("phase 23 float32: cached steps differ from "
                             "the teacher-forced decoder")
    launches = {k: train[k] + dec[k] for k in train}
    for k in PATHS["decoder"]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 "decoder path")
    print(f"launches decoder {json.dumps(launches)}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                            "19,20,21,22,23,24,25",
                    help="phases to run after phase 1 (always run)")
    ap.add_argument("--k4-sweep", action="store_true",
                    help="phase 2 also times each K4 case under other "
                         "plans (informative)")
    ap.add_argument("--b2-sweep", action="store_true",
                    help="phase 2 also times each B2 case under every "
                         "split count (informative)")
    ap.add_argument("--k1-sweep", action="store_true",
                    help="phase 2 also times each bf16 K1 case under every "
                         "plan the instances take (informative)")
    ap.add_argument("--b7-sweep", action="store_true",
                    help="phase 2 also times each bf16 B7 case under every "
                         "plan the instances take (informative)")
    ap.add_argument("--masked-rows", metavar="ROOT", nargs="?", const=ROOT,
                    help="only time phase 2's masked K4 / K4-int8 rows "
                         "(bf16) of the package in ROOT (default: beside "
                         "this script, built there on first use), then "
                         "exit: a change and its parent timed in one call")
    ap.add_argument("--decode-costs", metavar="ROOT", nargs="?", const=ROOT,
                    help="only measure the kernel wrappers' host time a "
                         "call, an eager forward and Llama-2-7B's ms a "
                         "token and memory in generation for the package "
                         "in ROOT (``decode_costs``), then exit")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    if args.masked_rows:
        return masked_rows(torch, args.masked_rows)
    if args.decode_costs:
        return decode_costs(torch, args.decode_costs)
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch  # noqa: F401  (precision pin)
    from paddle_tpu_torch.jit import graphs

    # a CUDA graph's replay (the serving engines' megastep loops) waits for
    # nothing on the host: every replay of the run raises on a sync
    replay = _sync_free(torch, graphs.CapturedGraph.replay)

    def counted_replay(self, arrays=()):
        _REPLAYS[0] += 1
        return replay(self, arrays)

    graphs.CapturedGraph.replay = counted_replay

    t = _phase("1 environment")
    card = environment(torch)
    _done("1", t)
    launches = {path: None for path in PATHS}
    # the GPT and Transformer phases first, while no earlier phase holds
    # memory on the card
    if 21 in phases:
        t = _phase("21 GPT-3 1.3B pretraining and generation")
        launches["gpt"] = full_width_gpt(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("21", t)
    if 22 in phases:
        t = _phase("22 GPT: kernel path vs plain path")
        gpt_kernels_vs_plain(torch)
        gc.collect()
        torch.cuda.empty_cache()
        _done("22", t)
    if 23 in phases:
        t = _phase("23 the Transformer base: training and cached decoding")
        launches["decoder"] = full_width_transformer(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("23", t)
    rows = []
    if 2 in phases:
        t = _phase("2 kernels vs plain")
        rows = kernels_vs_plain(torch, k4_sweep=args.k4_sweep,
                                b2_sweep=args.b2_sweep,
                                b7_sweep=args.b7_sweep,
                                k1_sweep=args.k1_sweep)
        _done("2", t)
    if 13 in phases:
        t = _phase("13 the public block_multihead_attention")
        launches["blha"] = full_width_blha(torch)
        gc.collect()
        torch.cuda.empty_cache()
        _done("13", t)
    model = (full_width_model(torch) if phases & {3, 5, 11, 12, 14}
             else None)
    if 3 in phases:
        t = _phase("3 full-width serving")
        launches["serving"] = full_width_serving(torch, model)
        _done("3", t)
    pair = two_layer_models(torch) if phases & {4, 6, 8} else None
    # the 2-layer Llamas at head_dim 72, 100, 264 and 640 (phases 4, 6, 8)
    dims = ({d: two_layer_models(torch, d) for d in HEAD_DIM_LLAMAS}
            if phases & {4, 6, 8} else None)
    if 4 in phases:
        t = _phase("4 kernel path vs plain path")
        kernels_vs_plain_path(torch, *pair)
        spec_and_transfer_vs_plain(torch, *pair)
        for d in (72, 264, 640):
            print(f"-- head_dim {d}")
            kernels_vs_plain_path(torch, *dims[d])
        _load_weights_on_graphs(torch, dims[72][0],
                                two_layer_models(torch, 72, seed=2)[0])
        for d in (None, 72, 640):
            print(f"-- int8 cache, head_dim {d or 128}")
            int8_kernels_vs_plain(torch, *(dims[d] if d else pair))
        mixed_cache_vs_plain(torch, pair)
        print("-- full width, float32 over a bfloat16 cache")
        launches["mixed_cache"] = full_width_mixed_cache(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("4", t)
    if 5 in phases:
        t = _phase("5 full-width generation")
        launches["generate"] = full_width_generation(torch, model)
        _done("5", t)
    if 6 in phases:
        t = _phase("6 generation: kernel path vs plain path")
        generation_kernels_vs_plain(torch, *pair)
        for d in (72, 100, 264, 640):
            print(f"-- head_dim {d}")
            generation_kernels_vs_plain(torch, *dims[d])
        _done("6", t)
    if 11 in phases:
        t = _phase("11 full-width speculative serving and block transfer")
        launches["spec"] = full_width_spec(torch, model)
        gc.collect()
        full_width_transfer(torch, model)
        gc.collect()
        torch.cuda.empty_cache()
        _done("11", t)
    if 12 in phases:
        t = _phase("12 full-width int8-cache serving")
        launches["int8"] = full_width_int8(torch, model)
        gc.collect()
        torch.cuda.empty_cache()
        _done("12", t)
    if 14 in phases:
        t = _phase("14 the serving control plane at full width")
        launches["control"] = full_width_control_plane(torch, model, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("14", t)
    model = None                # the 7B weights: room for training
    torch.cuda.empty_cache()
    if 15 in phases:
        t = _phase("15 the serving fleet across worker processes")
        launches["fleet"] = full_width_fleet(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("15", t)
    if 16 in phases:
        t = _phase("16 the in-process chaos soaks")
        launches["chaos"] = full_width_chaos(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("16", t)
    if 7 in phases:
        t = _phase("7 full-width training")
        launches["train"] = full_width_training(torch)
        torch.cuda.empty_cache()
        _done("7", t)
    if 25 in phases:
        t = _phase("25 static: Program capture, the Executor, the passes "
                   "and C16")
        launches["static"] = full_width_static(torch, card, pair=pair)
        gc.collect()
        torch.cuda.empty_cache()
        _done("25", t)
    if 8 in phases:
        t = _phase("8 training: kernel path vs plain path")
        training_kernels_vs_plain(torch, *pair)
        for d in (72, 264, 640):
            print(f"-- head_dim {d}")
            training_kernels_vs_plain(torch, *dims[d])
        print("-- O1 bf16, GradScaler, clip, schedule")
        training_amp_vs_plain(torch, *amp_pair(torch))
        _done("8", t)
    pair = dims = None
    torch.cuda.empty_cache()
    if 17 in phases:
        t = _phase("17 full-width pretraining under AMP")
        launches["train_amp"] = full_width_train_amp(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("17", t)
    if 18 in phases:
        t = _phase("18 full-width BERT-base finetune with dropout")
        launches["finetune"] = full_width_finetune(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("18", t)
    if 19 in phases:
        t = _phase("19 BERT-base finetune through hapi.Model")
        launches["fit"] = full_width_fit(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("19", t)
    if 20 in phases:
        t = _phase("20 the other optimizers")
        launches["optimizers"] = full_width_lamb(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        optimizers_vs_plain(torch)
        _done("20", t)
    if 9 in phases:
        t = _phase("9 full-width predictor")
        launches["predict"] = full_width_predictor(torch, card)
        _done("9", t)
    if 10 in phases:
        t = _phase("10 predictor: kernel path vs plain path")
        predictor_kernels_vs_plain(torch)
        _done("10", t)
    if 24 in phases:
        t = _phase("24 deployment: to_static, jit.save / jit.load and the "
                   "artifact Predictor")
        launches["deploy"] = full_width_deploy(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _done("24", t)
    # launches per path, each from that path's own run: null when its
    # phase did not run
    for r in rows:
        r["launches"] = {path: (None if n is None else n[r["name"]])
                         for path, n in launches.items()}
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
