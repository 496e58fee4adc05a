#!/usr/bin/env python
"""Remote serving replica worker: one ServingEngine in its own process,
driven over RPC by a ServingFleet frontend (possibly on another host).

Copied from ``tools/serving_worker.py`` of the JAX package, adapted to the
port: ``--device`` replaces ``--platform``, the model is the port's
``LlamaForCausalLM`` on that device, the spec may carry the JAX package's
weights (``numpy_state``), and the exit line carries the kernel launch
counts.

Boot sequence: resolve the device (``--device cpu`` for tests and CI;
without it the worker runs on ``cuda``, and a host without CUDA fails the
boot with the device module's ``RuntimeError`` — nothing falls back to the
CPU), build the seeded model + engine from ``--spec-json``, install them
as this process's served replica (``fleet.init_worker``), register with
the launch KV master via ``rpc.init_rpc``, then park until the frontend's
``_w_shutdown`` RPC (or SIGTERM).  All serving traffic — add_request /
step / evict / health — arrives as RPC calls into
``paddle_tpu_torch.inference.fleet``'s ``_w_*`` handlers, each on a thread
of its own; the handlers that issue CUDA work, and the blockwire
listener's exports, share one worker lock (see ``fleet``'s docstring);
this file is only the bootstrap.  One ``_w_step`` RPC drives one engine
step — which, with megastep decode, returns up to ``megastep_k`` tokens
per running sequence per round trip.

The worker deliberately OUTLIVES its frontend: it parks on the stop
event, not on the frontend's liveness, so a crashed frontend leaves the
worker registered and serving-ready.  The recovered frontend reattaches
(``fleet.discover_workers``/``connect_workers`` + ``RemoteReplica``),
calls the ``_w_reap_orphans`` handler to evict the dead frontend's
sequences (publishing their KV blocks into the prefix cache), and
re-admits from its write-ahead journal.

Because frontends come and go across one worker life, every control RPC
handler is EPOCH-FENCED: ``fleet.init_worker`` arms an ``EpochFence``
that remembers the highest frontend epoch this process has ever seen, and
a call carrying an older epoch — a zombie frontend resumed after its
lease expired and a standby took over — raises the typed ``StaleEpoch``
instead of touching the engine.  ``_w_shutdown`` is fenced too (a deposed
frontend cannot shut down the new incarnation's fleet), but SIGTERM still
works for operators.

Spec JSON (everything the worker needs to be a bit-identical replica):

    {"seed": 11,
     "model": {"vocab_size": 256, "hidden_size": 64, ...},   # LlamaConfig
     "engine": {"max_batch_size": 2, "max_seq_len": 64, ...},
     "bfloat16": false,
     "numpy_state": "/path/to/state.npz",  # optional: the JAX package's
                           # state_dict as numpy, loaded over the seeded
                           # build (load_numpy_state_dict)
     "role": "prefill",    # optional disaggregation label (or "decode")
     "wire": true}         # optional binary KV data-plane listener: its
                           # endpoint rides the launch-KV registration
                           # (/serving/wire/<name>) + every health reply

Every ``ServingEngine`` kwarg rides ``"engine"`` verbatim (``spec_k``,
``prefill_chunk_tokens``, ``megastep_k``, ...); ``"tracing": true`` arms a
flight recorder; ``"faults"`` arms worker-side failpoints.

Output: ``WORKER_READY <name> pid=<pid>`` once registered, and at a clean
exit ``WORKER_EXIT <name> launches=<json>``, the kernel wrappers' launch
counts of the process (``ops.hopper.launch_counters()``; ``name.attr``
for their other ``*launches`` counts, such as the masked K4 instances').
The counts start at 0 when the worker registers (a ``--warm`` worker's
throwaway request is not counted), and ``reset_launch_counts`` over RPC
sets them to 0 again before a measured run.

Run standalone (an operator adding capacity from another host):

    python -m paddle_tpu_torch.tools.serving_worker --master 10.0.0.1:8765 \\
        --name worker7 --spec-json "$(cat spec.json)"
"""
import argparse
import json
import os
import signal
import sys


def launch_counts():
    """{kernel: launches} of this process, plus ``kernel.attr`` for each
    other ``*launches`` count a wrapper keeps."""
    from paddle_tpu_torch.ops.hopper import launch_counters

    out = {}
    for name, fn in launch_counters().items():
        for attr, v in sorted(vars(fn).items()):
            if attr.endswith("launches") and isinstance(v, int):
                out[name if attr == "launches" else f"{name}.{attr}"] = v
    return out


def reset_launch_counts():
    """Set every count ``launch_counts`` reads to 0 (a caller's
    ``rpc_sync(worker, reset_launch_counts)`` does it in a worker)."""
    from paddle_tpu_torch.ops.hopper import launch_counters

    for fn in launch_counters().values():
        for attr, v in list(vars(fn).items()):
            if attr.endswith("launches") and isinstance(v, int):
                setattr(fn, attr, 0)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--master", required=True,
                    help="KV master endpoint ip:port (launch KVServer)")
    ap.add_argument("--name", required=True, help="unique worker name")
    ap.add_argument("--spec-json", required=True,
                    help="model/engine spec as inline JSON, or @/path/to.json")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="'cpu' runs the plain versions on the CPU (tests, "
                         "ServingFleet(cpu_workers=True)); default cuda, "
                         "which fails the boot without CUDA")
    ap.add_argument("--warm", action="store_true",
                    help="warm-pool boot: run the step/megastep programs "
                         "once with a throwaway request (on the card their "
                         "eager first calls and CUDA graph captures) BEFORE "
                         "registering, then park behind a "
                         "/serving/warm/<name> KV marker until a fleet "
                         "claims this worker — scale-up becomes a health "
                         "probe instead of a boot")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if repo not in sys.path:
        sys.path.insert(0, repo)

    from paddle_tpu_torch.device import resolve_device

    # first: a worker that may not run where it was asked fails its boot
    # here, loudly, before anything is built
    device = resolve_device(args.device)

    spec = args.spec_json
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    spec = json.loads(spec)

    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.distributed.launch.master import KVClient
    from paddle_tpu_torch.inference import ServingEngine, fleet
    from paddle_tpu_torch.inference.faults import FaultInjector

    model = fleet.build_spec_model(spec.get("model"), spec.get("seed", 0),
                                   bool(spec.get("bfloat16")), device=device,
                                   numpy_state=spec.get("numpy_state"))
    # chaos runs arm worker-side failpoints through the spec (the fleet
    # ships the same JSON to every worker, so a fault schedule is part of
    # the replica recipe): {"faults": {"seed": 7, "sites": {...}}}
    faults = spec.get("faults")
    # "replica_namespaces" rides the spec exactly like the env JSON's
    # (FaultInjector.from_env): without it, replica-scoped sites
    # ("r0.step") would fail the arm-time namespace validation at boot
    injector = (FaultInjector(faults.get("sites", {}),
                              seed=faults.get("seed", 0),
                              replica_namespaces=faults.get(
                                  "replica_namespaces", ()))
                if faults else None)
    engine = ServingEngine(model, fault_injector=injector, device=device,
                           **spec.get("engine", {}))
    # the engine holds the weights; without the model object a rolling
    # swap frees them
    del model
    # weights identity labels: a worker respawned AFTER a rolling swap
    # boots the new recipe — the spec carries the version label so it
    # reports the version it actually serves, not "v0"
    if "weights_version" in spec:
        engine.weights_version = str(spec["weights_version"])
    if "model_id" in spec:
        engine.model_id = str(spec["model_id"])
    # tracing: {"tracing": true} in the spec arms a per-worker flight
    # recorder; the engine's span events (prefill done, megastep
    # boundaries) ship back on every _w_step reply / _w_pop_traces RPC
    if spec.get("tracing"):
        from paddle_tpu_torch.inference.tracing import FlightRecorder

        engine.trace_recorder = FlightRecorder(proc=args.name)
        if injector is not None:
            injector.recorder = engine.trace_recorder

    role = spec.get("role")
    stop = fleet.init_worker(engine, name=args.name, fault_injector=injector,
                             role=role)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    if args.warm:
        # pre-pay the first calls BEFORE registering (registration is the
        # pool's ready signal): one throwaway sub-block request drives the
        # prefill program and one decode megastep.  The prompt is shorter
        # than a block, so no FULL block is ever published — the prefix
        # cache stays empty and a warm attach is token/cache-identical to
        # a cold boot.
        engine.add_request([1], max_new_tokens=2)
        while engine.num_active or engine._queue:
            engine.step()
        engine.pop_finished()
        engine.pop_token_logprobs()
        engine.pop_trace_events()
        # the warm-up is not traffic: the exit line counts what the
        # worker ran after it registered, and health probes read the
        # state after the warm-up
        reset_launch_counts()
        fleet._publish(engine)
    wire_server = None
    if spec.get("wire"):
        # binary KV data plane: open the worker's blockwire listener
        # before registering, sharing the SAME EpochFence the control RPCs
        # fence through (a deposed frontend's pull is rejected typed on
        # both planes) and the worker lock its CUDA-issuing handlers hold.
        # Bind all interfaces and advertise the rpc stack's peer-reachable
        # address.
        import socket as _socket

        from paddle_tpu_torch.inference.blockwire import BlockWireServer

        adv = os.environ.get("PADDLE_LOCAL_IP")
        if not adv:
            try:
                adv = _socket.gethostbyname(_socket.gethostname())
            except OSError:
                adv = "127.0.0.1"
        wire_server = BlockWireServer(engine, fence=fleet._WORKER["fence"],
                                      fault_injector=injector,
                                      host="0.0.0.0", advertise_host=adv,
                                      lock=fleet._WORKER["lock"])
    rpc.init_rpc(args.name, rank=args.rank, world_size=1,
                 master_endpoint=args.master)
    kv = KVClient(args.master)
    if role is not None:
        # the role label rides the launch-KV registration next to the rpc
        # entry, so discovery (fleet.worker_roles / connect_workers) can
        # rebuild a role-correct fleet on StandbyFrontend takeover even
        # without probing every worker first
        kv.put(f"/serving/roles/{args.name}", role)
    if wire_server is not None:
        # the data-plane endpoint registers next to the role label (and
        # rides every health reply), so peers can pull blocks directly
        kv.put(f"/serving/wire/{args.name}", wire_server.endpoint)
    if args.warm:
        # the warm marker keeps this worker out of discovery (a
        # recovering frontend must not adopt pool inventory); the
        # claiming fleet deletes it at attach time
        kv.put(f"/serving/warm/{args.name}", "1")
    print(f"WORKER_READY {args.name} pid={os.getpid()}", flush=True)
    stop.wait()
    if wire_server is not None:
        wire_server.close()
    rpc.shutdown()
    print(f"WORKER_EXIT {args.name} launches="
          f"{json.dumps(launch_counts(), sort_keys=True)}", flush=True)


if __name__ == "__main__":
    main()
