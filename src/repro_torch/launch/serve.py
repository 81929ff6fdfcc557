"""Serve a model through the port's serverless front door.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --events 4 [--page-size 16] [--prefill-chunk C] [--max-batch B]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --events 4 [--page-size 0]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama4-scout-17b-a16e --reduced --device cpu --events 2
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --max-batch 2 --trace-out /tmp/t.json
    PYTHONPATH=src python -m repro_torch.obs.validate /tmp/t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \\
        --pods 2 --events 6
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim --sim \\
        --arch qwen2.5-14b,mistral-large-123b --events 4
    PYTHONPATH=src python -m repro_torch.launch.serve --min-warm 1 \\
        --slo-ms 30000 --tenant-quota free=2:4 --events 6
    PYTHONPATH=src python -m repro_torch.launch.serve --cluster 2 --events 6
    PYTHONPATH=src python -m repro_torch.launch.serve --cluster 2 \\
        --workflow 2
    PYTHONPATH=src python -m repro_torch.launch.serve --tuned \\
        --max-new-tokens 16 --events 4

Registers the serve runtime of each registered arch of ``--arch`` (a
comma-separated list; 8 slots, max_len 2048; ``--page-size 0`` the dense
per-slot cache) with a ``Gateway`` and invokes them round-robin
``--events`` times, each event 2 random 64-token prompts
(``--max-new-tokens`` new tokens per prompt, default 6 as the
reference's); ``--workflow N`` submits N three-step chains instead
(generate -> refine -> polish, each step's prompts the previous step's
outputs, read through the object store; the steps round-robin over the
runtimes). Three backends:

* ``--backend engine`` (the default): an ``EngineBackend`` whose worker
  serves micro-batches of up to ``--max-batch`` compatible events, waiting
  up to ``--batch-wait-ms`` for one to fill; the first batch pays the cold
  start (weights from seed 0 on the card).
* ``--backend sim``: a simulated cluster of ``--pods`` nodes (placement by
  ``--scheduler``), each node one accelerator of the card's own type and
  memory (unpriced: the launcher states no price for the card, so the
  cost counters read 0). The runtime's real ``fn`` runs inside virtual
  time, on the card: its ELat is the measured wall time, its cold start
  the profile's. With ``--sim`` the archs run as registered (full size)
  and execute nothing: each node is one 8-GPU H100 node
  (``serve.service_model.SIM_NODE``) and each runtime's service time is
  its roofline profile (``roofline_profile``: analytic FLOPs over the
  node's datasheet peak at 40% MFU) for an event's 2 prompts of 64
  tokens and ``--max-new-tokens`` new tokens. It needs no card.
* ``--cluster N``: a real multi-process deployment, a master in this
  process and N worker processes over the cluster RPC protocol. Every
  worker holds its own CUDA context and model copy on the card (they
  share it); the runtime travels as the importable spec
  ``repro_torch.cluster.runtimes:serve_runtime`` with ``--reduced`` and
  ``--device`` in its kwargs, and each worker builds its own copy.

Prints one line per event from its future: cold or warm, ELat and RLat
(invoke to settled). ``--slo-ms``, ``--min-warm`` and ``--tenant-quota
NAME=RATE[:BURST]`` attach a control plane (SLO scaler, warm-pool floors
prewarmed off the critical path, per-tenant admission; ``--objective``
steers its scale-out and, on the sim, picks the ``hetero-*`` scheduler);
``--fault-spec`` arms a fault-injection schedule (sim: kill-node,
stall-node; engine: crash-worker; cluster: kill-worker-process).
``--tuned`` re-execs the launcher once with the host tuning preset
(``launch/tuning.py``: tcmalloc ``LD_PRELOAD``; never over a variable
already exported). ``--trace-out`` turns the tracer on and writes the span tree as Perfetto
trace_event JSON; ``--metrics-out``
writes the metrics collector (JSON for a ``.json`` path, Prometheus text
otherwise). Runs on the card; ``--device cpu`` runs the backend and the
model on the host (the plain PyTorch path), and ``--reduced`` the arch's
smoke-test widths. The MoE archs (llama4-scout-17b-a16e, grok-1-314b) do
not fit one card at their published depth: serve them ``--reduced``, or
cut ``n_layers`` with ``dataclasses.replace`` as ``chip_smoke.py`` does.

The reference launcher (``repro.launch.serve``) defaults to the sim
backend; the port defaults to the engine, since its entry points run on
the card.
"""
from __future__ import annotations

import argparse
import json
import random

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.controlplane import (AdmissionPolicy, ControlPlane,
                                      ControlPlaneConfig, SLOPolicy,
                                      WarmPolicy)
from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.cluster import Cluster
from repro_torch.core.runtime import RuntimeDef, SimProfile
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.faults import inject, parse_fault_spec
from repro_torch.gateway import (EngineBackend, Gateway, SimBackend, Workflow,
                                 WorkflowStepError)
from repro_torch.serve.api import make_serve_runtime
from repro_torch.serve.service_model import SIM_NODE, roofline_profile

SERVE_SPEC = "repro_torch.cluster.runtimes:serve_runtime"


def accelerator_spec(device: DeviceLike = None, *, cost_per_hour: float,
                     slots: int = 1) -> AcceleratorSpec:
    """The accelerator type a simulated node offers when it runs on
    ``device``: for a card, its name (``torch.cuda.get_device_name``) and
    memory (``total_memory``); for ``"cpu"``, the type ``cpu``.
    ``cost_per_hour`` is an input of the cost counters and the cost
    objective, a price the caller states, not a measurement."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return AcceleratorSpec(type=dev.type, slots=slots,
                               cost_per_hour=cost_per_hour)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return AcceleratorSpec(
        type=torch.cuda.get_device_name(idx), slots=slots,
        mem_bytes=torch.cuda.get_device_properties(idx).total_memory,
        cost_per_hour=cost_per_hour)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    help="comma-separated arch ids")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced smoke-test widths")
    ap.add_argument("--events", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=6,
                    help="new tokens per prompt (events, workflow steps and "
                         "--sim's profiles)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--backend", default="engine", choices=["sim", "engine"],
                    help="engine = worker threads on the card (default); "
                         "sim = pod cluster on the event clock")
    ap.add_argument("--cluster", type=int, default=None, metavar="N",
                    help="spawn a real master/worker deployment with N "
                         "worker processes sharing the card (overrides "
                         "--backend)")
    ap.add_argument("--workflow", type=int, default=0, metavar="N",
                    help="submit N generate->refine->polish chained "
                         "workflows (one submission each) instead of "
                         "--events flat invocations")
    ap.add_argument("--sim", action="store_true",
                    help="simulate full-size configs with roofline-derived "
                         "service times on 8-GPU H100 nodes instead of "
                         "running the model (sim backend only)")
    ap.add_argument("--pods", type=int, default=None,
                    help="sim backend only (default 2)")
    ap.add_argument("--scheduler", default=None,
                    choices=["warm", "fifo", "cost", "hetero-latency",
                             "hetero-cost", "hetero-energy"],
                    help="sim backend only (default warm)")
    ap.add_argument("--objective", default=None,
                    choices=["latency", "cost", "energy"],
                    help="placement objective (default latency): picks the "
                         "matching hetero-* scheduler on the sim backend "
                         "and steers control-plane scale-out/prewarm")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="engine backend and cluster workers: largest "
                         "micro-batch of compatible events one engine call "
                         "serves (default 1)")
    ap.add_argument("--batch-wait-ms", type=float, default=None,
                    help="engine backend: max wait for a micro-batch to "
                         "fill before a partial one is dispatched "
                         "(default 2 ms)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="attach a control plane whose SLO scaler targets "
                         "this RLat p99 (milliseconds)")
    ap.add_argument("--min-warm", type=int, default=None, metavar="N",
                    help="control plane keeps N instances of the runtime "
                         "warm (prewarmed off the critical path, pinned "
                         "against eviction)")
    ap.add_argument("--tenant-quota", action="append", default=None,
                    metavar="NAME=RATE[:BURST]",
                    help="per-tenant admission quota in events/s (burst "
                         "defaults to 2*rate); repeatable; over-quota "
                         "events are shed as rejected")
    ap.add_argument("--fault-spec", default=None, metavar="JSON|@FILE",
                    help="arm a fault-injection schedule: a JSON list of "
                         "actions (or @path to a file holding one); sim "
                         "ops: kill-node/stall-node, engine ops: "
                         "crash-worker, cluster ops: kill-worker-process")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics collector to PATH after the run "
                         "(JSON for .json paths, Prometheus text otherwise)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace every invocation and write the span tree to "
                         "PATH as Perfetto trace_event JSON")
    ap.add_argument("--tuned", action="store_true",
                    help="re-exec once with the host tuning preset (tcmalloc "
                         "LD_PRELOAD; launch/tuning.py) before the card is "
                         "touched")
    args = ap.parse_args(argv)
    if args.tuned and argv is None:
        # LD_PRELOAD only binds at process start: apply the preset by
        # re-exec (a no-op inside the tuned child); never for a call with
        # argv given, so a test keeps its interpreter
        from repro_torch.launch.tuning import maybe_reexec
        maybe_reexec("repro_torch.launch.serve")
    if args.prefill_chunk and not args.page_size:
        ap.error("--prefill-chunk needs --page-size > 0 (chunked prefill "
                 "scatters into the paged KV pool)")
    mode = "cluster" if args.cluster is not None else args.backend
    if mode == "cluster":
        if args.cluster < 1:
            ap.error("--cluster needs at least 1 worker process")
        if args.sim or args.pods is not None or args.scheduler is not None:
            ap.error("--sim/--pods/--scheduler only apply to --backend sim "
                     "(--cluster runs real worker processes)")
        if args.batch_wait_ms is not None:
            ap.error("--batch-wait-ms only applies to --backend engine "
                     "(cluster workers batch at the master's queue)")
    elif mode == "engine":
        if args.sim:
            ap.error("--sim requires --backend sim (the engine backend "
                     "executes real code)")
        if args.pods is not None or args.scheduler is not None:
            ap.error("--pods/--scheduler only apply to --backend sim "
                     "(the engine backend schedules on this host's devices)")
    elif args.max_batch is not None or args.batch_wait_ms is not None:
        ap.error("--max-batch/--batch-wait-ms only apply to "
                 "--backend engine (the sim models batching in its "
                 "service-time profiles)")
    if args.objective is not None and args.scheduler is not None:
        ap.error("--objective and --scheduler both pick the sim placement "
                 "policy; pass one (--objective X equals --scheduler "
                 "hetero-X plus the control-plane spend steer)")
    quotas = {}
    for spec_str in args.tenant_quota or []:
        name, _, rate_s = spec_str.partition("=")
        if not name or not rate_s:
            ap.error(f"--tenant-quota {spec_str!r}: expected "
                     f"NAME=RATE[:BURST]")
        rate_part, _, burst_part = rate_s.partition(":")
        rate = float(rate_part)
        quotas[name] = (rate, float(burst_part) if burst_part else 2.0 * rate)
    objective = args.objective if args.objective is not None else "latency"
    pods = args.pods if args.pods is not None else 2
    scheduler = args.scheduler if args.scheduler is not None else (
        f"hetero-{args.objective}" if args.objective is not None else "warm")
    max_batch = max(args.max_batch if args.max_batch is not None else 1, 1)
    sim = mode == "sim"

    archs = args.arch.split(",")
    cfgs = [get_config(arch) for arch in archs]
    if args.reduced:
        cfgs = [c.reduced() for c in cfgs]
    cluster_h = None
    if mode == "cluster":
        from repro_torch.cluster import start_cluster
        # the cold start (weights on the card, the kernels' first build)
        # must not read as death: generous lease and heartbeat bounds
        cluster_h = start_cluster(args.cluster, lease_s=300.0,
                                  heartbeat_timeout_s=30.0,
                                  max_batch=max_batch, ready_timeout_s=60.0)
        backend = cluster_h.backend
        acc_types = None
    elif sim:
        # --sim simulates 8-GPU H100 nodes; otherwise each node is the card
        spec = SIM_NODE if args.sim else accelerator_spec(args.device,
                                                          cost_per_hour=0.0)
        cluster = Cluster(scheduler=scheduler, seed=0)
        for p in range(pods):
            cluster.add_node(f"pod{p}", [spec])
        backend = SimBackend(cluster)
        acc_types = {spec.type: SimProfile(elat_median_s=0.4,
                                           cold_start_s=2.0)}
    else:
        backend = EngineBackend(
            max_batch=max_batch,
            batch_wait_s=(args.batch_wait_ms if args.batch_wait_ms
                          is not None else 2.0) / 1e3,
            device=args.device)
        acc_types = None        # make_serve_runtime's host-cuda profile
    gw = Gateway(backend)
    if args.trace_out:
        # on before the first invoke, so every event carries a trace
        obs.enable(clock=backend.now, metrics=gw.metrics)
    plane = injector = None
    futs = []
    ok = 0
    wf_ok = False
    try:
        rt_ids = []
        for arch, cfg in zip(archs, cfgs):
            if mode == "cluster":
                # cluster runtimes travel as importable factory specs, never
                # as closures: each worker process builds its own copy
                from repro_torch.cluster import load_runtime_spec
                rdef = load_runtime_spec(SERVE_SPEC, {
                    "arch": arch, "max_batch": max_batch, "max_slots": 8,
                    "max_len": 2048, "page_size": args.page_size,
                    "prefill_chunk": args.prefill_chunk,
                    "reduced": args.reduced, "device": args.device})
            elif args.sim:
                # an event is 2 prompts of 64 tokens
                rdef = RuntimeDef(
                    runtime_id=f"serve-{cfg.name}",
                    profiles={SIM_NODE.type: roofline_profile(
                        cfg, batch=2, new_tokens=args.max_new_tokens,
                        prompt_len=64)})
            else:
                rdef = make_serve_runtime(
                    cfg, acc_types=acc_types, max_slots=8, max_len=2048,
                    max_batch=max_batch, page_size=args.page_size,
                    prefill_chunk=args.prefill_chunk, device=args.device)
            rt_ids.append(gw.register(rdef))
        if args.slo_ms is not None or args.min_warm is not None or quotas:
            plane = ControlPlane(ControlPlaneConfig(
                tick_interval_s=5.0 if sim else 0.5,
                objective=objective,
                # the sim's pre-provisioned pods are the capacity floor
                # (they are not drainable); the engine floors at one
                slo=(SLOPolicy(slo_rlat_p99_s=args.slo_ms / 1e3,
                               min_units=pods if sim else 1)
                     if args.slo_ms is not None else None),
                warm=(WarmPolicy(min_warm={rid: args.min_warm
                                           for rid in rt_ids})
                      if args.min_warm is not None else None),
                admission=(AdmissionPolicy(tenant_quotas=quotas)
                           if quotas else None),
            )).attach(backend)
            plane.start()
        if args.fault_spec:
            spec_text = args.fault_spec
            if spec_text.startswith("@"):
                with open(spec_text[1:]) as f:
                    spec_text = f.read()
            injector = inject(backend, parse_fault_spec(spec_text))

        rng = random.Random(0)
        vocab = min(c.vocab for c in cfgs)
        events = [{"prompts": [[rng.randrange(3, vocab)
                                for _ in range(64)] for _ in range(2)]}
                  for _ in range(args.events)]
        run = {"max_new_tokens": args.max_new_tokens}
        if args.workflow:
            seed = {"prompts": [[rng.randrange(3, vocab) for _ in range(64)]
                                for _ in range(2)]}
            wf_ok = run_workflows(gw, rt_ids, args.workflow, seed, run)
        else:
            futs = [gw.invoke(rt_ids[i % len(rt_ids)], ev, config=run)
                    for i, ev in enumerate(events)]
            gw.drain()
        rid = ",".join(rt_ids)
        cold = next((f.invocation for f in futs if f.invocation.cold_start),
                    None)
        if cold is not None and cold.e_start is not None:
            print(f"[{rid}] cold start (setup, in dispatch) "
                  f"{cold.e_start - cold.n_start:.3f}s on {cold.accelerator}")
        for i, fut in enumerate(futs):
            inv = fut.invocation
            if not inv.success:
                print(f"  ev{i} FAILED: {inv.error}")
                continue
            ok += 1
            res = fut.result()
            ran = "" if res is None else (   # a --sim profile returns nothing
                f" tokens={sum(len(o) for o in res['outputs'])} "
                f"decode_steps={res['n_decode_steps']}")
            print(f"  ev{i} cold={int(inv.cold_start)} "
                  f"prewarmed={int(inv.prewarmed)} acc={inv.accelerator} "
                  f"ELat={inv.elat:.3f}s RLat={inv.rlat:.3f}s{ran}")
        if args.sim:
            for rt in rt_ids:
                prof = gw.backend.registry.get(rt).profiles[SIM_NODE.type]
                print(f"  profile {rt}: ELat median {prof.elat_median_s:.6f}s "
                      f"cold start {prof.cold_start_s:.3f}s on {SIM_NODE.type}")
        done = gw.metrics.completed
        served = f"{sum(i.success for i in done)}/{len(done)} workflow steps " \
            "succeeded" if args.workflow else f"{ok}/{len(futs)} events served"
        if sim:
            counts = "; ".join(f"{n.name}: cold={n.n_cold_starts} "
                               f"warm={n.n_warm_starts} "
                               f"prewarmed={n.n_prewarms}"
                               for n in cluster.nodes)
            print(f"[{rid}] {served}; {counts}")
        elif mode == "cluster":
            st = backend.stats()
            for name, rep in sorted(st.get("workers", {}).items()):
                ws = rep.get("stats") or {}
                print(f"{name}: pid={ws.get('pid')} "
                      f"batches={ws.get('n_batches', 0)} "
                      f"cold={ws.get('n_cold_starts', 0)} "
                      f"warm={ws.get('n_warm_starts', 0)} "
                      f"settled={ws.get('n_settled', 0)}")
            print(f"[{rid}] {served}; master: "
                  f"settled={st.get('settled')} "
                  f"requeued={st.get('requeued')} "
                  f"workers_lost={st.get('workers_lost')} "
                  f"duplicate_settles={st.get('duplicate_settles')}")
        else:
            handle = backend.handle(futs[0].invocation.runtime_key) \
                if futs else None
            stats = handle.stats() if handle is not None else {}
            print(f"[{rid}] {served}; cold="
                  f"{backend.n_cold_starts} warm={backend.n_warm_starts} "
                  f"prewarmed={backend.n_prewarms} rejected="
                  f"{backend.n_rejected} batches={backend.batch_sizes}; "
                  f"stats {stats}")
        if plane is not None:
            plane.stop()
            print(f"controlplane: {plane.summary()}")
        if injector is not None:
            injector.disarm()
            s = gw.metrics.summary()
            print(f"faults: {injector.summary()} "
                  f"retried={s['retried']:.0f} "
                  f"failed={s['failed']:.0f} "
                  f"exhausted={s['retries_exhausted']:.0f}")
    finally:
        if plane is not None:
            plane.detach()
        if cluster_h is not None:
            cluster_h.close()   # shut the master down, reap the workers
        elif not sim:
            backend.shutdown()
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                if args.metrics_out.endswith(".json"):
                    json.dump(gw.metrics.to_json(), f, indent=2)
                else:
                    f.write(gw.metrics.prometheus_text())
            print(f"wrote {args.metrics_out}")
        if args.trace_out:
            n = obs.export(args.trace_out)
            obs.reset()
            print(f"wrote {args.trace_out} ({n} trace events)")
    if args.workflow:
        # a retried-then-recovered step leaves its failed attempt in the
        # metrics; the verdict is whether the workflows completed
        return 0 if wf_ok else 1
    # admission sheds are policy outcomes, not failures; with faults armed,
    # a retries-exhausted record is the at-least-once contract (settled,
    # not stranded)
    settled = sum(1 for f in futs if f.invocation.r_end is not None and (
        f.invocation.success or f.invocation.rejected or
        (injector is not None and f.invocation.retries_exhausted)))
    return 0 if settled == len(futs) else 1


def run_workflows(gw, rt_ids, n: int, seed_event, run) -> bool:
    """Submit ``n`` three-step chains (generate -> refine -> polish): the
    first step reads ``seed_event`` from the object store, each later
    step's prompts are the previous step's outputs, and the steps
    round-robin over ``rt_ids``. Prints each chain's step statuses;
    True when every step of every chain is done."""
    data_ref = gw.put(seed_event)
    wf_futs = []
    for w in range(n):
        wf = Workflow(f"chain{w}")
        prev = wf.step("generate", rt_ids[w % len(rt_ids)],
                       data_ref=data_ref, config=run)
        for j, stage in enumerate(("refine", "polish")):
            prev = wf.step(stage, rt_ids[(w + j + 1) % len(rt_ids)],
                           after=prev, config=run, retries=1)
        wf_futs.append(gw.submit_workflow(wf))
    ok = True
    for fut in wf_futs:
        try:
            out = fut.result()
            print(f"  workflow {fut.name}: {fut.statuses()} tokens="
                  f"{sum(len(o) for o in out['outputs'])}")
        except WorkflowStepError as e:
            print(f"  workflow {fut.name} FAILED: {e}; {fut.statuses()}")
            ok = False
        ok &= all(s == "done" for s in fut.statuses().values())
    return ok


if __name__ == "__main__":
    raise SystemExit(main())
