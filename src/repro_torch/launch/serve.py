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

Registers the serve runtime of any registered arch (8 slots, max_len 2048;
``--page-size 0`` the dense per-slot cache) with a ``Gateway`` over an
``EngineBackend`` and invokes it ``--events`` times, each event 2 random
64-token prompts (16 new tokens per prompt). The backend's worker serves
micro-batches of up to ``--max-batch`` compatible events, waiting up to
``--batch-wait-ms`` for one to fill; the first batch pays the cold start
(weights from seed 0 on the card). Prints one line per event from its
future: cold or warm, ELat (the batch call that served it, ended by the
host reading the tokens) and RLat (invoke to settled). ``--trace-out``
turns the tracer on and writes the span tree as Perfetto trace_event
JSON; ``--metrics-out`` writes the metrics collector (JSON for a ``.json``
path, Prometheus text otherwise). Runs on the card; ``--device cpu`` runs
the backend's worker and the model on the host (the plain PyTorch path),
and ``--reduced`` the arch's smoke-test widths. The MoE archs
(llama4-scout-17b-a16e, grok-1-314b) do not fit one card at their
published depth: serve them ``--reduced``, or cut ``n_layers`` with
``dataclasses.replace`` as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import random

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.gateway import EngineBackend, Gateway
from repro_torch.serve.api import make_serve_runtime


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced smoke-test widths")
    ap.add_argument("--events", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="largest micro-batch of compatible events one "
                         "engine call serves")
    ap.add_argument("--batch-wait-ms", type=float, default=2.0,
                    help="max wait for a micro-batch to fill before a "
                         "partial one is dispatched")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics collector to PATH after the run "
                         "(JSON for .json paths, Prometheus text otherwise)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace every invocation and write the span tree to "
                         "PATH as Perfetto trace_event JSON")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_batch = max(args.max_batch, 1)
    eb = EngineBackend(max_batch=max_batch,
                       batch_wait_s=args.batch_wait_ms / 1e3,
                       device=args.device)
    gw = Gateway(eb)
    if args.trace_out:
        # on before the first invoke, so every event carries a trace
        obs.enable(clock=eb.now, metrics=gw.metrics)
    try:
        rid = gw.register(make_serve_runtime(
            cfg, max_slots=8, max_len=2048, max_batch=max_batch,
            page_size=args.page_size, prefill_chunk=args.prefill_chunk,
            device=args.device))
        rng = random.Random(0)
        events = [{"prompts": [[rng.randrange(3, cfg.vocab)
                                for _ in range(64)] for _ in range(2)]}
                  for _ in range(args.events)]
        futs = gw.map(rid, events, config={"max_new_tokens": 16})
        gw.drain()
        ok = 0
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
            n_tok = sum(len(o) for o in res["outputs"])
            print(f"  ev{i} cold={int(inv.cold_start)} ELat={inv.elat:.3f}s "
                  f"RLat={inv.rlat:.3f}s tokens={n_tok} "
                  f"decode_steps={res['n_decode_steps']}")
        handle = eb.handle(futs[0].invocation.runtime_key) if futs else None
        stats = handle.stats() if handle is not None else {}
        print(f"[{rid}] {ok}/{len(futs)} events served; cold="
              f"{eb.n_cold_starts} warm={eb.n_warm_starts} batches="
              f"{eb.batch_sizes}; stats {stats}")
    finally:
        eb.shutdown()
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
    return 0 if ok == len(futs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
