"""Serve a model through the port's runtime front door.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --events 4 [--page-size 16] [--prefill-chunk C] [--max-batch B]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --events 4 [--page-size 0]

Builds the serve runtime of any registered arch (8 slots, max_len 2048;
``--page-size 0`` the dense per-slot cache), runs ``setup`` once
(the cold start: weights from seed 0 on the card), then answers
``--events`` events of 2 random 64-token prompts each (16 new tokens per
prompt), ``--max-batch`` events per engine call, and prints one line per
event with its ELat (the wall time of the call that served it, ended by
the host reading the tokens) and cold/warm. Runs on the card; ``--device
cpu`` runs the plain PyTorch path, and ``--reduced`` the arch's
smoke-test widths.
"""
from __future__ import annotations

import argparse
import random
import time

from repro_torch.configs import get_config
from repro_torch.core.runtime import run_batch
from repro_torch.serve.api import make_serve_runtime


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced smoke-test widths")
    ap.add_argument("--events", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rdef = make_serve_runtime(cfg, max_slots=8, max_len=2048,
                              max_batch=args.max_batch,
                              page_size=args.page_size,
                              prefill_chunk=args.prefill_chunk,
                              device=args.device)
    rng = random.Random(0)
    events = [{"prompts": [[rng.randrange(3, cfg.vocab) for _ in range(64)]
                           for _ in range(2)]}
              for _ in range(args.events)]

    t0 = time.perf_counter()
    handle = rdef.setup()
    cold_s = time.perf_counter() - t0
    print(f"[{rdef.runtime_id}] cold start (setup) {cold_s:.3f}s on "
          f"{handle.device}")
    cold = True
    config = {"handle": handle, "max_new_tokens": 16}
    for start in range(0, len(events), max(args.max_batch, 1)):
        batch = events[start:start + max(args.max_batch, 1)]
        t0 = time.perf_counter()
        results = run_batch(rdef, batch, config)
        elat = time.perf_counter() - t0
        for i, res in enumerate(results):
            n_tok = sum(len(o) for o in res["outputs"])
            print(f"  ev{start + i} cold={int(cold)} ELat={elat:.3f}s "
                  f"tokens={n_tok} decode_steps={res['n_decode_steps']}")
        cold = False
    print(f"[{rdef.runtime_id}] {len(events)}/{len(events)} events served; "
          f"stats {handle.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
