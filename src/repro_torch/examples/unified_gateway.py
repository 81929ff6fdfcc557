"""One client, two execution worlds: the SAME ``invoke()`` code runs
against the calibrated cluster simulation and against real execution on
the card, only the backend handed to the Gateway changes. The port's twin
of ``examples/unified_gateway.py``: the same client, runtimes and printed
lines.

Backends exercised: BOTH: sim (roofline service times of one 8-GPU H100
node, ``SIM_NODE``, where the reference simulates a TPU slice; virtual
clock) then engine (the reference example's reduced config, run for real
on ``--device``: the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.unified_gateway
    PYTHONPATH=src python -m repro_torch.examples.unified_gateway --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.core.cluster import Cluster
from repro_torch.core.runtime import RuntimeDef
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.gateway import EngineBackend, Gateway, SimBackend
from repro_torch.serve.api import make_serve_runtime
from repro_torch.serve.service_model import SIM_NODE, roofline_profile

ARCH = "granite-3-2b"
PROMPTS = ["the quick brown fox", "serverless accelerators", "hardless"]


def run_client(gw: Gateway, runtime_id: str) -> None:
    """The serverless client, identical for every backend: stage data,
    fan out events, poll futures, read results from object storage."""
    tok = ByteTokenizer()
    payloads = [{"prompts": [tok.encode(p)]} for p in PROMPTS]
    futs = gw.map(runtime_id, payloads, config={"max_new_tokens": 4},
                  at=0.0, spacing_s=0.5)
    gw.drain()
    name = gw.backend.name
    for fut in futs:
        inv = fut.invocation
        assert fut.poll(), f"result for ev{fut.inv_id} not in object store"
        fut.result()    # raises if the invocation failed
        print(f"  [{name}] ev{fut.inv_id} cold={int(inv.cold_start)} "
              f"ELat={fut.elat:.3f}s RLat={fut.rlat:.3f}s")
    s = gw.summary()
    print(f"  [{name}] ELat p50 = {s['elat_p50']:.3f}s, "
          f"cold starts = {s['cold_starts']}, "
          f"RSuccess = {s['r_success']}/{s['n_completed']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the engine backend (default: cuda; "
                         "raises without a card)")
    args = ap.parse_args(argv)

    # -- backend 1: calibrated simulation (full-size config, no hardware)
    print("sim backend (event-driven cluster, roofline service times):")
    cfg_full = get_config(ARCH)
    cluster = Cluster(scheduler="warm", seed=0)
    cluster.add_node("pod0", [SIM_NODE])
    sim_gw = Gateway(SimBackend(cluster))
    sim_gw.register(RuntimeDef(
        runtime_id=f"serve-{cfg_full.name}",
        profiles={SIM_NODE.type: roofline_profile(cfg_full, batch=1, new_tokens=4)}))
    run_client(sim_gw, f"serve-{cfg_full.name}")

    # -- backend 2: the engine on the device (reduced config)
    print("engine backend (real execution: cold = weights + kernel build, "
          "warm = reuse):")
    cfg_red = get_config(ARCH).reduced()
    eng_gw = Gateway(EngineBackend(device=args.device))
    try:
        eng_gw.register(make_serve_runtime(cfg_red, max_slots=2, max_len=48,
                                           device=args.device))
        run_client(eng_gw, f"serve-{cfg_red.name}")
    finally:
        eng_gw.backend.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
