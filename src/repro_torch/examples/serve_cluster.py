"""End-to-end serving example (the paper's execution model with REAL
execution). The port's twin of ``examples/serve_cluster.py``: the same
pods, runtimes, events and printed lines.

Two "pods" (nodes) advertise different accelerator types; two architectures
are registered as serverless runtimes. Events carry batches of generation
requests; node managers cold-start engines (weights, first launches) on
first use, reuse them while warm, and persist results to object storage:
the full Hardless §IV lifecycle with actual model execution on
``--device`` (the card unless ``--device cpu``).

Backend exercised: sim (pod cluster on the virtual clock) with REAL
reduced-config forwards inside each simulated node. The pods hold an
8-card and a 1-card H100 node where the reference's hold TPU slices; the
per-type ELat profiles are the reference's stated ones. Event order and
placement follow the measured ELats, so they vary between runs, of the
reference as of the twin.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.cluster import Cluster
from repro_torch.core.events import Invocation
from repro_torch.core.runtime import SimProfile
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serve.api import make_serve_runtime

# unpriced, as the port's other sim nodes (a price is an input the caller
# states, not a measurement)
NODE_8 = AcceleratorSpec(type="h100-sxm-8", slots=1, mem_bytes=8 * (80 << 30),
                         cost_per_hour=0.0, chips=8)
NODE_1 = AcceleratorSpec(type="h100-sxm-1", slots=1, mem_bytes=80 << 30,
                         cost_per_hour=0.0, chips=1)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the runtimes (default: cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)

    cluster = Cluster(scheduler="warm", seed=0)
    cluster.add_node("pod0", [NODE_8, NODE_1])
    cluster.add_node("pod1", [NODE_1])

    profiles = {
        NODE_8.type: SimProfile(elat_median_s=0.2, cold_start_s=2.0),
        NODE_1.type: SimProfile(elat_median_s=0.6, cold_start_s=2.0),
    }
    for arch in ("granite-3-2b", "qwen2.5-14b"):
        rdef = make_serve_runtime(get_config(arch).reduced(), acc_types=profiles,
                                  max_slots=4, max_len=64, device=args.device)
        cluster.register_runtime(rdef)

    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in
               ["the quick brown fox", "serverless accelerators", "hello"]]
    data_ref = cluster.store.put({"prompts": prompts})

    # async events: (runtime reference, data reference, run config): the
    # user never selects hardware; the platform routes to whatever node is
    # free
    for i in range(4):
        arch = ["granite-3-2b", "qwen2.5-14b"][i % 2]
        cluster.submit(Invocation(
            runtime_id=f"serve-{arch}-smoke", data_ref=data_ref,
            config={"max_new_tokens": 6}, r_start=float(i) * 0.5))

    cluster.run(until=100_000.0)

    print(f"events completed: {len(cluster.metrics.completed)}")
    for inv in cluster.metrics.completed:
        res = cluster.store.get_outcome(inv.result_ref)["value"]
        print(f"  event {inv.inv_id}: rt={inv.runtime_id} acc={inv.accelerator} "
              f"cold={inv.cold_start} ELat={inv.elat:.2f}s "
              f"outputs={[len(o) for o in res['outputs']]} tokens")
    for node in cluster.nodes:
        print(f"{node.name}: cold={node.n_cold_starts} warm={node.n_warm_starts}")
    assert all(i.success for i in cluster.metrics.completed)
    print("OK — serverless serving with real PyTorch execution")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
