"""Cluster quickstart: master + 2 real worker processes, spec-registered
runtimes, a mid-run SIGKILL, and a workflow spanning both workers. The
port's twin of ``examples/cluster_quickstart.py``: the same three runs and
printed lines. Its runtimes (``sleep_runtime``, ``add_runtime``) run no
model, so nothing of it is placed on a card, and it takes no ``--device``.

Backend exercised: cluster (multi-process master/worker over the
versioned RPC protocol: real OS processes, real SIGKILL). Operator guide:
docs/cluster.md.

    PYTHONPATH=src python -m repro_torch.examples.cluster_quickstart
"""
from __future__ import annotations

import time

from repro_torch.cluster import start_cluster
from repro_torch.faults import inject
from repro_torch.gateway import Gateway, Workflow

SLEEP = "repro_torch.cluster.runtimes:sleep_runtime"
ADD = "repro_torch.cluster.runtimes:add_runtime"


def main() -> int:
    # ---------------------------------------------- 1. serve across pids
    # start_cluster spawns the master in-process and N worker processes;
    # the context manager SIGTERMs workers and stops the master on exit.
    # max_batch=2 so the 8 events spread across both workers instead of
    # one worker taking them all in a single micro-batch
    with start_cluster(2, heartbeat_timeout_s=10.0, max_batch=2) as h:
        gw = Gateway(h.backend)
        # runtimes cross the process boundary by *spec* (factory ref +
        # JSON kwargs), never as live callables
        rid = h.backend.register_spec(SLEEP, {"sleep_s": 0.02})
        futs = gw.map(rid, [{"i": i} for i in range(8)])
        pids = [f.result()["pid"] for f in futs]
        print(f"8 events served by {len(set(pids))} worker processes: "
              f"{sorted(set(pids))}")

    # --------------------------------- 2. SIGKILL a worker mid-batch
    # tight heartbeat knobs so crash detection is fast enough to watch
    with start_cluster(2, heartbeat_timeout_s=0.8, keeper_interval_s=0.1,
                       heartbeat_s=0.2) as h:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(SLEEP, {"sleep_s": 0.25})
        inject(h.backend,
               [{"at": 0.1, "op": "kill-worker-process", "worker": 0}])
        futs = gw.map(rid, [{"i": i} for i in range(6)])
        results = [f.result() for f in futs]     # none stranded
        retried = [i for i in gw.metrics.completed if i.attempt > 0]
        st = h.backend.stats()
        print(f"SIGKILL mid-batch: {len(results)}/6 settled, "
              f"{len(retried)} redelivered (attempt+1), "
              f"workers_lost={st['workers_lost']} "
              f"requeued={st['requeued']}")

    # ----------------------------------- 3. a workflow over the cluster
    with start_cluster(2, heartbeat_timeout_s=10.0) as h:
        gw = Gateway(h.backend)
        add1 = h.backend.register_spec(ADD, {"runtime_id": "add1", "add": 1})
        add10 = h.backend.register_spec(ADD, {"runtime_id": "add10",
                                              "add": 10})
        wf = Workflow("chain")
        s1 = wf.step("s1", add1, payload=5)
        s2 = wf.step("s2", add10, after=s1)
        wf.step("s3", add1, after=s2)
        t0 = time.monotonic()
        out = gw.submit_workflow(wf).result()
        print(f"workflow chain ((5+1)+10)+1 = {out} across worker "
              f"processes in {time.monotonic() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
