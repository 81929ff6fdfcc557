"""Quickstart: stand up the paper's testbed, submit a phase workload, read
the paper's metrics back. The port's twin of ``examples/quickstart.py``:
the same testbed, workload, seed and printed lines.

Backend exercised: sim (the discrete-event cluster on the virtual clock,
driven directly: no hardware, deterministic, the same numbers as the
reference's).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

from repro_torch.core.cluster import paper_testbed
from repro_torch.core.workload import PhaseWorkload, paper_phases


def main() -> int:
    # the §V testbed: 2x K600 GPU (2 runtime slots each) + 1 Movidius NCS VPU
    cluster = paper_testbed(with_vpu=True, invocation_timeout_s=60.0)
    # P0=10 trps warm-up / P1=20 trps scaling / P2=20 trps cooldown,
    # compressed 10x (the virtual clock replays it in milliseconds anyway)
    workload = PhaseWorkload(phases=paper_phases(10, 20, 20, scale=0.1),
                             runtime_id="onnx-tinyyolov2",
                             data_ref="data:voc-images")
    metrics = cluster.run_workloads([workload])

    s = metrics.summary()
    print(f"completed invocations : {s['n_completed']}")
    print(f"successful (RSuccess) : {s['r_success']}")
    print(f"max RFast             : {s['rfast_max']:.2f}/s")
    print(f"RLat p50/p99/max      : {s['rlat_p50']:.1f} / {s['rlat_p99']:.1f} / "
          f"{s['rlat_max']:.1f} s")
    print(f"median ELat (GPU)     : {metrics.median_elat('gpu')*1e3:.0f} ms "
          f"(paper: 1675 ms)")
    print(f"median ELat (VPU)     : {metrics.median_elat('vpu')*1e3:.0f} ms "
          f"(paper: 1577 ms)")
    print(f"cold starts           : {s['cold_starts']}")
    for node in cluster.nodes:
        for acc_id, util in node.utilization(cluster.clock.now()).items():
            print(f"utilization {acc_id:18s}: {util*100:.0f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
