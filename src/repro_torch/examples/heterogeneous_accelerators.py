"""The paper's §V experiment: the same workload with and without the VPU.
The port's twin of ``examples/heterogeneous_accelerators.py``: the same
testbeds, workload, seed and printed lines.

Reproduces claims C1 (extra accelerator raises max RFast without user
intervention), C2 (per-accelerator ELat medians) and C3 (higher max RLat
with heterogeneity, as deep-backlog events complete instead of timing out).

Backend exercised: sim (paper_testbed on the virtual clock; calibrated
service times, no hardware).

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_accelerators
"""
from __future__ import annotations

from repro_torch.core.cluster import paper_testbed
from repro_torch.core.workload import PhaseWorkload, paper_phases


def run(with_vpu: bool):
    cl = paper_testbed(with_vpu=with_vpu, invocation_timeout_s=60.0)
    wl = PhaseWorkload(phases=paper_phases(10, 20, 20, scale=1.0),
                       runtime_id="onnx-tinyyolov2",
                       data_ref="data:voc-images")
    return cl.run_workloads([wl])


def main() -> int:
    m_gpu = run(with_vpu=False)
    m_all = run(with_vpu=True)

    print(f"{'':28s}{'dual GPU (Fig 3)':>18s}{'GPU+VPU (Fig 4)':>18s}")
    for label, fn in [
        ("max RFast (/s)", lambda m: f"{m.rfast_max():.2f}"),
        ("RSuccess", lambda m: str(m.r_success())),
        ("max RLat (s)", lambda m: f"{m.rlats()[-1]:.1f}"),
        ("median ELat GPU (ms)",
         lambda m: f"{(m.median_elat('gpu') or 0)*1e3:.0f}"),
        ("median ELat VPU (ms)",
         lambda m: f"{(m.median_elat('vpu') or 0)*1e3:.0f}"),
    ]:
        print(f"{label:28s}{fn(m_gpu):>18s}{fn(m_all):>18s}")

    delta = m_all.rfast_max() - m_gpu.rfast_max()
    print(f"\nΔ max RFast = +{delta:.2f}/s from adding the NCS "
          f"(paper: ~+0.75 per-10s-window units; VPU capacity 1/1.577s = 0.63/s)")
    assert m_all.rfast_max() > m_gpu.rfast_max()
    print("C1 reproduced: the platform exploited the extra accelerator with "
          "zero user intervention.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
