"""Three-term roofline, with the H100's constants.

    compute    = FLOPs      / peak_FLOP/s
    memory     = HBM bytes  / HBM_bw
    collective = coll_bytes / link_bw

per chip. The port's copy of ``repro.roofline.analysis``: the report and
``model_flops`` are the reference's; the constants are NVIDIA's datasheet
figures for one H100 SXM (dense rates, no sparsity, at the full 700 W
power limit; the same figures ``PERF.md``'s kernel bounds use) in place
of the reference's TPU v5e ones. The report reads them through its
fields ``peak_flops``, ``hbm_bw`` and ``link_bw``, so a caller can put in
another part's constants. ``build_report`` takes the dry run's counts
of one traced step (``roofline/collectives.py``'s ``StepCounter``: FLOPs,
unfused bytes and the collectives, per chip) where the reference's parses
its compiled program's HLO text.
MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12          # HBM3 bytes/s, H100 SXM datasheet
NVLINK_BW = 450e9         # NVLink bytes/s per direction, H100 SXM datasheet


@dataclasses.dataclass
class RooflineReport:
    """All hlo_*/coll_* quantities are PER CHIP; whole-program totals are
    chips x per-chip, so the spec formula term = total / (chips x bw) is
    computed as per_chip / bw."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # per-chip FLOPs
    hlo_bytes: float              # per-chip HBM traffic (unfused)
    coll_bytes: float             # per-chip collective payload
    coll_breakdown: Dict[str, int]
    coll_counts: Dict[str, int]
    model_flops: float            # whole-model useful FLOPs (all chips)
    bytes_per_device: Optional[float] = None   # peak device memory
    # fusion-aware analytic HBM bytes/chip (roofline/analytic.py); hlo_bytes
    # is kept as an upper bound
    model_bytes: Optional[float] = None
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        b = self.model_bytes if self.model_bytes is not None else self.hlo_bytes
        return b / self.hbm_bw

    @property
    def t_memory_unfused(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def effective_coll_bytes(self) -> float:
        """Physical link traffic: a ring all-reduce moves ~2x its payload
        ((2(n-1)/n) vs (n-1)/n for all-gather/reduce-scatter); payload-only
        sums would make reduce-scatter+all-gather look *worse* than the
        all-reduce they replace."""
        if self.coll_breakdown:
            return float(sum(v * (2.0 if k == "all-reduce" else 1.0)
                             for k, v in self.coll_breakdown.items()))
        return self.coll_bytes

    @property
    def t_collective(self) -> float:
        return self.effective_coll_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def total_hlo_flops(self) -> float:
        return self.hlo_flops * self.chips

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs: how much of the compute is useful."""
        return (self.model_flops / self.total_hlo_flops
                if self.hlo_flops else 0.0)

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline estimate."""
        denom = self.step_time * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term is to pure-compute ideal: ideal
        compute time of MODEL_FLOPS vs the roofline step estimate."""
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.step_time if self.step_time else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_ratio=self.useful_ratio, step_time=self.step_time,
                 mfu=self.mfu, total_hlo_flops=self.total_hlo_flops,
                 roofline_fraction=self.roofline_fraction,
                 t_memory_unfused=self.t_memory_unfused)
        return d


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference steps."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * cfg.n_active_params * tokens


def build_report(cfg: ModelConfig, shape: InputShape, mesh_name: str,
                 chips: int, cost: dict,
                 collectives: Tuple[float, Dict[str, int], Dict[str, int]],
                 bytes_per_device: Optional[float] = None) -> RooflineReport:
    """The report of one step: ``cost`` {"flops", "bytes accessed"} per
    chip and ``collectives`` (total bytes, bytes by type, counts by type)
    per chip, as ``StepCounter.collective_bytes()`` gives them."""
    total, per_type, counts = collectives
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=float(total),
        coll_breakdown=dict(per_type), coll_counts=dict(counts),
        model_flops=model_flops(cfg, shape),
        bytes_per_device=bytes_per_device,
    )
