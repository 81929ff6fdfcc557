"""Roofline-derived service-time profiles for the simulated cluster (a
port of ``repro.serve.service_model``).

``--sim`` simulates full-size architectures that do not run here. Their
per-accelerator ELat model: an event costs one prefill plus
``new_tokens`` decode steps. Where the port's dry-run sweep
(``launch/dryrun.py --arch all --shape all --out SWEEP``) has a row for
the arch's ``prefill_32k`` and ``decode_32k`` on the single-pod mesh, each
step is that row's roofline ``step_time`` scaled to the event's batch and
prompt, as the reference reads its own sweep (``results/dryrun_all.json``);
else each step is ``2·N_active`` FLOPs per token over the node's peak at
40% MFU.

The node ``--sim`` simulates is one 8-GPU H100 SXM node, ``SIM_NODE``.
Its peak is the datasheet's dense bf16 rate (``roofline.analysis``). The
reference divides by 256 TPU v5e chips, although its sim node is a
16-chip slice; the port divides by the chips of the node it simulates.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.runtime import SimProfile
from repro_torch.roofline.analysis import PEAK_FLOPS

# one H100 SXM node of 8 cards (80 GiB each), one runtime instance at a
# time; unpriced, as the launcher's other sim pods are (a price is an
# input the caller states, not a measurement)
SIM_NODE = AcceleratorSpec(type="h100-sxm-8", slots=1, mem_bytes=8 * (80 << 30),
                           cost_per_hour=0.0, chips=8)
MFU = 0.4

# the dry run's sweep the profiles read (absent: the analytic branch)
SWEEP = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch_all.json"
_ROWS: Dict[str, Dict] = {}     # the ok rows of each sweep file read, by path


def _sweep_rows() -> Dict:
    path = os.path.abspath(SWEEP)
    if path not in _ROWS:
        rows = {}
        if os.path.exists(path):
            with open(path) as f:
                rows = {(r["arch"], r["shape"], r["mesh"]): r
                        for r in json.load(f) if r.get("status") == "ok"}
        _ROWS[path] = rows
    return _ROWS[path]


def step_time(arch: str, shape: str, mesh: str = "single") -> Optional[float]:
    """The sweep's roofline step time (s) of ``arch`` at ``shape`` on
    ``mesh``, or None where it has no such row."""
    row = _sweep_rows().get((arch, shape, mesh))
    return None if row is None else row["report"]["step_time"]


def roofline_profile(cfg: ModelConfig, *, batch: int = 4,
                     new_tokens: int = 16, prompt_len: int = 512,
                     cold_start_s: float = 20.0, peak: float = PEAK_FLOPS,
                     chips: int = SIM_NODE.chips) -> SimProfile:
    """ELat model: a ``batch`` x ``prompt_len`` prefill plus ``new_tokens``
    decode steps: the sweep's ``prefill_32k`` step scaled by batch and
    prompt length (its quadratic attention term taken as linear) and its
    ``decode_32k`` step scaled by batch, where the sweep has both rows;
    else at ``peak`` FLOP/s per chip over ``chips`` chips at 40% MFU (a
    decode step no shorter than 0.2 ms). The cold start is
    ``cold_start_s`` plus the bf16 weights fetched at 1.25 GB/s from each
    of 16 storage hosts: the reference's stated storage assumptions, not
    measurements."""
    t_prefill = step_time(cfg.name, "prefill_32k")
    t_decode = step_time(cfg.name, "decode_32k")
    if t_prefill is None or t_decode is None:
        cluster = peak * chips * MFU
        t_prefill = 2 * cfg.n_active_params * batch * prompt_len / cluster
        t_decode = max(2 * cfg.n_active_params * batch / cluster, 2e-4)
    else:
        shp = SHAPES["prefill_32k"]
        t_prefill = t_prefill * (batch / shp.global_batch) * (prompt_len / shp.seq_len)
        t_decode = t_decode * (batch / SHAPES["decode_32k"].global_batch)
    elat = t_prefill + new_tokens * t_decode
    load_s = cfg.n_params * 2 / 1.25e9 / 16  # striped over 16 hosts
    return SimProfile(elat_median_s=max(elat, 1e-4), sigma=0.08,
                      cold_start_s=cold_start_s + load_s,
                      result_bytes=batch * new_tokens * 4)
