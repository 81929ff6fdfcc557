"""Serverless front door: model serving as Hardless runtimes (a port of
``repro.serve.api``).

``make_serve_runtime`` wraps a ServingEngine factory as a RuntimeDef whose
events are batches of generation requests. ``setup`` is the cold start:
random weights from ``seed`` materialized on the card and the engine's
cache allocated (paged, or dense with ``page_size=0``; the kernels build
at their first launch). ``fn`` serves
one event; ``batch_fn`` merges several events' prompts into one shared
continuous-batching stream.

``setup`` builds the engine on the calling thread's current card (a
gateway worker enters its own before the cold start); the engine then
serves on that card, whichever thread calls it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.runtime import HOST_ACC, RuntimeDef, SimProfile
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServingEngine


def make_serve_runtime(cfg: ModelConfig, *,
                       acc_types: Optional[Dict[str, SimProfile]] = None,
                       max_slots: int = 4, max_len: int = 128,
                       max_batch: int = 4,
                       page_size: int = 16, prefill_chunk: int = 0,
                       kv_pool_tokens: Optional[int] = None,
                       greedy: bool = True,
                       seed: int = 0,
                       device: DeviceLike = None) -> RuntimeDef:
    """RuntimeDef serving ``cfg`` on ``device`` (default: the card; raises
    without one unless ``device="cpu"``). Arguments as in
    ``repro.serve.api.make_serve_runtime``. An encoder-decoder raises
    here, as ``ServingEngine`` does, rather than at the cold start."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the serving engine does not serve encoder-decoders")
    dev = resolve_device(device)
    if acc_types is None:
        acc_types = {HOST_ACC: SimProfile(elat_median_s=0.4, cold_start_s=2.0)}

    def setup():
        where = dev
        if where.type == "cuda" and where.index is None:
            where = torch.device("cuda", torch.cuda.current_device())
        params = M.init_model_params(cfg, seed, where)
        engine = ServingEngine(cfg, params, max_slots=max_slots,
                               max_len=max_len, page_size=page_size,
                               prefill_chunk=prefill_chunk,
                               kv_pool_tokens=kv_pool_tokens, greedy=greedy,
                               sample_seed=seed, device=where)
        if where.type == "cuda":
            # the weights are drawn in float32 and then cast: give those
            # drafts back to the driver, where other processes on the card
            # (cluster workers) can allocate them
            torch.cuda.empty_cache()
        return engine

    def _prompts(data: Any) -> List[List[int]]:
        # {"prompts": [...]} is the client form; {"outputs": [...]} a chained
        # upstream serve step's result; a list is a workflow fan-in gather
        if isinstance(data, list):
            return [p for d in data for p in _prompts(d)]
        return data["prompts"] if "prompts" in data else data["outputs"]

    def _requests(data: Any, max_new: int, base_id: int,
                  attempt: int = 0) -> List[Request]:
        prompts = [list(p) or [0] for p in _prompts(data)]
        return [Request(prompt=p, max_new_tokens=max_new,
                        req_id=base_id + i, attempt=attempt)
                for i, p in enumerate(prompts)]

    def fn(data: Any, config: Dict[str, Any]):
        engine: Optional[ServingEngine] = config.get("handle")
        if engine is None:                      # caller skipped setup
            engine = setup()
        max_new = int(config.get("max_new_tokens", 8))
        done = engine.generate(_requests(
            data, max_new, base_id=0, attempt=int(config.get("attempt", 0))))
        return {"outputs": [r.output for r in done],
                "n_decode_steps": engine.n_decode_steps}

    def batch_fn(datas: List[Any], config: Dict[str, Any]):
        engine: Optional[ServingEngine] = config.get("handle")
        if engine is None:
            engine = setup()
        max_new = int(config.get("max_new_tokens", 8))
        attempts = list(config.get("attempts") or [])
        attempts += [0] * (len(datas) - len(attempts))
        groups, base = [], 0
        for data, attempt in zip(datas, attempts):
            reqs = _requests(data, max_new, base_id=base, attempt=attempt)
            base += len(reqs)
            groups.append(reqs)
        done_groups = engine.generate_many(groups)
        return [{"outputs": [r.output for r in g],
                 "n_decode_steps": engine.n_decode_steps}
                for g in done_groups]

    return RuntimeDef(runtime_id=f"serve-{cfg.name}", profiles=acc_types,
                      fn=fn, setup=setup,
                      batch_fn=batch_fn, max_batch=max_batch,
                      artifact_bytes=64 << 20)
