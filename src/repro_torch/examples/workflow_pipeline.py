"""Cross-accelerator workflow: tiny-YOLO vision fan-out + whisper audio
fan-in to one LLM captioner, three runtimes composed into one ``Workflow``
submission (the paper's multi-accelerator application: VPU image
recognition feeding a GPU language stage). The port's twin of
``examples/workflow_pipeline.py``: the same runtime ids, profiles, DAG and
printed lines.

Every intermediate result flows step to step through the object store;
the client only submits the DAG and reads the final caption.

``--backend sim`` (the default) places the steps on a virtual-time VPU +
GPU testbed while running the real forwards; ``--backend engine`` runs the
same workflow concurrently on the gateway's worker threads. Both run the
models on the card unless ``--device cpu`` is given. Without ``--reduced``
the models run as registered: tiny-YOLOv2 on 416x416 images, whisper-tiny
(4 + 4 layers, d 384, 1500 frames; bf16) and granite-3-2b (40 layers;
bf16) as the captioner. ``--reduced`` takes the reference example's sizes:
``.reduced()`` configs and 64x64 images.

    PYTHONPATH=src python -m repro_torch.examples.workflow_pipeline \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.examples.workflow_pipeline \\
        --backend engine --images 4
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import GPU_K600, VPU_NCS, Cluster
from repro_torch.core.runtime import HOST_ACC, RuntimeDef, SimProfile
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.gateway import (EngineBackend, Gateway, SimBackend, Workflow,
                                 WorkflowStepError)
from repro_torch.models import model as M
from repro_torch.models.yolo import init_yolo_params, yolo_forward
from repro_torch.serve.engine import Request, ServingEngine

HOST = HOST_ACC
CAPTION_SLOTS, CAPTION_LEN, CAPTION_NEW = 2, 48, 8


def image_side(reduced: bool) -> int:
    """The images' side: the reference example's 64, or tiny-YOLOv2's
    published 416."""
    return 64 if reduced else 416


def audio_config(reduced: bool) -> ModelConfig:
    cfg = get_config("whisper-tiny")
    return cfg.reduced() if reduced else cfg


def caption_config(reduced: bool) -> ModelConfig:
    cfg = get_config("granite-3-2b")
    return cfg.reduced() if reduced else cfg


def _here(device: torch.device) -> torch.device:
    """``device``, with a card's index filled in from the calling thread
    (a gateway worker enters its own card before the cold start)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def vision_runtime(device: DeviceLike = None, params=None) -> RuntimeDef:
    """tiny-YOLO image recognition, the paper's VPU workload. ``params``
    (a YOLO tree on ``device``) replaces the weights drawn from seed 0."""
    dev = resolve_device(device)

    def setup():
        return params if params is not None else \
            init_yolo_params(0, device=_here(dev))

    def fn(data, config):
        p = config.get("handle") or setup()
        image = torch.as_tensor(np.asarray(data["image"]),
                                device=p["head"].device)
        logits = yolo_forward(p, image)                     # (1, h, w, 125)
        cells = logits.reshape(-1, logits.shape[-1])
        return {"detections": [int(i) for i in cells.argmax(-1)[:4].tolist()]}

    return RuntimeDef(
        runtime_id="vision-tinyyolo",
        profiles={VPU_NCS.type: SimProfile(elat_median_s=1.577, sigma=0.04,
                                           cold_start_s=5.0),
                  HOST: SimProfile(elat_median_s=0.05)},
        fn=fn, setup=setup, artifact_bytes=60 << 20)


def audio_runtime(device: DeviceLike = None, reduced: bool = False,
                  params=None) -> RuntimeDef:
    """whisper-tiny transcription (stub mel frontend: the frames are drawn
    from the event's ``audio_seed``): one ``train``-mode forward of 8
    tokens over the frames, greedy per position. ``params`` replaces the
    weights drawn from seed 1."""
    dev = resolve_device(device)
    cfg = audio_config(reduced)

    def setup():
        return params if params is not None else \
            M.init_model_params(cfg, 1, _here(dev))

    def fn(data, config):
        p = config.get("handle") or setup()
        where = p["embed"]["tok"].device
        rng = np.random.default_rng(data["audio_seed"])
        frames = rng.standard_normal(
            (1, cfg.n_frames, cfg.d_model)).astype("float32")
        batch = {"tokens": torch.zeros((1, 8), dtype=torch.long, device=where),
                 "frames": torch.from_numpy(frames).to(where)}
        logits, _ = M.forward(cfg, p, batch, mode="train")
        return {"transcript": [int(t) for t in logits[0].argmax(-1).tolist()]}

    return RuntimeDef(
        runtime_id="audio-whisper-tiny",
        profiles={GPU_K600.type: SimProfile(elat_median_s=0.9,
                                            cold_start_s=3.0),
                  HOST: SimProfile(elat_median_s=0.2)},
        fn=fn, setup=setup, artifact_bytes=39 << 20)


def caption_runtime(device: DeviceLike = None, reduced: bool = False,
                    params=None) -> RuntimeDef:
    """LLM captioner: fuses the gathered vision and audio outputs into a
    prompt and generates 8 tokens through a warm paged ``ServingEngine``
    (2 slots of 48 tokens; weights and cache on a cold start). ``params``
    replaces the weights drawn from seed 2."""
    dev = resolve_device(device)
    cfg = caption_config(reduced)

    def setup():
        where = _here(dev)
        p = params if params is not None else M.init_model_params(cfg, 2, where)
        return ServingEngine(cfg, p, max_slots=CAPTION_SLOTS,
                             max_len=CAPTION_LEN, device=where)

    def fn(data, config):
        engine = config.get("handle") or setup()
        # data = the gather barrier's list: vision outputs, then audio
        toks = [t for d in data
                for t in d.get("detections", []) + d.get("transcript", [])]
        prompt = [1] + [t % (cfg.vocab - 2) + 1 for t in toks][:12]
        done = engine.generate([Request(prompt=prompt,
                                        max_new_tokens=CAPTION_NEW)])
        return {"caption": done[0].output}

    return RuntimeDef(
        runtime_id="caption-lm",
        profiles={GPU_K600.type: SimProfile(elat_median_s=1.675,
                                            cold_start_s=3.0),
                  HOST: SimProfile(elat_median_s=0.4)},
        fn=fn, setup=setup, artifact_bytes=64 << 20)


def build_gateway(backend: str, device: DeviceLike = None,
                  reduced: bool = False) -> Gateway:
    """The three runtimes behind one gateway: on ``sim`` a VPU pod (one
    NCS) and a GPU pod (two K600s) in virtual time, on ``engine`` the
    gateway's worker threads on ``device``."""
    if backend == "sim":
        cluster = Cluster(scheduler="warm", seed=0)
        cluster.add_node("vpu-pod", [VPU_NCS])
        cluster.add_node("gpu-pod", [GPU_K600, GPU_K600])
        gw = Gateway(SimBackend(cluster))
    else:
        gw = Gateway(EngineBackend(device=device))
    for rdef in (vision_runtime(device), audio_runtime(device, reduced),
                 caption_runtime(device, reduced)):
        gw.register(rdef)
    return gw


def make_images(n: int, side: int, seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` image payloads (1, side, side, 3) float32 from ``seed``."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((1, side, side, 3)).astype(
        "float32")} for _ in range(n)]


def make_workflow(images: List[Dict[str, Any]],
                  name: str = "caption-pipeline") -> Workflow:
    """See every image (fan-out), hear the audio, caption both (fan-in)."""
    wf = Workflow(name)
    sees = wf.fan_out("see", "vision-tinyyolo", payloads=images)
    hear = wf.step("hear", "audio-whisper-tiny", payload={"audio_seed": 7})
    wf.step("caption", "caption-lm", after=sees + [hear], retries=1)
    return wf


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="sim", choices=["sim", "engine"])
    ap.add_argument("--images", type=int, default=2,
                    help="vision fan-out width")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's sizes: .reduced() configs "
                         "and 64x64 images")
    args = ap.parse_args(argv)
    gw = build_gateway(args.backend, args.device, args.reduced)
    wf = make_workflow(make_images(args.images, image_side(args.reduced)))
    fut = gw.submit_workflow(wf)
    try:
        try:
            out = fut.result()
            ok = True
        except WorkflowStepError as e:      # the failing step, by name
            print(f"workflow failed: {e}")
            out, ok = None, False

        print(f"[{gw.backend.name}] workflow {fut.name!r}: {fut.statuses()}")
        for name in list(wf.steps):
            step_fut = fut.step_future(name)
            if step_fut is None:            # cancelled before submission
                print(f"  step {name:10s} (never submitted)")
                continue
            inv = step_fut.invocation
            print(f"  step {name:10s} acc={inv.accelerator:28s} "
                  f"cold={int(inv.cold_start)} ELat={inv.elat:.3f}s")
        if ok:
            tok = ByteTokenizer()
            print(f"caption tokens: {out['caption']}")
            # untrained weights: ids above byte range are dropped before decode
            printable = [t for t in out["caption"] if t < tok.vocab_size]
            print(f"caption text  : {tok.decode(printable)!r} (untrained model)")
        print("pipeline", "COMPLETED" if ok else "FAILED")
    finally:
        if args.backend == "engine":
            gw.backend.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
