"""Training launcher (a port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 20 --batch 4 --seq 64 [--full-config] [--device cpu]

The reference's flags and printed lines: ``--full-config`` trains the
registered widths and depth (on the card), otherwise ``.reduced()``;
``--device`` defaults to the card (``--device cpu`` runs the plain
PyTorch path). Weights from seed 0, AdamW with ``warmup_steps =
max(2, steps // 10)``, batches from ``TokenPipeline``, remat on, the
update in place (``make_train_step``); ``--ckpt-tag`` puts the final
parameters into an ``ObjectStore``. ``setup`` and ``next_batch`` are the
pieces another caller (``chip_smoke.py``) reuses.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.storage import ObjectStore
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def setup(cfg, *, steps: int, batch: int, seq: int, lr: float, device=None):
    """(step_fn, params, opt_state, pipeline) as the launcher builds them."""
    dev = resolve_device(device)
    ocfg = AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                       total_steps=steps)
    step_fn = make_train_step(cfg, ocfg, make_host_mesh(), device=dev)
    params = M.init_model_params(cfg, 0, dev)
    state = init_opt_state(ocfg, params)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch))
    return step_fn, params, state, pipe


def next_batch(cfg, pipe: TokenPipeline, batch: int):
    """The pipeline's next batch, with zero frames / patches where the
    config takes them (the reference launcher's stubs)."""
    b = dict(pipe.next_batch())
    if cfg.n_frames:
        b["frames"] = torch.zeros((batch, cfg.n_frames, cfg.d_model))
    if cfg.n_patches:
        b["patches"] = torch.zeros((batch, cfg.n_patches, cfg.d_model))
    return b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full-size config (needs the card)")
    ap.add_argument("--ckpt-tag", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} params={cfg.n_params/1e6:.1f}M devices={n_dev}")

    step_fn, params, state, pipe = setup(cfg, steps=args.steps,
                                         batch=args.batch, seq=args.seq,
                                         lr=args.lr, device=dev)
    store = ObjectStore()
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        params, state, metrics = step_fn(params, state,
                                         next_batch(cfg, pipe, args.batch))
        if step % 5 == 0 or step == 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({(time.perf_counter()-t0)/step:.2f}s/step)", flush=True)
    if args.ckpt_tag:
        C.save(store, args.ckpt_tag, args.steps, params)
        print(f"checkpointed {args.ckpt_tag}@{args.steps}")
    print("done")


if __name__ == "__main__":
    main()
