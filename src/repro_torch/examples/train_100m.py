"""Train a ~100M-parameter dense model with the full substrate: synthetic
pipeline -> train step -> checkpoints into the Hardless object store. The
port's twin of ``examples/train_100m.py``: the same model, flags, optimizer
settings, batches and printed lines.

Backend exercised: none — this drives the training substrate directly;
only checkpoints touch the object store (the port's ``ObjectStore``, in
the reference's checkpoint layout, so they restore in either package).
The step is the port's ``train_step`` with ``remat=False``, the update
written in place (the counterpart of the reference's jit). It runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu \\
        --steps 20
(defaults target "a few hundred steps"; use --steps 20 for a quick look)
"""
from __future__ import annotations

import argparse
import time
from typing import List

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.core.storage import ObjectStore
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import batch_to, train_step


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="dense-100m", family=Family.DENSE, n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab=32_768,
        dtype="float32", source="examples/train_100m")


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int,
          ckpt_every: int, store: ObjectStore) -> List[float]:
    """The example's loop from ``params`` (a parameter tree on the device
    the steps run on, updated in place): AdamW at lr 3e-4 with 20 warmup
    steps, the pipeline's batches, a checkpoint every ``ckpt_every``
    steps, the reference's printed lines. Returns each step's loss."""
    dev = next(iter(params["embed"].values())).device
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    state = init_opt_state(ocfg, params)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch))
    losses = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        b = batch_to(pipe.next_batch(), dev)
        params, state, metrics = train_step(cfg, ocfg, params, state, b,
                                            remat=False, inplace=True)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{dt/step:.2f}s/step", flush=True)
        if step % ckpt_every == 0:
            key = C.save(store, cfg.name, step, params)
            print(f"  checkpoint -> {key} ({store.size(key)} B manifest)")
    print(f"done: latest checkpoint step {C.latest_step(store, cfg.name)}, "
          f"tokens seen {pipe.n_tokens_emitted}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = model_100m()
    print(f"model: {cfg.name}, {cfg.n_params/1e6:.0f}M params")
    params = M.init_model_params(cfg, 0, resolve_device(args.device))
    train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_every=args.ckpt_every, store=ObjectStore())


if __name__ == "__main__":
    main()
