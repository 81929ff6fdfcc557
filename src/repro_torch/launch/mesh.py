"""Meshes on ``torch.distributed`` (a port of ``repro.launch.mesh``).

``make_mesh(shape, axes, device=..., backend=...)`` builds a
``DeviceMesh`` over the process group. The backend is an explicit
argument: it defaults to ``"nccl"`` on the card, where each rank has a card
of its own, and to ``"gloo"`` on the CPU; ranks that share one card pass
``"gloo"`` (NCCL refuses two ranks on one device). A process group already
up must run that backend and hold exactly ``prod(shape)`` ranks; with none
up, a one-rank shape needs none (``make_host_mesh``) and a larger one is
brought up from the ``torchrun`` environment (``MASTER_ADDR``, ``RANK``,
``WORLD_SIZE``).

``make_production_mesh`` gives the reference's production meshes, (16, 16)
``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``, over a
*fake* process group of 256 or 512 ranks (``torch.distributed``'s
``"fake"`` backend: this process is rank 0, and a collective moves
nothing): what the dry run (``launch/dryrun.py``) traces a step on, with
fake tensors, on one machine and no card.

``run_world(fn, n, ...)`` runs ``fn(rank, *args)`` in ``n`` spawned
processes joined by a ``FileStore``, each with its own process group, and
returns their results in rank order: what the tests (eight gloo ranks on
the CPU) and ``chip_smoke.py`` (eight ranks sharing the card) run a
sharded step in. Spawned, not forked: CUDA does not survive ``fork``.

A box with several cards launches a sharded step with ``torchrun
--nproc-per-node N`` and ``make_mesh(shape, axes)`` (NCCL, one card a
rank).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.sharding import LogicalMesh, mesh_size


def make_host_mesh() -> LogicalMesh:
    """The one-rank (data, model) mesh: no process group is needed, and
    every sharding call is a no-op on it."""
    return LogicalMesh((1, 1), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = None, backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` on the
    process group (see the module docstring); a one-rank shape with no
    process group up gives ``make_host_mesh``'s kind of mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"one name per mesh dim: shape {shape}, axes {axes}")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n == 1:
            return LogicalMesh(shape, axes)
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(f"mesh {shape} needs {n} ranks and no process "
                             "group is up (launch with torchrun, or "
                             "run_world)")
        dist.init_process_group(backend)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                         f"has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device: DeviceLike = None):
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods x
    256 chips with a leading "pod" axis. The ``DeviceMesh`` runs over a fake
    process group of that many ranks, brought up here (a fake group of
    another size is taken down first; a real group is refused). ``device``
    (default: the card) is the device type of the mesh and of the tensors
    traced on it; the card is never touched."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(f"a {dist.get_backend()!r} process group is up: the "
                             "production mesh runs over a fake one")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def mesh_chips(mesh) -> int:
    return mesh_size(mesh)


# ----------------------------------------------------------------------
# worlds of spawned processes
# ----------------------------------------------------------------------
def _rank_main(fn, rank: int, world: int, store: str, backend: str,
               timeout_s: float, args, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)    # ranks share the host's cores
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:   # reported to the parent, which raises
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def _failed(out: Path) -> bool:
    if not out.exists():
        return False
    try:
        with open(out, "rb") as f:
            return pickle.load(f)[0] != "ok"
    except (EOFError, pickle.UnpicklingError):   # still being written
        return False


def run_world(fn: Callable[..., Any], world: int, *args, run_dir,
              backend: str = "gloo", timeout_s: float = 300.0) -> List[Any]:
    """``[fn(rank, *args) for rank in range(world)]``, each call in a
    process of its own (``spawn``; ``fn`` importable by name; one intra-op
    thread) with a ``backend`` process group of ``world`` ranks over a
    ``FileStore`` in ``run_dir``. Raises with the first
    failing rank's traceback, or when the world has not finished within
    ``timeout_s`` (every process is killed then)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    store = run_dir / "store"
    if store.exists():
        store.unlink()
    ctx = multiprocessing.get_context("spawn")
    outs = [run_dir / f"rank{r}.pkl" for r in range(world)]
    for o in outs:
        if o.exists():
            o.unlink()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, str(store), backend, timeout_s, args, str(outs[r])),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        # a rank that fails leaves the others waiting in a collective: stop
        # the world at the first failure instead of at the deadline
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) or _failed(o)
                   for p, o in zip(procs, outs)):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} ranks not done in "
                                   f"{timeout_s:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    results, errors = [], []
    for r, (p, o) in enumerate(zip(procs, outs)):
        if not o.exists():
            errors.append(f"rank {r} exited with code {p.exitcode} and no "
                          "result")
            continue
        with open(o, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r} failed:\n{value}")
        results.append(value)
    if errors:   # the first rank's own error first; killed ranks after it
        errors.sort(key=lambda e: "no result" in e)
        raise RuntimeError(errors[0])
    return results

