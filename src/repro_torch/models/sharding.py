"""Logical-axis -> mesh-axis sharding rules on a ``torch.distributed``
``DeviceMesh`` (a port of ``repro.models.sharding``).

The rules are the reference's, as pure Python: ``TRAIN_RULES`` /
``SERVE_RULES`` map logical axis names to one mesh axis or a tuple,
``rules_for`` makes the FSDP, no-TP and all-to-all variants, and
``spec_for`` builds the counterpart of a ``PartitionSpec`` (a tuple of
mesh-axis names, tuples or None, trailing Nones stripped), dropping a mesh
axis that does not divide a dim or that an earlier dim already used.

The design, the counterpart of GSPMD plus ``shard_map``:

* **Parameters are ``DTensor``s** on a ``DeviceMesh`` with named dims
  (``"data"``, ``"model"``, and ``"pod"`` where given). A dim whose spec
  picks mesh axis ``a`` is ``Shard(dim)`` on mesh dim ``a``; every other
  mesh dim is ``Replicate()`` (``placements``). ``distribute_params`` places
  a tree that every rank holds whole; ``train_loop.init_sharded`` draws one
  leaf at a time and keeps only the local shard.
* **``constrain`` is a ``redistribute``** to the placements of
  ``spec_for(x.shape, axes, rules, mesh)``. It is a no-op outside an
  ``axis_rules`` context and on a one-rank mesh, so the one-card path runs
  exactly as without this module.
* **Every kernel call runs on plain local tensors, under
  ``torch.distributed.tensor.experimental.local_map``**, the counterpart of
  ``shard_map``: the model (``model.py``) runs the embedding, each layer and
  the unembedding with its cross-entropy as one ``local_map`` body each.
  ``local_map`` redistributes the stored parameters to the placements the
  body computes with (``Plan``: FSDP shards all-gathered over the data axes,
  column / row slices over ``model`` where the heads, ``d_ff`` or the vocab
  divide, else replicated) and gives each gradient back with the placements
  it has (``Partial`` over the axes that shard the batch), which DTensor's
  backward reduce-scatters into the stored shards. The hand-written kernels
  (ctypes on raw pointers) and the port's autograd Functions therefore only
  ever see local tensors; ``kernels/build.refuse_dtensor`` makes every
  wrapper raise ``TypeError`` on a DTensor.
* **Collectives inside a body carry gradients** (small autograd Functions
  over ``torch.distributed`` on the mesh dim's group, in float32 where the
  reference crosses its ``shard_map`` boundary in float32): ``copy_to`` and
  ``reduce_from`` are Megatron's conjugate pair (identity forward and a sum
  over ``model`` backward, before a column-parallel product; a sum forward,
  identity backward, after a row-parallel one: the reference's ``psum``),
  ``pmean`` the reference's ``pmean``, ``all_to_all`` and ``all_gather``
  theirs, and ``split`` (this rank's block, the gradient all-gathered)
  gives back what ``all_gather`` gathered: under the no_tp rules a MoE
  layer, the embedding and the unembedding gather a data shard's rows over
  ``model`` and keep their own rows of the result. A replicated value inside a body carries its whole gradient on
  every rank, so a body's loss is the same scalar on every rank and each
  rank differentiates it once.

Gathers go through c10d, on every backend: ``to_placements`` (the
stored parameters to a body's placements) and ``gather_full`` gather a
shard with ``all_gather_into_tensor`` under an autograd Function of their
own, whose backward is DTensor's redistribute of the gradient (a
reduce-scatter or an all-reduce); a mesh dim that moves from one sharded
tensor dim to another (an FSDP-stored expert leaf to its ``model`` slice
under the no_tp rules) moves by one c10d all-to-all of bytes
(``_Reshard``), so no rank holds the whole leaf. DTensor's own Shard -> Replicate runs
the functional all-gather (``_c10d_functional.all_gather_into_tensor``),
which ends the process with SIGSEGV on CUDA tensors under gloo in the
card's PyTorch (2.11), where c10d's all-gather, all-reduce, reduce-scatter
and all-to-all, and the functional all-reduce and reduce-scatter, run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.param import iter_leaves, map_tree

AxisRule = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[AxisRule, ...]   # the counterpart of a PartitionSpec

# ----------------------------------------------------------------------
# The rules (the reference's, unchanged)
# ----------------------------------------------------------------------
# "fsdp" axes shard weights along the data (and pod) axis, ZeRO-3 style;
# "batch" covers activations and inputs
TRAIN_RULES: Dict[str, AxisRule] = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),   # FSDP weight sharding
    "heads": "model",            # fused H*hd dims
    "kv": "model",
    "ff": "model",
    "experts": None,             # replicated; the a2a layout shards them
    "vocab": "model",
    "layers": None,
    "seq": None,
    "kv_seq": "model",           # KV-cache sequence dim (decode)
    "state": None,               # recurrent state feature dims
}

SERVE_RULES = dict(TRAIN_RULES)


def rules_for(kind: str, fsdp: bool = True, no_tp: bool = False,
              moe_a2a: bool = False) -> Dict[str, AxisRule]:
    rules = dict(TRAIN_RULES)
    if kind != "train" and not fsdp:
        rules["embed"] = None
    if no_tp:
        # pure FSDP: the batch shards over every axis, weights ZeRO-3 over
        # all axes, no Megatron activation all-reduces; vocab TP is kept
        rules["batch"] = ("pod", "data", "model")
        rules["embed"] = ("pod", "data", "model")
        rules["heads"] = None
        rules["kv"] = None
        rules["ff"] = None
        rules["state"] = None
    if moe_a2a:
        rules["_moe_a2a"] = True     # read by blocks.moe_ffn
        rules["experts"] = "model"   # one expert per model-axis rank
    return rules


# FSDP for serving where model-axis sharding alone leaves more than ~6 GB a
# chip (the reference's ``launch/dryrun.py:55`` ``FSDP_SERVE_BYTES``)
FSDP_SERVE_BYTES = 6 << 30


def serve_fsdp(cfg) -> bool:
    """Whether serving shards the weights' ``embed`` dims over the data axes
    (``rules_for("serve", fsdp=...)``): where bf16 weights over 16 chips
    exceed ``FSDP_SERVE_BYTES`` (the reference's ``launch/dryrun.py:96``
    ``serve_fsdp``; a caller who wants a fixed choice passes ``fsdp=`` to
    ``rules_for``)."""
    return cfg.n_params * 2 / 16 > FSDP_SERVE_BYTES


# ----------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A mesh's shape and axis names with no devices and no process group:
    what ``spec_for`` reads (``launch.mesh.make_host_mesh`` returns the
    one-rank one)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``LogicalMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Dict[str, AxisRule], mesh) -> PSpec:
    """A spec tuple, dropping mesh axes that do not divide dims or that are
    already used by an earlier dim (the reference's, for a tuple in place
    of its ``PartitionSpec``)."""
    sizes = mesh_axis_sizes(mesh)
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        if logical is None or logical not in rules or rules[logical] is None:
            out.append(None)
            continue
        rule = rules[logical]
        cand = (rule,) if isinstance(rule, str) else tuple(rule)
        picked = []
        rem = dim
        for ax in cand:
            if ax in used or ax not in sizes:
                continue
            if rem % sizes[ax] == 0:
                picked.append(ax)
                rem //= sizes[ax]
        if picked:
            used.update(picked)
            out.append(tuple(picked) if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(entry: AxisRule) -> Tuple[str, ...]:
    """The mesh axes of one entry of a spec tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PSpec, mesh) -> list:
    """DTensor placements, one per mesh dim, of a spec tuple: ``Shard(i)``
    on each mesh dim that dim ``i`` picked, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    where = {ax: i for i, entry in enumerate(spec) for ax in spec_axes(entry)}
    return [Shard(where[name]) if name in where else Replicate()
            for name in mesh.mesh_dim_names]


# ----------------------------------------------------------------------
# The trace-time context: model code calls constrain(x, *axes) and the
# caller activates (mesh, rules) around the step; a no-op outside one
# ----------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, AxisRule]):
    prev = getattr(_CTX, "value", None)
    _CTX.value = (mesh, rules)
    try:
        yield
    finally:
        _CTX.value = prev


def current_rules():
    return getattr(_CTX, "value", None)


def active_mesh():
    """(mesh, rules) of the context when its mesh has more than one rank,
    else None: the one-rank path runs as with no context at all."""
    ctx = current_rules()
    if ctx is None or mesh_size(ctx[0]) == 1:
        return None
    return ctx


def _redistribute(x, axes, rules, mesh):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("constrain under a mesh of more than one rank takes a "
                        f"DTensor, got {type(x).__name__}")
    return x.redistribute(mesh, placements(spec_for(x.shape, axes, rules, mesh),
                                           mesh))


def constrain(x, *axes: Optional[str]):
    """``redistribute`` by logical axis names (context-driven); a no-op
    outside ``axis_rules`` and on a one-rank mesh."""
    ctx = active_mesh()
    if ctx is None:
        return x
    mesh, rules = ctx
    return _redistribute(x, axes, rules, mesh)


def param_pspecs(specs, rules: Dict[str, AxisRule], mesh):
    return map_tree(lambda _, s: spec_for(s.shape, s.axes, rules, mesh), specs)


def param_shardings(specs, rules: Dict[str, AxisRule], mesh):
    """Tree of placement lists matching a param spec tree."""
    return map_tree(lambda _, s: placements(spec_for(s.shape, s.axes, rules,
                                                     mesh), mesh), specs)


def shard_activation(x, axes: Sequence[Optional[str]],
                     rules: Dict[str, AxisRule], mesh):
    """``redistribute`` by logical axes; a no-op outside a mesh or on a
    one-rank mesh."""
    if mesh is None or mesh_size(mesh) == 1:
        return x
    return _redistribute(x, axes, rules, mesh)


def batch_sharding(shape: Sequence[int], mesh,
                   rules: Dict[str, AxisRule]) -> list:
    """Placements of an input batch tensor: dim 0 = batch, rest replicated."""
    axes = ["batch"] + [None] * (len(shape) - 1)
    return placements(spec_for(shape, axes, rules, mesh), mesh)


def shard_tensor(full: torch.Tensor, mesh, placements_):
    """This rank's shard of a tensor every rank holds whole, as a DTensor
    owning a contiguous copy (no communication; the whole tensor can be
    freed, and the optimizer views shards flat)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = distribute_tensor(full, mesh, placements_, src_data_rank=None)
    local = t.to_local().clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params, specs, rules: Dict[str, AxisRule], mesh):
    """A tree every rank holds whole -> the same tree of DTensors in their
    placements, each rank keeping its shards (no communication)."""
    leaves = dict(iter_leaves(specs))
    return map_tree(lambda path, t: shard_tensor(
        t, mesh, placements(spec_for(t.shape, leaves[path].axes, rules, mesh),
                            mesh)), params)


# ----------------------------------------------------------------------
# Decode caches under a mesh: each leaf placed by ``spec_for`` over its
# ``cache_specs`` axes, as the reference's ``build_decode`` places them
# (attention K/V ("batch", "kv_seq", "kv", None): the sequence over
# ``model`` where it divides, else the KV heads, else whole; RG-LRU state
# over the batch's axes)
# ----------------------------------------------------------------------
def _cache_spec_tree(cfg, cache=None, B: int = 1, L: int = 1):
    """{path: Spec} of ``model.cache_specs(cfg, B, L)``; with ``cache``,
    each spec takes that leaf's shape (the axes do not depend on sizes)."""
    from repro_torch.models.model import cache_specs
    specs = dict(iter_leaves(cache_specs(cfg, B, L)))
    if cache is None:
        return specs
    return {path: dataclasses.replace(specs[path], shape=tuple(t.shape))
            for path, t in iter_leaves(cache)}


def cache_pspecs(cfg, B: int, L: int, rules: Dict[str, AxisRule], mesh):
    """{path: spec tuple} of the dense decode cache of B sequences of
    ``L`` slots (``model.cache_specs``), the reference's ``spec_for`` of
    each leaf."""
    return {path: spec_for(s.shape, s.axes, rules, mesh)
            for path, s in _cache_spec_tree(cfg, B=B, L=L).items()}


def cache_placements(cfg, B: int, L: int, rules: Dict[str, AxisRule], mesh):
    """{path: DTensor placements} of each leaf of that cache."""
    return {path: placements(spec, mesh)
            for path, spec in cache_pspecs(cfg, B, L, rules, mesh).items()}


def distribute_cache(cache, cfg, rules: Dict[str, AxisRule], mesh):
    """A dense decode cache every rank holds whole -> the same tree of
    DTensors in the reference's placements, each rank keeping its shards
    (no communication); DTensor leaves as they are."""
    from torch.distributed.tensor import DTensor
    specs = _cache_spec_tree(cfg, cache)
    return map_tree(lambda path, t: t if isinstance(t, DTensor) else
                    shard_tensor(t, mesh, placements(spec_for(
                        t.shape, specs[path].axes, rules, mesh), mesh)), cache)


def init_sharded_cache(cfg, B: int, L: int, mesh,
                       rules: Dict[str, AxisRule], device=None,
                       kv_dtype: Optional[str] = None):
    """The zero decode cache of ``model.init_cache(cfg, B, L, kv_dtype=)``
    as DTensors, each rank allocating only its shards (an int8 cache's
    attention K/V in int8)."""
    from repro_torch.models.model import cache_specs
    return sharded_leaves(cache_specs(cfg, B, L, kv_dtype), rules, mesh, cfg.dtype,
                          device, torch.zeros)


def placed(shape: Sequence[int], dtype: torch.dtype, placements_, mesh, device,
           fill=torch.empty):
    """A DTensor of ``shape`` in ``placements_`` whose local shard this rank
    makes alone with ``fill`` (``torch.zeros``, or ``torch.empty``: inside a
    fake-tensor mode a shard with a shape and no storage)."""
    from torch.distributed.tensor import DTensor
    t = fill(local_shape(shape, mesh, placements_), dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements_, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_strides(shape))


def sharded_leaves(specs, rules: Dict[str, AxisRule], mesh, dtype: str,
                   device=None, fill=torch.empty):
    """A spec tree as DTensors in the placements ``spec_for`` gives each
    leaf, each rank making only its shards with ``fill`` (leaves in the
    spec's dtype, else ``dtype``)."""
    from repro_torch.device import resolve_device, torch_dtype
    dev = resolve_device(device)
    return map_tree(lambda _, s: placed(
        s.shape, torch_dtype(s.dtype or dtype),
        placements(spec_for(s.shape, s.axes, rules, mesh), mesh), mesh, dev, fill),
        specs)


def local_shape(shape: Sequence[int], mesh, placements_) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` in ``placements_``
    (DTensor's own reckoning), computed outside any fake-tensor mode: a
    fake mode (the dry run's) would trace DTensor's arithmetic on it and
    refuse its data-dependent steps."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return tuple(compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                           placements_)[0])


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


class _Gather(torch.autograd.Function):
    """A DTensor gathered over the mesh dims ``dims`` (Shard -> Replicate)
    with c10d's all-gather; the gradient goes back to the input's
    placements through DTensor's redistribute."""

    @staticmethod
    def forward(ctx, x, dims):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        ctx.src = (mesh, tuple(x.placements))
        local, pls = x._local_tensor, list(x.placements)
        for i in sorted(dims, reverse=True):   # inner mesh dims first
            d = pls[i].dim
            parts = _all_gather0(local, mesh.get_group(i))
            local = torch.cat(parts.unbind(0), dim=d)
            pls[i] = Replicate()
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        mesh, pls = ctx.src
        return g.redistribute(mesh, pls), None


def _move_shard(local: torch.Tensor, a: int, b: int, group) -> torch.Tensor:
    """A local shard split along dim ``a`` over ``group`` re-split along dim
    ``b``: block j of dim ``b`` goes to rank j, and the blocks received are
    concatenated along ``a`` in rank order (one c10d all-to-all of the
    blocks' bytes: no value is converted, an int8 or bf16 leaf moves at its
    own width)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    send = torch.stack(local.chunk(n, dim=b))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(torch.uint8), send.view(torch.uint8), group=group)
    return torch.cat(recv.unbind(0), dim=a)


class _Reshard(torch.autograd.Function):
    """A DTensor whose mesh dim ``i`` shards tensor dim ``a`` (the
    innermost split of it) re-sharded along tensor dim ``b`` by one c10d
    all-to-all over that mesh dim; the gradient moves back the same way.
    What the no_tp rules' FSDP-stored expert leaves (``embed`` over every
    axis) need to reach their compute slices over ``model`` without any
    rank holding a whole leaf."""

    @staticmethod
    def forward(ctx, x, i, b):
        from torch.distributed.tensor import DTensor, Shard
        mesh, pls = x.device_mesh, list(x.placements)
        a = pls[i].dim
        ctx.move = (mesh, i, a, b)
        local = _move_shard(x._local_tensor, a, b, mesh.get_group(i))
        pls[i] = Shard(b)
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Shard
        mesh, i, a, b = ctx.move
        pls = list(g.placements)
        local = _move_shard(g._local_tensor, b, a, mesh.get_group(i))
        pls[i] = Shard(a)
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=g.shape, stride=g.stride()), None, None


def _reshardable(pls, i: int, b) -> bool:
    """Whether mesh dim ``i`` can move from its Shard to ``b`` with
    ``_Reshard``: another tensor dim, the innermost split of its own, and
    no mesh dim already splitting ``b``'s."""
    a = pls[i]
    return (a.is_shard() and b.is_shard() and a.dim != b.dim
            and not any(p.is_shard(a.dim) for p in pls[i + 1:])
            and not any(p.is_shard(b.dim) for p in pls))


def to_placements(x, target):
    """DTensor ``x`` in placements ``target``: a mesh dim that moves from
    one sharded tensor dim to another by an all-to-all (``_Reshard``),
    then gathers through c10d (``_Gather``), then DTensor's redistribute
    for what needs no gather (a local chunk), so no functional all-gather
    runs."""
    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    for i, b in enumerate(target):
        if _reshardable(list(x.placements), i, b):
            x = _Reshard.apply(x, i, b.dim)
    dims = tuple(i for i, (a, b) in enumerate(zip(x.placements, target))
                 if a.is_shard() and not (b.is_shard() and b.dim == a.dim))
    if dims:
        x = _Gather.apply(x, dims)
    return x if tuple(x.placements) == target else \
        x.redistribute(x.device_mesh, target)


def gather_full(x) -> torch.Tensor:
    """A DTensor's whole value on every rank (a plain tensor; through
    c10d, see ``to_placements``)."""
    from torch.distributed.tensor import Replicate
    return to_placements(x, [Replicate()] * x.device_mesh.ndim).to_local()


def full_tree(tree):
    """Every DTensor leaf gathered whole (plain tensors as they are)."""
    from torch.distributed.tensor import DTensor
    return map_tree(lambda _, t: gather_full(t) if isinstance(t, DTensor)
                    else t, tree)



# ----------------------------------------------------------------------
# How a step computes under a mesh
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Plan:
    """The compute layout of one step: ``batch``, the mesh axes that shard
    the batch (``spec_for`` of the batch dim); ``model``, the axis that
    slices heads, ``d_ff`` and the vocab, where it has more than one rank
    and does not carry the batch (else None: weights compute replicated).
    Placements are per mesh dim, as DTensor's."""

    mesh: object
    rules: Dict[str, AxisRule]
    batch: Tuple[str, ...]
    model: Optional[str]

    def activation(self) -> list:
        """An activation's placements: dim 0 sharded over ``batch``."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(0) if a in self.batch else Replicate()
                for a in self.mesh.mesh_dim_names]

    def replicated(self) -> list:
        from torch.distributed.tensor import Replicate
        return [Replicate() for _ in self.mesh.mesh_dim_names]

    def compute(self, tp_dim: Optional[int], model: Optional[str] = None) -> list:
        """A weight's compute placements: dim ``tp_dim`` sliced over
        ``model`` (default ``self.model``; None: replicated), replicated
        over every other axis."""
        from torch.distributed.tensor import Replicate, Shard
        model = model or self.model
        return [Shard(tp_dim) if a == model and tp_dim is not None
                else Replicate() for a in self.mesh.mesh_dim_names]

    def grad(self, tp_dim: Optional[int], partial_on_model: bool = False,
             model: Optional[str] = None,
             batch: Optional[Tuple[str, ...]] = None) -> list:
        """The placements of a weight's gradient as a body leaves it: a
        partial sum over the axes whose ranks see different rows (default
        ``self.batch``; and over ``model`` where ranks use a replicated
        weight on different data), otherwise as ``compute``. ``model`` and
        ``batch`` name the axes of a layer that gathers its rows over the
        model axis first (a MoE layer under the no_tp rules): its expert
        slices' gradients come from the data shard's gathered rows, partial
        over the data axes alone."""
        from torch.distributed.tensor import Partial
        model = model or self.model
        batch = self.batch if batch is None else batch
        out = self.compute(tp_dim, model)
        for i, a in enumerate(self.mesh.mesh_dim_names):
            if a in batch or (a == model and partial_on_model):
                out[i] = Partial()
        return out


def make_plan(mesh, rules: Dict[str, AxisRule], batch_size: int) -> Plan:
    sizes = mesh_axis_sizes(mesh)
    spec = spec_for((batch_size,), ("batch",), rules, mesh)
    batch = spec_axes(spec[0]) if spec else ()
    model = "model" if sizes.get("model", 1) > 1 and "model" not in batch \
        else None
    return Plan(mesh=mesh, rules=rules, batch=batch, model=model)


# ----------------------------------------------------------------------
# Collectives with gradients, for local_map bodies
# ----------------------------------------------------------------------
def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    out = t.float().contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.dtype)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """float32 on the wire (a bf16 value widens exactly)."""
    import torch.distributed as dist
    src = t.float().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.dtype)


def _all_gather0(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis, in rank order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = t.contiguous().reshape(1, *t.shape)
    out = src.new_empty((n,) + tuple(t.shape))
    dist.all_gather_into_tensor(out, src, group=group)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = _all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x

    @staticmethod
    def backward(ctx, grad):
        for g in ctx.groups:
            grad = _all_reduce(grad, g)
        return grad, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.size = x.shape[dim]
        parts = _all_gather0(x, group)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # the gathered value is replicated and carries its whole gradient
        # on every rank: this rank's part is its slice
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``; the gradient all-gathered
    (the conjugate of ``_AllGather``: a value every rank holds whole,
    narrowed to each rank's part, gives back a whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        parts = _all_gather0(grad, ctx.group)
        return torch.cat(parts.unbind(0), dim=ctx.dim), None, None


def _groups(mesh, axes: Sequence[str]):
    return tuple(mesh.get_group(a) for a in axes)


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over the mesh ``axes`` in float32 (x's dtype out); the gradient
    passes unchanged (the reference's ``psum`` of a row-parallel output)."""
    return _ReduceFrom.apply(x, _groups(mesh, axes)) if axes else x


class _RowParallel(torch.autograd.Function):
    """``x @ w`` summed over ``groups`` from float32 partials, rounded
    once to x's dtype; the gradient is that of the local product (the sum
    passes it unchanged, as ``_ReduceFrom``'s)."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        if x.dtype not in (torch.bfloat16, torch.float16):
            part = x @ w
        elif x.is_cuda:     # one product with float32 output (aten::mm.dtype)
            part = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
            part = part.reshape(x.shape[:-1] + (w.shape[-1],))
        else:
            part = x.float() @ w.float()
        for g in groups:
            part = _all_reduce(part, g)
        return part.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx = grad @ w.t() if ctx.needs_input_grad[0] else None
        dw = (x.reshape(-1, x.shape[-1]).t() @ grad.reshape(-1, grad.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh,
                 axes: Sequence[str]) -> torch.Tensor:
    """``x @ w`` where ``w``'s rows (x's last dim) are sliced over the mesh
    ``axes``: each rank's partial product in float32 (bf16 operands widened
    exactly; float32 and float64 as they are), summed over the axes in
    float32 and rounded once to x's dtype, as one product over the whole
    contraction rounds once. The
    gradient is the local product's, ``dx = dy w^T`` and ``dw = x^T dy``
    (the reference's ``psum`` passes it unchanged)."""
    if not axes:
        return x @ w
    return _RowParallel.apply(x, w, _groups(mesh, axes))


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Identity; the gradient is summed over the mesh ``axes`` (ahead of a
    column-parallel product, whose input's gradient each rank holds only
    in part)."""
    return _CopyTo.apply(x, _groups(mesh, axes)) if axes else x


def pmean(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean over the mesh ``axes`` (the reference's ``pmean``)."""
    if not axes:
        return x
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in axes)
    return reduce_from(x, mesh, axes) / n


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x (n, ...) with n the axis's size: block j goes to rank j, and block
    i of the result came from rank i (``lax.all_to_all`` with split and
    concat axis 0, untiled)."""
    return _AllToAll.apply(x, mesh.get_group(axis))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, dim, mesh.get_group(axis))


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (the same on every rank of ``axis``)
    along ``dim``, in rank order: what ``all_gather`` gathered, given back;
    the gradient is all-gathered over ``axis``."""
    return _Split.apply(x, dim, mesh.get_group(axis))


def all_reduce_max(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The maximum over the mesh ``axes``, with no gradient."""
    import torch.distributed as dist
    x = x.detach()
    for g in _groups(mesh, axes):
        x = _all_reduce(x, g, dist.ReduceOp.MAX)
    return x


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis``."""
    return mesh.get_local_rank(axis)
