"""What one traced step costs a chip: collectives, FLOPs, bytes and memory
(the port's twin of ``repro.roofline.hlo``).

The reference parses the compiled program's HLO text for its collectives.
The port has no compiled program: the dry run (``launch/dryrun.py``) runs
the step on fake tensors (``FakeTensorMode``) over a fake process group,
and ``StepCounter``, a ``TorchDispatchMode``, sees every operator the
step issues, at the level of this rank's local tensors:

* **collectives**: every c10d collective (``c10d.allreduce_``,
  ``c10d._allgather_base_``, ...) and every functional one
  (``_c10d_functional.all_reduce``, ...), whether the model issues it or
  DTensor's ``redistribute`` does, put into the reference's five names
  (``COLLECTIVES``). Bytes are the result's payload, as ``hlo.py``
  counts the result shape: the output of a c10d collective (its first
  argument), the return value of a functional one. A functional
  collective's ``wait_tensor`` is the second half of an async pair and is
  not counted again.
* **FLOPs**: each operator ``torch.utils.flop_counter`` has a formula for
  (matrix products, convolutions, attention), from the local shapes, plus
  what the hand-written kernels' shape-only paths record
  (``kernels.build.recording_costs``).
* **bytes**: each operator's distinct input and output tensors, views
  and allocations (``empty``) aside: the unfused upper bound the report
  calls ``hlo_bytes`` (no operator is fused in an eager step), plus the
  kernels' own reckoning.
* **memory**: every storage an operator's output makes is counted live
  until Python frees it (a weak reference's finalizer on the storage), and
  the peak of that sum is what the step allocates beyond its arguments
  (whose storages ``track`` marks as there before the step).

An operator on DTensors is left to DTensor (the mode returns
``NotImplemented``), which runs it on the local tensors, where the mode
counts it: so every count is a chip's, never the global shape's.
DTensor's sharding propagation, which runs the operator on fake tensors
of the global shapes to learn its output's, is not counted: the counter
wraps the propagator's tensor-meta step while it is open.
"""
from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d's operators (ProcessGroup collectives, whose result is their first
# argument) and the functional ones (whose result is their return value),
# by the reference's names
_C10D = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NOT_COUNTED = {"wait_tensor", "barrier", "monitored_barrier_"}
# the sharding propagator's methods that run an operator on fake global
# tensors (the names differ between torch releases)
_PROPAGATION_STEPS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
# allocations move no bytes
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _payload(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class StepCounter(TorchDispatchMode):
    """Counts one step's collectives, FLOPs, bytes and allocations on this
    rank (see the module docstring). Open it inside the fake-tensor mode,
    ``track`` the step's arguments, run the step, read the fields and
    ``collective_bytes()``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_formulas = FlopCounterMode(display=False).flop_registry
        self.per_type: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self.counts: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self.by_op: Dict[str, int] = {}
        self.flops = 0.0
        self.op_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()   # storages there or counted
        self._propagating = 0
        self._unwrap = []

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in _PROPAGATION_STEPS:
            fn = getattr(prop, name, None)
            if fn is not None:
                setattr(prop, name, self._uncounted(fn))
                self._unwrap.append((prop, name))
        return super().__enter__()

    def __exit__(self, *exc):
        for prop, name in self._unwrap:
            delattr(prop, name)         # back to the class's method
        self._unwrap = []
        return super().__exit__(*exc)

    def _uncounted(self, fn):
        def wrapped(*args, **kwargs):
            self._propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._propagating -= 1
        return wrapped

    # ------------------------------------------------------------------
    def track(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the step's arguments: local
        tensors) as there before the step: not counted as allocated, also
        where the step writes into them in place."""
        for t in tensors:
            self._seen[t.untyped_storage()] = True

    def _allocated(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        if storage in self._seen:
            return
        self._seen[storage] = True
        size = storage.nbytes()
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._freed, size)

    def _freed(self, size: int) -> None:
        self.live -= size

    def collective_bytes(self) -> Tuple[int, Dict[str, int], Dict[str, int]]:
        """(total_bytes, bytes_per_op_type, count_per_op_type), the
        reference's ``hlo.collective_bytes`` result."""
        return sum(self.per_type.values()), dict(self.per_type), dict(self.counts)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(not issubclass(t, FakeTensor) and t is not torch.Tensor for t in types):
            return NotImplemented       # DTensor: counted on its local tensors
        out = func(*args, **kwargs)
        if self._propagating:
            return out      # DTensor's shape propagation: no chip's work
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional"):
            self._collective(ns, name, args, out)
        elif not func.is_view and name not in _ALLOCATIONS:
            formula = self._flop_formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            ins = {id(t): t for t in _tensors((args, kwargs))}
            outs = [t for t in _tensors(out) if id(t) not in ins]
            self.op_bytes += _payload(list(ins.values())) + _payload(outs)
        for t in _tensors(out):
            self._allocated(t)
        return out

    def _collective(self, ns: str, name: str, args, out) -> None:
        if name in _NOT_COUNTED:
            return
        kind = (_C10D if ns == "c10d" else _FUNCTIONAL).get(name)
        if kind is None:
            raise NotImplementedError(f"{ns}.{name}: a collective with no name among "
                                      f"{COLLECTIVES}")
        n = _payload(args[0] if ns == "c10d" else out)
        self.per_type[kind] += n
        self.counts[kind] += 1
        key = f"{ns}.{name}"
        self.by_op[key] = self.by_op.get(key, 0) + 1
