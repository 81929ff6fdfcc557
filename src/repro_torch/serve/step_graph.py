"""The engine's compiled step: the port of the reference engine's
``jax.jit(..., donate_argnums=(1,))`` over its decode and chunk steps
(``repro.serve.engine``).

XLA compiles one program per shape signature and donates the cache
through it; here each signature's step is captured once as a CUDA graph
that writes the engine's cache in place, and replayed once per engine
step. The signature is what fixes every shape and grid of the step: the
block-table width of a paged decode step, nothing for a dense one,
``(kb, C, width)`` for a chunk. Every value that varies between steps
(tokens, positions, tables, mask; a chunk's piece, start, table and rows)
is a static input tensor on the card, which the host fills with one copy
each before the replay; the kernels read them on the card only.

The first call at a signature runs the step eagerly on a side stream (the
warm-up: it builds the kernel libraries and cuBLAS's state and fills the
host-side caches) and is that step's own work; then the same function is
captured on the side stream, which runs nothing, so the cache is not
written twice. Captures use ``capture_error_mode="thread_local"``: other
threads (gateway workers, prewarms) launch on the card meanwhile. Two
things they must not do during a capture: draw from torch's default CUDA
generator, which torch ties to every capture (the port draws from
generators of its own), and synchronise the whole device, which CUDA
forbids while any stream captures (the port empties the allocator's
cache through ``empty_cache`` here, which waits for captures). All of
an engine's graphs share one memory pool, so one graph's outputs may lie
where another graph kept its intermediates during its capture: a
program's outputs stay valid only until the next replay of any program
of the same ``StepGraphs``, and the caller reads (or copies) them before
that. Dropping the engine drops its graphs and their pool. A failed capture or replay raises: there is no
return to the eager step on the card.

A replay runs no Python wrapper, so each graph keeps the kernel launches
its capture recorded (``kernels.build.count_launch``) and adds them to the
wrappers' counts on every replay. The graph is kept in its captured form
(``CUDAGraph(keep_graph=True)``) until it is instantiated, so that its
kernel nodes can be counted through libcuda: they must equal that
record.

On the CPU, or with capture off, nothing is captured: the same
static-buffer step runs eagerly at every call, as a kernel wrapper runs its
plain version on a CPU tensor.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

# one warm-up or capture at a time in the process, on one side stream per
# card: two engines never record into each other's capture
_CAPTURE_LOCK = threading.Lock()
_SIDE: Dict[int, torch.cuda.Stream] = {}


class Program:
    """One signature's step: its static inputs and, when captured, the
    graph, the outputs it owns (valid until any program of the same pool
    replays) and the launches it replays."""

    def __init__(self, inputs: List[torch.Tensor]):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[Callable, int] = {}
        self.kernel_nodes = 0


class StepGraphs:
    """The step programs of one engine, keyed by shape signature."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = bool(capture) and device.type == "cuda"
        self.programs: Dict[tuple, Program] = {}
        self.pool = None
        self.capture_s = 0.0        # host time of the captures

    @property
    def n_graphs(self) -> int:
        return sum(p.graph is not None for p in self.programs.values())

    def run(self, key: tuple, arrays: Sequence[np.ndarray], fn: Callable):
        """Run the step ``fn(*inputs)`` of signature ``key`` on ``arrays``
        (one host array per static input, same shapes at every call of the
        key); returns its outputs. A captured program's outputs are its
        graph's own memory in the shared pool: they hold until the next
        ``run`` of any key of this ``StepGraphs``, which may overwrite
        them."""
        prog = self.programs.get(key)
        if prog is None:
            return self._first(key, arrays, fn)
        for buf, arr in zip(prog.inputs, arrays):
            buf.copy_(torch.from_numpy(np.asarray(arr)))
        if prog.graph is None:
            return fn(*prog.inputs)
        prog.graph.replay()
        for wrapper, n in prog.launches.items():
            wrapper.launches += n
        return prog.outputs

    def _first(self, key: tuple, arrays, fn: Callable):
        prog = Program([torch.from_numpy(np.array(a)).to(self.device)
                        for a in arrays])
        if not self.capture:
            self.programs[key] = prog
            return fn(*prog.inputs)
        with _CAPTURE_LOCK:
            side = _SIDE.get(self.device.index)
            if side is None:
                side = _SIDE[self.device.index] = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = fn(*prog.inputs)              # the warm-up: this step
            current.wait_stream(side)
            for t in _tensors(out):
                t.record_stream(current)
            t0 = time.perf_counter()
            self._capture(prog, side, fn)
            self.capture_s += time.perf_counter() - t0
        self.programs[key] = prog
        return out

    def _capture(self, prog: Program, side, fn: Callable) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with build.recording_launches() as launches, torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                outputs = fn(*prog.inputs)
            finally:
                graph.capture_end()
        names = kernel_node_names(graph.raw_cuda_graph())
        found, want = count_kernel_nodes(names), by_kernel(launches)
        if found != want:
            raise RuntimeError(f"captured step: kernel nodes {found} differ "
                               f"from the launches recorded {want}")
        prog.kernel_nodes = len(names)
        graph.instantiate()
        prog.graph, prog.outputs, prog.launches = graph, outputs, launches


def empty_cache() -> None:
    """``torch.cuda.empty_cache()`` between this process's captures:
    freeing device memory synchronises the device, which CUDA forbids
    while a stream of the context captures (it would invalidate another
    thread's capture)."""
    with _CAPTURE_LOCK:
        torch.cuda.empty_cache()


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


# ----------------------------------------------------------------------
# the captured graph's kernel nodes, through libcuda's graph API
# ----------------------------------------------------------------------
class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_NODE_KERNEL, _NODE_GRAPH = 0, 5        # CUgraphNodeType


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    for fn in (lib.cuFuncGetName, lib.cuKernelGetName):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    return lib


def _check(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUresult {rc}")


def kernel_node_names(graph_handle: int) -> List[str]:
    """The (mangled) kernel names of every kernel node of a captured
    ``cudaGraph_t``, child graphs included."""
    lib = _libcuda()
    n = ctypes.c_size_t(0)
    _check("cuGraphGetNodes", lib.cuGraphGetNodes(graph_handle, None,
                                                  ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _check("cuGraphGetNodes", lib.cuGraphGetNodes(graph_handle, nodes,
                                                  ctypes.byref(n)))
    names: List[str] = []
    for node in nodes:
        kind = ctypes.c_int()
        _check("cuGraphNodeGetType", lib.cuGraphNodeGetType(node,
                                                            ctypes.byref(kind)))
        if kind.value == _NODE_GRAPH:
            child = ctypes.c_void_p()
            _check("cuGraphChildGraphNodeGetGraph",
                   lib.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)))
            names += kernel_node_names(child.value)
            continue
        if kind.value != _NODE_KERNEL:
            continue
        params = _KernelNodeParams()
        _check("cuGraphKernelNodeGetParams",
               lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)))
        name = ctypes.c_char_p()
        if params.func:
            _check("cuFuncGetName", lib.cuFuncGetName(ctypes.byref(name),
                                                      params.func))
        else:
            _check("cuKernelGetName", lib.cuKernelGetName(ctypes.byref(name),
                                                          params.kern))
        names.append((name.value or b"").decode())
    return names


def count_kernel_nodes(names: Sequence[str]) -> Dict[str, int]:
    """{kernel: body nodes} among mangled kernel ``names``
    (``build.kernel_of_body``)."""
    return dict(collections.Counter(
        k for k in map(build.kernel_of_body, names) if k is not None))


def by_kernel(launches: Dict[Callable, int]) -> Dict[str, int]:
    """{kernel: launches} of a {wrapper: launches} record."""
    out: Dict[str, int] = collections.Counter()
    for wrapper, n in launches.items():
        out[wrapper.kernel] += n
    return dict(out)
