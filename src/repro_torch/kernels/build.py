"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``), loaded with ``ctypes``. The library's file name carries
a hash of the sources and flags, so editing a kernel rebuilds it and an
unchanged checkout reuses what an earlier run built. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
with nvcc's ``-Xptxas -v`` report beside each. Several sources build in
parallel, one ``nvcc`` each. A failed build raises with nvcc's stderr.
Building and loading hold one lock, so threads that reach a kernel's first
launch together (a gateway's workers) build it once and share one handle.
Across processes (cluster workers on one card) a build holds an exclusive
``flock`` on ``build/kernels/.lock``: the first process builds, the others
wait for it and load what it built. The kernel releases the lock when the
holder exits, killed or not, so a dead builder leaves no stale lock.

A wrapper given FakeTensor operands (shapes and dtypes, no storage: the
dry run's trace, ``launch/dryrun.py``) takes its shape-only path
(``is_fake``): its checks run and its outputs are made, as fake tensors,
and its FLOPs and HBM bytes go to the open ``recording_costs`` record;
nothing is built or launched, and the launch counts stay as they are. A
tensor that holds data never takes it: on the card it launches the
kernel, on the CPU it runs the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_attention", "flash_attention", "decode_attention",
           "rglru_scan", "moe_gmm", "flash_attention_bwd", "rglru_scan_bwd",
           "moe_gmm_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# the temporary library name is per process, not per thread
_LOCK = threading.RLock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns build seconds per
    library this process compiled (empty when everything was already
    built, here or by another process that held the lock first)."""
    names = list(names)
    with _LOCK:
        if all(library_path(n).exists() for n in names):
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)    # released at close or exit
            return _build(names)


def _build(names) -> Dict[str, float]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.parent / f".{out.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                          f"\n{stderr}{stdout}")
            continue
        out.with_suffix(".log").write_text(stderr + stdout)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` lines (registers, shared memory, spills) for
    the current build of ``name``, or '' when it was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _LOADED[name] = lib
    return lib


# ----------------------------------------------------------------------
# binding helpers shared by the wrappers
# ----------------------------------------------------------------------
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    """The C interface's dtype code: 0 = float32, 1 = bfloat16."""
    code = _DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` where a ``DTensor`` reaches a kernel wrapper:
    under a mesh the model calls the kernels inside ``local_map`` bodies,
    on local tensors, and a DTensor here is a call site that missed one
    (its raw pointer would be a shard's, its shape the global one)."""
    from repro_torch.device import is_dtensor
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(f"{name} takes local tensors, got a DTensor "
                            f"{tuple(t.shape)} {t.placements}: call it inside "
                            "a local_map body")


def check_operands(device, align: int = 16, **tensors) -> None:
    """Every operand on ``device`` and contiguous; floating and int8
    operands, which the attention kernels read with 16-byte vector loads,
    ``align``-byte aligned (a FakeTensor has no address: the alignment of
    the tensors a real call would get is not known). A DTensor raises
    (``refuse_dtensor``)."""
    refuse_dtensor("kernel", *tensors.values())
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (t.is_floating_point() or str(t.dtype) == "torch.int8") and \
                not is_fake(t) and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where autograd would need the gradient
    of a kernel that has no backward kernel: its output, written through
    ctypes, carries no ``grad_fn``, so the gradient would be cut without a
    word. Inference under ``torch.no_grad()`` (and operands that need no
    gradient) pass."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card: call it under "
            "torch.no_grad(), or on CPU tensors, where its plain version is "
            "differentiable")


def check_launch(name: str, rc: int) -> None:
    """Raise when the C launcher reports an error (it returns the
    ``cudaGetLastError()`` after the launch, or -1 for bad arguments)."""
    if rc == -1:
        raise ValueError(f"{name}: unsupported head_dim or dtype")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# ----------------------------------------------------------------------
# launch counts
# ----------------------------------------------------------------------
_CAPTURE = threading.local()


def count_launch(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel on ``wrapper.launches``.
    While this thread captures a CUDA graph the launch is recorded into the
    graph, not run: it goes to the capture's record instead, which every
    replay of the graph adds to the counts (``serve/step_graph.py``).
    Launches of other threads are counted as ever."""
    record = getattr(_CAPTURE, "record", None)
    if record is None:
        wrapper.launches += 1
    else:
        record[wrapper] = record.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Yield {wrapper: launches} of this thread's launches while it is open
    (a capture), which then leave ``wrapper.launches`` unchanged."""
    record: Dict[Callable, int] = {}
    _CAPTURE.record = record
    try:
        yield record
    finally:
        _CAPTURE.record = None


# ----------------------------------------------------------------------
# the device kernels each wrapper launches
# ----------------------------------------------------------------------
# The body kernels of the port's kernels K1-K5 and of the backward kernels
# of K2, K4 and K5 ("K2 bwd": its dQ and dK/dV passes; "K4 bwd": its dX
# and dW kernels; "K5 bwd"), by fragments of their mangled names; each wrapper names its kernel in
# ``wrapper.kernel``. The split decode body may add its merge kernel, which
# is not a body. K1's two wrappers share their kernels: a one-token chunk
# runs the decode body.
BODIES: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("split_decode_mma_kernel", "PagedCache"), "K1"),
    (("split_decode_fma_kernel", "PagedCache"), "K1"),
    (("paged_prefill_mma_kernel",), "K1"),
    (("paged_tiled_kernel",), "K1"),
    (("split_decode_mma_kernel", "DenseCache"), "K3"),
    (("split_decode_fma_kernel", "DenseCache"), "K3"),
    (("flash_attention_wgmma_kernel",), "K2"),
    (("flash_attention_mma_kernel",), "K2"),
    (("flash_attention_kernel",), "K2"),
    (("moe_gmm_wgmma_kernel",), "K4"),
    (("moe_gmm_mma_kernel",), "K4"),
    (("moe_gmm_kernel",), "K4"),
    (("rglru_scan_kernel",), "K5"),
    (("flash_attention_bwd_dq_wgmma_kernel",), "K2 bwd"),
    (("flash_attention_bwd_dkv_wgmma_kernel",), "K2 bwd"),
    (("flash_attention_bwd_dq_kernel",), "K2 bwd"),
    (("flash_attention_bwd_dkv_kernel",), "K2 bwd"),
    (("rglru_scan_bwd_kernel",), "K5 bwd"),
    (("moe_gmm_bwd_dx_wgmma_kernel",), "K4 bwd"),
    (("moe_gmm_bwd_dw_wgmma_kernel",), "K4 bwd"),
    (("moe_gmm_bwd_dx_kernel",), "K4 bwd"),
    (("moe_gmm_bwd_dw_kernel",), "K4 bwd"),
)


def kernel_of_body(name: str) -> Optional[str]:
    """The kernel (K1-K5, K2 bwd, K4 bwd, K5 bwd) whose body the mangled
    device-kernel ``name`` is, or None (an identifier matches with its
    length prefix, so ``moe_gmm_kernel`` does not match
    ``moe_gmm_mma_kernel``)."""
    for frags, kernel in BODIES:
        if all(f"{len(f)}{f}" in name for f in frags):
            return kernel
    return None


# ----------------------------------------------------------------------
# shape-only calls: FakeTensor operands (the dry run's trace)
# ----------------------------------------------------------------------
# the streaming multiprocessors a split plan assumes where the operands are
# fake (a fake device has no properties to ask): the H100 SXM's 132
H100_SXM_SMS = 132

# the open record of shape-only costs: one for the process, not a thread,
# since autograd runs a card's backward on a thread of its own
_COSTS: Dict[str, Optional[dict]] = {"record": None}
_COSTS_LOCK = threading.Lock()


def is_fake(*tensors) -> bool:
    """Whether an operand is a FakeTensor (shapes and dtypes, no storage).
    Where nothing imported ``torch._subclasses.fake_tensor`` no FakeTensor
    can exist, so a call on real tensors pays no import."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and any(isinstance(t, mod.FakeTensor)
                                   for t in tensors)


def n_sms(t) -> int:
    """The SMs a split plan is made for: the card's, or ``H100_SXM_SMS``
    for a fake operand."""
    return H100_SXM_SMS if is_fake(t) else sm_count(t.device.index)


def nbytes(*tensors) -> int:
    """The bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def record_cost(wrapper: Callable, flops: float, n_bytes: float) -> None:
    """One shape-only call of ``wrapper``: its FLOPs and the HBM bytes it
    moves (each input read once, each output written once: the reckoning
    of ``PERF.md``'s bound column), added to the open
    ``recording_costs`` record (dropped where none is open)."""
    with _COSTS_LOCK:
        record = _COSTS["record"]
        if record is None:
            return
        row = record.setdefault(wrapper.__name__, {"calls": 0, "flops": 0.0,
                                                   "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += float(flops)
        row["bytes"] += float(n_bytes)


@contextlib.contextmanager
def recording_costs():
    """Yield {wrapper name: {"calls", "flops", "bytes"}} of the shape-only
    calls made while it is open (in any thread of the process)."""
    record: Dict[str, Dict[str, float]] = {}
    with _COSTS_LOCK:
        prev, _COSTS["record"] = _COSTS["record"], record
    try:
        yield record
    finally:
        with _COSTS_LOCK:
            _COSTS["record"] = prev
