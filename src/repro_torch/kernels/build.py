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
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_attention", "flash_attention", "decode_attention",
           "rglru_scan", "moe_gmm")
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


def check_operands(device, align: int = 16, **tensors) -> None:
    """Every operand on ``device`` and contiguous; floating and int8
    operands, which the attention kernels read with 16-byte vector loads,
    ``align``-byte aligned."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (t.is_floating_point() or str(t.dtype) == "torch.int8") and \
                t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def check_launch(name: str, rc: int) -> None:
    """Raise when the C launcher reports an error (it returns the
    ``cudaGetLastError()`` after the launch, or -1 for bad arguments)."""
    if rc == -1:
        raise ValueError(f"{name}: unsupported head_dim or dtype")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
