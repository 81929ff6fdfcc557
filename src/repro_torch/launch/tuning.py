"""Host tuning preset for serving launches (``--tuned``): the port's copy
of ``repro.launch.tuning``.

The serving loop allocates on the host at every step (requests, token
lists, tensors built from them), and glibc malloc contends there; tcmalloc
is the standard fix. The preset preloads it through ``LD_PRELOAD`` and
raises its large-alloc report threshold so big host arrays do not spam
warnings. The reference's XLA and TensorFlow knobs (``XLA_FLAGS`` with a
host device count, ``TF_CPP_MIN_LOG_LEVEL``) mean nothing to PyTorch and
are left out.

``LD_PRELOAD`` only takes effect at process start, so ``--tuned`` re-execs
the launcher once with the environment applied (``REPRO_TORCH_TUNED_ENV``
marks the tuned child and stops the recursion). ``tuned_env`` itself is
pure: tests check the preset without re-execing.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

# set in the re-exec'd child so the preset applies exactly once
TUNED_MARKER = "REPRO_TORCH_TUNED_ENV"

# well-known tcmalloc locations (Debian/Ubuntu package paths); absent in
# minimal containers, where the preset keeps the malloc it has
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def find_tcmalloc() -> Optional[str]:
    for path in TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def tuned_env(base: Optional[Dict[str, str]] = None
              ) -> Tuple[Dict[str, str], List[str]]:
    """The tuning preset over ``base`` (default: the live environment).

    Returns (environment, applied) where ``applied`` names each knob the
    preset actually set: already-exported values win, so an operator's
    explicit settings are never overridden.
    """
    env = dict(os.environ if base is None else base)
    applied: List[str] = []
    if env.get(TUNED_MARKER):
        return env, applied
    env[TUNED_MARKER] = "1"

    tcm = find_tcmalloc()
    if tcm and "LD_PRELOAD" not in env:
        env["LD_PRELOAD"] = tcm
        applied.append(f"LD_PRELOAD={tcm}")
    if "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in env:
        env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = "60000000000"
        applied.append("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000")
    return env, applied


def is_tuned() -> bool:
    """True inside a process the preset was applied to."""
    return bool(os.environ.get(TUNED_MARKER))


def maybe_reexec(module: str) -> None:
    """Re-exec ``python -m module sys.argv[1:]`` with the preset applied.

    Returns at once when this process already carries the marker; never
    returns otherwise. Must run before the process touches the card."""
    if is_tuned():
        return
    env, applied = tuned_env()
    for knob in applied:
        print(f"[tuned] {knob}", file=sys.stderr)
    os.execve(sys.executable,
              [sys.executable, "-m", module] + sys.argv[1:], env)
