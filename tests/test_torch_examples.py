"""The port's twins of the five examples (``repro_torch.examples``) against
the reference examples (``examples/*.py``), each run on the CPU and its
printed lines compared:

* ``quickstart`` and ``heterogeneous_accelerators`` run the sim core only,
  on the same seed and virtual clock: their lines are equal, numbers and
  all.
* ``unified_gateway``, ``serve_cluster`` and ``cluster_quickstart`` run a
  model (or worker processes) for real, so their times and process ids
  differ: their lines are equal with the numbers aside, after the
  reference's wording is put back where a twin names its own mechanism
  (``WORDING``: PyTorch for JAX, the cold start's work, H100 nodes for
  TPU slices). ``serve_cluster``'s event order,
  placement and cold starts follow the measured ELats, which differ
  between two runs of the reference itself, so its event lines are
  compared as a set with the accelerator and the cold flag aside.
"""
import io
import re
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from repro_torch.examples import cluster_quickstart, heterogeneous_accelerators
from repro_torch.examples import quickstart, serve_cluster, unified_gateway

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# {twin: {the twin's words: the reference's}}
WORDING = {
    "unified_gateway": {"cold = weights + kernel build": "cold = jit + weights"},
    "serve_cluster": {"h100-sxm-8": "v5e-4x4", "h100-sxm-1": "v5e-2x2",
                      "real PyTorch execution": "real JAX execution"},
}


def _lines(fn):
    out = io.StringIO()
    with redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def _reference(name):
    return _lines(lambda: runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                                         run_name="__main__"))


def _numbers_aside(lines):
    return [re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "N", x) for x in lines]


def _reworded(lines, wording):
    for twin, ref in wording.items():
        lines = [x.replace(twin, ref) for x in lines]
    return lines


@pytest.mark.parametrize("name,twin", [("quickstart", quickstart),
                                       ("heterogeneous_accelerators",
                                        heterogeneous_accelerators)])
def test_sim_twin_prints_the_reference_lines(name, twin):
    got = _lines(twin.main)
    assert got == _reference(name)
    assert len(got) >= 8


def test_unified_gateway_twin_prints_the_reference_lines():
    got = _reworded(_lines(lambda: unified_gateway.main(["--device", "cpu"])),
                    WORDING["unified_gateway"])
    want = _reference("unified_gateway")
    assert _numbers_aside(got) == _numbers_aside(want)
    assert sum("[engine] ev" in x for x in got) == 3


def test_serve_cluster_twin_prints_the_reference_lines():
    got = _reworded(_lines(lambda: serve_cluster.main(["--device", "cpu"])),
                    WORDING["serve_cluster"])
    want = _reference("serve_cluster")

    def shape(lines):
        lines = _numbers_aside(lines)
        events = sorted(re.sub(r"acc=\S+ cold=\w+", "acc=A cold=B", x)
                        for x in lines if x.startswith("  event"))
        return [x for x in lines if not x.startswith("  event")], events
    assert shape(got) == shape(want)
    assert got[-1] == want[-1] and len(got) == len(want) == 8


def test_cluster_quickstart_twin_prints_the_reference_lines():
    """Which worker takes which micro-batch follows the processes' start
    times: under load one worker may serve all 8 events, in the
    reference as in the twin, so the list of pids is compared as a list."""
    def shape(lines):
        return [re.sub(r"\[N(, N)*\]", "[pids]", x) for x in _numbers_aside(lines)]
    got = _lines(cluster_quickstart.main)
    want = _reference("cluster_quickstart")
    assert shape(got) == shape(want)
    assert re.match(r"8 events served by [12] worker processes", got[0])
    assert "= 17 across worker processes" in got[-1]
