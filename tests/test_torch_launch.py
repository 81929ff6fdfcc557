"""The port's launcher flags ``--max-new-tokens`` and ``--tuned`` against
the JAX package's launcher: both accept each flag; the new-token count
reaches ``--sim``'s roofline profile, the events' results and the
workflows' results; ``--tuned`` never execs for a call with ``argv`` given
and re-execs a command-line run exactly once; ``tuned_env`` never
overrides a variable already exported and sets no XLA knob."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import tuning
from repro_torch.serve.service_model import roofline_profile

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIM = ["--backend", "sim", "--sim", "--events", "1"]


@pytest.mark.parametrize("flags", [["--max-new-tokens", "4"], ["--tuned"]],
                         ids=["max-new-tokens", "tuned"])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_both_launchers_accept_the_flag(pkg, flags, capsys, monkeypatch):
    execs = []
    monkeypatch.setattr(os, "execve", lambda *a: execs.append(a))
    main = jserve.main if pkg == "jax" else tserve.main
    assert main(SIM + flags) == 0
    assert "1/1 events" in capsys.readouterr().out
    assert execs == []                      # argv given: never re-exec


@pytest.mark.parametrize("new", [4, 16])
def test_new_tokens_reach_the_sim_profile(new, capsys):
    assert tserve.main(SIM + ["--max-new-tokens", str(new)]) == 0
    out = capsys.readouterr().out
    cfg = get_config("granite-3-2b")
    want = roofline_profile(cfg, batch=2, new_tokens=new, prompt_len=64)
    other = roofline_profile(cfg, batch=2, new_tokens=6, prompt_len=64)
    assert want.elat_median_s != other.elat_median_s
    assert (f"profile serve-granite-3-2b: ELat median "
            f"{want.elat_median_s:.6f}s") in out


def test_default_is_the_reference_six(capsys):
    assert tserve.main(SIM) == 0
    want = roofline_profile(get_config("granite-3-2b"), batch=2, new_tokens=6,
                            prompt_len=64)
    assert f"ELat median {want.elat_median_s:.6f}s" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [["--events", "2"], ["--workflow", "1"]],
                         ids=["events", "workflow"])
def test_new_tokens_reach_the_results(mode, capsys):
    """2 prompts of 64 tokens an event (or a chain's step): 2 x 3 tokens."""
    assert tserve.main(["--reduced", "--device", "cpu", "--max-new-tokens",
                        "3", *mode]) == 0
    out = capsys.readouterr().out
    counts = re.findall(r"tokens=(\d+)", out)
    assert counts and set(counts) == {"6"}, out


def test_tuned_env_never_overrides_an_exported_variable(monkeypatch):
    monkeypatch.setattr(tuning, "find_tcmalloc", lambda: "/lib/tcm.so")
    env, applied = tuning.tuned_env({"LD_PRELOAD": "/mine.so",
                                     "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD":
                                     "7"})
    assert env["LD_PRELOAD"] == "/mine.so" and applied == []
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "7"
    assert env[tuning.TUNED_MARKER] == "1"
    env, applied = tuning.tuned_env({})
    assert env["LD_PRELOAD"] == "/lib/tcm.so"
    assert applied == ["LD_PRELOAD=/lib/tcm.so",
                       "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000"]
    # the XLA and TensorFlow knobs mean nothing to PyTorch
    assert "XLA_FLAGS" not in env and "TF_CPP_MIN_LOG_LEVEL" not in env
    # inside the tuned child the preset applies nothing again
    again, applied = tuning.tuned_env({tuning.TUNED_MARKER: "1"})
    assert again == {tuning.TUNED_MARKER: "1"} and applied == []


def test_maybe_reexec_runs_the_module_once(monkeypatch):
    calls = []
    monkeypatch.setattr(os, "execve", lambda *a: calls.append(a))
    monkeypatch.delenv(tuning.TUNED_MARKER, raising=False)
    monkeypatch.setattr(sys, "argv", ["serve", "--tuned", "--events", "1"])
    tuning.maybe_reexec("repro_torch.launch.serve")
    (exe, args, env), = calls
    assert args == [sys.executable, "-m", "repro_torch.launch.serve",
                    "--tuned", "--events", "1"]
    assert env[tuning.TUNED_MARKER] == "1"
    monkeypatch.setenv(tuning.TUNED_MARKER, "1")
    tuning.maybe_reexec("repro_torch.launch.serve")
    assert len(calls) == 1


def test_tuned_command_line_run_reexecs_and_serves():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop(tuning.TUNED_MARKER, None)
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tuned", *SIM,
         "--max-new-tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "1/1 events served" in p.stdout
    assert "[tuned] TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" in p.stderr
