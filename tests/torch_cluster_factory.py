"""Runtime factories that ``tests/test_torch_cluster.py`` hands to cluster
workers by importable spec (``"torch_cluster_factory:<name>"``).

Not a test module (no ``test_`` prefix, so pytest does not collect it),
and it imports no JAX: a worker process reaches it through the
``PYTHONPATH`` the test sets, and builds its runtime from here.
"""
import dataclasses
import importlib
import pickle
import threading
import time

SETUPS: dict = {}       # runtime_id -> setup() calls begun in this process
GATE = threading.Event()    # a gated setup() returns once this is set


def granite_from_pickle(path: str, max_batch: int = 4, max_slots: int = 4,
                        max_len: int = 64, page_size: int = 16):
    """The port's serve runtime for granite-3-2b ``.reduced()`` on the
    host, whose cold start builds the engine from the weights pickled at
    ``path`` (a numpy tree the test wrote from the JAX package's seed-0
    parameters) through ``repro_torch.bridge``: the worker serves the
    same weights as the reference cluster."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serve.api import make_serve_runtime
    from repro_torch.serve.engine import ServingEngine
    cfg = get_config("granite-3-2b").reduced()
    engine = dict(max_slots=max_slots, max_len=max_len, page_size=page_size)
    rdef = make_serve_runtime(cfg, max_batch=max_batch, device="cpu",
                              **engine)

    def setup():
        with open(path, "rb") as f:
            tree = pickle.load(f)
        return ServingEngine(cfg, bridge.from_jax(tree, device="cpu"),
                             device="cpu", **engine)
    return dataclasses.replace(rdef, setup=setup)


def slow_setup_runtime(pkg: str = "repro_torch", runtime_id: str = "slow",
                       setup_s: float = 4.5, gated: bool = False):
    """A runtime of package ``pkg`` (``repro`` or ``repro_torch``) whose
    cold start sleeps ``setup_s`` seconds: a prewarm of it outlasts the
    heartbeat timeout. Each ``setup()`` begun counts in ``SETUPS``, and
    with ``gated`` it then waits for ``GATE`` (both for a test that hosts
    the worker on a thread of its own process)."""
    R = importlib.import_module(f"{pkg}.core.runtime")

    def setup():
        SETUPS[runtime_id] = SETUPS.get(runtime_id, 0) + 1
        if gated:
            assert GATE.wait(60.0), "the test never opened the gate"
        time.sleep(setup_s)
        return {"warm": True}

    def fn(data, config):
        return {"echo": data, "warm": config["handle"]["warm"]}

    return R.RuntimeDef(
        runtime_id=runtime_id,
        profiles={R.HOST_ACC: R.SimProfile(elat_median_s=1e-3,
                                           cold_start_s=setup_s)},
        fn=fn, setup=setup)
