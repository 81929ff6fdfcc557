"""Multi-process serving cluster (master / workers / keeper over RPC).

The distributed deployment of the Hardless architecture: one master
process owns the shared state (scannable queue, object store, metrics,
control plane hooks, lease reaper), N worker processes each own the card
(their own CUDA context and model copy) and run the micro-batching
dispatcher loop, and a small versioned-JSON-frame RPC protocol connects
them.  The gateway client drives it all through :class:`ClusterBackend`
— the same ``Backend`` protocol the thread-mode backends implement, so
client code is unchanged.  See ``docs/cluster.md``.

The port's copy of ``repro.cluster``.  Names resolve lazily: a worker
process imports :mod:`repro_torch.cluster.worker` through this package,
and only the gateway side (``ClusterBackend``) needs torch, so a worker
serving a runtime that does not run a model never imports it.
"""
import importlib

_HOME = {
    "ClusterBackend": "backend", "ClusterCapacityHooks": "backend",
    "ClusterHandle": "backend", "MirrorStore": "backend",
    "WorkerLauncher": "backend", "start_cluster": "backend",
    "HeartbeatKeeper": "keeper", "Master": "master",
    "RPC_VERSION": "rpc", "RpcClient": "rpc", "RpcError": "rpc",
    "RpcProtocolError": "rpc", "RpcServer": "rpc",
    "load_runtime_spec": "runtimes",
    "InProcTransport": "transport", "MasterTransport": "transport",
    "RpcTransport": "transport", "Worker": "worker",
}

__all__ = [
    "ClusterBackend", "ClusterCapacityHooks", "ClusterHandle",
    "HeartbeatKeeper", "InProcTransport", "Master", "MasterTransport",
    "MirrorStore", "RPC_VERSION", "RpcClient", "RpcError",
    "RpcProtocolError", "RpcServer", "RpcTransport", "Worker",
    "WorkerLauncher", "load_runtime_spec", "start_cluster",
]


def __getattr__(name):
    home = _HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{home}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
