"""Transport-agnostic access to a cluster master.

The tentpole refactor's seam: everything the gateway side needs from
the master — submit, blob movement, the settlement stream, control-
plane actuation — goes through :class:`MasterTransport`, so
:class:`~repro_torch.cluster.backend.ClusterBackend` is written once and runs
over either:

* :class:`InProcTransport` — direct method calls on a ``Master`` living
  in this process (no sockets; the unit-test and single-process path,
  and the proof that the interface really is transport-agnostic);
* :class:`RpcTransport`  — the :mod:`repro_torch.cluster.rpc` frame protocol
  to a master process elsewhere.  Two connections: control traffic, and
  a dedicated one for the ``poll_settled`` long-poll so the pump never
  blocks a submit.

Both return the master's raw op dicts; blob helpers speak ``bytes`` and
hide the base64 framing.

The port's copy of ``repro.cluster.transport``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.cluster.rpc import RpcClient, RpcError, decode_blob, encode_blob


class MasterTransport:
    """What a gateway client may ask of a master (see module docstring)."""

    def hello(self, role: str = "client", name: str = "") -> Dict[str, Any]:
        """Clock/version handshake; returns the master's ``now``."""
        raise NotImplementedError

    def register(self, spec: str,
                 kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Install a runtime by importable factory spec."""
        raise NotImplementedError

    def submit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Publish one wire-format event to the shared queue."""
        raise NotImplementedError

    def put_blob(self, key: str, blob: bytes, raw: bool = False) -> None:
        """Install an already-serialized blob in the master's store."""
        raise NotImplementedError

    def get_blob(self, key: str) -> Tuple[bytes, bool]:
        """Fetch ``(blob, raw_flag)``; raises KeyError when absent."""
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        """Membership probe against the master's store."""
        raise NotImplementedError

    def poll_settled(self, since: int = 0,
                     timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll the settlement stream from cursor ``since``."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        """The master's queue/worker/settlement snapshot."""
        raise NotImplementedError

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Route a prewarm directive to one live worker."""
        raise NotImplementedError

    def evict(self, runtime_key: str) -> Dict[str, Any]:
        """Broadcast a warm-handle eviction."""
        raise NotImplementedError

    def pin(self, keys: List[str]) -> Dict[str, Any]:
        """Broadcast the pinned (never-evict) key set."""
        raise NotImplementedError

    def shutdown_master(self) -> None:
        """Flag the master to stop (workers exit on their next take)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release transport resources (idempotent)."""
        raise NotImplementedError


class InProcTransport(MasterTransport):
    """Direct calls on a :class:`~repro_torch.cluster.master.Master` in this
    process — the master's RPC dispatch surface without the sockets."""

    def __init__(self, master):
        self.master = master

    def hello(self, role: str = "client", name: str = "") -> Dict[str, Any]:
        """Handshake against the in-process master."""
        return self.master.op_hello(role=role, name=name)

    def register(self, spec: str,
                 kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Register a runtime spec on the in-process master."""
        return self.master.op_register(spec=spec, kwargs=kwargs or {})

    def submit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Publish one event (no serialization round trip)."""
        return self.master.op_submit(event=event)

    def put_blob(self, key: str, blob: bytes, raw: bool = False) -> None:
        """Install the blob directly in the master's store."""
        self.master.store.put_serialized(key, blob, raw=raw)

    def get_blob(self, key: str) -> Tuple[bytes, bool]:
        """Fetch the blob directly (KeyError surfaces naturally)."""
        return (self.master.store.get_raw(key),
                self.master.store.is_raw(key))

    def contains(self, key: str) -> bool:
        """Probe the master's store directly."""
        return key in self.master.store

    def poll_settled(self, since: int = 0,
                     timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll the settlement stream (blocks this thread)."""
        return self.master.op_poll_settled(since=since, timeout_s=timeout_s)

    def stats(self) -> Dict[str, Any]:
        """Master snapshot."""
        return self.master.op_stats()

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Route a prewarm directive."""
        return self.master.op_prewarm(runtime_id=runtime_id, config=config)

    def evict(self, runtime_key: str) -> Dict[str, Any]:
        """Broadcast an eviction directive."""
        return self.master.op_evict(runtime_key=runtime_key)

    def pin(self, keys: List[str]) -> Dict[str, Any]:
        """Broadcast the pin set."""
        return self.master.op_pin(keys=list(keys))

    def shutdown_master(self) -> None:
        """Flag the in-process master to stop."""
        self.master.op_shutdown()

    def close(self) -> None:
        """Nothing to release in-process."""


class RpcTransport(MasterTransport):
    """The frame protocol to a remote master (two connections: control +
    a dedicated settlement-pump stream)."""

    def __init__(self, addr: str, *, connect_timeout_s: float = 10.0):
        self.addr = addr
        self._ctl = RpcClient(addr, connect_timeout_s=connect_timeout_s)
        self._pump = RpcClient(addr, connect_timeout_s=connect_timeout_s)

    def hello(self, role: str = "client", name: str = "") -> Dict[str, Any]:
        """Handshake over the control connection."""
        return self._ctl.request("hello", role=role, name=name)

    def register(self, spec: str,
                 kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Register a runtime spec over RPC."""
        return self._ctl.request("register", spec=spec, kwargs=kwargs or {})

    def submit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Publish one event over RPC (config must be JSON-serializable)."""
        return self._ctl.request("submit", event=event)

    def put_blob(self, key: str, blob: bytes, raw: bool = False) -> None:
        """Ship the blob base64-framed."""
        self._ctl.request("put", key=key, blob=encode_blob(blob), raw=raw)

    def get_blob(self, key: str) -> Tuple[bytes, bool]:
        """Fetch a blob; the master's KeyError comes back as KeyError."""
        try:
            rsp = self._ctl.request("get", key=key)
        except RpcError as e:
            if "KeyError" in str(e):
                raise KeyError(key) from e
            raise
        return decode_blob(rsp["blob"]), bool(rsp.get("raw"))

    def contains(self, key: str) -> bool:
        """Membership probe over RPC."""
        return bool(self._ctl.request("contains", key=key)["present"])

    def poll_settled(self, since: int = 0,
                     timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll on the dedicated pump connection."""
        return self._pump.request("poll_settled", since=since,
                                  timeout_s=timeout_s)

    def stats(self) -> Dict[str, Any]:
        """Master snapshot over RPC."""
        return self._ctl.request("stats")

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Prewarm directive over RPC."""
        return self._ctl.request("prewarm", runtime_id=runtime_id,
                                 config=config)

    def evict(self, runtime_key: str) -> Dict[str, Any]:
        """Eviction directive over RPC."""
        return self._ctl.request("evict", runtime_key=runtime_key)

    def pin(self, keys: List[str]) -> Dict[str, Any]:
        """Pin-set broadcast over RPC."""
        return self._ctl.request("pin", keys=list(keys))

    def shutdown_master(self) -> None:
        """Flag the remote master to stop."""
        try:
            self._ctl.request("shutdown")
        except (ConnectionError, RpcError):
            pass        # already gone is as good as stopping

    def close(self) -> None:
        """Close both connections (unblocks a parked pump poll)."""
        self._pump.close()
        self._ctl.close()
