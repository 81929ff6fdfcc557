"""Versioned JSON-frame RPC between cluster processes (master/worker/client).

The wire protocol is deliberately tiny and inspectable — the Lithops
standalone master/worker split uses the same shape (a small HTTP/JSON
control plane in front of a queue):

* every frame is ``4-byte big-endian length`` + one UTF-8 JSON object;
* every frame carries ``"v": RPC_VERSION`` — a peer speaking a different
  protocol version is refused with an explicit error frame, never
  misparsed;
* requests are ``{"v", "id", "op", ...args}``; responses echo ``id`` and
  carry ``{"ok": true, ...result}`` or ``{"ok": false, "error": "..."}``;
* binary payloads (pickled data-plane blobs) travel base64-encoded under
  ``blob`` keys — the data plane shares the control frames, so one
  socket per role is enough.

Connections are persistent: a client opens one socket per concurrent
request stream (workers use two — the take/settle loop and the heartbeat
thread; the gateway client uses two — control and the settlement pump).
One request is outstanding per connection at a time (``RpcClient``
serializes), which keeps the server loop a plain read/dispatch/write
cycle with no frame interleaving.  Long-poll ops (``take``,
``poll_settled``) simply block their server thread — the server is a
thread-per-connection ``ThreadingTCPServer``.

The op vocabulary (dispatched by :class:`repro_torch.cluster.master.Master`):
``hello``, ``register``, ``runtime_specs``, ``submit``, ``take``,
``settle``, ``heartbeat``, ``poll_settled``, ``put``, ``get``,
``contains``, ``prewarm``, ``stats``, ``shutdown``.  See
``docs/cluster.md`` for the frame-by-frame reference.

The port's copy of ``repro.cluster.rpc``: the version and the frame
layout are byte-for-byte the reference's, so a client of either package
talks to a server of the other.
"""
from __future__ import annotations

import base64
import json
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

RPC_VERSION = 1

# a frame larger than this is a protocol error, not a big result — the
# data plane chunks nothing today, so this is simply a safety bound
MAX_FRAME_BYTES = 256 << 20

_LEN = struct.Struct(">I")


# Invocation fields carried verbatim across the wire (everything except
# ``config``/``inv_id``/identity, which the codec handles explicitly)
_INV_FIELDS = (
    "runtime_id", "data_ref", "r_start", "n_start", "e_start", "e_end",
    "n_end", "r_end", "success", "accelerator", "node", "cold_start",
    "result_ref", "error", "rejected", "prewarmed", "locality_hit",
    "attempt", "retries_exhausted", "tenant", "workflow", "step",
    "trace_id", "span_id",
)


def inv_to_wire(inv) -> Dict[str, Any]:
    """Serialize an :class:`~repro_torch.core.events.Invocation` for a frame.

    ``config`` must be JSON-serializable (the submit path enforces this
    with a clear error) — run configurations are declarative by design."""
    d = {f: getattr(inv, f) for f in _INV_FIELDS}
    d["inv_id"] = inv.inv_id
    d["config"] = inv.config
    return d


def inv_from_wire(d: Dict[str, Any]):
    """Rebuild an ``Invocation`` from its wire dict.

    ``inv_id`` is passed through explicitly so the receiving process's
    local id counter is never consulted — the submitting client's ids
    are authoritative cluster-wide (one gateway client per cluster)."""
    from repro_torch.core.events import Invocation
    inv = Invocation(runtime_id=d["runtime_id"],
                     data_ref=d.get("data_ref", ""),
                     config=dict(d.get("config") or {}),
                     inv_id=int(d["inv_id"]))
    for f in _INV_FIELDS:
        if f in d and f != "runtime_id":
            setattr(inv, f, d[f])
    return inv


class RpcError(RuntimeError):
    """The peer answered ``ok: false`` (the server-side error text)."""


class RpcProtocolError(RuntimeError):
    """The byte stream violated the frame protocol (length/JSON/version)."""


def encode_blob(blob: bytes) -> str:
    """Base64-encode a binary payload for a JSON frame field."""
    return base64.b64encode(blob).decode("ascii")


def decode_blob(text: str) -> bytes:
    """Decode a base64 ``blob`` field back to bytes."""
    return base64.b64decode(text.encode("ascii"))


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame and send it."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise RpcProtocolError(
            f"frame of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte bound")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None         # orderly EOF
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Read one frame; ``None`` on orderly EOF (peer closed the stream)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise RpcProtocolError(f"peer announced a {length}-byte frame "
                               f"(bound {MAX_FRAME_BYTES})")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise RpcProtocolError("stream closed mid-frame")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise RpcProtocolError(f"undecodable frame: {e}") from e
    if not isinstance(obj, dict):
        raise RpcProtocolError("frame is not a JSON object")
    return obj


def parse_addr(addr: str) -> Tuple[str, int]:
    """Split ``"host:port"`` into ``(host, port)``."""
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"malformed master address {addr!r} "
                         f"(expected host:port)")
    return host, int(port)


class RpcClient:
    """One persistent request/response connection to the master.

    Thread-safe in the "serialized" sense: an internal lock admits one
    outstanding request at a time, so callers that need concurrency
    (a blocking long-poll next to control traffic) open a second client.
    """

    def __init__(self, addr: str, *, connect_timeout_s: float = 5.0,
                 retry_interval_s: float = 0.05):
        self.addr = addr
        host, port = parse_addr(addr)
        deadline = time.monotonic() + connect_timeout_s
        last_err: Optional[Exception] = None
        self._sock: Optional[socket.socket] = None
        while time.monotonic() < deadline and self._sock is None:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=None)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
            except OSError as e:
                last_err = e
                time.sleep(retry_interval_s)
        if self._sock is None:
            raise ConnectionError(
                f"cannot reach master at {addr}: {last_err!r}")
        self._lock = threading.Lock()
        self._next_id = 0

    def request(self, op: str, **args: Any) -> Dict[str, Any]:
        """Send one op frame and block for its response payload.

        Raises :class:`RpcError` when the server answered ``ok: false``,
        ``ConnectionError`` when the stream died mid-call.
        """
        with self._lock:
            sock = self._sock
            if sock is None:
                raise ConnectionError(f"connection to {self.addr} is closed")
            self._next_id += 1
            frame = {"v": RPC_VERSION, "id": self._next_id, "op": op}
            frame.update(args)
            try:
                send_frame(sock, frame)
                rsp = recv_frame(sock)
            except (OSError, AttributeError) as e:
                # AttributeError: close() tore the socket down mid-call
                raise ConnectionError(
                    f"rpc {op!r} to {self.addr} failed: {e!r}") from e
            if rsp is None:
                raise ConnectionError(
                    f"master at {self.addr} closed the stream during "
                    f"{op!r}")
        if rsp.get("v") != RPC_VERSION:
            raise RpcProtocolError(
                f"version mismatch: peer speaks v{rsp.get('v')!r}, "
                f"this client v{RPC_VERSION}")
        if not rsp.get("ok"):
            raise RpcError(rsp.get("error", f"{op} failed"))
        return rsp

    def close(self) -> None:
        """Close the socket (idempotent).

        Deliberately does NOT take the request lock: a blocked long-poll
        holds it, and closing the socket out from under that recv is
        exactly how the caller unblocks it (the parked ``request`` raises
        ``ConnectionError``)."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()


class _FrameHandler(socketserver.BaseRequestHandler):
    """Per-connection server loop: read frame, dispatch, write response."""

    def handle(self):  # noqa: D102 — socketserver plumbing
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        dispatch = self.server.dispatch_fn        # type: ignore[attr-defined]
        while True:
            try:
                req = recv_frame(sock)
            except (RpcProtocolError, OSError):
                return                  # broken stream: drop the connection
            if req is None:
                return                  # orderly close
            rid = req.get("id")
            if req.get("v") != RPC_VERSION:
                rsp = {"v": RPC_VERSION, "id": rid, "ok": False,
                       "error": f"rpc version mismatch: got "
                                f"{req.get('v')!r}, serving v{RPC_VERSION}"}
            else:
                op = req.get("op")
                args = {k: v for k, v in req.items()
                        if k not in ("v", "id", "op")}
                try:
                    result = dispatch(op, args)
                    rsp = {"v": RPC_VERSION, "id": rid, "ok": True}
                    rsp.update(result or {})
                except Exception as e:  # noqa: BLE001 — surfaced to peer
                    rsp = {"v": RPC_VERSION, "id": rid, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
            try:
                send_frame(sock, rsp)
            except OSError:
                return                  # peer went away mid-response


class RpcServer:
    """Threaded frame server delegating every op to one dispatch callable.

    ``dispatch(op, args) -> dict`` runs on the connection's thread;
    long-poll ops may block it.  ``serve()`` binds (port 0 picks a free
    port) and starts the accept loop on a daemon thread.
    """

    def __init__(self, dispatch: Callable[[str, Dict[str, Any]],
                                          Dict[str, Any]]):
        self._dispatch = dispatch
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Bind and start accepting; returns the ``host:port`` address."""
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _FrameHandler)
        self._server.dispatch_fn = self._dispatch   # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rpc-accept",
            daemon=True)
        self._thread.start()
        bound_host, bound_port = self._server.server_address[:2]
        return f"{bound_host}:{bound_port}"

    def stop(self) -> None:
        """Stop accepting and close the listening socket (idempotent).

        In-flight handler threads are daemons parked on blocking reads of
        their own sockets; closing the server does not join them."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
