"""ttrpc, the RPC that containerd's NRI rides on, over the port's own codec.

The port of the JAX package's `util/ttrpc.py:43-394` (`Connection`,
`Mux`, `MuxChannel`, `MuxedPeer`, `TtrpcServer`, `dial`), with the
envelope messages of `kubeletplugin/api/nri_messages.py` in place of the
generated `ttrpc_pb2`, so it runs where protobuf is not installed.

The wire: each message is a 10-byte big-endian header (u32 payload
length, u32 stream id, u8 type: 1 request, 2 response, u8 flags) and a
payload, a `Request` on the way in and a `Response` on the way out. A
connection is full duplex: both ends originate requests (an NRI plugin
calls Runtime.RegisterPlugin while it serves Plugin requests), with odd
stream ids from the end that dialled and even ones from the end that
accepted. The NRI socket multiplexes two such byte streams over one unix
socket: every chunk carries a u32 connection id and a u32 length
(`Mux`), the runtime calling the plugin on one id and the plugin calling
the runtime on the other.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Callable

from vtpu_manager_torch.kubeletplugin.api import nri_messages as msg

log = logging.getLogger(__name__)

_HEADER = struct.Struct(">IIBB")
MSG_REQUEST = 0x1
MSG_RESPONSE = 0x2
MAX_MESSAGE = 4 << 20

# google.rpc codes used on the wire
CODE_OK = 0
CODE_UNKNOWN = 2
CODE_NOT_FOUND = 5


class TtrpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"ttrpc error {code}: {message}")
        self.code = code
        self.message = message


# payload bytes -> response payload bytes (raise TtrpcError for a status)
Handler = Callable[[bytes], bytes]


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class _PendingCall:
    def __init__(self):
        self.done = threading.Event()
        self.raw: bytes | None = None


class Connection:
    """One full-duplex ttrpc connection: it serves `handlers` and makes
    calls."""

    def __init__(self, sock,
                 handlers: dict[tuple[str, str], Handler] | None = None,
                 initiator: bool = True):
        self._sock = sock
        self.handlers = handlers or {}
        self._write_lock = threading.Lock()
        self._calls_lock = threading.Lock()
        self._calls: dict[int, _PendingCall] = {}
        self._next_stream = 1 if initiator else 2
        self.closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="ttrpc-read")
        self._reader.start()

    def _send(self, stream_id: int, msg_type: int, payload: bytes) -> None:
        frame = _HEADER.pack(len(payload), stream_id, msg_type, 0) + payload
        with self._write_lock:      # a torn frame corrupts the stream
            self._sock.sendall(frame)

    def _read_loop(self) -> None:
        while True:
            head = _recv_exact(self._sock, _HEADER.size)
            if head is None:
                break
            length, stream_id, msg_type, _flags = _HEADER.unpack(head)
            if length > MAX_MESSAGE:
                log.error("ttrpc frame too large (%d bytes)", length)
                break
            payload = _recv_exact(self._sock, length)
            if payload is None:
                break
            if msg_type == MSG_REQUEST:
                threading.Thread(target=self._serve_one,
                                 args=(stream_id, payload),
                                 daemon=True).start()
            elif msg_type == MSG_RESPONSE:
                self._complete(stream_id, payload)
        self.closed.set()
        with self._calls_lock:
            for call in self._calls.values():
                call.done.set()
            self._calls.clear()

    def _serve_one(self, stream_id: int, raw: bytes) -> None:
        resp = msg.Response()
        try:
            req = msg.Request.decode(raw)
            handler = self.handlers.get((req.service, req.method))
            if handler is None:
                raise TtrpcError(CODE_NOT_FOUND, f"{req.service}/{req.method}")
            resp.payload = handler(req.payload)
        except TtrpcError as e:
            resp.status = msg.Status(code=e.code, message=e.message)
        except Exception as e:  # noqa: BLE001 - a handler's bug is a status
            log.exception("ttrpc handler failed")
            resp.status = msg.Status(code=CODE_UNKNOWN,
                                     message=f"{type(e).__name__}: {e}")
        try:
            self._send(stream_id, MSG_RESPONSE, resp.encode())
        except OSError:
            pass

    def call(self, service: str, method: str, payload: bytes,
             timeout_s: float = 10.0) -> bytes:
        with self._calls_lock:
            stream_id = self._next_stream
            self._next_stream += 2
            pending = _PendingCall()
            self._calls[stream_id] = pending
        req = msg.Request(service=service, method=method, payload=payload,
                          timeout_nano=int(timeout_s * 1e9))
        self._send(stream_id, MSG_REQUEST, req.encode())
        if not pending.done.wait(timeout_s):
            with self._calls_lock:
                self._calls.pop(stream_id, None)
            raise TtrpcError(CODE_UNKNOWN, f"{service}/{method} timed out")
        if pending.raw is None:
            raise TtrpcError(CODE_UNKNOWN, "connection closed")
        resp = msg.Response.decode(pending.raw)
        if resp.status is not None and resp.status.code != CODE_OK:
            raise TtrpcError(resp.status.code, resp.status.message)
        return resp.payload

    def _complete(self, stream_id: int, raw: bytes) -> None:
        with self._calls_lock:
            call = self._calls.pop(stream_id, None)
        if call is None:
            log.warning("ttrpc response for unknown stream %d", stream_id)
            return
        call.raw = raw
        call.done.set()

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# -- the NRI socket's multiplexing ------------------------------------------------

_MUX_HEADER = struct.Struct(">II")   # connection id, payload length

# containerd/nri pkg/net/multiplex: the runtime calls the plugin on one id,
# the plugin calls the runtime on the other
MUX_PLUGIN_CONN = 1
MUX_RUNTIME_CONN = 2


class MuxChannel:
    """One connection id of a Mux, as the socket a Connection reads and
    writes."""

    def __init__(self, mux: "Mux", conn_id: int):
        self._mux = mux
        self.conn_id = conn_id
        self._buf = b""
        self._pending: list[bytes] = []
        self._cv = threading.Condition()
        self._closed = False

    def _deliver(self, payload: bytes) -> None:
        with self._cv:
            self._pending.append(payload)
            self._cv.notify_all()

    def _close_read(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def recv(self, n: int) -> bytes:
        with self._cv:
            while not self._buf and not self._pending and not self._closed:
                self._cv.wait()
            if not self._buf and self._pending:
                self._buf = b"".join(self._pending)
                self._pending.clear()
            out, self._buf = self._buf[:n], self._buf[n:]
            return out

    def sendall(self, data: bytes) -> None:
        self._mux.send(self.conn_id, data)

    def shutdown(self, how: int) -> None:
        pass   # the mux owns the socket

    def close(self) -> None:
        self._close_read()


class Mux:
    """Independent byte streams over one unix socket, each chunk prefixed
    with its connection id and length."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._write_lock = threading.Lock()
        self._channels_lock = threading.Lock()
        self._channels: dict[int, MuxChannel] = {}
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="ttrpc-mux")
        self._reader.start()

    def channel(self, conn_id: int) -> MuxChannel:
        with self._channels_lock:
            ch = self._channels.get(conn_id)
            if ch is None:
                ch = self._channels[conn_id] = MuxChannel(self, conn_id)
            return ch

    def send(self, conn_id: int, data: bytes) -> None:
        frame = _MUX_HEADER.pack(conn_id, len(data)) + data
        with self._write_lock:      # whole frames on the shared socket
            self._sock.sendall(frame)

    def _read_loop(self) -> None:
        while True:
            head = _recv_exact(self._sock, _MUX_HEADER.size)
            if head is None:
                break
            conn_id, length = _MUX_HEADER.unpack(head)
            if length > MAX_MESSAGE:
                log.error("mux frame too large (%d bytes)", length)
                break
            payload = _recv_exact(self._sock, length)
            if payload is None:
                break
            self.channel(conn_id)._deliver(payload)
        with self._channels_lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch._close_read()

    def alive(self) -> bool:
        """Whether the peer still holds the connection (the read loop ends
        at EOF or an error)."""
        return self._reader.is_alive()

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class MuxedPeer:
    """The runtime's end of one muxed NRI connection: it serves requests
    on the runtime channel and calls the plugin on the plugin channel."""

    def __init__(self, sock: socket.socket,
                 handlers: dict[tuple[str, str], Handler]):
        self.mux = Mux(sock)
        self.serve_conn = Connection(self.mux.channel(MUX_RUNTIME_CONN),
                                     handlers, initiator=False)
        self._call_conn = Connection(self.mux.channel(MUX_PLUGIN_CONN),
                                     initiator=True)

    def call(self, service: str, method: str, payload: bytes,
             timeout_s: float = 10.0) -> bytes:
        return self._call_conn.call(service, method, payload, timeout_s)

    def close(self) -> None:
        self.mux.close()


class TtrpcServer:
    """A unix-socket acceptor. With `mux=True` (the NRI socket's shape)
    each accepted socket is split into the two NRI channels; otherwise
    each is one full-duplex ttrpc connection."""

    def __init__(self, path: str,
                 handlers: dict[tuple[str, str], Handler],
                 mux: bool = False):
        self.path = path
        self.handlers = handlers
        self.mux = mux
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(8)
        self.connections: list[Connection | MuxedPeer] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="ttrpc-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break
            if self.mux:
                self.connections.append(MuxedPeer(sock, self.handlers))
            else:
                self.connections.append(
                    Connection(sock, self.handlers, initiator=False))

    def wait_for_connection(self, timeout_s: float = 5.0):
        """The first peer's connection, once one has connected (TtrpcError
        after `timeout_s`)."""
        deadline = time.monotonic() + timeout_s
        while not self.connections:
            if time.monotonic() >= deadline:
                raise TtrpcError(CODE_UNKNOWN,
                                 "no peer connected within timeout")
            time.sleep(0.01)
        return self.connections[0]

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)   # wakes accept()
        except OSError:
            pass
        self._listener.close()
        for conn in self.connections:
            conn.close()


def dial(path: str, handlers: dict[tuple[str, str], Handler] | None = None
         ) -> Connection:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(path)
    return Connection(sock, handlers, initiator=True)
