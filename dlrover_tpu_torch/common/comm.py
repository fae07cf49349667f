"""Control-plane RPC: one service, two calls (`report`, `get`).

The port's counterpart of dlrover_tpu/common/comm.py, with the same
interface and the same envelopes (`Envelope`, `ReplyEnvelope`, pickled
whole) over a transport of the Python standard library instead of
gRPC, which the port does not require. Reference parity:
dlrover/proto/elastic_training.proto `service Master` (report/get) +
dlrover/python/common/grpc.py.

Wire format, one TCP connection carrying calls one after another:
  request  = 1 byte verb (b"g" get, b"r" report) + 8-byte big-endian
             length + pickle(Envelope)
  reply    = 8-byte big-endian length + pickle(ReplyEnvelope)
Frames are capped at 256 MB, the JAX service's gRPC message limit.

The server (`build_master_server`) is a threading TCP server: one
handler thread per connection, so a slow call on one connection (a
rendezvous poll) never holds up another (a heartbeat), as the JAX
service's 64-thread gRPC pool serves calls side by side. The client
(`MasterStub`) keeps a pool of idle connections and takes one per
call, so threads that share a stub never interleave frames on one
socket. A refused connection, a reset, an early EOF, a timeout or an
oversized frame raises `RpcError`, which the master client retries as
the JAX client retries `grpc.RpcError`. All traffic is intra-job
control plane (master <-> agents), as in JAX.
"""

import pickle
import select
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Set

from dlrover_tpu_torch.common.log import default_logger as logger

MAX_MESSAGE_BYTES = 256 * 1024 * 1024
_GET, _REPORT = b"g", b"r"
_REQ_HEADER = struct.Struct("!cQ")
_REPLY_HEADER = struct.Struct("!Q")


@dataclass
class Envelope:
    """What actually crosses the wire for both RPCs."""

    node_id: int = -1
    node_type: str = ""
    payload: Any = None


@dataclass
class ReplyEnvelope:
    success: bool = True
    reason: str = ""
    payload: Any = None


class RpcError(Exception):
    """A call that did not complete: the master is unreachable, went
    away mid-call, timed out, or the frame broke the size cap. `code()`
    names the failure as gRPC's status codes do."""

    def __init__(self, code: str, detail: str = ""):
        super().__init__(f"{code}: {detail}" if detail else code)
        self._code = code

    def code(self) -> str:
        return self._code


def _dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def _loads(data: bytes):
    return pickle.loads(data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """`n` bytes, or None on EOF before the first byte; EOF inside the
    frame raises ConnectionError."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if not buf:
                return None
            raise ConnectionError("connection closed inside a frame")
        buf += chunk
    return bytes(buf)


class MasterServicerBase:
    """Subclass and implement get()/report(). Runs inside the master."""

    def get(self, envelope: Envelope) -> ReplyEnvelope:  # pragma: no cover
        raise NotImplementedError

    def report(self, envelope: Envelope) -> ReplyEnvelope:  # pragma: no cover
        raise NotImplementedError

    # transport-facing wrappers -------------------------------------------
    def _get_rpc(self, request: Envelope, context) -> ReplyEnvelope:
        try:
            return self.get(request)
        except Exception as e:  # noqa: BLE001 — control plane must not die
            logger.exception("error handling get(%s)", type(request.payload))
            return ReplyEnvelope(success=False, reason=str(e))

    def _report_rpc(self, request: Envelope, context) -> ReplyEnvelope:
        try:
            return self.report(request)
        except Exception as e:  # noqa: BLE001
            logger.exception(
                "error handling report(%s)", type(request.payload)
            )
            return ReplyEnvelope(success=False, reason=str(e))


class _Handler(socketserver.BaseRequestHandler):
    """Serves the calls of one connection until the peer closes it or
    the server stops."""

    def handle(self):
        server: MasterServer = self.server
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not server.stopping:
            try:
                header = _recv_exact(sock, _REQ_HEADER.size)
                if header is None:
                    return
                verb, size = _REQ_HEADER.unpack(header)
                if size > MAX_MESSAGE_BYTES or verb not in (_GET, _REPORT):
                    logger.warning(
                        "master RPC: bad frame (verb %r, %d bytes)",
                        verb,
                        size,
                    )
                    return
                data = _recv_exact(sock, size)
                if data is None:
                    return
            except OSError:
                return
            with server.calls:
                reply = server.dispatch(verb, data)
            try:
                sock.sendall(_REPLY_HEADER.pack(len(reply)) + reply)
            except OSError:
                return


class _InFlight:
    """Counts the calls being served, at most `limit` at a time (the
    JAX service's worker-pool size); `wait_idle` waits for none."""

    def __init__(self, limit: int):
        self._slots = threading.BoundedSemaphore(limit)
        self._cond = threading.Condition()
        self._n = 0

    def __enter__(self):
        self._slots.acquire()
        with self._cond:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._n -= 1
            self._cond.notify_all()
        self._slots.release()
        return False

    def wait_idle(self, timeout: float) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._n == 0, timeout)


class MasterServer(socketserver.ThreadingTCPServer):
    """The bound, not yet started, server `build_master_server` returns:
    `start()` serves in a daemon thread; `stop(grace)` stops accepting,
    lets calls in flight finish for up to `grace` seconds, then closes
    every connection and the listening socket, so the port is free for
    a restarted master at once and no client keeps talking to a
    stopped servicer."""

    allow_reuse_address = True  # SO_REUSEADDR: a restart rebinds at once
    daemon_threads = True
    block_on_close = False

    def __init__(self, servicer: MasterServicerBase, port: int,
                 max_workers: int):
        self.servicer = servicer
        self.stopping = False
        self.calls = _InFlight(max_workers)
        self._conns: Set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        super().__init__(("0.0.0.0", port), _Handler)

    # connection bookkeeping --------------------------------------------
    def process_request(self, request, client_address):
        with self._conns_lock:
            stopping = self.stopping
            if not stopping:
                self._conns.add(request)
        if stopping:
            self.shutdown_request(request)
            return
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def dispatch(self, verb: bytes, data: bytes) -> bytes:
        try:
            request = _loads(data)
        except Exception as e:  # noqa: BLE001
            return _dumps(
                ReplyEnvelope(success=False, reason=f"bad request: {e}")
            )
        if verb == _GET:
            reply = self.servicer._get_rpc(request, None)
        else:
            reply = self.servicer._report_rpc(request, None)
        try:
            out = _dumps(reply)
        except Exception as e:  # noqa: BLE001
            logger.exception("master RPC: reply does not pickle")
            out = _dumps(ReplyEnvelope(success=False, reason=str(e)))
        if len(out) > MAX_MESSAGE_BYTES:
            out = _dumps(ReplyEnvelope(
                success=False,
                reason=f"reply of {len(out)} bytes exceeds the "
                       f"{MAX_MESSAGE_BYTES}-byte cap",
            ))
        return out

    # lifecycle -----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="master-rpc",
            daemon=True,
        )
        self._thread.start()

    def stop(self, grace: Optional[float] = None):
        with self._conns_lock:
            if self.stopping:
                return
            self.stopping = True
        if self._thread is not None:
            self.shutdown()
            self._thread.join()
        self.server_close()
        self.calls.wait_idle(grace or 0.0)
        with self._conns_lock:
            conns: List[socket.socket] = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()


def build_master_server(
    servicer: MasterServicerBase,
    port: int,
    max_workers: int = 64,
) -> MasterServer:
    """Create (not start) the server hosting the 2-RPC service, bound
    to 0.0.0.0:`port` with SO_REUSEADDR."""
    try:
        return MasterServer(servicer, port, max_workers)
    except OSError as e:
        raise RuntimeError(f"cannot bind master RPC port {port}") from e


class MasterStub:
    """Low-level client for the 2-RPC service (used by MasterClient).

    Each call takes an idle connection from the pool (or opens one) and
    puts it back after the reply, so concurrent threads each use their
    own socket. An idle connection the master has closed meanwhile (it
    stopped) reads as ready: it is dropped before the call, not after a
    half-sent request, and a fresh one is opened in its place."""

    def __init__(self, addr: str, timeout: float = 30.0):
        self._addr = addr
        host, port = addr.rsplit(":", 1)
        self._target = (host, int(port))
        self._timeout = timeout
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    @property
    def addr(self) -> str:
        return self._addr

    def _take(self, timeout: float) -> socket.socket:
        while True:
            with self._lock:
                sock = self._idle.pop() if self._idle else None
            if sock is None:
                break
            readable, _, _ = select.select([sock], [], [], 0)
            if not readable:
                sock.settimeout(timeout)
                return sock
            sock.close()  # EOF or a reset waiting: the master went away
        try:
            sock = socket.create_connection(self._target, timeout=timeout)
        except socket.timeout as e:
            raise RpcError("DEADLINE_EXCEEDED", f"connect: {e}") from e
        except OSError as e:
            raise RpcError("UNAVAILABLE", f"connect {self._addr}: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _put(self, sock: socket.socket):
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        sock.close()

    def _call(self, verb: bytes, payload, node_id, node_type,
              timeout) -> ReplyEnvelope:
        req = _dumps(
            Envelope(node_id=node_id, node_type=node_type, payload=payload)
        )
        if len(req) > MAX_MESSAGE_BYTES:
            raise RpcError(
                "RESOURCE_EXHAUSTED",
                f"request of {len(req)} bytes exceeds the "
                f"{MAX_MESSAGE_BYTES}-byte cap",
            )
        timeout = timeout or self._timeout
        sock = self._take(timeout)
        try:
            sock.sendall(_REQ_HEADER.pack(verb, len(req)) + req)
            header = _recv_exact(sock, _REPLY_HEADER.size)
            if header is None:
                raise ConnectionError("connection closed before the reply")
            (size,) = _REPLY_HEADER.unpack(header)
            if size > MAX_MESSAGE_BYTES:
                raise RpcError("RESOURCE_EXHAUSTED", f"reply of {size} bytes")
            data = _recv_exact(sock, size)
            if data is None:
                raise ConnectionError("connection closed before the reply")
        except RpcError:
            sock.close()
            raise
        except socket.timeout as e:
            sock.close()
            raise RpcError("DEADLINE_EXCEEDED", str(e)) from e
        except OSError as e:
            sock.close()
            raise RpcError("UNAVAILABLE", str(e)) from e
        self._put(sock)
        return _loads(data)

    def get(
        self, payload, node_id=-1, node_type="", timeout=None
    ) -> ReplyEnvelope:
        return self._call(_GET, payload, node_id, node_type, timeout)

    def report(
        self, payload, node_id=-1, node_type="", timeout=None
    ) -> ReplyEnvelope:
        return self._call(_REPORT, payload, node_id, node_type, timeout)

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            sock.close()
