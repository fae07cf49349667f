"""On-host IPC between the agent and the training process — the port's
copy of dlrover_tpu/common/multi_process.py (the same wire protocol and
environment variables).

Reference parity: dlrover/python/common/multi_process.py — unix-socket
served `SharedLock` (:227), `SharedQueue` (:348), `SharedDict` (:455).
One `LocalSocketServer` runs in the agent process and hosts any number of
named locks/queues/dicts; trainer-side proxies speak a tiny pickled
request protocol. POSIX shared memory is handled separately by
`SharedMemorySegment` (mmap over /dev/shm — deliberately NOT
multiprocessing.shared_memory, whose resource tracker unlinks segments
when the *creating* process dies; flash checkpoint requires the segment
to outlive a crashed trainer).

The port reads its two directories when it uses them, not at import:
`DLROVER_TPU_SOCK_DIR` (default: `dlrover_tpu/sockets` under the temp
directory the environment names) and `DLROVER_TPU_SHM_DIR` (default
/dev/shm).
"""

import mmap
import os
import pickle
import queue as _queue
import socket
import socketserver
import struct
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

def socket_dir() -> str:
    return os.environ.get(
        "DLROVER_TPU_SOCK_DIR",
        os.path.join(tempfile.gettempdir(), "dlrover_tpu", "sockets"),
    )


def socket_path(job_name: str) -> str:
    d = socket_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{job_name}.sock")


# ---------------------------------------------------------------------------
# wire helpers: length-prefixed pickle frames
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, obj: Any):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# server (agent side)
# ---------------------------------------------------------------------------


class LocalSocketServer:
    """Hosts named locks, queues and dicts for one job on one host."""

    def __init__(self, job_name: str = "default"):
        self.path = socket_path(job_name)
        self._locks: Dict[str, threading.Lock] = {}
        self._lock_owners: Dict[str, str] = {}  # name -> acquire nonce
        self._queues: Dict[str, _queue.Queue] = {}
        self._dicts: Dict[str, dict] = {}
        self._meta_lock = threading.Lock()
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None

    # object accessors (server side) --------------------------------------

    def _lock(self, name) -> threading.Lock:
        with self._meta_lock:
            return self._locks.setdefault(name, threading.Lock())

    def _queue(self, name) -> _queue.Queue:
        with self._meta_lock:
            return self._queues.setdefault(name, _queue.Queue())

    def _dict(self, name) -> dict:
        with self._meta_lock:
            return self._dicts.setdefault(name, {})

    def _release_dead_owner(self, name: str, token: str):
        # only reap if the CURRENT holder is the acquire this dead
        # connection performed: a release that was retried over a fresh
        # socket (transient send error) leaves `name` in the dead
        # connection's held map, and blindly releasing here would yank
        # the lock from a different client that since acquired it
        with self._meta_lock:
            if self._lock_owners.get(name) != token:
                return
            self._lock_owners.pop(name, None)
        lock = self._lock(name)
        try:
            lock.release()
            logger.warning(
                "released lock %r held by disconnected client %s",
                name,
                token,
            )
        except RuntimeError:
            pass  # already released through the normal path

    # request handling -----------------------------------------------------

    def _handle(self, req: dict, conn_held: dict = None) -> Any:
        kind, name, op = req["kind"], req["name"], req["op"]
        if kind == "lock":
            lock = self._lock(name)
            if op == "acquire":
                ok = lock.acquire(
                    blocking=req.get("blocking", True),
                    timeout=req.get("timeout", -1),
                )
                if ok:
                    # the client's per-acquire nonce becomes the owner
                    # token: release and the dead-connection reaper
                    # both check it, so neither a release retried over
                    # a fresh socket nor a stale reap can yank the
                    # lock from a LATER holder
                    token = req.get("owner", "")
                    with self._meta_lock:
                        self._lock_owners[name] = token
                    if conn_held is not None:
                        conn_held[name] = token
                return ok
            if op == "release":
                # pop the ownership entry BEFORE releasing: releasing
                # first would let a concurrent acquirer write its
                # fresh token and then have it wiped, disarming the
                # reaper for that holder
                token = req.get("owner", "")
                with self._meta_lock:
                    cur = self._lock_owners.get(name)
                    if cur != token:
                        # Not ours to release. Covers: a retried
                        # release racing a new holder (cur is the new
                        # holder's nonce); a double/stray release
                        # (empty nonce); AND cur=None — every
                        # legitimate release follows an acquire whose
                        # handler wrote the owner before replying, so
                        # a missing entry means the lock was already
                        # released (or a new acquire is mid-handshake
                        # between lock.acquire() and its token write,
                        # which a blind release here would break).
                        return False
                    self._lock_owners.pop(name, None)
                if conn_held is not None:
                    conn_held.pop(name, None)
                try:
                    lock.release()
                    return True
                except RuntimeError:
                    return False
            if op == "locked":
                return lock.locked()
        elif kind == "queue":
            q = self._queue(name)
            if op == "put":
                q.put(req["value"])
                return True
            if op == "get":
                try:
                    return ("ok", q.get(timeout=req.get("timeout")))
                except _queue.Empty:
                    return ("empty", None)
            if op == "size":
                return q.qsize()
        elif kind == "dict":
            d = self._dict(name)
            if op == "set":
                d[req["key"]] = req["value"]
                return True
            if op == "get":
                return d.get(req["key"])
            if op == "update":
                d.update(req["value"])
                return True
            if op == "dump":
                return dict(d)
            if op == "pop":
                return d.pop(req["key"], None)
        elif kind == "server" and op == "ping":
            return "pong"
        raise ValueError(f"bad request {kind}/{op}")

    def start(self):
        if os.path.exists(self.path):
            os.unlink(self.path)
        handle = self._handle
        release_dead = self._release_dead_owner

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one connection, many requests
                held = {}  # name -> acquire token, THIS connection
                try:
                    while True:
                        try:
                            req = _recv_msg(self.request)
                        except (ConnectionError, EOFError):
                            return
                        try:
                            result = handle(req, held)
                            _send_msg(self.request, ("ok", result))
                        except Exception as e:  # noqa: BLE001
                            _send_msg(self.request, ("err", str(e)))
                finally:
                    # dead-owner reaping: a client that dies (e.g. the
                    # trainer SIGKILLed mid-save) must not leave a
                    # named lock held forever — the agent's teardown
                    # persist would deadlock on the shm lock
                    for name, token in held.items():
                        release_dead(name, token)

        self._server = socketserver.ThreadingUnixStreamServer(
            self.path, Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="local-ipc-server",
            daemon=True,
        )
        self._thread.start()
        logger.info("local IPC server on %s", self.path)

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)


# ---------------------------------------------------------------------------
# client proxies (trainer side)
# ---------------------------------------------------------------------------


class _Proxy:
    """Connections are PER THREAD (threading.local), not per proxy.

    A single shared socket would serialize all threads of a process
    through one server handler thread — and that handler blocks inline
    in `lock.acquire`, so two threads of one process contending on the
    same SharedLock (async ckpt staging vs. a concurrent restore; the
    saver loop vs. the agent's crash-path persist) would wedge the
    connection in a 4-way cycle: waiter stuck in recv holding the
    socket, holder's release stuck behind it, server stuck in acquire.
    With a connection per thread the blocked acquire occupies only its
    own handler thread and the holder's release flows independently.
    """

    kind = ""

    def __init__(self, name: str, job_name: str = "default"):
        self.name = name
        self.job_name = job_name
        self._tls = threading.local()

    def _connect(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(socket_path(self.job_name))
        self._tls.sock = s
        return s

    def _request(self, op: str, **kw) -> Any:
        for attempt in (0, 1):
            sock = getattr(self._tls, "sock", None)
            try:
                if sock is None:
                    sock = self._connect()
                _send_msg(
                    sock,
                    {
                        "kind": self.kind,
                        "name": self.name,
                        "op": op,
                        **kw,
                    },
                )
                status, result = _recv_msg(sock)
                if status == "err":
                    raise RuntimeError(result)
                return result
            except (ConnectionError, OSError):
                self._tls.sock = None
                if attempt:
                    raise
        raise AssertionError("unreachable: attempt 1 returns or raises")

    def close_thread(self):
        """Close the CALLING thread's connection (if any). Short-lived
        worker threads (async ckpt staging, replica backup) should call
        this on exit — otherwise their connection and the server handler
        thread parked on it linger until GC reclaims the dead thread."""
        sock = getattr(self._tls, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._tls.sock = None


class SharedLock(_Proxy):
    """Reference SharedLock multi_process.py:227.

    Every acquire carries a fresh nonce; the matching release sends it
    back. The server only honors a release whose nonce matches the
    current holder, so a release retried over a fresh socket after a
    transient send error can never release a DIFFERENT client's
    acquire. Acquire/release must pair within one thread (they do
    everywhere: `with lock:`)."""

    kind = "lock"

    def acquire(self, blocking=True, timeout=-1) -> bool:
        import uuid

        nonce = f"{os.getpid()}:{uuid.uuid4().hex}"
        ok = bool(
            self._request(
                "acquire",
                blocking=blocking,
                timeout=timeout,
                owner=nonce,
            )
        )
        if ok:
            self._tls.nonce = nonce
        return ok

    def release(self) -> bool:
        nonce = getattr(self._tls, "nonce", "")
        self._tls.nonce = ""
        return bool(self._request("release", owner=nonce))

    def locked(self) -> bool:
        return bool(self._request("locked"))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class SharedQueue(_Proxy):
    """Reference SharedQueue multi_process.py:348."""

    kind = "queue"

    def put(self, value: Any):
        self._request("put", value=value)

    def get(self, timeout: Optional[float] = None) -> Any:
        status, value = self._request("get", timeout=timeout)
        if status == "empty":
            raise _queue.Empty
        return value

    def qsize(self) -> int:
        return int(self._request("size"))

    def empty(self) -> bool:
        return self.qsize() == 0


class SharedDict(_Proxy):
    """Reference SharedDict multi_process.py:455."""

    kind = "dict"

    def set(self, key: str, value: Any):
        self._request("set", key=key, value=value)

    def get(self, key: str) -> Any:
        return self._request("get", key=key)

    def update(self, mapping: dict):
        self._request("update", value=mapping)

    def dump(self) -> dict:
        return self._request("dump")

    def pop(self, key: str) -> Any:
        return self._request("pop", key=key)


def server_alive(job_name: str, timeout: float = 1.0) -> bool:
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(socket_path(job_name))
        _send_msg(s, {"kind": "server", "name": "", "op": "ping"})
        status, result = _recv_msg(s)
        s.close()
        return result == "pong"
    except OSError:
        return False


# ---------------------------------------------------------------------------
# POSIX shared memory segment (mmap over /dev/shm)
# ---------------------------------------------------------------------------

def shm_dir() -> str:
    return os.environ.get("DLROVER_TPU_SHM_DIR", "/dev/shm")


class SharedMemorySegment:
    """Named byte buffer that survives the death of any single process.

    The segment is a plain file in /dev/shm (tmpfs) mapped with mmap —
    it persists until `unlink()` regardless of which process created it,
    which is the property flash checkpoint needs (reference keeps shm
    alive in the *agent*, ckpt_saver.py:210 SharedMemoryHandler).
    """

    def __init__(self, name: str, size: int = 0, create: bool = False):
        self.name = name
        self.path = os.path.join(shm_dir(), name.replace("/", "_"))
        if create:
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                st = os.fstat(fd)
                if size > st.st_size:
                    os.ftruncate(fd, size)
                self.size = max(size, st.st_size)
                self.ino = st.st_ino
                self.buf = mmap.mmap(fd, self.size)
            finally:
                os.close(fd)
        else:
            fd = os.open(self.path, os.O_RDWR)
            try:
                st = os.fstat(fd)
                self.size = st.st_size
                self.ino = st.st_ino
                self.buf = mmap.mmap(fd, self.size)
            finally:
                os.close(fd)

    def is_stale(self) -> bool:
        """True when the file at `path` is no longer the inode this
        mapping covers (unlinked + recreated) or changed size — grown
        means slices miss the new bytes; shrunk means touching pages
        past EOF SIGBUSes the process. Either way: re-attach."""
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            return True
        return st.st_ino != self.ino or st.st_size != self.size

    def close(self):
        try:
            self.buf.close()
        except BufferError:  # outstanding memoryviews
            pass

    def unlink(self):
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
