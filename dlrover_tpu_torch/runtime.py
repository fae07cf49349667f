"""Worker-side runtime bootstrap — the counterpart of dlrover_tpu/runtime.py.

Reference parity: the reference's workers (re)build the collective
runtime after every rendezvous — torchelastic assigns ranks and the
training process calls `init_process_group` with the rendezvous store
(dlrover/python/elastic_agent/torch/training.py:253 `next_rendezvous`,
:488 `_assign_worker_ranks`; atorch/atorch/distributed/distributed.py:664
`init_distributed`, :796 `reset_distributed`).

The per-host agent exports the coordination env
(DLROVER_TPU_COORDINATOR_ADDR / NODE_RANK / NODE_NUM / RDZV_ROUND — see
agent/training.py `_worker_env`) and `dlrover_tpu_torch.init()` consumes
it: with more than one node it joins a `torch.distributed` world over
TCP at the coordinator (the rank-0 agent's host and port), on gloo
under DLROVER_TPU_FORCE_CPU=1 and on NCCL on the card (`device()`: the
agent runs one worker a node, and a worker trains on one card); with
one node it only records the context (`join_world` joins a world of
one where a caller wants one). NCCL refuses two ranks on one card
("Duplicate GPU detected"), so a world of several processes on a
machine with one card (a test of the data-parallel path) needs gloo
there: DLROVER_TPU_TORCH_DIST_BACKEND=gloo asks for it, and is logged;
the backend never changes on its own. A new rendezvous round means a
fresh worker process (the agent restarts it), so `init()` is normally
called once per process; `shutdown()` + `init()` re-inits in process.

Because workers cannot outlive their world (a peer's death leaves
collectives hanging until a timeout fires), the worker also runs a
`MembershipWatch`: a thread polling the master's rendezvous state; the
moment the world is invalidated (a member died), a newer round formed
or nodes are waiting to join, the worker exits with
MEMBERSHIP_RESTART_EXIT_CODE so its agent re-rendezvouses at once.

What the compile cache is here: the port's compiled artefacts are the
kernel libraries `ops/_build.py` builds with nvcc. `enable_compile_cache`
keeps JAX's env contract over their directory, so a respawned worker
loads the libraries an earlier process built and never runs nvcc.
"""

import atexit
import datetime
import os
import threading
from typing import Callable, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger

# Worker exit code meaning "restart me into a new rendezvous round" —
# the agent treats it as a membership restart, not a failure.
MEMBERSHIP_RESTART_EXIT_CODE = 77
COMPILE_CACHE_ENV = "DLROVER_TPU_COMPILE_CACHE"
# seconds a collective (and the world's join) may wait for a peer, so
# a dead peer cannot hold a survivor for gloo's default 30 minutes
DIST_TIMEOUT_SECS = 600.0
# the one override of the backend: "gloo" on the card (see the module)
DIST_BACKEND_ENV = "DLROVER_TPU_TORCH_DIST_BACKEND"


class RuntimeContext:
    """What this process knows about its place in the job."""

    def __init__(self):
        self.initialized = False
        self.coordinator_addr: Optional[str] = None
        self.node_rank = 0
        self.node_num = 1
        self.rdzv_round = 0
        self.backend: Optional[str] = None
        self.watch: Optional["MembershipWatch"] = None

    def reset(self):
        self.initialized = False
        self.coordinator_addr = None
        self.backend = None


_ctx = RuntimeContext()


def context() -> RuntimeContext:
    return _ctx


def is_initialized() -> bool:
    return _ctx.initialized


def node_rank() -> int:
    return _ctx.node_rank


def node_count() -> int:
    return _ctx.node_num


def enable_compile_cache() -> Optional[str]:
    """Point the kernel build directory where DLROVER_TPU_COMPILE_CACHE
    says, JAX's contract over the port's compiled artefact.

    DLROVER_TPU_COMPILE_CACHE, when set, always wins: a path overrides
    any directory already in effect, "0"/"off"/"none" disables (each
    process then builds into a directory of its own). With the variable
    unset, a directory already in effect is kept (by default the
    package's `_build/`). Returns the directory in effect (None =
    disabled)."""
    from pathlib import Path

    from dlrover_tpu_torch.ops import _build

    want = os.environ.get(COMPILE_CACHE_ENV, "")
    if want.lower() in ("0", "off", "none"):
        _build.BUILD_DIR = None
        return None
    current = _build.BUILD_DIR
    if current and not want:
        return str(current)
    cache_dir = want or str(_build.DEFAULT_BUILD_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        logger.warning("kernel build directory %s unavailable", cache_dir,
                       exc_info=True)
        return None
    _build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def _backend() -> str:
    """gloo on the CPU, NCCL on the card, gloo on the card only where
    DLROVER_TPU_TORCH_DIST_BACKEND=gloo asks for it."""
    from dlrover_tpu_torch.utils.platform import cpu_forced

    want = os.environ.get(DIST_BACKEND_ENV, "")
    if want:
        if want != "gloo":
            raise ValueError(
                f"{DIST_BACKEND_ENV}={want!r}: the one override is 'gloo'")
        if not cpu_forced():
            logger.warning(
                "%s=gloo: collectives on the card's tensors go through "
                "gloo, not NCCL (several ranks on one card)",
                DIST_BACKEND_ENV)
        return "gloo"
    return "gloo" if cpu_forced() else "nccl"


def wire_tensor(t, group, p2p: bool = False):
    """The tensor a collective of `group` reads and writes for `t`, by
    the group's backend: NCCL moves card tensors only, so a host tensor
    (torch Adam keeps its step counts there) goes through a copy on the
    card; gloo's all_reduce, broadcast and all_gather take tensors on
    either device, but its send / recv (`p2p`) read a tensor's pointer
    as host memory (torch 2.11's gloo fails on a card tensor with "Bad
    address"), so a point-to-point payload goes through a host copy
    (none where `t` is on the host already). Anything else is `t`."""
    import torch
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "nccl" and t.device.type == "cpu":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    if backend == "gloo" and p2p:
        return t.cpu()
    return t


def device():
    """This worker's device: the CPU under DLROVER_TPU_FORCE_CPU=1, else
    the card (one a worker), made the current CUDA device."""
    import torch

    from dlrover_tpu_torch.utils.platform import ensure_cpu_if_forced

    dev = ensure_cpu_if_forced()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def join_world(addr: str, world_size: int, rank: int) -> RuntimeContext:
    """`torch.distributed.init_process_group` over TCP at `addr`, on
    `_backend()`, with DIST_TIMEOUT_SECS on the join and every
    collective; what `init()` does for a job of several nodes, and what
    a caller does for a world of one rank. The card is made the current
    device first (NCCL's communicators bind to it)."""
    import torch.distributed as dist

    backend = _backend()
    if backend == "nccl":
        device()
    logger.info(
        "init_process_group(%s) coordinator=%s rank=%d/%d",
        backend,
        addr,
        rank,
        world_size,
    )
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{addr}",
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_SECS),
    )
    _ctx.initialized = True
    _ctx.coordinator_addr = addr
    _ctx.node_rank, _ctx.node_num = rank, world_size
    _ctx.backend = backend
    atexit.register(_shutdown_quietly)
    return _ctx


def init(
    coordinator_addr: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    membership_watch: bool = True,
    watch_interval: float = 1.0,
) -> RuntimeContext:
    """Join the world the agent rendezvoused for this process.

    Reads DLROVER_TPU_COORDINATOR_ADDR / NODE_RANK / NODE_NUM (exported
    by the agent, agent/training.py `_worker_env`) unless overridden,
    and with more than one node calls
    `torch.distributed.init_process_group(init_method="tcp://<addr>")`.
    Single-node jobs (NODE_NUM == 1 or no coordinator) only record the
    context, so user scripts can call `dlrover_tpu_torch.init()`
    unconditionally. DIST_TIMEOUT_SECS bounds the join and every
    collective.

    Re-init: if the process is already initialized with different
    coordinates, the previous world is destroyed first (the
    `reset_distributed` path in the reference).
    """
    enable_compile_cache()
    addr = coordinator_addr or os.environ.get(NodeEnv.COORDINATOR_ADDR)
    num = (
        num_processes
        if num_processes is not None
        else int(os.environ.get(NodeEnv.NODE_NUM, "1"))
    )
    rank = (
        process_id
        if process_id is not None
        else int(os.environ.get(NodeEnv.NODE_RANK, "0"))
    )
    _ctx.node_rank = rank
    _ctx.node_num = num
    _ctx.rdzv_round = int(
        os.environ.get("DLROVER_TPU_RDZV_ROUND", "0")
    )
    if num > 1 and addr:
        if _ctx.initialized:
            if _ctx.coordinator_addr == addr and _ctx.node_num == num:
                return _ctx  # idempotent
            shutdown()
        join_world(addr, num, rank)
    else:
        _ctx.initialized = False
        _ctx.coordinator_addr = None
    if membership_watch and os.environ.get(NodeEnv.MASTER_ADDR):
        start_membership_watch(interval=watch_interval)
    return _ctx


def shutdown():
    """Tear down the distributed runtime (re-init support)."""
    if _ctx.watch is not None:
        _ctx.watch.stop()
        _ctx.watch = None
    if _ctx.initialized:
        import torch.distributed as dist

        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — peer may already be gone
            logger.warning("destroy_process_group failed", exc_info=True)
        _ctx.reset()


def _shutdown_quietly():
    try:
        if _ctx.initialized:
            import torch.distributed as dist

            dist.destroy_process_group()
            _ctx.reset()
    except Exception:  # noqa: BLE001
        pass


class MembershipWatch:
    """Poll the master rendezvous state; exit when the world is stale.

    Stale means: a member of our world died (the master invalidated the
    world — rendezvous.remove_node), a newer round formed without us, or
    nodes are waiting to join. The agent supervising this process
    understands MEMBERSHIP_RESTART_EXIT_CODE and restarts us into the
    next round without burning a failure-restart budget.
    """

    def __init__(
        self,
        client=None,
        interval: float = 1.0,
        on_change: Optional[Callable[[], None]] = None,
    ):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        self.client = client or MasterClient.singleton()
        self.interval = interval
        self.on_change = on_change or self._default_exit
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_exit():
        logger.info(
            "membership change detected — exiting for re-rendezvous "
            "(code %d)",
            MEMBERSHIP_RESTART_EXIT_CODE,
        )
        os._exit(MEMBERSHIP_RESTART_EXIT_CODE)

    def _stale(self) -> bool:
        try:
            st = self.client.rdzv_state()
        except Exception:  # noqa: BLE001 — master briefly unreachable
            return False
        if st.waiting_num > 0:
            return True
        if st.round > _ctx.rdzv_round:
            return True  # a newer world formed without us
        if st.round == _ctx.rdzv_round and st.world_size == 0:
            return True  # our world was invalidated (member death)
        return False

    def _loop(self):
        while not self._stop.is_set():
            if self._stale():
                self.on_change()
                return
            self._stop.wait(self.interval)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="membership-watch", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stop.set()


def start_membership_watch(
    client=None,
    interval: float = 1.0,
    on_change: Optional[Callable[[], None]] = None,
) -> MembershipWatch:
    if _ctx.watch is not None:
        return _ctx.watch
    watch = MembershipWatch(
        client=client, interval=interval, on_change=on_change
    )
    watch.start()
    _ctx.watch = watch
    return watch
