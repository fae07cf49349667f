"""`dlrover-tpu-run` for the port — the elastic launcher CLI (the
dlrover-run / torchrun analogue), the port's copy of
dlrover_tpu/trainer/elastic_run.py.

Reference parity: dlrover/trainer/torch/elastic_run.py (`elastic_launch`
:197, `run` :351, `main` :400, `_launch_dlrover_local_master` :245) +
setup.py:58 console script. Behavior kept: if no master address is
configured (env or --master-addr), node 0 starts a DistributedJobMaster
in the launcher process, then runs the elastic agent which supervises
the training script.

Usage:
    python -m dlrover_tpu_torch.trainer.elastic_run
           [--nnodes MIN[:MAX]] [--node-id N] [--max-restarts K]
           [--network-check] [--master-addr HOST:PORT] script.py args...
"""

import argparse
import os
import socket
import sys
import time
from contextlib import closing
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.training import ElasticLaunchConfig, launch_agent
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import addr_connected


def parse_nnodes(value: str) -> Tuple[int, int]:
    try:
        if ":" in value:
            lo, hi = value.split(":", 1)
            lo, hi = int(lo), int(hi)
        else:
            lo = hi = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--nnodes must be 'N' or 'MIN:MAX', got {value!r}"
        ) from None
    if lo < 1 or hi < lo:
        raise argparse.ArgumentTypeError(
            f"--nnodes range invalid: {value!r} (need 1 <= MIN <= MAX)"
        )
    return lo, hi


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dlrover-tpu-torch-run", description=__doc__.split("\n")[0]
    )
    p.add_argument(
        "--nnodes",
        default=(1, 1),
        type=parse_nnodes,
        help="'N' or 'MIN:MAX' elastic host range",
    )
    p.add_argument("--node-id", type=int, default=None)
    p.add_argument("--nproc-per-node", type=int, default=1)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--master-addr", default=None)
    p.add_argument(
        "--network-check",
        action="store_true",
        help="pre-flight compute/collective bench before training",
    )
    p.add_argument(
        "--node-unit",
        type=int,
        default=1,
        help="world size must be a multiple of this",
    )
    p.add_argument("--job-name", default="tpujob")
    p.add_argument("--log-dir", default=None)
    p.add_argument(
        "--rdzv-timeout", type=float, default=600.0
    )
    p.add_argument("script", help="training script (or module with -m)")
    p.add_argument(
        "script_args", nargs=argparse.REMAINDER, default=[]
    )
    return p


def _local_port(addr: str) -> int:
    """The port of `addr` ("host:port") where its host is an address of
    this machine (one a socket here can bind), else 0 (a free port): a
    configured address without a port, with a port that is no number,
    or naming another host (a stale MASTER_ADDR) gives 0."""
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        return 0
    try:
        with closing(socket.socket(
                socket.AF_INET6 if ":" in host else socket.AF_INET)) as s:
            s.bind((host.strip("[]"), 0))
    except OSError:
        return 0
    return int(port)


def _resolve_master(
    args, min_nodes: int, max_nodes: int, node_id: int
):
    """Find or create the master. Returns (addr, master_or_None).

    Reference `run` elastic_run.py:351: env/flag master wins if reachable;
    otherwise node 0 hosts a local master in-process (reference spawns a
    subprocess; in-process is equivalent and simpler to supervise since
    the agent itself is already a daemon per host). Node 0 binds that
    master to the configured address's port where that address is this
    machine's (`_local_port`; JAX's picks a free port), so the other
    nodes' launchers, given the same --master-addr, find it: two agents
    on one machine form a world of two that way.
    """
    addr = args.master_addr or os.environ.get(NodeEnv.MASTER_ADDR, "")
    if addr and addr_connected(addr):
        return addr, None
    if addr:
        logger.warning("configured master %s unreachable", addr)
    if node_id != 0:
        # non-zero nodes must be given a reachable master
        deadline = time.monotonic() + 60
        while addr and time.monotonic() < deadline:
            if addr_connected(addr):
                return addr, None
            time.sleep(1)
        raise RuntimeError(
            "no reachable master; set --master-addr or "
            f"{NodeEnv.MASTER_ADDR}"
        )
    from dlrover_tpu_torch.master.master import DistributedJobMaster

    master = DistributedJobMaster(
        port=_local_port(addr),
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_unit=args.node_unit,
        job_name=args.job_name,
    )
    master.start()
    logger.info("started local job master at %s", master.addr)
    return master.addr, master


def run(args) -> int:
    min_nodes, max_nodes = args.nnodes
    node_id = (
        args.node_id
        if args.node_id is not None
        else int(os.environ.get(NodeEnv.NODE_ID, 0))
    )
    addr, master = _resolve_master(args, min_nodes, max_nodes, node_id)

    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        max_restarts=args.max_restarts,
        network_check=args.network_check,
        node_unit=args.node_unit,
        job_name=args.job_name,
        log_dir=args.log_dir,
        rdzv_timeout=args.rdzv_timeout,
    )
    entrypoint = [sys.executable, args.script] + list(args.script_args)
    if args.script.endswith(".py") is False and "/" not in args.script:
        # allow console-script / binary entrypoints too
        entrypoint = [args.script] + list(args.script_args)
    try:
        code = launch_agent(
            config, entrypoint, master_addr=addr, node_id=node_id
        )
    finally:
        if master is not None:
            master.stop()
    return code


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
