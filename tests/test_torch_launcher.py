"""The port's launcher, `python -m dlrover_tpu_torch.trainer.elastic_run`
(dlrover_tpu_torch/trainer/elastic_run.py), end to end on the CPU under
DLROVER_TPU_FORCE_CPU=1: a SIGTERM to the launcher's process, an
always-failing script, and the port's tiny-Llama example crashing at
step 10 and resuming from the agent's shared memory. The parity of the
agent underneath with the JAX package's is held in test_torch_agent.py.
"""

import functools
import os
import signal
import subprocess
import sys
import threading
import uuid

import pytest

from dlrover_tpu_torch.agent import training as ttraining
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.trainer import elastic_run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Each test's shm segments and IPC sockets in its own directory."""
    (tmp_path / "shm").mkdir()
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path / "shm"))
    monkeypatch.setenv("DLROVER_TPU_SOCK_DIR", str(tmp_path / "sock"))


def _job():
    return f"launcher-{uuid.uuid4().hex[:8]}"


def _launch(monkeypatch, args):
    """`elastic_run.main` in this process on `args`, as a user's
    `python -m dlrover_tpu_torch.trainer.elastic_run --nnodes 1 ...`
    runs it, the agent polling its worker every 0.05 s (JAX's lifecycle
    tests shorten the interval through ElasticLaunchConfig the same
    way). Returns (exit code, the master the launcher started)."""
    masters = []
    resolve = trun._resolve_master

    def _resolve(*a, **kw):
        addr, master = resolve(*a, **kw)
        masters.append(master)
        return addr, master

    monkeypatch.setattr(trun, "_resolve_master", _resolve)
    monkeypatch.setattr(trun, "ElasticLaunchConfig", functools.partial(
        ttraining.ElasticLaunchConfig, monitor_interval=0.05))
    monkeypatch.setenv("DLROVER_TPU_FORCE_CPU", "1")
    handler = signal.getsignal(signal.SIGTERM)
    try:
        rc = trun.main(["--nnodes", "1", "--job-name", _job(), *args])
    finally:
        signal.signal(signal.SIGTERM, handler)
    return rc, masters[0]


def test_sigterm_to_the_launcher_is_a_graceful_leave(tmp_path):
    """The launcher as its own process (the signal is what is under
    test), at the default poll interval: SIGTERM stops the worker and
    the launcher exits 0."""
    script = tmp_path / "train.py"
    script.write_text("import time\nprint('training-started', flush=True)\n"
                      "time.sleep(120)\n")
    env = {**os.environ, "DLROVER_TPU_FORCE_CPU": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--nnodes", "1", "--max-restarts", "1", "--job-name", _job(),
         str(script)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
    lines, started = [], threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if "training-started" in line:
                started.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        assert started.wait(timeout=60), "".join(lines)[-2000:]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        t.join(timeout=10)
        full = "".join(lines)
        assert "graceful leave" in full, full[-2000:]
        assert proc.returncode == 0, (proc.returncode, full[-2000:])
    finally:
        if proc.poll() is None:
            proc.kill()


def test_launcher_failure_propagates_the_workers_code(tmp_path, monkeypatch):
    """An always-failing script: the one restart spent, the launcher
    exits with the script's own code and its master marks the node
    fatal_error."""
    script = tmp_path / "f.py"
    script.write_text("import sys\nsys.exit(5)\n")
    rc, master = _launch(monkeypatch, ["--max-restarts", "1", str(script)])
    assert rc == 5
    node = master.servicer.node_manager.get_node("worker", 0)
    assert (node.status, node.exit_reason) == (NodeStatus.FAILED,
                                               "fatal_error")
    assert [r.error_data for r in master.servicer.error_monitor.recent()
            ] == ["worker exit code 5"] * 2


def test_launcher_crash_and_resume_from_the_agents_shm(tmp_path, monkeypatch):
    """The port's tiny-Llama example through the launcher on the CPU:
    the first attempt dies at step 10, the agent persists the staged
    step and restarts it, the second resumes from the agent's shared
    memory and finishes."""
    ckpt = tmp_path / "ckpt"
    logs = tmp_path / "logs"
    example = os.path.join(REPO, "dlrover_tpu_torch", "examples",
                           "train_tiny_llama.py")
    rc, master = _launch(monkeypatch, [
        "--max-restarts", "2", "--log-dir", str(logs), example,
        "--steps", "12", "--crash-at-step", "10", "--ckpt-dir", str(ckpt)])
    out = [(logs / f"worker_0_r{a}.log").read_text() for a in (0, 1)]
    assert rc == 0, out
    assert "injected crash at step 10" in out[0]
    resumed = [int(line.split()[-1]) for line in out[1].splitlines()
               if line.startswith("resumed from step")]
    # the staged step is 9, or 8 where step 9's staging was in flight
    assert len(resumed) == 1 and resumed[0] in (8, 9), out
    assert "restore source: memory" in out[1]
    assert "done: restart_count=1" in out[1]
    # the crash path persisted the staged step before the restart
    assert (ckpt / str(resumed[0])).is_dir()
    node = master.servicer.node_manager.get_node("worker", 0)
    assert node.status == NodeStatus.SUCCEEDED


@pytest.mark.parametrize("addr, want", [
    ("127.0.0.1:4321", 4321),
    ("localhost:4321", 4321),
    ("127.0.0.1", 0),            # no port
    ("127.0.0.1:", 0),
    ("127.0.0.1:http", 0),
    ("192.0.2.1:4321", 0),       # TEST-NET-1: never this machine's
])
def test_local_port_of_the_configured_master(addr, want):
    """Node 0 hosts its master at the configured port only where the
    configured host is this machine; anything else takes a free port
    (0), and no configured address makes the launcher raise."""
    assert trun._local_port(addr) == want
