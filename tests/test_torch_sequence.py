"""The port's sequence parallelism (parallel/sequence.py: Ulysses over
the all-to-all, ring attention over `batch_isend_irecv`) on four gloo
processes on the CPU, held to JAX's `sp_attention` on a seq=4 mesh of
the conftest's 8-device CPU mesh (after tests/test_sequence_parallel.py
:32-75): the outputs and the gradients of sum(out * cotangent), causal
and not, GQA included (Ulysses repeats the KV heads that do not split
over sp=4).

The port's side is one spawn of four processes
(tests/_torch_sharded_worker.py, mode "seq"), each holding its chunk of
the sequence; the results are gathered along it. Tolerance: f32 both
sides, the reductions in other orders: rtol 1e-5 / atol 1e-6.
"""

import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.parallel.sequence import sp_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_sharded_worker import Ranks as _Ranks  # noqa: E402

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
SHAPES = {
    "mha": dict(b=2, s=32, h=4, kv=4, d=8, causal=True),
    "mha_full": dict(b=2, s=32, h=4, kv=4, d=8, causal=False),
    "gqa": dict(b=2, s=32, h=8, kv=2, d=8, causal=True),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(7)
    seq = {}
    for name, c in SHAPES.items():
        seq[name] = {
            "q": rng.standard_normal((c["b"], c["s"], c["h"], c["d"])),
            "k": rng.standard_normal((c["b"], c["s"], c["kv"], c["d"])),
            "v": rng.standard_normal((c["b"], c["s"], c["kv"], c["d"])),
            "ct": rng.standard_normal((c["b"], c["s"], c["h"], c["d"])),
            "causal": c["causal"]}
        for k in ("q", "k", "v", "ct"):
            seq[name][k] = seq[name][k].astype(np.float32)
    return {"port": _free_port(), "seq": seq}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    run = _Ranks(str(tmp_path_factory.mktemp("seq")), _inputs(), "seq")
    yield run
    run.kill()


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_sp_attention_equals_jax(ranks, name, mode):
    """Each rank's chunk through the port's sp_attention, gathered along
    the sequence: the output and dq, dk, dv of sum(out * cotangent)
    equal JAX's sp_attention over a seq=4 mesh (its backward ring is
    autodiff's) within rtol 1e-5 / atol 1e-6, on every rank."""
    x = ranks.inp["seq"][name]
    mesh = jmesh.MeshSpec(seq=4).build(jax.devices()[:WORLD])
    ct = jnp.asarray(x["ct"])

    def f(q, k, v):
        return sp_attention(q, k, v, mesh, mode=mode, causal=x["causal"])

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x[n])
                                     for n in ("q", "k", "v")))
    want = [out] + list(vjp(ct))
    got = ranks.result()
    for r in range(WORLD):
        for what, g, w in zip(("out", "dq", "dk", "dv"),
                              got[r]["seq"][(name, mode)], want):
            np.testing.assert_allclose(
                g, np.asarray(w), rtol=RTOL, atol=ATOL,
                err_msg=f"{name} {mode} {what} rank {r}")
