"""The HTTP front door (dlrover_tpu_torch/serving/gateway.py) over the
port's replica pool and scheduler, on the tiny f32 Llama on the CPU,
against the JAX package: real HTTP on 127.0.0.1 on an ephemeral port.

Streamed and non-streamed tokens equal the JAX engine's greedy
continuation; every status code of the JAX gateway's request table
(400 for each malformed body, 429 for the token budget, 503 with
Retry-After for an empty pool, the tier field) is the port's too, with
the same body; a client that disconnects mid-stream cancels its request
and frees its slot; /healthz carries the JAX gateway's keys and
/metrics its metric names for the same engine knobs. No test asserts a
latency: the only waits are on events, with generous timeouts, and the
disconnect case pumps its scheduler from the test thread.
"""

import dataclasses
import http.client
import json
import socket
import struct
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import engine as jeng
from dlrover_tpu.serving import gateway as jgw
from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import gateway as tgw
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import replica as trep
from dlrover_tpu_torch.serving import scheduler as tsched

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=4, pad_id=-1)
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


@dataclasses.dataclass
class Side:
    make: object
    R: object
    S: object
    M: object
    G: object

    def engine(self, **kw):
        return self.make(**{**ENGINE, **kw})


@pytest.fixture(scope="module")
def sides(model):
    jcfg, jparams, tcfg, tparams = model
    return (
        Side(lambda **kw: jeng.ContinuousBatcher(jcfg, jparams, **kw),
             jrep, jsched, jmetrics, jgw),
        Side(lambda **kw: teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                                 **kw),
             trep, tsched, tmetrics, tgw),
    )


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=int(n)).tolist() for n in lengths]


def _jax_greedy(sides, prompts, max_new):
    eng = sides[0].engine()
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return [[int(t) for t in o] for o in eng.generate_all([])]


def _pool(side, n=2, slo=None, start=True, **engine_kw):
    metrics = side.M.ServingMetrics()
    pool = side.R.ReplicaPool(metrics=metrics)
    for i in range(n):
        sched = side.S.RequestScheduler(
            side.engine(**engine_kw),
            slo or side.S.SloConfig(default_deadline_s=600.0),
            metrics=metrics)
        rep = side.R.InferenceReplica(f"replica-{i}", sched)
        if start:
            rep.start()
        pool.add(rep)
    return pool, metrics


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request(method, path, body)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, dict(resp.getheaders()), raw
    finally:
        conn.close()


def _post(port, payload):
    body = payload if isinstance(payload, bytes) else json.dumps(payload)
    status, headers, raw = _request(port, "POST", "/v1/generate", body)
    return status, headers, raw


def _stream(port, tokens, max_new):
    status, _, raw = _post(port, {"tokens": tokens, "max_new": max_new,
                                  "deadline_s": 600.0})
    assert status == 200, raw
    out, trailer = [], None
    for line in raw.decode().strip().splitlines():
        d = json.loads(line)
        out.extend(d.get("tokens", []))
        if d.get("done"):
            trailer = d
    return out, trailer


def test_concurrent_streams_across_two_replicas(sides):
    """Two tenants, each warmed on its own replica; then six concurrent
    streams. The first routed request sees both replicas idle, so it
    follows its tenant's prefix (an affinity match); every stream is
    the JAX engine's greedy continuation, whichever replica served it."""
    port = sides[1]
    pool, metrics = _pool(port, prefix_cache_rows=4, prefix_block=4)
    gw = port.G.ServingGateway(pool, metrics=metrics)
    gw.start()
    try:
        rng = np.random.default_rng(42)
        tenants = [rng.integers(1, 250, size=12).tolist() for _ in range(2)]
        warm = []
        for shared, rep in zip(tenants, pool.replicas()):
            warm.append((shared + [1, 2],
                         rep.scheduler.submit(shared + [1, 2], max_new=6)))
        for _, req in warm:
            assert req.wait(timeout=TIMEOUT_S)
        pool.check_replicas()  # advertise both tenants' prefixes
        prompts = [tenants[i % 2] + rng.integers(1, 250, size=2).tolist()
                   for i in range(6)]
        with ThreadPoolExecutor(max_workers=6) as ex:
            got = list(ex.map(lambda p: _stream(gw.port, p, 6), prompts))
        want = _jax_greedy(sides, [p for p, _ in warm] + prompts, 6)
        assert [list(r.tokens) for _, r in warm] == want[:2]
        assert [toks for toks, _ in got] == want[2:]
        assert [tr["state"] for _, tr in got] == ["done"] * 6
        assert [tr["n_tokens"] for _, tr in got] == [6] * 6
        assert metrics.completed_total == 8 and metrics.shed_total == 0
        assert metrics.affinity_matched >= 1
    finally:
        gw.stop()
        pool.stop()


def test_nonstream_reply_and_token_budget(sides):
    port = sides[1]
    pool, metrics = _pool(port, n=1, slo=port.S.SloConfig(
        max_queue_depth=1, max_new_tokens=8, default_deadline_s=600.0))
    gw = port.G.ServingGateway(pool, metrics=metrics)
    gw.start()
    try:
        p = _prompts((5,), seed=1)[0]
        status, headers, raw = _post(gw.port, {"tokens": p, "max_new": 4,
                                               "stream": False})
        body = json.loads(raw)
        assert status == 200 and headers["Content-Type"] == "application/json"
        assert body["tokens"] == _jax_greedy(sides, [p], 4)[0]
        assert body["state"] == "done" and body["n_tokens"] == 4
        status, headers, raw = _post(gw.port, {"tokens": p, "max_new": 999})
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert "error" in json.loads(raw)
    finally:
        gw.stop()
        pool.stop()


class _NoEngine:
    """A backend that must never be reached (validation answers first)."""

    def submit(self, *a, **kw):
        raise AssertionError("a malformed request reached the backend")


MALFORMED = [
    {}, {"tokens": []}, {"tokens": "not-a-list"}, {"tokens": [1, "two", 3]},
    {"tokens": [1, True]}, {"tokens": [1, 2], "max_new": 0},
    {"tokens": [1, 2], "max_new": -4}, {"tokens": [1, 2], "max_new": "five"},
    {"tokens": [1, 2], "max_new": True}, {"tokens": [1, 2], "deadline_s": 0},
    {"tokens": [1, 2], "deadline_s": "soon"},
    {"tokens": [1, 2], "stream": "yes"}, {"tokens": [1, 2], "max_tokens": 4},
    {"tokens": [1, 2], "bogus": 1}, {"tokens": [1, 2], "tier": "gold"},
    {"tokens": [1, 2], "tier": 3}, {"tokens": [1, 2], "tier": True},
    {"tokens": [1, 2], "tier": ["latency"]},
    {"tokens": [1, 2], "adapter_id": ""},
    {"tokens": [1, 2], "adapter_id": "unknown-adapter"},
    [1, 2, 3], b"not json {",
]


def test_malformed_requests_equal_jax(sides):
    answers = []
    for side in sides:
        gw = side.G.ServingGateway(_NoEngine())
        gw.start()
        try:
            got = []
            for payload in MALFORMED:
                status, _, raw = _post(gw.port, payload)
                got.append((status, json.loads(raw)))
            got.append(_request(gw.port, "GET", "/nowhere")[0])
            answers.append(got)
        finally:
            gw.stop()
    j, t = answers
    assert t == j
    assert all(status == 400 and "error" in body for status, body in t[:-1])
    assert t[-1] == 404
    for payload, (_, body) in zip(MALFORMED, t):
        if isinstance(payload, dict) and "tier" in payload:
            assert "tier" in body["error"]


class _Saturated:
    def __init__(self, exc):
        self.exc = exc

    def aggregate_pressure(self):
        return 1.5

    def submit(self, *a, **kw):
        raise self.exc


def _unhealthy(side, monkeypatch):
    pool, metrics = _pool(side, n=1, start=False)
    gw = side.G.ServingGateway(pool, metrics=metrics)
    gw.start()
    try:
        monkeypatch.setenv(side.R.MOCK_ERR_REPLICA_ENV, "replica-0")
        pool.check_replicas()
        first = pool.replicas()[0].healthy  # one strike: weather
        pool.check_replicas()
        status, headers, raw = _post(gw.port, {"tokens": [5, 6, 7],
                                               "max_new": 3})
        _, _, health = _request(gw.port, "GET", "/healthz")
        monkeypatch.delenv(side.R.MOCK_ERR_REPLICA_ENV)
        pool.check_replicas()
        back = pool.replicas()[0].healthy
    finally:
        gw.stop()
        pool.stop()
    saturated = []
    backend = _Saturated(None)
    g = side.G.ServingGateway(backend)
    g.start()
    try:
        for exc in (side.R.NoHealthyReplicasError("no healthy replicas"),
                    side.S.AdmissionError("queue full")):
            backend.exc = exc
            s, h, _ = _post(g.port, {"tokens": [5, 6, 7], "max_new": 3})
            saturated.append((s, h["Retry-After"]))
    finally:
        g.stop()
    h = json.loads(health)
    return (first, status, headers["Retry-After"], json.loads(raw), back,
            h["ok"], h["replicas"], saturated)


def test_all_replicas_unhealthy_maps_to_503_equal_jax(sides, monkeypatch):
    assert trep.MOCK_ERR_REPLICA_ENV == jrep.MOCK_ERR_REPLICA_ENV
    j, t = (_unhealthy(side, monkeypatch) for side in sides)
    assert t == j
    # an empty pool reports full pressure: Retry-After 1 + 4 x 1.0
    assert t[:3] == (True, 503, "5") and t[4] is True
    assert t[5:7] == (False, 0)
    assert t[7] == [(503, "7"), (429, "7")]


def test_tier_field_plumbed(sides):
    port = sides[1]
    metrics = port.M.ServingMetrics()
    pool = port.R.ReplicaPool()
    sched = port.S.RequestScheduler(port.engine(n_slots=4),
                                    port.S.SloConfig(), metrics=metrics)
    rep = port.R.InferenceReplica("replica-0", sched)
    rep.start()
    pool.add(rep)
    gw = port.G.ServingGateway(pool, metrics=metrics)
    gw.start()
    try:
        p = _prompts((5,), seed=11)[0]
        status, _, raw = _post(gw.port, {"tokens": p, "max_new": 3,
                                         "stream": False, "tier": "batch"})
        assert status == 200, raw
        assert json.loads(raw)["tokens"] == _jax_greedy(sides, [p], 3)[0]
        _, _, raw = _request(gw.port, "GET", "/healthz")
        tiers = json.loads(raw)["tiers"]
        assert tiers["admitted"] == {"latency": 0, "standard": 0, "batch": 1}
        assert tiers["preempted"]["batch"] == 0
    finally:
        gw.stop()
        pool.stop()


def test_disconnect_cancels_and_frees_the_slot(sides):
    """The scheduler is pumped from the test thread, one chunk at a
    time: the first chunk reaches the client, the client resets the
    connection, and the handler's next write cancels the request."""
    port = sides[1]
    eng = port.engine(n_slots=1, max_len=256, max_new_tokens=128, chunk=1)
    metrics = port.M.ServingMetrics()
    sched = port.S.RequestScheduler(eng, metrics=metrics)
    submitted = []

    class Backend:
        def submit(self, *a, **kw):
            req = sched.submit(*a, **kw)
            submitted.append(req)
            return req

    gw = port.G.ServingGateway(Backend(), metrics=metrics)
    gw.start()
    sock = socket.create_connection(("127.0.0.1", gw.port),
                                    timeout=TIMEOUT_S)
    try:
        body = json.dumps({"tokens": _prompts((5,), seed=9)[0],
                           "max_new": 128, "deadline_s": 600}).encode()
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: localhost\r\n"
                     b"Content-Type: application/json\r\n"
                     + b"Content-Length: %d\r\n\r\n" % len(body) + body)
        buf = b""
        while b'"tokens"' not in buf:
            sched.pump()
            buf += sock.recv(4096)
        assert b"200" in buf.split(b"\r\n", 1)[0]
        (req,) = submitted
        # RST on close: the handler's next write raises at once
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        while not req.wait(timeout=0.05):
            assert sched.pump(), "the request ran out before the cancel"
        assert req.state is port.S.RequestState.CANCELLED
        assert metrics.cancelled_total == 1
        assert sched.active_count() == 0 and eng.active_count() == 0
        assert len(req.tokens) < 128
    finally:
        sock.close()
        gw.stop()
        sched.stop()


KNOBS = dict(kv_layout="paged", prefix_cache_rows=2, kv_tier_bytes=8 << 20,
             kv_checksums=1)


def _keys(d):
    """The key tree of a JSON document (values dropped)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def _exposition(side, backend_kind, prompt):
    metrics = side.M.ServingMetrics()
    sched = side.S.RequestScheduler(side.engine(**KNOBS), metrics=metrics)
    if backend_kind == "pool":
        backend = side.R.ReplicaPool(metrics=metrics)
        rep = side.R.InferenceReplica("replica-0", sched)
        rep.start()
        backend.add(rep)
    else:
        backend = sched
        sched.start()
    gw = side.G.ServingGateway(backend, metrics=metrics)
    gw.start()
    try:
        toks, trailer = _stream(gw.port, prompt, 4)
        status, headers, text = _request(gw.port, "GET", "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        _, _, health = _request(gw.port, "GET", "/healthz")
    finally:
        gw.stop()
        backend.stop()
    names = sorted(line.split()[2] for line in text.decode().splitlines()
                   if line.startswith("# TYPE"))
    health = json.loads(health)
    return toks, trailer["state"], names, _keys(health), health


@pytest.mark.parametrize("backend_kind", ["scheduler", "pool"])
def test_healthz_keys_and_metric_names_equal_jax(sides, backend_kind):
    prompt = _prompts((11,), seed=4)[0]
    j, t = (_exposition(side, backend_kind, prompt) for side in sides)
    assert t[:4] == j[:4]
    assert t[1] == "done" and t[0] == _jax_greedy(sides, [prompt], 4)[0]
    health = t[4]
    assert health["ok"] is True and health["replicas"] == 1
    assert health["handoff"]["total"] == {"device": 0, "host": 0}
    if backend_kind == "scheduler":
        assert health["kernel_path"] == "reference"
        assert health["replica_role"] == "colocated"
        assert health["mesh"] == {"shape": {"tp": 1}, "n_chips": 1}
        assert health["prefill"]["prefill_chunk"] == 0
        assert health["kv_tier"]["capacity_bytes"] == float(8 << 20)
    else:
        assert health["fleet_routing"]["affinity_routing"] is True
