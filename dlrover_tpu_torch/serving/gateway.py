"""HTTP front door for the serving stack — stdlib only; a copy of
dlrover_tpu/serving/gateway.py over the port's scheduler and replica
pool (host code: the gateway adds no device logic of its own).

threading + http.server, no web framework: the gateway is a thin
protocol adapter over the scheduler/pool (the control logic lives
there, where it is unit-testable without sockets), and the repo's
no-new-deps rule holds for serving like everywhere else.

Endpoints:

  POST /v1/generate   {"tokens": [...], "max_new"?: n,
                       "deadline_s"?: s, "stream"?: bool,
                       "adapter_id"?: str,
                       "tier"?: "latency"|"standard"|"batch"}
    stream=true (default): application/x-ndjson — one
      {"tokens": [...]} line per decoded chunk as it lands, then a
      {"done": true, ...} trailer. TTFT for the client is one engine
      chunk, not one full generation.
    stream=false: one JSON body with the full continuation.
    429 when admission rejects (queue full / token budget);
    503 when the request is shed past its deadline.

  GET /metrics        Prometheus text (serving/metrics.py)
  GET /healthz        {"ok": ..., "replicas": n}

Responses are HTTP/1.0 with Connection: close — the absence of a
Content-Length makes end-of-body explicit at close, which is exactly
the framing a streaming response wants, and every http client (curl
included) consumes it incrementally.
"""

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.serving.metrics import ServingMetrics
from dlrover_tpu_torch.serving.replica import NoHealthyReplicasError
from dlrover_tpu_torch.serving.scheduler import (
    TIERS,
    AdmissionError,
    RequestState,
)

_GENERATE_FIELDS = frozenset(
    {"tokens", "max_new", "deadline_s", "stream", "adapter_id", "tier"}
)


def _validate_generate(payload) -> Optional[str]:
    """Schema check for POST /v1/generate; returns the 400 reason or
    None. A malformed request must fail loudly at the door — not 500
    deep in the scheduler, and never be silently clamped into a
    request the client didn't make."""
    if not isinstance(payload, dict):
        return "body must be a JSON object"
    unknown = set(payload) - _GENERATE_FIELDS
    if unknown:
        return f"unknown fields: {sorted(unknown)}"
    tokens = payload.get("tokens")
    if not isinstance(tokens, list) or not tokens:
        return "'tokens' must be a non-empty list of ints"
    if any(
        isinstance(t, bool) or not isinstance(t, int) for t in tokens
    ):
        return "'tokens' must be a non-empty list of ints"
    max_new = payload.get("max_new")
    if max_new is not None and (
        isinstance(max_new, bool)
        or not isinstance(max_new, int)
        or max_new < 1
    ):
        return "'max_new' must be a positive int"
    deadline_s = payload.get("deadline_s")
    if deadline_s is not None and (
        isinstance(deadline_s, bool)
        or not isinstance(deadline_s, (int, float))
        or deadline_s <= 0
    ):
        return "'deadline_s' must be a positive number"
    stream = payload.get("stream")
    if stream is not None and not isinstance(stream, bool):
        return "'stream' must be a bool"
    adapter_id = payload.get("adapter_id")
    if adapter_id is not None and (
        not isinstance(adapter_id, str) or not adapter_id
    ):
        return "'adapter_id' must be a non-empty string"
    tier = payload.get("tier")
    if tier is not None and (
        not isinstance(tier, str) or tier not in TIERS
    ):
        return f"'tier' must be one of {sorted(TIERS)}"
    return None


class ServingGateway:
    """HTTP server routing generation requests into a backend.

    `backend` is anything with submit(prompt, max_new, deadline_s) ->
    ServeRequest: a RequestScheduler (single replica) or a ReplicaPool
    (least-loaded routing across replicas)."""

    # the gateway spawns the server thread but shares no mutable
    # fields with it: backend/metrics/timeout are read-only after
    # __init__, and per-request state lives on the handler instances
    GUARDED_FIELDS = frozenset()

    def __init__(
        self,
        backend,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics: Optional[ServingMetrics] = None,
        stream_timeout_s: float = 120.0,
    ):
        self.backend = backend
        self.metrics = metrics or getattr(backend, "metrics", None) \
            or ServingMetrics()
        self.stream_timeout_s = stream_timeout_s
        gw = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            # route the handler's log through ours, not stderr
            def log_message(self, fmt, *args):
                logger.debug("gateway: " + fmt, *args)

            def _json(
                self, code: int, obj: dict, headers: dict = None
            ):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, str(value))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    body = gw.metrics.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4",
                    )
                    self.send_header(
                        "Content-Length", str(len(body))
                    )
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    self._json(200, gw._health())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._json(
                        400, {"error": "body must be valid JSON"}
                    )
                    return
                reason = _validate_generate(payload)
                if reason is not None:
                    self._json(400, {"error": reason})
                    return
                adapter_id = payload.get("adapter_id")
                if adapter_id is not None and not gw._adapter_known(
                    adapter_id
                ):
                    # a typo'd adapter id is a CLIENT error, caught at
                    # the door — not a 500 from deep in the engine and
                    # not a 429 the client would uselessly retry
                    self._json(
                        400,
                        {"error": f"unknown adapter {adapter_id!r}"},
                    )
                    return
                kw = (
                    {}
                    if adapter_id is None
                    else {"adapter_id": adapter_id}
                )
                tier = payload.get("tier")
                if tier is not None:
                    kw["tier"] = tier
                try:
                    req = gw.backend.submit(
                        payload["tokens"],
                        max_new=payload.get("max_new"),
                        deadline_s=payload.get("deadline_s"),
                        **kw,
                    )
                except NoHealthyReplicasError as e:
                    # availability, not backpressure: retrying the
                    # same replica set cannot help until it scales
                    self._json(
                        503,
                        {"error": e.reason},
                        headers={"Retry-After": gw._retry_after()},
                    )
                    return
                except AdmissionError as e:
                    self._json(
                        429,
                        {"error": e.reason},
                        headers={"Retry-After": gw._retry_after()},
                    )
                    return
                if payload.get("stream", True):
                    self._stream(req)
                else:
                    self._blocking(req)

            def _stream(self, req):
                self.send_response(200)
                self.send_header(
                    "Content-Type", "application/x-ndjson"
                )
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for chunk in req.iter_stream(
                        timeout=gw.stream_timeout_s
                    ):
                        self.wfile.write(
                            json.dumps({"tokens": chunk}).encode()
                            + b"\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(
                        json.dumps(gw._trailer(req)).encode() + b"\n"
                    )
                except queue.Empty:
                    self.wfile.write(
                        json.dumps(
                            {"error": "stream timeout"}
                        ).encode()
                        + b"\n"
                    )
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: cancel the request
                    # so its slot (and any pinned prefix-cache row)
                    # frees NOW instead of decoding tokens nobody
                    # will read
                    gw._cancel(req)

            def _blocking(self, req):
                if not req.wait(timeout=gw.stream_timeout_s):
                    self._json(504, {"error": "generation timeout"})
                    return
                if req.state is RequestState.SHED:
                    self._json(
                        503,
                        gw._trailer(req),
                        headers={"Retry-After": gw._retry_after()},
                    )
                    return
                if req.state is RequestState.FAILED:
                    # crashed past its retry budget: the service
                    # dropped admitted work — a server error, not
                    # client backpressure
                    self._json(500, gw._trailer(req))
                    return
                self._json(
                    200, {"tokens": req.tokens, **gw._trailer(req)}
                )

            handler_version = "dlrover-tpu-serving"

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _cancel(req) -> None:
        """Best-effort cancellation on client disconnect: the request
        knows which scheduler currently hosts it (failover may have
        moved it since submit). Never raises back into the stream
        handler — the connection is already gone."""
        sched = getattr(req, "scheduler", None)
        if sched is None:
            return
        try:
            sched.cancel(req)
        except Exception:  # noqa: BLE001
            logger.exception(
                "cancel after disconnect failed for request %d", req.id
            )

    @staticmethod
    def _trailer(req) -> dict:
        return {
            "done": True,
            "id": req.id,
            "state": req.state.value,
            "n_tokens": len(req.tokens),
        }

    def _health(self) -> dict:
        reps = getattr(self.backend, "healthy_replicas", None)
        n = len(reps()) if callable(reps) else 1
        out = {"ok": n > 0, "replicas": n}
        pc = self._prefix_cache()
        if pc is not None:
            out["prefix_cache"] = pc.stats()
        spec = self._speculative()
        if spec is not None:
            out["speculative"] = spec.stats()
        paged = self._paged()
        if paged:
            out["paged_kv"] = paged
        engine = getattr(self.backend, "engine", None)
        # host-DRAM KV tier: byte occupancy, entry counts, and the
        # demote/promote/swap counters (serving/kv_tier.py). Engines
        # without a tier (kv_tier_bytes=0, test doubles) return {}
        # and skip the block.
        tstats = getattr(engine, "kv_tier_stats", None)
        if callable(tstats):
            t = tstats()
            if t:
                out["kv_tier"] = t
        mesh_shape = getattr(engine, "mesh_shape", None)
        if mesh_shape is not None:
            out["mesh"] = {
                "shape": mesh_shape,
                "n_chips": int(getattr(engine, "n_chips", 1)),
            }
        kp = getattr(engine, "kernel_path", None)
        if kp is not None:
            out["kernel_path"] = kp
        # int8 weight quantization: which matmul body the quantized
        # programs traced ("int8:kernel" | "int8:reference" | "none")
        # plus the byte/leaf stats — duck-typed like kernel_path so
        # test doubles and pool backends skip the block
        wqp = getattr(engine, "weight_quant_path", None)
        if wqp is not None:
            out["weight_quant_path"] = wqp
            wqstats = getattr(engine, "weight_quant_stats", None)
            if callable(wqstats):
                wq = wqstats()
                if wq:
                    out["weight_quant"] = wq
        role = getattr(engine, "replica_role", None)
        if role is not None:
            out["replica_role"] = role
        # phase-handoff health: per-transport migration counts, last
        # migration latency, per-role waiting depth (duck-typed so
        # test doubles without the counters stay valid)
        m = self.metrics
        if getattr(m, "handoff_total", None) is not None:
            out["handoff"] = {
                "total": m.handoff_total,
                "last_ms": m.handoff_last_ms,
                "role_queue_depth": m.role_queue_depth,
            }
        # elastic health: resize/refresh counters, the served weight
        # version, and the engine's live device-set health (same
        # duck-typing as the handoff block)
        if getattr(m, "resize_total", None) is not None:
            out["elastic"] = {
                "resize_total": m.resize_total,
                "weight_refresh_total": m.weight_refresh_total,
                "resize_downtime_ms": m.resize_downtime_ms,
                "weight_version": m.weight_version,
            }
        health_fn = getattr(engine, "device_health", None)
        if callable(health_fn):
            out["device_health"] = health_fn()
        # multi-adapter serving: registry size, device-cache traffic,
        # and per-adapter live request counts (single-scheduler
        # scoping like the blocks above; {} engines are elided)
        astats = getattr(engine, "adapter_stats", None)
        if callable(astats):
            a = astats()
            if a:
                out["adapters"] = a
                active = getattr(engine, "adapter_active", None)
                if callable(active):
                    out["adapters"]["active"] = active()
        # interleaved chunked prefill: the knob, cumulative admission
        # stall, fused chunk dispatches, and live mid-prefill slots
        # (same duck-typing — engines without prefill_stats, and
        # pool backends, skip the block)
        pfstats = getattr(engine, "prefill_stats", None)
        if callable(pfstats):
            out["prefill"] = pfstats()
        # fleet front door: digest-map occupancy + affinity knobs
        # (pool backends only — a single scheduler has no fleet;
        # same duck-typing as the blocks above)
        rstats = getattr(self.backend, "routing_stats", None)
        if callable(rstats):
            out["fleet_routing"] = rstats()
        # priority tiers: per-class admission/preemption/escalation/
        # shed counters (same duck-typing — test doubles without the
        # tier counters skip the block)
        if getattr(m, "tier_admitted_total", None) is not None:
            out["tiers"] = {
                "admitted": m.tier_admitted_total,
                "preempted": m.tier_preempted_total,
                "escalated": m.tier_escalated_total,
                "shed": m.tier_shed_total,
            }
        # health sentinel (serving/health.py): KV integrity
        # check/quarantine totals from the engine, preflight and
        # straggler state from the pool (same duck-typing — backends
        # without the sentinel skip the block)
        sentinel: dict = {}
        hstats = getattr(engine, "health_stats", None)
        if callable(hstats):
            sentinel.update(hstats())
        pstats = getattr(self.backend, "health_stats", None)
        if callable(pstats):
            sentinel.update(pstats())
        if sentinel:
            out["health_sentinel"] = sentinel
        return out

    def _retry_after(self) -> int:
        """Retry-After seconds for 503/429 responses, derived from
        the backend's live queue pressure: an idle fleet says "come
        right back" (1s), a saturated one pushes the retry out so
        clients don't synchronize a thundering herd onto a backend
        that is already shedding. Duck-typed: pool backends expose
        aggregate_pressure(), single schedulers pressure(); anything
        else gets the 1s floor."""
        pressure = 0.0
        for name in ("aggregate_pressure", "pressure"):
            fn = getattr(self.backend, name, None)
            if callable(fn):
                try:
                    pressure = float(fn())
                # the header is advisory: a pressure probe that raises
                # must not turn an otherwise-correct 503 into a 500
                except Exception:  # noqa: BLE001
                    pressure = 0.0
                break
        pressure = min(max(pressure, 0.0), 2.0)
        return max(1, int(round(1.0 + 4.0 * pressure)))

    def _prefix_cache(self):
        """The backing engine's RadixPrefixCache, when the backend is
        a single scheduler with the cache enabled (a replica pool
        aggregates through /metrics instead)."""
        engine = getattr(self.backend, "engine", None)
        return getattr(engine, "prefix_cache", None)

    def _speculative(self):
        """The backing engine's SpeculativeDecoder, same single-
        scheduler scoping as _prefix_cache."""
        engine = getattr(self.backend, "engine", None)
        return getattr(engine, "spec", None)

    def _paged(self) -> dict:
        """The backing engine's page-pool stats ({} under the dense
        layout), same single-scheduler scoping as _prefix_cache."""
        engine = getattr(self.backend, "engine", None)
        stats = getattr(engine, "paged_stats", None)
        return stats() if callable(stats) else {}

    def _adapter_known(self, adapter_id: str) -> bool:
        """Whether ANY engine behind this gateway can serve
        `adapter_id`: the single scheduler's registry, or — pool
        backend — any replica's. No registry anywhere means
        multi-adapter serving is off and every adapter id is
        unknown."""
        engines = []
        eng = getattr(self.backend, "engine", None)
        if eng is not None:
            engines.append(eng)
        reps = getattr(self.backend, "replicas", None)
        if callable(reps):
            engines.extend(r.scheduler.engine for r in reps())
        for e in engines:
            reg = getattr(e, "adapter_registry", None)
            if reg is not None and adapter_id in reg:
                return True
        return False

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def addr(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="serving-gateway",
            daemon=True,
        )
        self._thread.start()
        logger.info("serving gateway on %s", self.addr)

    def stop(self):
        self._server.shutdown()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._server.server_close()
