"""Brain datastore: job metrics persistence (sqlite) — a copy of
dlrover_tpu/brain/datastore.py (stdlib only; the port imports nothing
of the JAX package). The replica pool's `publish_telemetry` writes
its serving samples here.

Reference parity: dlrover/go/brain/pkg/datastore — MySQL tables for job
metrics/job meta consumed by the optimize algorithms
(implementation/utils/mysql.go). Sqlite keeps the same shape with zero
deployment burden; the schema mirrors what the algorithms read: job
identity, per-role resource requests, runtime series (cpu/mem/speed),
and terminal status (incl. OOM flags)."""

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class JobMeta:
    job_uuid: str
    job_name: str = ""
    user: str = ""
    cluster: str = ""
    status: str = "running"  # running | succeeded | failed | oom
    created_at: float = field(default_factory=time.time)


@dataclass
class RuntimeSample:
    """One observation of a role group at a moment in time.

    Serving telemetry (role="serving", written by the replica pool's
    publish_telemetry) reuses the shared fields — num_nodes carries
    the fleet's healthy CHIP count (the denomination the forecast
    scales in), cpu_percent carries aggregate queue pressure ×100,
    samples_per_sec carries tokens/sec — and adds the three
    serving-only columns below (zero for training roles)."""

    job_uuid: str
    role: str  # worker | ps (embedding host) | serving
    num_nodes: int = 0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    samples_per_sec: float = 0.0
    global_step: int = 0
    ts: float = field(default_factory=time.time)
    queue_depth: int = 0       # fleet-total waiting requests
    ttft_ms: float = 0.0       # warm TTFT p50 over the window
    cache_hit_rate: float = 0.0  # fleet prefix-cache hit rate [0,1]


class JobMetricsStore:
    """Thread-safe store over sqlite (":memory:" for tests)."""

    def __init__(self, path: str = ":memory:"):
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS job_meta (
                job_uuid TEXT PRIMARY KEY,
                job_name TEXT, user TEXT, cluster TEXT,
                status TEXT, created_at REAL,
                resources TEXT DEFAULT '{}'
            )"""
        )
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS runtime_samples (
                job_uuid TEXT, role TEXT, num_nodes INTEGER,
                cpu_percent REAL, memory_mb REAL,
                samples_per_sec REAL, global_step INTEGER, ts REAL,
                queue_depth INTEGER DEFAULT 0,
                ttft_ms REAL DEFAULT 0,
                cache_hit_rate REAL DEFAULT 0
            )"""
        )
        # serving-telemetry columns, added for the fleet forecast:
        # CREATE IF NOT EXISTS never migrates a pre-existing file, so
        # widen it in place (ALTER is a no-op error when the column
        # is already there — including the fresh-table path above)
        for col, decl in (
            ("queue_depth", "INTEGER DEFAULT 0"),
            ("ttft_ms", "REAL DEFAULT 0"),
            ("cache_hit_rate", "REAL DEFAULT 0"),
        ):
            try:
                self._conn.execute(
                    f"ALTER TABLE runtime_samples "
                    f"ADD COLUMN {col} {decl}"
                )
            except sqlite3.OperationalError:
                pass  # column exists
        self._conn.commit()

    # ---- job meta --------------------------------------------------------

    def upsert_job(self, meta: JobMeta, resources: Optional[Dict] = None):
        with self._lock:
            self._conn.execute(
                """INSERT INTO job_meta
                   (job_uuid, job_name, user, cluster, status,
                    created_at, resources)
                   VALUES (?,?,?,?,?,?,?)
                   ON CONFLICT(job_uuid) DO UPDATE SET
                     status=excluded.status,
                     resources=CASE WHEN excluded.resources != '{}'
                       THEN excluded.resources
                       ELSE job_meta.resources END""",
                (
                    meta.job_uuid,
                    meta.job_name,
                    meta.user,
                    meta.cluster,
                    meta.status,
                    meta.created_at,
                    json.dumps(resources or {}),
                ),
            )
            self._conn.commit()

    def get_job(self, job_uuid: str) -> Optional[JobMeta]:
        with self._lock:
            row = self._conn.execute(
                "SELECT job_uuid, job_name, user, cluster, status, "
                "created_at FROM job_meta WHERE job_uuid=?",
                (job_uuid,),
            ).fetchone()
        if row is None:
            return None
        return JobMeta(*row)

    def job_resources(self, job_uuid: str) -> Dict:
        with self._lock:
            row = self._conn.execute(
                "SELECT resources FROM job_meta WHERE job_uuid=?",
                (job_uuid,),
            ).fetchone()
        return json.loads(row[0]) if row else {}

    def similar_jobs(
        self, job_name: str, user: str = "", limit: int = 10
    ) -> List[JobMeta]:
        """Historical jobs of the same name prefix/user — the
        'similar job' lookup behind the create-resource algorithm."""
        prefix = job_name.rstrip("0123456789-_")
        # escape LIKE metacharacters — '_' is near-universal in job
        # names and would otherwise match any single character
        escaped = (
            prefix.replace("\\", "\\\\")
            .replace("%", "\\%")
            .replace("_", "\\_")
        )
        with self._lock:
            rows = self._conn.execute(
                "SELECT job_uuid, job_name, user, cluster, status, "
                "created_at FROM job_meta "
                "WHERE job_name LIKE ? ESCAPE '\\' "
                "AND status='succeeded' "
                + ("AND user=? " if user else "")
                + "ORDER BY created_at DESC LIMIT ?",
                (escaped + "%",) + ((user,) if user else ()) + (limit,),
            ).fetchall()
        return [JobMeta(*r) for r in rows]

    # ---- runtime samples -------------------------------------------------

    def add_sample(self, s: RuntimeSample):
        with self._lock:
            self._conn.execute(
                "INSERT INTO runtime_samples "
                "(job_uuid, role, num_nodes, cpu_percent, memory_mb, "
                "samples_per_sec, global_step, ts, queue_depth, "
                "ttft_ms, cache_hit_rate) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (
                    s.job_uuid,
                    s.role,
                    s.num_nodes,
                    s.cpu_percent,
                    s.memory_mb,
                    s.samples_per_sec,
                    s.global_step,
                    s.ts,
                    s.queue_depth,
                    s.ttft_ms,
                    s.cache_hit_rate,
                ),
            )
            self._conn.commit()

    def samples(
        self, job_uuid: str, role: str = "", limit: int = 100
    ) -> List[RuntimeSample]:
        q = (
            "SELECT job_uuid, role, num_nodes, cpu_percent, memory_mb, "
            "samples_per_sec, global_step, ts, queue_depth, ttft_ms, "
            "cache_hit_rate FROM runtime_samples "
            "WHERE job_uuid=?"
        )
        args: tuple = (job_uuid,)
        if role:
            q += " AND role=?"
            args += (role,)
        q += " ORDER BY ts DESC LIMIT ?"
        args += (limit,)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [RuntimeSample(*r) for r in rows]

    def close(self):
        with self._lock:
            self._conn.close()
