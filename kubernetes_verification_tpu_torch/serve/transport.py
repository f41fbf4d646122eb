"""Networked replication: WAL/snapshot transport over stdlib HTTP.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.transport``:
the wire format (WAL ranges and their crc32, the checkpoint listing, the
JSON bodies) is byte for byte the JAX package's, so a follower of either
package bootstraps from and tails a leader of the other. ``/healthz``
reports the AOT pack as absent (the port ships none) and ``/profile``
captures through ``torch.profiler``.

Shared-directory replication assumes every replica mounts the leader's filesystem;
this module removes that ceiling with a wire protocol a follower on
another host can ride, built entirely on the stdlib (``http.server`` /
``http.client`` — no new deps):

* :class:`ReplicationServer` — the leader side. A threaded HTTP server
  over the leader's serving directory exposing four read-only endpoints:

  - ``GET /v1/tip`` — WAL size / last seq / last epoch plus the current
    ``leader.lease`` (:meth:`~.replication.LeaseFile.describe`) and the
    server's wall clock: one round trip answers "is the leader alive,
    what reign is it, how far ahead is it";
  - ``GET /v1/wal?offset=N&limit=M`` (or ``start_after_seq=S``) — a raw
    byte range of the WAL, crc32-stamped (``X-KVTPU-Crc32``), so a
    follower resumes a tail at an exact byte offset or after the last
    sequence number it applied;
  - ``GET /v1/checkpoint/manifest`` — the newest *valid* checkpoint
    generation (walking the same ladder as recovery): the verbatim
    manifest plus a per-file ``sha256`` listing;
  - ``GET /v1/checkpoint/file?generation=N&path=REL&offset=B&limit=M``
    — one chunk of one snapshot file, ``X-KVTPU-Sha256``-stamped, path
    traversal refused.

* :class:`ReplicationClient` — per-request timeouts, bounded retries with
  capped exponential backoff + jitter (:class:`~..resilience.retry.
  RetryPolicy`), checksum verification on every payload, and the
  :func:`~..resilience.faults.net_fault` seam before every wire request
  so the chaos harness can drop / delay / partition the stream. Every
  failure is a typed :class:`~..resilience.errors.ReplicationError`.

* :func:`bootstrap_from_leader` — snapshot shipping: fetch the newest
  generation file-by-file into a tmp dir, verify per-file and whole-tree
  digests, promote with ``os.replace``, and write the manifest *last* —
  the same commit-point discipline as :class:`~.durability.
  CheckpointManager`, so a crash mid-bootstrap leaves no torn generation.

* :class:`RemoteEventSource` — a drop-in for :class:`~.events.
  EventSource` that maintains a local **byte-replica mirror** of the
  leader's WAL: each sync appends the leader's raw bytes at our exact
  mirror size, so mirror offsets *are* leader offsets, checkpoint
  ``log_offset`` bindings hold unchanged, and every read-side guarantee —
  crc verification, epoch-regression fencing, ``min_epoch`` floors, seq
  dedup, torn-tail deferral — is enforced by the wrapped EventSource on
  the mirror, bit-for-bit identical to the shared-filesystem path. A
  fetch failure is swallowed (and kept in ``last_error``): a partitioned
  follower keeps serving increasingly stale reads from its mirror, which
  is exactly the staleness-bound story.

Failover note: promotion arbitration (O_EXCL claim + flock'd lease CAS)
needs a shared medium, so networked followers arbitrate in their *local*
standby directory — followers that should elect among themselves share
that directory, while the deposed leader across the partition is fenced
by epoch: the winner's records carry a higher epoch, so a healed
follower's EventSource drops the old reign's strays on sight. A follower
that applied records the new leader never saw (it was *ahead* of the
fork) cannot be rolled back by this transport and must re-bootstrap —
the README failure matrix spells this out.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..observe import log_event
from ..observe.export import to_prometheus
from ..observe.flight import recent_dumps
from ..observe.metrics import (
    NET_BYTES_TOTAL,
    NET_REQUEST_FAILURES_TOTAL,
    NET_REQUESTS_TOTAL,
    SCRAPE_REQUESTS_TOTAL,
)
from ..observe.progress import ProgressTicker, active_jobs
from ..observe.spans import (
    TRACE_HEADER,
    capture_profile,
    parse_trace_header,
    trace,
    trace_context,
    trace_headers,
)
from ..resilience.errors import (
    AdmissionRejectedError,
    PersistError,
    ReplicationError,
    ServeError,
)
from ..resilience.faults import net_fault
from ..resilience.retry import RetryPolicy
from .durability import (
    CheckpointManager,
    _atomic_write_json,
    _fsync_dir,
    _fsync_tree,
    _manifest_checksum,
    _tree_digest,
    aot_pack_status,
    load_manifest,
)
from .events import Event, EventSource
from .replication import LeaseFile, lease_path

__all__ = [
    "ReplicationServer",
    "ReplicationClient",
    "RemoteEventSource",
    "bootstrap_from_leader",
    "wal_offset_after_seq",
]

#: default per-range / per-chunk transfer size (1 MiB)
DEFAULT_CHUNK_BYTES = 1 << 20

#: conservative retry profile for replication traffic: 3 attempts, 50ms
#: base doubling to a 1s cap, 10% decorrelation jitter, deterministic seed
DEFAULT_POLICY = RetryPolicy(
    max_retries=2, backoff_base=0.05, backoff_max=1.0, jitter=0.1, seed=0
)


def _payload_crc(payload: bytes) -> str:
    return format(zlib.crc32(payload) & 0xFFFFFFFF, "08x")


def wal_offset_after_seq(path: str, seq: int) -> int:
    """Byte offset of the first WAL record *after* sequence ``seq`` — the
    wire-level mirror of ``EventSource.start_after_seq``. Scans complete
    lines only, stops at the first record whose ``seq`` exceeds the bound
    (or that carries none: an unsequenced record has no identity to dedup
    by, so it must be resent rather than silently skipped)."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return 0
    offset = 0
    for raw in data.splitlines(keepends=True):
        if not raw.endswith(b"\n"):
            break
        line = raw.decode("utf-8", errors="replace").strip()
        if line:
            try:
                rec_seq = json.loads(line).get("seq")
            except (json.JSONDecodeError, AttributeError):
                break
            if not isinstance(rec_seq, int) or rec_seq > seq:
                break
        offset += len(raw)
    return offset


class _WalTip:
    """Incremental WAL tip tracker for ``/v1/tip``: parses only the bytes
    appended since the last refresh (complete lines only — a partial or
    undecodable tail is a writer mid-flush and is retried next time), so
    serving the tip stays O(new bytes) under sustained churn. A file that
    *shrank* (torn-tail repair on a leader restart) resets the scan."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._offset = 0
        self._last_seq = -1
        self._last_epoch: Optional[int] = None

    def refresh(self) -> Dict[str, object]:
        with self._lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            if size < self._offset:
                self._offset = 0
                self._last_seq = -1
                self._last_epoch = None
            if size > self._offset:
                with open(self.path, "rb") as fh:
                    fh.seek(self._offset)
                    chunk = fh.read()
                for raw in chunk.splitlines(keepends=True):
                    if not raw.endswith(b"\n"):
                        break
                    line = raw.decode("utf-8", errors="replace").strip()
                    if line:
                        try:
                            obj = json.loads(line)
                        except json.JSONDecodeError:
                            break
                        rec_seq = obj.get("seq")
                        if isinstance(rec_seq, int):
                            self._last_seq = max(self._last_seq, rec_seq)
                        rec_epoch = obj.get("epoch")
                        if isinstance(rec_epoch, int):
                            self._last_epoch = (
                                rec_epoch
                                if self._last_epoch is None
                                else max(self._last_epoch, rec_epoch)
                            )
                    self._offset += len(raw)
            return {
                "size": size,
                "last_seq": self._last_seq,
                "last_epoch": self._last_epoch,
            }


class _Handler(BaseHTTPRequestHandler):
    """Request handler bound to the owning :class:`ReplicationServer`
    through ``self.server`` (a :class:`_Server`)."""

    protocol_version = "HTTP/1.1"
    server: "_Server"

    # the default handler writes every request to stderr — a tailing
    # follower would flood the leader's logs
    def log_message(self, format: str, *args) -> None:  # noqa: A002
        pass

    def _send_json(
        self,
        obj: dict,
        status: int = 200,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = json.dumps(obj, sort_keys=True).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(
        self, payload: bytes, headers: Dict[str, str]
    ) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(payload)))
        for key, value in headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler's name
        rep = self.server.replication
        parts = urlsplit(self.path)
        query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        # adopt the caller's X-Kvtpu-Trace context: every span opened while
        # serving this request (this one and any nested) joins the caller's
        # trace_id and parents under the caller's span, so `kv-tpu trace`
        # sees the server-side time from the client's own timeline
        trace_id, parent_id = parse_trace_header(
            self.headers.get(TRACE_HEADER)
        )
        with trace_context(trace_id, parent_id), trace(
            "http_serve", path=parts.path
        ) as span:
            try:
                if parts.path == "/v1/tip":
                    self._send_json(rep.tip())
                elif parts.path == "/v1/wal":
                    payload, headers = rep.wal_range(query)
                    self._send_bytes(payload, headers)
                elif parts.path == "/v1/checkpoint/manifest":
                    self._send_json(rep.checkpoint_manifest())
                elif parts.path == "/v1/checkpoint/file":
                    payload, headers = rep.checkpoint_chunk(query)
                    self._send_bytes(payload, headers)
                elif parts.path == "/metrics":
                    SCRAPE_REQUESTS_TOTAL.labels(endpoint="metrics").inc()
                    # ?exemplars=1 opts into the OpenMetrics exemplar
                    # annotations; the default stays byte-compatible with
                    # pre-exemplar scrapers
                    self._send_text(
                        to_prometheus(
                            exemplars=query.get("exemplars")
                            in ("1", "true")
                        ).encode("utf-8"),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif parts.path == "/healthz":
                    SCRAPE_REQUESTS_TOTAL.labels(endpoint="healthz").inc()
                    self._send_json(rep.health())
                elif parts.path == "/profile":
                    SCRAPE_REQUESTS_TOTAL.labels(endpoint="profile").inc()
                    result = rep.profile(
                        seconds=float(query.get("seconds", 2.0))
                    )
                    self._send_json(
                        result,
                        status=429
                        if result.get("outcome") == "rate-limited"
                        else 200,
                    )
                else:
                    self._send_json(
                        {"error": f"unknown endpoint {parts.path!r}"},
                        status=404,
                    )
            except ReplicationError as e:
                span.attrs["error"] = str(e)
                self._send_json({"error": str(e)}, status=404)
            except (OSError, ValueError, KeyError) as e:
                span.attrs["error"] = f"{type(e).__name__}: {e}"
                self._send_json(
                    {"error": f"{type(e).__name__}: {e}"}, status=500
                )

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler's name
        rep = self.server.replication
        parts = urlsplit(self.path)
        # same trace adoption as do_GET: the submit's ingress_batch span
        # parents under the caller's X-Kvtpu-Trace context
        trace_id, parent_id = parse_trace_header(
            self.headers.get(TRACE_HEADER)
        )
        with trace_context(trace_id, parent_id), trace(
            "http_serve", path=parts.path
        ) as span:
            try:
                if parts.path == "/v1/stripe":
                    source = getattr(rep, "stripe_source", None)
                    if source is None:
                        self._send_json(
                            {"error": "this replica serves no stripe"},
                            status=503,
                        )
                        return
                    length = int(
                        self.headers.get("Content-Length", 0) or 0
                    )
                    raw = self.rfile.read(length) if length > 0 else b""
                    doc = json.loads(raw.decode("utf-8")) if raw else {}
                    span.attrs["op"] = str(doc.get("op", ""))
                    self._send_json(source(doc))
                    return
                if parts.path != "/v1/query":
                    self._send_json(
                        {"error": f"unknown endpoint {parts.path!r}"},
                        status=404,
                    )
                    return
                ingress = getattr(rep, "ingress", None)
                if ingress is None:
                    self._send_json(
                        {"error": "this replica has no ingress tier wired"},
                        status=503,
                    )
                    return
                length = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(length) if length > 0 else b""
                doc = json.loads(raw.decode("utf-8")) if raw else {}
                tenant = str(
                    doc.get("tenant")
                    or self.headers.get("X-Kvtpu-Tenant")
                    or "default"
                )
                span.attrs["tenant"] = tenant
                deadline_s = doc.get("deadline_s")
                priority = doc.get("priority")
                answers = ingress.submit(
                    [tuple(p) for p in doc.get("probes", [])],
                    tenant=tenant,
                    deadline_s=(
                        float(deadline_s) if deadline_s is not None else None
                    ),
                    priority=int(priority) if priority is not None else None,
                )
                self._send_json(
                    {"answers": [bool(a) for a in answers], "tenant": tenant}
                )
            except AdmissionRejectedError as e:
                # the typed refusal contract: over-quota is the client's
                # own pacing problem (429), everything else is the
                # server shedding (503); both carry the computed
                # Retry-After so well-behaved clients back off exactly
                # as long as the door asks
                span.attrs["rejected"] = e.reason
                self._send_json(
                    {
                        "error": str(e),
                        "reason": e.reason,
                        "tenant": e.tenant,
                        "retry_after_s": e.retry_after_s,
                    },
                    status=429 if e.reason == "over-quota" else 503,
                    headers={
                        "Retry-After": f"{max(0.0, e.retry_after_s):.3f}"
                    },
                )
            except ServeError as e:
                span.attrs["error"] = str(e)
                self._send_json({"error": str(e)}, status=400)
            except (OSError, ValueError, KeyError) as e:
                span.attrs["error"] = f"{type(e).__name__}: {e}"
                self._send_json(
                    {"error": f"{type(e).__name__}: {e}"}, status=500
                )


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    replication: "ReplicationServer"


class ReplicationServer:
    """The leader side of the replication transport (read-only — nothing a
    follower sends can mutate leader state, so a partitioned or malicious
    replica cannot corrupt the write path). Serves the WAL at
    ``log_path`` and the checkpoint generations in ``directory``; use as
    a context manager or call :meth:`start` / :meth:`close`."""

    def __init__(
        self,
        directory: str,
        log_path: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        clock: Callable[[], float] = time.time,
        max_range_bytes: int = 8 * DEFAULT_CHUNK_BYTES,
        health_source: Optional[Callable[[], dict]] = None,
        profile_dir: Optional[str] = None,
        ingress=None,
        stripe_source: Optional[Callable[[dict], dict]] = None,
    ) -> None:
        self.directory = directory
        self.log_path = log_path
        #: optional front-door tier (:class:`~.ingress.Ingress`): when
        #: wired, ``POST /v1/query`` coalesces client probes through it
        #: and ``/healthz`` carries its queue/admission fragment
        self.ingress = ingress
        #: optional stripe-owner surface (a
        #: :meth:`~.stripes.StripeFollower.handle_stripe_op` bound method):
        #: when wired, ``POST /v1/stripe`` answers describe/probes/rows/cols
        #: ops against the owned row range — a typed :class:`ServeError`
        #: (wrong-stripe routing, unknown op) maps to HTTP 400, never a
        #: silently smaller answer
        self.stripe_source = stripe_source
        self.host = host
        self.port = port
        self.max_range_bytes = max_range_bytes
        self._clock = clock
        self._health_source = health_source
        #: where ``/profile`` captures land (shared with the SIGUSR1 path
        #: when the process installed it over the same directory)
        self.profile_dir = profile_dir or os.path.join(
            directory, "profiles"
        )
        self._cm = CheckpointManager(directory)
        self._tip = _WalTip(log_path)
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    # --------------------------------------------------------- lifecycle
    def start(self) -> str:
        """Bind and serve in a background thread; returns the base URL."""
        if self._httpd is not None:
            return self.url
        httpd = _Server((self.host, self.port), _Handler)
        httpd.replication = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"replication-server:{self.port}",
            daemon=True,
        )
        thread.start()
        self._thread = thread
        log_event(
            "replication_server_start", url=self.url,
            directory=self.directory, log_path=self.log_path,
        )
        return self.url

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ReplicationServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- endpoints
    def tip(self) -> dict:
        out = self._tip.refresh()
        lp = lease_path(self.directory)
        out["lease"] = (
            LeaseFile(lp, clock=self._clock).describe()
            if os.path.exists(lp)
            else None
        )
        out["server_time"] = self._clock()
        return out

    def health(self) -> dict:
        """The ``/healthz`` document: role, fencing epoch, WAL tip,
        replica lag, breaker states and AOT-pack validity. The base
        document describes the directory this server fronts (a leader's:
        zero lag, no breakers); a ``health_source`` callable — a
        :class:`~.replication.FollowerService`'s ``health()`` when the
        server fronts a follower mirror — overlays the replica-specific
        truth."""
        tip = self._tip.refresh()
        out: dict = {
            "role": "leader",
            "url": self.url,
            "epoch": tip["last_epoch"],
            "last_seq": tip["last_seq"],
            "wal_size": tip["size"],
            "lag": {"seconds": 0.0, "seq": 0},
            "breakers": {},
            "server_time": self._clock(),
        }
        lp = lease_path(self.directory)
        if os.path.exists(lp):
            try:
                out["lease"] = LeaseFile(lp, clock=self._clock).describe()
            except (OSError, ValueError):
                out["lease"] = None
        # the port ships no AOT pack: absent, with the reason
        out["aot"] = aot_pack_status()
        # live progress plane: every in-flight long job in this process
        # (closure passes, bootstrap shipping, WAL replay, …) plus the
        # newest crash flight dumps — so one /healthz answers "what is
        # this replica doing right now and did it crash recently"
        out["jobs"] = active_jobs()
        out["flight_dumps"] = [
            os.path.basename(p) for p in recent_dumps(limit=3)
        ]
        if self.ingress is not None:
            try:
                out["ingress"] = self.ingress.describe()
            except Exception as e:  # a sick front door is itself a signal
                out["ingress"] = {"error": f"{type(e).__name__}: {e}"}
        if self._health_source is not None:
            try:
                out.update(self._health_source())
            except Exception as e:  # a sick overlay is itself a signal
                out["health_source_error"] = f"{type(e).__name__}: {e}"
        return out

    def profile(self, *, seconds: float = 2.0) -> dict:
        """On-demand deep profiling (``/profile?seconds=N``): a bounded
        ``torch.profiler`` capture into this server's ``profile_dir``,
        rate-limited by :func:`~..observe.spans.capture_profile` so a
        scrape loop cannot DoS the device."""
        return capture_profile(
            seconds, trigger="http", capture_dir=self.profile_dir
        )

    def wal_range(
        self, query: Dict[str, str]
    ) -> Tuple[bytes, Dict[str, str]]:
        limit = min(
            int(query.get("limit", DEFAULT_CHUNK_BYTES)),
            self.max_range_bytes,
        )
        if "start_after_seq" in query:
            offset = wal_offset_after_seq(
                self.log_path, int(query["start_after_seq"])
            )
        else:
            offset = int(query.get("offset", 0))
        if offset < 0 or limit <= 0:
            raise ReplicationError(
                f"invalid WAL range offset={offset} limit={limit}", op="wal"
            )
        try:
            size = os.path.getsize(self.log_path)
        except OSError:
            size = 0
        payload = b""
        if offset < size:
            with open(self.log_path, "rb") as fh:
                fh.seek(offset)
                payload = fh.read(limit)
        return payload, {
            "X-KVTPU-Offset": str(offset),
            "X-KVTPU-Size": str(size),
            "X-KVTPU-Crc32": _payload_crc(payload),
        }

    def checkpoint_manifest(self) -> dict:
        """The newest *valid* generation — walking the ladder exactly like
        recovery, so a torn or bit-rotted newest generation degrades to
        the one below instead of shipping garbage to a follower."""
        for gen in self._cm.generations():
            try:
                manifest = load_manifest(self._cm.manifest_path(gen))
            except (PersistError, FileNotFoundError):
                continue
            snap = self._cm.snapshot_dir(gen)
            if not os.path.isdir(snap):
                continue
            files = []
            for root, _dirs, fnames in os.walk(snap):
                for fname in sorted(fnames):
                    full = os.path.join(root, fname)
                    rel = os.path.relpath(full, snap).replace(os.sep, "/")
                    digest = hashlib.sha256()
                    with open(full, "rb") as fh:
                        for block in iter(lambda: fh.read(1 << 20), b""):
                            digest.update(block)
                    files.append({
                        "path": rel,
                        "size": os.path.getsize(full),
                        "sha256": digest.hexdigest(),
                    })
            return {
                "generation": gen,
                "manifest": manifest,
                "files": sorted(files, key=lambda f: f["path"]),
            }
        return {"generation": None}

    def checkpoint_chunk(
        self, query: Dict[str, str]
    ) -> Tuple[bytes, Dict[str, str]]:
        gen = int(query["generation"])
        rel = query.get("path", "")
        offset = int(query.get("offset", 0))
        limit = min(
            int(query.get("limit", DEFAULT_CHUNK_BYTES)),
            self.max_range_bytes,
        )
        snap = os.path.abspath(self._cm.snapshot_dir(gen))
        full = os.path.abspath(os.path.normpath(os.path.join(snap, rel)))
        # traversal guard: the resolved path must stay inside gen-N/
        if not rel or os.path.isabs(rel) or not full.startswith(
            snap + os.sep
        ):
            raise ReplicationError(
                f"checkpoint path {rel!r} escapes generation {gen}",
                op="file",
            )
        if offset < 0 or limit <= 0:
            raise ReplicationError(
                f"invalid chunk range offset={offset} limit={limit}",
                op="file",
            )
        try:
            with open(full, "rb") as fh:
                fh.seek(offset)
                payload = fh.read(limit)
            size = os.path.getsize(full)
        except FileNotFoundError:
            raise ReplicationError(
                f"generation {gen} has no file {rel!r} (rotated away?)",
                op="file",
            ) from None
        return payload, {
            "X-KVTPU-Offset": str(offset),
            "X-KVTPU-Size": str(size),
            "X-KVTPU-Sha256": hashlib.sha256(payload).hexdigest(),
        }


class ReplicationClient:
    """A follower's (or the load balancer's) handle on one leader URL.

    Every wire request goes through the :func:`net_fault` injection seam,
    carries a per-request ``timeout``, and retries transient failures
    with the policy's capped exponential backoff + jitter before raising
    a typed :class:`ReplicationError`; an optional per-replica ``breaker``
    is fed on every outcome so callers eject dead endpoints."""

    def __init__(
        self,
        base_url: str,
        *,
        timeout: float = 2.0,
        policy: RetryPolicy = DEFAULT_POLICY,
        breaker=None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        parts = urlsplit(base_url)
        if parts.scheme != "http" or not parts.hostname:
            raise ReplicationError(
                f"replication URLs are plain http://host:port, got "
                f"{base_url!r}",
                url=base_url,
            )
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.policy = policy
        self.breaker = breaker
        self._sleep = sleep
        self._host = parts.hostname
        self._port = parts.port or 80

    # ----------------------------------------------------------- plumbing
    def _once(self, op: str, path: str) -> Tuple[bytes, Dict[str, str]]:
        NET_REQUESTS_TOTAL.labels(op=op).inc()
        try:
            net_fault(op)  # the injection seam: may delay or raise
            conn = HTTPConnection(
                self._host, self._port, timeout=self.timeout
            )
            try:
                # propagate the active trace context (if any) so the
                # server-side spans parent under this caller's span
                conn.request("GET", path, headers=trace_headers())
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
                headers = {k: v for k, v in resp.getheaders()}
            finally:
                conn.close()
        except ReplicationError as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            if self.breaker is not None:
                self.breaker.record_failure()
            if e.url is None:
                e.url = self.base_url
            raise
        except (OSError, HTTPException) as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            if self.breaker is not None:
                self.breaker.record_failure()
            raise ReplicationError(
                f"{op} request to {self.base_url} failed: "
                f"{type(e).__name__}: {e}",
                op=op, url=self.base_url,
            ) from e
        if status != 200:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            if self.breaker is not None:
                self.breaker.record_failure()
            detail = body.decode("utf-8", errors="replace")[:200]
            raise ReplicationError(
                f"{op} request to {self.base_url} returned HTTP {status}: "
                f"{detail}",
                op=op, url=self.base_url,
            )
        if self.breaker is not None:
            self.breaker.record_success()
        NET_BYTES_TOTAL.labels(op=op).inc(len(body))
        return body, headers

    def _request(self, op: str, path: str) -> Tuple[bytes, Dict[str, str]]:
        delays = self.policy.delays()
        while True:
            try:
                return self._once(op, path)
            except ReplicationError:
                delay = next(delays, None)
                if delay is None:
                    raise
                self._sleep(delay)

    # ---------------------------------------------------------- endpoints
    def tip(self) -> dict:
        body, _ = self._request("tip", "/v1/tip")
        return json.loads(body)

    def healthz(self) -> dict:
        """The replica's ``/healthz`` document (scrape surface)."""
        body, _ = self._request("healthz", "/healthz")
        return json.loads(body)

    def metrics_text(self, *, exemplars: bool = False) -> str:
        """The replica's ``/metrics`` Prometheus text exposition
        (``exemplars=True`` requests the OpenMetrics exemplar
        annotations)."""
        path = "/metrics?exemplars=1" if exemplars else "/metrics"
        body, _ = self._request("metrics", path)
        return body.decode("utf-8")

    def profile(self, seconds: float = 2.0) -> dict:
        """Trigger a bounded deep-profile capture on the replica
        (``/profile?seconds=N``); raises :class:`ReplicationError` when
        the replica refused (rate-limited → HTTP 429)."""
        body, _ = self._request(
            "profile", f"/profile?seconds={float(seconds)}"
        )
        return json.loads(body)

    def query(
        self,
        probes,
        *,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        priority: Optional[int] = None,
    ) -> List[bool]:
        """``POST /v1/query``: answer ``probes`` through the replica's
        front-door ingress tier. A 429/503 refusal is re-raised as the
        same typed :class:`AdmissionRejectedError` the server threw
        (reason + finite retry-after reconstructed from the body), so a
        local caller and a wire caller handle overload identically."""
        op = "query"
        NET_REQUESTS_TOTAL.labels(op=op).inc()
        body = json.dumps(
            {
                "probes": [list(p) for p in probes],
                "tenant": tenant,
                "deadline_s": deadline_s,
                "priority": priority,
            }
        ).encode("utf-8")
        try:
            net_fault(op)  # the injection seam, same as every wire request
            conn = HTTPConnection(
                self._host, self._port, timeout=self.timeout
            )
            try:
                headers = dict(trace_headers())
                headers["Content-Type"] = "application/json"
                headers["X-Kvtpu-Tenant"] = tenant
                conn.request("POST", "/v1/query", body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
            finally:
                conn.close()
        except (OSError, HTTPException) as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"query request to {self.base_url} failed: "
                f"{type(e).__name__}: {e}",
                op=op, url=self.base_url,
            ) from e
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"query response from {self.base_url} was not JSON "
                f"(HTTP {status})",
                op=op, url=self.base_url,
            ) from e
        if status in (429, 503) and "retry_after_s" in doc:
            raise AdmissionRejectedError(
                doc.get("error", f"admission rejected (HTTP {status})"),
                retry_after_s=float(doc["retry_after_s"]),
                tenant=doc.get("tenant"),
                reason=doc.get("reason", "over-quota"),
            )
        if status != 200:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"query request to {self.base_url} returned HTTP {status}: "
                f"{doc.get('error', '')[:200]}",
                op=op, url=self.base_url,
            )
        NET_BYTES_TOTAL.labels(op=op).inc(len(payload))
        return [bool(a) for a in doc.get("answers", [])]

    def stripe_op(self, doc: dict) -> dict:
        """``POST /v1/stripe``: one stripe-owner operation (``describe`` /
        ``probes`` / ``rows`` / ``cols`` — the wire form of
        :meth:`~.stripes.StripeFollower.handle_stripe_op`). An HTTP 400
        is re-raised as the typed :class:`ServeError` the owner threw
        (a routing bug — e.g. a row outside the owned stripe — not a
        transport fault, so the coordinator must NOT eject the owner for
        it); transport failures and non-owner replicas (503) raise
        :class:`ReplicationError` as every other wire op does."""
        op = "stripe"
        NET_REQUESTS_TOTAL.labels(op=op).inc()
        body = json.dumps(doc).encode("utf-8")
        try:
            net_fault(op)  # the injection seam, same as every wire request
            conn = HTTPConnection(
                self._host, self._port, timeout=self.timeout
            )
            try:
                headers = dict(trace_headers())
                headers["Content-Type"] = "application/json"
                conn.request(
                    "POST", "/v1/stripe", body=body, headers=headers
                )
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
            finally:
                conn.close()
        except (OSError, HTTPException) as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"stripe request to {self.base_url} failed: "
                f"{type(e).__name__}: {e}",
                op=op, url=self.base_url,
            ) from e
        try:
            out = json.loads(payload.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"stripe response from {self.base_url} was not JSON "
                f"(HTTP {status})",
                op=op, url=self.base_url,
            ) from e
        if status == 400:
            raise ServeError(
                out.get("error", "stripe op rejected (HTTP 400)")
            )
        if status != 200:
            NET_REQUEST_FAILURES_TOTAL.labels(op=op).inc()
            raise ReplicationError(
                f"stripe request to {self.base_url} returned HTTP "
                f"{status}: {out.get('error', '')[:200]}",
                op=op, url=self.base_url,
            )
        NET_BYTES_TOTAL.labels(op=op).inc(len(payload))
        return out

    def wal(
        self,
        *,
        offset: Optional[int] = None,
        start_after_seq: Optional[int] = None,
        limit: int = DEFAULT_CHUNK_BYTES,
    ) -> Tuple[bytes, Dict[str, int]]:
        """One WAL range: returns ``(payload, {"offset", "size"})`` after
        verifying the crc32 the server stamped over the payload."""
        if (offset is None) == (start_after_seq is None):
            raise ReplicationError(
                "wal() takes exactly one of offset= / start_after_seq=",
                op="wal", url=self.base_url,
            )
        if offset is not None:
            qs = f"offset={int(offset)}"
        else:
            qs = f"start_after_seq={int(start_after_seq)}"
        body, headers = self._request("wal", f"/v1/wal?{qs}&limit={limit}")
        want = headers.get("X-KVTPU-Crc32")
        got = _payload_crc(body)
        if want is not None and got != want:
            NET_REQUEST_FAILURES_TOTAL.labels(op="wal").inc()
            raise ReplicationError(
                f"WAL range from {self.base_url} arrived corrupted "
                f"(crc {got}, stamped {want})",
                op="wal", url=self.base_url,
            )
        return body, {
            "offset": int(headers.get("X-KVTPU-Offset", 0)),
            "size": int(headers.get("X-KVTPU-Size", 0)),
        }

    def manifest(self) -> dict:
        body, _ = self._request("manifest", "/v1/checkpoint/manifest")
        return json.loads(body)

    def fetch_file(
        self,
        generation: int,
        relpath: str,
        dest_path: str,
        *,
        expected_sha256: Optional[str] = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ) -> int:
        """Chunked download of one snapshot file to ``dest_path`` (written
        tmp + fsync + ``os.replace``), verifying the per-chunk sha256 the
        server stamps and — when ``expected_sha256`` is given — the whole
        file against the manifest listing. Returns bytes transferred."""
        parent = os.path.dirname(dest_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        digest = hashlib.sha256()
        total = 0
        tmp = dest_path + ".fetch"
        with open(tmp, "wb") as fh:
            while True:
                payload, headers = self._request(
                    "file",
                    f"/v1/checkpoint/file?generation={int(generation)}"
                    f"&path={relpath}&offset={total}&limit={chunk_bytes}",
                )
                want = headers.get("X-KVTPU-Sha256")
                if (
                    want is not None
                    and hashlib.sha256(payload).hexdigest() != want
                ):
                    NET_REQUEST_FAILURES_TOTAL.labels(op="file").inc()
                    raise ReplicationError(
                        f"chunk of {relpath!r} at offset {total} arrived "
                        "checksum-mismatched",
                        op="file", url=self.base_url,
                    )
                fh.write(payload)
                digest.update(payload)
                total += len(payload)
                if len(payload) < chunk_bytes:
                    break
            fh.flush()
            os.fsync(fh.fileno())
        if (
            expected_sha256 is not None
            and digest.hexdigest() != expected_sha256
        ):
            os.remove(tmp)
            raise ReplicationError(
                f"{relpath!r} from generation {generation} failed its "
                f"manifest checksum after transfer (got "
                f"{digest.hexdigest()[:12]}…, want {expected_sha256[:12]}…)",
                op="file", url=self.base_url,
            )
        os.replace(tmp, dest_path)
        return total


def bootstrap_from_leader(
    client: ReplicationClient, directory: str, *, fsync: bool = True
) -> dict:
    """Snapshot shipping: mirror the leader's newest valid checkpoint
    generation into ``directory``.

    The transfer lands in a ``.tmp-fetch-gen-N/`` staging dir, every file
    is verified against its manifest sha256, the whole tree against the
    manifest's ``snapshot_digest``, and only then is the tree promoted
    (``os.replace``) and the manifest written — *last*, because its
    presence is the commit, exactly like a locally written generation. A
    crash or fault mid-transfer leaves staging garbage the next attempt
    sweeps, never a half generation recovery could mistake for real."""
    info = client.manifest()
    gen = info.get("generation")
    if gen is None:
        return {"outcome": "no-checkpoint", "generation": None}
    manifest = info["manifest"]
    if _manifest_checksum(manifest) != manifest.get("checksum"):
        raise ReplicationError(
            f"leader {client.base_url} shipped a manifest whose checksum "
            f"does not verify (generation {gen})",
            op="manifest", url=client.base_url,
        )
    cm = CheckpointManager(directory)
    mpath = cm.manifest_path(gen)
    if os.path.exists(mpath):
        try:
            load_manifest(mpath)
            return {"outcome": "already-local", "generation": gen}
        except PersistError:
            pass  # damaged local copy: refetch over it
    tmp_dir = os.path.join(directory, f".tmp-fetch-gen-{gen:08d}")
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    total = 0
    # chunk shipping is the long pole of a cold follower start: one tick
    # per manifest file feeds `kv-tpu jobs` / /healthz with a live ETA
    with ProgressTicker(
        "bootstrap", total=len(info["files"]), unit="file"
    ) as ticker:
        for entry in info["files"]:
            rel = entry["path"]
            dest = os.path.abspath(
                os.path.normpath(os.path.join(tmp_dir, rel))
            )
            if not dest.startswith(os.path.abspath(tmp_dir) + os.sep):
                raise ReplicationError(
                    f"leader listed a snapshot path {rel!r} that escapes "
                    "the generation — refusing the transfer",
                    op="manifest", url=client.base_url,
                )
            total += client.fetch_file(
                gen, rel, dest, expected_sha256=entry.get("sha256")
            )
            ticker.tick(bytes=total, file=rel)
    tree = _tree_digest(tmp_dir)
    if tree != manifest["snapshot_digest"]:
        raise ReplicationError(
            f"generation {gen} tree digest mismatch after transfer (got "
            f"{tree[:12]}…, manifest {manifest['snapshot_digest'][:12]}…) — "
            "partial or corrupted snapshot shipping",
            op="file", url=client.base_url,
        )
    if fsync:
        _fsync_tree(tmp_dir)
    snap_dir = cm.snapshot_dir(gen)
    if os.path.exists(snap_dir):
        shutil.rmtree(snap_dir)  # manifest was absent/damaged: stale tree
    os.replace(tmp_dir, snap_dir)
    if fsync:
        _fsync_dir(directory)
    _atomic_write_json(mpath, manifest, fsync=fsync)
    log_event(
        "bootstrap_fetch", url=client.base_url, generation=gen,
        files=len(info["files"]), transferred_bytes=total,
    )
    return {
        "outcome": "fetched",
        "generation": gen,
        "files": len(info["files"]),
        "bytes": total,
    }


class RemoteEventSource:
    """An :class:`~.events.EventSource` whose file grows by fetching the
    leader's WAL over a :class:`ReplicationClient`.

    The mirror at ``mirror_path`` is a **byte replica**: every sync
    appends the leader's raw bytes at exactly our current mirror size, so
    a mirror offset *is* a leader offset and every shared-filesystem
    invariant — checkpoint ``log_offset`` bindings, ``scan_wal``
    validation, crc/epoch/seq read-side fencing — holds verbatim on the
    wrapped inner source. Fetch failures are swallowed into
    ``last_error`` (the follower keeps serving stale reads from the
    mirror); ``last_contact`` feeds the follower's staleness accounting
    so a partitioned replica's lag grows instead of lying at zero."""

    def __init__(
        self,
        client: Optional[ReplicationClient],
        mirror_path: str,
        *,
        inner: Optional[EventSource] = None,
        start_after_seq: Optional[int] = None,
        min_epoch: Optional[int] = None,
        limit_bytes: int = DEFAULT_CHUNK_BYTES,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.client = client
        self.mirror_path = mirror_path
        self.limit_bytes = limit_bytes
        self._clock = clock
        if not os.path.exists(mirror_path):
            # materialise the empty mirror up front: a follower whose
            # very first fetch dies (partition right after bootstrap)
            # must serve its empty stale prefix, not crash on a read
            with open(mirror_path, "ab"):  # kvtpu: ignore[atomic-write] an empty byte-replica prefix; nothing torn to repair
                pass
        self.inner = inner if inner is not None else EventSource(
            mirror_path, start_after_seq=start_after_seq, min_epoch=min_epoch
        )
        self._remote_offset = (
            os.path.getsize(mirror_path)
            if os.path.exists(mirror_path)
            else 0
        )
        self.detached = False
        self.last_contact: Optional[float] = None
        self.last_error: Optional[ReplicationError] = None
        self.fetched_bytes = 0

    # ------------------------------------------- EventSource delegation
    @property
    def path(self) -> str:
        return self.inner.path

    @property
    def offset(self) -> int:
        return self.inner.offset

    @property
    def last_seq(self) -> int:
        return self.inner.last_seq

    @property
    def last_epoch(self) -> Optional[int]:
        return self.inner.last_epoch

    @property
    def skipped(self) -> int:
        return self.inner.skipped

    @property
    def fenced(self) -> int:
        return self.inner.fenced

    @property
    def min_epoch(self) -> Optional[int]:
        return self.inner.min_epoch

    @min_epoch.setter
    def min_epoch(self, value: Optional[int]) -> None:
        self.inner.min_epoch = value

    # ----------------------------------------------------------- fetching
    def _fetch(self) -> int:
        """One WAL range request; returns payload bytes appended (0 when
        caught up or detached). Raises :class:`ReplicationError` on wire
        failure — callers via :meth:`_sync` swallow it."""
        if self.detached or self.client is None:
            return 0
        payload, info = self.client.wal(
            offset=self._remote_offset, limit=self.limit_bytes
        )
        size = info["size"]
        if size < self._remote_offset:
            # The leader's log shrank: a torn-tail repair on its restart
            # dropped bytes we had fetched but (by construction: fsync'd
            # records survive repair, and the inner source never consumes
            # a torn tail) not applied. Drop our unconsumed surplus too.
            if size < self.inner.offset:
                raise ReplicationError(
                    f"leader WAL shrank to {size} bytes, below our applied "
                    f"prefix at {self.inner.offset} — divergent history; "
                    "this follower must re-bootstrap",
                    op="wal",
                    url=self.client.base_url,
                )
            self.truncate_unconsumed()
            self.last_contact = self._clock()
            return 0
        if payload:
            with open(self.mirror_path, "ab") as fh:  # kvtpu: ignore[atomic-write] WAL mirror append: a torn tail here is repaired by scan_wal exactly like a local WAL
                fh.write(payload)
            self._remote_offset += len(payload)
            self.fetched_bytes += len(payload)
        self.last_contact = self._clock()
        return len(payload)

    def _sync(self) -> int:
        """Fetch until the leader has nothing more for us (or the wire
        fails — recorded, not raised: a partitioned follower serves stale
        reads from its mirror rather than dying)."""
        fetched = 0
        try:
            while True:
                got = self._fetch()
                fetched += got
                if got < self.limit_bytes:
                    break
            self.last_error = None
        except ReplicationError as e:
            self.last_error = e
        return fetched

    def detach(self) -> None:
        """Stop fetching permanently (promotion: our mirror is the WAL of
        record now — appending a deposed leader's bytes after our own
        would hand scan_wal an epoch regression)."""
        self.detached = True

    def truncate_unconsumed(self) -> None:
        """Drop mirror bytes past the inner source's consumed offset —
        repoint hygiene: unapplied bytes fetched from the old leader may
        not exist on the new one."""
        with open(self.mirror_path, "rb+") as fh:  # kvtpu: ignore[atomic-write] truncating to the consumed prefix is idempotent, same contract as scan_wal's torn-tail repair
            fh.truncate(self.inner.offset)
        self._remote_offset = self.inner.offset

    def set_client(self, client: ReplicationClient) -> None:
        """Swap leaders (failover repoint) and resume fetching."""
        self.client = client
        self.detached = False
        self.last_error = None

    # ----------------------------------------------------------- reading
    def replay(self) -> Iterator[Event]:
        self._sync()
        yield from self.inner.replay()

    def batches(self, batch_size: int = 64) -> Iterator[List[Event]]:
        self._sync()
        yield from self.inner.batches(batch_size)
