"""Replica serving worker: one HTTP process per fleet member (port of
paddle_tpu/serving/replica.py).

Each replica wraps the hardened ``ServingRuntime`` (batcher, breaker,
watchdog, outcome ledger) behind a tiny stdlib HTTP surface — the same
no-new-dependency stance as the metrics exporter.  It serves on the
card unless it is given a CPU place (``--device cpu``):

- ``POST /infer``  — one request: JSON ``{"feed": {...}, "deadline_s"}``
  with an optional W3C ``traceparent`` header the runtime joins, so one
  request's span tree covers router + replica.
- ``GET /healthz`` — the exporter's health verdict plus replica state:
  503 while DRAINING (the router stops routing, in-flight work
  completes) or while a swap warms the incoming version.
- ``GET /stats``   — per-version outcome ledgers + the merged replica
  ledger (``requests == sum(outcomes)`` across every runtime this
  process ever ran), current version, bucket warm-up count, AOT
  import/export tallies — what the router scrapes for the fleet ledger.
- ``GET /metrics`` — the full Prometheus scrape (exporter.prometheus_text).
- ``GET /trace``   — retained span trees, so the bench can join a
  router-side tree to this replica's spans by trace id.
- ``POST /swap``   — hot-swap to ``{"version": N}`` from the registry.

Hot-swap is ZERO-DROP by construction: the incoming version is built
and warmed (AOT cache import when the registry has artifacts for this
device kind, counted bucket warm-ups otherwise — and the first warmer
publishes the artifacts back) BEFORE the atomic flip; only then is the
outgoing runtime closed, whose ``close()`` drains the queue — the
batcher keeps dispatching until the queue is empty before failing
anything.  A request that races the flip into a closing runtime is
resubmitted once on the new one.

Chaos: the request path visits ``faultinject.kill_point("replica.infer")``
so an armed worker dies mid-request via ``os._exit(1)`` — the router
sees a reset socket, classifies it PREEMPTION, and fails over.

Worker processes are started with ``subprocess`` (``python -m
paddle_tpu_torch.serving.replica``), never forked from a process that
has initialised CUDA.
"""

import argparse
import http.server
import json
import os
import threading

import numpy as np
import torch

from ..core.place import resolve_device
from ..inference import Predictor
from ..resilience import faultinject
from ..resilience.taxonomy import classify, is_transient
from .registry import ModelRegistry
from .runtime import (DeadlineExceeded, QueueFullError,
                      ServingClosedError, ServingRuntime)

__all__ = ["ModelHost", "ReplicaServer", "main"]


def _mon():
    from .. import monitor

    return monitor


def _device_kind(device):
    """The AOT cache's device key: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class ModelHost:
    """Owns the replica's active (version, ServingRuntime) pair and the
    per-version ledger history; performs zero-drop hot swaps.  `place`
    is where the models run: None means `cuda` (raising on a host
    without one), as every entry point of the port."""

    def __init__(self, registry, name="replica", config_kw=None,
                 place=None):
        self.registry = registry if isinstance(registry, ModelRegistry) \
            else ModelRegistry(registry)
        self.name = name
        self.device = resolve_device(place)
        self.device_kind = _device_kind(self.device)
        self._config_kw = dict(config_kw or {})
        self._flip_lock = threading.Lock()   # guards the active pair
        self._swap_lock = threading.Lock()   # serializes swaps
        self._runtime = None
        self._version = None
        self._history = []    # [(version, ServingStats)] — every runtime
        self.aot_imported = 0
        self.aot_exported = 0
        self.bucket_compiles = 0
        self.swaps = 0

    # -- lifecycle ------------------------------------------------------
    @property
    def version(self):
        return self._version

    @property
    def runtime(self):
        return self._runtime

    def _build_runtime(self, version):
        """Build + WARM a runtime for `version`: import the AOT cache
        when the registry has artifacts for this device kind (zero
        bucket warm-ups), warm each bucket otherwise — and publish the
        artifacts back so the NEXT cold replica wins."""
        pred = Predictor(self.registry.version_dir(version),
                         place=self.device)
        kind = self.device_kind
        kw = dict(self._config_kw)
        kw.setdefault("label", f"{self.name}/v{version}")
        kw["prewarm"] = False
        rt = ServingRuntime(pred, **kw)
        if self.registry.has_aot(version, kind):
            self.aot_imported += rt.dispatcher.import_aot(
                self.registry.aot_dir(version, kind))
        # warm whatever the cache did not cover (everything, on a cache
        # miss), BEFORE the flip
        rt.prewarmed = rt.dispatcher.prewarm()
        self.bucket_compiles += rt.prewarmed
        if rt.prewarmed:
            try:
                self.aot_exported += self.registry.publish_aot(
                    version, kind, rt.dispatcher.export_aot)
            except Exception:
                pass          # a torn cache write must not fail a swap
        return rt

    def start(self, version=None):
        if version is None:
            version = self.registry.current()
        if version is None:
            version = self.registry.latest()
        if version is None:
            raise ValueError("registry has no published versions")
        rt = self._build_runtime(int(version))
        with self._flip_lock:
            self._runtime, self._version = rt, int(version)
        self._history.append((int(version), rt.stats))
        return self._version

    def swap_to(self, version):
        """Hot-swap to `version`: build + warm the new runtime, flip
        atomically, THEN drain the old one (its close() serves the
        whole queue before failing anything) — zero dropped requests,
        asserted fleet-wide via the merged outcome ledger."""
        version = int(version)
        with self._swap_lock:
            old_version = self._version
            if version == old_version:
                return old_version
            rt = self._build_runtime(version)
            self._history.append((version, rt.stats))
            with self._flip_lock:
                old, self._runtime = self._runtime, rt
                self._version = version
            self.swaps += 1
            mon = _mon()
            if mon.is_enabled():
                mon.counter("fleet.model_swap").add(1)
            if old is not None:
                old.close(timeout=30.0)
            return old_version

    def close(self, timeout=10.0):
        with self._flip_lock:
            rt, self._runtime = self._runtime, None
        if rt is not None:
            rt.close(timeout=timeout)

    # -- request path ---------------------------------------------------
    def run(self, feed, deadline_s=None, timeout=None, traceparent=None):
        """One request through the ACTIVE runtime.  A submit that races
        a swap's flip into the closing runtime is resubmitted once on
        the new one — the drain contract still resolves everything that
        made it into the old queue."""
        for attempt in (0, 1):
            with self._flip_lock:
                rt = self._runtime
            if rt is None:
                raise ServingClosedError("replica is shut down")
            try:
                return rt.run(feed, deadline_s=deadline_s,
                              timeout=timeout, traceparent=traceparent)
            except ServingClosedError:
                if attempt:
                    raise
        raise AssertionError("unreachable")

    # -- ledgers --------------------------------------------------------
    def merged_ledger(self):
        """The replica-wide outcome ledger: requests/outcomes summed
        over EVERY runtime this process ran (drained versions keep
        their final counts) — the per-replica row of the fleet merge."""
        requests = 0
        outcomes = {}
        per_version = []
        for version, stats in self._history:
            s = stats.summary()
            requests += s["requests"]
            for k, v in s["outcomes"].items():
                outcomes[k] = outcomes.get(k, 0) + v
            per_version.append({"version": version, "key": s["key"],
                                "requests": s["requests"],
                                "outcomes": s["outcomes"],
                                "pending": s["pending"]})
        resolved = sum(outcomes.values())
        return {"requests": requests, "outcomes": outcomes,
                "resolved": resolved, "pending": requests - resolved,
                "per_version": per_version}

    def stats_doc(self):
        active = None
        with self._flip_lock:
            rt, version = self._runtime, self._version
        if rt is not None:
            active = rt.summary()
        return {
            "name": self.name,
            "version": version,
            "device_kind": self.device_kind,
            "merged": self.merged_ledger(),
            "active": active,
            "swaps": self.swaps,
            "aot_imported": self.aot_imported,
            "aot_exported": self.aot_exported,
            "serving_compile_events": self.bucket_compiles,
        }


def _make_handler(server):
    class _ReplicaHandler(http.server.BaseHTTPRequestHandler):
        def _reply(self, code, doc):
            body = json.dumps(doc, sort_keys=True).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server contract
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                code, doc = server.health_doc()
                self._reply(code, doc)
            elif path == "/stats":
                self._reply(200, server.host.stats_doc())
            elif path == "/trace":
                from ..monitor import tracing

                self._reply(200,
                            {"trees": tracing.get().retained_trees()})
            elif path == "/metrics":
                from ..monitor import exporter

                try:
                    body = exporter.prometheus_text().encode()
                except Exception as e:  # noqa: BLE001 — scrape safety
                    self._reply_text(500, f"# scrape failed: {e}\n"
                                     .encode(), "text/plain")
                    return
                self._reply_text(
                    200, body,
                    "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 — http.server contract
            path = self.path.split("?", 1)[0]
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
            except Exception as e:
                self._reply(400, {"error": f"bad request body: {e}",
                                  "kind": "fatal"})
                return
            if path == "/infer":
                self._infer(doc)
            elif path == "/swap":
                self._swap(doc)
            else:
                self._reply(404, {"error": "not found"})

        def _infer(self, doc):
            if server.draining:
                self._reply(503, {"error": "replica is draining",
                                  "kind": "draining"})
                return
            # the chaos kill lands HERE: the request is in flight from
            # the router's point of view, so the death surfaces as a
            # mid-request connection reset — the failover shape
            faultinject.kill_point("replica.infer")
            try:
                feed = {k: np.asarray(v)
                        for k, v in (doc.get("feed") or {}).items()}
                outs = server.host.run(
                    feed, deadline_s=doc.get("deadline_s"),
                    traceparent=self.headers.get("traceparent"))
                self._reply(200, {
                    "outputs": [np.asarray(o).tolist() for o in outs],
                    "version": server.host.version,
                    "replica": server.host.name})
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e), "kind": "deadline"})
            except QueueFullError as e:
                self._reply(503, {"error": str(e), "kind": "overload"})
            except ServingClosedError as e:
                self._reply(503, {"error": str(e), "kind": "closed"})
            except Exception as e:  # noqa: BLE001 — classified reply
                self._reply(500, {
                    "error": f"{type(e).__name__}: {e}"[:500],
                    "kind": ("transient" if is_transient(e)
                             else classify(e))})

        def _swap(self, doc):
            try:
                version = int(doc["version"])
            except (KeyError, TypeError, ValueError):
                self._reply(400, {"error": "body must carry an integer "
                                           "'version'", "kind": "fatal"})
                return
            try:
                previous = server.host.swap_to(version)
            except Exception as e:  # noqa: BLE001 — classified reply
                self._reply(500, {
                    "error": f"{type(e).__name__}: {e}"[:500],
                    "kind": classify(e)})
                return
            self._reply(200, {"version": server.host.version,
                              "previous": previous})

        def log_message(self, *args):  # requests are not app logs
            pass

    return _ReplicaHandler


class ReplicaServer:
    """One replica process's HTTP front: a daemon-threaded stdlib
    server around a ModelHost.  ``port=0`` binds ephemeral (callers
    read ``.port`` back) — runnable in-process for tests or as the
    subprocess worker via ``python -m paddle_tpu_torch.serving.replica``.
    `place` is the ModelHost's (None means `cuda`)."""

    def __init__(self, registry, name="replica", host="127.0.0.1",
                 port=0, version=None, config_kw=None, place=None):
        self.host_model = self.host = ModelHost(registry, name=name,
                                                config_kw=config_kw,
                                                place=place)
        self.host.start(version)
        self.draining = False
        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.addr = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"paddle_tpu_torch-replica-{name}", daemon=True)
        self._thread.start()

    @property
    def base_url(self):
        return f"http://{self.addr}:{self.port}"

    def health_doc(self):
        """(status code, body) for /healthz: the exporter's fleet-wide
        verdict plus replica drain state — 503 tells the router to stop
        routing here while in-flight work completes."""
        from ..monitor import exporter

        if self.draining:
            return 503, {"ok": False, "reason": "draining",
                         "replica": self.host.name,
                         "version": self.host.version}
        ok, checks = exporter.health()
        doc = {"ok": ok, "checks": checks, "replica": self.host.name,
               "version": self.host.version}
        if not ok:
            doc["reason"] = exporter._health_reason(checks)
        return (200 if ok else 503), doc

    def drain(self):
        self.draining = True

    def close(self, timeout=10.0):
        """Graceful: stop routing (the socket closes), then drain the
        runtime — every queued request resolves before shutdown."""
        self.draining = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self.host.close(timeout=timeout)

    def kill(self):
        """Abrupt in-process death for tests: the socket goes away
        without draining anything — connections reset, exactly what a
        killed process looks like from the router (the REAL kill is
        faultinject.kill_point in the subprocess worker)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def _write_endpoint_file(path, doc):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None):
    """Subprocess worker entry (``python -m
    paddle_tpu_torch.serving.replica``): serve one replica until killed.
    Writes an endpoint file (atomic) once the socket is bound so the
    spawner can discover the ephemeral port; ``--kill-point`` arms the
    replica-kill chaos primitive; ``--device`` places the models (cuda
    by default, or cpu)."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--name", default="replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--version", type=int, default=None)
    ap.add_argument("--endpoint-file", default=None)
    ap.add_argument("--telemetry", default=None,
                    help="enable monitor with this JSONL path")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the models run: cuda (default) or cpu")
    ap.add_argument("--kill-point", default=None, metavar="NAME:HIT",
                    help="arm faultinject kill_points={NAME: HIT}")
    args = ap.parse_args(argv)

    from .. import monitor

    if args.telemetry:
        monitor.reset()
        monitor.enable(jsonl_path=args.telemetry)
    else:
        monitor.enable()
    if args.kill_point:
        name, _, hit = args.kill_point.partition(":")
        faultinject.arm(kill_points={name: int(hit or 0)})

    srv = ReplicaServer(args.registry, name=args.name, host=args.host,
                        port=args.port, version=args.version,
                        config_kw={"max_batch_size": args.max_batch},
                        place=args.device)
    if args.endpoint_file:
        _write_endpoint_file(args.endpoint_file, {
            "name": args.name, "host": args.host, "port": srv.port,
            "pid": os.getpid(), "version": srv.host.version})
    threading.Event().wait()      # serve until the spawner kills us


if __name__ == "__main__":
    main()
