"""Live /metrics + /healthz exporter (port of
paddle_tpu/monitor/exporter.py).

A stdlib ``http.server`` daemon thread — no new dependencies — serving:

- ``/metrics`` — Prometheus text format (0.0.4): every monitor counter
  and gauge, the flight recorder's gate-free event counters, the
  serving outcome ledger (``requests == sum(outcomes)`` — the identity
  the tests assert on the scrape itself), exact serving p50/p99,
  circuit-breaker state, the request-tracing SLO families and the fleet
  router's per-replica rows.  The metric names are the reference's
  (prefix ``paddle_tpu``), so a dashboard reads either package.
- ``/healthz`` — rc reflects live health: 503 when any serving breaker
  is open or a watchdog-flagged dispatch is still wedged in flight;
  200 otherwise, body JSON either way.

The reference's peak-memory, fleet-skew and elastic-topology blocks and
its anomaly-guard health check read modules of ROADMAP item 10, and are
left out until those are ported.

Off by default (``FLAGS_metrics_port=0``): the serving hot paths carry
no exporter code at all — ``ensure_started`` is called from
``monitor.enable()`` and ``ServingRuntime.start()``, never per request.
Scrapes read the same registries ``monitor.snapshot()`` does, so the
two views cannot drift.
"""

import http.server
import json
import re
import threading

from .. import flags

__all__ = ["MetricsServer", "prometheus_text", "parse_prometheus",
           "exported_name", "metric_key",
           "health", "start", "stop", "ensure_started", "active"]

_PREFIX = "paddle_tpu"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_lock = threading.Lock()
_server = None


def _sanitize(name):
    return _NAME_RE.sub("_", name)


def _fmt(value):
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float) and value == int(value) \
            and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value)) if isinstance(value, float) else str(value)


def _esc_label(value):
    """Exposition-format label escaping: backslash, double quote and
    newline are the three characters the text format reserves."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _line(out, name, value, labels=None, kind=None, help_=None):
    full = f"{_PREFIX}_{_sanitize(name)}"
    if kind and full not in out["typed"]:
        if help_:
            out["lines"].append(f"# HELP {full} {help_}")
        out["lines"].append(f"# TYPE {full} {kind}")
        out["typed"].add(full)
    if labels:
        lab = ",".join(f'{_sanitize(k)}="{_esc_label(v)}"'
                       for k, v in sorted(labels.items()))
        out["lines"].append(f"{full}{{{lab}}} {_fmt(value)}")
    else:
        out["lines"].append(f"{full} {_fmt(value)}")


def prometheus_text():
    """The full scrape body.  Gate-free reads only: registries, the
    flight recorder's counters, the serving stats ledger, the trace
    store and the fleet routers' cached state.  (The reference's fleet
    skew, peak-memory and elastic blocks are ROADMAP item 10.)"""
    from .. import monitor

    out = {"lines": [], "typed": set()}
    reg = monitor._registry.snapshot()
    # these registry names sanitize to the SAME families the serving-
    # ledger block below owns with {runtime=...} labels — emitting both
    # would split the family (promtool/OpenMetrics reject that) and
    # show two diverging series for one concept
    ledger_owned = {"serving.requests", "serving.queue_depth",
                    "serving.in_flight", "fleet.process_count"}
    for name, value in sorted(reg["counters"].items()):
        if name in ledger_owned:
            continue
        _line(out, name + "_total", value, kind="counter")
    for name, value in sorted(reg["gauges"].items()):
        if name in ledger_owned:
            continue
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            _line(out, name, value, kind="gauge")
    # flight-recorder event counters move even with telemetry off — the
    # post-mortem view and the scrape must agree on recovery history
    try:
        from . import flight_recorder

        for name, value in sorted(
                flight_recorder.get().snapshot()["counters"].items()):
            _line(out, f"flight_{name}_total", value, kind="counter")
    except Exception:
        pass
    # serving outcome ledger: requests == sum(outcomes) BY CONSTRUCTION
    # — exported per outcome so the scrape itself carries the identity
    try:
        from ..serving import stats as serving_stats

        # family-outer loops: the exposition format requires ALL
        # samples of one metric to form a single contiguous group, so
        # with >=2 runtimes we must not interleave families row-by-row
        rows = list(serving_stats.serving_table())
        for row in rows:
            _line(out, "serving_requests_total", row["requests"],
                  labels={"runtime": row["key"]}, kind="counter",
                  help_="equals sum of serving_outcome_total plus "
                        "in-flight pending")
        for row in rows:
            for outcome, n in sorted(row["outcomes"].items()):
                _line(out, "serving_outcome_total", n,
                      labels={"runtime": row["key"], "outcome": outcome},
                      kind="counter")
        for gname, field in (("serving_pending", "pending"),
                             ("serving_queue_depth", "queue_depth"),
                             ("serving_in_flight", "in_flight")):
            for row in rows:
                _line(out, gname, row[field],
                      labels={"runtime": row["key"]}, kind="gauge")
        for q in ("p50_ms", "p99_ms"):
            for row in rows:
                lat = row.get("latency") or {}
                if lat.get(q) is not None:
                    _line(out, f"serving_latency_{q}", lat[q],
                          labels={"runtime": row["key"]}, kind="gauge")
        for row in rows:
            br = row.get("breaker") or {}
            if br.get("state"):
                for state in ("closed", "open", "half_open"):
                    _line(out, "serving_breaker_state",
                          1 if br["state"] == state else 0,
                          labels={"runtime": row["key"], "state": state},
                          kind="gauge")
        for row in rows:
            if row.get("stalled_in_flight") is not None:
                _line(out, "serving_stalled_in_flight",
                      row["stalled_in_flight"],
                      labels={"runtime": row["key"]}, kind="gauge")
        # decode-engine families: new names, NOT extra
        # labels on the families above — a decode row is a superset of
        # a serving row, and adding decode-only samples to an existing
        # family would split it across scrapes with mixed runtimes
        for row in rows:
            dec = row.get("decode")
            if dec:
                _line(out, "decode_tokens_total", dec["tokens_total"],
                      labels={"runtime": row["key"]}, kind="counter",
                      help_="tokens emitted by decode steps (excludes "
                            "prefill first-tokens)")
        for row in rows:
            dec = row.get("decode") or {}
            if dec.get("slot_occupancy_mean") is not None:
                _line(out, "decode_slot_occupancy",
                      dec["slot_occupancy_mean"],
                      labels={"runtime": row["key"]}, kind="gauge",
                      help_="mean fraction of KV-cache slots live per "
                            "decode step")
    except Exception:
        pass
    # request-tracing SLO families: cumulative violation
    # counter + window burn-rate gauge per traced serving label, driven
    # by FLAGS_serving_slo_ms.  Family-outer like the ledger block.
    try:
        from . import tracing

        store = tracing.get()
        slos = [s for s in (store.slo_table(lb) for lb in store.labels())
                if s is not None and s["slo_ms"] > 0.0]
        for s in slos:
            _line(out, "serving_slo_violations_total",
                  s["violations_total"],
                  labels={"runtime": s["label"]}, kind="counter",
                  help_="completed requests slower than "
                        "FLAGS_serving_slo_ms")
        for s in slos:
            _line(out, "serving_slo_burn_rate", s["burn_rate"],
                  labels={"runtime": s["label"]}, kind="gauge",
                  help_="violating fraction of the completed-request "
                        "window")
    except Exception:
        pass
    # fleet serving tier: per-router failover/unaccounted
    # counters plus one labeled row per replica (health, version,
    # breaker).  Reads ONLY the router's cached state — a scrape must
    # never block on replica sockets.  Family-outer like every block.
    try:
        from ..serving import fleet as serving_fleet

        routers = serving_fleet.router_table()
        for r in routers:
            _line(out, "fleet_failovers_total", r["failovers"],
                  labels={"router": r["label"]}, kind="counter",
                  help_="requests retried on a different replica after "
                        "a transient/preemption-classified failure")
        for r in routers:
            _line(out, "fleet_attempts_unaccounted",
                  r["attempts_unaccounted"],
                  labels={"router": r["label"]}, kind="gauge",
                  help_="route attempts started but never resolved — "
                        "nonzero at quiesce means silent loss")
        for r in routers:
            for rep in r["replicas"]:
                _line(out, "fleet_replica_healthy",
                      0 if rep["dead"] else (1 if rep["healthy"] else 0),
                      labels={"router": r["label"],
                              "replica": rep["name"]}, kind="gauge")
        for r in routers:
            for rep in r["replicas"]:
                if rep.get("version") is not None:
                    _line(out, "fleet_replica_version", rep["version"],
                          labels={"router": r["label"],
                                  "replica": rep["name"]}, kind="gauge")
        for r in routers:
            for rep in r["replicas"]:
                _line(out, "fleet_replica_breaker_open",
                      1 if rep["breaker_open"] else 0,
                      labels={"router": r["label"],
                              "replica": rep["name"]}, kind="gauge")
    except Exception:
        pass
    return "\n".join(out["lines"]) + "\n"


def exported_name(name, kind=None):
    """The exact sample name ``_line`` emits for a registry entry:
    prefix + sanitize, plus the counter convention's ``_total``."""
    full = f"{_PREFIX}_{_sanitize(name)}"
    return full + "_total" if kind == "counter" else full


def metric_key(name, labels=()):
    """JSON-safe string key for one parsed sample
    (``"<name>|<label dict>"``) — how the multi-process smoke ships
    ``parse_prometheus`` output across a process boundary."""
    return f"{name}|{dict(labels)}"


def parse_prometheus(text):
    """Inverse of the text format (enough of it): returns
    ``{(name, (sorted label items...)): float}``.  Used by the tests
    and the smoke row to assert the scrape against ``snapshot()``."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # greedy label block: a quoted label VALUE may legally contain
        # "}" (only \ " and newline are escaped), but the numeric value
        # after the closing brace never does — so the last "}" on the
        # line is the closing brace
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                     r"(?:\{(.*)\})?\s+(\S+)$", line)
        if not m:
            raise ValueError(f"unparseable metrics line: {line!r}")
        name, labstr, value = m.groups()
        labels = ()
        if labstr:
            unesc = lambda v: re.sub(  # noqa: E731 — one-pass unescape
                r"\\(.)", lambda m: "\n" if m.group(1) == "n"
                else m.group(1), v)
            labels = tuple(sorted(
                (k, unesc(v)) for k, v in re.findall(
                    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
                    labstr)))
        out[(name, labels)] = float(value)
    return out


def health():
    """(ok, checks) — the /healthz verdict.  Unhealthy when any live
    serving breaker is OPEN or a watchdog-flagged dispatch is still
    wedged in flight.  (The reference also checks its anomaly guard's
    streak and elastic transitions: ROADMAP item 10.)"""
    checks = {"breaker_open": False, "watchdog_wedged": False}
    try:
        from ..serving import stats as serving_stats

        for row in serving_stats.serving_table():
            br = row.get("breaker") or {}
            if br.get("state") == "open":
                checks["breaker_open"] = True
            if row.get("stalled_in_flight"):
                checks["watchdog_wedged"] = True
    except Exception:
        pass
    ok = not (checks["breaker_open"] or checks["watchdog_wedged"])
    return ok, checks


def _health_reason(checks):
    """The first failing check's name — the machine-actionable
    `reason` field of a 503 body)."""
    if checks.get("breaker_open"):
        return "breaker_open"
    if checks.get("watchdog_wedged"):
        return "watchdog_wedged"
    return None


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server contract
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                body = prometheus_text().encode()
            except Exception as e:  # noqa: BLE001 — scrape never kills
                self._reply(500, f"# scrape failed: {e}\n".encode(),
                            "text/plain")
                return
            self._reply(200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            ok, checks = health()
            doc = {"ok": ok, "checks": checks}
            if not ok:
                doc["reason"] = _health_reason(checks)
            body = json.dumps(doc, sort_keys=True).encode()
            self._reply(200 if ok else 503, body, "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain")

    def _reply(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet: scrapes are not app logs
        pass


class MetricsServer:
    """One daemon-threaded HTTP server; ``port=0`` binds ephemeral
    (tests read ``.port`` back)."""

    def __init__(self, port, host="127.0.0.1"):
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="paddle_tpu_torch-metrics", daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def active():
    """The running MetricsServer, or None."""
    return _server


def start(port=None, host=None):
    """Start (or return the already-running) exporter.  ``port=None``
    reads FLAGS_metrics_port; an explicit 0 binds an ephemeral port.
    ``host=None`` reads FLAGS_metrics_host (loopback by default — the
    scrape body names hosts and serving labels, so reaching it from
    off-machine is an explicit opt-in)."""
    global _server
    with _lock:
        if _server is not None:
            return _server
        if port is None:
            port = int(flags.flag("metrics_port"))
            if port <= 0:
                return None
        if host is None:
            host = str(flags.flag("metrics_host"))
        _server = MetricsServer(port, host=host)
        return _server


def stop():
    global _server
    with _lock:
        server, _server = _server, None
    if server is not None:
        server.close()


def ensure_started():
    """Session-entry hook (monitor.enable / ServingRuntime.start): start
    the exporter iff FLAGS_metrics_port says so and it isn't running.
    Never raises — observability must not kill the run it observes."""
    try:
        if _server is None and int(flags.flag("metrics_port")) > 0:
            start()
    except Exception:
        pass
    return _server
