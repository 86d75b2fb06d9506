"""FleetRouter: health-gated routing + failover over N replicas (port of
paddle_tpu/serving/fleet.py).

The scheduling tier above the per-replica engine (the Orca shape: the
replica's batcher/decode engine is untouched; the fleet layer only
decides WHERE a request runs):

- **Health gating** — a poll thread scrapes each replica's
  ``/healthz``; a 503 (draining, open breaker, wedged watchdog) or a
  connection failure demotes the replica out of the routing set, and a
  recovered 200 restores it.  Repeated connection failures mark it
  DEAD (its ledger is carried at last-known value in the fleet merge).
- **Per-replica circuit breaker** — consecutive dispatch failures trip
  the replica's breaker open; the router stops offering it traffic
  before the health poll even runs, and half-open probes readmit it.
- **Failover, not blind retry** — a per-replica failure classified by
  ``taxonomy.is_failover`` (connection reset from a killed process,
  overload 503, transient infrastructure) is retried on a DIFFERENT
  replica, bounded by ``FLAGS_fleet_failover_attempts``.  Deadline and
  fatal shapes fail fast: a spent budget cannot be un-spent by moving
  replicas, and a bad request fails identically everywhere.
- **Merged outcome ledger** — the router's own registered
  ``ServingStats`` (every routed request ends in exactly one outcome)
  plus each replica's scraped per-version ledgers merge into one fleet
  ledger whose ``requests == sum(outcomes)`` identity is the zero-
  silent-loss assertion; UNACCOUNTED is the difference.  Router-side
  per-ATTEMPT accounting (started vs resolved) covers even replicas
  that died with their ledgers.
- **Tracing** — each routed request opens a trace (joining the
  caller's ``traceparent`` when given) with one ``dispatch`` child
  span per route attempt, and forwards its own traceparent on the
  router hop — the replica's runtime joins the same trace id, so one
  request's tree spans router + replica.

Model rollout rides the same surface: ``roll(version)`` hot-swaps every
live replica (each drains its outgoing runtime — zero drops), and
``registry.set_current`` flips the fleet-wide pointer for replicas yet
to be born.
"""

import http.client
import json
import threading
import time
import weakref

import numpy as np

from .. import flags
from ..resilience.breaker import CircuitBreaker
from ..resilience.taxonomy import DeadlineExceeded, is_failover
from .stats import ServingStats

__all__ = ["FleetRouter", "ReplicaHandle", "NoReplicaAvailable",
           "ReplicaUnavailable", "ReplicaRequestError", "router_table"]

# live routers keyed by label — what the exporter's fleet families and
# /healthz read (the serving/stats.py weak-registry idiom)
_ROUTERS = weakref.WeakValueDictionary()
_routers_lock = threading.Lock()

_DEAD_AFTER = 3         # consecutive failed health polls -> dead


class NoReplicaAvailable(RuntimeError):
    """No healthy, breaker-closed replica is accepting traffic — the
    router's backpressure rejection (counted `rejected`, never queued)."""


class ReplicaUnavailable(ConnectionError):
    """A replica answered with an unavailable/overload shape (503, a
    closed runtime, a transient-classified 500).  Derives from
    ConnectionError so the taxonomy classifies it PREEMPTION by TYPE —
    the failover class — exactly like the raw socket reset a killed
    replica produces."""


class ReplicaRequestError(RuntimeError):
    """A replica rejected the request as fatal (4xx/fatal-classified
    500): failing over would re-run a bad request N more times."""


def _mon():
    from .. import monitor

    return monitor


def _tracing():
    from ..monitor import tracing

    return tracing


class ReplicaHandle:
    """Router-side state for one replica endpoint."""

    def __init__(self, name, host, port, breaker_threshold=3,
                 breaker_cooldown_s=2.0, clock=time.monotonic):
        self.name = name
        self.host = host
        self.port = int(port)
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s, clock=clock,
            name=f"replica:{name}")
        self.healthy = True          # optimistic until the first poll
        self.draining = False
        self.dead = False
        self.version = None
        self.last_stats = None       # newest /stats doc (kept for dead)
        self.last_error = None
        self.health_fails = 0

    def summary(self):
        merged = (self.last_stats or {}).get("merged")
        return {
            "name": self.name,
            "endpoint": f"{self.host}:{self.port}",
            "healthy": self.healthy,
            "draining": self.draining,
            "dead": self.dead,
            "version": self.version,
            "breaker": self.breaker.summary(),
            "last_error": self.last_error,
            "ledger": merged,
        }


class FleetRouter:
    """Route requests across replicas; merge their ledgers.

    router = FleetRouter([("r0", "127.0.0.1", 8070), ...])
    outs = router.run({"x": batch})          # list of np.ndarray
    router.roll(2)                           # hot-swap the fleet
    router.close()
    """

    def __init__(self, replicas, label="fleet_router",
                 health_poll_s=None, failover_attempts=None,
                 request_timeout_s=None, breaker_threshold=3,
                 breaker_cooldown_s=2.0, clock=time.monotonic,
                 auto_poll=True, policy="round_robin"):
        if policy not in ("round_robin", "least_loaded"):
            raise ValueError(
                f"unknown routing policy {policy!r}: want 'round_robin' "
                f"or 'least_loaded'")
        self.label = label
        self.policy = policy
        self.clock = clock
        self.health_poll_s = float(
            health_poll_s if health_poll_s is not None
            else flags.flag("fleet_health_poll_s"))
        self.failover_attempts = int(
            failover_attempts if failover_attempts is not None
            else flags.flag("fleet_failover_attempts"))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else flags.flag("fleet_request_timeout_s"))
        self.replicas = []
        for spec in replicas:
            if isinstance(spec, ReplicaHandle):
                self.replicas.append(spec)
                continue
            if isinstance(spec, dict):
                name, host, port = (spec["name"], spec["host"],
                                    spec["port"])
            else:
                name, host, port = spec
            self.replicas.append(ReplicaHandle(
                name, host, port, breaker_threshold=breaker_threshold,
                breaker_cooldown_s=breaker_cooldown_s, clock=clock))
        # the router's own registered ledger: rides serving_table(),
        # the exporter's serving families and /healthz automatically
        self.stats = ServingStats(label)
        self.failovers = 0
        self.attempts_started = 0
        self.attempts_resolved = 0
        self._rr = 0
        self._lock = threading.Lock()
        self._closed = False
        self._poll_stop = threading.Event()
        self._poll_thread = None
        with _routers_lock:
            _ROUTERS[label] = self
        if auto_poll and self.health_poll_s > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_loop,
                name=f"paddle_tpu_torch-fleet-poll-{label}", daemon=True)
            self._poll_thread.start()

    # -- transport ------------------------------------------------------
    def _http(self, rep, method, path, body=None, headers=None,
              timeout=None):
        conn = http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=timeout if timeout is not None
            else self.request_timeout_s)
        try:
            conn.request(method, path, body=body,
                         headers=dict(headers or {}))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _get_json(self, rep, path, timeout=None):
        status, body = self._http(rep, "GET", path, timeout=timeout)
        try:
            return status, json.loads(body)
        except ValueError:
            return status, {}

    # -- health gating --------------------------------------------------
    def poll_once(self):
        """One health sweep: /healthz gates routing, /stats refreshes
        the replica's version + merged ledger for the fleet merge."""
        for rep in self.replicas:
            try:
                status, doc = self._get_json(
                    rep, "/healthz", timeout=max(1.0,
                                                 self.health_poll_s * 4))
                rep.health_fails = 0
                rep.dead = False
                rep.healthy = (status == 200)
                rep.draining = (doc.get("reason") == "draining")
                rep.last_error = (None if status == 200
                                  else doc.get("reason"))
                if doc.get("version") is not None:
                    rep.version = doc["version"]
                try:
                    _, st = self._get_json(rep, "/stats")
                    rep.last_stats = st
                    if st.get("version") is not None:
                        rep.version = st["version"]
                except Exception:
                    pass
            except Exception as e:
                rep.healthy = False
                rep.health_fails += 1
                rep.last_error = f"{type(e).__name__}: {e}"[:200]
                if rep.health_fails >= _DEAD_AFTER:
                    rep.dead = True
        mon = _mon()
        if mon.is_enabled():
            mon.gauge("fleet.healthy_replicas").set(
                sum(1 for r in self.replicas if r.healthy))

    def _poll_loop(self):
        while not self._poll_stop.wait(self.health_poll_s):
            try:
                self.poll_once()
            except Exception:
                pass             # the poll must outlive any one scrape

    # -- routing --------------------------------------------------------
    def _routable(self, tried):
        return [r for r in self.replicas
                if r.healthy and not r.draining and not r.dead
                and r.name not in tried]

    @staticmethod
    def _load(rep):
        """Scraped load of one replica: queued + in-flight requests
        from its newest /stats doc (the runtime's own admission
        gauges).  None when no poll has landed a stats doc yet — the
        least-loaded policy treats that as unknown, not as idle."""
        active = (rep.last_stats or {}).get("active") or {}
        depth = active.get("queue_depth")
        in_flight = active.get("in_flight")
        if depth is None and in_flight is None:
            return None
        return int(depth or 0) + int(in_flight or 0)

    def _pick(self, tried):
        """Pick a routable replica whose breaker admits traffic.

        round_robin (default): rotate over the candidates.
        least_loaded: order candidates by their scraped queue-depth +
        in-flight load (the metrics the observability tier exports);
        replicas with no scraped gauges sort last, and ties keep the
        round-robin
        rotation order, so a fleet with no stats yet degrades to exact
        round-robin.  allow() is only asked in candidate order (it
        hands out half-open probe tokens — polling every breaker would
        burn probes on replicas we don't pick)."""
        with self._lock:
            candidates = self._routable(tried)
            if not candidates:
                return None
            start = self._rr
            self._rr += 1
        n = len(candidates)
        ordered = [candidates[(start + i) % n] for i in range(n)]
        if self.policy == "least_loaded":
            loads = [self._load(rep) for rep in ordered]
            if any(ld is not None for ld in loads):
                order = sorted(range(n),
                               key=lambda i: (loads[i] is None,
                                              loads[i] or 0))
                ordered = [ordered[i] for i in order]
        for rep in ordered:
            if rep.breaker.allow():
                return rep
        return None

    def _post_infer(self, rep, payload, traceparent):
        headers = {"Content-Type": "application/json"}
        if traceparent:
            headers["traceparent"] = traceparent
        status, body = self._http(rep, "POST", "/infer", body=payload,
                                  headers=headers)
        try:
            doc = json.loads(body)
        except ValueError:
            doc = {"error": body.decode(errors="replace")[:200],
                   "kind": "unknown"}
        if status == 200:
            return [np.asarray(o) for o in doc["outputs"]], doc
        err = doc.get("error") or f"HTTP {status}"
        kind = doc.get("kind")
        if status == 504 or kind == "deadline":
            raise DeadlineExceeded(f"replica {rep.name}: {err}")
        if status == 503 or kind in ("overload", "closed", "draining",
                                     "transient", "preemption"):
            raise ReplicaUnavailable(
                f"replica {rep.name} unavailable ({kind}): {err}")
        raise ReplicaRequestError(
            f"replica {rep.name} failed the request ({kind}): {err}")

    def run(self, feed, deadline_s=None, traceparent=None):
        """Route one request; returns the fetch list (np arrays).  On a
        classified-transient replica failure the request FAILS OVER to
        a different replica (bounded attempts); deadline/fatal shapes
        raise immediately.  Every call lands in exactly one router
        ledger outcome."""
        if self._closed:
            raise NoReplicaAvailable("router is closed")
        start = self.clock()
        tried = set()
        # this pick doubles as the first attempt's routing decision —
        # picking twice would consume two half-open probe tokens and
        # advance round-robin for a request that only routes once
        first = self._pick(tried)
        if first is None:
            # backpressure, not a queued failure: counted `rejected`
            # (note_outcome increments `requests` for rejections)
            self.stats.note_outcome("rejected")
            mon = _mon()
            if mon.is_enabled():
                mon.counter("fleet.no_replica").add(1)
            raise NoReplicaAvailable(
                "no healthy replica is accepting traffic")
        self.stats.note_admitted(0)
        tr = _tracing().get().start_request(
            "fleet.infer", label=self.label, traceparent=traceparent)
        hop_traceparent = tr.traceparent() if tr is not None \
            else traceparent
        payload = json.dumps({
            "feed": {k: np.asarray(v).tolist() for k, v in feed.items()},
            "deadline_s": deadline_s}).encode()
        last_exc = None
        attempts = 0
        while attempts <= self.failover_attempts:
            rep, first = (first, None) if first is not None \
                else (self._pick(tried), None)
            if rep is None:
                break
            tried.add(rep.name)
            attempts += 1
            span = tr.child(f"route:{rep.name}", "dispatch",
                            attrs={"replica": rep.name}) \
                if tr is not None else None
            with self._lock:
                self.attempts_started += 1
            try:
                outs, _doc = self._post_infer(rep, payload,
                                              hop_traceparent)
            except Exception as e:  # noqa: BLE001 — classified below
                with self._lock:
                    self.attempts_resolved += 1
                last_exc = e
                rep.breaker.note_failure(e)
                if tr is not None:
                    tr.end(span, outcome="error")
                if isinstance(e, DeadlineExceeded) or not is_failover(e):
                    break         # terminal: budget spent / fatal shape
                # demote immediately on a RAW socket failure (reset /
                # refused: the process is likely gone) — the health
                # poll will readmit a blip, but routing must not wait a
                # poll interval to stop feeding a dead socket.  A
                # ReplicaUnavailable is an ANSWER (alive, just busy or
                # draining): failover, but leave it health-gated by the
                # poll.
                if isinstance(e, ConnectionError) and \
                        not isinstance(e, ReplicaUnavailable):
                    rep.healthy = False
                with self._lock:
                    self.failovers += 1
                mon = _mon()
                if mon.is_enabled():
                    mon.counter("fleet.failover").add(1)
                continue
            with self._lock:
                self.attempts_resolved += 1
            rep.breaker.note_success()
            if tr is not None:
                tr.end(span, outcome="completed")
                tr.finish("completed")
            self.stats.note_outcome("completed",
                                    latency_s=self.clock() - start)
            return outs
        # terminal failure: classify into the ledger
        latency = self.clock() - start
        if isinstance(last_exc, DeadlineExceeded):
            outcome = "expired"
        else:
            outcome = "failed"
        self.stats.note_outcome(outcome, latency_s=latency)
        if tr is not None:
            tr.finish(outcome)
        if last_exc is None:
            raise NoReplicaAvailable(
                f"all routable replicas exhausted after {attempts} "
                f"attempts")
        raise last_exc

    # -- model rollout --------------------------------------------------
    def roll(self, version):
        """Hot-swap every live replica to `version` (each drains its
        outgoing runtime — zero drops).  Returns {replica: result}."""
        out = {}
        for rep in self.replicas:
            if rep.dead:
                out[rep.name] = {"error": "dead"}
                continue
            try:
                status, doc = self._http(
                    rep, "POST", "/swap",
                    body=json.dumps({"version": int(version)}).encode(),
                    headers={"Content-Type": "application/json"})
                doc = json.loads(doc)
                if status != 200:
                    out[rep.name] = {"error": doc.get("error"),
                                     "status": status}
                    continue
                rep.version = doc.get("version")
                out[rep.name] = doc
            except Exception as e:  # noqa: BLE001 — per-replica verdict
                out[rep.name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- merged ledger / records ----------------------------------------
    def fleet_ledger(self):
        """The merged fleet view: router ledger + per-replica scraped
        ledgers summed into one ``requests == sum(outcomes)`` identity.
        UNACCOUNTED > 0 at quiesce means a request entered a ledger and
        never reached an outcome — a silent loss.  Dead replicas are
        reported at last-known value but EXCLUDED from the identity sum
        (their in-flight work at death is accounted by the router's
        failover path); the per-attempt row covers them: every attempt
        the router ever started must be resolved."""
        router = self.stats.summary()
        reps = [rep.summary() for rep in self.replicas]
        requests = router["requests"]
        outcomes = dict(router["outcomes"])
        for rep, row in zip(self.replicas, reps):
            ledger = row.get("ledger")
            if rep.dead or not ledger:
                continue
            requests += ledger["requests"]
            for k, v in ledger["outcomes"].items():
                outcomes[k] = outcomes.get(k, 0) + v
        resolved = sum(outcomes.values())
        with self._lock:
            attempts = {
                "started": self.attempts_started,
                "resolved": self.attempts_resolved,
                "unaccounted": (self.attempts_started
                                - self.attempts_resolved),
            }
            failovers = self.failovers
        return {
            "router": router,
            "replicas": reps,
            "merged": {"requests": requests, "outcomes": outcomes,
                       "resolved": resolved,
                       "unaccounted": requests - resolved},
            "attempts": attempts,
            "failovers": failovers,
        }

    def fleet_record(self):
        rec = {"kind": "fleet_serving", "label": self.label,
               "policy": self.policy}
        rec.update(self.fleet_ledger())
        return rec

    def emit_telemetry(self):
        return _mon().record_fleet_serving(self.fleet_record())

    def exporter_row(self):
        """Scrape-shaped snapshot from CACHED state only (no network
        I/O on the scrape path)."""
        with self._lock:
            failovers = self.failovers
            att_unaccounted = (self.attempts_started
                               - self.attempts_resolved)
        return {
            "label": self.label,
            "failovers": failovers,
            "attempts_unaccounted": att_unaccounted,
            "replicas": [{
                "name": rep.name,
                "healthy": rep.healthy,
                "dead": rep.dead,
                "version": rep.version,
                "breaker_open": rep.breaker.state == "open",
            } for rep in self.replicas],
        }

    def close(self, emit=True):
        if self._closed:
            return
        self._closed = True
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
        if emit:
            try:
                self.emit_telemetry()
            except Exception:
                pass


def router_table():
    """One exporter_row per live FleetRouter — what the exporter's
    fleet-serving families and /healthz read."""
    with _routers_lock:
        routers = list(_ROUTERS.values())
    return [r.exporter_row() for r in routers]
