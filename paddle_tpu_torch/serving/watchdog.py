"""Hang watchdog — a wedged dispatch must be detected, explained, and
escalated, never waited on forever (port of
paddle_tpu/serving/watchdog.py).

The retry layer handles dispatches that FAIL; this thread handles
dispatches that do NOTHING — a collective stuck at rendezvous, a
runtime bug, an injected hang.  The batcher registers every in-flight
dispatch (`track`) with its batch metadata; the watchdog polls the
registry, and any entry older than `stall_s`:

1. gets a flight-recorder post-mortem dump NOW (reason
   "serving_stall", carrying the in-flight batch's metadata — bucket,
   rows, request ids, and, with request tracing on, the wedged
   requests' trace_ids, elapsed — plus the usual last-K window),
   because a process wedged hard enough may never reach another dump
   point.  The trace_ids in the stall event join against the dump's
   kind="trace" / "trace_active" lines, so the post-mortem names the
   wedged requests' span trees, not just their count;
2. bumps `resilience.watchdog_stalls`;
3. has its `stalled` event set — the dispatch's WAITER escalates per
   policy (fail the batch with a classified WatchdogStall, or abandon
   the wedged call and retry degraded); the watchdog itself never
   kills anything (you cannot cancel a CUDA launch, only stop
   waiting for it).

The clock is injectable and the poll interval adapts to the stall
threshold, so tests run with millisecond thresholds and zero flakes.
"""

import queue
import threading
import time

from ..resilience.taxonomy import DeadlineExceeded

__all__ = ["HangWatchdog", "WatchdogStall", "DispatchWorker",
           "WAIT_POLL_S"]

# how often a dispatch's waiter wakes to enforce the riding requests'
# deadlines and to read the watchdog's verdict.  The reference wakes
# every 2-5 ms; the port's dispatch runs host-bound eager launches under
# the same GIL, and a 2 ms waiter slowed the card's 8-slot decode step by
# a third (chip_smoke.py `_dispatch_costs`), so it wakes every 20 ms.
WAIT_POLL_S = 0.02


class WatchdogStall(DeadlineExceeded):
    """A dispatch exceeded the watchdog's stall threshold and the
    escalation policy chose to fail it.  Subclasses DeadlineExceeded:
    classified DEADLINE (never blind-retried), `is_deadline`-true, and
    distinct from generic transients in every counter."""


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


class HangWatchdog:
    """Monitor in-flight serving dispatches for stalls."""

    def __init__(self, stall_s, poll_s=None, clock=time.monotonic,
                 stats=None, label="serving", pre_dump=None,
                 on_poll=None):
        # pre_dump: zero-arg callback run before the stall dump — the
        # runtime uses it to push its freshest kind="serving" record
        # into the flight recorder so the dump carries the serving
        # table, not a stale one
        self.pre_dump = pre_dump
        # on_poll: zero-arg callback run every poll tick — the runtime
        # hangs its queue deadline sweep here, so budget expiry is
        # enforced even while the batcher thread is wedged inside the
        # very stall this watchdog exists to catch
        self.on_poll = on_poll
        self.stall_s = float(stall_s)
        # poll fast enough to detect within ~12% of the threshold, but
        # never busy-spin; the cap keeps an idle runtime cheap
        self.poll_s = poll_s if poll_s is not None else \
            min(max(self.stall_s / 8.0, 0.005), 1.0)
        self.clock = clock
        self.stats = stats
        self.label = label
        self._lock = threading.Lock()
        self._inflight = {}          # token -> entry
        self._next_token = 0
        self._stop = threading.Event()
        self._thread = None
        if stats is not None:
            # back-link: the serving summary / the exporter's /healthz
            # ask "is a flagged dispatch STILL wedged right now"
            stats.attach_watchdog(self)

    def stalled_now(self):
        """How many flagged dispatches are still in flight — nonzero
        exactly while a detected stall remains unresolved."""
        with self._lock:
            return sum(1 for e in self._inflight.values() if e["flagged"])

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.label}-watchdog",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- registry -------------------------------------------------------
    def track(self, meta):
        """Register one in-flight dispatch; returns (token, stalled
        threading.Event).  The waiter waits on `done OR stalled`."""
        entry = {"start": self.clock(), "meta": dict(meta or {}),
                 "stalled": threading.Event(), "flagged": False}
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._inflight[token] = entry
        if self.stats is not None:
            self.stats.note_in_flight(len(self._inflight))
        return token, entry["stalled"]

    def untrack(self, token):
        with self._lock:
            self._inflight.pop(token, None)
        if self.stats is not None:
            self.stats.note_in_flight(len(self._inflight))

    def check_now(self):
        """One scan pass (the loop body, callable directly by tests)."""
        now = self.clock()
        with self._lock:
            entries = list(self._inflight.items())
        for token, e in entries:
            elapsed = now - e["start"]
            if elapsed < self.stall_s or e["flagged"]:
                continue
            e["flagged"] = True
            if self.stats is not None:
                self.stats.note_watchdog_stall()
            fr = _fr()
            fr.note_event(
                "serving_stall", severe=True, label=self.label,
                elapsed_s=round(elapsed, 4),
                stall_threshold_s=self.stall_s, **e["meta"])
            # dump BEFORE escalation: if the waiter's policy raises and
            # the caller exits, the post-mortem already exists — and it
            # records what the wedged dispatch was doing
            if self.pre_dump is not None:
                try:
                    self.pre_dump()
                except Exception:
                    pass
            fr.dump(f"serving_stall:{self.label}")
            e["stalled"].set()

    def _loop(self):
        while not self._stop.wait(self.poll_s):
            if self.on_poll is not None:
                try:
                    self.on_poll()
                except Exception:
                    pass
            self.check_now()


class DispatchWorker:
    """One long-lived thread that runs a serving tier's dispatches in
    turn, so that the caller can wait on them while it enforces
    deadlines and the watchdog's verdict.

    The reference starts a thread per dispatch.  The port's dispatches
    are host-bound eager launches, and on the card a fresh thread per
    dispatch slowed the 8-slot decode step by a fifth to two fifths
    (chip_smoke.py `_dispatch_costs` times both), so the port keeps one
    worker with the same semantics:
    a call the caller stops waiting for (stalled, or every request
    riding it resolved) cannot be cancelled, so `abandon()` leaves its
    thread to finish the call alone and the next `submit` starts a
    fresh worker.  Grad mode and the current CUDA device are per thread:
    the submitted callable sets both itself."""

    def __init__(self, name="dispatch"):
        self.name = name
        self._lock = threading.Lock()
        self._jobs = None

    def submit(self, fn):
        """Queue fn() on the worker; returns (done Event, box): on
        completion box holds "out" or "error" and done is set."""
        done = threading.Event()
        box = {}
        with self._lock:
            if self._jobs is None:
                self._jobs = queue.SimpleQueue()
                threading.Thread(target=self._run, args=(self._jobs,),
                                 name=f"{self.name}-dispatch",
                                 daemon=True).start()
            self._jobs.put((fn, done, box))
        return done, box

    @staticmethod
    def _run(jobs):
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, done, box = job
            try:
                box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 - handed to caller
                box["error"] = e
            finally:
                done.set()

    def abandon(self):
        """Retire the current thread (it exits once its call returns, at
        once when idle); the next submit starts a fresh one."""
        with self._lock:
            if self._jobs is not None:
                self._jobs.put(None)
            self._jobs = None
