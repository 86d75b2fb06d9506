"""Circuit breaker — fail fast while a dependency is known-broken.

Parity role: the reference's serving stack sheds load when a backend
is wedged instead of letting every caller time out individually; here
the breaker guards the serving runtime's batched dispatch.
The state machine is the classic three-state one:

- **closed** — traffic flows; `failure_threshold` CONSECUTIVE
  classified failures (any success resets the count) trip it open.
- **open** — `allow()` answers False immediately (no dispatch, no
  timeout); the serving layer degrades to its fallback path.  After
  `cooldown_s` on the injectable clock the breaker half-opens.
- **half_open** — exactly ONE caller wins the probe token; its success
  closes the breaker, its failure re-opens it (cooldown restarts).

Every transition lands in `transitions` (inspectable by tests and the
serving table), bumps a `resilience.breaker_*` counter, and is noted
in the flight recorder — an open breaker is exactly the kind of event
a post-mortem must explain.

The clock is injectable so breaker tests never sleep; thread-safe, one
lock, tiny critical sections.
"""

import threading
import time

__all__ = ["CircuitBreaker", "CircuitOpenError",
           "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpenError(RuntimeError):
    """Raised (or stored on a request) when the breaker is open and no
    degraded fallback is configured: the dependency is known-broken,
    so failing in microseconds beats timing out in seconds."""


def _mon():
    from .. import monitor

    return monitor


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


class CircuitBreaker:
    """Three-state breaker with an injectable clock.

    b = CircuitBreaker(failure_threshold=5, cooldown_s=30.0)
    if b.allow():
        try:    ...dispatch...; b.note_success()
        except Exception as e:  b.note_failure(e); raise
    else:       ...fail fast / degraded path...
    """

    def __init__(self, failure_threshold=5, cooldown_s=30.0,
                 clock=time.monotonic, name="breaker"):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = None
        self._probe_taken = False
        self._probe_granted_at = None
        self.transitions = []          # [(ts, from_state, to_state)]
        self.last_error = None

    # -- state ----------------------------------------------------------
    def _advance_locked(self):
        """Open -> half-open once the cooldown has elapsed (lazy: no
        timer thread — the next caller pays one clock read).  A probe
        that never reported back (its requests all expired, the caller
        died) expires after another cooldown period, re-granting the
        token — an unreported probe must not wedge the breaker in
        half-open forever."""
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.cooldown_s:
            self._transition_locked(HALF_OPEN)
            self._probe_taken = False
            self._probe_granted_at = None
        if self._state == HALF_OPEN and self._probe_taken and \
                self._probe_granted_at is not None and \
                self.clock() - self._probe_granted_at >= self.cooldown_s:
            self._probe_taken = False
            self._probe_granted_at = None

    def _transition_locked(self, to_state):
        frm = self._state
        if frm == to_state:
            return
        self._state = to_state
        self.transitions.append((self.clock(), frm, to_state))
        mon = _mon()
        if mon.is_enabled():
            mon.counter(f"resilience.breaker_{to_state}").add(1)
        _fr().note_event(f"breaker_{to_state}", name=self.name,
                         consecutive_failures=self._consecutive_failures,
                         error=(f"{type(self.last_error).__name__}: "
                                f"{self.last_error}"[:200]
                                if self.last_error is not None else None))

    @property
    def state(self):
        with self._lock:
            self._advance_locked()
            return self._state

    def allow(self):
        """May a dispatch proceed right now?  closed: yes.  open: no
        (fail fast).  half_open: yes for exactly ONE caller — the
        probe; everyone else is treated as open until it reports."""
        with self._lock:
            self._advance_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_taken:
                self._probe_taken = True
                self._probe_granted_at = self.clock()
                return True
            mon = _mon()
            if mon.is_enabled():
                mon.counter("resilience.breaker_fast_fail").add(1)
            return False

    # -- outcome reports ------------------------------------------------
    def release_probe(self):
        """The dispatch this breaker allowed ended with NO verdict —
        every waiter expired mid-flight, or the batch was abandoned
        before completing.  Hand the half-open probe token back so the
        next dispatch can probe instead of waiting out the expiry
        backstop."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_taken = False
                self._probe_granted_at = None

    def note_success(self):
        """A dispatch the breaker allowed succeeded.  In half-open this
        is the probe reporting: the dependency healed — close."""
        with self._lock:
            self._consecutive_failures = 0
            self.last_error = None
            if self._state in (HALF_OPEN, OPEN):
                # OPEN can only be seen here by a dispatch that started
                # pre-trip and finished late; its success is still the
                # recovery signal the probe exists to find
                self._transition_locked(CLOSED)

    def note_failure(self, exc=None):
        """A dispatch the breaker allowed failed (with the error
        already classified by the taxonomy — retry has given up, or
        the failure was fail-fast).  Half-open: the probe failed,
        re-open and restart the cooldown.  Closed: count it; the Nth
        consecutive failure trips the breaker."""
        with self._lock:
            self.last_error = exc
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._transition_locked(OPEN)
                self._opened_at = self.clock()
                return
            if self._state == CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self._transition_locked(OPEN)
                self._opened_at = self.clock()

    def summary(self):
        """json-safe view for the serving table / kind="serving"
        records."""
        with self._lock:
            self._advance_locked()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "transitions": [
                    {"ts": round(ts, 6), "from": frm, "to": to}
                    for ts, frm, to in self.transitions],
            }
