"""Preemption-safe shutdown — SIGTERM/SIGINT to clean checkpoint.

Parity role: the reference's pserver `checkpoint_notify` + trainer
restart contract assumes workers are killed mid-run; cloud preemptions
arrive the same way (SIGTERM with a grace window).  The handler does
NOT checkpoint from signal context — async-signal-unsafe and the step
in flight would tear — it only raises a flag; the training loop
(Executor.train_from_dataset, or any user loop polling
`preemption_requested()`) force-checkpoints at the next STEP BOUNDARY
and exits cleanly, which `auto_resume=True` then picks up.

A second SIGINT escalates to the default KeyboardInterrupt — a user
hammering Ctrl-C must still be able to kill a wedged run.

an opt-in DRAIN signal (conventionally SIGUSR1, via
``PreemptionHandler(drain_signal=signal.SIGUSR1)``) raises a SEPARATE
flag meaning "finish the step, leave the fleet, stay re-admittable" —
distinct from SIGTERM's "save and exit".  A drained rank under an
ElasticCoordinator writes a leave intent so the survivors shrink
around it without waiting out the dead-peer timeout; the process
itself exits cleanly and can later rejoin via a join intent.
"""

import signal
import threading

__all__ = ["PreemptionHandler", "preemption_requested",
           "request_preemption", "clear_preemption",
           "drain_requested", "request_drain", "clear_drain"]

_event = threading.Event()
_drain_event = threading.Event()


def preemption_requested():
    return _event.is_set()


def request_preemption():
    """Programmatic preemption request (what the signal handler calls;
    also the deterministic hook for tests and external orchestrators
    that learn of preemption out-of-band, e.g. a metadata server).

    Async-signal-safe by design: ONLY the event is set.  No locks, no
    imports, no counters — the handler may be interrupting a frame
    that holds the monitor registry lock, and blocking on it here
    would hang the process through its grace window.  The training
    loop that OBSERVES the flag does the counting."""
    _event.set()


def clear_preemption():
    _event.clear()


def drain_requested():
    """True when a drain-and-leave was requested (SIGUSR1 under an
    opted-in PreemptionHandler, or request_drain) — "finish the step,
    leave the fleet, stay re-admittable", distinct from the preemption
    flag's "save and exit"."""
    return _drain_event.is_set()


def request_drain():
    """Programmatic drain request (what the opt-in drain signal's
    handler calls).  Async-signal-safe for the same reason
    request_preemption is: ONLY the event is set — counting happens in
    the loop that observes the flag."""
    _drain_event.set()


def clear_drain():
    _drain_event.clear()


class PreemptionHandler:
    """Install SIGTERM/SIGINT -> request_preemption while active.

    with PreemptionHandler():
        exe.train_from_dataset(..., checkpoint=mgr, auto_resume=True)

    Previous handlers are restored on exit.  Only the main thread may
    install signal handlers (CPython rule); constructing elsewhere
    raises, so a producer thread can't half-install.

    drain_signal (opt-in, conventionally signal.SIGUSR1): raises the
    DRAIN flag instead of the preemption flag — "leave the fleet at
    the next step boundary, stay re-admittable".  An elastic training
    loop turns it into a leave intent + clean exit; a plain loop that
    never polls drain_requested() simply ignores it, which is why the
    signal is not installed by default.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 drain_signal=None):
        self.signals = tuple(signals)
        self.drain_signal = drain_signal
        self._prev = {}
        self._sigints = 0

    def _on_signal(self, signum, frame):
        # escalation counts SIGINTs specifically — an earlier SIGTERM
        # (or programmatic request) must not turn the user's FIRST
        # Ctrl-C into a mid-step KeyboardInterrupt that skips the
        # boundary checkpoint
        if signum == signal.SIGINT:
            self._sigints += 1
            if self._sigints > 1:
                # second Ctrl-C: the user means it
                raise KeyboardInterrupt
        request_preemption()

    def _on_drain(self, signum, frame):
        request_drain()

    def install(self):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionHandler must be installed from the main thread")
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        if self.drain_signal is not None:
            self._prev[self.drain_signal] = signal.signal(
                self.drain_signal, self._on_drain)
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
