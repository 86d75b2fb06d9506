"""Deterministic fault-injection harness (port of
paddle_tpu/resilience/faultinject.py).

The fault-tolerance layer is only trustworthy if every recovery path is
exercised on purpose: this module injects the three failure shapes the
runtime claims to survive, at exact, reproducible points —

- **NaN at step N**: the first floating-point feed of the Nth guarded
  Executor.run is replaced (a tainted COPY — the caller's batch array
  is untouched, so a rollback replay of the same batch sees clean
  data) with NaN, which propagates to loss and gradients and trips the
  anomaly guard.
- **transient error at step N**: a synthetic InjectedTransientError is
  raised from inside the retried dispatch region, `times` times in a
  row, exercising classification + backoff + eventual success.
- **crash at a named point**: code that must be crash-safe calls
  `crash_point("name")` at its vulnerable spots (checkpoint.py calls
  `checkpoint.before_marker` between the array write and the
  _COMPLETE marker); an armed plan raises InjectedCrash there —
  a BaseException, so no cleanup handler downstream can complete the
  interrupted operation, exactly like a SIGKILL.

All injections are ONE-SHOT by default (they disarm after firing) and
counted both in the plan (`fired`) and as `resilience.injected_*`
monitor counters, so a test can assert the fault actually happened —
a chaos test that silently injects nothing is worse than no test.
"""

import os
import threading

import numpy as np
import torch

from .taxonomy import InjectedCrash, InjectedTransientError

__all__ = ["FaultPlan", "arm", "disarm", "active_plan", "is_armed",
           "plan_scope", "on_step_feed", "check_transient", "crash_point",
           "kill_point", "stall_point",
           "InjectedTransientError", "InjectedCrash"]

_lock = threading.Lock()
_plan = None


class FaultPlan:
    """One armed injection schedule.  Step indices are 0-based counts
    of EVERY Executor.run dispatch SINCE ARMING — guarded or not, eval
    programs included (the harness keeps its own counter; arm right
    before the loop under test, and account for any interleaved eval
    runs when picking indices).  Injecting into an UNguarded run is a
    legitimate chaos scenario: it shows what the failure looks like
    with recovery off.

    nan_at_steps:   iterable of step indices whose feeds get tainted
    nan_feed:       feed var name to taint (default: first float feed,
                    in sorted-name order for determinism)
    transient_at_step: step index (or iterable of indices — the
                    serving breaker tests need CONSECUTIVE dispatch
                    failures) that raises InjectedTransientError
    transient_times:   how many raises total before succeeding (shared
                    budget across the scheduled steps)
    crash_points:   {point_name: nth_hit_to_fire} (0-based hit count)
    kill_points:    {point_name: nth_hit_to_fire} like crash_points,
                    but the PROCESS dies via os._exit(1) — a real
                    SIGKILL-equivalent for multi-process chaos (the
                    fleet replica kill): no exception, no
                    handler, no atexit; the peer sees a dead socket.
                    InjectedCrash stays the single-process simulation.
    stall_points:   {point_name: spec} latency/hang injection:
                    spec is a float (deterministic sleep of that many
                    seconds) or a threading.Event (block until the test
                    sets it — a REAL hang with no wall-clock guess, so
                    watchdog tests are not timing-flaky).  One-shot per
                    point; a (nth_hit, spec) tuple targets a later
                    visit, and ("every", spec) fires on EVERY visit
                    without disarming — the fleet straggler smoke slows
                    one rank on each step.
    """

    def __init__(self, nan_at_steps=(), nan_feed=None,
                 transient_at_step=None, transient_times=1,
                 crash_points=None, kill_points=None, stall_points=None):
        self.nan_at_steps = set(int(s) for s in (
            nan_at_steps if not isinstance(nan_at_steps, int)
            else (nan_at_steps,)))
        self.nan_feed = nan_feed
        if transient_at_step is None:
            self.transient_at_steps = set()
        elif isinstance(transient_at_step, int):
            self.transient_at_steps = {transient_at_step}
        else:
            self.transient_at_steps = set(
                int(s) for s in transient_at_step)
        self.transient_remaining = int(transient_times)
        self.crash_points = dict(crash_points or {})
        self._crash_hits = {}
        self.kill_points = dict(kill_points or {})
        self._kill_hits = {}
        self.stall_points = {
            name: (spec if isinstance(spec, tuple) else (0, spec))
            for name, spec in (stall_points or {}).items()}
        self._stall_hits = {}
        self.step = 0
        self.fired = {"nan": 0, "transient": 0, "crash": 0, "kill": 0,
                      "stall": 0}

    @property
    def transient_at_step(self):
        """Back-compat single-step view (None unless exactly one
        step is scheduled — multi-step plans have no single index)."""
        if len(self.transient_at_steps) == 1:
            return next(iter(self.transient_at_steps))
        return None

    def describe(self):
        return {"step": self.step, "fired": dict(self.fired)}


def arm(plan=None, **kw):
    """Install a FaultPlan (or build one from kwargs) process-wide.
    Returns the armed plan."""
    global _plan
    p = plan if plan is not None else FaultPlan(**kw)
    with _lock:
        _plan = p
    return p


def disarm():
    global _plan
    with _lock:
        _plan = None


def active_plan():
    return _plan


def is_armed():
    return _plan is not None


class plan_scope:
    """Context manager: arm on enter, ALWAYS disarm on exit — a
    raising test must not leak its faults into the next one."""

    def __init__(self, plan=None, **kw):
        self._plan = plan if plan is not None else FaultPlan(**kw)

    def __enter__(self):
        return arm(self._plan)

    def __exit__(self, *exc):
        disarm()
        return False


def _mon():
    from .. import monitor

    return monitor


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


# -- hooks called by the runtime ---------------------------------------

def on_step_feed(feed_arrays):
    """Executor.run calls this once per guarded dispatch with the
    prepared feed dict; returns the (possibly tainted) dict and
    advances the plan's step counter.  The input dict/arrays are never
    mutated — a tainted feed is a fresh NaN-filled array under the
    same name."""
    p = _plan
    if p is None:
        return feed_arrays
    with _lock:
        step = p.step
        p.step += 1
        fire_nan = step in p.nan_at_steps
        if fire_nan:
            p.nan_at_steps.discard(step)       # one-shot
    if not fire_nan:
        return feed_arrays
    name = p.nan_feed
    if name is None:
        for n in sorted(feed_arrays):
            if _is_floating(feed_arrays[n]):
                name = n
                break
    if name is None or name not in feed_arrays:
        raise ValueError(
            f"fault plan has no float feed to taint (nan_feed="
            f"{p.nan_feed!r}, feeds={sorted(feed_arrays)})")
    tainted = dict(feed_arrays)
    a = tainted[name]
    tainted[name] = (torch.full_like(a, float("nan"))
                     if isinstance(a, torch.Tensor)
                     else np.full_like(np.asarray(a), np.nan))
    p.fired["nan"] += 1
    mon = _mon()
    if mon.is_enabled():
        mon.counter("resilience.injected_nan").add(1)
    _fr().note_event("injected_nan", step=step, feed=name)
    return tainted


def _is_floating(a):
    """A torch tensor or numpy array of a floating dtype."""
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return hasattr(a, "dtype") and np.issubdtype(np.dtype(a.dtype),
                                                 np.floating)


def check_transient():
    """Called from inside the retried dispatch region: raises the
    scheduled InjectedTransientError while any raises remain for the
    current step.  The step index was fixed by on_step_feed (which
    runs first), so every retry of the SAME step re-enters here."""
    p = _plan
    if p is None or not p.transient_at_steps:
        return
    # on_step_feed already advanced p.step past the current dispatch
    current = p.step - 1
    if current not in p.transient_at_steps:
        return
    with _lock:
        if p.transient_remaining <= 0:
            return
        p.transient_remaining -= 1
        p.fired["transient"] += 1
    mon = _mon()
    if mon.is_enabled():
        mon.counter("resilience.injected_transient").add(1)
    _fr().note_event("injected_transient", step=current)
    raise InjectedTransientError(
        "injected: RESOURCE_EXHAUSTED: synthetic device allocation "
        "failure while trying to allocate 1073741824 bytes "
        "(fault-injection harness)")


def crash_point(name):
    """Instrumented code calls this at its crash-vulnerable points;
    a no-op unless an armed plan schedules `name`.  Fires InjectedCrash
    on the scheduled visit (0-based), then disarms that point."""
    p = _plan
    if p is None or name not in p.crash_points:
        return
    with _lock:
        if name not in p.crash_points:       # re-check under lock
            return
        hit = p._crash_hits.get(name, 0)
        p._crash_hits[name] = hit + 1
        if hit != p.crash_points[name]:
            return
        del p.crash_points[name]             # one-shot
        p.fired["crash"] += 1
    mon = _mon()
    if mon.is_enabled():
        mon.counter("resilience.injected_crash").add(1)
    # post-mortem BEFORE the raise: InjectedCrash models a SIGKILL, so
    # nothing downstream may run — including any dump hook.  (A real
    # SIGKILL can't dump either; the simulation records what the kill
    # interrupted, which is exactly what the chaos test asserts.)
    fr = _fr()
    fr.note_event("injected_crash", severe=True, point=name)
    fr.dump(f"injected_crash:{name}")
    raise InjectedCrash(f"injected crash at point {name!r}")


def kill_point(name):
    """Instrumented code calls this at its kill-vulnerable points (the
    fleet replica worker's request path); a no-op unless an armed plan
    schedules `name`.  On the scheduled visit (0-based hit count) the
    PROCESS dies via ``os._exit(1)`` — the SIGKILL model the shm worker
    established: no exception, no cleanup handler, no atexit hooks, no
    flushed buffers; peers observe a reset socket, which is exactly the
    failure shape the router's failover path must classify.
    The counter/flight-recorder notes land BEFORE the exit (a real
    SIGKILL can't note anything; the simulation records what it
    interrupted — the same contract as crash_point's pre-raise dump)."""
    p = _plan
    if p is None or name not in p.kill_points:
        return
    with _lock:
        if name not in p.kill_points:        # re-check under lock
            return
        hit = p._kill_hits.get(name, 0)
        p._kill_hits[name] = hit + 1
        if hit != p.kill_points[name]:
            return
        del p.kill_points[name]              # one-shot
        p.fired["kill"] += 1
    mon = _mon()
    if mon.is_enabled():
        mon.counter("resilience.injected_kill").add(1)
    fr = _fr()
    fr.note_event("injected_kill", severe=True, point=name)
    fr.dump(f"injected_kill:{name}")
    os._exit(1)


def stall_point(name):
    """Instrumented code calls this at its hang-vulnerable points (the
    serving dispatch, the shm consumer loop); a no-op unless an armed
    plan schedules `name`.  Fires the scheduled stall on the scheduled
    visit (0-based hit count), then disarms that point.

    A float spec sleeps that many seconds (deterministic latency); a
    threading.Event spec BLOCKS until the test sets it — the honest
    hang the watchdog must detect, with no wall-clock race.  A stuck
    test can't deadlock CI: event waits are capped at 120s."""
    p = _plan
    if p is None or name not in p.stall_points:
        return
    with _lock:
        if name not in p.stall_points:       # re-check under lock
            return
        hit = p._stall_hits.get(name, 0)
        p._stall_hits[name] = hit + 1
        target_hit, spec = p.stall_points[name]
        if target_hit == "every":
            pass                             # repeating: never disarm
        elif hit != target_hit:
            return
        else:
            del p.stall_points[name]         # one-shot
        p.fired["stall"] += 1
    mon = _mon()
    if mon.is_enabled():
        mon.counter("resilience.injected_stall").add(1)
    _fr().note_event("injected_stall", point=name,
                     spec=("event" if isinstance(spec, threading.Event)
                           else float(spec)))
    if isinstance(spec, threading.Event):
        spec.wait(timeout=120.0)
    else:
        import time

        time.sleep(float(spec))
