"""Retry with jittered exponential backoff for transient failures (port
of paddle_tpu/resilience/retry.py).

Parity role: the reference's fleet keeps training alive across worker
hiccups by re-launching (fleet_util / trainer restart); here the
granularity is the single dispatched step — a CUDA out-of-memory or a
preemption-shaped runtime error is retried in place after a backoff,
while programming errors and sticky CUDA errors (see taxonomy.py) fail
fast on the first throw.  The jitter draws from `random.Random(seed)`
as the reference's does, so equal seeds give equal delay schedules.

Determinism: the jitter source and the sleep function are both
injectable, so tests (and the fault-injection harness) observe the
exact delay sequence without wall-clock waits.
"""

import random
import time

from .taxonomy import classify, PREEMPTION, TRANSIENT

__all__ = ["RetryPolicy", "call_with_retry", "RetriesExhausted"]

# retryable categories: a single throw cannot tell a network blip from
# a dead peer, so preemption-shaped failures keep their historical
# retry behavior — UNLESS an elastic coordinator is active (below)
_RETRYABLE = (TRANSIENT, PREEMPTION)


class RetriesExhausted(RuntimeError):
    """All retry attempts failed; `last_error` holds the final throw
    (also chained as __cause__) and `attempts` the total call count."""

    def __init__(self, attempts, last_error):
        super().__init__(
            f"transient failure persisted through {attempts} attempts: "
            f"{type(last_error).__name__}: {last_error}")
        self.attempts = attempts
        self.last_error = last_error


class RetryPolicy:
    """max_retries retries (max_retries+1 total attempts) with
    delay_n = min(max_delay, base_delay * multiplier**n), each scaled
    by a uniform jitter in [1-jitter, 1+jitter] — the decorrelation
    that keeps a gang of preempted workers from re-dialing the
    coordinator in lockstep.

    `sleep` and `rng` are injectable for deterministic tests; `seed`
    builds a private PRNG so two policies never share jitter streams.
    """

    def __init__(self, max_retries=5, base_delay=0.5, max_delay=30.0,
                 multiplier=2.0, jitter=0.25, sleep=time.sleep, seed=None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_retries = max_retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.sleep = sleep
        self.rng = random.Random(seed)

    def delay(self, attempt):
        """Backoff before retry number `attempt` (0-based), jittered."""
        d = min(self.max_delay,
                self.base_delay * (self.multiplier ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        return d


def _mon():
    from .. import monitor

    return monitor


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


def _elastic_active():
    """Is an ElasticCoordinator installed — the signal that rank-death
    recovery belongs to the topology-change path, not the backoff loop?
    The elastic runtime is ROADMAP item 10; until it is ported there is
    no coordinator, so preemption-shaped failures retry like
    transients."""
    return False


def call_with_retry(fn, policy=None, classify_fn=classify,
                    on_retry=None):
    """Run `fn()`; on a TRANSIENT (or preemption-shaped) throw, back
    off and retry up to policy.max_retries times.  Fatal errors
    propagate immediately with their original traceback.  Exhausted
    retries raise RetriesExhausted chaining the last error.

    PREEMPTION-category failures (dead peer, lost heartbeat, barrier
    timeout — taxonomy.is_preemption) are retried like transients
    ONLY while no elastic coordinator is active: with one installed,
    the throw propagates immediately so the coordinator can turn the
    rank death into a topology change instead of the retry loop
    blind-redialing a dead peer through the whole backoff schedule.

    Recovery telemetry: each retry bumps `resilience.retries` and sets
    the `resilience.last_backoff_s` gauge; a give-up bumps
    `resilience.retry_giveup` (all monitor-gated)."""
    policy = policy or RetryPolicy()
    mon = _mon()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            cat = classify_fn(e)
            if cat not in _RETRYABLE:
                raise
            if cat == PREEMPTION and _elastic_active():
                if mon.is_enabled():
                    mon.counter("resilience.retry_deferred_to_elastic") \
                        .add(1)
                raise
            if attempt >= policy.max_retries:
                if mon.is_enabled():
                    mon.counter("resilience.retry_giveup").add(1)
                fr = _fr()
                fr.note_event("retry_giveup", severe=True,
                              attempts=attempt + 1,
                              error=f"{type(e).__name__}: {e}"[:200])
                # the caller usually catches RetriesExhausted and shuts
                # down cleanly — this taxonomy path dumps NOW so the
                # post-mortem records what the device was doing
                fr.dump("retries_exhausted")
                raise RetriesExhausted(attempt + 1, e) from e
            d = policy.delay(attempt)
            if mon.is_enabled():
                mon.counter("resilience.retries").add(1)
                mon.gauge("resilience.last_backoff_s").set(d)
            _fr().note_event("retry", attempt=attempt,
                             backoff_s=round(d, 4),
                             error=f"{type(e).__name__}: {e}"[:200])
            if on_retry is not None:
                on_retry(attempt, d, e)
            # the reference charges the backoff to its goodput ledger's
            # recovery bucket; the ledger is ROADMAP item 10, so there
            # is no ledger to charge yet
            policy.sleep(d)
            attempt += 1
