"""Resilience (port of paddle_tpu/resilience/): the error taxonomy, retry
with jittered backoff, the circuit breaker, deterministic fault
injection, and the part of the anomaly guard that AMP needs
(`guard.all_finite`).

The serving tier (`paddle_tpu_torch.serving`) runs every dispatch under
these; all recovery events land as `resilience.*` monitor counters and
flight-recorder events.  The anomaly guard's policies, preemption
handling and the elastic runtime are ROADMAP item 10.
"""

from .breaker import CircuitBreaker, CircuitOpenError  # noqa: F401
from . import faultinject  # noqa: F401
from .faultinject import (FaultPlan, InjectedCrash,  # noqa: F401
                          InjectedTransientError, plan_scope)
from .guard import all_finite  # noqa: F401
from .retry import RetriesExhausted, RetryPolicy, call_with_retry  # noqa
from .taxonomy import (DEADLINE, FATAL, PREEMPTION, TRANSIENT,  # noqa: F401
                       TAXONOMY, DeadlineExceeded, classify, is_deadline,
                       is_failover, is_oom, is_preemption, is_transient)

__all__ = [
    "all_finite",
    # retry
    "RetryPolicy", "RetriesExhausted", "call_with_retry",
    "enable_retry", "disable_retry", "active_retry",
    # breaker
    "CircuitBreaker", "CircuitOpenError",
    # taxonomy
    "classify", "is_transient", "is_oom", "is_deadline", "is_preemption",
    "is_failover", "DeadlineExceeded", "TRANSIENT", "FATAL", "DEADLINE",
    "PREEMPTION", "TAXONOMY",
    # fault injection
    "faultinject", "FaultPlan", "plan_scope", "InjectedTransientError",
    "InjectedCrash",
]

_retry_policy = None


def enable_retry(policy=None):
    """Install a process-wide retry policy (read back with
    `active_retry`)."""
    global _retry_policy
    _retry_policy = policy or RetryPolicy()
    return _retry_policy


def disable_retry():
    global _retry_policy
    _retry_policy = None


def active_retry():
    return _retry_policy
