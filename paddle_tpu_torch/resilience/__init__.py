"""Resilience (port of paddle_tpu/resilience/): the anomaly guard and its
policies, preemption-safe shutdown, the error taxonomy, retry with
jittered backoff, the circuit breaker and deterministic fault injection.

- The anomaly guard (`guard.py`): an all-finite reduction over each
  backward section's loss and gradients, read once per guarded
  Executor.run; policy ``raise`` / ``skip_step`` / ``rollback``
  (restore the newest complete checkpoint and replay the data cursor,
  which Executor.train_from_dataset does itself).
- Preemption (`preempt.py`): SIGTERM/SIGINT raise a flag; the training
  loop force-checkpoints at the next step boundary and exits cleanly;
  `train_from_dataset(auto_resume=True)` restores the latest checkpoint
  and skips the consumed batches.
- Fault injection (`faultinject.py`): NaN feeds at step N and synthetic
  transient errors, for tests and the card check.

The serving tier (`paddle_tpu_torch.serving`) runs every dispatch under
the retry policy and the breaker; all recovery events land as
`resilience.*` monitor counters and flight-recorder events.  The elastic
runtime (`elastic.py`) is ROADMAP item 10.

Usage::

    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager("ckpt", save_interval_steps=50)
    resilience.enable_anomaly_guard(policy="rollback", manager=mgr)
    with resilience.PreemptionHandler():
        exe.train_from_dataset(prog, dataset, checkpoint=mgr,
                               auto_resume=True)
"""

from .breaker import CircuitBreaker, CircuitOpenError  # noqa: F401
from . import faultinject  # noqa: F401
from .faultinject import (FaultPlan, InjectedCrash,  # noqa: F401
                          InjectedTransientError, plan_scope)
from .guard import (AnomalyError, AnomalyGuard,  # noqa: F401
                    RollbackPerformed, active_guard, all_finite,
                    anomaly_guard, disable_anomaly_guard,
                    enable_anomaly_guard)
from .preempt import (PreemptionHandler, clear_drain,  # noqa: F401
                      clear_preemption, drain_requested,
                      preemption_requested, request_drain,
                      request_preemption)
from .retry import RetriesExhausted, RetryPolicy, call_with_retry  # noqa
from .taxonomy import (DEADLINE, FATAL, PREEMPTION, TRANSIENT,  # noqa: F401
                       TAXONOMY, DeadlineExceeded, classify, is_deadline,
                       is_failover, is_oom, is_preemption, is_transient)

__all__ = [
    # guard
    "AnomalyGuard", "AnomalyError", "RollbackPerformed",
    "enable_anomaly_guard", "disable_anomaly_guard", "anomaly_guard",
    "active_guard", "all_finite", "guarded_step",
    # retry
    "RetryPolicy", "RetriesExhausted", "call_with_retry",
    "enable_retry", "disable_retry", "active_retry",
    # breaker
    "CircuitBreaker", "CircuitOpenError",
    # taxonomy
    "classify", "is_transient", "is_oom", "is_deadline", "is_preemption",
    "is_failover", "DeadlineExceeded", "TRANSIENT", "FATAL", "DEADLINE",
    "PREEMPTION", "TAXONOMY",
    # preemption / drain
    "PreemptionHandler", "preemption_requested", "request_preemption",
    "clear_preemption", "drain_requested", "request_drain", "clear_drain",
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


def _mon():
    from .. import monitor

    return monitor


def _is_true(flag):
    """A host bool of a 0-dim (or all-reduced) flag: a tensor's one
    `.item()`, or numpy's truth of an array or number."""
    import numpy as np

    if hasattr(flag, "detach"):
        return bool(flag.detach().all().item())
    return bool(np.asarray(flag).all())


def guarded_step(step, guard=None, template_state=None):
    """Wrap a functional train step (the `make_train_step` family:
    ``step(state, *batch) -> (state, loss, finite)`` or ``(state,
    loss)``) with host-side guard-policy handling, the eager twin of the
    executor's check.

    Steps that return a `finite` flag (the AMP path) have it read; the
    others get the finiteness of their loss checked.  Policy
    ``rollback`` restores through guard.manager and raises
    RollbackPerformed with `.state` set to the restored state (the
    caller rewinds its batch cursor to `.step` and continues from
    `.state`)."""
    g = guard or active_guard()
    if g is None:
        raise ValueError("no anomaly guard active (pass guard= or "
                         "enable_anomaly_guard first)")

    def wrapped(state, *batch):
        out = step(state, *batch)
        if len(out) == 3:
            new_state, loss, finite = out
        else:
            new_state, loss = out
            finite = all_finite(loss if hasattr(loss, "detach")
                                else float(loss))
        ok = _is_true(finite)
        mon = _mon()
        if ok:
            g.note_ok()
            return new_state, loss, True
        if mon.is_enabled():
            mon.counter("resilience.anomaly_steps").add(1)
        g.note_anomaly()
        if g.policy == "raise":
            raise AnomalyError("guarded step produced non-finite "
                               "loss/gradients (policy=raise)")
        if g.policy == "skip_step":
            if mon.is_enabled():
                mon.counter("resilience.skipped_steps").add(1)
            # AMP steps already selected the old state on overflow;
            # plain steps committed a poisoned update — hand back the
            # INPUT state so the skip really skips
            return (new_state if len(out) == 3 else state), loss, False
        # rollback
        g.note_rollback()
        if mon.is_enabled():
            mon.counter("resilience.rollbacks").add(1)
        template = template_state if template_state is not None \
            else (new_state if len(out) == 3 else state)
        restored, ck_step = g.manager.restore_latest(template)
        exc = RollbackPerformed(ck_step)
        exc.state = restored
        raise exc

    return wrapped
