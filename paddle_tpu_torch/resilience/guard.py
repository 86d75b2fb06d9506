"""Anomaly guard: an all-finite check with a recovery policy (port of
paddle_tpu/resilience/guard.py).

Parity role: the reference's FLAGS_check_nan_inf checks every op output
on the host (operator.cc:1032), useful for debugging and ruinous for
throughput.  The guard instead takes ONE cheap reduction over each
section's loss and gradients and lets a policy decide what an anomalous
step means:

- ``raise``     — stop the run with AnomalyError (CI / debugging).
- ``skip_step`` — commit nothing: the executor reads the step's finite
  flag once after the backward and runs no update op when it is down,
  counts the step, and training continues with the next batch (the
  dynamic-loss-scaling skip of the AMP path, generalized to any
  program).
- ``rollback``  — restore the newest complete checkpoint through a
  CheckpointManager and signal the training loop (RollbackPerformed)
  to rewind its data cursor and replay the consumed batches.

The reference selects the old state on the device inside its compiled
step and reads the flag on the host afterwards; the port reads the flag
before the update ops and skips them (one host sync per guarded step
either way).

AMP integration: the static-graph AMP rewrite scales the loss before
backward, so the guard's gradient check sees SCALED grads — overflow
detection at the same point update_loss_scaling samples.
"""

import math
import threading

import torch

__all__ = ["AnomalyGuard", "AnomalyError", "RollbackPerformed",
           "enable_anomaly_guard", "disable_anomaly_guard",
           "anomaly_guard", "active_guard", "all_finite"]

POLICIES = ("raise", "skip_step", "rollback")


class AnomalyError(FloatingPointError):
    """A guarded step produced non-finite loss/gradients under the
    `raise` policy (or a policy escalated after repeated anomalies)."""


class RollbackPerformed(RuntimeError):
    """The guard restored checkpoint `step` into the scope; the
    training loop must rewind its data cursor to that step and replay.
    Executor.train_from_dataset handles this itself; bare Executor.run
    loops catch it and reset their batch index to `step`."""

    def __init__(self, step):
        super().__init__(
            f"anomaly guard rolled state back to checkpoint step {step}; "
            f"replay data from there")
        self.step = step


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def all_finite(tree):
    """True when every float leaf is finite.  Non-float tensors (int
    counters) are finite by construction and skipped; Python floats (an
    eagerly accumulated loss) are checked, so float('nan') does not slip
    through.  The result lies on the first checked tensor's device."""
    checks = []
    device = None
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                device = device or x.device
                checks.append(torch.isfinite(x).all())
        elif isinstance(x, float):
            checks.append(torch.tensor(math.isfinite(x)))
    if not checks:
        return torch.tensor(True)
    return torch.stack([c.to(device or c.device) for c in checks]).all()


class AnomalyGuard:
    """Active guard configuration.

    policy:          one of POLICIES.
    manager:         CheckpointManager (required for ``rollback``).
    max_consecutive: escalate to AnomalyError after this many
                     anomalous steps IN A ROW — a persistent numeric
                     bug must not skip/rollback forever (the
                     reference's loss scaler has the same escape:
                     scale bottoms out at 1.0 and the run dies).
    max_rollbacks:   total rollbacks before escalating.
    """

    def __init__(self, policy="raise", manager=None, max_consecutive=10,
                 max_rollbacks=3):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown anomaly policy {policy!r}; pick from {POLICIES}")
        if policy == "rollback" and manager is None:
            raise ValueError(
                "rollback policy needs a CheckpointManager (manager=...)")
        self.policy = policy
        self.manager = manager
        self.max_consecutive = max_consecutive
        self.max_rollbacks = max_rollbacks
        self._lock = threading.Lock()
        self.consecutive = 0
        self.rollbacks = 0
        # True exactly when the most recent guarded step was skipped —
        # the signal train_from_dataset's sparse-push path reads so a
        # skipped step's NaN gradient rows never reach the tables
        self.last_skipped = False

    # -- bookkeeping called by the executor ---------------------------
    def note_ok(self):
        with self._lock:
            self.consecutive = 0
            self.last_skipped = False

    def note_anomaly(self):
        """Count one anomalous step; returns True when the policy
        should still apply, raises AnomalyError when escalation is
        due."""
        with self._lock:
            self.consecutive += 1
            escalate = self.consecutive > self.max_consecutive
        if escalate:
            # dump OUTSIDE the guard lock: the recorder snapshots the
            # monitor registry, and holding two subsystem locks across
            # each other is how deadlocks are born
            _flight_dump(
                f"anomaly_guard:max_consecutive={self.max_consecutive}")
            raise AnomalyError(
                f"{self.consecutive} consecutive anomalous steps "
                f"exceed max_consecutive={self.max_consecutive}; "
                f"escalating past policy {self.policy!r}")
        return True

    def note_rollback(self):
        with self._lock:
            self.rollbacks += 1
            escalate = self.rollbacks > self.max_rollbacks
        if escalate:
            _flight_dump(
                f"anomaly_guard:max_rollbacks={self.max_rollbacks}")
            raise AnomalyError(
                f"{self.rollbacks} rollbacks exceed max_rollbacks="
                f"{self.max_rollbacks}; the anomaly is not transient")


def _flight_dump(reason):
    """Escalations are normally CAUGHT by calling code (CI harnesses,
    retry loops), so the excepthook may never see them: write the
    post-mortem at the escalation point.  Never raises — diagnostics
    must not mask the AnomalyError being thrown."""
    try:
        from ..monitor import flight_recorder

        flight_recorder.note_event("anomaly_escalation", severe=True,
                                   reason=reason)
        flight_recorder.dump(reason)
    except Exception:
        pass


_active = None


def enable_anomaly_guard(policy="raise", manager=None, **kw):
    """Install a process-wide guard; every train step Executor.run
    dispatches while a guard is active reads the finite flag of its
    sections' losses and gradients before its update ops."""
    global _active
    _active = AnomalyGuard(policy=policy, manager=manager, **kw)
    return _active


def disable_anomaly_guard():
    global _active
    _active = None


def active_guard():
    return _active


class anomaly_guard:
    """Context-manager form, restoring the previous guard on exit."""

    def __init__(self, policy="raise", manager=None, **kw):
        self._guard = AnomalyGuard(policy=policy, manager=manager, **kw)

    def __enter__(self):
        global _active
        self._prev = _active
        _active = self._guard
        return self._guard

    def __exit__(self, *exc):
        global _active
        _active = self._prev
        return False
