"""Error taxonomy — transient vs fatal classification for retry (port
of paddle_tpu/resilience/taxonomy.py).

Parity role: the reference's trainer restart semantics distinguish
worker deaths the fleet recovers from (pserver timeout, barrier lost,
preempted trainer — fleet re-launches the worker) from programming
errors that must fail the job (shape mismatch, missing var).  Here the
same split drives the retry/backoff layer: only errors classified
TRANSIENT are retried; everything else fails fast with the original
traceback.

Classification is TABLE-driven (not a type check buried in a retry
loop) so new failure shapes are one row, and the table itself is
inspectable/testable.  Two axes:

- exception TYPE: connection/timeout OS errors are transient;
  Python programming errors (TypeError, KeyError, ...) are fatal no
  matter what their message says.
- MESSAGE pattern: the reference's runtime surfaces status codes as
  one error type with the gRPC code name in the message
  (RESOURCE_EXHAUSTED, UNAVAILABLE, ...), so the code word — not the
  exception type — carries the taxonomy.  Every row of the reference's
  table is kept, so its messages classify the same here.

The CUDA rows the reference has no need of:

- `torch.cuda.OutOfMemoryError` ("CUDA out of memory. Tried to allocate
  ...") is TRANSIENT and `is_oom`, as RESOURCE_EXHAUSTED is.
- Sticky CUDA errors ("an illegal memory access was encountered",
  "device-side assert triggered", "unspecified launch failure",
  "misaligned address") are FATAL: they poison the CUDA context, so
  every later call on it fails the same way and a retry would spin.
- NCCL's "remote process exited" and its watchdog's collective timeout
  are PREEMPTION, as the reference's socket and heartbeat rows are.
"""

import re

import torch

__all__ = ["TRANSIENT", "FATAL", "DEADLINE", "PREEMPTION", "classify",
           "is_transient", "is_oom", "is_deadline", "is_preemption",
           "is_failover",
           "DeadlineExceeded", "InjectedTransientError", "InjectedCrash",
           "TAXONOMY"]

TRANSIENT = "transient"
FATAL = "fatal"
# a request/dispatch ran out of TIME BUDGET (shed in a serving queue,
# stalled past the hang watchdog's threshold).  Distinct from TRANSIENT
# on purpose: retrying is exactly wrong — the budget is already spent,
# so the only honest outcome is a fast classified failure the caller
# can act on (shed load, re-issue with a fresh budget).
DEADLINE = "deadline"
# a PEER (or this rank's own slice) went away: the platform preempted a
# worker, the distributed coordination service lost a heartbeat, a
# collective's transport hit a dead socket.  Retry-worthy BY DEFAULT
# (is_transient covers it — a blip and a death look identical from one
# throw), but a distinct category so the elastic coordinator and the
# retry path agree on what "a rank died" looks like: while an
# ElasticCoordinator is active, retry fails fast on PREEMPTION and
# hands recovery to the topology-change path instead of blind-redialing
# a dead peer through the whole backoff schedule.
PREEMPTION = "preemption"


class DeadlineExceeded(RuntimeError):
    """A request exceeded its time budget — shed from the serving
    queue before dispatch, or expired while a dispatch was in flight.
    Classified DEADLINE by TYPE (never retried: the budget is gone);
    `elapsed_s`/`budget_s` carry the forensics when known."""

    def __init__(self, msg, elapsed_s=None, budget_s=None):
        super().__init__(msg)
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s


class InjectedTransientError(RuntimeError):
    """Synthetic device/runtime error raised by the fault-injection
    harness; classified transient by TYPE so retry tests exercise the
    real classification path."""


class InjectedCrash(BaseException):
    """Synthetic SIGKILL stand-in raised at a crash point.  Derives
    from BaseException so no `except Exception` cleanup handler can
    swallow it — like the real signal, nothing downstream of the crash
    point runs (the _COMPLETE marker is never written)."""


# message patterns for runtime status codes, CUDA/NCCL errors and
# preemption-shaped infrastructure failures.  Order matters: first
# match wins, and fatal codes are listed before the broad transient
# net so e.g. "INVALID_ARGUMENT: ... was ABORTED" stays fatal.
_MESSAGE_RULES = (
    # -- sticky CUDA errors: the context is poisoned, every later call
    # on it fails the same way — first, so no broader row (a "device
    # ... reset" preemption shape, a transient code quoted in the
    # text) can send them round the retry loop
    (re.compile(r"illegal memory access|device-side assert triggered|"
                r"unspecified launch failure|misaligned address",
                re.IGNORECASE), FATAL),
    # -- NCCL rank death: a peer's process exited mid-collective, or
    # the NCCL watchdog timed a collective out; the specific shapes
    # precede the fatal codes like the socket rows below
    (re.compile(r"remote process exit|ncclRemoteError|"
                r"Watchdog caught collective operation timeout",
                re.IGNORECASE), PREEMPTION),
    # the CUDA caching allocator's OOM text (torch.cuda.OutOfMemoryError
    # also classifies by type) and cudaMalloc's own error string: the
    # counterpart of RESOURCE_EXHAUSTED, ahead of any row its long
    # advice text could brush against
    (re.compile(r"CUDA out of memory|CUDA error: out of memory"),
     TRANSIENT),
    # -- preemption-shaped, TIGHTLY-ANCHORED dead-peer transport/
    # control-plane shapes: these precede even the fatal
    # status codes because a dead peer's gloo collective surfaces as
    # "FAILED_PRECONDITION: ... Gloo all-reduce failed: ... Connection
    # reset by peer" (observed on the CPU backend) and the specific
    # shape must win over the generic code.  ONLY phrases that cannot
    # plausibly appear in a programming error's text belong up here —
    # a bare word like "heartbeat" does not (an "INVALID_ARGUMENT:
    # heartbeat_interval must be positive" must stay fatal), so the
    # broader shapes rank BELOW the fatal codes.
    (re.compile(r"socket closed|connection reset|broken pipe",
                re.IGNORECASE), PREEMPTION),
    (re.compile(r"coordination service", re.IGNORECASE), PREEMPTION),
    (re.compile(r"barrier.{0,40}(time.?out|timed.?out)|"
                r"(time.?out|timed.?out).{0,40}barrier",
                re.IGNORECASE), PREEMPTION),
    # -- fatal status codes: the program itself is wrong --------------
    (re.compile(r"\bINVALID_ARGUMENT\b"), FATAL),
    (re.compile(r"\bFAILED_PRECONDITION\b"), FATAL),
    (re.compile(r"\bUNIMPLEMENTED\b"), FATAL),
    (re.compile(r"\bOUT_OF_RANGE\b"), FATAL),
    (re.compile(r"\bPERMISSION_DENIED\b"), FATAL),
    (re.compile(r"\bUNAUTHENTICATED\b"), FATAL),
    # -- preemption-shaped, broader: the platform took a worker/device
    # back, or the control plane says a peer is gone.  One category
    # (PREEMPTION) for every "a rank died" shape so the retry path and
    # the elastic coordinator classify them identically instead of
    # falling through to a blind TRANSIENT retry — but AFTER the fatal
    # codes, so a status-coded programming error whose text merely
    # mentions one of these words stays fatal.  Still BEFORE the
    # transient codes: "UNAVAILABLE: ... missing heartbeats" is a rank
    # death, not a generic blip.
    (re.compile(r"preempt", re.IGNORECASE), PREEMPTION),
    (re.compile(r"slice.*restart|restart.*slice", re.IGNORECASE),
     PREEMPTION),
    (re.compile(r"heartbeat", re.IGNORECASE), PREEMPTION),
    (re.compile(r"(peer|worker|task|process)"
                r".{0,40}(disconnect|unreachable|shut ?down|terminated|"
                r"exited|closed)", re.IGNORECASE), PREEMPTION),
    (re.compile(r"device.*(lost|halted|reset)", re.IGNORECASE),
     PREEMPTION),
    # -- transient status codes: infrastructure, not the program ------
    (re.compile(r"\bRESOURCE_EXHAUSTED\b"), TRANSIENT),
    (re.compile(r"\bUNAVAILABLE\b"), TRANSIENT),
    (re.compile(r"\bDEADLINE_EXCEEDED\b"), TRANSIENT),
    (re.compile(r"\bABORTED\b"), TRANSIENT),
    (re.compile(r"\bCANCELLED\b"), TRANSIENT),
)

# exception TYPES classified without looking at the message.  Python
# programming errors fail fast even if their text happens to contain a
# transient-looking word (an error note quoting a log line, say).
_FATAL_TYPES = (
    TypeError, KeyError, AttributeError, IndexError, NotImplementedError,
    AssertionError, NameError, ImportError, SyntaxError,
)
_TRANSIENT_TYPES = (
    InjectedTransientError, TimeoutError, torch.cuda.OutOfMemoryError,
)
# connection-level OS errors are how a dead peer manifests locally
# (gloo/PJRT surface SIGKILL'd ranks as resets and broken pipes), so
# they classify PREEMPTION by TYPE — is_transient still covers them,
# but the elastic coordinator sees them as a rank death.  A bare
# TimeoutError stays TRANSIENT: a slow socket is not a dead one.
_PREEMPTION_TYPES = (ConnectionError, BrokenPipeError)

# -- dump triggers: failure shapes that warrant a flight-
# recorder post-mortem BEFORE the error propagates.  Orthogonal to the
# transient/fatal axis — a RESOURCE_EXHAUSTED is *retried* (transient)
# AND *explained* (the executor writes the peak-HBM table + live-bytes
# timeline via flight_recorder.dump_oom when one finally surfaces).
_OOM_PATTERN = re.compile(
    r"\bRESOURCE_EXHAUSTED\b|\bout of memory\b|\ballocation fail",
    re.IGNORECASE)

# deadline/timeout-shaped failure text: a shed or stalled
# request must classify distinctly from generic transients — is_deadline
# walks the cause/context chain like is_oom, so a RetriesExhausted (or a
# serving-layer wrapper) around a watchdog stall still reads as one.
# Like OOM, deadline-shaped death is a flight-recorder dump trigger:
# the serving watchdog dumps the in-flight batch's metadata before
# escalating.
_DEADLINE_PATTERN = re.compile(
    r"\bDEADLINE_EXCEEDED\b|deadline exceeded|timed out\b"
    r"|watchdog stall", re.IGNORECASE)

# deadline-shaped exception TYPES for classify(): checked FIRST — a
# DeadlineExceeded whose message quotes a transient-looking log line
# must still fail fast.  (TimeoutError stays in _TRANSIENT_TYPES for
# classify — a bare socket timeout is retry-worthy — but is_deadline
# still recognizes it on the orthogonal axis.)
_DEADLINE_TYPES = (DeadlineExceeded,)

# the full inspectable table (used by the README and tests)
TAXONOMY = {
    "fatal_types": tuple(t.__name__ for t in _FATAL_TYPES),
    "transient_types": tuple(t.__name__ for t in _TRANSIENT_TYPES),
    "preemption_types": tuple(t.__name__ for t in _PREEMPTION_TYPES),
    "deadline_types": tuple(t.__name__ for t in _DEADLINE_TYPES),
    "message_rules": tuple((p.pattern, cls) for p, cls in _MESSAGE_RULES),
    "dump_triggers": {"oom": _OOM_PATTERN.pattern,
                      "deadline": _DEADLINE_PATTERN.pattern},
    # the fleet router's failover rule: which classes route
    # a per-replica failure onto a DIFFERENT replica
    "failover_classes": (TRANSIENT, PREEMPTION),
}


def classify(exc):
    """TRANSIENT, FATAL, DEADLINE or PREEMPTION for one exception
    instance.

    Precedence: deadline types > preemption types > transient types >
    fatal types > message rules > FATAL.  (An InjectedTransientError is
    a RuntimeError subclass; the type check must see it before any
    message rule fires.  A raw "DEADLINE_EXCEEDED" status message
    on a non-DeadlineExceeded type stays TRANSIENT — a collective
    rendezvous timeout is infrastructure and retry-worthy; only the
    runtime's own budget-expiry type means the budget is spent.)
    """
    if isinstance(exc, _DEADLINE_TYPES):
        return DEADLINE
    if isinstance(exc, _PREEMPTION_TYPES):
        return PREEMPTION
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    if isinstance(exc, _FATAL_TYPES):
        return FATAL
    msg = str(exc)
    for pattern, cls in _MESSAGE_RULES:
        if pattern.search(msg):
            return cls
    return FATAL


def is_transient(exc):
    """Retry-worthy: TRANSIENT or PREEMPTION.  A single throw cannot
    distinguish a network blip from a dead peer, so without an elastic
    coordinator the preemption shapes keep their historical
    retry-and-pray behavior; retry.py itself fails fast on PREEMPTION
    while a coordinator is active (it owns the recovery)."""
    return classify(exc) in (TRANSIENT, PREEMPTION)


def is_oom(exc):
    """True when `exc` is a memory-exhaustion failure — a MemoryError,
    or a RESOURCE_EXHAUSTED / CUDA out-of-memory message anywhere
    in the exception or its cause/context chain (a RetriesExhausted
    wrapping an OOM still reads as one).  The executor treats OOM as a
    DUMP TRIGGER: the flight recorder writes the peak-HBM post-mortem
    before the error propagates."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, MemoryError):
            return True
        if _OOM_PATTERN.search(str(exc)):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def is_preemption(exc):
    """True when `exc` is a rank-death / preemption-shaped failure —
    classified PREEMPTION anywhere in its cause/context chain (a
    RetriesExhausted wrapping a dead-peer connection reset still reads
    as one, like is_oom/is_deadline).  This is the single definition of
    "a rank died" the retry path and the elastic coordinator share:
    what retry refuses to blind-redial while a coordinator is active is
    exactly what the coordinator turns into a topology change."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if classify(exc) == PREEMPTION:
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def is_failover(exc):
    """True when a per-REPLICA failure should be retried on a
    DIFFERENT replica (the fleet router's failover rule) —
    distinct from plain retry: the same-replica budget is irrelevant
    because the router moves the request sideways instead of waiting
    out a backoff schedule against a dead socket.

    Failover-worthy: the transient and preemption shapes — a replica
    connection reset / RemoteDisconnected (its process was SIGKILL'd
    mid-request), an overload 503, a generic infrastructure blip.
    NOT failover-worthy: deadline shapes (the budget is spent — moving
    replicas cannot un-spend it) and fatal shapes (a bad request fails
    identically everywhere; re-running it N more times only multiplies
    the damage).  Walks the cause/context chain like is_oom/is_deadline
    so a router-side wrapper around the transport error still routes
    correctly — with deadline links checked first at every hop, since
    an expired budget must win over whatever transient noise the
    expiry surfaced alongside."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        cls = classify(exc)
        if cls == DEADLINE:
            return False
        if cls in (TRANSIENT, PREEMPTION):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def is_deadline(exc):
    """True when `exc` is a deadline/timeout-shaped failure — a
    DeadlineExceeded or TimeoutError, or a DEADLINE_EXCEEDED /
    "deadline exceeded" / watchdog-stall message anywhere in the
    exception or its cause/context chain (a RetriesExhausted wrapping a
    stalled dispatch still reads as one).  Orthogonal to classify():
    the serving layer uses it to count shed/stalled requests distinctly
    from generic transients and to trigger the watchdog's
    flight-recorder dump."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, _DEADLINE_TYPES + (TimeoutError,)):
            return True
        if _DEADLINE_PATTERN.search(str(exc)):
            return True
        exc = exc.__cause__ or exc.__context__
    return False
