"""The PyTorch port's resilience tier against the JAX package's.

- The taxonomy classifies the reference's table of messages the same,
  and the CUDA rows as stated: torch's out-of-memory TRANSIENT and
  `is_oom`, the sticky CUDA errors FATAL, NCCL's rank-death shapes
  PREEMPTION.
- The circuit breaker makes the same transitions under the same fake
  clock.
- `RetryPolicy(seed=)` gives the same delay schedules, give-ups and
  counters.
- Fault-injection schedules fire at the same hits.
- The flags the serving tier reads default to the reference's values.
"""

import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu.resilience import breaker as jbreaker
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.resilience import taxonomy as jtax

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.resilience import breaker as tbreaker
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.resilience import retry as tretry
from paddle_tpu_torch.resilience import taxonomy as ttax
from torch_threads import torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    old = (jflags.flag("flight_recorder_dir"),
           tflags.flag("flight_recorder_dir"))
    jflags.set_flags({"flight_recorder_dir": str(tmp_path / "jfr")})
    tflags.set_flags({"flight_recorder_dir": str(tmp_path / "tfr")})
    for m in (jmonitor, tmonitor):
        m.disable()
        m.reset()
    jfi.disarm()
    tfi.disarm()
    yield
    jfi.disarm()
    tfi.disarm()
    for m in (jmonitor, tmonitor):
        m.disable()
        m.reset()
        # no severe event may reach the atexit backstop's default dir
        m.flight_recorder.get().clear()
    jflags.set_flags({"flight_recorder_dir": old[0]})
    tflags.set_flags({"flight_recorder_dir": old[1]})


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

REFERENCE_MESSAGES = [
    "RESOURCE_EXHAUSTED: out of memory allocating",
    "DEADLINE_EXCEEDED: slept too long",
    "ABORTED: cross-replica op cancelled",
    "UNAVAILABLE: coordination service error",
    "worker was preempted by the scheduler",
    "Socket closed before handshake",
    "barrier timed out waiting for 1 of 2 tasks",
    "coordinator detected missing heartbeats from task 1",
    "connection reset by peer",
    "peer process terminated unexpectedly",
    "INVALID_ARGUMENT: computation was ABORTED",
    "INVALID_ARGUMENT: heartbeat_interval must be positive",
    "FAILED_PRECONDITION: Gloo all-reduce failed: Connection reset by peer",
    "UNIMPLEMENTED: op", "OUT_OF_RANGE: index", "PERMISSION_DENIED: x",
    "UNAUTHENTICATED: y", "CANCELLED: z", "UNAVAILABLE: socket",
    "slice restart requested", "device halted", "huh",
    "request deadline exceeded after 5ms", "serving watchdog stall: 2s",
    "Attempting to allocate 1.91GiB: allocation failed",
]


@pytest.mark.parametrize("msg", REFERENCE_MESSAGES)
def test_reference_messages_classify_the_same(msg):
    exc_j, exc_t = RuntimeError(msg), RuntimeError(msg)
    assert ttax.classify(exc_t) == jtax.classify(exc_j)
    for fn in ("is_transient", "is_oom", "is_deadline", "is_preemption",
               "is_failover"):
        assert getattr(ttax, fn)(exc_t) == getattr(jtax, fn)(exc_j), fn


def test_reference_types_classify_the_same():
    for make in (lambda m: KeyError(m), lambda m: TypeError(m),
                 lambda m: TimeoutError(m), lambda m: ConnectionResetError(m),
                 lambda m: BrokenPipeError(m), lambda m: MemoryError(m)):
        assert ttax.classify(make("RESOURCE_EXHAUSTED")) \
            == jtax.classify(make("RESOURCE_EXHAUSTED"))
    assert ttax.classify(ttax.InjectedTransientError("x")) == ttax.TRANSIENT
    assert ttax.classify(ttax.DeadlineExceeded("x")) == ttax.DEADLINE
    for key in ("fatal_types", "preemption_types", "deadline_types",
                "dump_triggers", "failover_classes"):
        assert ttax.TAXONOMY[key] == jtax.TAXONOMY[key], key
    # every reference row is kept, in order; the CUDA rows come in front
    ref_rows = list(jtax.TAXONOMY["message_rules"])
    port_rows = list(ttax.TAXONOMY["message_rules"])
    assert port_rows[-len(ref_rows):] == ref_rows


def test_cuda_rows():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.10 GiB of which 1.12 GiB is free. Process 4242 has "
        "77.97 GiB memory in use.")
    assert ttax.classify(oom) == ttax.TRANSIENT
    assert ttax.is_oom(oom) and ttax.is_transient(oom)
    assert ttax.classify(RuntimeError(
        "CUDA error: out of memory")) == ttax.TRANSIENT
    for msg in ("CUDA error: an illegal memory access was encountered\n"
                "CUDA kernel errors might be asynchronously reported at "
                "some other API call, so the stacktrace below might be "
                "incorrect.",
                "CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure",
                "CUDA error: misaligned address",
                # a transient code quoted in the text does not win
                "UNAVAILABLE: CUDA error: an illegal memory access was "
                "encountered"):
        exc = RuntimeError(msg)
        assert ttax.classify(exc) == ttax.FATAL, msg
        assert not ttax.is_transient(exc) and not ttax.is_failover(exc)
    for msg in ("NCCL error in: ProcessGroupNCCL.cpp:1234, remote process "
                "exited or there was a network error, NCCL version 2.21.5",
                "ncclRemoteError: A call failed possibly due to a network "
                "error or a remote process exiting prematurely.",
                "[Rank 0] Watchdog caught collective operation timeout: "
                "WorkNCCL(SeqNum=7, OpType=ALLREDUCE, Timeout(ms)=600000) "
                "ran for 600035 milliseconds before timing out."):
        exc = RuntimeError(msg)
        assert ttax.classify(exc) == ttax.PREEMPTION, msg
        assert ttax.is_preemption(exc) and ttax.is_failover(exc)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_trace(mod):
    clock = FakeClock()
    b = mod.CircuitBreaker(failure_threshold=3, cooldown_s=10.0,
                           clock=clock, name="t")
    seen = []
    script = ["f", "s", "f", "f", "f", "allow", "t5", "allow", "t6",
              "allow", "allow", "f", "allow", "t10", "allow", "release",
              "allow", "s", "allow", "t20", "f", "f", "f", "t10", "allow",
              "t10", "allow"]
    for op in script:
        if op == "f":
            b.note_failure(RuntimeError("UNAVAILABLE"))
        elif op == "s":
            b.note_success()
        elif op == "allow":
            seen.append(b.allow())
        elif op == "release":
            b.release_probe()
        else:
            clock.t += float(op[1:])
        seen.append(b.state)
    summary = b.summary()
    summary.pop("transitions")
    return seen, b.transitions, summary


def test_breaker_transitions_equal_under_fake_clock():
    assert _breaker_trace(tbreaker) == _breaker_trace(jbreaker)
    with pytest.raises(ValueError):
        tbreaker.CircuitBreaker(failure_threshold=0)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def _retry_run(retry_mod, tax_mod, mon, fail_times, max_retries, seed):
    mon.enable()
    delays = []
    pol = retry_mod.RetryPolicy(max_retries=max_retries, base_delay=0.5,
                                max_delay=3.0, multiplier=2.0, jitter=0.4,
                                sleep=delays.append, seed=seed)
    calls = [0]
    retries = []

    def flaky():
        calls[0] += 1
        if calls[0] <= fail_times:
            raise tax_mod.InjectedTransientError("RESOURCE_EXHAUSTED")
        return "ok"

    try:
        out = retry_mod.call_with_retry(
            flaky, pol, on_retry=lambda a, d, e: retries.append((a, d)))
    except retry_mod.RetriesExhausted as e:
        out = ("gave up", e.attempts, type(e.last_error).__name__)
    counters = mon.snapshot()["counters"]
    return (out, delays, retries, calls[0],
            {k: counters.get(k, 0) for k in ("resilience.retries",
                                             "resilience.retry_giveup")})


@pytest.mark.parametrize("fail_times,max_retries,seed", [
    (3, 5, 7), (6, 4, 0), (0, 2, 3), (2, 2, 11)])
def test_retry_schedules_and_giveups_equal(fail_times, max_retries, seed):
    ref = _retry_run(jretry, jtax, jmonitor, fail_times, max_retries, seed)
    got = _retry_run(tretry, ttax, tmonitor, fail_times, max_retries, seed)
    assert got == ref


def test_retry_fails_fast_on_fatal_and_sticky_cuda():
    pol = tretry.RetryPolicy(max_retries=5, sleep=lambda d: pytest.fail(
        "must not back off on a fatal error"))
    for exc in (ValueError("bad shape"),
                RuntimeError("CUDA error: device-side assert triggered")):
        def boom(exc=exc):
            raise exc

        with pytest.raises(type(exc)):
            tretry.call_with_retry(boom, pol)
    assert tres.enable_retry(pol) is tres.active_retry()
    tres.disable_retry()
    assert tres.active_retry() is None


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

def _fault_schedule(fi):
    out = []
    plan = fi.arm(transient_at_step=[1, 3], transient_times=2,
                  crash_points={"c": 2}, stall_points={"s": (1, 0.0)},
                  nan_at_steps=(0, 2))
    for step in range(5):
        feeds = fi.on_step_feed({"x": np.ones((2, 3), np.float32),
                                 "ids": np.ones((2,), np.int64)})
        out.append(("nan", step, bool(np.isnan(
            np.asarray(feeds["x"])).any())))
        try:
            fi.check_transient()
            out.append(("ok", step))
        except fi.InjectedTransientError:
            out.append(("transient", step))
    for hit in range(4):
        try:
            fi.crash_point("c")
            out.append(("lived", hit))
        except fi.InjectedCrash:
            out.append(("crash", hit))
        fi.stall_point("s")
    out.append(dict(plan.fired))
    fi.disarm()
    return out


def test_fault_schedules_fire_at_the_same_hits(tmp_path):
    assert _fault_schedule(tfi) == _fault_schedule(jfi)


def test_nan_injection_taints_torch_float_feed_only():
    tfi.arm(nan_at_steps=0)
    feed = {"a_ids": torch.ones(2, dtype=torch.int64),
            "x": torch.ones(2, 3)}
    out = tfi.on_step_feed(feed)
    assert torch.isnan(out["x"]).all() and not torch.isnan(feed["x"]).any()
    assert out["a_ids"] is feed["a_ids"]


def test_stall_point_event_blocks_until_released():
    ev = threading.Event()
    tfi.arm(stall_points={"p": ev})
    done = threading.Event()
    t = threading.Thread(target=lambda: (tfi.stall_point("p"), done.set()))
    t.start()
    assert not done.wait(0.05)
    ev.set()
    t.join(5)
    assert done.is_set()


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

SERVING_FLAGS = [
    "fleet_failover_attempts", "fleet_health_poll_s",
    "fleet_request_timeout_s", "flight_recorder", "flight_recorder_dir",
    "flight_recorder_steps", "metrics_host", "metrics_port",
    "request_tracing", "serving_deadline_s", "serving_slo_ms",
    "serving_watchdog_stall_s", "telemetry_keep", "telemetry_max_mb",
    "trace_buffer", "trace_sample", "serving_queue_depth", "decode_slots",
    "decode_max_len", "decode_token_budget_s",
]


@pytest.mark.parametrize("name", SERVING_FLAGS)
def test_serving_flag_defaults_equal_the_reference(name):
    want = jflags._REGISTRY[name].default
    if name == "flight_recorder_dir":
        # the reference's directory name, under this process's temp dir
        # (the reference's own /tmp when TMPDIR is unset)
        want = os.path.join(tempfile.gettempdir(), os.path.basename(want))
    assert tflags._REGISTRY[name].default == want
    assert type(tflags._REGISTRY[name].default) is type(want)
