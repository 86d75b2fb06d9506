"""The PyTorch port's ServingRuntime against the JAX package's.

Two models are saved by the JAX package and served by both runtimes
(`auto_start=False`, `process_once`, the same request script): the
reference serving tests' `served_model` (fc 6 -> 8 relu -> 3 softmax)
and the fused static GPT (`static_zoo.build_gpt`, its for_test forward
to the logits through `passes.fuse_program`).

- Bucket composition, the outcome ledger and the monitor counters are
  the same.
- Outputs agree within float32 atol = rtol = 1e-5 (MLP) and 1e-4 (GPT),
  and each output is bitwise equal to the port's own `Predictor.run` of
  the same rows padded to the same bucket.
- Deadline shedding, backpressure, retry, the breaker's degraded modes
  (eager, smallest_bucket, fail) and the watchdog's `raise` and
  `cancel_retry` policies are driven with threading.Events and a fake
  clock, never with wall-clock sleeps that assert latency.
- `BucketDispatcher` over a `CompiledPredictor` serves its exported batch
  as its one bucket, and `export_aot` / `import_aot` round-trip the
  per-bucket `.pt2` artifacts with no warm-up.

Everything runs on the CPU, where the kernels' wrappers take their
plain versions; on the card the same runtime goes through K1 and K4
(chip_smoke.py).
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import passes as jpasses
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import ServingRuntime as JRuntime

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.resilience import (CircuitOpenError, RetryPolicy,
                                         faultinject as tfi, taxonomy)
from paddle_tpu_torch.serving import (BucketDispatcher, DeadlineExceeded,
                                      QueueFullError, ServingClosedError,
                                      ServingRuntime, WatchdogStall)
from torch_threads import torch_threads  # noqa: F401


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"mlp": dir, "gpt": dir}, both saved by the JAX package."""
    root = tmp_path_factory.mktemp("serving_models")
    out = {}
    with jfluid.unique_name.guard():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            x = jfluid.data("x", [None, 6])
            h = jfluid.layers.fc(x, 8, act="relu")
            y = jfluid.layers.fc(h, 3, act="softmax")
    exe = jfluid.Executor()
    exe.run(startup)
    out["mlp"] = str(root / "mlp")
    jfluid.io.save_inference_model(out["mlp"], ["x"], [y], exe,
                                   main_program=main)
    m = jzoo.build_gpt()
    scope = jfluid.Scope()
    exe.run(m.startup, scope=scope)
    test = m.main.clone(for_test=True)
    logits = [op for op in test.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0] \
        .inputs["Logits"][0]
    fused, _ = jpasses.fuse_program(test._prune([logits]),
                                    fetch_names=[logits])
    out["gpt"] = str(root / "gpt")
    with jfluid.scope_guard(scope):
        jfluid.io.save_inference_model(out["gpt"], ["ids"], [logits], exe,
                                       main_program=fused)
    return out


@pytest.fixture(scope="module")
def mlp(models):
    return tinf.Predictor(models["mlp"], place="cpu")


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    old = (jflags.flag("flight_recorder_dir"),
           tflags.flag("flight_recorder_dir"))
    jflags.set_flags({"flight_recorder_dir": str(tmp_path / "jfr")})
    tflags.set_flags({"flight_recorder_dir": str(tmp_path / "tfr")})
    for fi in (jfi, tfi):
        fi.disarm()
    for mon in (jmonitor, tmonitor):
        mon.disable()
        mon.reset()
    yield
    for fi in (jfi, tfi):
        fi.disarm()
    for mon in (jmonitor, tmonitor):
        mon.disable()
        mon.reset()
        # no severe event may reach the atexit backstop's default dir
        mon.flight_recorder.get().clear()
    jflags.set_flags({"flight_recorder_dir": old[0]})
    tflags.set_flags({"flight_recorder_dir": old[1]})


def _feed(model, rows, seed):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        return {"x": rng.standard_normal((rows, 6)).astype(np.float32)}
    return {"ids": rng.integers(0, 128, size=(rows, 16)).astype(np.int64)}


def _mk(pred, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_window_s", 0.0)
    kw.setdefault("prewarm", False)
    kw.setdefault("label", f"t{time.perf_counter_ns()}")
    kw.setdefault("auto_start", False)
    return ServingRuntime(pred, **kw)


def _padded_ref(pred, feed, bucket):
    """The port's Predictor.run of the rows zero-padded to `bucket`,
    sliced back: the bitwise ground truth of the batched path."""
    rows = len(next(iter(feed.values())))
    padded = {k: np.concatenate(
        [v, np.zeros((bucket - rows,) + v.shape[1:], v.dtype)])
        for k, v in feed.items()}
    return [o[:rows] for o in pred.run(padded)]


# request script: (rows, seed); the max bucket (4) splits it into
# batches of 1+3, 2+1, 4, 2+2 ... by arrival order
SCRIPT = [(1, 0), (3, 1), (2, 2), (1, 3), (4, 4), (2, 5), (2, 6), (1, 7)]


def _serve(runtime_cls, pred, model, mon):
    mon.enable()
    rt = runtime_cls(pred, max_batch_size=4, batch_window_s=0.0,
                     auto_start=False, label=f"parity_{model}")
    feeds = [_feed(model, r, s) for r, s in SCRIPT]
    futs = [rt.submit(f) for f in feeds]
    passes = 0
    while not all(f.done() for f in futs):
        rt.process_once()
        passes += 1
    outs = [[np.asarray(o, np.float32) for o in f.result(0)] for f in futs]
    s = rt.summary()
    counters = {k: v for k, v in mon.snapshot()["counters"].items()
                if v and k.startswith(("serving.", "resilience."))}
    rt.close()
    ledger = {k: s[k] for k in ("requests", "outcomes", "batches",
                                "dispatched_rows", "padded_rows",
                                "buckets", "degraded_batches")}
    return outs, ledger, counters, passes, rt.prewarmed


@pytest.mark.parametrize("model,tol", [("mlp", 1e-5), ("gpt", 1e-4)])
def test_runtime_matches_the_reference_runtime(models, model, tol):
    jout, jled, jcnt, jpasses_, jwarm = _serve(
        JRuntime, JPredictor(models[model]), model, jmonitor)
    pred = tinf.Predictor(models[model], place="cpu")
    tout, tled, tcnt, tpasses_, twarm = _serve(
        ServingRuntime, pred, model, tmonitor)
    assert tled == jled and tpasses_ == jpasses_
    assert tcnt == jcnt and twarm == jwarm == 3
    assert tled["requests"] == sum(tled["outcomes"].values()) \
        == tled["outcomes"]["completed"] == len(SCRIPT)
    for got, want in zip(tout, jout):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
    # bitwise against the port's Predictor at the padded bucket, batch
    # by batch as the runtime forms them from the script
    rt = _mk(pred, label=f"bits_{model}")
    for group in _batch_groups(SCRIPT, 4):
        feeds = [_feed(model, r, s) for r, s in group]
        futs = [rt.submit(f) for f in feeds]
        rt.process_once()
        rows = sum(r for r, _ in group)
        bucket = next(b for b in (1, 2, 4) if b >= rows)
        merged = {k: np.concatenate([f[k] for f in feeds]) for k in feeds[0]}
        ref = _padded_ref(pred, merged, bucket)
        off = 0
        for fut, (r, _) in zip(futs, group):
            got = fut.result(1)
            for g, w in zip(got, ref):
                assert np.array_equal(g, w[off:off + r])
            off += r
    rt.close()


def _batch_groups(script, max_rows):
    """The runtime's greedy in-order batching of `script`."""
    groups, cur, rows = [], [], 0
    for r, s in script:
        if rows + r > max_rows:
            groups.append(cur)
            cur, rows = [], 0
        cur.append((r, s))
        rows += r
    groups.append(cur)
    return groups


def test_deadline_shed_and_backpressure_match_the_reference(models, mlp):
    ledgers = []
    for cls, pred in ((JRuntime, JPredictor(models["mlp"])),
                      (ServingRuntime, mlp)):
        clk = FakeClock()
        rt = cls(pred, max_batch_size=4, batch_window_s=0.0, prewarm=False,
                 auto_start=False, clock=clk, max_queue_depth=3,
                 label=f"shed_{cls.__module__}")
        f1 = rt.submit(_feed("mlp", 1, 0), deadline_s=0.05)
        f2 = rt.submit(_feed("mlp", 1, 1), deadline_s=50.0)
        f3 = rt.submit(_feed("mlp", 2, 2), deadline_s=0.05)
        with pytest.raises(Exception) as full:
            rt.submit(_feed("mlp", 1, 3))
        assert "backpressure" in str(full.value)
        if cls is ServingRuntime:
            assert isinstance(full.value, QueueFullError)
        clk.t += 0.1
        assert rt.sweep_expired() == 2
        for f in (f1, f3):
            err = f.exception(timeout=1)
            assert type(err).__name__ == "DeadlineExceeded"
            assert err.budget_s == 0.05
        assert not f2.done()
        rt.process_once()
        assert f2.exception(timeout=1) is None
        s = rt.summary()
        ledgers.append((s["requests"], s["outcomes"], s["buckets"]))
        rt.close()
    assert ledgers[1] == ledgers[0]
    assert ledgers[1][1]["shed"] == 2 and ledgers[1][1]["rejected"] == 1


def test_submit_validation_and_close(mlp):
    rt = _mk(mlp)
    with pytest.raises(KeyError):
        rt.submit({"y": np.zeros((1, 6), np.float32)})
    with pytest.raises(ValueError, match="largest serving bucket"):
        rt.submit(_feed("mlp", 5, 0))
    pending = rt.submit(_feed("mlp", 1, 0))
    rt.close()
    assert isinstance(pending.exception(timeout=1), ServingClosedError)
    with pytest.raises(ServingClosedError):
        rt.submit(_feed("mlp", 1, 0))
    s = rt.summary()
    assert s["outcomes"]["cancelled"] == 1 and s["pending"] == 0


def test_blocking_run_with_batcher_thread(mlp):
    feed = _feed("mlp", 3, 9)
    with ServingRuntime(mlp, max_batch_size=4, label="blocking") as rt:
        outs = rt.run(feed, timeout=30)
    ref = _padded_ref(mlp, feed, 4)
    assert all(np.array_equal(a, b) for a, b in zip(outs, ref))


def test_retry_recovers_injected_transient(mlp):
    tmonitor.enable()
    tfi.arm(transient_at_step=0, transient_times=1)
    rt = _mk(mlp, retry_policy=RetryPolicy(max_retries=2, base_delay=0.001,
                                           sleep=lambda d: None, seed=0))
    fut = rt.submit(_feed("mlp", 1, 0))
    rt.process_once()
    assert fut.exception(timeout=5) is None
    assert tmonitor.snapshot()["counters"]["resilience.retries"] == 1
    assert rt.stats.retries == 1 and rt.breaker.state == "closed"
    rt.close()


@pytest.mark.parametrize("mode", ["eager", "smallest_bucket", "fail"])
def test_breaker_open_degraded_modes(mlp, mode):
    tmonitor.enable()
    tfi.arm(transient_at_step=[0], transient_times=1)
    rt = _mk(mlp, retry_policy=None, breaker_threshold=1,
             breaker_cooldown_s=30.0, degraded_mode=mode)
    try:
        sacrifice = rt.submit(_feed("mlp", 1, 0))
        rt.process_once()
        assert taxonomy.classify(sacrifice.exception(timeout=5)) \
            == taxonomy.TRANSIENT
        assert rt.breaker.state == "open"
        feed = _feed("mlp", 2, 1)
        fut = rt.submit(feed)
        rt.process_once()
        s = rt.summary()
        assert s["requests"] == sum(s["outcomes"].values()) == 2
        if mode == "fail":
            assert isinstance(fut.exception(timeout=5), CircuitOpenError)
            assert s["outcomes"]["failed"] == 2
            assert s["degraded_batches"] == 0
            return
        res = fut.result(timeout=5)
        ref = mlp.run(feed) if mode == "eager" \
            else _padded_ref(mlp, feed, 2)
        assert all(np.array_equal(a, b) for a, b in zip(res, ref))
        assert s["degraded_batches"] == 1
        assert tmonitor.snapshot()["counters"][
            "resilience.serving_degraded"] == 1
    finally:
        rt.close()


def test_breaker_half_open_probe_closes(mlp):
    clk = FakeClock()
    tfi.arm(transient_at_step=[0], transient_times=1)
    rt = _mk(mlp, retry_policy=None, breaker_threshold=1,
             breaker_cooldown_s=5.0, clock=clk)
    rt.submit(_feed("mlp", 1, 0))
    rt.process_once()
    clk.t += 5.1
    fut = rt.submit(_feed("mlp", 1, 1))
    rt.process_once()
    assert fut.exception(timeout=5) is None
    assert [(t["from"], t["to"]) for t in
            rt.breaker.summary()["transitions"]] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    rt.close()


def test_deadline_expires_in_flight(mlp):
    hang = threading.Event()
    tfi.arm(stall_points={"serving.dispatch": hang})
    rt = _mk(mlp, watchdog_stall_s=60.0)
    fut = rt.submit(_feed("mlp", 1, 0), deadline_s=0.05)
    t = threading.Thread(target=rt.process_once, daemon=True)
    t.start()
    assert isinstance(fut.exception(timeout=10), DeadlineExceeded)
    assert rt.summary()["outcomes"]["expired"] == 1
    hang.set()
    t.join(10)
    rt.close()


def test_watchdog_raise_policy_dumps_and_fails_classified(mlp, tmp_path):
    hang = threading.Event()
    tfi.arm(stall_points={"serving.dispatch": hang})
    rt = _mk(mlp, auto_start=True, watchdog_stall_s=0.05,
             watchdog_poll_s=0.01, watchdog_policy="raise")
    try:
        fut = rt.submit(_feed("mlp", 2, 0))
        err = fut.exception(timeout=30)
        assert isinstance(err, WatchdogStall) and taxonomy.is_deadline(err)
        s = rt.summary()
        assert s["outcomes"]["stalled"] == 1 and s["watchdog_stalls"] == 1
        path = tmonitor.flight_recorder.get().last_dump
        assert os.path.dirname(path) == str(tmp_path / "tfr")
        recs = [json.loads(x) for x in open(path)]
        stall = [r for r in recs if r.get("event") == "serving_stall"]
        assert stall[0]["bucket"] == 2 and stall[0]["rows"] == 2
        assert [r for r in recs if r["kind"] == "serving"]
    finally:
        hang.set()
        rt.close()


def test_watchdog_cancel_retry_recovers_and_never_resolves_twice(mlp):
    hang = threading.Event()
    tfi.arm(stall_points={"serving.dispatch": hang})
    rt = _mk(mlp, auto_start=True, watchdog_stall_s=0.05,
             watchdog_poll_s=0.01, watchdog_policy="cancel_retry")
    try:
        feed = _feed("mlp", 2, 3)
        res = rt.run(feed, timeout=30)     # stall -> abandon -> re-run
        ref = _padded_ref(mlp, feed, 2)
        assert all(np.array_equal(a, b) for a, b in zip(res, ref))
        hang.set()                  # the abandoned call finishes late
        time.sleep(0.05)
        s = rt.summary()
        assert rt.stats.cancel_retries == 1
        assert s["outcomes"]["completed"] == 1 == s["requests"]
    finally:
        hang.set()
        rt.close()


def test_compiled_predictor_is_one_bucket(models, mlp, tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(d)
    path = mlp.export_compiled({"x": ((4, 6), "float32")}, d)
    cp = tinf.CompiledPredictor(path)
    disp = BucketDispatcher(cp)
    assert disp.buckets == [4] and disp.prewarm() == 0
    assert disp.export_aot(str(tmp_path / "aot")) == 0
    rt = ServingRuntime(cp, auto_start=False, batch_window_s=0.0,
                        label="compiled")
    feed = _feed("mlp", 3, 4)
    fut = rt.submit(feed)
    rt.process_once()
    ref = _padded_ref(mlp, feed, 4)
    for g, w in zip(fut.result(1), ref):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    rt.close()


def test_aot_export_import_round_trip(models, mlp, tmp_path):
    tmonitor.enable()
    src = BucketDispatcher(mlp, max_batch=4)
    assert src.export_aot(str(tmp_path / "aot"), platforms="cpu") == 3
    assert sorted(os.listdir(tmp_path / "aot")) == ["b1.pt2", "b2.pt2",
                                                    "b4.pt2"]
    with pytest.raises(ValueError, match="device type"):
        src.export_aot(str(tmp_path / "x"), platforms=["cpu", "cuda"])
    pred = tinf.Predictor(models["mlp"], place="cpu")
    rt = ServingRuntime(pred, max_batch_size=4, prewarm=False,
                        auto_start=False, batch_window_s=0.0, label="aot")
    assert rt.dispatcher.import_aot(str(tmp_path / "aot")) == 3
    assert rt.dispatcher.prewarm() == 0
    counters = tmonitor.snapshot()["counters"]
    assert counters["serving.aot_import"] == 3
    assert counters.get("serving.bucket_compile", 0) == 0
    feed = _feed("mlp", 3, 5)
    fut = rt.submit(feed)
    rt.process_once()
    for g, w in zip(fut.result(1), _padded_ref(mlp, feed, 4)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    rt.close()


def test_serving_table_snapshot_and_telemetry(mlp, tmp_path):
    path = str(tmp_path / "t.jsonl")
    tmonitor.enable(jsonl_path=path)
    rt = _mk(mlp, label="table")
    rt.submit(_feed("mlp", 1, 0))
    rt.process_once()
    rows = {r["key"]: r for r in tmonitor.serving_table()}
    assert rows["table"]["outcomes"]["completed"] == 1
    assert any(r["key"] == "table" for r in tmonitor.snapshot()["serving"])
    rt.close()
    recs = tmonitor.read_jsonl(path)
    assert any(r["kind"] == "serving" and r["key"] == "table"
               for r in recs)
