"""The hardened half of the port's DecodeEngine against the JAX package's.

Both engines serve the `tests/test_torch_serving.py` GPT (2 layers,
hidden 64, weights crossed as numpy) with `auto_start=False` and
`step()`, under the same fake clock, budgets and armed faults:

- greedy tokens are exactly equal and every request ends in the same
  outcome: normal traffic, a transient at `decode.step` that the retry
  absorbs, a per-token budget that sheds a queued request and expires a
  slot-resident one (whose slot the kill mask retires and the queue
  refills), a failed dispatch that opens a threshold-1 breaker and
  breaks the engine, and a stalled step that the watchdog turns into a
  `stalled` outcome, a broken engine and a flight dump naming the
  request;
- every dispatch runs with grad mode off on its worker thread, and its
  outputs carry no autograd graph;
- `requests == sum(outcomes)` in every run, and a trace tree per request
  closes with its ledger outcome.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import nn as jnn
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.resilience import RetryPolicy as JRetryPolicy
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import decode as jdecode

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import generate as G
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.resilience import RetryPolicy, faultinject as tfi
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineBrokenError,
                                      WatchdogStall)
from torch_threads import torch_threads  # noqa: F401

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=48)


@pytest.fixture(scope="module")
def pair():
    np.random.seed(11)
    jm = JGPT(JGPTConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    return jm, tm


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


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _engines(pair, clocks=(None, None), **kw):
    """(reference engine, port engine) with the same knobs, each on its
    own clock."""
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (16,))
    kw.setdefault("watchdog_stall_s", 30.0)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("retry_policy") == "nosleep":
        jkw["retry_policy"] = JRetryPolicy(max_retries=2, sleep=lambda d: 0,
                                           seed=0)
        tkw["retry_policy"] = RetryPolicy(max_retries=2, sleep=lambda d: 0,
                                          seed=0)
    label = f"hard{time.perf_counter_ns()}"
    jm, tm = pair
    je = jdecode.DecodeEngine(
        jm, config=jdecode.DecodeConfig(clock=clocks[0] or time.monotonic,
                                        label="j" + label, **jkw),
        auto_start=False)
    te = tdecode.DecodeEngine(
        tm, config=tdecode.DecodeConfig(clock=clocks[1] or time.monotonic,
                                        label="t" + label, **tkw),
        auto_start=False)
    return je, te


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=n).astype(np.int32) for n in lens]


def _outcome(fut):
    err = fut.exception(timeout=0)
    return ("ok", fut.result(0).tolist()) if err is None \
        else type(err).__name__


def _drive(eng, script, clock=None, max_steps=200):
    """script: list of ("submit", args, kwargs) / ("step",) /
    ("advance", dt) / ("drain",); returns [outcome per request]."""
    futs = []
    for op in script:
        if op[0] == "submit":
            futs.append(eng.submit(*op[1], **op[2]))
        elif op[0] == "step":
            eng.step()
        elif op[0] == "advance":
            clock.t += op[1]
        elif op[0] == "sweep":
            eng.sweep_expired()
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            break
        if not eng.step() and eng._broken:
            break
    s = eng.summary()
    assert s["requests"] == sum(s["outcomes"].values())
    return [_outcome(f) for f in futs], s


def _both(pair, script_fn, clock_fn=None, **kw):
    jc, tc = (clock_fn(), clock_fn()) if clock_fn else (None, None)
    je, te = _engines(pair, clocks=(jc, tc), **kw)
    jout, js = _drive(je, script_fn(), jc)
    tout, ts = _drive(te, script_fn(), tc)
    je.close()
    te.close()
    return (jout, js), (tout, ts), te


def _normal_script():
    p = _prompts(1, (5, 9, 3, 12))
    return [("submit", (p[0], 6), {}), ("submit", (p[1], 4), {}),
            ("step",), ("submit", (p[2], 7), {}),
            ("submit", (p[3], 3), {})]


def test_normal_traffic_token_exact_and_no_grad(pair, monkeypatch):
    seen = []
    real = tdecode._decode_step_impl

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((torch.is_grad_enabled(),
                     [(t.requires_grad, t.grad_fn) for t in out]))
        return out

    monkeypatch.setattr(tdecode, "_decode_step_impl", spy)
    (jout, js), (tout, ts), te = _both(pair, _normal_script)
    assert tout == jout
    assert all(o[0] == "ok" for o in tout)
    assert ts["outcomes"] == js["outcomes"]
    assert ts["decode"]["tokens_total"] == js["decode"]["tokens_total"]
    # against the port's own generate()
    _, tm = pair
    for (kind, toks), (op, args, _) in zip(
            tout, [s for s in _normal_script() if s[0] == "submit"]):
        ref = G.generate(tm, args[0][None, :],
                         max_new_tokens=args[1]).numpy()[0]
        assert toks == ref.tolist()
    assert seen and all(not grad and all(not rg and fn is None
                                         for rg, fn in outs)
                        for grad, outs in seen)
    assert te._state["k"].grad_fn is None
    assert not te._state["k"].requires_grad


def test_transient_at_decode_step_is_retried_tokens_unchanged(pair):
    (ref, _), _, _ = _both(pair, _normal_script)
    for fi in (jfi, tfi):
        # the engines never advance the plan's step counter: step -1
        # is "the current dispatch", whichever it is
        fi.arm(transient_at_step=-1, transient_times=1)
    (jout, js), (tout, ts), _ = _both(pair, _normal_script,
                                      retry_policy="nosleep")
    assert tout == jout == ref
    assert ts["dispatch_retries"] == js["dispatch_retries"] == 1
    assert ts["breaker"]["state"] == "closed"


def _budget_script():
    p = _prompts(2, (4, 6, 5))
    return [("submit", (p[0], 8), {"token_budget_s": 0.5}),
            ("submit", (p[1], 5), {}),
            ("step",), ("step",),             # prefill both, one token
            ("submit", (p[2], 4), {"token_budget_s": 0.5}),
            ("advance", 1.0),                 # both budgets pass
            ("sweep",)]


def test_token_budgets_shed_and_expire_the_same(pair):
    (jout, js), (tout, ts), _ = _both(pair, _budget_script,
                                      clock_fn=FakeClock, slots=2)
    assert tout == jout
    assert tout[0] == "DeadlineExceeded" and tout[2] == "DeadlineExceeded"
    assert tout[1][0] == "ok"
    assert ts["outcomes"] == js["outcomes"]
    assert ts["outcomes"]["expired"] == 1 and ts["outcomes"]["shed"] == 1


def test_default_token_budget_applies(pair):
    clk = FakeClock()
    _, tm = pair
    eng = tdecode.DecodeEngine(
        tm, config=tdecode.DecodeConfig(slots=1, max_len=48, buckets=(16,),
                                        default_token_budget_s=0.25,
                                        clock=clk, prewarm=False),
        auto_start=False)
    fut = eng.submit(_prompts(3, (4,))[0], 4)
    clk.t += 0.5
    assert eng.sweep_expired() == 1
    err = fut.exception(timeout=0)
    assert isinstance(err, DeadlineExceeded) and err.budget_s == 0.25
    eng.close()


def _upfront_script():
    p = _prompts(5, (5, 9, 3))
    return [("submit", (p[0], 6), {}), ("submit", (p[1], 4), {}),
            ("submit", (p[2], 7), {})]


def test_failed_dispatch_opens_breaker_and_breaks_engine(pair):
    for fi in (jfi, tfi):
        fi.arm(transient_at_step=-1, transient_times=1)
    (jout, js), (tout, ts), te = _both(pair, _upfront_script,
                                       retry_policy=None,
                                       breaker_threshold=1)
    assert tout == jout
    assert ts["outcomes"] == js["outcomes"]
    assert ts["outcomes"]["failed"] == 1
    assert ts["outcomes"]["cancelled"] == 2
    assert tout.count(EngineBrokenError.__name__) == 2
    assert ts["breaker"]["state"] == js["breaker"]["state"] == "open"
    assert not te.breaker.allow()            # fails fast
    assert te._broken and te.step() == 0


def _stall_run(eng, fi, hang):
    fi.arm(stall_points={"decode.step": hang})
    p = _prompts(4, (5, 7))
    futs = [eng.submit(p[0], 6), eng.submit(p[1], 6)]
    eng.watchdog.start()
    t = threading.Thread(target=eng.step, daemon=True)
    t.start()
    outs = [f.exception(timeout=30) for f in futs]
    hang.set()
    t.join(10)
    s = eng.summary()
    eng.close()
    return [type(e).__name__ for e in outs], s


def test_stall_gives_stalled_broken_engine_and_flight_dump(pair, tmp_path):
    je, te = _engines(pair, watchdog_stall_s=0.05, watchdog_poll_s=0.01,
                      retry_policy=None)
    jnames, js = _stall_run(je, jfi, threading.Event())
    tnames, ts = _stall_run(te, tfi, threading.Event())
    assert tnames == jnames == ["WatchdogStall", "EngineBrokenError"]
    assert ts["outcomes"] == js["outcomes"]
    assert ts["outcomes"]["stalled"] == 1 and ts["watchdog_stalls"] == 1
    assert ts["pending"] == 0
    assert isinstance(WatchdogStall("x"), DeadlineExceeded)
    path = tmonitor.flight_recorder.get().last_dump
    assert str(tmp_path / "tfr") in path
    recs = [json.loads(x) for x in open(path)]
    stall = [r for r in recs if r.get("event") == "serving_stall"]
    assert stall and stall[0]["op"] == "prefill" and stall[0]["rid"] == 1
    # the engine broke after the dump: the event is in the ring, and
    # armed the atexit backstop
    events = tmonitor.flight_recorder.get().snapshot()["events"]
    assert any(e["event"] == "decode_engine_broken" for e in events)


def test_traces_close_with_ledger_outcomes(pair):
    tflags.set_flags({"request_tracing": True})
    try:
        ttracing.get().reset()
        clk = FakeClock()
        _, te = _engines(pair, clocks=(None, clk), slots=2)
        out, s = _drive(te, _budget_script(), clk)
        te.close()
        trees = ttracing.get().retained_trees(te.config.label)
        assert sorted(t["outcome"] for t in trees) == sorted(
            ["completed", "expired", "shed"])
        assert all(ttracing.tree_problems(t) == [] for t in trees)
        done = [t for t in trees if t["outcome"] == "completed"][0]
        names = [sp["name"] for sp in done["spans"]]
        assert names[:2] == ["decode.request/" + te.config.label, "queue"]
        assert "prefill/b16" in names and "decode" in names
    finally:
        tflags.set_flags({"request_tracing": False})
        ttracing.get().reset()
