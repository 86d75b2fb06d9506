"""The PyTorch port's fleet tier (registry -> replica -> router) against
the JAX package's.

Two tiny models (fc 6 -> hidden relu -> 3 softmax, hidden 8 and 4) are
saved by the JAX package and published as v1 and v2.

- The registry's publish / pointer / crash-at-marker protocol lists the
  same versions as the reference's after the same sequence.
- The AOT cache is keyed `aot/v<NNNN>/<device kind>/`: the first CPU
  host writes one `.pt2` per bucket under `cpu`, a cold host imports
  them with zero bucket warm-ups and predicts bitwise the same, and the
  cell of another device kind stays empty.
- A hot swap under traffic drops nothing, and the rolled-back version
  predicts bitwise as before.
- Behind a FleetRouter, a killed replica's traffic fails over and the
  fleet ledger holds requests == sum(outcomes); the same sequence
  through the reference's fleet gives the same router ledger, and
  outputs within float32 atol = rtol = 1e-5.
- One replica runs as a subprocess (`python -m
  paddle_tpu_torch.serving.replica --device cpu`) behind the router.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu.resilience import faultinject as jfi
from paddle_tpu.serving import (FleetRouter as JRouter,
                                ModelRegistry as JRegistry,
                                ReplicaServer as JReplica)

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.resilience import faultinject as tfi
from paddle_tpu_torch.serving import (FleetRouter, ModelHost, ModelRegistry,
                                      ReplicaServer, router_table)
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = {"max_batch_size": 2, "batch_window_s": 0.0}


def _build_model(dirname, hidden):
    with jfluid.unique_name.guard():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            x = jfluid.data("x", [None, 6])
            h = jfluid.layers.fc(x, hidden, act="relu")
            out = jfluid.layers.fc(h, 3, act="softmax")
    exe = jfluid.Executor()
    exe.run(startup)
    jfluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                   main_program=main)
    return dirname


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    return (_build_model(str(tmp_path_factory.mktemp("fleet_a")), 8),
            _build_model(str(tmp_path_factory.mktemp("fleet_b")), 4))


def _registry(cls, root, model_dirs):
    reg = cls(str(root))
    assert (reg.publish(model_dirs[0]), reg.publish(model_dirs[1])) == (1, 2)
    reg.set_current(1)
    return reg


@pytest.fixture()
def registry(model_dirs, tmp_path):
    return _registry(ModelRegistry, tmp_path / "reg", model_dirs)


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


def _feed(rows=1, seed=0):
    return {"x": np.random.default_rng(seed)
            .standard_normal((rows, 6)).astype(np.float32)}


def _post(port, path, doc):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=json.dumps(doc).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _registry_story(reg_cls, fi, root, model_dirs):
    reg = reg_cls(str(root))
    seen = []
    with pytest.raises(fi.InjectedCrash):
        with fi.plan_scope(crash_points={"registry.before_marker": 0}):
            reg.publish(model_dirs[0], version=1)
    seen.append((reg.versions(), reg.current()))
    seen.append(reg.publish(model_dirs[0], version=1))
    seen.append(reg.publish(model_dirs[1]))
    reg.set_current(2)
    seen.append((reg.versions(), reg.current(), reg.latest()))
    os.makedirs(reg.version_dir(7))
    with pytest.raises(Exception) as err:
        reg.set_current(7)
    seen.append(type(err.value).__name__)
    with pytest.raises(fi.InjectedCrash):
        with fi.plan_scope(crash_points={"registry.aot.before_marker": 0}):
            reg.publish_aot(1, "NVIDIA H100 80GB HBM3", _fake_aot)
    seen.append(reg.has_aot(1, "NVIDIA H100 80GB HBM3"))
    seen.append(reg.publish_aot(1, "NVIDIA H100 80GB HBM3", _fake_aot))
    seen.append(reg.publish_aot(1, "NVIDIA H100 80GB HBM3", _fake_aot))
    seen.append(os.path.relpath(reg.aot_dir(1, "NVIDIA H100 80GB HBM3"),
                                reg.root))
    return seen


def _fake_aot(d):
    with open(os.path.join(d, "b1.pt2"), "wb") as f:
        f.write(b"artifact")
    return 1


def test_registry_protocol_matches_the_reference(model_dirs, tmp_path):
    ref = _registry_story(JRegistry, jfi, tmp_path / "j", model_dirs)
    got = _registry_story(ModelRegistry, tfi, tmp_path / "t", model_dirs)
    assert got == ref
    assert got[-1] == os.path.join("aot", "v0001", "NVIDIA_H100_80GB_HBM3")


def test_aot_cache_keyed_by_device_kind(registry):
    tmonitor.enable()
    warm = ModelHost(registry, name="warm", config_kw=dict(KW),
                     place="cpu")
    warm.start(1)
    feed = _feed(2, seed=5)
    ref = warm.run(feed)
    try:
        assert warm.device_kind == "cpu"
        assert warm.bucket_compiles == 2 and warm.aot_exported == 2
        assert registry.has_aot(1, "cpu")
        assert sorted(f for f in os.listdir(registry.aot_dir(1, "cpu"))
                      if f.endswith(".pt2")) == ["b1.pt2", "b2.pt2"]
        # an artifact of one kind never serves another
        assert not registry.has_aot(1, "NVIDIA H100 80GB HBM3")
        cold = ModelHost(registry, name="cold", config_kw=dict(KW),
                         place="cpu")
        cold.start(1)
        try:
            assert cold.aot_imported == 2
            assert cold.stats_doc()["serving_compile_events"] == 0
            got = cold.run(feed)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(r, g)
        finally:
            cold.close()
    finally:
        warm.close()
    assert tmonitor.snapshot()["counters"]["serving.aot_import"] == 2


def test_hot_swap_under_traffic_drops_nothing(registry):
    host = ModelHost(registry, name="swap", config_kw=dict(KW),
                     place="cpu")
    host.start(1)
    feed = _feed(2, seed=3)
    before = host.run(feed)
    errors, completed = [], [0]
    done = threading.Event()

    def traffic():
        i = 0
        while not done.is_set() or i < 3:
            try:
                host.run(_feed(1, seed=i))
                completed[0] += 1
            except Exception as e:  # noqa: BLE001 — test verdict
                errors.append(repr(e))
            i += 1

    threads = [threading.Thread(target=traffic, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        assert host.swap_to(2) == 1
        assert host.swap_to(1) == 2
    finally:
        done.set()
        for t in threads:
            t.join(timeout=30)
    after = host.run(feed)
    host.close()
    assert not errors, errors[:3]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    merged = host.merged_ledger()
    assert merged["requests"] == completed[0] + 2
    assert merged["outcomes"]["completed"] == merged["requests"]
    assert merged["pending"] == 0
    assert [r["version"] for r in merged["per_version"]] == [1, 2, 1]


def test_replica_requires_a_card_unless_given_cpu(registry):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelHost(registry, name="nocard")


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _fleet_story(reg, replica_cls, router_cls, place_kw):
    reps = [replica_cls(reg, name=f"r{i}", config_kw=dict(KW), **place_kw)
            for i in range(2)]
    router = router_cls(
        [(s.host_model.name, "127.0.0.1", s.port) for s in reps],
        label=f"fleet{time.perf_counter_ns()}", auto_poll=False,
        request_timeout_s=10.0)
    outs = []
    try:
        for i in range(4):
            outs.append(router.run(_feed(1, seed=i)))
        status, doc = _post(reps[1].port, "/swap", {"version": 2})
        assert status == 200 and doc == {"version": 2, "previous": 1}
        status, doc = _post(reps[1].port, "/swap", {"version": 1})
        reps[0].kill()                   # socket gone mid-fleet
        for i in range(4, 8):
            outs.append(router.run(_feed(1, seed=i)))
        router.poll_once()
        ledger = router.fleet_ledger()
        table = [r for r in router_table() if r["label"] == router.label] \
            if router_cls is FleetRouter else None
    finally:
        router.close(emit=False)
        for s in reps:
            s.close()
    return outs, ledger, router.failovers, table


def test_router_failover_and_ledger_match_the_reference(model_dirs,
                                                        tmp_path):
    jreg = _registry(JRegistry, tmp_path / "j", model_dirs)
    treg = _registry(ModelRegistry, tmp_path / "t", model_dirs)
    jouts, jled, jfail, _ = _fleet_story(jreg, JReplica, JRouter, {})
    touts, tled, tfail, table = _fleet_story(
        treg, ReplicaServer, FleetRouter, {"place": "cpu"})
    assert tfail == jfail >= 1
    assert tled["router"]["requests"] == jled["router"]["requests"] == 8
    assert tled["router"]["outcomes"] == jled["router"]["outcomes"]
    assert tled["router"]["outcomes"]["completed"] == 8
    assert tled["attempts"] == jled["attempts"]
    assert tled["attempts"]["unaccounted"] == 0
    merged = tled["merged"]
    assert merged["requests"] == merged["resolved"]
    assert merged["unaccounted"] == 0
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(np.asarray(t[0], np.float32),
                                   np.asarray(j[0], np.float32),
                                   atol=1e-5, rtol=1e-5)
    assert table and table[0]["failovers"] == tfail


def test_subprocess_replica_behind_the_router(registry, tmp_path):
    endpoint = str(tmp_path / "endpoint.json")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
         "--registry", registry.root, "--name", "sub", "--device", "cpu",
         "--max-batch", "2", "--endpoint-file", endpoint],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(endpoint):
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "replica never came up"
            time.sleep(0.05)
        with open(endpoint) as f:
            ep = json.load(f)
        assert ep["version"] == 1 and ep["pid"] == proc.pid
        router = FleetRouter([("sub", "127.0.0.1", ep["port"])],
                             label="sub_fleet", auto_poll=False,
                             request_timeout_s=30.0)
        pred = Predictor(registry.version_dir(1), place="cpu")
        try:
            for i in range(3):
                feed = _feed(2, seed=i)
                got = router.run(feed)
                want = pred.run(feed)
                np.testing.assert_allclose(
                    np.asarray(got[0], np.float32), want[0], atol=1e-6,
                    rtol=1e-6)
            router.poll_once()
            led = router.fleet_ledger()
            assert led["router"]["outcomes"]["completed"] == 3
            rep = led["replicas"][0]
            assert rep["ledger"]["requests"] == 3
        finally:
            router.close(emit=False)
    finally:
        proc.kill()
        proc.communicate(timeout=30)
