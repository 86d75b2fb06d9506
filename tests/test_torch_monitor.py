"""The PyTorch port's monitor tier against the JAX package's.

- Counter and gauge snapshots are equal for the same operations.
- kind="serving" / "fleet_serving" JSONL records carry the same keys,
  and rotation keeps the same segments.
- A request trace tree built from the same span sequence is equal up to
  ids and clock origin, with exact attribution, and `tree_problems` is
  empty; traceparent parse and format agree.
- The flight recorder's dump reads back with the reference's sections,
  and an OOM record parses torch's "Tried to allocate" size.
- `prometheus_text` parses to the same series for the same counters and
  serving ledger, and `/metrics` and `/healthz` answer over HTTP.
"""

import gc
import json
import os
import urllib.error
import urllib.request

import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu.monitor import exporter as jexporter
from paddle_tpu.monitor import flight_recorder as jfr
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu.resilience import breaker as jbreaker
from paddle_tpu.serving import stats as jstats

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.monitor import exporter as texporter
from paddle_tpu_torch.monitor import flight_recorder as tfr
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.resilience import breaker as tbreaker
from paddle_tpu_torch.serving import stats as tstats
from torch_threads import torch_threads  # noqa: F401

PAIRS = [(jflags, jmonitor, jfr, jtracing), (tflags, tmonitor, tfr,
                                              ttracing)]


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    saved = []
    for i, (fl, mon, fr, tr) in enumerate(PAIRS):
        saved.append((fl.flag("flight_recorder_dir"),
                      fl.flag("request_tracing")))
        fl.set_flags({"flight_recorder_dir": str(tmp_path / f"fr{i}")})
        mon.disable()
        mon.reset()
        fr.get().clear()
    yield
    for (fl, mon, fr, tr), (d, rt) in zip(PAIRS, saved):
        mon.disable()
        mon.reset()
        fr.get().clear()
        tr.get().clear_override()
        fl.set_flags({"flight_recorder_dir": d, "request_tracing": rt})


def _ops(mon):
    mon.enable()
    mon.counter("serving.requests").add(3)
    mon.counter("resilience.retries").add(1)
    mon.counter("resilience.retries").add(2)
    mon.gauge("serving.queue_depth").set(4)
    mon.gauge("serving.queue_depth").set(2)
    mon.gauge("resilience.last_backoff_s").set(0.25)
    snap = mon.snapshot()
    # the registries are process-wide: earlier files' counters linger at 0
    return ({k: v for k, v in snap["counters"].items() if v},
            snap["gauges"])


def test_counter_and_gauge_snapshots_equal():
    assert _ops(tmonitor) == _ops(jmonitor)
    # handles stay valid across reset, values go to zero / unset
    c = tmonitor.counter("x")
    c.add(5)
    tmonitor.reset()
    assert c.value == 0 and tmonitor.snapshot()["counters"]["x"] == 0


def _ledger(stats_mod, breaker_mod, label):
    st = stats_mod.ServingStats(label)
    st.attach_breaker(breaker_mod.CircuitBreaker(name=label))
    for depth in (1, 2, 3):
        st.note_admitted(depth)
    st.note_outcome("completed", latency_s=0.010)
    st.note_outcome("completed", latency_s=0.030)
    st.note_outcome("shed")
    st.note_outcome("rejected")
    st.note_batch(4, 3)
    st.note_batch(None, 1, degraded=True)
    st.note_retry()
    st.note_watchdog_stall()
    st.note_cancel_retry()
    return st


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("host", "process_index", "local_device_ids",
                         "ts_us", "wall_time")}


def test_serving_records_on_jsonl_carry_the_same_keys(tmp_path):
    docs = []
    for (fl, mon, fr, tr), smod, bmod, tag in (
            (PAIRS[0], jstats, jbreaker, "j"),
            (PAIRS[1], tstats, tbreaker, "t")):
        path = str(tmp_path / f"{tag}.jsonl")
        mon.enable(jsonl_path=path)
        st = _ledger(smod, bmod, "mon_rec")
        mon.record_serving(st.to_record())
        mon.record_fleet_serving({"label": "r", "requests": 1})
        assert mon.jsonl_path() == path
        mon.disable()
        docs.append(mon.read_jsonl(path))
        assert [r["kind"] for r in docs[-1]] == ["serving",
                                                 "fleet_serving"]
        assert mon.serving_records()[0]["requests"] == 4
        del st
    ref, got = docs
    # the reference stamps local_device_ids once its backend is up
    assert set(got[0]) == set(ref[0]) - {"local_device_ids"}
    assert set(got[1]) == set(ref[1]) - {"local_device_ids"}
    # the ledger and the latency table are the same numbers
    assert _strip(got[0]) == _strip(ref[0])
    assert got[0]["requests"] == sum(got[0]["outcomes"].values())


def test_jsonl_rotation_keeps_the_same_segments(tmp_path):
    from paddle_tpu.monitor.jsonl_writer import JsonlWriter as JW
    from paddle_tpu_torch.monitor.jsonl_writer import JsonlWriter as TW
    from paddle_tpu_torch.monitor.jsonl_writer import read_jsonl

    sizes = []
    for cls, d in ((JW, tmp_path / "j"), (TW, tmp_path / "t")):
        os.makedirs(d)
        w = cls(str(d / "s.jsonl"), max_bytes=200, keep=2, rank_tag=False)
        for i in range(30):
            w.emit({"i": i, "pad": "x" * 20})
        w.close()
        sizes.append(sorted(os.listdir(d)))
        if cls is TW:
            recs = read_jsonl(str(d / "s.jsonl"))
            assert [r["i"] for r in recs] == list(range(30 - len(recs), 30))
    assert sizes[0] == sizes[1]


def _span_tree(tracing, fl):
    fl.set_flags({"request_tracing": True, "trace_sample": 1.0})
    store = tracing.get()
    store.reset()
    tr = store.start_request("serving.request/t", label="trc",
                             attrs={"rows": 2})
    t0 = tr.root.start_ns
    q = tr.child("queue", "queue", start_ns=t0 + 10)
    tr.end(q, end_ns=t0 + 110)
    d = tr.child("dispatch/b4", "dispatch", start_ns=t0 + 110,
                 attrs={"bucket": 4, "attempt": 1})
    r = tr.child("retry", "retry", parent=d, start_ns=t0 + 150)
    tr.end(r, end_ns=t0 + 190)
    tr.annotate(d, "batch_join", ts_ns=t0 + 120, bucket=4)
    tr.recategorize(d, "stall")
    tr.end(d, end_ns=t0 + 300, outcome="ok")
    tr.finish("completed", end_ns=t0 + 320)
    (tree,) = store.retained_trees("trc")
    assert tracing.tree_problems(tree) == []
    ids = {s["span_id"]: i for i, s in enumerate(tree["spans"])}
    norm = []
    for s in tree["spans"]:
        n = dict(s, span_id=ids[s["span_id"]],
                 parent_id=ids.get(s["parent_id"]),
                 start_ns=s["start_ns"] - t0, end_ns=s["end_ns"] - t0)
        if "annotations" in n:
            n["annotations"] = [[ts - t0, txt]
                                for ts, txt in n["annotations"]]
        norm.append(n)
    summary = store.summary("trc")
    return (norm, tree["components_ns"], tree["total_ns"], tree["outcome"],
            {k: summary[k] for k in ("label", "finished")
             if k in summary})


def test_trace_tree_equal_up_to_ids():
    ref = _span_tree(jtracing, jflags)
    got = _span_tree(ttracing, tflags)
    assert got == ref
    assert sum(got[1].values()) == got[2]


def test_traceparent_parse_and_format_agree():
    tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    for header in (f"00-{tid}-{sid}-01", f"00-{tid}-{sid}-00", "garbage",
                   f"00-{'0' * 32}-{sid}-01", f"00-{tid.upper()}-{sid}-01"):
        assert ttracing.parse_traceparent(header) \
            == jtracing.parse_traceparent(header), header
    assert ttracing.format_traceparent(tid, sid) \
        == jtracing.format_traceparent(tid, sid)


def _dump_sections(fr_mod, mon, smod, bmod, tracing, fl, directory):
    fl.set_flags({"request_tracing": True})
    mon.enable()
    mon.counter("resilience.retries").add(1)
    rec = fr_mod.get()
    rec.note_event("retry", attempt=0, backoff_s=0.1)
    rec.note_event("serving_stall", severe=True, label="fr",
                   request_ids=[1, 2], trace_ids=["a"])
    st = _ledger(smod, bmod, "fr_rec")
    rec.note_serving(st.to_record())
    tr = tracing.get().start_request("serving.request/fr", label="fr")
    tr.finish("stalled")
    tracing.get().start_request("serving.request/fr", label="fr")
    path = fr_mod.dump("serving_stall:fr", directory=str(directory))
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    with open(path[:-len(".jsonl")] + ".trace.json") as f:
        trace = json.load(f)
    kinds = [x["kind"] for x in lines]
    events = [x["event"] for x in lines if x["kind"] == "event"]
    meta = lines[0]
    tracing.get().reset()
    return (kinds, events, sorted(set(meta) - {"local_device_ids"}),
            meta["reason"], lines[1]["recorder"],
            {k: v for k, v in lines[1]["registry"]["counters"].items()
             if v},
            sorted({e.get("pid") for e in trace["traceEvents"]}), path)


def test_flight_dump_reads_back_with_reference_sections(tmp_path):
    ref = _dump_sections(jfr, jmonitor, jstats, jbreaker, jtracing, jflags,
                         tmp_path / "j")
    got = _dump_sections(tfr, tmonitor, tstats, tbreaker, ttracing, tflags,
                         tmp_path / "t")
    assert got[:-1] == ref[:-1]
    assert os.path.basename(got[-1]).startswith("flight_")
    assert tfr.get().last_dump == got[-1]


def test_oom_record_parses_torch_and_reference_sizes(tmp_path):
    for msg, want in (
            ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
             "total capacity of 79.10 GiB", 2 << 30),
            ("CUDA out of memory. Tried to allocate 20.00 MiB", 20 << 20),
            ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
             "123456 bytes", 123456),
            ("Attempting to allocate 1.91G", int(1.91 * (1 << 30))),
            ("no size here", None)):
        assert tfr._parse_requested_bytes(msg) == want, msg
        assert jfr._parse_requested_bytes(msg) == want, msg
    # a CPU-only process has no card stats: {} as the reference on CPU
    assert tfr._device_memory_stats() == {}
    path = tfr.dump_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
        directory=str(tmp_path))
    with open(path) as f:
        recs = [json.loads(x) for x in f]
    (oom,) = [r for r in recs if r["kind"] == "oom"]
    assert oom["requested_bytes"] == 2 << 30 and "device_memory" not in oom


def _scrape(mon, exporter, smod, bmod):
    gc.collect()            # runtimes of earlier tests leave the table
    mon.enable()
    mon.counter("resilience.retries").add(2)
    mon.counter("serving.batches").add(5)
    mon.gauge("resilience.last_backoff_s").set(0.5)
    st = _ledger(smod, bmod, "prom")
    parsed = exporter.parse_prometheus(exporter.prometheus_text())
    ok, checks = exporter.health()
    del st
    # the registries are process-wide: compare the series this scrape's
    # operations moved (unlabelled ones that are not zero, and the
    # "prom" runtime's ledger rows)
    keep = {k: v for k, v in parsed.items()
            if not k[0].startswith(("paddle_tpu_flight_",
                                    "paddle_tpu_fleet_process",
                                    "paddle_tpu_elastic"))
            and ((not k[1] and v) or ("runtime", "prom") in k[1])}
    return keep, ok, checks.get("breaker_open")


def test_prometheus_text_parses_to_the_same_series():
    ref = _scrape(jmonitor, jexporter, jstats, jbreaker)
    got = _scrape(tmonitor, texporter, tstats, tbreaker)
    assert got == ref
    series = got[0]
    assert series[("paddle_tpu_serving_requests_total",
                   (("runtime", "prom"),))] == 4.0


def test_metrics_server_serves_metrics_and_healthz():
    gc.collect()            # runtimes of earlier tests leave the table
    srv = texporter.start(port=0)
    try:
        tmonitor.enable()
        tmonitor.counter("resilience.retries").add(1)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert "paddle_tpu_resilience_retries_total 1" in body
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            assert json.loads(r.read())["ok"] is True
        st = tstats.ServingStats("wedged")
        b = tbreaker.CircuitBreaker(failure_threshold=1, name="wedged")
        st.attach_breaker(b)
        b.note_failure(RuntimeError("x"))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                   timeout=5)
        assert err.value.code == 503
        assert json.loads(err.value.read())["reason"] == "breaker_open"
        del st, b
    finally:
        texporter.stop()
    assert texporter.active() is None


def test_merged_trace_events_carry_request_tracks():
    tflags.set_flags({"request_tracing": True})
    tr = ttracing.get().start_request("serving.request/m", label="m")
    tr.end(tr.child("queue", "queue"))
    tr.finish("completed")
    tmonitor.enable()
    tmonitor.gauge("serving.queue_depth").set(1)
    events = tmonitor.merged_trace_events()
    assert any(e.get("pid") == 2 and e.get("ph") == "X" for e in events)
    assert any(e.get("ph") == "C" and e["name"] == "serving.queue_depth"
               for e in events)
    assert tmonitor.flight_dump("manual") is not None
