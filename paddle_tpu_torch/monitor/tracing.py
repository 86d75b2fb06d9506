"""Request-scoped distributed tracing for the serving tier (port of
paddle_tpu/monitor/tracing.py).

Every serving request gets a span tree: a root request span plus
child spans for each phase of its life (queue wait, dispatch attempt
k, retry backoff, stall, prefill bucket, slot-resident decode,
degraded-mode detour).  The timeline is ``time.perf_counter_ns()`` —
the same clock the profiler and the merged Chrome trace already use,
so request tracks line up with host/step tracks without skew.

Design contracts (mirroring the rest of the monitor package):

* **Gate-free when off.**  ``TraceStore.enabled`` reads
  ``FLAGS_request_tracing`` live (flight-recorder pattern); with the
  flag off ``start_request`` returns ``None`` and every serving call
  site guards on ``req.trace is not None`` — the dispatch fast path
  pays one attribute read, no flag probe, no allocation.

* **Exact attribution.**  A finished trace is decomposed over integer
  nanoseconds: the root interval is partitioned at child-span
  boundaries and every elementary interval is attributed to the
  deepest covering categorized span.  The partition is exhaustive and
  disjoint, so ``sum(components.values()) == total_ns`` is integer
  equality — and the p50/p99 rows of ``attribution_table`` are one
  ACTUAL request's own decomposition (nearest-rank, the
  ``serving/stats.py`` idiom), re-derivable from the raw spans with
  ``==``, never ``allclose``.

* **W3C trace context.**  External callers hand in a ``traceparent``
  header (``00-<32 hex>-<16 hex>-<2 hex>``); the request joins that
  trace and emits a ``traceparent()`` for anything downstream —
  that's what lets the upcoming fleet tier join one request's spans
  across replica rank streams by trace id.

* **SLO + exemplars.**  ``FLAGS_serving_slo_ms`` classifies completed
  requests; violators' FULL trees are always retained, the rest are
  head-sampled at ``FLAGS_trace_sample``.  Attribution component rows
  are recorded for every finished trace regardless of sampling.
"""

import collections
import os
import re
import threading
import time

from .. import flags

__all__ = [
    "Span",
    "RequestTrace",
    "TraceStore",
    "COMPONENTS",
    "get",
    "parse_traceparent",
    "format_traceparent",
    "components_of",
    "tree_problems",
]

# attribution categories, in display order; anything of the root
# interval not covered by a categorized span lands in "other"
COMPONENTS = ("queue", "dispatch", "retry", "stall", "prefill",
              "decode", "degraded")

_COMPONENT_ROWS_CAP = 8192   # per-label attribution rows (matches stats)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def _new_trace_id():
    return os.urandom(16).hex()


def _new_span_id():
    return os.urandom(8).hex()


def parse_traceparent(header):
    """W3C traceparent -> (trace_id, parent_span_id), or None if the
    header is malformed / version ff / all-zero ids (per spec these
    must be treated as absent, not propagated)."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id, span_id, sampled=True):
    """(trace_id, span_id) -> version-00 W3C traceparent header."""
    return "00-%s-%s-%s" % (trace_id, span_id, "01" if sampled else "00")


class Span:
    """One timed interval in a request's tree.  ``end_ns is None``
    while open; ``category`` drives attribution (None = structural
    only, e.g. the root)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "category",
                 "start_ns", "end_ns", "outcome", "attrs", "annotations",
                 "depth")

    def __init__(self, name, trace_id, parent_id, category=None,
                 start_ns=None, depth=0, attrs=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.category = category
        self.start_ns = (time.perf_counter_ns()
                         if start_ns is None else int(start_ns))
        self.end_ns = None
        self.outcome = None
        self.attrs = dict(attrs) if attrs else {}
        self.annotations = []   # [(ts_ns, text), ...]
        self.depth = depth

    def to_dict(self):
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "category": self.category,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "depth": self.depth,
        }
        if self.outcome is not None:
            d["outcome"] = self.outcome
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.annotations:
            d["annotations"] = [list(a) for a in self.annotations]
        return d


class RequestTrace:
    """The span tree of one serving request.

    Thread-safe: the serving runtime mutates a request's trace from
    the submit thread, the batch loop, AND the dispatch worker.  All
    spans share the root's trace_id; ``finish`` is idempotent and
    force-closes any still-open span at the root's end, so a finished
    trace is complete and orphan-free BY CONSTRUCTION — the property
    the outcome-ledger reconciliation tests assert."""

    def __init__(self, name, label="", trace_id=None, parent_id=None,
                 rid=None, attrs=None, store=None):
        self._lock = threading.Lock()
        self.label = label
        self.rid = rid
        self.trace_id = trace_id or _new_trace_id()
        self.root = Span(name, self.trace_id, parent_id, category=None,
                         depth=0, attrs=attrs)
        self.spans = [self.root]
        self._store = store
        self._finished = False

    # -- structure ------------------------------------------------------
    def child(self, name, category, parent=None, attrs=None,
              start_ns=None):
        """Open a child span under `parent` (default: the root)."""
        with self._lock:
            if self._finished:
                return None
            p = parent if parent is not None else self.root
            s = Span(name, self.trace_id, p.span_id, category=category,
                     start_ns=start_ns, depth=p.depth + 1, attrs=attrs)
            self.spans.append(s)
            return s

    def end(self, span, end_ns=None, outcome=None):
        """Close an open span (no-op on None / already-closed)."""
        if span is None:
            return
        with self._lock:
            if span.end_ns is None:
                span.end_ns = (time.perf_counter_ns()
                               if end_ns is None else int(end_ns))
            if outcome is not None and span.outcome is None:
                span.outcome = outcome

    def annotate(self, span, text, ts_ns=None, **fields):
        """Timestamped point annotation on a span (e.g. per-token
        decode progress).  Cheap: one tuple append under the lock."""
        if span is None:
            return
        if fields:
            text = text + " " + " ".join(
                "%s=%s" % (k, fields[k]) for k in sorted(fields))
        with self._lock:
            span.annotations.append(
                (time.perf_counter_ns() if ts_ns is None else int(ts_ns),
                 text))

    def recategorize(self, span, category):
        """Reclassify a span post-hoc (a dispatch that wedged becomes
        'stall' so attribution charges the right bucket)."""
        if span is None:
            return
        with self._lock:
            span.category = category

    @property
    def finished(self):
        return self._finished

    def traceparent(self):
        return format_traceparent(self.trace_id, self.root.span_id)

    # -- terminal -------------------------------------------------------
    def finish(self, outcome, end_ns=None):
        """Close the tree with the ledger outcome.  Idempotent — the
        first caller wins, mirroring ServingFuture's resolve contract,
        so the trace outcome multiset reconciles with the outcome
        ledger exactly.  Returns True on the first (effective) call."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
            t = time.perf_counter_ns() if end_ns is None else int(end_ns)
            if self.root.end_ns is None:
                self.root.end_ns = t
            self.root.outcome = outcome
            for s in self.spans:
                if s.end_ns is None:
                    # force-close at the root's end: no unclosed span
                    # survives a finished trace
                    s.end_ns = self.root.end_ns
                if s.end_ns > self.root.end_ns:
                    self.root.end_ns = s.end_ns
        if self._store is not None:
            self._store._on_finish(self)
        return True

    # -- export ---------------------------------------------------------
    def to_record(self):
        """kind="trace" JSONL record: the full tree + its exact
        attribution, self-contained so telemetry_report can read a
        flight dump the same way it reads the live stream."""
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        comp = components_of(self)
        total = (self.root.end_ns - self.root.start_ns
                 if self.root.end_ns is not None else None)
        return {
            "kind": "trace",
            "trace_id": self.trace_id,
            "rid": self.rid,
            "label": self.label,
            "name": self.root.name,
            "outcome": self.root.outcome,
            "start_ns": self.root.start_ns,
            "end_ns": self.root.end_ns,
            "total_ns": total,
            "components_ns": comp,
            "spans": spans,
        }


def components_of(trace_or_tree):
    """EXACT integer-ns attribution of a finished trace.

    Partition the root interval at every categorized-span boundary;
    attribute each elementary interval to the deepest covering
    categorized span (tie: latest start).  Intervals are disjoint and
    cover the root exactly, so::

        sum(result.values()) == root.end_ns - root.start_ns

    holds as INTEGER equality for every finished trace.  Accepts a
    live RequestTrace or a tree dict (the kind="trace" record shape),
    so tests and the bench row can recompute from raw spans and
    assert ``==`` against the stored rows."""
    if isinstance(trace_or_tree, RequestTrace):
        with trace_or_tree._lock:
            spans = [(s.category, s.start_ns, s.end_ns, s.depth)
                     for s in trace_or_tree.spans]
        root = trace_or_tree.root
        t0, t1 = root.start_ns, root.end_ns
    else:
        spans = [(s.get("category"), s.get("start_ns"), s.get("end_ns"),
                  s.get("depth", 0))
                 for s in trace_or_tree.get("spans", ())]
        t0 = trace_or_tree.get("start_ns")
        t1 = trace_or_tree.get("end_ns")
    comp = dict.fromkeys(COMPONENTS, 0)
    comp["other"] = 0
    if t0 is None or t1 is None or t1 <= t0:
        return comp
    clipped = []
    bounds = {t0, t1}
    for cat, a, b, depth in spans:
        if cat not in comp or a is None or b is None:
            continue
        a, b = max(a, t0), min(b, t1)
        if b > a:
            clipped.append((a, b, depth, cat))
            bounds.add(a)
            bounds.add(b)
    pts = sorted(bounds)
    for i in range(len(pts) - 1):
        lo, hi = pts[i], pts[i + 1]
        best_key, best_cat = None, None
        for a, b, depth, cat in clipped:
            if a <= lo and b >= hi:
                key = (depth, a)
                if best_key is None or key > best_key:
                    best_key, best_cat = key, cat
        if best_cat is not None:
            comp[best_cat] += hi - lo
    comp["other"] = (t1 - t0) - sum(
        comp[c] for c in COMPONENTS)
    return comp


def tree_problems(tree):
    """Structural lint of a tree dict: returns a list of problem
    strings (empty == complete + orphan-free).  Used by the bench
    chaos row and the reconciliation tests."""
    problems = []
    spans = tree.get("spans") or []
    if not spans:
        return ["empty tree"]
    ids = {s.get("span_id") for s in spans}
    roots = [s for s in spans if s.get("depth", 0) == 0]
    if len(roots) != 1:
        problems.append("expected exactly one root, got %d" % len(roots))
    for s in spans:
        sid = s.get("span_id")
        if s.get("end_ns") is None:
            problems.append("unclosed span %s (%s)" % (sid, s.get("name")))
        elif s.get("start_ns") is not None and s["end_ns"] < s["start_ns"]:
            problems.append("negative span %s" % sid)
        if s.get("depth", 0) > 0 and s.get("parent_id") not in ids:
            problems.append("orphan span %s (parent %s missing)"
                            % (sid, s.get("parent_id")))
    if tree.get("outcome") is None:
        problems.append("root has no outcome")
    comp = tree.get("components_ns")
    total = tree.get("total_ns")
    if comp is not None and total is not None:
        if sum(comp.values()) != total:
            problems.append("attribution sum %d != total %d"
                            % (sum(comp.values()), total))
    return problems


class _LabelTraces:
    """Per-serving-label trace state inside the store."""

    __slots__ = ("active", "rows", "rows_dropped", "trees",
                 "trees_dropped", "finished", "slo_eligible",
                 "violations_total")

    def __init__(self, tree_cap):
        self.active = {}                                  # trace_id -> trace
        self.rows = collections.deque(maxlen=_COMPONENT_ROWS_CAP)
        self.rows_dropped = 0
        self.trees = collections.deque(maxlen=tree_cap)
        self.trees_dropped = 0
        self.finished = 0
        self.slo_eligible = 0
        self.violations_total = 0


class TraceStore:
    """Process-wide registry of request traces, keyed by serving
    label.  Holds (a) bounded attribution-component rows for EVERY
    finished trace, (b) a bounded ring of retained FULL trees
    (violators + head-sampled), (c) cumulative SLO counters."""

    def __init__(self):
        self._enabled_override = None
        self._lock = threading.Lock()
        self._labels = {}

    @property
    def enabled(self):
        """Live view of FLAGS_request_tracing (fluid.set_flags at
        runtime works), unless pinned by assignment — the flight
        recorder's gate contract."""
        if self._enabled_override is not None:
            return self._enabled_override
        return bool(flags.flag("request_tracing"))

    @enabled.setter
    def enabled(self, value):
        self._enabled_override = bool(value)

    def clear_override(self):
        self._enabled_override = None

    def _label(self, label):
        st = self._labels.get(label)
        if st is None:
            st = _LabelTraces(max(1, int(flags.flag("trace_buffer"))))
            self._labels[label] = st
        return st

    # -- lifecycle ------------------------------------------------------
    def start_request(self, name, label="", traceparent=None, rid=None,
                      attrs=None):
        """Open a trace for one request; returns None when tracing is
        off (call sites guard every later touch on that None)."""
        if not self.enabled:
            return None
        tid = pid = None
        if traceparent is not None:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                tid, pid = parsed
        tr = RequestTrace(name, label=label, trace_id=tid, parent_id=pid,
                          rid=rid, attrs=attrs, store=self)
        with self._lock:
            self._label(label).active[tr.trace_id] = tr
        return tr

    @staticmethod
    def _head_keep(n, rate):
        """Deterministic head sampling: keep the n-th finished trace
        (1-based) iff it crosses the next integer multiple of `rate`.
        rate=1 keeps all, rate=0 keeps none."""
        r = min(1.0, max(0.0, float(rate)))
        return int(n * r) > int((n - 1) * r)

    def _on_finish(self, trace):
        root = trace.root
        total_ns = root.end_ns - root.start_ns
        comp = components_of(trace)
        slo_ms = float(flags.flag("serving_slo_ms"))
        violation = (slo_ms > 0.0 and root.outcome == "completed"
                     and total_ns > int(slo_ms * 1e6))
        row = {
            "trace_id": trace.trace_id,
            "rid": trace.rid,
            "outcome": root.outcome,
            "total_ns": total_ns,
            "components_ns": comp,
            "violation": violation,
        }
        tree = None
        with self._lock:
            st = self._label(trace.label)
            st.active.pop(trace.trace_id, None)
            st.finished += 1
            if slo_ms > 0.0 and root.outcome == "completed":
                st.slo_eligible += 1
                if violation:
                    st.violations_total += 1
            if len(st.rows) == st.rows.maxlen:
                st.rows_dropped += 1
            st.rows.append(row)
            keep = violation or self._head_keep(
                st.finished, flags.flag("trace_sample"))
            if keep:
                tree = trace.to_record()
                if violation:
                    tree["violation"] = True
                    tree["slo_ms"] = slo_ms
                if len(st.trees) == st.trees.maxlen:
                    st.trees_dropped += 1
                st.trees.append(tree)
        if tree is not None:
            _mon().record_trace(tree)

    # -- readout --------------------------------------------------------
    def labels(self):
        with self._lock:
            return sorted(self._labels)

    def active_traces(self, label=None):
        """trace ids of still-open requests (what a stall dump names)."""
        with self._lock:
            if label is not None:
                st = self._labels.get(label)
                return sorted(st.active) if st else []
            return {lb: sorted(st.active)
                    for lb, st in self._labels.items() if st.active}

    def component_rows(self, label=""):
        with self._lock:
            st = self._labels.get(label)
            return [dict(r) for r in st.rows] if st else []

    def retained_trees(self, label=None):
        with self._lock:
            if label is not None:
                st = self._labels.get(label)
                return list(st.trees) if st else []
            out = []
            for lb in sorted(self._labels):
                out.extend(self._labels[lb].trees)
            return out

    def attribution_table(self, label=""):
        """Tail-latency attribution: p50/p99 rows are ONE actual
        request's exact decomposition (nearest-rank over total_ns),
        so every number re-derives from that trace's raw spans with
        integer equality."""
        from ..serving.stats import exact_percentile

        with self._lock:
            st = self._labels.get(label)
            if st is None or not st.rows:
                return None
            rows = sorted(st.rows, key=lambda r: r["total_ns"])
            out = {
                "label": label,
                "count": len(rows),
                "rows_dropped": st.rows_dropped,
                "finished": st.finished,
            }
        totals = [r["total_ns"] for r in rows]
        for key, q in (("p50", 0.50), ("p99", 0.99)):
            t = exact_percentile(totals, q)
            row = rows[totals.index(t)]
            out[key] = {
                "trace_id": row["trace_id"],
                "outcome": row["outcome"],
                "total_ns": row["total_ns"],
                "total_ms": row["total_ns"] / 1e6,
                "components_ns": dict(row["components_ns"]),
                "components_ms": {k: v / 1e6
                                  for k, v in row["components_ns"].items()},
            }
        return out

    def slo_table(self, label=""):
        """SLO attainment + burn rate.  Cumulative counters feed the
        /metrics counter family; burn rate is over the bounded row
        window (violating fraction of the last <=8192 completed
        requests), the gauge."""
        slo_ms = float(flags.flag("serving_slo_ms"))
        with self._lock:
            st = self._labels.get(label)
            if st is None:
                return None
            win_rows = [r for r in st.rows if r["outcome"] == "completed"]
            win_viol = sum(1 for r in win_rows if r["violation"])
            out = {
                "label": label,
                "slo_ms": slo_ms,
                "eligible": st.slo_eligible,
                "violations_total": st.violations_total,
                "window_completed": len(win_rows),
                "window_violations": win_viol,
            }
        out["burn_rate"] = (win_viol / len(win_rows)) if win_rows else 0.0
        out["attainment"] = 1.0 - out["burn_rate"]
        return out

    def summary(self, label=""):
        """One dict per label for telemetry records / snapshots."""
        with self._lock:
            st = self._labels.get(label)
            if st is None:
                return None
            base = {
                "label": label,
                "finished": st.finished,
                "active": len(st.active),
                "rows_dropped": st.rows_dropped,
                "trees_retained": len(st.trees),
                "trees_dropped": st.trees_dropped,
            }
        attr = self.attribution_table(label)
        if attr is not None:
            base["attribution"] = attr
        slo = self.slo_table(label)
        if slo is not None and slo["slo_ms"] > 0.0:
            base["slo"] = slo
        return base

    # -- flight-recorder hooks ------------------------------------------
    def flight_lines(self):
        """Preformatted dump lines: per-label trace summary, the ids
        of still-in-flight traces (a stall dump names the wedged
        requests), and each retained tree's one-line digest."""
        lines = []
        for label in self.labels():
            s = self.summary(label)
            if s is None:
                continue
            lines.append(
                "  label=%s finished=%d active=%d retained=%d "
                "trees_dropped=%d"
                % (label, s["finished"], s["active"], s["trees_retained"],
                   s["trees_dropped"]))
            active = self.active_traces(label)
            if active:
                lines.append("    in-flight traces: %s" % ", ".join(active))
            slo = s.get("slo")
            if slo:
                lines.append(
                    "    slo=%.1fms violations=%d/%d burn_rate=%.4f"
                    % (slo["slo_ms"], slo["violations_total"],
                       slo["eligible"], slo["burn_rate"]))
            for t in self.retained_trees(label):
                comp = t.get("components_ns") or {}
                dom = max(comp, key=comp.get) if comp else "?"
                lines.append(
                    "    trace %s rid=%s outcome=%s total=%.3fms "
                    "dominant=%s spans=%d%s"
                    % (t["trace_id"], t.get("rid"), t.get("outcome"),
                       (t.get("total_ns") or 0) / 1e6, dom,
                       len(t.get("spans") or ()),
                       " VIOLATION" if t.get("violation") else ""))
        return lines

    def reset(self):
        with self._lock:
            self._labels = {}


def _mon():
    from .. import monitor

    return monitor


_store = TraceStore()


def get():
    """The process-wide TraceStore."""
    return _store
