"""Continuous-batching decode serving — slot-based KV-cache engine (port
of paddle_tpu/serving/decode.py).

One engine owns the whole serving state: a fixed
`[layers, slots, heads, max_len, head_dim]` KV cache plus per-slot
`pos/active/token/stop/eos` vectors on the device (sampling
temperatures and generators stay on the host).  The reference
passes that state as donated jit state; the port updates the same
tensors in place (`_prefill_impl` and `_decode_step_impl` mutate
`state`).

- Requests join and leave mid-decode: a finished slot is released and
  refilled by the next queued request's prefill.  Prefill runs at
  bucket shapes (prompt zero-padded to the smallest bucket that holds
  it, causally masked so the padding is inert) and writes K/V straight
  into the slot's cache region.
- Every decode step runs the full slot width; inactive slots compute
  harmless garbage whose writes land, clamped, inside their own slot's
  region (a position is only attended on or after the step that writes
  it, and a refilling prefill overwrites the prompt region).
- Decode attention is the same `decode_attention` that `generate()`
  calls (K6 on the card when max_len % 128 == 0), and prefill
  attention is K1 on the card when the bucket is a multiple of 128.

`continuous=False` turns the same engine into the pad-to-bucket
baseline: admit a cohort, decode until every member finishes, only then
admit again.

The hardening is the reference's: per-TOKEN deadline budgets (the first
token included, so TTFT counts queue wait) swept from the engine loop
and the watchdog's poll, a kill mask that retires an expired
slot-resident request at the next step, every prefill and decode step
dispatched under the hang watchdog, jittered retry and the circuit
breaker, fault points (`decode.step`), flight-recorder events, and a
span tree per request with FLAGS_request_tracing on.  Each dispatch runs
on the engine's dispatch worker thread (`watchdog.DispatchWorker`),
which enters `torch.inference_mode` and the card's device itself (both
are per thread) and copies the results to the host before it returns.
A stalled or failed call may still be writing the cache in place, so
the engine marks itself broken and drains every open request, as the
reference's does.
"""

import threading
import time
from collections import deque

import numpy as np
import torch

from .. import flags
from ..kernels.attention import decode_attention
from ..models import generate as G
from ..nn import functional as F
from ..resilience import faultinject
from ..resilience.breaker import CircuitBreaker
from ..resilience.retry import RetryPolicy, call_with_retry
from ..resilience.taxonomy import DeadlineExceeded
from .runtime import QueueFullError, ServingClosedError, ServingFuture
from .stats import DecodeStats
from .watchdog import (WAIT_POLL_S, DispatchWorker, HangWatchdog,
                       WatchdogStall)

__all__ = ["DecodeEngine", "DecodeConfig", "EngineBrokenError",
           "default_prompt_buckets", "QueueFullError",
           "ServingClosedError", "WatchdogStall", "DeadlineExceeded"]

_DEFAULT_RETRY = object()


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


def _mon():
    from .. import monitor

    return monitor


def _tracing():
    from ..monitor import tracing

    return tracing


def default_prompt_buckets(max_len):
    """Power-of-two prompt buckets 16..max_len."""
    out = []
    b = 16
    while b <= max_len:
        out.append(b)
        b *= 2
    return tuple(out) or (int(max_len),)


class DecodeConfig:
    """Knobs for one decode engine; flag-backed defaults."""

    def __init__(self, slots=None, max_len=None, buckets=None,
                 max_queue_depth=None, default_token_budget_s=None,
                 retry_policy=_DEFAULT_RETRY, breaker_threshold=5,
                 breaker_cooldown_s=5.0, watchdog_stall_s=None,
                 watchdog_poll_s=None, continuous=True, prewarm=True,
                 label="decode", clock=time.monotonic):
        self.slots = int(slots if slots is not None
                         else flags.flag("decode_slots"))
        self.max_len = int(max_len if max_len is not None
                           else flags.flag("decode_max_len"))
        if self.slots < 1 or self.max_len < 2:
            raise ValueError("need slots >= 1 and max_len >= 2")
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets
                             or default_prompt_buckets(self.max_len)))))
        if any(b < 1 or b > self.max_len for b in self.buckets):
            raise ValueError(
                f"buckets {self.buckets} must lie in [1, max_len="
                f"{self.max_len}]")
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else flags.flag("serving_queue_depth"))
        if default_token_budget_s is None:
            default_token_budget_s = \
                flags.flag("decode_token_budget_s") or None
        self.default_token_budget_s = default_token_budget_s
        if retry_policy is _DEFAULT_RETRY:
            retry_policy = RetryPolicy(max_retries=2, base_delay=0.02,
                                       max_delay=0.5, seed=0)
        self.retry_policy = retry_policy          # None disables retry
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.watchdog_stall_s = float(
            watchdog_stall_s if watchdog_stall_s is not None
            else flags.flag("serving_watchdog_stall_s"))
        self.watchdog_poll_s = watchdog_poll_s
        self.continuous = bool(continuous)
        self.prewarm = bool(prewarm)
        self.label = label
        self.clock = clock


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "temperature", "seed",
                 "token_budget_s", "rid", "future", "tokens", "enqueue_t",
                 "last_token_t", "bucket", "kill", "trace", "qspan",
                 "dspan")

    def __init__(self, prompt, max_new, eos_id, temperature, seed,
                 token_budget_s, rid, bucket):
        self.prompt = prompt              # np.int32 [len]
        self.max_new = max_new
        self.eos_id = eos_id              # int or None
        self.temperature = temperature
        self.seed = seed
        self.token_budget_s = token_budget_s
        self.rid = rid
        self.bucket = bucket
        self.future = ServingFuture()
        self.tokens = []
        self.enqueue_t = None
        self.last_token_t = None          # engine clock of newest token
        self.kill = False                 # expired while slot-resident
        # request-scoped trace context (monitor/tracing.py); None when
        # FLAGS_request_tracing is off
        self.trace = None
        self.qspan = None                 # queue-wait span
        self.dspan = None                 # slot-resident decode span

    def next_deadline(self):
        """Per-token budget: the NEXT token (the first included — TTFT
        counts queue wait) must land within budget of the previous."""
        if self.token_budget_s is None:
            return None
        anchor = self.last_token_t if self.last_token_t is not None \
            else self.enqueue_t
        return anchor + self.token_budget_s

    def expired(self, now):
        d = self.next_deadline()
        return d is not None and now >= d


class EngineBrokenError(RuntimeError):
    """The engine lost its device state (a wedged or failed step) and
    cannot continue; submit() fails fast."""


# ---------------------------------------------------------------------------
# device steps (in place on `state`)
# ---------------------------------------------------------------------------

def _fresh_state(dec, slots, max_len, device):
    cache = G.init_cache(dec, slots, max_len, device=device)
    i32 = {"dtype": torch.int32, "device": device}
    return {
        "k": cache["k"],
        "v": cache["v"],
        "pos": torch.zeros(slots, **i32),
        "active": torch.zeros(slots, dtype=torch.bool, device=device),
        "token": torch.zeros(slots, **i32),
        "stop": torch.zeros(slots, **i32),
        "eos": torch.full((slots,), -1, **i32),
    }


def _pick(logits, temps, generators):
    """Greedy argmax per row; rows with temperature > 0 draw from their
    own generator instead."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    for i, temp in enumerate(temps):
        if temp > 0.0:
            probs = torch.softmax(logits[i].float() / max(temp, 1e-6), -1)
            nxt[i] = torch.multinomial(probs, 1,
                                       generator=generators[i])[0]
    return nxt


def _decode_step_impl(state, params, temps, generators, kill=None):
    """One full-width decode step over every slot; returns (tokens,
    was_active, still_active) and advances `state` in place.  `kill`
    (bool [slots]) retires host-killed (budget-expired) slots: they
    flow through the math like inactive ones and leave inactive."""
    cfg = params.cfg
    max_len = state["k"].shape[3]
    scale = 1.0 / (cfg.hidden_size // cfg.num_heads) ** 0.5
    active = state["active"]
    if kill is not None:
        active = active & ~kill
    pos, tok = state["pos"], state["token"]
    x = params.emb["wte.weight"][tok.long()][:, None, :] \
        + params.emb["wpe.weight"][pos.long()][:, None, :]
    posw = pos.clamp(max=max_len - 1).long()
    sl = torch.arange(pos.shape[0], device=pos.device)
    for layer, bp in enumerate(params.blocks):
        hn = F.layer_norm(x, [cfg.hidden_size], bp["norm1.weight"],
                          bp["norm1.bias"])
        q, k, v = G._qkv(hn, bp, cfg.num_heads)      # [S, H, 1, D]
        k_cache, v_cache = state["k"][layer], state["v"][layer]
        k_cache[sl, :, posw] = k[:, :, 0]
        v_cache[sl, :, posw] = v[:, :, 0]
        # per-slot ragged positions through the same single-query
        # attention generate() decodes with
        o = decode_attention(q, k_cache, v_cache, pos=pos, scale=scale)
        x = G._block_tail(x, G._merge_heads(o), bp, cfg, decode=True)
    logits = G._head(params, x)
    nxt = _pick(logits, temps, generators)
    new_pos = pos + 1
    done = ((state["eos"] >= 0) & (nxt == state["eos"])) \
        | (new_pos >= state["stop"])
    still = active & ~done
    state["pos"] = torch.where(active, new_pos, pos)
    state["token"] = torch.where(active, nxt, tok)
    state["active"] = still
    return nxt, active, still


def _prefill_impl(state, params, prompt, true_len, slot, temp, generator):
    """Prefill one request into one slot at its bucket shape; returns
    the first token (int).  `prompt` is [1, bucket], zero-padded."""
    cfg = params.cfg
    bucket = prompt.shape[1]

    def write(layer, k, v):
        state["k"][layer, slot, :, :bucket] = k[0]
        state["v"][layer, slot, :, :bucket] = v[0]

    # MoE routes drop-free (decode=True), so pad tokens at the bucket
    # shape cannot displace real ones
    x = G._prefill_layers(params, prompt, write, decode=True)
    # logits at the true last prompt position (LayerNorm is per
    # position, so slicing before the head matches generate())
    logits = G._head(params, x[:, true_len - 1:true_len])
    return int(_pick(logits, [temp], [generator])[0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """See module docstring.  `auto_start=False` keeps the loop thread
    off so tests drive scheduling deterministically via `step()`."""

    def __init__(self, model_or_params, config=None, auto_start=True,
                 **kw):
        if config is not None and kw:
            raise TypeError("pass either config= or keyword knobs, "
                            "not both")
        self.config = cfg = config or DecodeConfig(**kw)
        params = (model_or_params
                  if isinstance(model_or_params, G.DecodeParams)
                  else G.build_decode_params(model_or_params))
        self.params = params
        if cfg.max_len > params.cfg.max_seq_len:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's "
                f"max_seq_len {params.cfg.max_seq_len}")
        self.device = G.params_device(params)
        self.stats = DecodeStats(cfg.label, slots=cfg.slots)
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s, clock=cfg.clock,
            name=cfg.label)
        self.stats.attach_breaker(self.breaker)
        self.watchdog = HangWatchdog(
            cfg.watchdog_stall_s, poll_s=cfg.watchdog_poll_s,
            clock=cfg.clock, stats=self.stats, label=cfg.label,
            pre_dump=self.emit_telemetry, on_poll=self.sweep_expired)
        self._worker = DispatchWorker(cfg.label)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queue = deque()
        self._slot_req = [None] * cfg.slots
        self._temps = [0.0] * cfg.slots
        self._gens = [None] * cfg.slots
        self._live = set()
        self._rid = 0
        self._closed = False
        self._broken = False
        self._loop_thread = None
        self._state = _fresh_state(params.cfg, cfg.slots, cfg.max_len,
                                   self.device)
        self.prewarmed = self._prewarm() if cfg.prewarm else 0
        if auto_start:
            self.start()

    def _prewarm(self):
        """Run every program shape this engine will use (one prefill per
        bucket, one decode step) against throwaway state, so the kernels
        are built and compiled before the first request; then start from
        an empty cache."""
        cfg = self.config
        with torch.inference_mode():
            for b in cfg.buckets:
                _prefill_impl(self._state, self.params,
                              torch.zeros((1, b), dtype=torch.int32,
                                          device=self.device),
                              1, 0, 0.0, None)
            _decode_step_impl(self._state, self.params, self._temps,
                              self._gens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._state = _fresh_state(self.params.cfg, cfg.slots, cfg.max_len,
                                   self.device)
        return len(cfg.buckets) + 1

    # -- lifecycle ------------------------------------------------------
    def start(self):
        with self._lock:
            if self._loop_thread is not None or self._closed:
                return
            self._loop_thread = threading.Thread(
                target=self._loop, name=f"{self.config.label}-engine",
                daemon=True)
            self._loop_thread.start()
        self.watchdog.start()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._loop_thread
        if t is not None:
            t.join(timeout=10.0)
        err = ServingClosedError("decode engine closed")
        with self._lock:
            leftovers = list(self._live)
            self._queue.clear()
            self._slot_req = [None] * self.config.slots
        for req in leftovers:
            self._resolve_error(req, err, "cancelled")
        self.watchdog.stop()
        self._worker.abandon()
        self.emit_telemetry()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission -----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, eos_id=None,
               temperature=0.0, token_budget_s=None, seed=None,
               traceparent=None):
        """Enqueue one generation request; returns a ServingFuture that
        resolves to the np.int32 token array (length max_new_tokens, or
        shorter if eos_id fires).  `token_budget_s` bounds the wait for
        each token (the first included); `traceparent` optionally joins
        an external W3C trace when FLAGS_request_tracing is on."""
        cfg = self.config
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new > cfg.max_len:
            raise ValueError(
                f"prompt+new = {prompt.size + max_new} exceeds the "
                f"engine's max_len {cfg.max_len}")
        bucket = next((b for b in cfg.buckets if b >= prompt.size), None)
        if bucket is None:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest "
                f"prefill bucket {cfg.buckets[-1]}")
        G.check_token_ids(prompt, self.params.emb["wte.weight"].shape[0])
        if token_budget_s is None:
            token_budget_s = cfg.default_token_budget_s
        with self._lock:
            if self._closed:
                raise ServingClosedError("decode engine is closed")
            if self._broken:
                raise EngineBrokenError(
                    "decode engine lost its device state (stalled or "
                    "failed step); build a fresh engine")
            # started after the closed/broken gates (those raise without
            # a ledger outcome, so no tree must exist for them) but
            # before the queue-full gate (rejected IS a ledger outcome)
            trace = _tracing().get().start_request(
                f"decode.request/{cfg.label}", label=cfg.label,
                traceparent=traceparent,
                attrs={"prompt_len": int(prompt.size),
                       "max_new": max_new})
            if len(self._queue) >= cfg.max_queue_depth:
                self.stats.note_outcome("rejected")
                if trace is not None:
                    trace.annotate(trace.root, "rejected: queue full",
                                   depth=len(self._queue))
                    trace.finish("rejected")
                raise QueueFullError(
                    f"decode queue at depth {cfg.max_queue_depth}")
            self._rid += 1
            rid = self._rid
            req = _DecodeRequest(prompt, max_new, eos_id,
                                 float(temperature),
                                 seed if seed is not None else rid,
                                 token_budget_s, rid, bucket)
            req.enqueue_t = cfg.clock()
            if trace is not None:
                trace.rid = rid
                req.trace = trace
                req.qspan = trace.child("queue", "queue")
            self._queue.append(req)
            self._live.add(req)
            self.stats.note_admitted(len(self._queue))
            self._cond.notify_all()
        return req.future

    # -- budget sweep (watchdog poll + loop tick) ----------------------
    def sweep_expired(self):
        """Shed queued requests and expire slot-resident ones whose
        per-token budget has passed — runs on the watchdog thread too,
        so budget expiry keeps resolving even while the engine thread
        is wedged inside a stalled step."""
        now = self.config.clock()
        shed, expired = [], []
        with self._lock:
            keep = deque()
            for req in self._queue:
                (shed.append if req.expired(now) else keep.append)(req)
            self._queue = keep
            # slot-resident: mark for the next step's kill mask
            for req in self._slot_req:
                if req is not None and not req.kill \
                        and not req.future.done() and req.expired(now):
                    req.kill = True
                    expired.append(req)
            depth = len(self._queue)
        for req in shed:
            self._resolve_error(
                req, DeadlineExceeded(
                    f"first token budget "
                    f"({req.token_budget_s * 1e3:.1f}ms/token) expired "
                    f"in queue", budget_s=req.token_budget_s),
                "shed")
        for req in expired:
            self._resolve_error(
                req, DeadlineExceeded(
                    f"per-token budget "
                    f"({req.token_budget_s * 1e3:.1f}ms/token) expired "
                    f"after {len(req.tokens)} tokens",
                    budget_s=req.token_budget_s),
                "expired")
        if shed or expired:
            self.stats.note_queue_depth(depth)
        return len(shed) + len(expired)

    # -- resolution -----------------------------------------------------
    def _resolve_ok(self, req, now):
        if req.future._set_result(np.asarray(req.tokens, np.int32)):
            self.stats.note_outcome("completed",
                                    latency_s=now - req.enqueue_t)
            if req.trace is not None:
                req.trace.finish("completed")
        with self._lock:
            self._live.discard(req)

    def _resolve_error(self, req, exc, outcome):
        if req.future._set_exception(exc):
            self.stats.note_outcome(outcome)
            if req.trace is not None:
                req.trace.finish(outcome)
        with self._lock:
            self._live.discard(req)

    def _mark_broken(self, why):
        """The device state rode a doomed call: drain EVERY unresolved
        request — queued AND slot-resident — as cancelled, so no future
        (and no trace) stays open behind a dead engine.  Requests the
        failing dispatch already resolved (stalled/failed) are skipped
        by the idempotent resolve."""
        with self._lock:
            self._broken = True
            queued = list(self._queue)
            self._queue.clear()
            resident = [r for r in self._slot_req if r is not None]
            self._slot_req = [None] * self.config.slots
        err = EngineBrokenError(f"decode engine broken: {why}")
        for req in queued + resident:
            self._resolve_error(req, err, "cancelled")
        _fr().note_event("decode_engine_broken", severe=True,
                         label=self.config.label, reason=why)

    # -- guarded dispatch ----------------------------------------------
    def _dispatch(self, call, meta, requests):
        """Run one device call (prefill or decode step) on the dispatch
        worker under watchdog + retry + breaker, enforcing per-token
        budgets of the carried requests while it is in flight.  Returns
        the call's value, or None when the dispatch stalled or failed
        (requests resolved, engine marked broken — the in-place state
        rode the doomed call, and an abandoned call may still write
        it)."""
        cfg = self.config
        token, stalled = self.watchdog.track(meta)
        device = self.device

        def _call():
            if faultinject.is_armed():
                faultinject.check_transient()
                faultinject.stall_point("decode.step")
            # grad mode and the current device are per thread: set both
            # here, on the thread that launches
            with torch.inference_mode():
                if device.type == "cuda":
                    with torch.cuda.device(device):
                        return call()
                return call()

        def runner():
            if cfg.retry_policy is None:
                return _call()
            return call_with_retry(
                _call, cfg.retry_policy,
                on_retry=lambda *a: self.stats.note_retry())

        done, box = self._worker.submit(runner)
        try:
            while not done.wait(timeout=WAIT_POLL_S):
                self.sweep_expired()
                # requests riding THIS dispatch may not be queue- or
                # slot-resident yet (a prefill's request is in limbo
                # between the two) — enforce their budgets directly
                now = cfg.clock()
                for req in requests:
                    if not req.future.done() and req.expired(now):
                        req.kill = True
                        self._resolve_error(
                            req, DeadlineExceeded(
                                "per-token budget expired in flight",
                                budget_s=req.token_budget_s),
                            "expired")
                if stalled.is_set():
                    stall = WatchdogStall(
                        f"decode {meta.get('op')} step in flight > "
                        f"{cfg.watchdog_stall_s}s")
                    self.breaker.note_failure(stall)
                    for req in requests:
                        self._resolve_error(req, stall, "stalled")
                    self._worker.abandon()
                    self._mark_broken("watchdog_stall")
                    return None
        finally:
            self.watchdog.untrack(token)
        if "error" in box:
            e = box["error"]
            self.breaker.note_failure(e)
            _fr().note_event(
                "decode_dispatch_failed", label=cfg.label,
                error=f"{type(e).__name__}: {e}"[:200],
                **{k: v for k, v in meta.items()
                   if k not in ("request_ids", "trace_ids")})
            for req in requests:
                self._resolve_error(req, e, "failed")
            self._mark_broken("dispatch_failed")
            self.emit_telemetry()
            return None
        self.breaker.note_success()
        return box["out"]

    # -- scheduling -----------------------------------------------------
    def _free_slots_locked(self):
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit_locked(self):
        """Pick (slot, request) pairs to prefill this iteration.
        Continuous mode refills any free slot the moment the queue has
        work; static (baseline) mode only admits a fresh cohort once
        every slot is free."""
        free = self._free_slots_locked()
        if not free or not self._queue:
            return []
        if not self.config.continuous \
                and len(free) != self.config.slots:
            return []
        picks = []
        while free and self._queue:
            req = self._queue.popleft()
            if req.future.done():          # shed while queued
                continue
            picks.append((free.pop(0), req))
        self.stats.note_queue_depth(len(self._queue))
        return picks

    def step(self):
        """One engine iteration: sweep budgets, refill free slots via
        prefill, then run one full-width decode step.  Returns the
        number of device dispatches made (0 = idle)."""
        self.sweep_expired()
        with self._lock:
            if self._broken:
                return 0
            picks = self._admit_locked()
        dispatched = 0
        for idx, (slot, req) in enumerate(picks):
            if not self.breaker.allow():
                # breaker open: requeue the whole remainder and let
                # budgets shed; the cooldown probe reopens admission.
                # A requeued request keeps its SAME trace (its queue
                # span never ended); the detour is an annotation.
                with self._lock:
                    for _, r in reversed(picks[idx:]):
                        if r.trace is not None:
                            r.trace.annotate(r.trace.root,
                                             "breaker_requeue")
                        self._queue.appendleft(r)
                break
            if not self._prefill(slot, req):
                err = EngineBrokenError("decode engine broke mid-admission")
                for _, r in picks[idx + 1:]:
                    self._resolve_error(r, err, "cancelled")
                return dispatched + 1      # engine broken
            dispatched += 1
        with self._lock:
            slot_reqs = list(self._slot_req)
        want_step = any(
            r is not None and (r.kill or not r.future.done())
            for r in slot_reqs)
        if want_step and self.breaker.allow():
            self._decode_once(slot_reqs)
            dispatched += 1
        return dispatched

    def _prefill(self, slot, req):
        cfg = self.config
        true_len = req.prompt.size
        stop = true_len + req.max_new - 1   # position of the last token
        prompt = np.zeros((1, req.bucket), np.int32)
        prompt[0, :true_len] = req.prompt
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
        meta = {"op": "prefill", "bucket": req.bucket, "slot": slot,
                "rid": req.rid}
        pspan = None
        if req.trace is not None:
            meta["trace_id"] = req.trace.trace_id
            req.trace.end(req.qspan)
            pspan = req.trace.child(f"prefill/b{req.bucket}", "prefill",
                                    attrs={"bucket": req.bucket,
                                           "slot": slot})

        def call():
            s = self._state
            first = _prefill_impl(
                s, self.params, torch.from_numpy(prompt).to(self.device),
                true_len, slot, req.temperature, gen)
            eos = -1 if req.eos_id is None else int(req.eos_id)
            s["pos"][slot] = true_len
            s["token"][slot] = first
            s["stop"][slot] = stop
            s["eos"][slot] = eos
            active = true_len < stop and not (eos >= 0 and first == eos)
            s["active"][slot] = active
            return first, active

        out = self._dispatch(call, meta, [req])
        if out is None:
            return False
        first, active = out
        now = cfg.clock()
        req.last_token_t = now
        if req.trace is not None:
            req.trace.annotate(pspan, "first_token")
            req.trace.end(pspan)
        if req.future.done():              # expired mid-prefill
            self.stats.note_prefill(ttft_s=None, now=now)
            req.kill = True
            with self._lock:
                self._slot_req[slot] = req if active else None
                self._temps[slot] = req.temperature
                self._gens[slot] = gen
            return True
        self.stats.note_prefill(ttft_s=now - req.enqueue_t, now=now)
        req.tokens.append(first)
        if not active:                     # max_new == 1 or instant eos
            self._resolve_ok(req, now)
            with self._lock:
                self._slot_req[slot] = None
        else:
            if req.trace is not None:
                # slot-resident decode: one span from slot entry to the
                # last token, per-token progress as annotations
                req.dspan = req.trace.child("decode", "decode",
                                            attrs={"slot": slot})
            with self._lock:
                self._slot_req[slot] = req
                self._temps[slot] = req.temperature
                self._gens[slot] = gen
        return True

    def _decode_once(self, slot_reqs):
        cfg = self.config
        temps = [self._temps[i] if r is not None else 0.0
                 for i, r in enumerate(slot_reqs)]
        kill = np.array([r is not None and r.kill for r in slot_reqs],
                        bool)
        meta = {"op": "decode", "active": int(sum(
            r is not None and not r.kill for r in slot_reqs)),
            "request_ids": [r.rid for r in slot_reqs if r is not None]}
        tids = [r.trace.trace_id for r in slot_reqs
                if r is not None and r.trace is not None]
        if tids:
            # a wedged decode step's stall dump names every resident
            # request's trace
            meta["trace_ids"] = tids

        def call():
            nxt, was, still = _decode_step_impl(
                self._state, self.params, temps, self._gens,
                kill=torch.from_numpy(kill).to(self.device))
            # one device -> host copy for the three per-slot vectors
            host = torch.stack([nxt, was.to(torch.int32),
                                still.to(torch.int32)]).cpu().numpy()
            return host[0], host[1].astype(bool), host[2].astype(bool)

        waiting = [r for r in slot_reqs
                   if r is not None and not r.future.done()]
        out = self._dispatch(call, meta, waiting)
        if out is None:
            return False
        tokens, was_active, still = out
        now = cfg.clock()
        emitted = 0
        for i, req in enumerate(slot_reqs):
            if req is None:
                continue
            if not was_active[i]:
                # killed (budget-expired) or raced to done: release
                with self._lock:
                    if self._slot_req[i] is req:
                        self._slot_req[i] = None
                continue
            if not req.future.done():
                req.tokens.append(int(tokens[i]))
                if req.last_token_t is not None:
                    self.stats.note_token_latency(now - req.last_token_t)
                req.last_token_t = now
                emitted += 1
                if req.trace is not None:
                    req.trace.annotate(req.dspan, "token",
                                       n=len(req.tokens))
                if not still[i]:
                    if req.trace is not None:
                        req.trace.end(req.dspan)
                    self._resolve_ok(req, now)
            if not still[i]:
                with self._lock:
                    if self._slot_req[i] is req:
                        self._slot_req[i] = None
        self.stats.note_decode_step(int(was_active.sum()), emitted, now=now)
        if self.stats.decode_steps % 64 == 0:
            self.emit_telemetry()
        return True

    def _loop(self):
        while True:
            with self._cond:
                while not self._closed and not self._queue \
                        and not any(r is not None for r in self._slot_req):
                    self._cond.wait(0.02)
                if self._closed or self._broken:
                    return
            try:
                did = self.step()
            except Exception as e:  # noqa: BLE001 - keep no future open
                _fr().note_event(
                    "decode_engine_error", severe=True,
                    label=self.config.label,
                    error=f"{type(e).__name__}: {e}"[:200])
                self._mark_broken("engine_loop_error")
                return
            if self._broken:
                return
            if not did:
                time.sleep(0.001)

    # -- observability --------------------------------------------------
    def emit_telemetry(self):
        """Push the freshest kind="serving" decode record onto the
        telemetry JSONL stream (no-op while telemetry is off).  With
        request tracing on, the record carries the label's
        attribution/SLO summary."""
        rec = self.stats.to_record()
        store = _tracing().get()
        if store.enabled:
            s = store.summary(self.config.label)
            if s is not None:
                rec["tracing"] = s
        return _mon().record_serving(rec)

    def summary(self):
        return self.stats.summary()
