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

Not ported yet (ROADMAP queue 1 item 9): the circuit breaker, retry, hang
watchdog, request tracing, flight recorder, fault injection and the
per-token deadline sweep.  A failed dispatch resolves its requests as
"failed" and marks the engine broken, as the reference does.
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
from .runtime import QueueFullError, ServingClosedError, ServingFuture
from .stats import DecodeStats

__all__ = ["DecodeEngine", "DecodeConfig", "EngineBrokenError",
           "default_prompt_buckets", "QueueFullError", "ServingClosedError"]


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
                 continuous=True, prewarm=True, label="decode",
                 clock=time.monotonic):
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
        if default_token_budget_s is not None:
            raise NotImplementedError(
                "per-token deadline budgets are not ported yet (ROADMAP "
                "queue 1 item 9)")
        self.continuous = bool(continuous)
        self.prewarm = bool(prewarm)
        self.label = label
        self.clock = clock


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "temperature", "seed",
                 "rid", "future", "tokens", "enqueue_t", "last_token_t",
                 "bucket")

    def __init__(self, prompt, max_new, eos_id, temperature, seed, rid,
                 bucket):
        self.prompt = prompt              # np.int32 [len]
        self.max_new = max_new
        self.eos_id = eos_id              # int or None
        self.temperature = temperature
        self.seed = seed
        self.rid = rid
        self.bucket = bucket
        self.future = ServingFuture()
        self.tokens = []
        self.enqueue_t = None
        self.last_token_t = None


class EngineBrokenError(RuntimeError):
    """The engine lost its device state (a failed step) and cannot
    continue; submit() fails fast."""


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


def _decode_step_impl(state, params, temps, generators):
    """One full-width decode step over every slot; returns (tokens,
    was_active, still_active) and advances `state` in place."""
    cfg = params.cfg
    max_len = state["k"].shape[3]
    scale = 1.0 / (cfg.hidden_size // cfg.num_heads) ** 0.5
    active = state["active"]
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- submission -----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, eos_id=None,
               temperature=0.0, token_budget_s=None, seed=None):
        """Enqueue one generation request; returns a ServingFuture that
        resolves to the np.int32 token array (length max_new_tokens, or
        shorter if eos_id fires)."""
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
        if token_budget_s is not None:
            raise NotImplementedError(
                "per-token deadline budgets are not ported yet (ROADMAP "
                "queue 1 item 9)")
        with self._lock:
            if self._closed:
                raise ServingClosedError("decode engine is closed")
            if self._broken:
                raise EngineBrokenError(
                    "decode engine lost its device state (failed step); "
                    "build a fresh engine")
            if len(self._queue) >= cfg.max_queue_depth:
                self.stats.note_outcome("rejected")
                raise QueueFullError(
                    f"decode queue at depth {cfg.max_queue_depth}")
            self._rid += 1
            rid = self._rid
            req = _DecodeRequest(prompt, max_new, eos_id,
                                 float(temperature),
                                 seed if seed is not None else rid, rid,
                                 bucket)
            req.enqueue_t = cfg.clock()
            self._queue.append(req)
            self._live.add(req)
            self.stats.note_admitted(len(self._queue))
            self._cond.notify_all()
        return req.future

    # -- resolution -----------------------------------------------------
    def _resolve_ok(self, req, now):
        if req.future._set_result(np.asarray(req.tokens, np.int32)):
            self.stats.note_outcome("completed",
                                    latency_s=now - req.enqueue_t)
        with self._lock:
            self._live.discard(req)

    def _resolve_error(self, req, exc, outcome):
        if req.future._set_exception(exc):
            self.stats.note_outcome(outcome)
        with self._lock:
            self._live.discard(req)

    def _mark_broken(self, why):
        """The device state rode a failed call: drain every unresolved
        request, queued and slot-resident, as cancelled."""
        with self._lock:
            self._broken = True
            queued = list(self._queue)
            self._queue.clear()
            resident = [r for r in self._slot_req if r is not None]
            self._slot_req = [None] * self.config.slots
        err = EngineBrokenError(f"decode engine broken: {why}")
        for req in queued + resident:
            self._resolve_error(req, err, "cancelled")

    def _dispatch(self, call, requests):
        """Run one device call; on an exception resolve the riding
        requests as failed, mark the engine broken and return None."""
        try:
            with torch.inference_mode():
                return call()
        except Exception as e:  # noqa: BLE001 - engine boundary
            for req in requests:
                self._resolve_error(req, e, "failed")
            self._mark_broken(f"dispatch_failed: {type(e).__name__}: {e}")
            return None

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
            if req.future.done():
                continue
            picks.append((free.pop(0), req))
        self.stats.note_queue_depth(len(self._queue))
        return picks

    def step(self):
        """One engine iteration: refill free slots via prefill, then run
        one full-width decode step.  Returns the number of device
        dispatches made (0 = idle)."""
        with self._lock:
            if self._broken:
                return 0
            picks = self._admit_locked()
        dispatched = 0
        for idx, (slot, req) in enumerate(picks):
            if not self._prefill(slot, req):
                err = EngineBrokenError("decode engine broke mid-admission")
                for _, r in picks[idx + 1:]:
                    self._resolve_error(r, err, "cancelled")
                return dispatched + 1
            dispatched += 1
        with self._lock:
            slot_reqs = list(self._slot_req)
        if any(r is not None and not r.future.done() for r in slot_reqs):
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

        out = self._dispatch(call, [req])
        if out is None:
            return False
        first, active = out
        now = cfg.clock()
        req.last_token_t = now
        self.stats.note_prefill(ttft_s=now - req.enqueue_t, now=now)
        req.tokens.append(first)
        with self._lock:
            if active:
                self._slot_req[slot] = req
                self._temps[slot] = req.temperature
                self._gens[slot] = gen
            else:                           # max_new == 1 or instant eos
                self._slot_req[slot] = None
        if not active:
            self._resolve_ok(req, now)
        return True

    def _decode_once(self, slot_reqs):
        cfg = self.config
        temps = [self._temps[i] if r is not None else 0.0
                 for i, r in enumerate(slot_reqs)]

        def call():
            nxt, was, still = _decode_step_impl(self._state, self.params,
                                                temps, self._gens)
            # one device -> host copy for the three per-slot vectors
            host = torch.stack([nxt, was.to(torch.int32),
                                still.to(torch.int32)]).cpu().numpy()
            return host[0], host[1].astype(bool), host[2].astype(bool)

        waiting = [r for r in slot_reqs
                   if r is not None and not r.future.done()]
        out = self._dispatch(call, waiting)
        if out is None:
            return False
        tokens, was_active, still = out
        now = cfg.clock()
        emitted = 0
        for i, req in enumerate(slot_reqs):
            if req is None:
                continue
            if not was_active[i]:
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
                if not still[i]:
                    self._resolve_ok(req, now)
            if not still[i]:
                with self._lock:
                    if self._slot_req[i] is req:
                        self._slot_req[i] = None
        self.stats.note_decode_step(int(was_active.sum()), emitted, now=now)
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
                self._mark_broken(
                    f"engine_loop_error: {type(e).__name__}: {e}")
                return
            if self._broken:
                return
            if not did:
                time.sleep(0.001)

    # -- observability --------------------------------------------------
    def summary(self):
        return self.stats.summary()
