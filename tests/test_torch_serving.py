"""The PyTorch port's generation and decode engine.

- Greedy `generate()` tokens equal the JAX package's `generate()` on the
  same weights (crossed as numpy); `prefill` and `decode_step` logits are
  allclose (float32, atol = rtol = 1e-4).
- The port's `DecodeEngine` is token-exact against the port's own
  `generate()`, as the reference's engine is against its own, for
  `continuous=True` and `continuous=False`, including a request that
  joins mid-decode into a released slot.
- `submit` validation raises what the reference's engine raises.

Everything runs on the CPU, where the kernels' wrappers take the eager
compositions; the same engine on the card goes through K1, K4 and K6
(chip_smoke.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import generate as JG
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.serving import decode as jdecode

from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import generate as G
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      QueueFullError, ServingClosedError,
                                      default_prompt_buckets)
from paddle_tpu_torch.serving.stats import DecodeStats, exact_percentile
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


def _engine(model, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (8, 16))
    auto = kw.pop("auto_start", False)
    return DecodeEngine(model, config=DecodeConfig(**kw), auto_start=auto)


def _drain(eng, futs, max_steps=300):
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# generate() against the JAX package
# ---------------------------------------------------------------------------

def test_generate_greedy_matches_jax(pair):
    jm, tm = pair
    ids = np.stack(_prompts(1, (20, 20)))
    want = np.asarray(JG.generate(jm, ids, max_new_tokens=12))
    got = G.generate(tm, ids, max_new_tokens=12)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_early_exit_matches_jax(pair):
    jm, tm = pair
    ids = np.stack(_prompts(2, (9,)))
    full = G.generate(tm, ids, max_new_tokens=10).numpy()[0]
    eos = int(full[3])
    want = np.asarray(JG.generate(jm, ids, max_new_tokens=10, eos_id=eos))
    got = G.generate(tm, ids, max_new_tokens=10, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    stop = int(np.argmax(full == eos)) + 1
    assert (got[0, stop:] == eos).all()


def test_prefill_and_decode_step_logits_match_jax(pair):
    jm, tm = pair
    ids = np.stack(_prompts(3, (13, 13)))
    jp = JG.build_decode_params(jm)
    j_cache = JG.init_cache(jp.cfg, 2, 24)
    j_logits, j_cache = JG.prefill(jp, jnp.asarray(ids), j_cache)
    tp = G.build_decode_params(tm)
    t_cache = G.init_cache(tp.cfg, 2, 24, device="cpu")
    with torch.no_grad():
        t_logits = G.prefill(tp, torch.from_numpy(ids), t_cache)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(j_cache["k"]),
                               atol=1e-4, rtol=1e-4)
    token = np.array([5, 77], np.int32)
    for pos in (13, 14):
        j_logits, j_cache = JG.decode_step(jp, jnp.asarray(token), j_cache,
                                           pos)
        with torch.no_grad():
            t_logits = G.decode_step(tp, torch.from_numpy(token), t_cache,
                                     pos)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4, rtol=1e-4)
        token = np.asarray(j_logits).argmax(-1).astype(np.int32)


def test_generate_sampling_is_seeded_and_in_range(pair):
    _, tm = pair
    ids = np.stack(_prompts(4, (6, 6)))

    def draw(seed, **kw):
        return G.generate(tm, ids, 8, temperature=0.8,
                          generator=torch.Generator().manual_seed(seed),
                          **kw).numpy()

    a, b = draw(0, top_p=0.9), draw(0, top_p=0.9)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < 97
    # top_k = 1 leaves only the argmax: sampling reduces to greedy
    np.testing.assert_array_equal(draw(3, top_k=1),
                                  G.generate(tm, ids, 8).numpy())


def test_generate_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        G.generate(tm, np.zeros((1, 40), np.int32), 9)
    with pytest.raises(ValueError, match="max_new_tokens"):
        G.generate(tm, np.zeros((1, 4), np.int32), 0)
    with pytest.raises(ValueError, match=r"\[0, 97\)"):
        G.generate(tm, np.full((1, 4), 97, np.int32), 2)


# ---------------------------------------------------------------------------
# the engine against the port's own generate()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("continuous", [True, False])
def test_engine_token_exact_vs_generate(pair, continuous):
    _, tm = pair
    eng = _engine(tm, continuous=continuous)
    prompts = _prompts(5, (5, 7, 3))
    news = (9, 3, 6)
    futs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    # run until the short request frees its slot while others are live
    for _ in range(100):
        eng.step()
        if futs[1].done():
            break
    assert futs[1].done()
    if continuous:
        assert not futs[0].done()
    late = _prompts(6, (12,))[0]
    futs.append(eng.submit(late, 7))     # joins into a released slot
    _drain(eng, futs)
    for p, n, f in zip(prompts + [late], news + (7,), futs):
        ref = G.generate(tm, p[None], n).numpy()[0]
        np.testing.assert_array_equal(f.result(timeout=0), ref)
    s = eng.summary()
    assert s["outcomes"]["completed"] == 4
    assert s["requests"] == sum(s["outcomes"].values())
    # the first token of each request comes from its prefill
    assert s["decode"]["tokens_total"] == sum(news) + 7 - 4
    eng.close()


def test_engine_static_mode_waits_for_the_cohort(pair):
    _, tm = pair
    eng = _engine(tm, continuous=False, slots=2)
    futs = [eng.submit(p, n) for p, n in zip(_prompts(7, (4, 4, 4)),
                                              (2, 6, 2))]
    eng.step()
    assert eng.stats.prefill_steps == 2
    for _ in range(3):
        eng.step()
    assert futs[0].done() and not futs[1].done()
    assert eng.stats.prefill_steps == 2       # slot free, cohort not done
    _drain(eng, futs)
    assert eng.stats.prefill_steps == 3
    eng.close()


def test_engine_threaded_and_eos(pair):
    _, tm = pair
    p = _prompts(8, (6,))[0]
    full = G.generate(tm, p[None], 10).numpy()[0]
    eos = int(full[3])
    stop = int(np.argmax(full == eos)) + 1
    eng = _engine(tm, auto_start=True)
    try:
        f_eos = eng.submit(p, 10, eos_id=eos)
        f_one = eng.submit(p, 1)
        np.testing.assert_array_equal(f_eos.result(timeout=60), full[:stop])
        np.testing.assert_array_equal(f_one.result(timeout=60), full[:1])
    finally:
        eng.close()
    assert eng.prewarmed == 3                 # 2 buckets + 1 decode step
    s = eng.summary()
    assert s["outcomes"]["completed"] == 2 and s["pending"] == 0


def test_engine_sampling_reproducible_per_seed(pair):
    _, tm = pair
    p = _prompts(9, (5,))[0]
    outs = []
    for _ in range(2):
        eng = _engine(tm, prewarm=False)
        f = eng.submit(p, 6, temperature=0.9, seed=42)
        _drain(eng, [f])
        outs.append(f.result(timeout=0))
        eng.close()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].min() >= 0 and outs[0].max() < 97


# ---------------------------------------------------------------------------
# admission and lifecycle
# ---------------------------------------------------------------------------

BAD_SUBMITS = [
    ([], 4),                 # empty prompt
    ([1, 2], 0),             # no tokens requested
    (list(range(20)), 4),    # beyond the largest bucket
    ([1, 2, 3], 60),         # prompt + new > max_len
]


def test_submit_validation_matches_reference(pair):
    jm, tm = pair
    ours = _engine(tm, prewarm=False)
    theirs = jdecode.DecodeEngine(
        jm, config=jdecode.DecodeConfig(slots=3, max_len=48, buckets=(8, 16),
                                        prewarm=False, label="t_val"),
        auto_start=False)
    for prompt, n in BAD_SUBMITS:
        with pytest.raises(ValueError) as mine:
            ours.submit(prompt, n)
        with pytest.raises(ValueError) as ref:
            theirs.submit(prompt, n)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match=r"\[0, 97\)"):
        ours.submit([1, 200], 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ours.submit([1, 2], 2, token_budget_s=0.5)
    ours.close()
    theirs.close()
    with pytest.raises(ServingClosedError):
        ours.submit([1, 2], 2)
    with pytest.raises(ValueError):
        DecodeConfig(slots=0)
    with pytest.raises(ValueError, match="buckets"):
        DecodeConfig(max_len=16, buckets=(8, 32))
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(tm, max_len=64, prewarm=False)


def test_queue_full_rejected_and_close_cancels(pair):
    _, tm = pair
    eng = _engine(tm, slots=1, max_queue_depth=2, prewarm=False)
    futs = [eng.submit([1, 2, 3], 4) for _ in range(2)]
    with pytest.raises(QueueFullError):
        eng.submit([1, 2, 3], 4)
    assert eng.summary()["outcomes"]["rejected"] == 1
    eng.close()
    s = eng.summary()
    assert s["outcomes"]["cancelled"] == 2
    assert s["requests"] == sum(s["outcomes"].values()) == 3
    assert all(isinstance(f.exception(timeout=0), ServingClosedError)
               for f in futs)


def test_failed_dispatch_breaks_the_engine(pair, monkeypatch):
    _, tm = pair
    eng = _engine(tm, prewarm=False)
    f1 = eng.submit([1, 2, 3], 4)
    f2 = eng.submit([4, 5], 4)
    from paddle_tpu_torch.serving import decode as tdecode

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(tdecode, "_prefill_impl", boom)
    eng.step()
    assert isinstance(f1.exception(timeout=0), RuntimeError)
    assert isinstance(f2.exception(timeout=0), tdecode.EngineBrokenError)
    with pytest.raises(tdecode.EngineBrokenError):
        eng.submit([1], 1)
    s = eng.summary()
    assert s["outcomes"]["failed"] == 1 and s["outcomes"]["cancelled"] == 1
    assert s["requests"] == sum(s["outcomes"].values())
    eng.close()


def test_default_prompt_buckets_match_reference():
    for n in (8, 64, 100, 1024):
        assert default_prompt_buckets(n) == jdecode.default_prompt_buckets(n)


def test_decode_stats_percentiles_exact():
    st = DecodeStats("t", slots=4)
    rng = np.random.default_rng(14)
    for v in rng.uniform(0.001, 0.2, size=257):
        st.note_token_latency(float(v))
        st.note_prefill(ttft_s=float(v) * 2, now=float(v))
    d = st.decode_summary()
    toks = sorted(st.token_latency_samples())
    assert d["token_latency"]["p99_ms"] == round(
        exact_percentile(toks, 0.99) * 1e3, 3)
    ttfts = sorted(st.ttft_samples())
    assert d["ttft"]["p50_ms"] == round(
        exact_percentile(ttfts, 0.50) * 1e3, 3)
    assert d["prefill_steps"] == 257


def test_engine_concurrent_submitters(pair):
    """Submissions from several threads while the loop thread decodes:
    every request resolves, and the ledger balances."""
    _, tm = pair
    eng = _engine(tm, auto_start=True, prewarm=False)
    futs, lock = [], threading.Lock()

    def client(seed):
        for p in _prompts(seed, (3, 5, 4)):
            f = eng.submit(p, 3)
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    try:
        for f in futs:
            assert len(f.result(timeout=60)) == 3
    finally:
        eng.close()
    s = eng.summary()
    assert s["outcomes"]["completed"] == 12
    assert s["requests"] == sum(s["outcomes"].values())
