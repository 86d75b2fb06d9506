"""The port's `generate.beam_search` against the reference's on a tiny
f32 GPT with the same weights: sequences exactly, scores at 1e-5; eos
freezing, the length penalty, beam 1 against greedy `generate`, the
guards, and the tie order of the expansion (the lower index first, as
`jax.lax.top_k`).  The card's beam search (K1/K4/K6) is held against
the CPU in the cuda-marked test and in chip_smoke.py's zoo phase."""

import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import generate as JG
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import generate as G
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from torch_threads import torch_threads  # noqa: F401

CFG = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=40)


@pytest.fixture(scope="module")
def pair():
    jnn.seed(3)
    jm = JGPT(JGPTConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    return jm, tm


def _prompts(batch, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], size=(batch, seq), dtype=np.int32)


def _both(pair, prompts, beam, new, **kw):
    jm, tm = pair
    jseq, jsc = JG.beam_search(jm, prompts, beam, new, **kw)
    tseq, tsc = G.beam_search(tm, prompts, beam, new, **kw)
    return (np.asarray(jseq), np.asarray(jsc), tseq.numpy(), tsc.numpy())


@pytest.mark.parametrize("beam,new,kw", [
    (3, 6, {}),
    (4, 8, {"length_penalty": 0.6}),
    (2, 5, {"eos_id": 7}),
    (5, 7, {"eos_id": 3, "length_penalty": 1.0}),
])
def test_beam_search_matches_the_reference(pair, beam, new, kw):
    jseq, jsc, tseq, tsc = _both(pair, _prompts(2, 9), beam, new, **kw)
    assert tseq.dtype == np.int32 and tseq.shape == (2, beam, new)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    # best first
    assert (np.diff(tsc, axis=1) <= 0).all()


def test_eos_freezes_a_finished_beam(pair):
    """An eos every beam meets early: after it the beam pads with eos and
    its score stops moving (the same as the reference's)."""
    jm, tm = pair
    prompts = _prompts(1, 6, seed=4)
    seq, _ = G.beam_search(tm, prompts, 4, 10)
    eos = int(seq[0, 0, 1])          # the best beam's second token
    jseq, jsc, tseq, tsc = _both(pair, prompts, 4, 10, eos_id=eos)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    hit = tseq[0] == eos
    assert hit.any()
    for row in tseq[0]:
        at = np.flatnonzero(row == eos)
        if at.size:
            assert (row[at[0]:] == eos).all()


def test_length_penalty_divides_by_the_gnmt_factor(pair):
    _, tm = pair
    prompts = _prompts(1, 5, seed=5)
    seq0, sc0 = G.beam_search(tm, prompts, 3, 6)
    seq1, sc1 = G.beam_search(tm, prompts, 3, 6, length_penalty=2.0)
    # no eos: every beam has length 6, so the order is kept and each
    # score is divided by ((5 + 6) / 6) ** 2
    np.testing.assert_array_equal(seq0.numpy(), seq1.numpy())
    np.testing.assert_allclose(sc1.numpy(), sc0.numpy() / (11 / 6) ** 2,
                               rtol=1e-6)


def test_beam_one_is_greedy(pair):
    _, tm = pair
    prompts = _prompts(3, 7, seed=6)
    seq, _ = G.beam_search(tm, prompts, 1, 9)
    np.testing.assert_array_equal(seq[:, 0].numpy(),
                                  G.generate(tm, prompts, 9).numpy())


def test_guards(pair):
    jm, tm = pair
    prompts = _prompts(1, 4)
    for beam in (0, CFG["vocab_size"] + 1):
        with pytest.raises(ValueError, match="beam_size"):
            JG.beam_search(jm, prompts, beam, 3)
        with pytest.raises(ValueError, match="beam_size"):
            G.beam_search(tm, prompts, beam, 3)
    with pytest.raises(ValueError, match="max_seq_len"):
        G.beam_search(tm, prompts, 2, CFG["max_seq_len"])
    with pytest.raises(ValueError, match="max_new_tokens"):
        G.beam_search(tm, prompts, 2, 0)


def test_a_planted_tie_picks_the_lower_index():
    """Two tokens with equal logits: the expansion keeps the lower index
    first, as `jax.lax.top_k`, and so does the port's beam update."""
    logits = torch.full((1, 2, 11), -5.0)
    logits[0, 0, 4] = logits[0, 0, 9] = 2.0
    logp = torch.tensor([[0.0, -1e30]])
    fin = torch.zeros((1, 2), dtype=torch.bool)
    top, parent, token, _ = G._beam_update(logp, fin, logits, None)
    assert token.tolist() == [[4, 9]] and parent.tolist() == [[0, 0]]
    assert top[0, 0] == top[0, 1]
    import jax
    import jax.numpy as jnp

    total = jnp.asarray(logp.numpy())[..., None] + jax.nn.log_softmax(
        jnp.asarray(logits.numpy()), axis=-1)
    _, idx = jax.lax.top_k(total.reshape(1, 22), 2)
    assert np.asarray(idx % 11).tolist() == [[4, 9]]


@pytest.mark.cuda
def test_beam_search_on_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1, K4 and K6)")
    _, tm = pair
    card = GPT(GPTConfig(**CFG), device="cuda")
    card.load_state_dict(tm.state_dict())
    prompts = _prompts(2, 9)
    cseq, csc = G.beam_search(card, prompts, 3, 6)
    tseq, tsc = G.beam_search(tm, prompts, 3, 6)
    np.testing.assert_array_equal(cseq.cpu().numpy(), tseq.numpy())
    np.testing.assert_allclose(csc.cpu().numpy(), tsc.numpy(), rtol=1e-4)
