"""The rest of the model zoo against the reference with copied weights:
LeNet, MLP, SE-ResNeXt (depths (1, 1, 1, 1), 32x32), BERT
(`bert_tiny_config`, with and without a mask and `masked_positions`),
Wide&Deep (its hashed ids bit for bit, ids near 2^32 too), Word2Vec and
Seq2Seq (greedy and beam decode tokens exactly).

Tolerances: forward 1e-5; the loss over 3 train steps 1e-4 (the GPT and
ResNet rows: sums in another order); params after Momentum steps within
5% of their update in norm (the ResNet row: a relu mask on a near-tie
may route one element), after AdamW steps atol 2·lr·k + 1e-5 (the GPT
row); BERT's grads, tied embedding included, 1e-5 of each grad's scale.
The reference steps run jitted.  Dropout is off (JAX's bits and torch's
never match)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import bert as JB
from paddle_tpu.models import lenet as JL
from paddle_tpu.models import mlp as JM
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import seq2seq as JS
from paddle_tpu.models import train as jtrain
from paddle_tpu.models import wide_deep as JW
from paddle_tpu.models import word2vec as JV
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import functional as jopt

from paddle_tpu_torch.interop import load_jax_buffer_dict, load_jax_param_dict
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import lenet as TL
from paddle_tpu_torch.models import mlp as TM
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import seq2seq as TS
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models import wide_deep as TW
from paddle_tpu_torch.models import word2vec as TV
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _pair(make_j, make_t, seed):
    jnn.seed(seed)
    jm = make_j()
    tm = make_t()
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    bufs = {n: np.asarray(b) for n, b in jm.named_buffers()}
    if bufs:
        load_jax_buffer_dict(tm, bufs)
    return jm, tm


def _steps(jm, tm, jloss, tloss, batches, opt, lr, adam=False):
    """3 train steps in each package from the same weights; holds the
    losses and the params (see the module docstring)."""
    jo, to = getattr(jopt, opt)(lr), getattr(topt, opt)(lr)
    jst = jtrain.init_train_state(jm, jo)
    tst = ttrain.init_train_state(tm, to)
    start = {n: np.asarray(p, np.float32) for n, p in jst.params.items()}
    jstep = jtrain.make_train_step(jm, jo, loss_fn=jloss, jit=True)
    tstep = ttrain.make_train_step(tm, to, loss_fn=tloss)
    jl, tl = [], []
    for b in batches:
        jst, l = jstep(jst, *[jnp.asarray(a) for a in b])
        jl.append(float(l))
        tst, l = tstep(tst, *[_t(a) for a in b])
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    k = len(batches)
    for n, p in tst.params.items():
        want = np.asarray(jst.params[n], np.float32)
        got = p.detach().numpy()
        if adam:
            np.testing.assert_allclose(got, want, atol=2 * lr * k + 1e-5,
                                       rtol=1e-5, err_msg=n)
        else:
            moved = float(np.linalg.norm(want - start[n]))
            off = float(np.linalg.norm(got - want))
            assert off <= 5e-2 * moved + 1e-6, (n, off, moved)
    for n, b in tst.buffers.items():
        _close(b, jst.buffers[n], 1e-4, n)
    return tl


def _ce(m, x, y, fn):
    return fn.cross_entropy(m(x), y)


def test_lenet():
    jm, tm = _pair(JL.LeNet, lambda: TL.LeNet(device="cpu"), 0)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.integers(0, 10, (4,)).astype(np.int32) for _ in range(3)]
    _close(tm(_t(xs[0])), jm(jnp.asarray(xs[0])), 1e-5)
    _steps(jm, tm, lambda m, x, y: _ce(m, x, y, JF),
           lambda m, x, y: _ce(m, x, y, F), list(zip(xs, ys)), "Momentum",
           0.01)


def test_mlp():
    jm, tm = _pair(lambda: JM.MLP(20, (16, 8), 5, act="tanh"),
                   lambda: TM.MLP(20, (16, 8), 5, act="tanh", device="cpu"),
                   1)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((6, 4, 5)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.integers(0, 5, (6,)).astype(np.int32) for _ in range(3)]
    _close(tm(_t(xs[0])), jm(jnp.asarray(xs[0])), 1e-5)
    _steps(jm, tm, lambda m, x, y: _ce(m, x, y, JF),
           lambda m, x, y: _ce(m, x, y, F), list(zip(xs, ys)), "Momentum",
           0.05)


def test_se_resnext():
    depths = (1, 1, 1, 1)
    jm, tm = _pair(lambda: JR.SEResNeXt(10, depths),
                   lambda: TR.SEResNeXt(10, depths, device="cpu"), 2)
    assert tm.blocks[1].conv1.conv._groups == 32
    assert sorted(n for n, _ in tm.named_buffers()) == sorted(
        n for n, _ in jm.named_buffers())
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.integers(0, 10, (4,)).astype(np.int32) for _ in range(3)]
    jm.eval()
    tm.eval()
    _close(tm(_t(xs[0])), jm(jnp.asarray(xs[0])), 1e-5)
    jm.train()
    tm.train()
    _steps(jm, tm, lambda m, x, y: _ce(m, x, y, JF),
           lambda m, x, y: _ce(m, x, y, F), list(zip(xs, ys)), "Momentum",
           1e-3)


BERT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _bert_pair():
    return _pair(lambda: JB.BertForPretraining(JB.bert_tiny_config(**BERT)),
                 lambda: TB.BertForPretraining(TB.bert_tiny_config(**BERT),
                                               device="cpu"), 3)


def _bert_batch(seed, b=2, s=16, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mlm = np.where(rng.random((b, s)) < 0.3, ids, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (b,)).astype(np.int32)
    tt = (np.arange(s)[None, :] >= s // 2).astype(np.int32).repeat(b, 0)
    am = np.ones((b, s), np.int32)
    am[1, s - 5:] = 0
    return ids, mlm, nsp, tt, am


def test_bert_forward_masks_and_positions():
    jm, tm = _bert_pair()
    names = {n for n, _ in tm.named_parameters()}
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in names
    assert "mlm_bias" in names and "bert.embeddings.layer_norm.weight" in names
    assert tm.transform_norm._epsilon == 1e-12
    ids, _, _, tt, am = _bert_batch(0)
    pos = np.array([[1, 4, 7], [0, 2, 15]], np.int32)
    for mask, mp in ((None, None), (am, None), (am, pos), (None, pos)):
        j = jm(jnp.asarray(ids), jnp.asarray(tt),
               None if mask is None else jnp.asarray(mask),
               None if mp is None else jnp.asarray(mp))
        t = tm(_t(ids), _t(tt), None if mask is None else _t(mask),
               None if mp is None else _t(mp))
        for a, b in zip(t, j):
            _close(a, b, 1e-5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(_t(np.zeros((1, 129), np.int32)))


def test_bert_grads_with_the_tied_embedding():
    jm, tm = _bert_pair()
    batch = _bert_batch(1)
    jparams = dict(jnn.param_dict(jm))
    jbatch = tuple(jnp.asarray(a) for a in batch)
    jg = jax.grad(lambda p: jtrain._loss_with_buffers(
        jm, p, {}, jax.random.PRNGKey(0), lambda m, *b: m.loss(*b),
        jbatch)[0])(jparams)
    tm.loss(*[_t(a) for a in batch]).backward()
    top = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for n, p in tm.named_parameters():
        want = np.asarray(jg[n])
        if n.endswith("k_proj.bias"):
            # 0 in exact arithmetic (softmax is shift-invariant per
            # query): both sides hold f32 noise only
            assert float(p.grad.abs().max()) < 1e-4 * top, n
            assert float(np.abs(want).max()) < 1e-4 * top, n
            continue
        scale = max(float(np.abs(want).max()), 1e-3)
        _close(p.grad / scale, want / scale, 1e-5, n)
    # the MLM head's use of the word table reaches its one grad: rows of
    # ids absent from the batch get a grad too
    word = tm.bert.embeddings.word_embeddings.weight.grad
    absent = np.setdiff1d(np.arange(1024), batch[0])
    assert (word[absent] != 0).any()


def test_bert_train_steps():
    jm, tm = _bert_pair()
    batches = [_bert_batch(s) for s in (2, 3, 4)]
    _steps(jm, tm, None, None, batches, "AdamW", 1e-3, adam=True)


def test_wide_deep_hashed_ids_and_steps():
    kw = dict(sparse_field_count=5, sparse_vocab_size=997, embedding_dim=4,
              dense_dim=3, hidden=(16, 8))
    jm, tm = _pair(lambda: JW.WideDeep(**kw),
                   lambda: TW.WideDeep(device="cpu", **kw), 4)
    rng = np.random.default_rng(4)
    ids = rng.integers(-2 ** 31, 2 ** 31, (64, 5), dtype=np.int64).astype(
        np.int32)
    ids[0] = [2 ** 31 - 1, -1, -2 ** 31, 2 ** 31 - 2, -2]   # 2^32 - 1 ...
    ids[1] = [0, 1, 2654435761 % 2 ** 31, 0x9E3779B9 - 2 ** 32, 7]
    np.testing.assert_array_equal(tm._hash_ids(_t(ids)).numpy(),
                                  np.asarray(jm._hash_ids(jnp.asarray(ids))))
    dense = rng.standard_normal((64, 3)).astype(np.float32)
    _close(tm(_t(ids), _t(dense)), jm(jnp.asarray(ids), jnp.asarray(dense)),
           1e-5)
    batches = [(ids[i * 16:(i + 1) * 16], dense[i * 16:(i + 1) * 16],
                rng.integers(0, 2, (16,)).astype(np.float32))
               for i in range(3)]
    _steps(jm, tm, None, None, batches, "Momentum", 0.05)


def test_word2vec():
    jm, tm = _pair(lambda: JV.Word2Vec(50, 8, 4, 16),
                   lambda: TV.Word2Vec(50, 8, 4, 16, device="cpu"), 5)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 50, (8, 4)).astype(np.int32),
                rng.integers(0, 50, (8,)).astype(np.int32))
               for _ in range(3)]
    _close(tm(_t(batches[0][0])), jm(jnp.asarray(batches[0][0])), 1e-5)
    _steps(jm, tm, None, None, batches, "Momentum", 0.1)


S2S = dict(src_vocab=40, tgt_vocab=30, hidden_size=16, embed_dim=8)


def _s2s_pair(seed=6):
    return _pair(lambda: JS.Seq2Seq(JS.Seq2SeqConfig(**S2S)),
                 lambda: TS.Seq2Seq(TS.Seq2SeqConfig(**S2S), device="cpu"),
                 seed)


def _s2s_batch(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(2, 40, (3, 7)).astype(np.int32)
    tgt = rng.integers(2, 30, (3, 6)).astype(np.int32)
    src_len = np.array([7, 4, 1], np.int32)
    tgt_len = np.array([6, 3, 5], np.int32)
    return src, tgt[:, :-1], tgt[:, 1:], src_len, tgt_len - 1


def test_seq2seq_forward_loss_and_steps():
    jm, tm = _s2s_pair()
    src, tin, tout, sl, tl = _s2s_batch(6)
    _close(tm(_t(src), _t(tin), _t(sl)),
           jm(jnp.asarray(src), jnp.asarray(tin), jnp.asarray(sl)), 1e-5)
    _close(tm.loss(_t(src), _t(tin), _t(tout), _t(sl), _t(tl)),
           jm.loss(*[jnp.asarray(a) for a in (src, tin, tout, sl, tl)]),
           1e-5)
    batches = [_s2s_batch(s) for s in (7, 8, 9)]
    _steps(jm, tm, None, None, batches, "Momentum", 0.1)


@pytest.mark.parametrize("beam,lp", [(3, 0.0), (4, 0.7)])
def test_seq2seq_decodes_match_exactly(beam, lp):
    jm, tm = _s2s_pair(seed=10)
    src, _, _, sl, _ = _s2s_batch(11)
    for length in (None, sl):
        jl = None if length is None else jnp.asarray(length)
        tl = None if length is None else _t(length)
        np.testing.assert_array_equal(
            tm.greedy_decode(_t(src), 8, tl).numpy(),
            np.asarray(jm.greedy_decode(jnp.asarray(src), 8, jl)))
        jseq, jsc = jm.beam_search_decode(jnp.asarray(src), 8, beam, jl, lp)
        tseq, tsc = tm.beam_search_decode(_t(src), 8, beam, tl, lp)
        np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
        _close(tsc, jsc, 1e-5)


def test_zoo_exports_the_reference_names():
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels

    assert set(tmodels.__all__) >= set(jmodels.__all__)
    for n in tmodels.__all__:
        assert hasattr(tmodels, n), n


@pytest.mark.cuda
def test_zoo_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (BERT on K1-K5)")
    cfg = TB.bert_tiny_config(**BERT)
    cpu = TB.BertForPretraining(cfg, device="cpu")
    card = TB.BertForPretraining(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    batch = _bert_batch(12, s=128)
    with torch.no_grad():
        lc = cpu.loss(*[_t(a) for a in batch])
        lg = card.loss(*[_t(a).cuda() for a in batch])
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
