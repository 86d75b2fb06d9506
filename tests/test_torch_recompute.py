"""Recompute on both paths of the port.

Dygraph: `make_train_step(remat="conv_outs")` (keep the conv outputs,
recompute the elementwise tail; `models/remat.py`) and `remat=True`
against the reference's `remat=False` step (the reference's own remat
parity fails, so its plain step is the target), and against the port's
`remat=False` bit for bit on the CPU; what "conv_outs" stores, counted
through `torch.autograd.graph.saved_tensors_hooks`: fewer bytes than
`remat=False`, every conv output among them.

Static: `RecomputeOptimizer` Programs byte-equal to the reference's, and
3 Executor steps within 1e-5 of the JAX Executor's and equal to the
port's run without recompute, with the checkpointed chunks run again in
the backward.

Tolerances as tests/test_torch_resnet.py: losses 1e-4, params within 5%
of their update in norm, buffers 1e-4."""

import functools

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import paddle_tpu as jfluid
from paddle_tpu import nn as jnn
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.models import train as jtrain
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import functional as jopt

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.framework import executor as texec
from paddle_tpu_torch.models import remat as R
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import static_zoo as tzoo
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401


def _ce_t(m, x, y):
    return F.cross_entropy(m(x), y)


def _ce_j(m, x, y):
    return JF.cross_entropy(m(x), y)


def _resnet(kind, device="cpu"):
    if kind == "nchw":
        return TR.ResNet(TR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                         device=device)
    m = TR.ResNet(TR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                  data_format="NHWC", fused=kind == "fused", device=device)
    return TR.set_bn_stats_sample(m, 2) if kind == "fused" else m


def _batches(n=2, side=32):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((4, 3, side, side)).astype(np.float32),
             rng.integers(0, 10, (4,)).astype(np.int32)) for _ in range(n)]


def _run_port(model, remat, batches, lr=1e-3, loss_fn=_ce_t, opt=None):
    opt = opt or topt.Momentum(lr, 0.9)
    st = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, opt, loss_fn=loss_fn, remat=remat)
    losses = []
    for b in batches:
        st, l = step(st, *[torch.from_numpy(a) for a in b])
        losses.append(l)
    return losses, st


@functools.lru_cache(maxsize=None)
def _port_plain(kind):
    """A fresh `_resnet(kind)`'s state and its plain (remat=False) run on
    `_batches()`: (state_dict, losses, TrainState), made once per layout
    for the remat runs to start from."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_FUSED_SUBSET", "")
        a = _resnet(kind)
        init = {n: t.clone() for n, t in a.state_dict().items()}
        return (init, *_run_port(a, False, _batches()))


@pytest.mark.parametrize("kind", ["nchw", "nhwc", "fused"])
@pytest.mark.parametrize("remat", ["conv_outs", True])
def test_remat_is_bitwise_the_plain_step(kind, remat, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "")
    batches = _batches()
    init, la, sa = _port_plain(kind)
    b = _resnet(kind)
    b.load_state_dict(init)
    lb, sb = _run_port(b, remat, batches)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for n in sa.params:
        assert torch.equal(sa.params[n], sb.params[n]), n
    va, vb = tree_leaves(sa.opt_state), tree_leaves(sb.opt_state)
    assert len(va) == len(vb) and all(torch.equal(x, y)
                                      for x, y in zip(va, vb))
    for n in sa.buffers:
        assert torch.equal(sa.buffers[n], sb.buffers[n]), n


def test_conv_outs_keeps_dropout_masks_bitwise():
    """A model without convs: every residual recomputes back to the params
    but the dropout draws, which are kept, so the step equals the plain
    one with the same generator."""
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    max_seq_len=16, dropout=0.2)
    a = GPT(cfg, device="cpu")
    b = GPT(cfg, device="cpu")
    b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 3, 16)).astype(np.int32)
    batches = [(i, np.roll(i, -1, 1)) for i in ids]
    la, sa = _run_port(a, False, batches, opt=topt.AdamW(1e-3),
                       loss_fn=None)
    lb, sb = _run_port(b, "conv_outs", batches, opt=topt.AdamW(1e-3),
                       loss_fn=None)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for n in sa.params:
        assert torch.equal(sa.params[n], sb.params[n]), n


# 64x64 keeps the stage-4 maps at 2x2 (over 1x1 maps a batch of 4 gives
# 4-point batch variances, and f32 noise moves the third loss by ~5e-4;
# tests/test_torch_resnet.py)
REF_BATCHES = dict(n=3, side=64)


@functools.lru_cache(maxsize=None)
def _jax_plain(kind):
    """The reference's plain step on its [1, 1, 1, 1] ResNet in `kind`'s
    layout over `_batches(**REF_BATCHES)`, made once per layout: (params
    and buffers at the start, losses, params and buffers at the end), as
    numpy."""
    jnn.seed(4)
    jm = JR.ResNet(JR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                   data_format="NCHW" if kind == "nchw" else "NHWC")
    params = {n: np.asarray(v) for n, v in jnn.param_dict(jm).items()}
    bufs = {n: np.asarray(b) for n, b in jm.named_buffers()}
    jo = jopt.Momentum(1e-3, 0.9)
    jst = jtrain.init_train_state(jm, jo)
    start = {n: np.asarray(p) for n, p in jst.params.items()}
    jstep = jtrain.make_train_step(jm, jo, loss_fn=_ce_j, jit=True)
    jl = []
    for x, y in _batches(**REF_BATCHES):
        jst, l = jstep(jst, x, y)
        jl.append(float(l))
    return (params, bufs, start, jl,
            {n: np.asarray(v) for n, v in jst.params.items()},
            {n: np.asarray(b) for n, b in jst.buffers.items()})


@pytest.mark.parametrize("kind", ["nchw", "nhwc"])
@pytest.mark.parametrize("remat", ["conv_outs", True])
def test_remat_matches_the_reference_plain_step(kind, remat):
    params, bufs, start, jl, jparams, jbufs = _jax_plain(kind)
    tm = _resnet(kind)
    interop.load_jax_param_dict(tm, params)
    interop.load_jax_buffer_dict(tm, bufs)
    tl, tst = _run_port(tm, remat, _batches(**REF_BATCHES))
    np.testing.assert_allclose([float(l) for l in tl], jl, rtol=1e-4,
                               atol=1e-4)
    for n, p in tst.params.items():
        want = jparams[n]
        moved = float(np.linalg.norm(want - start[n]))
        off = float(np.linalg.norm(p.detach().numpy() - want))
        assert off <= 5e-2 * moved + 1e-6, (n, off, moved)
    for n, b in tst.buffers.items():
        np.testing.assert_allclose(b.numpy(), jbufs[n], rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def _saved_plain(model, x, y):
    """Distinct storages (address -> bytes) autograd saves for a plain
    forward, by `saved_tensors_hooks`."""
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = _ce_t(model, x, y)
    return saved, loss


@pytest.mark.parametrize("kind", ["nchw", "nhwc"])
def test_conv_outs_saves_fewer_bytes_and_every_conv_output(kind):
    m = _resnet(kind)
    x, y = [torch.from_numpy(a) for a in _batches(1)[0]]
    plain, _ = _saved_plain(m, x, y)
    tape = R.ConvOutsTape()
    with tape.recording():
        loss = _ce_t(m, x, y)
    stats = tape.stats()
    own = {p.untyped_storage()._cdata for p in m.parameters()} \
        | {x.untyped_storage()._cdata}

    def act_bytes(d):
        return sum(v for k, v in d.items() if k not in own)

    kept = act_bytes(tape._kept)
    convs = sum(isinstance(l, type(m.stem.conv)) for l in m.modules())
    assert stats["conv_outputs"] == convs == 17
    assert stats["conv_outputs_kept"] == convs
    assert 0 < kept < 0.5 * act_bytes(plain), (kept, act_bytes(plain))
    assert stats["handles"] > 0
    loss.backward()
    assert all(p.grad is not None for p in m.parameters())


@pytest.mark.parametrize("read", ["replayed", "kept"])
def test_conv_outs_raises_on_a_tensor_changed_in_place(read):
    """A tensor the backward reads as itself, changed in place after the
    forward read it: the backward raises, as autograd does for its saved
    tensors, and does not compute on the new value.  "replayed": the
    replay of `h + 1` (for exp's saved output) would read the conv output
    after `relu_`; "kept": sin saved the conv output itself."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 4, 4, generator=g, requires_grad=True)
    w = torch.randn(3, 2, 3, 3, generator=g, requires_grad=True)
    tape = R.ConvOutsTape()
    with tape.recording():
        h = torch.nn.functional.conv2d(x, w)
        out = (h + 1).exp() if read == "replayed" else h.sin()
        h.relu_()
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        out.sum().backward()


def test_the_conv_the_dispatch_mode_sees_on_the_cpu():
    """`aten.convolution.default`, whatever backend runs it below."""
    seen = []

    class Rec(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    m = _resnet("nhwc")
    x = torch.from_numpy(_batches(1)[0][0]).requires_grad_()
    with Rec():
        m(x)
    convs = [f for f in seen if "conv" in f._schema.name]
    assert convs and all(f is torch.ops.aten.convolution.default
                         for f in convs)
    assert all(R.is_conv(f) for f in convs)


def _recompute_gpt(pkg, zoo, recompute, t=16, d=32, heads=4, vocab=128):
    """The static zoo's GPT, its Adam wrapped in RecomputeOptimizer with
    checkpoints at the embedding's and the block's outputs."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard():
        with pkg.program_guard(main, startup):
            ids = pkg.data("ids", [None, t], dtype="int64")
            targets = pkg.data("targets", [None, t, 1], dtype="int64")
            emb = L.embedding(ids, size=(vocab, d))
            x = zoo._transformer_layer(emb, d, heads, t)
            logits = L.fc(x, vocab, num_flatten_dims=2)
            loss = L.mean(L.softmax_with_cross_entropy(logits, targets))
            opt = pkg.optimizer.Adam(1e-3)
            if recompute:
                opt = pkg.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints([emb, x])
            opt.minimize(loss)
    return main, startup, loss


def test_recompute_optimizer_program_is_the_reference_bytes():
    tm, ts, _ = _recompute_gpt(fluid, tzoo, True)
    jm, js, _ = _recompute_gpt(jfluid, jzoo, True)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    assert len(tm.backward_sections[0].checkpoint_names) == 2
    back = fluid.Program.from_json(jm.to_json())
    assert back.backward_sections[0].checkpoint_names == \
        jm.backward_sections[0].checkpoint_names


def test_recompute_optimizer_steps(monkeypatch):
    rng = np.random.default_rng(0)
    feeds = [{"ids": rng.integers(0, 128, (4, 16)),
              "targets": rng.integers(0, 128, (4, 16, 1))} for _ in range(3)]
    jm, js, jl = _recompute_gpt(jfluid, jzoo, True)
    jexe, jsc = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jsc)
    start = {n: np.asarray(v) for n, v in jsc.vars.items()}
    want = [float(jexe.run(jm, feed=f, fetch_list=[jl], scope=jsc)[0])
            for f in feeds]

    calls = []
    real = texec.interpret
    monkeypatch.setattr(texec, "interpret",
                        lambda ops, env, gen: calls.append(len(ops))
                        or real(ops, env, gen))
    runs = {}
    for rec in (True, False):
        m, _, l = _recompute_gpt(fluid, tzoo, rec)
        exe = fluid.Executor(fluid.CPUPlace())
        sc = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
        calls.clear()
        got = [float(exe.run(m, feed=f, fetch_list=[l], scope=sc)[0])
               for f in feeds]
        runs[rec] = (got, interop.scope_to_numpy(sc), list(calls))
    np.testing.assert_allclose(runs[True][0], want, rtol=1e-5, atol=1e-5)
    assert runs[True][0] == runs[False][0]
    for n, v in runs[True][1].items():
        np.testing.assert_array_equal(v, runs[False][1][n], err_msg=n)
        np.testing.assert_allclose(v, np.asarray(jsc.vars[n]), rtol=1e-5,
                                   atol=2e-3 * 3 + 1e-5, err_msg=n)
    # per step: two recomputed chunks, run in the forward and again in
    # the backward, the head chunk and the update once each
    assert len(runs[True][2]) == 3 * 6 and len(runs[False][2]) == 3 * 2


def _nudged(batches):
    """The first batch's images moved up by one f32 ulp each."""
    (x, y), rest = batches[0], batches[1:]
    return [(np.nextafter(x, np.float32(np.inf)), y)] + rest


def test_ghost_batch_over_1x1_maps_is_ill_conditioned():
    """Why the fused net's card-vs-CPU test runs at 64x64.  At 32x32 the
    full-subset net's stage-4 maps are 1x1, so its 2-sample ghost batch
    norm takes a 2-point variance (a - b)^2 / 4 and divides the other
    samples by |a - b|: a one-ulp nudge of the input moves the second
    step's loss by over 1e-2 (100 times the card test's tolerance), in
    the reference (its fused program, on the CPU) as in the port, and
    the two frameworks, both right, part there too.  At 64x64 (2x2
    maps) the nudge moves it by under 1e-5."""
    import jax
    import jax.numpy as jnp

    jnn.seed(4)
    jm = JR.ResNet(JR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                   data_format="NHWC", fused=True)
    JR.set_bn_stats_sample(jm, 2)
    params = {n: np.asarray(v) for n, v in jnn.param_dict(jm).items()}
    bufs = {n: np.asarray(b) for n, b in jm.named_buffers()}
    jo = jopt.Momentum(1e-3, 0.9)
    init = jtrain.init_train_state(jm, jo)
    init = jax.tree.map(np.asarray, init)
    jstep = jtrain.make_train_step(jm, jo, loss_fn=_ce_j, jit=True)

    def ref(batches):
        st = jax.tree.map(jnp.asarray, init)
        out = []
        for x, y in batches:
            st, l = jstep(st, x, y)
            out.append(float(l))
        return out

    def port(batches):
        tm = _resnet("fused")
        interop.load_jax_param_dict(tm, params)
        interop.load_jax_buffer_dict(tm, bufs)
        return [float(l) for l in _run_port(tm, False, batches)[0]]

    rel = lambda a, b: abs(a - b) / abs(b)
    for side, low, high in ((32, 1e-2, None), (64, None, 1e-5)):
        b = _batches(side=side)
        runs = {"ref": ref(b), "ref nudged": ref(_nudged(b)),
                "port": port(b), "port nudged": port(_nudged(b))}
        print(f"{side}x{side}: " + "; ".join(f"{k} {v}"
                                             for k, v in runs.items()))
        moved = [rel(runs[f"{k} nudged"][1], runs[k][1])
                 for k in ("ref", "port")]
        if low is not None:
            assert min(moved) > low, (side, runs)
        else:
            assert max(moved) < high, (side, runs)
            assert rel(runs["port"][1], runs["ref"][1]) < high, runs


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, "conv_outs"])
def test_conv_outs_on_card_matches_cpu(remat, monkeypatch):
    """The card's fused step (K7, K8, K9) under `remat` against the CPU's
    fused remat=False step from the same weights, f32 products and convs
    on both (precision="float32": no TF32), losses 1e-4, at 64x64 (at
    32x32 the 1x1 stage-4 maps make the loss ill-conditioned, see the
    test above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7/K8/K9 on the fused path)")
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "")
    batches = _batches(side=64)
    cpu = _resnet("fused")
    card = _resnet("fused", device="cuda")
    card.load_state_dict(cpu.state_dict())
    want, _ = _run_port(cpu, False, batches)
    opt = topt.Momentum(1e-3, 0.9)
    st = ttrain.init_train_state(card, opt)
    step = ttrain.make_train_step(card, opt, loss_fn=_ce_t, remat=remat,
                                  precision="float32")
    got = []
    for x, y in batches:
        st, l = step(st, torch.from_numpy(x).cuda(),
                     torch.from_numpy(y).cuda())
        got.append(float(l))
    np.testing.assert_allclose(got, [float(l) for l in want], rtol=1e-4)


@pytest.mark.cuda
def test_conv_outs_on_card_matches_the_plain_step(monkeypatch):
    """On the card (K7, K8, K9 on the full fused program): "conv_outs"
    against the plain step of the same net, losses 1e-4 (the 64x64 net of
    the reference test above; chip_smoke.py's zoo phase holds the grads
    and updates at the ResNet check's widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7/K8/K9 on the fused path)")
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "")
    batches = [tuple(torch.from_numpy(a).cuda() for a in b)
               for b in _batches(side=64)]
    losses = {}
    for remat in (False, "conv_outs"):
        model = _resnet("fused", device="cuda")     # the same draws
        opt = topt.Momentum(1e-3, 0.9)
        st = ttrain.init_train_state(model, opt)
        step = ttrain.make_train_step(model, opt, loss_fn=_ce_t, remat=remat)
        losses[remat] = []
        for b in batches:
            st, l = step(st, *b)
            losses[remat].append(float(l))
    np.testing.assert_allclose(losses["conv_outs"], losses[False], rtol=1e-4)
