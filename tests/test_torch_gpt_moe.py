"""GPT MoE in the port (models.gpt with num_experts > 0, its decode, and
the dp x ep sharded train step) against the JAX package's.

Weights cross from the JAX model with `interop.load_jax_param_dict` (the
MoE leaves are `blocks.i.moe.{wg,w1,w2}` in both), batches are numpy.

- loss and grads of the MoE GPT (4 experts, top-2, capacity 1.25):
  atol = rtol = 1e-4 (tests/test_torch_train.py's f32 loss rule);
- 3 AdamW steps after one JAX step, the state carried over: the train
  tests' rules (f32 loss 1e-4, params 2 lr k + 1e-5);
- decode: test_decode_serving.py's MoE setup (4 experts, capacity 8.0,
  the router scaled by 10 so that expert choices are decisive):
  `generate()` tokens exactly, the engine's tokens equal `generate()`'s,
  beam search at beam 1 is `generate()`;
- checkpoint resume: bitwise, as tests/test_gpt_moe.py's;
- the sharded step at dp = 2, ep = 2 in four gloo worker processes
  (`python tests/test_torch_gpt_moe.py <weights> <out dir>`, killed
  after 120 s, no jax in the workers), 2 SGD steps: the global loss
  against the JAX `make_sharded_train_step` on `build_mesh(dp=2, ep=2)`
  and the unsharded JAX step, and the params, at 1e-5 (SGD's update is
  lr x grad, so an ep-fold or partial expert grad shows; Adam's first
  updates, about lr x sign(grad), would hide a scale).  The same workers
  run the ring's composition at sp = 4 (tests/test_torch_ring_attention.py)
  and `DataParallelTrainStep` on the dp x ep mesh, where each dp group
  broadcasts from its own first rank: 2 SGD steps of a dense GPT against
  one process on the whole batch, at 1e-5.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import generate as TG
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=24, num_experts=4, moe_top_k=2)
LR = 1e-3
SGD_LR = 0.1


@pytest.fixture(autouse=True)
def _two_threads():
    """The tests' tensors are small: two intra-op threads, so that the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, shape=(4, 16), vocab=64):
    x = np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _jax_model(seed=0, **kw):
    from paddle_tpu import nn as jnn
    from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

    np.random.seed(seed)
    jnn.seed(seed)
    return JGPT(JGPTConfig(**{**CFG, **kw}))


def _weights(jm):
    from paddle_tpu import nn as jnn

    return {n: np.asarray(v) for n, v in jnn.param_dict(jm).items()}


def _port_model(weights, **kw):
    tm = GPT(GPTConfig(**{**CFG, **kw}), device="cpu")
    load_jax_param_dict(tm, weights)
    return tm


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_moe_gpt_has_the_references_params_and_builds_on_its_own():
    jm = _jax_model()
    tm = GPT(GPTConfig(**CFG), device="cpu")
    want = {n: tuple(v.shape) for n, v in _weights(jm).items()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert got["blocks.0.moe.w1"] == (4, 32, 128)
    assert not any(n.startswith("blocks.0.fc") for n in got)
    assert tm.cfg.moe_capacity_factor == 1.25 and tm.cfg.moe_aux_weight == 0.01


def test_moe_gpt_loss_and_grads_match_reference():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import train as jtrain

    jm = _jax_model()
    weights = _weights(jm)
    tm = _port_model(weights)
    x, y = _batch(1)

    def jloss(p):
        return jtrain._loss_with_buffers(
            jm, p, {}, jax.random.PRNGKey(0), lambda m, a, b: m.loss(a, b),
            (jnp.asarray(x), jnp.asarray(y)))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        {n: jnp.asarray(v) for n, v in weights.items()})
    names = [n for n, _ in tm.named_parameters()]
    tl = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    tg = torch.autograd.grad(tl, list(tm.parameters()))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
    aux = sum(float(b.moe.last_aux_loss) for b in tm.blocks)
    assert aux > 0
    for n, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), atol=1e-4,
                                   rtol=1e-4, err_msg=n)
    # the router learns: its grads carry the aux loss and the gates
    assert all(float(g.abs().sum()) > 0
               for n, g in zip(names, tg) if n.endswith("moe.wg"))


def test_moe_adamw_steps_match_reference():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import train as jtrain
    from paddle_tpu.optimizer import functional as jopt

    from paddle_tpu_torch.interop import train_state_from_jax

    jm = _jax_model(seed=2)
    tm = GPT(GPTConfig(**CFG), device="cpu")
    jo, to = jopt.AdamW(LR), topt.AdamW(LR)
    jstate = jtrain.init_train_state(jm, jo)
    jstep = jtrain.make_train_step(jm, jo, jit=True)
    x, y = _batch(100)
    jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tm, to,
                                  device="cpu")
    tstep = ttrain.make_train_step(tm, to)
    jl, tl = [], []
    for i in range(3):
        x, y = _batch(i)
        jstate, l = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(l))
        tstate, l = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for n, v in jstate.params.items():
        np.testing.assert_allclose(tstate.params[n].detach().numpy(),
                                   np.asarray(v), atol=2 * LR * 4 + 1e-5,
                                   rtol=0, err_msg=n)


def test_moe_gpt_trains_and_every_moe_param_moves():
    """As tests/test_gpt_moe.py: 30 steps of a shifted-copy task at lr
    3e-3 cut the loss by a fifth, and one step at 1e-2 moves every MoE
    parameter."""
    tm = GPT(GPTConfig(**CFG), device="cpu")
    opt = topt.AdamW(3e-3)
    state = ttrain.init_train_state(tm, opt)
    step = ttrain.make_train_step(tm, opt)
    x, y = (torch.from_numpy(a) for a in _batch(0, shape=(8, 16)))
    losses = [float(step(state, x, y)[1]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    tm = GPT(GPTConfig(**CFG), device="cpu")
    opt = topt.AdamW(1e-2)
    state = ttrain.init_train_state(tm, opt)
    before = {n: v.detach().clone() for n, v in state.params.items()
              if "moe." in n}
    ttrain.make_train_step(tm, opt)(state, x, y)
    for n, b in before.items():
        assert not torch.equal(state.params[n], b), f"{n} frozen"


def test_moe_checkpoint_resume_is_bitwise(tmp_path):
    """tests/test_gpt_moe.py::test_moe_checkpoint_resume: the expert-major
    [E, D, H] params round-trip through a checkpoint and training
    resumes on the same bits."""
    from paddle_tpu_torch import checkpoint as tckpt

    def fresh():
        m = GPT(GPTConfig(**CFG), device="cpu")
        return m, ttrain.init_train_state(m, topt.AdamW(LR))

    m, state = fresh()
    step = ttrain.make_train_step(m, topt.AdamW(LR))
    x, y = (torch.from_numpy(a) for a in _batch(3))
    state, _ = step(state, x, y)
    tckpt.save_checkpoint(str(tmp_path), state, 1)
    m2, tmpl = fresh()
    restored, at = tckpt.load_checkpoint(str(tmp_path), tmpl)
    assert at == 1
    for n, v in state.params.items():
        assert torch.equal(restored.params[n], v), n
    _, l1 = step(state, x, y)
    _, l2 = ttrain.make_train_step(m2, topt.AdamW(LR))(restored, x, y)
    assert torch.equal(l1, l2)
    for n, v in state.params.items():
        assert torch.equal(restored.params[n], v), n


@pytest.fixture(scope="module")
def decode_pair():
    """test_decode_serving.py's MoE model: capacity 8.0 never binds, and
    the router scaled by 10 makes the expert choices decisive."""
    kw = dict(moe_capacity_factor=8.0)
    jm = _jax_model(seed=12, **kw)
    for blk in jm.blocks:
        blk.moe.wg.set_value(np.asarray(blk.moe.wg.value) * 10.0)
    return jm, _port_model(_weights(jm), **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in lens]


def test_moe_generate_matches_reference(decode_pair):
    import jax.numpy as jnp
    from paddle_tpu.models import generate as JG

    jm, tm = decode_pair
    prompts = np.stack(_prompts(0, (6, 6, 6)))
    want = np.asarray(JG.generate(jm, jnp.asarray(prompts), 10))
    got = TG.generate(tm, torch.from_numpy(prompts), 10).numpy()
    np.testing.assert_array_equal(got, want)
    for p in _prompts(1, (3, 9)):
        want = np.asarray(JG.generate(jm, jnp.asarray(p[None]), 8))
        got = TG.generate(tm, torch.from_numpy(p[None]), 8).numpy()
        np.testing.assert_array_equal(got, want)


def test_moe_engine_and_beam_1_match_generate(decode_pair):
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    _, tm = decode_pair
    prompts = _prompts(2, (5, 8, 3))
    news = (6, 5, 7)
    eng = DecodeEngine(tm, config=DecodeConfig(slots=2, max_len=24,
                                               buckets=(8,)),
                       auto_start=False)
    futs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        eng.step()
    for p, n, f in zip(prompts, news, futs):
        want = TG.generate(tm, torch.from_numpy(p[None]), n).numpy()[0]
        np.testing.assert_array_equal(f.result(timeout=0), want)
        seqs, _ = TG.beam_search(tm, torch.from_numpy(p[None]), 1, n)
        np.testing.assert_array_equal(seqs[0, 0].numpy(), want)
    eng.close()


def test_moe_decode_routes_drop_free():
    """Prefill keeps the config's factor, decode raises it to E/k: at
    factor 0.25 a prefill cohort drops tokens, a decode cohort none."""
    from paddle_tpu_torch.distributed import moe as tmoe

    tm = GPT(GPTConfig(**{**CFG, "moe_capacity_factor": 0.25}),
             device="cpu")
    params = TG.build_decode_params(tm)
    bp, cfg = params.blocks[0], params.cfg
    assert cfg.moe_top_k == 2 and cfg.moe_capacity_factor == 0.25
    h = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    seen = []
    real = tmoe.moe_ffn

    def spy(p, x, k=2, capacity_factor=1.25, **kw):
        seen.append(capacity_factor)
        return real(p, x, k, capacity_factor, **kw)

    tmoe.moe_ffn = spy
    try:
        zero = torch.zeros(1, 6, 32)
        TG._block_tail(zero, zero, bp, cfg)
        TG._block_tail(zero, zero, bp, cfg, decode=True)
    finally:
        tmoe.moe_ffn = real
    assert seen == [0.25, 2.0]
    d, _, _ = tmoe.top_k_gating(h, bp["moe.wg"], 2, 2.0)
    assert int(d.sum()) == 12                      # every choice kept


def test_sharded_step_at_one_rank_and_what_raises():
    """dp = ep = 1 on a one-rank gloo group: the sharded step is
    make_train_step, also with zero1 and accum_steps=2 (bitwise); an
    explicit device list binds the rank to its device, one shorter than
    the mesh raises, and tp or pp beyond the world's ranks is a
    ValueError."""
    from paddle_tpu_torch.distributed import sharded as tsh
    from paddle_tpu_torch.distributed.env import destroy_parallel_env
    from paddle_tpu_torch.distributed.mesh import build_mesh

    weights = _weights(_jax_model(seed=4))
    mesh = build_mesh(dp=1, ep=1, device="cpu")
    try:
        a, b = _port_model(weights), _port_model(weights)
        step, st = tsh.make_sharded_train_step(a, topt.AdamW(LR), mesh)
        ref = ttrain.make_train_step(b, topt.AdamW(LR))
        rst = ttrain.init_train_state(b, topt.AdamW(LR))
        for i in range(2):
            x, y = tsh.shard_batch(mesh, *_batch(i))
            st, l1 = step(st, x, y)
            rst, l2 = ref(rst, x, y)
            torch.testing.assert_close(l1, l2, atol=1e-6, rtol=1e-6)
        for n, v in rst.params.items():
            torch.testing.assert_close(st.params[n], v, atol=1e-6, rtol=1e-6)
        rules = tsh.gpt_rules()
        assert rules.spec("blocks.0.moe.w1") == tsh.P("ep", None, None)
        assert rules.spec("blocks.0.moe.wg") == tsh.P()
        assert rules.spec("norm_f.weight") == tsh.P()
        for kw in ({"zero1": True}, {"accum_steps": 2}):
            a, b = _port_model(weights), _port_model(weights)
            step, st = tsh.make_sharded_train_step(a, topt.AdamW(LR), mesh,
                                                   **kw)
            acc = kw.get("accum_steps", 1)
            ref = ttrain.make_train_step(b, topt.AdamW(LR), accum_steps=acc)
            rst = ttrain.init_train_state(b, topt.AdamW(LR))
            x, y = tsh.shard_batch(mesh, *_batch(7))
            st, l1 = step(st, x, y)
            rst, l2 = ref(rst, x, y)
            assert torch.equal(l1, l2), kw
            for n, v in rst.params.items():
                assert torch.equal(st.params[n], v), (kw, n)
        assert build_mesh(dp=1, devices=["cpu"]).device == \
            torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 devices"):
            build_mesh(dp=1, tp=2, devices=["cpu"])
        for kw in ({"tp": 2}, {"pp": 2}):
            with pytest.raises(ValueError, match="mesh needs"):
                build_mesh(**kw)
    finally:
        destroy_parallel_env()


@pytest.mark.cuda
def test_moe_step_launches_the_kernels_on_the_card():
    """On the card a MoE GPT train step launches K1, K2, K3 once per
    layer and K4, K5 once per LayerNorm (2 per layer + the final one):
    the MoE layer adds no kernel launch and takes none away."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1-K5)")
    from paddle_tpu_torch.kernels import backend

    layers = 2
    m = GPT(GPTConfig(vocab_size=512, hidden_size=256, num_layers=layers,
                      num_heads=4, max_seq_len=256, num_experts=4,
                      dtype="bfloat16"))
    opt = topt.AdamW(LR)
    st = ttrain.init_train_state(m, opt)
    step = ttrain.make_train_step(m, opt)
    x, y = (torch.from_numpy(a).cuda() for a in _batch(0, (2, 256), 512))
    step(st, x, y)
    torch.cuda.synchronize()
    backend.reset_launches()
    st, loss = step(st, x, y)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    L = backend.LAUNCHES
    assert (L["flash_attention_fwd"], L["flash_attention_bwd_dq"],
            L["flash_attention_bwd_dkv"]) == (layers,) * 3
    assert (L["layer_norm_fwd"], L["layer_norm_bwd"]) == (2 * layers + 1,) * 2


# ---------------------------------------------------------------------------
# world 4: dp = 2 x ep = 2, and the ring at sp = 4
# ---------------------------------------------------------------------------

def _ring4():
    from test_torch_ring_attention import ring_cases

    # the flash branch at sp = 4 is held in one process
    # (tests/test_torch_ring_attention.py) and over ranks at sp = 2
    return ring_cases(4, flash_causal=())


def _sharded_runs(mesh, weights):
    from paddle_tpu_torch.distributed import sharded as tsh

    out = {}
    for name, opt in (("sgd", topt.SGD(SGD_LR)),):
        m = _port_model(weights)
        step, st = tsh.make_sharded_train_step(m, opt, mesh, tsh.gpt_rules())
        losses = []
        for i in range(2):
            x, y = tsh.shard_batch(mesh, *_batch(10 + i))
            st, loss = step(st, x, y)
            losses.append(float(loss))
        out[name] = (losses, {n: v.detach().numpy().copy()
                              for n, v in st.params.items()})
    return out


def _dense_gpt(seed):
    from paddle_tpu_torch.nn import make_generator

    cfg = GPTConfig(**{**CFG, "num_experts": 0})
    return GPT(cfg, device="cpu", generator=make_generator(seed))


def _dp_step_runs(mesh):
    """DataParallelTrainStep on the dp x ep mesh: every rank starts from
    its own weights (seed 20 + ep + 10 dp), the first step broadcasts
    the first dp rank's over each dp group, 2 SGD steps on a dense GPT:
    (losses, params)."""
    from paddle_tpu_torch.distributed import DataParallelTrainStep

    m = _dense_gpt(20 + mesh.axis_index("ep") + 10 * mesh.axis_index("dp"))
    step = DataParallelTrainStep(m, topt.SGD(SGD_LR),
                                 lambda mod, x, y: mod.loss(x, y), mesh)
    losses = [float(step(*(torch.from_numpy(a) for a in _batch(30 + i))))
              for i in range(2)]
    return losses, {n: p.detach().numpy().copy()
                    for n, p in m.named_parameters()}


def _worker_main(weights_file, out_dir):
    from test_torch_ring_attention import run_ring_case

    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    mesh = build_mesh(dp=2, ep=2)
    sp = build_mesh(sp=4)
    weights = pickle.loads(Path(weights_file).read_bytes())
    rank = torch.distributed.get_rank()
    out = {"coord": (mesh.axis_index("dp"), mesh.axis_index("ep")),
           "runs": _sharded_runs(mesh, weights),
           "dp_step": _dp_step_runs(mesh),
           "ring": [run_ring_case(c, sp) for c in _ring4()],
           "jax_imported": "jax" in sys.modules}
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


def _jax_runs(weights):
    """The JAX sharded step on build_mesh(dp=2, ep=2) and the unsharded
    step, 2 steps each per optimizer: (losses, params) per name."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import sharded as jsh
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.models import train as jtrain
    from paddle_tpu.nn.layers import load_param_dict
    from paddle_tpu.optimizer import functional as jopt

    mesh = build_mesh(dp=2, ep=2, devices=jax.devices()[:4])
    out = {}
    for name, mk in (("sgd", lambda: jopt.SGD(SGD_LR)),):
        res = []
        for sharded in (True, False):
            jm = _jax_model()
            load_param_dict(jm, weights)
            if sharded:
                step, st = jsh.make_sharded_train_step(jm, mk(), mesh,
                                                       jsh.gpt_rules())
            else:
                st = jtrain.init_train_state(jm, mk())
                step = jtrain.make_train_step(jm, mk(), jit=True)
            losses = []
            for i in range(2):
                x, y = (jnp.asarray(a) for a in _batch(10 + i))
                if sharded:
                    x, y = jsh.shard_batch(mesh, x, y)
                st, loss = step(st, x, y)
                losses.append(float(loss))
            res.append((losses, {n: np.asarray(v)
                                 for n, v in st.params.items()}))
        out[name] = res
    return out


def test_world_4_dp_2_ep_2_on_gloo_matches_the_jax_mesh(tmp_path):
    from test_torch_moe import start_workers
    from test_torch_ring_attention import check_rank, jax_ring

    weights = _weights(_jax_model())
    wfile = tmp_path / "weights.pkl"
    wfile.write_bytes(pickle.dumps(weights))
    wait = start_workers(__file__, 4, tmp_path, args=(str(wfile),))
    try:
        ref = _jax_runs(weights)
        rings = [jax_ring(case, 4) for case in _ring4()]
    finally:
        ranks = wait()
    for jl, jp in ref["sgd"]:                       # sharded, unsharded
        for res in ranks:
            tl, tp = res["runs"]["sgd"]
            np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
            dpi, epi = res["coord"]
            for n, want in jp.items():
                if n.endswith(("moe.w1", "moe.w2")):
                    blk = want.shape[0] // 2
                    want = want[epi * blk:(epi + 1) * blk]
                np.testing.assert_allclose(tp[n], want, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{n} rank {dpi, epi}")
    # every dp rank holds the same expert slice, every ep rank the same
    # replicated params
    by = {r["coord"]: r["runs"]["sgd"][1] for r in ranks}
    for n in by[(0, 0)]:
        np.testing.assert_array_equal(by[(0, 0)][n], by[(1, 0)][n])
        if "moe.w" not in n or n.endswith("moe.wg"):
            np.testing.assert_array_equal(by[(0, 0)][n], by[(0, 1)][n])

    # DataParallelTrainStep on the same dp x ep mesh: each dp group (one
    # per ep index e, global ranks [e, 2 + e]) broadcasts from its first
    # rank, so ep replica e trains seed 20 + e's weights on the global
    # batch, as one process does with the whole batch
    for e in range(2):
        m = _dense_gpt(20 + e)
        params = dict(m.named_parameters())
        losses = []
        for i in range(2):
            x, y = (torch.from_numpy(a) for a in _batch(30 + i))
            loss = m.loss(x, y)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p -= SGD_LR * g
            losses.append(float(loss.detach()))
        for res in ranks:
            if res["coord"][1] != e:
                continue
            tl, tp = res["dp_step"]
            np.testing.assert_allclose(tl, losses, atol=1e-5, rtol=1e-5)
            for n, p in params.items():
                np.testing.assert_allclose(tp[n], p.detach().numpy(),
                                           atol=1e-5, rtol=1e-5,
                                           err_msg=f"{n} rank {res['coord']}")

    for i, (case, want) in enumerate(zip(_ring4(), rings)):
        for r, res in enumerate(ranks):
            check_rank(res["ring"][i], want, case, 4, r)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
