"""Tensor and sequence parallelism in the port (distributed.tensor_parallel,
the sharded step over tp and sp, the 3D pipeline) against the JAX
package's sharded step and pipeline on the 8-device CPU mesh.

Weights cross from the JAX model (`interop.load_jax_param_dict`), batches
are numpy.  One launch of eight gloo worker processes (`python
tests/test_torch_tensor_parallel.py <weights> <out dir>`, killed after
120 s; no jax in the workers) runs, on one world:

- the sharded step on dp 2 x tp 2 x sp 2 under `gpt_rules()`, 2 SGD steps
  (lr x grad, so a missing or doubled sum over tp or sp shows, where
  Adam's first updates would hide a scale): the global losses against
  JAX's `make_sharded_train_step` on `build_mesh(dp=2, tp=2, sp=2)` and
  the unsharded JAX step, and every rank's blocks of every param against
  the JAX step's, at atol = rtol = 1e-5;
- `build_gpt_pipeline_3d` on dp 2 x tp 2 x pp 2 and tp 4 x pp 2: the
  loss against the single-device model (which JAX's 3D pipeline on dp
  2 x tp 2 x pp 2 matches), and the grads of every stage leaf (this
  rank's tile) and of the embedding, summed over dp, against the
  single-device model's, at 1e-5.

The rest runs here: the rules' shards, the clamp and ZeRO-1's spec edge
cases against the reference's `_named` / `_zero1_spec`, and the same
step on meshes held in this process (`inprocess.local_meshes`, a thread
a rank) against the unsharded port step.  The cuda-marked test holds the
in-process tp = 2 step on the card to the unsharded step there.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import inprocess, sharded as tsh
from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
SGD_LR = 0.1
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=16, dropout=0.0)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batch(seed=0, n=4, seq=16, vocab=128):
    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, (n, seq)).astype(np.int32),
            r.integers(0, vocab, (n, seq)).astype(np.int32))


def jax_model(seed=0, **kw):
    from paddle_tpu import nn as jnn
    from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

    np.random.seed(seed)
    jnn.seed(seed)
    return JGPT(JGPTConfig(**{**CFG, **kw}))


def weights_of(jm):
    from paddle_tpu import nn as jnn

    return {n: np.asarray(v) for n, v in jnn.param_dict(jm).items()}


def port_model(weights, **kw):
    m = GPT(GPTConfig(**{**CFG, **kw}), device="cpu")
    load_jax_param_dict(m, weights)
    return m


def jax_grads(jm, x, y):
    """The single-device JAX model's loss and grads ({name: np})."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.layers import _swap_params, param_dict

    def loss(flat):
        with _swap_params(jm, flat):
            return jm.loss(jnp.asarray(x), jnp.asarray(y))

    l, g = jax.value_and_grad(loss)(param_dict(jm))
    return float(l), {n: np.asarray(v) for n, v in g.items()}


def local_of(mesh, step, name, value):
    """This rank's block of a global numpy value of param `name`."""
    return tsh.local_block(mesh, step.param_specs[name],
                           torch.from_numpy(np.asarray(value))).numpy()


# ---------------------------------------------------------------------------
# the rules, the clamp, ZeRO-1's specs (no collective)
# ---------------------------------------------------------------------------

def test_tp_rules_shard_expected_params():
    """tests/test_sharded.py::test_tp_rules_shard_expected_params: under
    gpt_rules at tp = 2 each rank holds the out-dim half of the
    column-parallel weights, the in-dim half of the row-parallel ones,
    its rows of the embeddings, and the norms whole."""
    meshes = inprocess.local_meshes(tp=2, device="cpu")
    m = GPT(GPTConfig(**CFG), device="cpu")
    params = dict(m.named_parameters())
    for r, mesh in enumerate(meshes):
        sh = tsh.shard_params(params, mesh, tsh.gpt_rules())
        assert sh["blocks.0.fc1.weight"].shape == (32, 64)
        assert sh["blocks.0.fc2.weight"].shape == (64, 32)
        assert sh["blocks.0.attn.q_proj.weight"].shape == (32, 16)
        assert sh["blocks.0.attn.q_proj.bias"].shape == (16,)
        assert sh["blocks.0.norm1.weight"].shape == (32,)
        assert sh["wte.weight"].shape == (64, 32)
        assert sh["wpe.weight"].shape == (8, 32)
        assert torch.equal(sh["blocks.0.fc1.weight"],
                           params["blocks.0.fc1.weight"][:, 64 * r:64 * r + 64])
        assert sh["blocks.0.norm1.weight"] is params["blocks.0.norm1.weight"]


def _ref_named(jmesh, spec, shape):
    from paddle_tpu.distributed.sharded import _named

    return tuple(_named(jmesh, spec, np.zeros(shape)).spec)


def test_named_clamps_and_zero1_specs_match_reference():
    """tests/test_sharded.py's clamp cases (a spec longer than the rank,
    an indivisible dim, multi-axis entries, a scalar) and ZeRO-1's spec
    edge cases (a size-1 dim-0 axis is free, an indivisible dim stays,
    dp = 1 is a no-op), the port's against the reference's."""
    import jax
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.distributed.sharded import _zero1_spec

    jmesh = build_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    mesh = inprocess.local_meshes(dp=2, tp=2, device="cpu")[0]
    cases = [(("dp", "tp", None), (4, 4)), (("dp", "tp"), (5, 4)),
             (("dp",), (3,)), ((("dp", "tp"),), (8, 2)),
             ((("dp", "tp"),), (6, 2)), (("dp",), ())]
    for spec, shape in cases:
        got = tuple(tsh._named(mesh, tsh.P(*spec), shape))
        assert got == _ref_named(jmesh, JP(*spec), shape), (spec, shape)
    for dp, tp, spec, shape in ((4, 1, ("tp", None), (512, 64)),
                                (4, 1, (), (512, 64)),
                                (4, 1, ("tp", None), (510, 64)),
                                (4, 1, (), ()),
                                (2, 2, ("tp", None), (512, 64)),
                                (2, 2, (None, "tp"), (64, 64)),
                                (1, 1, (), (512, 64))):
        jm = build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
        m = inprocess.local_meshes(dp=dp, tp=tp, device="cpu")[0]
        want = tuple(_zero1_spec(JP(*spec), shape, jm))
        assert tuple(tsh._zero1_spec(tsh.P(*spec), shape, m)) == want


# ---------------------------------------------------------------------------
# in one process (threads): the same step code against the unsharded step
# ---------------------------------------------------------------------------

def _local_steps(weights, axes, opt, rules=None, cfg=None, **kw):
    meshes = inprocess.local_meshes(**axes, device="cpu")
    parts = [tsh.make_sharded_train_step(port_model(weights, **(cfg or {})),
                                         opt(), mesh, rules, **kw)
             for mesh in meshes]
    return meshes, [p[0] for p in parts], [p[1] for p in parts]


@pytest.mark.parametrize("axes", [dict(tp=2), dict(sp=2),
                                  dict(dp=2, tp=2, sp=2)])
def test_in_process_step_matches_unsharded_step(axes):
    """The sharded step's ranks as threads of this process (the card's
    W > 1 form): 2 SGD steps, the losses and every rank's blocks against
    the unsharded port step, at 1e-5."""
    _hold_in_process_steps(axes, {})


@pytest.mark.parametrize("axes,chunk", [(dict(tp=2), 32),
                                        (dict(dp=2, tp=2, sp=2), 16)])
def test_in_process_step_with_ce_vocab_chunk_matches_unsharded_step(axes,
                                                                    chunk):
    """The same with the cross-entropy streamed over vocab chunks: the
    vocab-parallel head's chunks of each rank's 64 rows against the
    unsharded model's streamed CE, at 1e-5."""
    _hold_in_process_steps(axes, dict(ce_vocab_chunk=chunk))


def _hold_in_process_steps(axes, cfg):
    weights = weights_of(jax_model())
    ref = port_model(weights, **cfg)
    rst = ttrain.init_train_state(ref, topt.SGD(SGD_LR))
    rstep = ttrain.make_train_step(ref, topt.SGD(SGD_LR))
    meshes, steps, states = _local_steps(weights, axes,
                                         lambda: topt.SGD(SGD_LR), cfg=cfg)
    for i in range(2):
        x, y = (torch.from_numpy(a) for a in batch(10 + i))
        rst, want = rstep(rst, x, y)
        out = tsh.run_local_step(steps, states,
                                 [tsh.shard_batch(m, x, y) for m in meshes])
        states = [o[0] for o in out]
        for _, loss in out:
            np.testing.assert_allclose(float(loss), float(want), atol=TOL,
                                       rtol=TOL)
    for mesh, step, st in zip(meshes, steps, states):
        for n, v in rst.params.items():
            np.testing.assert_allclose(
                st.params[n].detach().numpy(),
                local_of(mesh, step, n, v.detach().numpy()), atol=TOL,
                rtol=TOL, err_msg=n)


def test_interop_shards_a_global_jax_state():
    """`interop.sharded_state_from_jax`: a global JAX TrainState after an
    AdamW step becomes each rank's blocks under gpt_rules and ZeRO-1
    (dp 2 x tp 2), bitwise the blocks of `train_state_from_jax`."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import train as jtrain
    from paddle_tpu.optimizer import functional as jopt

    from paddle_tpu_torch.interop import (
        sharded_state_from_jax, train_state_from_jax,
    )

    jm = jax_model()
    st = jtrain.init_train_state(jm, jopt.AdamW(1e-3))
    st, _ = jtrain.make_train_step(jm, jopt.AdamW(1e-3), jit=True)(
        st, *(jnp.asarray(a) for a in batch(1)))
    st = jax.tree.map(np.asarray, st)
    whole = train_state_from_jax(st, GPT(GPTConfig(**CFG), device="cpu"),
                                 topt.AdamW(1e-3), device="cpu")
    for mesh in inprocess.local_meshes(dp=2, tp=2, device="cpu"):
        got = sharded_state_from_jax(st, GPT(GPTConfig(**CFG), device="cpu"),
                                     topt.AdamW(1e-3), mesh, tsh.gpt_rules(),
                                     zero1=True)
        specs = tsh.state_specs(whole, mesh, tsh.gpt_rules(), zero1=True)
        assert any("Moment1" in k and v[0] == "dp" for k, v in specs.items())
        from paddle_tpu_torch.checkpoint import flatten_with_path

        want = dict(flatten_with_path(whole))
        for k, v in flatten_with_path(got):
            if isinstance(v, torch.Tensor):
                w = want[k]
                if k in specs:
                    w = tsh.local_block(mesh, specs[k], w)
                assert torch.equal(v, w), k


def test_in_process_logits_and_grads_of_the_vocab_parallel_head():
    """GPT.forward inside `tensor_parallel` at tp = 2 x sp = 2: every
    rank's logits are its sequence block of the unsharded model's, all
    vocab rows gathered over tp (1e-5); the grads of a loss on them
    summed over the ranks' blocks are the unsharded model's (1e-5 of the
    largest)."""
    from paddle_tpu_torch.distributed.tensor_parallel import tensor_parallel
    from paddle_tpu_torch.nn.layers import functional_call

    weights = weights_of(jax_model())
    ref = port_model(weights)
    x = torch.from_numpy(batch(5)[0])
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 128)).astype(np.float32))
    want = ref(x)
    ref_g = torch.autograd.grad((want * w).sum(), [ref.wte.weight])[0]
    meshes = inprocess.local_meshes(tp=2, sp=2, device="cpu")
    models = [port_model(weights) for _ in meshes]
    sts = [tsh.shard_train_state(ttrain.init_train_state(
        m, topt.SGD(0.1)), mesh, tsh.gpt_rules())
        for m, mesh in zip(models, meshes)]

    def fwd(r, mesh):
        leaves = {n: t.detach().requires_grad_()
                  for n, t in sts[r].params.items()}
        with tensor_parallel(mesh):
            out = functional_call(models[r], leaves,
                                  tsh.shard_batch(mesh, x))
        blk = tsh.shard_batch(mesh, w, spec=tsh.P(None, "sp"))
        # every tp rank computes the same loss from the gathered logits
        return out, (out * blk).sum(), leaves["wte.weight"]

    outs = inprocess.run_ranks(meshes, fwd)
    grads = inprocess.joint_grad([o[1] for o in outs],
                                 [[o[2]] for o in outs])
    for r, (mesh, (out, _, _)) in enumerate(zip(meshes, outs)):
        np.testing.assert_allclose(
            out.detach().numpy(),
            tsh.shard_batch(mesh, want.detach(), spec=tsh.P(None, "sp"))
            .numpy(), atol=TOL, rtol=TOL)
    # a wte row block's grad summed over the sp ranks that hold it (f32
    # sums of 64 terms in another order: 1e-5 of the largest grad)
    scale = float(ref_g.abs().max())
    for t in range(2):
        got = sum(grads[r][0] for r, m in enumerate(meshes)
                  if m.axis_index("tp") == t)
        np.testing.assert_allclose(got.numpy(),
                                   ref_g[64 * t:64 * t + 64].numpy(),
                                   atol=TOL * scale, rtol=TOL)


def test_kbias_probe_tells_a_planted_dk_fault():
    """paddle_tpu_torch.tools.kbias_probe on the CPU at width 64 (f32):
    with the attention as it is and the written-out one every key bias's
    grad stays under 2^-4 of its query bias's (1e-4: 0 in exact
    arithmetic); with D left out of dS, or the causal mask left out of
    the P that dK reads, every layer reads above 2^-4."""
    from paddle_tpu_torch.tools import kbias_probe

    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=64, dtype="float32")
    out = kbias_probe.run(cfg=cfg, batch=2, device="cpu")
    assert max(out["flash"] + out["plain"]) < 1e-4
    assert min(out["no_d"] + out["mask"]) > kbias_probe.LIMIT


# ---------------------------------------------------------------------------
# world 8 on gloo
# ---------------------------------------------------------------------------

def _sharded_run(mesh, weights):
    m = port_model(weights)
    step, st = tsh.make_sharded_train_step(m, topt.SGD(SGD_LR), mesh,
                                           tsh.gpt_rules())
    losses = []
    for i in range(2):
        st, loss = step(st, *tsh.shard_batch(mesh, *(
            torch.from_numpy(a) for a in batch(10 + i))))
        losses.append(float(loss))
    return losses, {n: v.detach().numpy().copy()
                    for n, v in st.params.items()}, dict(step.param_specs)


def _pipeline_3d_run(mesh, weights):
    from paddle_tpu_torch.distributed import pipeline

    m = port_model(weights)
    fn, params = pipeline.build_gpt_pipeline_3d(m, mesh, num_microbatches=2)
    x, y = (torch.from_numpy(a) for a in batch(3, n=8))
    x, y = tsh.shard_batch(mesh, x, y, spec=tsh.P("dp"))
    loss, grads = pipeline.value_and_grad(fn, mesh)(params, x, y)
    return float(loss), {g: {n: t.numpy().copy() for n, t in d.items()}
                         for g, d in grads.items()}


def _worker_main(weights_file, out_dir):
    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    weights = pickle.loads(Path(weights_file).read_bytes())
    rank = torch.distributed.get_rank()
    mesh = build_mesh(dp=2, tp=2, sp=2)
    out = {"coord": {a: mesh.axis_index(a) for a in ("pp", "dp", "sp",
                                                     "tp", "ep")},
           "sharded": _sharded_run(mesh, weights)}
    m3 = build_mesh(dp=2, tp=2, pp=2)
    out["coord3d"] = {a: m3.axis_index(a) for a in ("pp", "dp", "tp")}
    out["3d"] = _pipeline_3d_run(m3, weights)
    m4 = build_mesh(tp=4, pp=2)
    out["coord_tp4"] = {a: m4.axis_index(a) for a in ("pp", "tp")}
    out["tp4"] = _pipeline_3d_run(m4, weights)
    out["jax_imported"] = "jax" in sys.modules
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


def _jax_sharded(weights):
    """The JAX sharded step on build_mesh(dp=2, tp=2, sp=2) and the
    unsharded step, 2 SGD steps each: [(losses, params)]."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import sharded as jsh
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.models import train as jtrain
    from paddle_tpu.nn.layers import load_param_dict
    from paddle_tpu.optimizer import functional as jopt

    mesh = build_mesh(dp=2, tp=2, sp=2, devices=jax.devices()[:8])
    res = []
    for sharded in (True, False):
        jm = jax_model()
        load_param_dict(jm, weights)
        if sharded:
            step, st = jsh.make_sharded_train_step(jm, jopt.SGD(SGD_LR), mesh,
                                                   jsh.gpt_rules())
        else:
            st = jtrain.init_train_state(jm, jopt.SGD(SGD_LR))
            step = jtrain.make_train_step(jm, jopt.SGD(SGD_LR), jit=True)
        losses = []
        for i in range(2):
            x, y = (jnp.asarray(a) for a in batch(10 + i))
            if sharded:
                x, y = jsh.shard_batch(mesh, x, y)
            st, loss = step(st, x, y)
            losses.append(float(loss))
        res.append((losses, {n: np.asarray(v)
                             for n, v in st.params.items()}))
    return res


def _jax_3d(weights, dp, tp, pp):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.distributed.pipeline import build_gpt_pipeline_3d
    from paddle_tpu.nn.layers import load_param_dict

    jm = jax_model()
    load_param_dict(jm, weights)
    mesh = build_mesh(dp=dp, tp=tp, pp=pp, devices=jax.devices()[:8])
    fn, params = build_gpt_pipeline_3d(jm, mesh, num_microbatches=2)
    x, y = (jnp.asarray(a) for a in batch(3, n=8))
    return float(jax.jit(fn)(params, x, y))


def test_world_8_on_gloo_matches_the_jax_mesh(tmp_path):
    from test_torch_moe import start_workers

    weights = weights_of(jax_model())
    wfile = tmp_path / "weights.pkl"
    wfile.write_bytes(pickle.dumps(weights))
    wait = start_workers(__file__, 8, tmp_path, args=(str(wfile),))
    try:
        sharded = _jax_sharded(weights)
        loss_ref, grads_ref = jax_grads(jax_model(), *batch(3, n=8))
        loss_3d = _jax_3d(weights, 2, 2, 2)
    finally:
        ranks = wait()

    # dp 2 x tp 2 x sp 2: the JAX sharded and unsharded steps
    for jl, jp in sharded:
        for res in ranks:
            tl, tp, specs = res["sharded"]
            np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
            mesh = _coord_mesh(res["coord"])
            for n, want in jp.items():
                blk = tsh.local_block(mesh, specs[n],
                                      torch.tensor(want)).numpy()
                np.testing.assert_allclose(tp[n], blk, atol=TOL, rtol=TOL,
                                           err_msg=f"{n} {res['coord']}")
    # the tp split really splits: rank (tp 0) and (tp 1) hold different
    # halves of a column-parallel weight
    by_tp = {r["coord"]["tp"]: r["sharded"][1]["blocks.0.fc1.weight"]
             for r in ranks}
    assert by_tp[0].shape == (32, 64) and not np.array_equal(by_tp[0],
                                                              by_tp[1])

    # dp 2 x tp 2 x pp 2 and tp 4 x pp 2: loss and grads
    np.testing.assert_allclose(loss_3d, loss_ref, atol=TOL, rtol=TOL)
    for key, coord_key, axes in (("3d", "coord3d", (2, 2, 2)),
                                 ("tp4", "coord_tp4", (1, 4, 2))):
        for res in ranks:
            loss, grads = res[key]
            np.testing.assert_allclose(loss, loss_ref, atol=TOL, rtol=TOL)
            c = res[coord_key]
            per = CFG["num_layers"] // 2
            for n, g in grads["stages"].items():
                for k in range(per):
                    layer = c["pp"] * per + k
                    want = _tp_tile(n, grads_ref[f"blocks.{layer}.{n}"],
                                    c["tp"], axes[1])
                    np.testing.assert_allclose(
                        g[k], want, atol=TOL, rtol=TOL,
                        err_msg=f"{key} {n} layer {layer} {c}")
            for grp in ("emb", "head"):
                for n, g in grads[grp].items():
                    np.testing.assert_allclose(g, grads_ref[n], atol=TOL,
                                               rtol=TOL, err_msg=f"{key} {n}")


def _tp_tile(name, g, index, tp):
    from paddle_tpu_torch.distributed.pipeline import tp_stage_spec

    spec = tp_stage_spec(name)[1:]          # without the block dim
    for d, a in enumerate(spec):
        if a == "tp":
            blk = g.shape[d] // tp
            g = np.take(g, range(index * blk, (index + 1) * blk), axis=d)
    return g


class _CoordMesh:
    """A mesh seen from a coordinate (sizes dp 2 x tp 2 x sp 2): what
    `local_block` reads."""

    def __init__(self, coord):
        self.coord = coord

    def axis_size(self, name):
        return {"dp": 2, "tp": 2, "sp": 2}.get(name, 1)

    def axis_index(self, name):
        return self.coord.get(name, 0)


def _coord_mesh(coord):
    return _CoordMesh(coord)


@pytest.mark.cuda
def test_in_process_tp_step_on_the_card_matches_unsharded():
    """On the card the in-process tp = 2 step (K1-K3 on each rank's
    local heads, f32) gives the unsharded step's losses and params."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1-K5)")
    from paddle_tpu_torch.nn import make_generator

    cfg = dict(CFG, hidden_size=256, num_heads=4, max_seq_len=128)
    ref = GPT(GPTConfig(**cfg), device="cuda", generator=make_generator(3))
    rst = ttrain.init_train_state(ref, topt.SGD(SGD_LR))
    rstep = ttrain.make_train_step(ref, topt.SGD(SGD_LR),
                                   precision="float32")
    meshes = inprocess.local_meshes(tp=2, device="cuda")
    parts = [tsh.make_sharded_train_step(
        GPT(GPTConfig(**cfg), device="cuda", generator=make_generator(3)),
        topt.SGD(SGD_LR), mesh) for mesh in meshes]
    steps, states = [p[0] for p in parts], [p[1] for p in parts]
    x, y = (torch.from_numpy(a).cuda() for a in batch(1, n=2, seq=128))
    torch.backends.cuda.matmul.allow_tf32 = False
    rst, want = rstep(rst, x, y)
    out = tsh.run_local_step(steps, states,
                             [tsh.shard_batch(m, x, y) for m in meshes])
    for _, loss in out:
        np.testing.assert_allclose(float(loss), float(want), atol=1e-4,
                                   rtol=1e-4)
    for mesh, step, (st, _) in zip(meshes, steps, out):
        for n, v in rst.params.items():
            np.testing.assert_allclose(
                st.params[n].detach().cpu().numpy(),
                local_of(mesh, step, n, v.detach().cpu().numpy()),
                atol=1e-4, rtol=1e-4, err_msg=n)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
