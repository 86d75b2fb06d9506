"""The port's pipelines (distributed.pipeline: GPipe, the interleaved
schedule, pp x ep) against the JAX package's and the single-device model
(tests/test_pipeline.py's cases).

Two launches of gloo worker processes (`python tests/test_torch_pipeline.py
<world> <weights> <out dir>`, killed after 120 s; no jax in the workers),
each rank holding its own stage:

- world 2 (pp = 2): `build_gpt_pipeline` at 4 microbatches, loss and the
  grads of every stage leaf, the embedding and the head; the interleaved
  schedule (V = 2) on an identity stage (every microbatch passes all
  chunks: + 1111), on an order-sensitive stage (h * 2 + c gives 11 only
  in chunk order), on the GPT at (pp, V) = (2, 2) and, with grads, at
  8 layers (4 chunks of 2 blocks); with dropout 0.3: two keys give two
  losses, one key the same loss twice, the mean over 8 keys within a
  quarter of the dropout-free loss, and 30 SGD steps at dropout 0.1 cut
  the loss by a fifth (port-only, as the reference's own tests);
- world 4: the identity schedule at pp = 4; the GPT at (pp, dp) = (4, 1)
  and (2, 2); pp 2 x ep 2: the interleaved pipeline of expert-parallel
  MoE blocks (`moe_ffn_shardmap` over ep, the batch split over ep)
  against the dense serial stack, its output and the w1 grads.

JAX's single-device losses and grads are the reference: atol = rtol =
1e-5 (the reference's rule: rtol 1e-5 / 2e-4 for grads, atol 1e-6).
"""

import functools
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import inprocess, pipeline as tpipe
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           max_seq_len=16, dropout=0.0)


def batch(n=8, seq=16, seed=0, vocab=128):
    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, (n, seq)).astype(np.int32),
            r.integers(0, vocab, (n, seq)).astype(np.int32))


def _jax_model(layers):
    from paddle_tpu import nn as jnn
    from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

    np.random.seed(0)
    jnn.seed(0)
    return JGPT(JGPTConfig(**dict(CFG, num_layers=layers)))


def _weights(jm):
    from paddle_tpu import nn as jnn

    return {n: np.asarray(v) for n, v in jnn.param_dict(jm).items()}


def _jax_loss_grads(jm):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.layers import _swap_params, param_dict

    x, y = (jnp.asarray(a) for a in batch())

    def loss(flat):
        with _swap_params(jm, flat):
            return jm.loss(x, y)

    l, g = jax.value_and_grad(loss)(param_dict(jm))
    return float(l), {n: np.asarray(v) for n, v in g.items()}


def _moe_blocks(S=2, V=2, E=4, D=8, H=16):
    return [{k: v.astype(np.float32) for k, v in {
        "wg": np.random.default_rng(100 + i).standard_normal((D, E)) * 0.3,
        "w1": np.random.default_rng(200 + i).standard_normal((E, D, H)) * 0.2,
        "w2": np.random.default_rng(300 + i).standard_normal((E, H, D)) * 0.2,
    }.items()} for i in range(S * V)]


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _port_model(weights, layers, **kw):
    from paddle_tpu_torch.interop import load_jax_param_dict

    m = GPT(GPTConfig(**dict(CFG, num_layers=layers, **kw)), device="cpu")
    load_jax_param_dict(m, weights)
    return m


def _np(tree):
    return {g: {n: t.detach().numpy().copy() for n, t in d.items()}
            for g, d in tree.items()}


def _gpt(mesh, weights, layers, micro, interleave=1):
    m = _port_model(weights, layers)
    fn, params = tpipe.build_gpt_pipeline(m, mesh, micro,
                                          interleave=interleave)
    from paddle_tpu_torch.distributed.sharded import P, shard_batch

    x, y = shard_batch(mesh, *(torch.from_numpy(a) for a in batch()),
                       spec=P("dp"))
    loss, grads = tpipe.value_and_grad(fn, mesh)(params, x, y)
    return float(loss), _np(grads)


def _schedules(mesh, S):
    """The identity and order-sensitive stages: the outputs."""
    out = {}
    me = mesh.axis_index("pp")
    w = torch.arange(1, S + 1, dtype=torch.float32).reshape(S, 1)
    fn = tpipe.gpipe(lambda p, h: h + p[0], mesh, 2, batch_axis=None)
    out["gpipe_identity"] = fn(w[me], torch.ones(4, 3)).numpy()
    if S == 2:
        # interleaved rows: row d*V + v = chunk v*S + d
        rows = torch.tensor([[1.0], [100.0], [10.0], [1000.0]])
        fn = tpipe.interleaved_gpipe(lambda p, h: h + p["w"][0], mesh, 4, 2,
                                     batch_axis=None)
        out["interleaved_identity"] = fn(
            {"w": rows[2 * me:2 * me + 2]}, torch.zeros(8, 3)).numpy()
        cs = torch.tensor([[0.0], [2.0], [1.0], [3.0]])
        fn = tpipe.interleaved_gpipe(lambda p, h: h * 2.0 + p["c"][0], mesh,
                                     2, 2, batch_axis=None)
        out["interleaved_order"] = fn({"c": cs[2 * me:2 * me + 2]},
                                      torch.zeros(2, 1)).numpy()
    return out


def _dropout(mesh, weights):
    """Masks vary, are repeatable, average out; training lowers the
    loss."""
    m = _port_model(weights["drop"], 2, dropout=0.3)
    fn, params = tpipe.build_gpt_pipeline(m, mesh, 2)
    x, y = (torch.from_numpy(a) for a in batch())
    with torch.no_grad():
        l0, l1 = float(fn(params, x, y, rng_key=0)), float(fn(params, x, y,
                                                              rng_key=1))
        again = float(fn(params, x, y, rng_key=0))
        mean = float(np.mean([float(fn(params, x, y, rng_key=k))
                              for k in range(8)]))
        ref_fn, _ = tpipe.build_gpt_pipeline(
            _port_model(weights["drop"], 2), mesh, 2)
        ref = float(ref_fn(params, x, y))
    raised = False
    try:
        fn(params, x, y)
    except ValueError as e:
        raised = "rng_key" in str(e)
    m = _port_model(weights["train"], 2, dropout=0.1, vocab_size=64,
                    max_seq_len=8)
    fn, params = tpipe.build_gpt_pipeline(m, mesh, 2)
    xs, ys = (torch.from_numpy(a) for a in batch(4, 8, vocab=64))
    vg = tpipe.value_and_grad(fn, mesh)
    losses = []
    for i in range(30):
        loss, grads = vg(params, xs, ys, rng_key=tpipe.fold_in(0, i))
        with torch.no_grad():
            for g in params:
                for n, t in params[g].items():
                    t.sub_(0.1 * grads[g][n])
        losses.append(float(loss))
    return dict(l0=l0, l1=l1, again=again, mean=mean, ref=ref,
                raised=raised, losses=losses)


def _pp_ep(mesh):
    """The interleaved pp 2 x ep 2 MoE pipeline: (out block, w1 grads of
    this rank's rows, this rank's ep index)."""
    from paddle_tpu_torch.distributed.moe import moe_ffn_shardmap

    S, V, E = 2, 2, 4
    blocks = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in _moe_blocks()]
    stacked = tpipe.stage_params(tpipe.interleave_stack_params(blocks, S, V),
                                 mesh, rows=V)
    e = mesh.axis_index("ep")
    for n in ("w1", "w2"):
        stacked[n] = stacked[n][:, :, e * 2:e * 2 + 2].contiguous()
    stacked = {n: t.requires_grad_() for n, t in stacked.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 8)).astype(np.float32))[e * 8:e * 8 + 8]

    def stage(chunk_p, hh):
        bp = {n: t[0] for n, t in chunk_p.items()}
        ye, _ = moe_ffn_shardmap(bp, hh, axis="ep", k=2,
                                 capacity_factor=8.0, mesh=mesh)
        return hh + ye

    pipe = tpipe.interleaved_gpipe(stage, mesh, 2, V, batch_axis="ep")
    out = pipe(stacked, x)
    g = torch.autograd.grad((out ** 2).sum(), stacked["w1"])[0]
    return out.detach().numpy(), g.numpy(), e


def _worker_main(world, weights_file, out_dir):
    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    weights = pickle.loads(Path(weights_file).read_bytes())
    rank = torch.distributed.get_rank()
    out = {}
    if int(world) == 2:
        mesh = build_mesh(pp=2)
        out["sched"] = _schedules(mesh, 2)
        out["pp2"] = _gpt(mesh, weights[4], 4, 4)
        out["il22"] = _gpt(mesh, weights[4], 4, 2, interleave=2)
        out["il8"] = _gpt(mesh, weights[8], 8, 4, interleave=2)
        out["drop"] = _dropout(mesh, weights)
        out["pp"] = mesh.axis_index("pp")
    else:
        mesh = build_mesh(pp=4)
        out["sched"] = _schedules(mesh, 4)
        out["pp4"] = _gpt(mesh, weights[4], 4, 2)
        out["pp4_index"] = mesh.axis_index("pp")
        m22 = build_mesh(pp=2, dp=2)
        out["pp2dp2"] = _gpt(m22, weights[4], 4, 2)
        out["pp2dp2_index"] = m22.axis_index("pp")
        out["ppep"] = _pp_ep(build_mesh(pp=2, ep=2))
    out["jax_imported"] = "jax" in sys.modules
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _hold_stage_grads(grads, want, rank, S, V, per, label):
    for n, g in grads["stages"].items():
        for v in range(V):
            for k in range(per):
                layer = (v * S + rank) * per + k
                got = g[v, k] if V > 1 else g[k]
                np.testing.assert_allclose(
                    got, want[f"blocks.{layer}.{n}"], atol=TOL, rtol=TOL,
                    err_msg=f"{label} {n} layer {layer}")
    for grp in ("emb", "head"):
        for n, g in grads[grp].items():
            np.testing.assert_allclose(g, want[n], atol=TOL, rtol=TOL,
                                       err_msg=f"{label} {n}")


@functools.lru_cache(maxsize=None)
def _jax_weights(layers):
    """`_weights(_jax_model(layers))`, made once per module."""
    return _weights(_jax_model(layers))


@functools.lru_cache(maxsize=None)
def _jax_ref(layers):
    """`_jax_loss_grads(_jax_model(layers))`, made once per module."""
    return _jax_loss_grads(_jax_model(layers))


def _launch(tmp_path, world, weights):
    """Start the workers (see test_torch_moe.start_workers); the returned
    callable waits for their results."""
    from test_torch_moe import start_workers

    wfile = tmp_path / "weights.pkl"
    wfile.write_bytes(pickle.dumps(weights))
    return start_workers(__file__, world, tmp_path, args=(str(world),
                                                          str(wfile)))


def test_world_2_gpipe_interleaved_dropout_on_gloo(tmp_path):
    from paddle_tpu import nn as jnn

    weights = {4: _jax_weights(4), 8: _jax_weights(8)}
    for key, layers, kw in (("drop", 2, {}), ("train", 2,
                                              dict(vocab_size=64,
                                                   max_seq_len=8))):
        np.random.seed(1)
        jnn.seed(1)
        from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JC

        weights[key] = _weights(JGPT(JC(**dict(CFG, num_layers=layers,
                                               **kw))))
    wait = _launch(tmp_path, 2, weights)
    try:
        ref4, ref8 = _jax_ref(4), _jax_ref(8)
    finally:
        ranks = wait()
    for res in ranks:
        r = res["pp"]
        for key, ref, V, per in (("pp2", ref4, 1, 2), ("il22", ref4, 2, 1),
                                 ("il8", ref8, 2, 2)):
            loss, grads = res[key]
            np.testing.assert_allclose(loss, ref[0], atol=TOL, rtol=TOL,
                                       err_msg=key)
            _hold_stage_grads(grads, ref[1], r, 2, V, per, key)
        sched = res["sched"]
        np.testing.assert_allclose(sched["gpipe_identity"], 1.0 + 3.0)
        np.testing.assert_allclose(sched["interleaved_identity"], 1111.0)
        np.testing.assert_allclose(sched["interleaved_order"], 11.0)
        d = res["drop"]
        assert d["l0"] != d["l1"] and d["again"] == d["l0"] and d["raised"]
        assert abs(d["mean"] - d["ref"]) / d["ref"] < 0.25, d
        losses = d["losses"]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses
    # dropout masks differ across stages but not across the ranks' view
    # of the loss: every rank reports the same losses
    assert ranks[0]["drop"]["losses"] == ranks[1]["drop"]["losses"]


def test_world_4_gpipe_dp_and_pp_ep_on_gloo(tmp_path):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed.moe import moe_ffn

    wait = _launch(tmp_path, 4, {4: _jax_weights(4)})
    try:
        ref = _jax_ref(4)
        blocks = [{k: jnp.asarray(v) for k, v in b.items()}
                  for b in _moe_blocks()]
        x = jnp.asarray(np.random.default_rng(0).standard_normal(
            (16, 8)).astype(np.float32))

        def dense(bs):
            h = x
            for bp in bs:
                y, _ = moe_ffn(bp, h, k=2, capacity_factor=8.0)
                h = h + y
            return h

        want = np.asarray(dense(blocks))
        g_ref = jax.grad(lambda bs: jnp.sum(dense(bs) ** 2))(blocks)
    finally:
        ranks = wait()
    for res in ranks:
        np.testing.assert_allclose(res["sched"]["gpipe_identity"],
                                   1.0 + 10.0)
        for key, S, per in (("pp4", 4, 1), ("pp2dp2", 2, 2)):
            loss, grads = res[key]
            np.testing.assert_allclose(loss, ref[0], atol=TOL, rtol=TOL,
                                       err_msg=key)
            _hold_stage_grads(grads, ref[1], res[f"{key}_index"], S, 1, per,
                              key)
    # pp x ep against the dense serial stack (capacity 8: nothing drops)
    for res in ranks:
        out, g, e = res["ppep"]
        np.testing.assert_allclose(out, want[e * 8:e * 8 + 8], atol=TOL,
                                   rtol=TOL)
    # rank (pp d, ep e) holds rows d*V + v (chunk v*S + d), experts
    # 2e..2e+1; its w1 grads summed over ep's batch halves come from the
    # all_to_all backward already (the expert slice sees every token)
    for res, rank in zip(ranks, range(4)):
        out, g, e = res["ppep"]
        d = rank // 2
        for v in range(2):
            chunk = v * 2 + d
            np.testing.assert_allclose(
                g[v, 0], np.asarray(g_ref[chunk]["w1"])[2 * e:2 * e + 2],
                atol=TOL, rtol=2e-4, err_msg=f"w1 chunk {chunk} ep {e}")


def test_bubble_fraction_and_bad_configs():
    """tests/test_pipeline.py's bubble fractions and rejections, on a
    pp = 2 mesh held in this process."""
    assert tpipe.bubble_fraction(4, 8) == pytest.approx(3 / 11)
    assert tpipe.bubble_fraction(4, 8, 4) == pytest.approx(3 / 35)
    for v in (2, 3, 4):
        assert tpipe.bubble_fraction(4, 8, v) < \
            tpipe.bubble_fraction(4, 8, v - 1)
    mesh = inprocess.local_meshes(pp=2, device="cpu")[0]
    with pytest.raises(ValueError, match="divisible"):
        tpipe.interleaved_gpipe(lambda p, h: h, mesh, num_microbatches=3,
                                num_virtual=2)
    m = GPT(GPTConfig(vocab_size=64, hidden_size=16, num_layers=4,
                      num_heads=2, max_seq_len=8, dropout=0.1), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        tpipe.build_gpt_pipeline(m, mesh, num_microbatches=2, interleave=2)
    with pytest.raises(ValueError, match="dropout"):
        tpipe.build_gpt_pipeline_3d(m, mesh, num_microbatches=2)


def test_in_process_pipeline_matches_the_model():
    """The ranks of a pp = 2 mesh as threads (the card's form): the loss
    and every grad of build_gpt_pipeline, V = 1 and 2, against the
    single-device port model, at 1e-5."""
    from paddle_tpu_torch.nn import make_generator

    x, y = (torch.from_numpy(a) for a in batch())
    ref = GPT(GPTConfig(**CFG), device="cpu", generator=make_generator(0))
    params = dict(ref.named_parameters())
    loss = ref.loss(x, y)
    want = {n: g.numpy() for n, g in zip(params, torch.autograd.grad(
        loss, list(params.values())))}
    for V in (1, 2):
        meshes = inprocess.local_meshes(pp=2, device="cpu")
        built = [tpipe.build_gpt_pipeline(
            GPT(GPTConfig(**CFG), device="cpu", generator=make_generator(0)),
            mesh, 2, interleave=V) for mesh in meshes]

        def fwd(r, mesh):
            fn, p = built[r]
            leaves = {g: {n: t.detach().requires_grad_()
                          for n, t in p[g].items()} for g in p}
            return fn(leaves, x, y), leaves

        outs = inprocess.run_ranks(meshes, fwd)
        flat = [[t for g in o[1] for t in o[1][g].values()] for o in outs]
        grads = inprocess.joint_grad([o[0] for o in outs], flat)
        for r, (o, gs) in enumerate(zip(outs, grads)):
            np.testing.assert_allclose(float(o[0]), float(loss), atol=TOL,
                                       rtol=TOL)
            keys = [(g, n) for g in o[1] for n in o[1][g]]
            tree = {"stages": {}, "emb": {}, "head": {}}
            for (g, n), gr in zip(keys, gs):
                tree[g][n] = gr.numpy()
            _hold_stage_grads(tree, want, r, 2, V, 2 // V, f"V={V}")


def test_interop_carries_the_references_pipeline_params():
    """`interop.pipeline_params_from_jax`: the reference's stacked
    pipeline params (GPipe [S, per, ...], interleaved [S V, per, ...],
    3D with tp tiles) become each rank's stage, bitwise the stage the
    port's builder cuts from the same weights."""
    import jax
    from paddle_tpu.distributed import pipeline as jpipe
    from paddle_tpu.distributed.mesh import build_mesh

    from paddle_tpu_torch.interop import pipeline_params_from_jax

    jm = _jax_model(4)
    weights = _weights(jm)
    for kw, axes, tp in ((dict(), dict(pp=2), False),
                         (dict(interleave=2), dict(pp=2), False),
                         (None, dict(pp=2, tp=2), True)):
        jmesh = build_mesh(**axes, devices=jax.devices()[
            :int(np.prod(list(axes.values())))])
        if tp:
            _, jp = jpipe.build_gpt_pipeline_3d(jm, jmesh, 2)
        else:
            _, jp = jpipe.build_gpt_pipeline(jm, jmesh, 2, **kw)
        jp = jax.tree.map(np.asarray, jp)
        for mesh in inprocess.local_meshes(**axes, device="cpu"):
            m = _port_model(weights, 4)
            if tp:
                _, want = tpipe.build_gpt_pipeline_3d(m, mesh, 2)
            else:
                _, want = tpipe.build_gpt_pipeline(m, mesh, 2, **kw)
            got = pipeline_params_from_jax(
                jp, mesh, interleave=(kw or {}).get("interleave", 1), tp=tp)
            for g in want:
                assert got[g].keys() == want[g].keys()
                for n, t in want[g].items():
                    assert torch.equal(got[g][n], t), (kw, g, n)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2], sys.argv[3])
