"""ZeRO-1, FSDP, accumulation, clipping, sequence parallelism, resharded
checkpoints and the fleet's tp degree in the port's sharded step, against
the JAX package's (tests/test_sharded.py's cases) and the port's own
replicated step.

One launch of four gloo worker processes (`python
tests/test_torch_zero_fsdp.py <weights> <out dir>`, killed after 120 s;
no jax in the workers) runs, on one world of 4:

- the reference's MLP (16 -> 32 relu -> 4, `nn.seed`-drawn weights) at dp
  = 4: `zero1=True` with Adam(0.01), 3 steps; with `accum_steps=2` and
  SGD(0.05) on 16 samples; `fsdp_rules()` with Adam(0.01): losses
  against the JAX replicated runs at atol = rtol = 1e-5 (the reference's
  rule is rtol 1e-5, atol 1e-6 against its own replicated run); ZeRO-1
  against the same step without it bitwise (the reductions are the
  same; AdamW and SGD are elementwise); the moments' and params' local
  shapes; FSDP's peak of gathered bytes below the model's;
- the ZeRO-1 checkpoint round trip: saved whole (`save_checkpoint` with
  `mesh`, `state_specs`), restored onto the same mesh bitwise, and a
  step from each gives the same loss bitwise;
- `restore_resharded` of a dp 2 x tp 2 GPT state onto dp = 4 (ZeRO-1's
  specs) and onto one rank (`mesh=None`): bitwise the saved arrays;
- a global-norm clip (0.05, engaged) over params split on tp (dp 2 x tp
  2) and on ep (dp 2 x ep 2, the MoE GPT): 2 SGD steps against the JAX
  unsharded step with the same clip, losses and params at 1e-5;
- sp = 4 alone (seq 32): one SGD step against the JAX unsharded step;
- `fleet.make_train_step` with dp_degree 2 and tp_degree 2: the data
  parallel step over dp (tp replicates) against one process on the
  whole batch, 2 SGD steps at 1e-5.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.distributed import sharded as tsh
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, dropout=0.0)
CLIP = 0.05


def mlp_data(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, (n,)).astype(np.int32))


def gpt_batch(seed, n=4, seq=16):
    r = np.random.default_rng(seed)
    return (r.integers(0, 128, (n, seq)).astype(np.int32),
            r.integers(0, 128, (n, seq)).astype(np.int32))


def _jax_mlp(seed):
    from paddle_tpu import nn as jnn

    jnn.seed(seed)
    return jnn.Sequential(jnn.Linear(16, 32, act="relu"), jnn.Linear(32, 4))


def _jax_gpt(**kw):
    from paddle_tpu import nn as jnn
    from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

    np.random.seed(0)
    jnn.seed(0)
    return JGPT(JGPTConfig(**{**CFG, **kw}))


def _np_params(m):
    from paddle_tpu import nn as jnn

    return {n: np.asarray(v) for n, v in jnn.param_dict(m).items()}


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _port_mlp(weights):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.interop import load_jax_param_dict

    m = nn.Sequential(nn.Linear(16, 32, act="relu", device="cpu"),
                      nn.Linear(32, 4, device="cpu"))
    load_jax_param_dict(m, weights)
    return m


def _mlp_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y).mean()


def _port_gpt(weights, **kw):
    from paddle_tpu_torch.interop import load_jax_param_dict

    m = GPT(GPTConfig(**{**CFG, **kw}), device="cpu")
    load_jax_param_dict(m, weights)
    return m


def _params(st):
    return {n: v.detach().numpy().copy() for n, v in st.params.items()}


def _mlp_runs(mesh, weights):
    """The MLP cases at dp = 4: {case: (losses, params, extra)}."""
    out = {}
    cases = (("zero1", 77, 8, lambda: topt.Adam(0.01), tsh.mlp_rules(),
              dict(zero1=True)),
             ("replicated", 77, 8, lambda: topt.Adam(0.01), tsh.mlp_rules(),
              {}),
             ("zero1_accum", 41, 16, lambda: topt.SGD(0.05),
              tsh.mlp_rules(), dict(zero1=True, accum_steps=2)),
             ("accum", 41, 16, lambda: topt.SGD(0.05), tsh.mlp_rules(),
              dict(accum_steps=2)),
             ("fsdp", 31, 8, lambda: topt.Adam(0.01), tsh.fsdp_rules(), {}))
    for name, seed, n, opt, rules, kw in cases:
        m = _port_mlp(weights[seed])
        step, st = tsh.make_sharded_train_step(m, opt(), mesh, rules,
                                               loss_fn=_mlp_loss, **kw)
        data = {77: 0, 41: 6, 31: 1}[seed]
        x, y = (torch.from_numpy(a) for a in mlp_data(data, n))
        x, y = tsh.shard_batch(mesh, x, y)
        slots = st.opt_state["0.weight"]
        extra = {"param": tuple(st.params["0.weight"].shape),
                 "moment": (tuple(slots["Moment1"].shape)
                            if "Moment1" in slots else None)}
        losses = []
        for _ in range(3):
            st, loss = step(st, x, y)
            losses.append(float(loss))
        extra["fsdp_peak"] = step.fsdp_peak_bytes
        extra["model_bytes"] = sum(p.numel() * p.element_size()
                                   for p in m.parameters())
        extra["after"] = (tuple(st.params["0.weight"].shape),)
        out[name] = (losses, _params(st), extra)
        if name == "zero1":
            out["_zero1"] = (m, step, st, x, y, opt)
    return out


def _ckpt_round_trip(mesh, zero1, ckpt_dir):
    """Save the ZeRO-1 state whole, restore it onto the same mesh, step
    from both: (every leaf bitwise, the losses bitwise)."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import flatten_with_path

    m, step, st, x, y, opt = zero1
    checkpoint.save_checkpoint(ckpt_dir, st, 3, mesh=mesh,
                               state_specs=step.state_specs)
    m2 = _port_mlp_like(m)
    step2, tmpl = tsh.make_sharded_train_step(
        m2, opt(), mesh, tsh.mlp_rules(), loss_fn=_mlp_loss, zero1=True)
    restored, at = checkpoint.restore_resharded(
        ckpt_dir, tmpl, mesh=mesh, state_specs=step2.state_specs)
    a = dict(flatten_with_path(st))
    b = dict(flatten_with_path(restored))
    same = at == 3 and a.keys() == b.keys() and all(
        torch.equal(v, b[k]) for k, v in a.items()
        if isinstance(v, torch.Tensor))
    _, l1 = step(st, x, y)
    _, l2 = step2(restored, x, y)
    return same, bool(torch.equal(l1, l2))


def _port_mlp_like(m):
    from paddle_tpu_torch import nn

    m2 = nn.Sequential(nn.Linear(16, 32, act="relu", device="cpu"),
                       nn.Linear(32, 4, device="cpu"))
    with torch.no_grad():
        for a, b in zip(m2.parameters(), m.parameters()):
            a.copy_(b)
    return m2


def _reshard(weights, ckpt_dir):
    """A dp 2 x tp 2 GPT state after one SGD step, saved whole; restored
    onto dp = 4 with ZeRO-1's specs and onto one rank: (each restored
    leaf equals its block of the gathered state, bitwise)."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import flatten_with_path
    from paddle_tpu_torch.distributed.mesh import build_mesh

    mesh = build_mesh(dp=2, tp=2)
    step, st = tsh.make_sharded_train_step(_port_gpt(weights),
                                           topt.Adam(1e-3), mesh)
    st, _ = step(st, *tsh.shard_batch(mesh, *(torch.from_numpy(a) for a in
                                               gpt_batch(1))))
    whole = tsh.gather_state(st, mesh, step.state_specs)
    checkpoint.save_checkpoint(ckpt_dir, st, 1, mesh=mesh,
                               state_specs=step.state_specs)
    dp4 = build_mesh(dp=4)
    step4, tmpl = tsh.make_sharded_train_step(_port_gpt(weights),
                                              topt.Adam(1e-3), dp4,
                                              zero1=True)
    on4, _ = checkpoint.restore_resharded(ckpt_dir, tmpl, mesh=dp4,
                                          state_specs=step4.state_specs)
    on1, _ = checkpoint.restore_resharded(ckpt_dir, tmpl)
    w = dict(flatten_with_path(whole))
    ok4 = all(torch.equal(v, tsh.local_block(dp4, step4.state_specs[k], w[k])
                          if k in step4.state_specs else w[k])
              for k, v in flatten_with_path(on4)
              if isinstance(v, torch.Tensor))
    ok1 = all(torch.equal(v, w[k]) for k, v in flatten_with_path(on1)
              if isinstance(v, torch.Tensor))
    split = sum(1 for k in step4.state_specs if "Moment" in k)
    return ok4, ok1, split, len(step.state_specs)


def _clip_runs(mesh, weights, **kw):
    step, st = tsh.make_sharded_train_step(
        _port_gpt(weights, **kw),
        topt.SGD(0.1, grad_clip=topt.global_norm_clip(CLIP)), mesh)
    losses = []
    for i in range(2):
        st, loss = step(st, *tsh.shard_batch(mesh, *(
            torch.from_numpy(a) for a in gpt_batch(20 + i))))
        losses.append(float(loss))
    return losses, _params(st), dict(step.param_specs)


def _fleet_run(weights):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.dp_degree, s.tp_degree = 2, 2
    m = _port_gpt(weights)
    step = fleet.make_train_step(m, topt.SGD(0.1), lambda mod, x, y:
                                 mod.loss(x, y), strategy=s)
    losses = [float(step(*(torch.from_numpy(a) for a in gpt_batch(30 + i))))
              for i in range(2)]
    return losses, {n: p.detach().numpy().copy()
                    for n, p in m.named_parameters()}


def _worker_main(weights_file, out_dir):
    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    weights = pickle.loads(Path(weights_file).read_bytes())
    rank = torch.distributed.get_rank()
    dp4 = build_mesh(dp=4)
    mlp = _mlp_runs(dp4, weights["mlp"])
    out = {"mlp": {k: v for k, v in mlp.items() if not k.startswith("_")},
           "ckpt": _ckpt_round_trip(dp4, mlp["_zero1"],
                                    str(Path(out_dir, "ckpt_zero1"))),
           "reshard": _reshard(weights["gpt"],
                               str(Path(out_dir, "ckpt_tp"))),
           "clip_tp": _clip_runs(build_mesh(dp=2, tp=2), weights["gpt"]),
           "clip_ep": _clip_runs(build_mesh(dp=2, ep=2), weights["moe"],
                                 num_experts=4, moe_top_k=2),
           "fleet": _fleet_run(weights["gpt"])}
    sp4 = build_mesh(sp=4)
    step, st = tsh.make_sharded_train_step(_port_gpt(weights["gpt"]),
                                           topt.SGD(0.1), sp4)
    st, loss = step(st, *tsh.shard_batch(sp4, *(
        torch.from_numpy(a) for a in gpt_batch(40, seq=32))))
    out["sp4"] = (float(loss), _params(st))
    out["coord"] = {a: dp4.axis_index(a) for a in ("dp",)}
    out["coord22"] = {a: build_mesh(dp=2, tp=2).axis_index(a)
                      for a in ("dp", "tp")}
    out["coord_ep"] = {a: build_mesh(dp=2, ep=2).axis_index(a)
                       for a in ("dp", "ep")}
    out["jax_imported"] = "jax" in sys.modules
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


# ---------------------------------------------------------------------------
# the references and the test
# ---------------------------------------------------------------------------

def _jax_mlp_losses(seed, data, n, opt):
    from paddle_tpu.models.train import init_train_state, make_train_step
    from paddle_tpu.nn import functional as JF

    m = _jax_mlp(seed)
    st = init_train_state(m, opt)
    step = make_train_step(m, opt, loss_fn=lambda mm, x, y:
                           JF.cross_entropy(mm(x), y).mean())
    x, y = mlp_data(data, n)
    losses = []
    for _ in range(3):
        st, loss = step(st, x, y)
        losses.append(float(loss))
    return losses


def _jax_gpt_run(steps, batches, opt, **kw):
    import jax.numpy as jnp
    from paddle_tpu.models import train as jtrain

    jm = _jax_gpt(**kw)
    st = jtrain.init_train_state(jm, opt)
    step = jtrain.make_train_step(jm, opt, jit=True)
    losses = []
    for b in batches[:steps]:
        st, loss = step(st, *(jnp.asarray(a) for a in b))
        losses.append(float(loss))
    return losses, {n: np.asarray(v) for n, v in st.params.items()}


class _Coord:
    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def axis_size(self, a):
        return self.sizes.get(a, 1)

    def axis_index(self, a):
        return self.coord.get(a, 0)


def _hold_params(got, want, specs, coord, label):
    for n, w in want.items():
        blk = tsh.local_block(coord, specs[n], torch.tensor(w)).numpy()
        np.testing.assert_allclose(got[n], blk, atol=TOL, rtol=TOL,
                                   err_msg=f"{label} {n}")


def test_world_4_zero1_fsdp_clip_reshard_on_gloo(tmp_path):
    from paddle_tpu.optimizer import functional as jopt

    from test_torch_moe import start_workers

    weights = {"mlp": {s: _np_params(_jax_mlp(s)) for s in (77, 41, 31)},
               "gpt": _np_params(_jax_gpt()),
               "moe": _np_params(_jax_gpt(num_experts=4, moe_top_k=2))}
    wfile = tmp_path / "weights.pkl"
    wfile.write_bytes(pickle.dumps(weights))
    wait = start_workers(__file__, 4, tmp_path, args=(str(wfile),))
    clip_cases = (("clip_tp", {}, {"dp": 2, "tp": 2}, "coord22"),
                  ("clip_ep", dict(num_experts=4, moe_top_k=2),
                   {"dp": 2, "ep": 2}, "coord_ep"))
    try:
        want = {"zero1": _jax_mlp_losses(77, 0, 8, jopt.Adam(0.01)),
                "zero1_accum": _jax_mlp_losses(41, 6, 16, jopt.SGD(0.05)),
                "fsdp": _jax_mlp_losses(31, 1, 8, jopt.Adam(0.01))}
        batches = [gpt_batch(20 + i) for i in range(2)]
        clip_refs = {key: (_jax_gpt_run(2, batches, jopt.SGD(
            0.1, grad_clip=jopt.global_norm_clip(CLIP)), **kw),
            _jax_gpt_run(2, batches, jopt.SGD(0.1), **kw))
            for key, kw, _, _ in clip_cases}
        sp4 = _jax_gpt_run(1, [gpt_batch(40, seq=32)], jopt.SGD(0.1))
    finally:
        ranks = wait()
    for res in ranks:
        mlp = res["mlp"]
        for name, losses in want.items():
            np.testing.assert_allclose(mlp[name][0], losses, atol=TOL,
                                       rtol=TOL, err_msg=name)
        # ZeRO-1 is the replicated update, bitwise
        for a, b in (("zero1", "replicated"), ("zero1_accum", "accum")):
            assert mlp[a][0] == mlp[b][0], (a, b)
            for n, v in mlp[b][1].items():
                np.testing.assert_array_equal(mlp[a][1][n], v, err_msg=n)
        # the moments split over dp, the params whole; FSDP splits both
        assert mlp["zero1"][2]["moment"] == (4, 32)
        assert mlp["zero1"][2]["param"] == (16, 32)
        assert mlp["zero1"][2]["after"] == ((16, 32),)
        assert mlp["replicated"][2]["moment"] == (16, 32)
        assert mlp["fsdp"][2]["param"] == (4, 32)
        assert mlp["fsdp"][2]["moment"] == (4, 32)
        peak, total = mlp["fsdp"][2]["fsdp_peak"], \
            mlp["fsdp"][2]["model_bytes"]
        assert 0 < peak < total, (peak, total)
        # checkpoints: bitwise round trip and resharded restores
        assert res["ckpt"] == (True, True)
        ok4, ok1, split, n_split = res["reshard"]
        assert ok4 and ok1 and split > 0 and n_split > 0

    # clipping over tp and over ep against the unsharded JAX step
    for key, kw, sizes, ckey in clip_cases:
        (jl, jp), (jl0, _) = clip_refs[key]
        # the clip engages: an unclipped step moves further
        assert abs(jl0[1] - jl[1]) > 1e-4
        for res in ranks:
            losses, params, specs = res[key]
            np.testing.assert_allclose(losses, jl, atol=TOL, rtol=TOL)
            _hold_params(params, jp, specs, _Coord(sizes, res[ckey]), key)

    # sp = 4 alone
    jl, jp = sp4
    for res in ranks:
        np.testing.assert_allclose(res["sp4"][0], jl[0], atol=TOL, rtol=TOL)
        for n, v in jp.items():
            np.testing.assert_allclose(res["sp4"][1][n], v, atol=TOL,
                                       rtol=TOL, err_msg=n)

    # the fleet step at dp 2 x tp 2: one process on the whole batch
    from paddle_tpu_torch.interop import load_jax_param_dict

    m = GPT(GPTConfig(**CFG), device="cpu")
    load_jax_param_dict(m, weights["gpt"])
    params = dict(m.named_parameters())
    losses = []
    for i in range(2):
        x, y = (torch.from_numpy(a) for a in gpt_batch(30 + i))
        loss = m.loss(x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.1 * g
        losses.append(float(loss.detach()))
    for res in ranks:
        np.testing.assert_allclose(res["fleet"][0], losses, atol=TOL,
                                   rtol=TOL)
        for n, p in params.items():
            np.testing.assert_allclose(res["fleet"][1][n],
                                       p.detach().numpy(), atol=TOL,
                                       rtol=TOL, err_msg=n)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
