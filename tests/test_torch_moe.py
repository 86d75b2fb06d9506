"""The port's MoE (paddle_tpu_torch.distributed.moe) and its two collectives
(`ppermute`, `all_to_all`) against the JAX package's.

The same numpy inputs go through both packages.  Single-process cases run
here; the W = 2 cases run in two worker processes on a gloo group that
`launch.start_procs` starts with this file as their script (`python
tests/test_torch_moe.py <out dir>`, killed after 120 s; the workers import
no jax): `ppermute` and `all_to_all` and their grads against `lax.ppermute`
/ `lax.all_to_all` under shard_map on the 8-device CPU mesh,
`moe_ffn_shardmap` and `sharded_moe_ffn` at ep = 2 against the JAX forms
and the dense `moe_ffn`, and the ring at sp = 2
(tests/test_torch_ring_attention.py's cases).

Tolerances:
- `top_k_gating`: dispatch exactly (every choice and slot), combine to
  4 f32 ulps (rtol 5e-7): combine holds the router probabilities, and
  XLA's f32 dot and exp round differently from torch's on the CPU, so
  they agree to an ulp or two, not bitwise; aux atol 1e-6;
- `moe_ffn`, its forms over ep and their grads: atol = rtol = 1e-5;
- the collectives: exact (they move values).
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import moe as tmoe
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent

GATING = [  # (tokens, d_model, experts, k, capacity factor): drops or not
    (64, 32, 4, 2, 1.25), (64, 32, 4, 1, 1.0), (128, 32, 8, 2, 0.5),
    (40, 16, 4, 2, 2.0), (96, 16, 4, 1, 0.25)]


@pytest.fixture(autouse=True)
def _two_threads():
    """The tests' tensors are small: two intra-op threads, so that the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def moe_inputs(n, d, e, h, seed=0, lead=None):
    """x [n, d] (or lead + [d]), params, and the cotangent weights W."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(lead or (n,)) + (d,)).astype(np.float32)
    p = {"wg": (r.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32),
         "w1": (r.normal(size=(e, d, h)) / np.sqrt(d)).astype(np.float32),
         "w2": (r.normal(size=(e, h, d)) / np.sqrt(h)).astype(np.float32)}
    w = r.normal(size=x.shape).astype(np.float32)
    return x, p, w


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.requires_grad_() if grad else t


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", GATING, ids=str)
def test_top_k_gating_matches_reference(case):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import moe as jmoe

    n, d, e, k, cf = case
    x, p, _ = moe_inputs(n, d, e, 4 * d)
    jd, jc, ja = jax.jit(lambda x, w: jmoe.top_k_gating(
        x, w, k=k, capacity_factor=cf))(jnp.asarray(x), jnp.asarray(p["wg"]))
    td, tc, ta = tmoe.top_k_gating(_t(x), _t(p["wg"]), k=k,
                                   capacity_factor=cf)
    assert td.shape == jd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=5e-7,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)
    if cf < 1.0:
        assert float(td.sum()) < n * k          # capacity dropped some


@pytest.mark.parametrize("case", GATING, ids=str)
def test_moe_ffn_and_grads_match_reference(case):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import moe as jmoe

    n, d, e, k, cf = case
    x, p, w = moe_inputs(n, d, e, 4 * d, seed=1)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, k=k, capacity_factor=cf)
        return (y * w).sum() + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {a: jnp.asarray(b) for a, b in p.items()}, jnp.asarray(x))
    tp, tx = _t(p, True), _t(x, True)
    ty, taux = tmoe.moe_ffn(tp, tx, k=k, capacity_factor=cf)
    tg = torch.autograd.grad((ty * _t(w)).sum() + taux,
                             [tp["wg"], tp["w1"], tp["w2"], tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    want = [jg[0]["wg"], jg[0]["w1"], jg[0]["w2"], jg[1]]
    for name, g, j in zip(("wg", "w1", "w2", "x"), tg, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_routing_and_products_stay_f32_under_autocast_and_amp():
    """bf16 tokens: the router and the expert products run in f32 (the
    reference casts), whatever torch.autocast or the port's AMP say."""
    from paddle_tpu_torch import amp

    x, p, _ = moe_inputs(64, 32, 4, 128, seed=2)
    xb = _t(x).to(torch.bfloat16)
    want, aux = tmoe.moe_ffn(_t(p), xb)
    assert want.dtype == torch.bfloat16
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got, got_aux = tmoe.moe_ffn(_t(p), xb)
    assert torch.equal(got, want) and torch.equal(got_aux, aux)
    with amp.auto_cast(enable=True):
        got, got_aux = tmoe.moe_ffn(_t(p), xb)
    assert torch.equal(got, want) and torch.equal(got_aux, aux)
    # the f32 products against the reference's on the same bf16 tokens
    import jax.numpy as jnp
    from paddle_tpu.distributed import moe as jmoe

    jy, _ = jmoe.moe_ffn({a: jnp.asarray(b) for a, b in p.items()},
                         jnp.asarray(xb.float().numpy()).astype(
                             jnp.bfloat16))
    np.testing.assert_allclose(want.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2.0 ** -7, rtol=2.0 ** -7)


def test_init_moe_params_draws_from_the_generator():
    g = lambda: torch.Generator().manual_seed(3)
    a = tmoe.init_moe_params(g(), 4, 16, 64)
    b = tmoe.init_moe_params(g(), 4, 16, 64)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "wg": (16, 4), "w1": (4, 16, 64), "w2": (4, 64, 16)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["w2"].std()) - 1 / 8) < 0.01   # 1 / sqrt(64)
    assert a["w1"].dtype == torch.float32


def test_ep_forms_at_ep_1_on_a_gloo_group():
    """At ep = 1 (a one-rank gloo group) both forms over ep are
    `moe_ffn`, and the shardmap form's router check fires on
    full-expert arrays given at ep = 2."""
    from paddle_tpu_torch.distributed.env import destroy_parallel_env
    from paddle_tpu_torch.distributed.mesh import build_mesh

    mesh = build_mesh(ep=1, device="cpu")
    try:
        x, p, _ = moe_inputs(0, 16, 4, 64, seed=4, lead=(2, 8))
        want, aux = tmoe.moe_ffn(_t(p), _t(x))
        sp = tmoe.shard_moe_params(_t(p), mesh)
        for got, got_aux in (tmoe.sharded_moe_ffn(sp, _t(x), mesh),
                             tmoe.moe_ffn_shardmap(sp, _t(x), mesh=mesh)):
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
            torch.testing.assert_close(got_aux, aux)
        half = dict(_t(p), w1=_t(p["w1"][:2]), w2=_t(p["w2"][:2]))
        with pytest.raises(AssertionError, match="LOCAL"):
            tmoe.moe_ffn_shardmap(half, _t(x), mesh=mesh)
    finally:
        destroy_parallel_env()


# ---------------------------------------------------------------------------
# world 2: two worker processes on gloo
# ---------------------------------------------------------------------------

_X = np.arange(1, 49, dtype=np.float32).reshape(2, 4, 6) / 7.0
_C = np.random.default_rng(5).normal(size=(2, 4, 6)).astype(np.float32)
PERMS = {"swap": [(0, 1), (1, 0)], "one_way": [(0, 1)]}
SPLITS = [(0, 1), (1, 0)]
EP_MOE = dict(d=16, e=4, h=32, lead=(2, 8))   # per-rank tokens [2, 8]
EP_CFS = (1.25, 4.0)


def _ring2():
    from test_torch_ring_attention import ring_cases

    # the causal flash ring has past, diagonal and future blocks
    return ring_cases(2, flash_causal=(True,))


RING2 = _ring2()


def _collectives(mesh):
    """ppermute and all_to_all on rank r's X[r], and the grads of
    sum(out * C') (C' the cotangent block of the output's shape)."""
    r = mesh.axis_index("ep")
    out = {}
    for name, perm in PERMS.items():
        x = _t(_X[r], True)
        y = tcoll.ppermute(x, "ep", perm, mesh)
        (g,) = torch.autograd.grad((y * _t(_C[r])).sum(), [x])
        out[f"ppermute_{name}"] = (y.detach().numpy(), g.numpy())
    for sa, ca in SPLITS:
        x = _t(_X[r], True)
        y = tcoll.all_to_all(x, "ep", sa, ca, mesh)
        c = np.random.default_rng(6).normal(size=(2,) + tuple(y.shape))
        (g,) = torch.autograd.grad((y * _t(c[r].astype(np.float32))).sum(),
                                   [x])
        out[f"all_to_all_{sa}{ca}"] = (y.detach().numpy(), g.numpy())
    return out


def _ep_moe(mesh):
    """moe_ffn_shardmap on rank r's tokens and sharded_moe_ffn on all
    tokens, with the grads of sum(y * W) + aux."""
    r = mesh.axis_index("ep")
    out = {}
    for cf in EP_CFS:
        x, p, w = moe_inputs(0, EP_MOE["d"], EP_MOE["e"], EP_MOE["h"],
                             seed=7, lead=(4, 8))
        sp = {k: v.detach().requires_grad_()
              for k, v in tmoe.shard_moe_params(_t(p), mesh).items()}
        xr = _t(x[2 * r:2 * r + 2], True)
        y, aux = tmoe.moe_ffn_shardmap(sp, xr, k=2, capacity_factor=cf,
                                       mesh=mesh)
        g = torch.autograd.grad((y * _t(w[2 * r:2 * r + 2])).sum() + aux,
                                [sp["wg"], sp["w1"], sp["w2"], xr])
        out[f"shardmap_{cf}"] = (y.detach().numpy(), float(aux),
                                 [t.numpy() for t in g])
        xa = _t(x, True)
        y, aux = tmoe.sharded_moe_ffn(sp, xa, mesh, k=2, capacity_factor=cf)
        g = torch.autograd.grad((y * _t(w)).sum() + aux,
                                [sp["wg"], sp["w1"], sp["w2"], xa])
        out[f"sharded_{cf}"] = (y.detach().numpy(), float(aux),
                                [t.numpy() for t in g])
    return out


def _worker_main(out_dir):
    from test_torch_ring_attention import run_ring_case

    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    ep = build_mesh(ep=2)
    sp = build_mesh(sp=2)
    out = {"collectives": _collectives(ep), "moe": _ep_moe(ep),
           "ring": [run_ring_case(c, sp) for c in RING2],
           "rank": ep.axis_index("ep"), "jax_imported": "jax" in sys.modules}
    Path(out_dir, f"rank{out['rank']}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


def start_workers(script, world, tmp_path, args=()):
    """Launch `world` workers of `script` on gloo and return at once: the
    returned callable waits for them (killing them 120 s after it is
    called) and gives their pickled results.  A test computes its JAX
    references between the two, while the workers run."""
    from paddle_tpu_torch.distributed import launch as tlaunch

    env = {"PYTHONPATH": os.pathsep.join(
               [str(ROOT), str(ROOT / "tests"),
                os.environ.get("PYTHONPATH", "")]),
           "PADDLE_RENDEZVOUS_TIMEOUT": "60", "OMP_NUM_THREADS": "1"}
    procs, logs = tlaunch.start_procs(
        ["127.0.0.1"], "127.0.0.1", world, script,
        [*args, str(tmp_path)], log_dir=str(tmp_path / "logs"),
        env_extra=env)

    def wait():
        rc = tlaunch._wait(procs, logs, timeout=120)
        log = "".join((tmp_path / "logs" / f"workerlog.{r}").read_text()
                      for r in range(world))
        assert rc == 0, f"workers exited {rc}:\n{log[-4000:]}"
        ranks = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
                 for r in range(world)]
        assert not any(res["jax_imported"] for res in ranks)
        return ranks

    return wait


def run_workers(script, world, tmp_path, args=()):
    """Launch `world` workers of `script` on gloo; their pickled results."""
    return start_workers(script, world, tmp_path, args)()


def _jax_collectives():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.mesh import build_mesh

    mesh = build_mesh(ep=2, devices=jax.devices()[:2])
    X = jnp.asarray(_X.reshape(8, 6))
    want = {}

    def run(body, cot):
        f = jax.shard_map(body, mesh=mesh, in_specs=P("ep"),
                          out_specs=P("ep"), check_vma=False)
        y, g = jax.jit(lambda x: (f(x), jax.grad(
            lambda x: (f(x) * cot).sum())(x)))(X)
        return np.asarray(y), np.asarray(g)

    for name, perm in PERMS.items():
        y, g = run(lambda x: lax.ppermute(x, "ep", perm),
                   jnp.asarray(_C.reshape(8, 6)))
        want[f"ppermute_{name}"] = (y.reshape(2, 4, 6), g.reshape(2, 4, 6))
    for sa, ca in SPLITS:
        body = lambda x: lax.all_to_all(x, "ep", sa, ca, tiled=True)
        shape = jax.eval_shape(
            jax.shard_map(body, mesh=mesh, in_specs=P("ep"),
                          out_specs=P("ep"), check_vma=False), X).shape
        blk = (shape[0] // 2,) + tuple(shape[1:])
        c = np.random.default_rng(6).normal(size=(2,) + blk)
        y, g = run(body, jnp.asarray(c.reshape(shape).astype(np.float32)))
        want[f"all_to_all_{sa}{ca}"] = (y.reshape((2,) + blk),
                                        g.reshape(2, 4, 6))
    return want


def _jax_ep_moe(cf):
    """The JAX moe_ffn_shardmap at ep = 2 and the dense moe_ffn on all
    tokens: ((y, aux per rank, grads), (y, aux, grads))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed import moe as jmoe
    from paddle_tpu.distributed.mesh import build_mesh

    mesh = build_mesh(ep=2, devices=jax.devices()[:2])
    x, p, w = moe_inputs(0, EP_MOE["d"], EP_MOE["e"], EP_MOE["h"], seed=7,
                         lead=(4, 8))
    x, w = jnp.asarray(x), jnp.asarray(w)
    p = {a: jnp.asarray(b) for a, b in p.items()}
    pspec = {"wg": P(), "w1": P("ep"), "w2": P("ep")}
    f = jax.shard_map(
        lambda p, x: (lambda y, a: (y, a[None]))(*jmoe.moe_ffn_shardmap(
            p, x, "ep", k=2, capacity_factor=cf)),
        mesh=mesh, in_specs=(pspec, P("ep")), out_specs=(P("ep"), P("ep")),
        check_vma=False)

    def loss_sm(p, x):
        y, aux = f(p, x)
        return (y * w).sum() + aux.sum(), (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss_sm, argnums=(0, 1), has_aux=True))(p, x)
    shardmap = (np.asarray(y), np.asarray(aux),
                [np.asarray(g[0][n]) for n in ("wg", "w1", "w2")]
                + [np.asarray(g[1])])

    def loss_dense(p, x):
        y, aux = jmoe.moe_ffn(p, x, k=2, capacity_factor=cf)
        return (y * w).sum() + aux, (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss_dense, argnums=(0, 1), has_aux=True))(p, x)
    ys = jax.jit(lambda ps, x: jmoe.sharded_moe_ffn(
        ps, x, mesh, k=2, capacity_factor=cf)[0])(
        jmoe.shard_moe_params(p, mesh), x)
    dense = (np.asarray(y), float(aux),
             [np.asarray(g[0][n]) for n in ("wg", "w1", "w2")]
             + [np.asarray(g[1])], np.asarray(ys))
    return shardmap, dense


def test_world_2_on_gloo_matches_the_jax_mesh(tmp_path):
    from test_torch_ring_attention import check_rank, jax_ring

    wait = start_workers(__file__, 2, tmp_path)
    try:
        coll = _jax_collectives()
        ep = {cf: _jax_ep_moe(cf) for cf in EP_CFS}
        rings = [jax_ring(case, 2) for case in RING2]
    finally:
        ranks = wait()
    for r, res in enumerate(ranks):
        for name, (y, g) in coll.items():
            got_y, got_g = res["collectives"][name]
            np.testing.assert_array_equal(got_y, y[r], err_msg=name)
            np.testing.assert_array_equal(got_g, g[r], err_msg=name)
    # a rank that is no one's destination gets zeros
    assert not ranks[0]["collectives"]["ppermute_one_way"][0].any()

    for cf in EP_CFS:
        (sy, saux, sg), (dy, daux, dg, dys) = ep[cf]
        for r, res in enumerate(ranks):
            y, aux, g = res["moe"][f"shardmap_{cf}"]
            blk = slice(2 * r, 2 * r + 2)
            np.testing.assert_allclose(y, sy[blk], atol=TOL, rtol=TOL)
            np.testing.assert_allclose(aux, saux[r], atol=1e-6)
            np.testing.assert_allclose(g[3], sg[3][blk], atol=TOL, rtol=TOL)
            for i in (1, 2):                       # this rank's experts
                np.testing.assert_allclose(g[i], sg[i][blk], atol=TOL,
                                           rtol=TOL)
            y, aux, g = res["moe"][f"sharded_{cf}"]
            np.testing.assert_allclose(y, dy, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(y, dys, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(aux, daux, atol=1e-6)
            # the same loss on both ranks: x's and the router's grads
            # are the dense ones on each, not twice them
            for i in (0, 3):
                np.testing.assert_allclose(g[i], dg[i], atol=TOL, rtol=TOL)
            for i in (1, 2):
                np.testing.assert_allclose(g[i], dg[i][blk], atol=TOL,
                                           rtol=TOL)
        # the router's grad of the sum of the ranks' losses
        np.testing.assert_allclose(
            sum(res["moe"][f"shardmap_{cf}"][2][0] for res in ranks),
            sg[0], atol=TOL, rtol=TOL)
        if cf == 4.0:
            # no drops: the shardmap form is moe_ffn of each rank's tokens
            import jax.numpy as jnp
            from paddle_tpu.distributed import moe as jmoe

            x, p, _ = moe_inputs(0, EP_MOE["d"], EP_MOE["e"], EP_MOE["h"],
                                 seed=7, lead=(4, 8))
            for r, res in enumerate(ranks):
                want, _ = jmoe.moe_ffn(
                    {a: jnp.asarray(b) for a, b in p.items()},
                    jnp.asarray(x[2 * r:2 * r + 2]), k=2, capacity_factor=cf)
                np.testing.assert_allclose(res["moe"][f"shardmap_{cf}"][0],
                                           np.asarray(want), atol=TOL,
                                           rtol=TOL)

    for i, (case, ref) in enumerate(zip(RING2, rings)):
        for r, res in enumerate(ranks):
            check_rank(res["ring"][i], ref, case, 2, r)


if __name__ == "__main__":
    _worker_main(sys.argv[1])
