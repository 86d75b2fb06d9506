"""The port's data-parallel tier (paddle_tpu_torch.distributed) against the
JAX package's.

Both packages get the same weights (carried over as numpy arrays with
`paddle_tpu_torch.interop`) and the same numpy batches, and take 3 steps:
`DataParallelTrainStep`, `DGCTrainStep` (the mask from `torch.topk` or,
under FLAGS_use_pallas_dgc_topk, from K10's plain version) and
`LocalSGDTrainStep`.  The JAX steps run on `build_mesh(dp=W)` of the
8-device CPU mesh; the port's on a gloo process group of W ranks:

- W = 1 in this process;
- W = 2 in two worker processes that `launch.start_procs` starts with
  this file as their script (`python tests/test_torch_distributed.py
  <case file> <out dir>`).  The workers import no `jax`; rank r's params,
  buffers and DGC state are held against the JAX mesh's shard r.  The
  workers use free ports from `find_free_ports`, a rendezvous bounded by
  PADDLE_RENDEZVOUS_TIMEOUT, one thread each, and are killed after 120 s.

Tolerances (atol = rtol unless said):
- losses: f32 1e-5, bf16 3e-2;
- params, f32: 1e-5; bf16: tests/test_torch_train.py's rule, atol 2 lr k
  + 1e-5 plus 2 bf16 ulps of the largest |param| (the JAX package rounds
  a Python-float momentum and lr to bf16 before it multiplies; the port
  multiplies in f32 and rounds once);
- DGC state u, v and the dense velocity: f32 1e-5; bf16 3e-2 of each
  tensor in norm (u and v accumulate grads that the two frameworks round
  at other places, and v = v + u cancels: an element can be off by a
  few % of the tensor's scale after 3 steps);
- the DGC masks: exact.  The port records its mask at every step; the
  reference's mask is read off the reference's own trajectory, as the
  elements whose v is 0 after its step (a sent element is cleared from
  v).  An element whose port |v| lies within the tolerance of 0 is not
  compared, as a 0 there does not tell a sent element from one that was
  0.  Across the two frameworks, f32 noise can swap the k-th and
  (k+1)-th |v| when they lie within the tolerance of each other; then
  that tensor's state and param may differ where the masks do.  Each such exception is counted
  and reported, and at most one near-tie per tensor is allowed (one
  element on the histogram path; the swapped pair, two elements, on the
  exact path), only where the port's k-th and (k+1)-th |v| (or, under
  the flag, an element and the threshold) lie within the tolerance.
"""

import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed import strategies as tstrat
from paddle_tpu_torch.distributed.data_parallel import DataParallelTrainStep
from paddle_tpu_torch.distributed.env import (
    destroy_parallel_env, init_parallel_env,
)
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.interop import (
    load_jax_buffer_dict, load_jax_param_dict,
)
from paddle_tpu_torch.optimizer import functional as topt

LR, MOMENTUM, STEPS = 0.05, 0.9, 3
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# models, data, steps (the port's side imports no jax: the workers use it)
# ---------------------------------------------------------------------------

def _steps(case):
    return case.get("steps", STEPS)


def _data(model, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    if model == "resnet":
        xs = [rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
              for _ in range(steps)]
        ys = [rng.integers(0, 10, (4,)).astype(np.int32)
              for _ in range(steps)]
        return list(zip(xs, ys))
    w = rng.normal(size=(8, 1)).astype(np.float32)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=(32, 1))).astype(np.float32)
    return [(x, y)] * steps


def _port_model(model, dtype):
    kw = dict(dtype=dtype, device="cpu")
    if model == "resnet":
        from paddle_tpu_torch.models import resnet as TR

        return TR.ResNet(TR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                         data_format="NHWC", **kw)
    layers = [tnn.Linear(8, 8, act="relu", **kw)]
    if model == "bn":
        layers.append(tnn.BatchNorm(8, **kw))
    return tnn.Sequential(*layers, tnn.Linear(8, 1, **kw))


def _port_loss(model):
    if model == "resnet":
        return lambda m, x, y: tnn.functional.cross_entropy(m(x), y).mean()
    return lambda m, x, y: ((m(x) - y) ** 2).mean()


def _port_batch(batch, dtype):
    x, y = batch
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    y = torch.from_numpy(y)
    return (x, y.to(x.dtype) if y.dtype == torch.float32 else y)


def _port_step(case, model, mesh):
    loss = _port_loss(case["model"])
    lr = case.get("lr", LR)
    if case["kind"] == "dp":
        return DataParallelTrainStep(model, topt.Momentum(lr, MOMENTUM),
                                     loss, mesh)
    if case["kind"] == "dgc":
        return tstrat.DGCTrainStep(model, loss, mesh, lr=lr,
                                   momentum=MOMENTUM,
                                   sparsity=case["sparsity"],
                                   rampup_begin_step=case.get("rampup", 0))
    return tstrat.LocalSGDTrainStep(model, topt.SGD(lr), loss, mesh,
                                    local_sgd_steps=case["k"])


def _run_port(case, weights, mesh):
    """3 steps of the port; returns losses, params, buffers, and for DGC
    the state and, per step, each tensor's v and mask."""
    dtype = case["dtype"]
    model = _port_model(case["model"], dtype)
    load_jax_param_dict(model, weights["params"])
    if weights["buffers"]:
        load_jax_buffer_dict(model, weights["buffers"])
    step = _port_step(case, model, mesh)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    f32 = lambda t: t.detach().float().numpy().copy()
    tflags.set_flags({"FLAGS_use_pallas_dgc_topk": case.get("flag", False)})
    losses, masks = [], []
    real = tstrat.dgc_topk_mask

    def recording(v, sparsity):
        m = real(v, sparsity)
        masks[-1][names[len(masks[-1])]] = (f32(v), f32(m))
        return m

    tstrat.dgc_topk_mask = recording
    try:
        for batch in _data(case["model"], _steps(case)):
            masks.append({})
            losses.append(float(step(*_port_batch(batch, dtype))))
    finally:
        tstrat.dgc_topk_mask = real
        tflags.set_flags({"FLAGS_use_pallas_dgc_topk": False})
    out = {"losses": np.array(losses),
           "params": {n: f32(p) for n, p in model.named_parameters()},
           "buffers": {n: f32(b) for n, b in model.named_buffers()}}
    if case["kind"] == "dgc":
        out["state"] = {k: {n: f32(t) for n, t in d.items()}
                        for k, d in zip(("u", "v", "vel"), step._state)}
        out["masks"] = masks
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_model(model, dtype):
    from paddle_tpu import nn as jnn
    from paddle_tpu.models import resnet as JR

    np.random.seed(0)
    jnn.seed(0)     # the weights do not depend on what ran before
    if model == "resnet":
        return JR.ResNet(JR.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                         data_format="NHWC", dtype=dtype)
    layers = [jnn.Linear(8, 8, act="relu", dtype=dtype)]
    if model == "bn":
        layers.append(jnn.BatchNorm(8, dtype=dtype))
    return jnn.Sequential(*layers, jnn.Linear(8, 1, dtype=dtype))


def _f32(a):
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _weights(jm):
    return {"params": {n: np.asarray(p.value)
                       for n, p in jm.named_parameters()},
            "buffers": {n: np.asarray(b) for n, b in jm.named_buffers()}}


def _run_jax(case, jm, world):
    import jax.numpy as jnp

    from paddle_tpu import flags as jflags
    from paddle_tpu.distributed import strategies as jstrat
    from paddle_tpu.distributed.data_parallel import (
        DataParallelTrainStep as JDP,
    )
    from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
    from paddle_tpu.dygraph import SGD, Momentum
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.nn.layers import buffer_dict

    mesh = jbuild_mesh(dp=world)
    if case["model"] == "resnet":
        loss = lambda m, x, y: JF.cross_entropy(m(x), y).mean()
    else:
        loss = lambda m, x, y: ((m(x) - y) ** 2).mean()
    lr = case.get("lr", LR)
    if case["kind"] == "dp":
        step = JDP(jm, Momentum(lr, MOMENTUM, parameter_list=jm.parameters()),
                   loss, mesh)
    elif case["kind"] == "dgc":
        step = jstrat.DGCTrainStep(jm, loss, mesh, lr=lr, momentum=MOMENTUM,
                                   sparsity=case["sparsity"],
                                   rampup_begin_step=case.get("rampup", 0))
    else:
        step = jstrat.LocalSGDTrainStep(
            jm, SGD(lr, parameter_list=jm.parameters()), loss, mesh,
            local_sgd_steps=case["k"])
    dt = getattr(jnp, case["dtype"])
    def shard(a, r):
        return _f32(a.addressable_shards[r].data)

    jflags.set_flags({"FLAGS_use_pallas_dgc_topk": case.get("flag", False)})
    try:
        losses, vsteps = [], []
        for i, (x, y) in enumerate(_data(case["model"], _steps(case))):
            y = jnp.asarray(y, dt) if y.dtype == np.float32 else y
            losses.append(float(step(jnp.asarray(x, dt), y)))
            if case["kind"] == "dgc" and i >= case.get("rampup", 0):
                # each rank's v after the step: 0 where the mask sent it
                vsteps.append([{n: shard(t, r) for n, t in
                                step._state[1].items()}
                               for r in range(world)])
    finally:
        jflags.set_flags({"FLAGS_use_pallas_dgc_topk": False})

    ranks = []
    for r in range(world):
        out = {"losses": np.array(losses)}
        if case["kind"] == "localsgd":
            params_st, buf_st, _, _ = step._state
            out["params"] = {n: _f32(p[r]) for n, p in params_st.items()}
            out["buffers"] = {n: _f32(b[r]) for n, b in buf_st.items()}
        else:
            out["params"] = {n: _f32(p.value)
                             for n, p in jm.named_parameters()}
            out["buffers"] = {n: _f32(b)
                              for n, b in buffer_dict(jm).items()}
        if case["kind"] == "dgc":
            out["state"] = {k: {n: shard(t, r) for n, t in d.items()}
                            for k, d in zip(("u", "v", "vel"),
                                            step._state[:3])}
            out["vsteps"] = [v[r] for v in vsteps]
        ranks.append(out)
    return ranks


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _ulps2(a):
    return 2 * float(np.abs(a).max()) * 2.0 ** -7


def _boundary(v, sparsity, flag):
    """The port's threshold for v: K10's histogram edge under the flag,
    else the exact k-th largest |v|."""
    k = max(1, int(round(v.size * (1.0 - sparsity))))
    if flag:
        from paddle_tpu_torch.kernels.topk_threshold import topk_threshold

        return float(topk_threshold(torch.from_numpy(v), k))
    return float(np.sort(np.abs(v).reshape(-1))[-k])


def _mask_exceptions(case, port, ref, tols):
    """Compare the port's mask at every DGC step with the reference's
    (where the reference's v after the step is 0 and the port's v is
    not within the tolerance of 0, it was sent).  Each
    tensor may differ in one near-tie per step: an element whose |v| lies
    within the tolerance of the port's threshold, one element on the
    histogram path, the swapped k-th and (k+1)-th (two) on the exact
    path.  Returns name -> the elements that differed (flat indices)."""
    per_tie = 1 if case.get("flag") else 2
    flipped = {}
    for t, (mine, theirs) in enumerate(zip(
            [m for m in port["masks"] if m], ref["vsteps"])):
        for n, (v, mask) in mine.items():
            sent = mask.reshape(-1) > 0
            # where v is within the tolerance of 0, a 0 after the step
            # does not tell a sent element from one that was 0
            atol, rtol = tols(v)
            care = np.abs(v.reshape(-1)) > atol
            diff = np.flatnonzero(care & (sent != (theirs[n].reshape(-1)
                                                  == 0)))
            # an element that differed at an earlier step has its own v
            # on each side since
            diff = np.setdiff1d(diff, list(flipped.get(n, ())))
            if not diff.size:
                continue
            b = _boundary(v, case["sparsity"], case.get("flag"))
            near = np.isclose(np.abs(v.reshape(-1)[diff]), b, atol=atol,
                              rtol=rtol)
            assert diff.size <= per_tie and near.all(), (
                f"{case} step {t} mask of {n}: {diff.size} elements "
                f"differ, |v| {np.abs(v.reshape(-1)[diff])} vs threshold "
                f"{b:.6e}")
            flipped.setdefault(n, set()).update(diff.tolist())
    return flipped


def _compare(case, port, ref, start, rank=0):
    """Hold one rank's port results against the JAX results; returns the
    near-tie exceptions, name -> elements.

    MLPs: elementwise, f32 1e-5 (params, u, v, vel) and bf16 as the
    module docstring says.  The ResNet (f32 only) takes one step: its
    grads agree to ~2e-4 of each tensor's largest |grad| (f32 sums
    through ~20 layers in another order), so u, v and each param's
    update are held elementwise to 1e-3 of the tensor's largest |value|,
    and the loss to 1e-5.  Later steps are not held: an element that
    this noise carries across the threshold is sent on one side only,
    its u and v then differ by its whole value, and the next steps' grads
    and thresholds move with it, so two trajectories part by
    construction (measured: 4e-3 apart in loss at step 3).  The elements
    a near-tie sent on one side only are left out of the elementwise
    comparisons (they are counted and reported)."""
    dtype, resnet = case["dtype"], case["model"] == "resnet"
    tol = TOL[dtype]
    np.testing.assert_allclose(port["losses"], ref["losses"], atol=tol,
                               rtol=tol, err_msg=f"{case} losses")

    def tols(want):
        if resnet:
            return 1e-3 * float(np.abs(want).max()) + 1e-12, 0.0
        if dtype == "float32":
            return 1e-5, 1e-5
        return _ulps2(want) + 1e-8, TOL[dtype]

    flipped = (_mask_exceptions(case, port, ref, tols)
               if case["kind"] == "dgc" else {})
    if flipped:
        print(f"near-tie exceptions, {case}, rank {rank}: "
              f"{ {n: len(e) for n, e in flipped.items()} }")

    def hold(what, n, got, want, atol, rtol):
        bad = ~np.isclose(got, want, atol=atol, rtol=rtol).reshape(-1)
        bad[list(flipped.get(n, ()))] = False
        assert not bad.any(), (
            f"{case} rank {rank} {what} {n}: {int(bad.sum())} elements "
            f"off, max {np.abs(got - want).reshape(-1)[bad].max():.3e}")

    def hold_norm(what, n, got, want):
        keep = np.ones(want.size, bool)
        keep[list(flipped.get(n, ()))] = False
        off = np.linalg.norm((got - want).reshape(-1)[keep])
        scale = np.linalg.norm(want.reshape(-1)[keep])
        assert off <= TOL[dtype] * scale + 1e-6, (
            f"{case} rank {rank} {what} {n}: off {off:.3e} in norm, "
            f"scale {scale:.3e}")

    lr = case.get("lr", LR)
    top = _ulps2(np.concatenate([p.reshape(-1)
                                 for p in ref["params"].values()]))
    for n, want in ref["params"].items():
        got = port["params"][n]
        if resnet:
            p0 = _f32(start[n])
            hold("param", n, got - p0, want - p0, *tols(want - p0))
        elif dtype == "float32":
            hold("param", n, got, want, 1e-5, 1e-5)
        else:
            # tests/test_torch_train.py's rule
            hold("param", n, got, want, 2 * lr * _steps(case) + 1e-5 + top,
                 0.0)
    for n, b in ref["buffers"].items():
        np.testing.assert_allclose(port["buffers"][n], b, atol=tol,
                                   rtol=tol, err_msg=f"{case} buffer {n}")
    if case["kind"] == "dgc":
        for k in ("u", "v", "vel"):
            for n, want in ref["state"][k].items():
                if dtype == "bfloat16":
                    hold_norm(k, n, port["state"][k][n], want)
                else:
                    hold(k, n, port["state"][k][n], want, *tols(want))
    return flipped


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    mesh = build_mesh(dp=1, device="cpu")
    yield mesh
    destroy_parallel_env()


def _case_id(c):
    parts = [c["model"], c["kind"], c["dtype"]]
    if c["kind"] == "dgc":
        parts += [f"s{c['sparsity']}", "k10" if c.get("flag") else "topk"]
        if c.get("rampup"):
            parts.append(f"rampup{c['rampup']}")
    if c["kind"] == "localsgd":
        parts.append(f"k{c['k']}")
    return "-".join(parts)


_F32, _BF16 = "float32", "bfloat16"
WORLD1 = (
    [dict(model="toy", kind="dp", dtype=_F32)]
    + [dict(model="toy", kind="dgc", dtype=_F32, sparsity=s, flag=f)
       for s in (0.0, 0.5, 0.999) for f in (False, True)]
    + [dict(model="toy", kind="dgc", dtype=_F32, sparsity=0.5, flag=True,
            rampup=2),
       dict(model="toy", kind="localsgd", dtype=_F32, k=1),
       dict(model="toy", kind="localsgd", dtype=_F32, k=2),
       dict(model="toy", kind="dp", dtype=_BF16),
       dict(model="toy", kind="dgc", dtype=_BF16, sparsity=0.5, flag=False),
       dict(model="toy", kind="dgc", dtype=_BF16, sparsity=0.5, flag=True),
       dict(model="bn", kind="dp", dtype=_F32),
       dict(model="bn", kind="dgc", dtype=_F32, sparsity=0.5, flag=True),
       dict(model="bn", kind="localsgd", dtype=_F32, k=2),
       # the slice's path: DGC on K10 at the ResNet-50 recipe's sparsity,
       # one step (see _compare)
       dict(model="resnet", kind="dgc", dtype=_F32, sparsity=0.999,
            flag=True, steps=1)])


@pytest.mark.parametrize("case", WORLD1, ids=_case_id)
def test_steps_match_reference_at_world_1(case, mesh1):
    jm = _jax_model(case["model"], case["dtype"])
    weights = _weights(jm)
    port = _run_port(case, weights, mesh1)
    ref = _run_jax(case, jm, 1)[0]
    if case["kind"] == "dgc":
        n_dgc = _steps(case) - case.get("rampup", 0)
        assert len([m for m in port["masks"] if m]) == n_dgc
    _compare(case, port, ref, weights["params"])
    assert all(np.isfinite(port["losses"]))


def test_dgc_sparsity_zero_is_dense_sgd(mesh1):
    """Sparsity 0 selects every entry, so u and v drain each step and
    the update is the raw gradient: DP with plain SGD."""
    weights = _weights(_jax_model("toy", _F32))
    dgc = _run_port(dict(model="toy", kind="dgc", dtype=_F32,
                         sparsity=0.0), weights, mesh1)
    sgd = _run_port(dict(model="toy", kind="localsgd", dtype=_F32, k=1),
                    weights, mesh1)
    np.testing.assert_allclose(dgc["losses"], sgd["losses"], rtol=1e-6)
    for k in ("u", "v"):
        assert all(not t.any() for t in dgc["state"][k].values())


def test_fleet_make_train_step_picks_the_step(mesh1):
    """Each DistributedStrategy knob selects its step; use_dgc reads lr
    and momentum from the optimizer."""
    model = _port_model("toy", _F32)
    loss = _port_loss("toy")
    x, y = _data("toy")[0]

    def make(opt, **knobs):
        s = tfleet.DistributedStrategy()
        for k, v in knobs.items():
            setattr(s, k, v)
        return tfleet.make_train_step(
            model, tfleet.distributed_optimizer(opt, s), loss)

    step = make(topt.Momentum(0.02, 0.8), use_dgc=True, dgc_sparsity=0.5,
                dgc_rampup_begin_step=1, dp_degree=1)
    assert isinstance(step, tstrat.DGCTrainStep)
    assert (step._lr, step._m, step._sparsity, step._rampup) == \
        (0.02, 0.8, 0.5, 1)
    assert tfleet.get_strategy().use_dgc
    step = make(topt.SGD(0.03), use_dgc=True)
    assert (step._lr, step._m) == (0.03, 0.9)
    with pytest.raises(ValueError, match="use_dgc"):
        make(topt.AdamW(1e-3), use_dgc=True)
    with pytest.raises(ValueError, match="use_dgc"):
        make(topt.Momentum(lambda s: 0.1), use_dgc=True)
    step = make(topt.SGD(0.05), use_local_sgd=True, local_sgd_steps=2)
    assert isinstance(step, tstrat.LocalSGDTrainStep) and step._k == 2
    step = make(topt.SGD(0.05))
    assert isinstance(step, DataParallelTrainStep)
    # amp runs the loss under amp.auto_cast (tests/test_torch_amp.py holds
    # it against the reference's)
    step = make(topt.SGD(0.05), amp=True)
    assert isinstance(step, DataParallelTrainStep)
    with pytest.raises(NotImplementedError, match="item 8"):
        make(topt.SGD(0.05), tp_degree=2)
    # the save facades write through io on the first worker
    # (tests/test_torch_io.py holds io's files against the reference's)
    saved = []
    import paddle_tpu_torch.io as tio
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tio, "save_persistables",
                   lambda exe, d, main_program=None: saved.append(d) or d)
        assert tfleet.save_persistables(None, "x") == "x"
    assert saved == ["x"]
    # recompute wraps the loss in torch.utils.checkpoint: same losses as
    # the plain step from the same weights, BN buffers updated once
    weights = _weights(_jax_model("bn", _F32))
    runs = []
    for recompute in (False, True):
        m = _port_model("bn", _F32)
        load_jax_param_dict(m, weights["params"])
        opt = topt.Momentum(LR, MOMENTUM)
        s = tfleet.DistributedStrategy()
        s.recompute = recompute
        step = tfleet.make_train_step(m, tfleet.distributed_optimizer(opt, s),
                                      _port_loss("bn"))
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                  for _ in range(2)]
        runs.append((losses, {n: b.clone() for n, b in m.named_buffers()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for n, b in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][n], b, rtol=1e-6, atol=1e-7)
    assert tfleet.worker_num() == 1 and tfleet.is_first_worker()


def test_batch_must_divide_and_unported_axes_raise(mesh1):
    step = DataParallelTrainStep(_port_model("toy", _F32), topt.SGD(LR),
                                 _port_loss("toy"), mesh1)
    x, y = _data("toy")[0]
    assert np.isfinite(float(step(torch.from_numpy(x), torch.from_numpy(y))))
    with pytest.raises(ValueError, match="mesh needs dp=2"):
        build_mesh(dp=2)
    for kw in ({"tp": 2}, {"pp": 2}, {"sp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError, match="item 8"):
            build_mesh(**kw)
    from paddle_tpu_torch.distributed import data_parallel, mesh
    for fn in (lambda: mesh.build_rule_mesh({"dp": 1}),
               lambda: mesh.mesh_key(mesh1), lambda: mesh.MeshLayout(mesh1),
               lambda: tcoll.ppermute(torch.zeros(2), "dp", [(0, 0)]),
               lambda: tcoll.all_to_all(torch.zeros(2), "dp", 0, 0)):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn()
    with pytest.raises(NotImplementedError, match="item 10"):
        data_parallel.DataParallel(None)
    with pytest.raises(NotImplementedError, match="item 8"):
        tcoll.psum(torch.zeros(2), "tp")


def test_entry_points_default_to_the_card():
    """Without `device`, the rendezvous asks for a card (NCCL): on a host
    without one the device it picks raises instead of being the CPU."""
    from paddle_tpu_torch.distributed import env

    if torch.cuda.is_available():
        assert env._device_of(None, 0).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        env._device_of(None, 0)
    assert env._device_of("cpu", 0).type == "cpu"


# ---------------------------------------------------------------------------
# world 2: two worker processes on gloo
# ---------------------------------------------------------------------------

WORLD2 = [dict(model="toy", kind="dp", dtype=_F32),
          dict(model="toy", kind="dgc", dtype=_F32, sparsity=0.5,
               flag=True),
          dict(model="toy", kind="dgc", dtype=_F32, sparsity=0.999,
               flag=False, rampup=1),
          dict(model="bn", kind="dgc", dtype=_F32, sparsity=0.5,
               flag=False),
          dict(model="bn", kind="localsgd", dtype=_F32, k=2)]

# inputs of the collectives check: rank r's tensor is X[r]
_COLL_X = np.arange(1, 25, dtype=np.float32).reshape(2, 4, 3) / 7.0


def _collectives(rank, world):
    """The collectives on rank `rank`'s tensor; results as numpy."""
    x = torch.from_numpy(_COLL_X[rank].copy())
    g = torch.from_numpy(_COLL_X.reshape(8, 3).copy())   # a global array
    out = {op: tcoll.all_reduce(x, op=op).numpy()
           for op in ("sum", "mean", "max", "min", "prod")}
    out["pmean"] = tcoll.pmean(x).numpy()
    out["gather"] = tcoll.all_gather(x).numpy()
    out["gather_stacked"] = tcoll.all_gather(x, axis=1, tiled=False).numpy()
    out["reduce_scatter"] = tcoll.reduce_scatter(x).numpy()
    out["broadcast"] = tcoll.broadcast(x, root=1).numpy()
    out["eager_all_reduce"] = tcoll.eager_all_reduce(g).numpy()
    out["eager_all_gather"] = tcoll.eager_all_gather(g).numpy()
    out["eager_reduce_scatter"] = tcoll.eager_reduce_scatter(g).numpy()
    out["eager_broadcast"] = tcoll.eager_broadcast(g, root=1).numpy()
    assert torch.equal(x, torch.from_numpy(_COLL_X[rank]))  # not modified
    return out


def _worker_main(case_file, out_dir):
    """One rank of the world-2 run: the cases' port steps and the
    collectives, results pickled to <out_dir>/rank<r>.pkl."""
    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    mesh = build_mesh(dp=2)
    spec = json.loads(Path(case_file).read_text())
    weights = pickle.loads(Path(spec["weights"]).read_bytes())
    # the port's probe modules load without jax too
    import paddle_tpu_torch.kernels.fused_probe  # noqa: F401
    import paddle_tpu_torch.tools.fused_probe  # noqa: F401
    import paddle_tpu_torch.tools.near_ties  # noqa: F401
    out = {"cases": [_run_port(case, w, mesh)
                     for case, w in zip(spec["cases"], weights)],
           "collectives": _collectives(mesh.rank, mesh.size),
           "jax_imported": "jax" in sys.modules}
    Path(out_dir, f"rank{mesh.rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


def test_world_2_on_gloo_matches_the_jax_mesh(tmp_path):
    jms = [_jax_model(c["model"], c["dtype"]) for c in WORLD2]
    weights = [_weights(jm) for jm in jms]
    (tmp_path / "weights.pkl").write_bytes(pickle.dumps(weights))
    spec = tmp_path / "cases.json"
    spec.write_text(json.dumps({"cases": WORLD2,
                                "weights": str(tmp_path / "weights.pkl")}))
    env = {"PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")]),
           "PADDLE_RENDEZVOUS_TIMEOUT": "60", "OMP_NUM_THREADS": "1"}
    procs, logs = tlaunch.start_procs(
        ["127.0.0.1"], "127.0.0.1", 2, __file__,
        [str(spec), str(tmp_path)], log_dir=str(tmp_path / "logs"),
        env_extra=env)
    rc = tlaunch._wait(procs, logs, timeout=120)
    log = "".join((tmp_path / "logs" / f"workerlog.{r}").read_text()
                  for r in range(2))
    assert rc == 0, f"workers exited {rc}:\n{log[-4000:]}"
    ranks = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
             for r in range(2)]

    for r, res in enumerate(ranks):
        assert not res["jax_imported"]
        want = {"sum": _COLL_X.sum(0), "mean": _COLL_X.mean(0),
                "max": _COLL_X.max(0), "min": _COLL_X.min(0),
                "prod": _COLL_X.prod(0), "pmean": _COLL_X.mean(0),
                "gather": _COLL_X.reshape(8, 3),
                "gather_stacked": np.stack(list(_COLL_X), 1),
                "reduce_scatter": _COLL_X.sum(0)[2 * r:2 * r + 2],
                "broadcast": _COLL_X[1],
                "eager_all_reduce": np.concatenate([_COLL_X.sum(0)] * 2),
                "eager_all_gather": _COLL_X.reshape(8, 3),
                "eager_reduce_scatter": _COLL_X.sum(0),
                "eager_broadcast": np.concatenate([_COLL_X[1]] * 2)}
        for k, w in want.items():
            np.testing.assert_allclose(res["collectives"][k], w, rtol=1e-6,
                                       err_msg=f"rank {r} {k}")

    for i, (case, jm) in enumerate(zip(WORLD2, jms)):
        refs = _run_jax(case, jm, 2)
        for r in range(2):
            _compare(case, ranks[r]["cases"][i], refs[r],
                     weights[i]["params"], rank=r)
        if case["kind"] == "dgc":
            # the state is per rank: the two ranks' v differ
            v0 = ranks[0]["cases"][i]["state"]["v"]
            assert any(not np.array_equal(v0[n], v1)
                       for n, v1 in refs[1]["state"]["v"].items())


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
