"""The port's entry points (port of `__graft_entry__.entry()` and
`dryrun_multichip`).

`entry(device=None) -> (fwd, (params, input_ids))`: the forward of the
flagship GPT (vocab 8192, hidden 256, 4 layers, 8 heads, max_seq_len
256) in eval mode, as a function of its parameter dict, with an example
batch of zeros [4, 256] (int32).  `fwd(params, input_ids)` returns the
logits [4, 256, 8192].

The flagship's head_dim is 256 / 8 = 32, outside the flash kernels'
envelope (64/128/256), so this forward takes the eager attention on the
card too; its LayerNorms (D = 256) run through K4.
"""

import torch

from .core.place import resolve_device
from .models.gpt import GPT, GPTConfig
from .nn.layers import functional_call, param_dict


def _flagship(vocab=8192, hidden=256, layers=4, heads=8, seq=256,
              dtype="float32", device=None):
    return GPT(GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_layers=layers, num_heads=heads,
                         max_seq_len=seq, dtype=dtype), device=device)


def entry(device=None):
    """Forward of the flagship GPT on `device` (default `cuda`)."""
    device = resolve_device(device)
    model = _flagship(device=device)
    model.eval()
    params = param_dict(model)

    def fwd(params, input_ids):
        return functional_call(model, params, input_ids)

    input_ids = torch.zeros((4, 256), dtype=torch.int32, device=device)
    return fwd, (params, input_ids)


def _factor_mesh(n):
    """n ranks over (dp, sp, tp): tp first, then sp, the rest dp (the
    reference's `__graft_entry__._factor_mesh`)."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 and rem >= 2 else 1
    rem //= sp
    return rem, sp, tp


def _close(a, b, rtol, what):
    if not abs(float(a) - float(b)) <= rtol * max(1.0, abs(float(b))):
        raise AssertionError(f"{what}: {float(a)} != {float(b)}")


def dryrun_rank(n_devices, device=None):
    """One rank of `dryrun_multichip`: the checks of the reference's
    `__graft_entry__.dryrun_multichip`, in its order, on this process
    group.  Returns {check: loss} (the same on every rank)."""
    import numpy as np
    import torch.distributed as dist

    from .distributed.env import init_parallel_env
    from .distributed.mesh import build_mesh
    from .distributed.moe import (
        init_moe_params, moe_ffn, shard_moe_params, sharded_moe_ffn)
    from .distributed.pipeline import (
        build_gpt_pipeline, build_gpt_pipeline_3d, interleave_stack_params,
        interleaved_gpipe, pipeline_dryrun, stage_params, value_and_grad)
    from .distributed.sharded import (
        P, gpt_rules, make_sharded_train_step, shard_batch)
    from .models.train import init_train_state, make_train_step
    from .nn import make_generator
    from .optimizer.functional import AdamW

    init_parallel_env(device)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun of {n_devices} ranks in a world of "
                         f"{dist.get_world_size()}")
    out = {}
    dp, sp, tp = _factor_mesh(n_devices)
    mesh = build_mesh(dp=dp, tp=tp, sp=sp, device=device)
    dev = mesh.device

    def flagship():
        return _flagship(vocab=512, hidden=64, layers=2, heads=4,
                         seq=8 * sp, device=dev).to(dev)

    batch = max(2, 2 * dp)
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 512, (batch, 8 * sp)), dtype=torch.int32, device=dev)
    y = torch.as_tensor(np.random.default_rng(1).integers(
        0, 512, (batch, 8 * sp)), dtype=torch.int32, device=dev)
    ref = flagship()
    opt = AdamW(1e-3)
    _, want = make_train_step(ref, opt)(init_train_state(ref, opt), x, y)
    xs, ys = shard_batch(mesh, x, y)
    for name, zero1 in (("sharded", False), ("zero1", True)):
        # the sharded step on dp x sp x tp, then with ZeRO-1: finite and
        # the unsharded step's loss
        step, state = make_sharded_train_step(flagship(), AdamW(1e-3), mesh,
                                              rules=gpt_rules(), zero1=zero1)
        state, loss = step(state, xs, ys)
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{name} dryrun loss is not finite")
        _close(loss, want, 1e-4, f"{name} step loss vs unsharded")
        out[name] = float(loss)

    # expert parallelism over dp x ep: the sharded MoE FFN is the dense one
    ep = n_devices if n_devices < 4 else n_devices // 2
    ep_mesh = build_mesh(dp=n_devices // ep, ep=ep, device=device)
    moe_p = init_moe_params(make_generator(0, dev), ep, 16, 32)
    moe_x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 8, 16)), dtype=torch.float32, device=dev)
    y_dense, _ = moe_ffn(moe_p, moe_x, k=2)
    y_sh, _ = sharded_moe_ffn(shard_moe_params(moe_p, ep_mesh), moe_x,
                              ep_mesh, k=2)
    if not torch.allclose(y_sh, y_dense, atol=1e-5):
        raise AssertionError("expert-parallel MoE diverged from dense")

    if n_devices >= 4:
        # dp x pp with dropout (per-tick generator streams)
        pp = 4 if n_devices >= 8 else 2
        out["pipeline"] = pipeline_dryrun(
            n_devices, pp=pp, dropout=0.1,
            mesh=build_mesh(dp=n_devices // pp, pp=pp, device=device))

    if n_devices >= 8:
        from .models.gpt import GPT, GPTConfig

        def small(layers):
            return GPT(GPTConfig(vocab_size=256, hidden_size=32,
                                 num_layers=layers, num_heads=4,
                                 max_seq_len=16), device=dev,
                       generator=make_generator(0))

        r3 = np.random.default_rng(3)
        x3 = torch.as_tensor(r3.integers(0, 256, (8, 16)),
                             dtype=torch.int32, device=dev)
        y3 = torch.as_tensor(r3.integers(0, 256, (8, 16)),
                             dtype=torch.int32, device=dev)
        # dp x tp x pp in one mesh: the single-device loss
        mesh3d = build_mesh(dp=2, tp=2, pp=n_devices // 4, device=device)
        m3 = small(max(2, n_devices // 4))
        apply3d, p3 = build_gpt_pipeline_3d(m3, mesh3d, num_microbatches=2)
        b3 = shard_batch(mesh3d, x3, y3, spec=P("dp"))
        loss3d, _ = value_and_grad(apply3d, mesh3d)(p3, *b3)
        with torch.no_grad():
            ref3d = m3.loss(x3, y3)
        _close(loss3d, ref3d, 1e-4, "3D-composed loss")
        out["3d"] = float(loss3d)

        # the interleaved schedule (V = 2): the same loss (the
        # reference's 4-device dp 2 x pp 2 mesh is the whole world here:
        # dp = n/2)
        mesh_il = build_mesh(dp=n_devices // 2, pp=2, device=device)
        m_il = small(4)
        apply_il, p_il = build_gpt_pipeline(m_il, mesh_il,
                                            num_microbatches=2,
                                            interleave=2)
        b_il = shard_batch(mesh_il, x3, y3, spec=P("dp"))
        loss_il, _ = value_and_grad(apply_il, mesh_il)(p_il, *b_il)
        with torch.no_grad():
            ref_il = m_il.loss(x3, y3)
        _close(loss_il, ref_il, 1e-4, "interleaved loss")
        out["interleaved"] = float(loss_il)

        # pp x ep in one program: an interleaved pipeline of
        # expert-parallel MoE blocks (dp replicates) against the dense
        # serial stack
        from .distributed.moe import moe_ffn_shardmap

        S, V, E, D, H = 2, 2, 4, 8, 16
        rblk = np.random.default_rng(4)
        blocks = [{
            "wg": torch.as_tensor(rblk.standard_normal((D, E)) * 0.3,
                                  dtype=torch.float32, device=dev),
            "w1": torch.as_tensor(rblk.standard_normal((E, D, H)) * 0.2,
                                  dtype=torch.float32, device=dev),
            "w2": torch.as_tensor(rblk.standard_normal((E, H, D)) * 0.2,
                                  dtype=torch.float32, device=dev),
        } for _ in range(S * V)]
        xe = torch.as_tensor(rblk.standard_normal((8, D)),
                             dtype=torch.float32, device=dev)
        he = xe
        for bp in blocks:
            ye, _ = moe_ffn(bp, he, k=2, capacity_factor=8.0)
            he = he + ye
        mesh_pe = build_mesh(pp=S, ep=2, dp=n_devices // 4, device=device)

        def moe_stage(chunk_p, hh):
            bp = {n: t[0] for n, t in chunk_p.items()}
            ye, _ = moe_ffn_shardmap(bp, hh, axis="ep", k=2,
                                     capacity_factor=8.0, mesh=mesh_pe)
            return hh + ye

        pipe_pe = interleaved_gpipe(moe_stage, mesh_pe, num_microbatches=2,
                                    num_virtual=V, batch_axis="ep")
        stacked = stage_params(interleave_stack_params(blocks, S, V),
                               mesh_pe, rows=V)
        e_lo = mesh_pe.axis_index("ep") * (E // 2)
        for n in ("w1", "w2"):
            stacked[n] = stacked[n][:, :, e_lo:e_lo + E // 2].contiguous()
        blk = xe.shape[0] // 2
        lo = mesh_pe.axis_index("ep") * blk
        with torch.no_grad():
            out_pe = pipe_pe(stacked, xe[lo:lo + blk])
        if not torch.allclose(out_pe, he[lo:lo + blk], atol=1e-4):
            raise AssertionError("pp x ep composed pipeline diverged from "
                                 "the dense stack")
    return out


def dryrun_multichip(n_devices, device=None, timeout=300):
    """Counterpart of `__graft_entry__.dryrun_multichip(n)`: the sharded
    GPT step on a dp x sp x tp mesh, the same with ZeRO-1, expert
    parallelism, the dp x pp pipeline with dropout (n >= 4), the 3D dp x
    tp x pp GPT, the interleaved schedule and pp x ep (n >= 8), each
    held to its unsharded result.  It spawns n worker processes
    (`launch.start_procs`, one rank each): gloo on the CPU when
    `device="cpu"`, NCCL when n cards are visible; it raises when
    neither holds, and kills workers still running after `timeout`
    seconds.  Returns rank 0's {check: loss}."""
    import json
    import os
    import tempfile

    from .distributed import launch

    n = int(n_devices)
    if device is not None and torch.device(device).type == "cpu":
        device = "cpu"
    elif torch.cuda.is_available() and torch.cuda.device_count() >= n:
        device = "cuda"
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(
            f"dryrun_multichip({n}): NCCL needs {n} cards and {have} are "
            "visible; pass device='cpu' for gloo ranks on the CPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "distributed", "_dryrun_worker.py")
    with tempfile.TemporaryDirectory() as tmp:
        env = {"PYTHONPATH": os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]),
               "PADDLE_RENDEZVOUS_TIMEOUT": "120", "OMP_NUM_THREADS": "1"}
        procs, logs = launch.start_procs(
            ["127.0.0.1"], "127.0.0.1", n, worker, [str(n), device, tmp],
            log_dir=os.path.join(tmp, "logs"), env_extra=env)
        rc = launch._wait(procs, logs, timeout=timeout)
        if rc != 0:
            text = "".join(
                open(os.path.join(tmp, "logs", f"workerlog.{r}")).read()
                for r in range(n))
            raise RuntimeError(f"dryrun_multichip({n}) workers exited "
                               f"{rc}:\n{text[-4000:]}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)
