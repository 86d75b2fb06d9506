"""`paddle_tpu_torch.entry.dryrun_multichip`: the counterpart of
`__graft_entry__.dryrun_multichip`, run on gloo ranks of this CPU.

`dryrun_multichip(n, device="cpu")` spawns n worker processes (one rank
each, killed after 300 s) that run the reference's checks in its order:
the sharded GPT step on dp x sp x tp (`_factor_mesh`), the same with
ZeRO-1, each at the unsharded step's loss to 1e-4 (the reference's
rule for its 3D check); expert parallelism against the dense MoE at
1e-5; the dp x pp pipeline with dropout (n >= 4); the 3D dp x tp x pp
GPT, the interleaved schedule and pp x ep (n = 8), each held to its
unsharded result inside the workers.  Without `device` it takes NCCL
and needs n cards; here it raises.  The cuda-marked test runs the
in-process pipeline on the card.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.entry import _factor_mesh, dryrun_multichip
from torch_threads import torch_threads  # noqa: F401


def test_factor_mesh_is_the_references():
    import __graft_entry__ as g

    for n in (1, 2, 4, 6, 8, 16):
        assert _factor_mesh(n) == g._factor_mesh(n)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_on_gloo(n):
    out = dryrun_multichip(n, device="cpu")
    want = {"sharded", "zero1", "pipeline"} | (
        {"3d", "interleaved"} if n >= 8 else set())
    assert set(out) == want
    assert all(np.isfinite(v) for v in out.values())
    # ZeRO-1 is the replicated update: the same first loss
    assert out["zero1"] == out["sharded"]


def test_dryrun_without_cards_raises():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards NCCL needs")
    with pytest.raises(RuntimeError, match="NCCL needs 2 cards"):
        dryrun_multichip(2)


@pytest.mark.cuda
def test_in_process_pipeline_on_the_card_matches_the_model():
    """On the card the in-process pp = 2 pipeline (K1-K5 in every stage,
    f32) gives the unpipelined model's loss and grads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1-K5)")
    from paddle_tpu_torch.distributed import inprocess, pipeline
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=4,
                    num_heads=4, max_seq_len=128)
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.integers(0, 512, (4, 128)),
                            dtype=torch.int32, device="cuda")
            for _ in range(2))
    ref = GPT(cfg, device="cuda", generator=make_generator(1))
    params = dict(ref.named_parameters())
    loss = ref.loss(x, y)
    want = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    meshes = inprocess.local_meshes(pp=2, device="cuda")
    built = [pipeline.build_gpt_pipeline(
        GPT(cfg, device="cuda", generator=make_generator(1)), m, 2)
        for m in meshes]

    def fwd(r, mesh):
        fn, p = built[r]
        leaves = {g: {n: t.detach().requires_grad_() for n, t in d.items()}
                  for g, d in p.items()}
        return fn(leaves, x, y), leaves

    outs = inprocess.run_ranks(meshes, fwd)
    flat = [[t for d in o[1].values() for t in d.values()] for o in outs]
    grads = inprocess.joint_grad([o[0] for o in outs], flat)
    for r, (o, gs) in enumerate(zip(outs, grads)):
        np.testing.assert_allclose(float(o[0].detach()), float(loss.detach()),
                                   atol=1e-4, rtol=1e-4)
        names = [(g, n) for g, d in o[1].items() for n in d]
        for (g, n), gr in zip(names, gs):
            if g != "stages":
                torch.testing.assert_close(gr, want[n], atol=1e-4,
                                           rtol=1e-3)
                continue
            for k in range(2):
                torch.testing.assert_close(
                    gr[k], want[f"blocks.{2 * r + k}.{n}"], atol=1e-4,
                    rtol=1e-3)
