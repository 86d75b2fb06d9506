"""The port's ring attention (paddle_tpu_torch.distributed.ring_attention)
against the JAX package's.

The same numpy inputs go through the JAX `ring_attention` (under
shard_map on the 8-device CPU mesh, sp = n) and the port's ring.  Both
branches are held: the composition ("xla", the running m, l, o) and the
flash blocks ("flash": the JAX package's Pallas kernel in interpret mode;
the port's `flash_attention_with_lse`, whose plain version runs on the
CPU).  K1's envelope sets the flash shapes: S/n a multiple of 128,
head_dim 64.  The port's ring runs here in one process
(`ring_attention_local`, the same loop with the hop rotating a list of
the n shards) and over a one-rank gloo group (sp = 1); over two and four
ranks it runs in the worker launches of tests/test_torch_moe.py (sp = 2)
and tests/test_torch_gpt_moe.py (sp = 4), whose cases are `ring_cases`
and `run_ring_case` here.

Tolerance: output and grads of sum(out * W) at atol = rtol = 1e-5 (f32
products summed in another order, the f32 exp and logaddexp of two
libraries).
"""

import importlib
import math

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: F401

# the package exports the function under the module's name
tring = importlib.import_module("paddle_tpu_torch.distributed.ring_attention")

TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """The tests' tensors are small: two intra-op threads, so that the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ring_cases(n, flash_causal=(False, True)):
    """(impl, causal, shape) of the parity cases at ring size n."""
    return ([("xla", causal, (2, 2, 16 * n, 16)) for causal in (False, True)]
            + [("flash", causal, (1, 2, 128 * n, 64))
               for causal in flash_causal])


def ring_inputs(shape, seed=0):
    r = np.random.default_rng(seed)
    q, k, v, w = (r.normal(size=shape).astype(np.float32) * s
                  for s in (0.5, 0.5, 0.5, 1.0))
    return q, k, v, w


def run_ring_case(case, mesh, axis="sp"):
    """This rank's output shard and its grads of sum(out * W) through
    `ring_attention` over `axis`, and `ring_attention_sharded`'s global
    output; numpy."""
    impl, causal, shape = case
    ax_i, ax_n = mesh.axis_index(axis), mesh.axis_size(axis)
    blk = shape[2] // ax_n
    sl = slice(ax_i * blk, (ax_i + 1) * blk)
    q, k, v, w = (torch.from_numpy(a[:, :, sl].copy())
                  for a in ring_inputs(shape))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tring.ring_attention(q, k, v, axis, causal, impl=impl, mesh=mesh)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    full = [torch.from_numpy(a) for a in ring_inputs(shape)[:3]]
    glob = tring.ring_attention_sharded(*full, mesh, axis, causal, impl=impl)
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads],
            "global": glob.numpy()}


def jax_ring(case, n):
    """The JAX package's ring over sp = n: (out [B, H, S, D], grads of
    sum(out * W)) as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.distributed.ring_attention import ring_attention

    impl, causal, shape = case
    q, k, v, w = (jnp.asarray(a) for a in ring_inputs(shape))
    mesh = build_mesh(sp=n, devices=jax.devices()[:n])
    spec = P(None, None, "sp", None)
    ring = jax.jit(jax.shard_map(
        lambda q, k, v: ring_attention(q, k, v, "sp", causal=causal,
                                       impl=impl),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False))
    out = ring(q, k, v)
    grads = jax.grad(lambda q, k, v: (ring(q, k, v) * w).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def check_rank(res, ref, case, n, rank):
    """One rank's results against the JAX ring's block `rank`."""
    out, grads = ref
    blk = case[2][2] // n
    sl = slice(rank * blk, (rank + 1) * blk)
    np.testing.assert_allclose(res["out"], out[:, :, sl], atol=TOL,
                               rtol=TOL, err_msg=f"{case} rank {rank} out")
    np.testing.assert_allclose(res["global"], out, atol=TOL, rtol=TOL,
                               err_msg=f"{case} rank {rank} sharded")
    for name, g, want in zip("qkv", res["grads"], grads):
        np.testing.assert_allclose(g, want[:, :, sl], atol=TOL, rtol=TOL,
                                   err_msg=f"{case} rank {rank} d{name}")


@pytest.mark.parametrize("case", ring_cases(4),
                         ids=lambda c: f"{c[0]}-causal{c[1]}")
def test_in_process_ring_matches_reference(case):
    """`ring_attention_local` over 4 shards: the loop, hop and merges of
    a 4-rank ring in one process, against the JAX ring at sp = 4."""
    impl, causal, shape = case
    q, k, v, w = (torch.from_numpy(a) for a in ring_inputs(shape))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tring.ring_attention_local(q, k, v, 4, causal, impl=impl)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref_out, ref_grads = jax_ring(case, 4)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=TOL,
                               rtol=TOL)
    for name, g, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_the_two_branches_agree_with_full_attention(impl):
    """Both branches against the port's plain attention on the whole
    sequence (K1's plain version), causal, over 2 and 3 shards."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_ref

    shape = (1, 2, 768, 64)
    q, k, v, _ = (torch.from_numpy(a) for a in ring_inputs(shape, seed=1))
    ref, _ = flash_attention_ref(q, k, v, causal=True)
    for n in (2, 3):
        out = tring.ring_attention_local(q, k, v, n, causal=True, impl=impl)
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)


def test_sp_1_on_a_gloo_group_and_impl_checks():
    """sp = 1 over a one-rank gloo group: the ring has no hop and is the
    attention of the shard; an unknown impl raises, "auto" takes the
    composition on the CPU; over another one-rank axis (tp) the ring is
    the same attention, and an unknown axis raises."""
    from paddle_tpu_torch.distributed.env import destroy_parallel_env
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_ref

    mesh = build_mesh(sp=1, device="cpu")
    try:
        case = ("flash", True, (1, 2, 128, 64))
        res = run_ring_case(case, mesh)
        q, k, v, _ = (torch.from_numpy(a) for a in ring_inputs(case[2]))
        ref, _ = flash_attention_ref(q, k, v, causal=True)
        np.testing.assert_allclose(res["out"], ref.numpy(), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res["global"], ref.numpy(), atol=TOL,
                                   rtol=TOL)
        with pytest.raises(ValueError, match="impl"):
            tring.ring_attention(q, k, v, impl="pallas", mesh=mesh)
        assert not tring._use_flash_blocks("auto", q)
        got = tring.ring_attention(q, k, v, axis_name="tp", causal=True,
                                   mesh=mesh)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL,
                                   rtol=TOL)
        with pytest.raises(ValueError, match="unknown mesh axis"):
            tring.ring_attention(q, k, v, axis_name="mp", mesh=mesh)
    finally:
        destroy_parallel_env()


@pytest.mark.cuda
def test_in_process_ring_on_the_card_matches_k1():
    """On the card the ring's flash blocks are K1 (forward) and K2/K3
    (backward): the 4-shard ring in bf16 against K1-K3 on the whole
    sequence, at bf16's rule (2^-7 of each tensor's largest |value|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ring's flash blocks are K1-K3)")
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    shape = (2, 4, 4 * 256, 64)
    for causal in (False, True):
        q, k, v, w = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                      for a in ring_inputs(shape))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        backend.reset_launches()
        out = tring.ring_attention_local(q, k, v, 4, causal)
        grads = torch.autograd.grad((out.float() * w.float()).sum(),
                                    (q, k, v))
        assert backend.LAUNCHES["flash_attention_fwd"] > 0
        ref = flash_attention(q, k, v, causal=causal)
        ref_grads = torch.autograd.grad((ref.float() * w.float()).sum(),
                                        (q, k, v))
        for got, want in zip((out, *grads), (ref, *ref_grads)):
            tol = 2.0 ** -7 * float(want.float().abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=0)


def test_scale_default_is_inverse_sqrt_head_dim():
    case = ("xla", False, (1, 1, 32, 16))
    q, k, v, _ = (torch.from_numpy(a) for a in ring_inputs(case[2]))
    a = tring.ring_attention_local(q, k, v, 2, impl="xla")
    b = tring.ring_attention_local(q, k, v, 2, impl="xla",
                                   sm_scale=1.0 / math.sqrt(16))
    assert torch.equal(a, b)


def test_ring_probe_tells_a_misweighted_block():
    """paddle_tpu_torch.tools.ring_probe on the CPU (the flash blocks'
    plain versions, bf16, 4 shards of 128): the ring as it is passes
    both rules; one hop's blocks weighted by e^0.03 pass the old
    allclose at 3e-2 and fail chip_smoke.py's scaled rule."""
    from paddle_tpu_torch.tools import ring_probe

    recs = ring_probe.run((0.0, 0.03), shape=(1, 2, 4 * 128, 64),
                          device="cpu")
    assert len(recs) == 16
    for r in recs:
        assert r["old"], r
        if r["delta"] == 0.0:
            assert r["scaled"], r
        elif not r["causal"]:
            assert not r["scaled"], r
