"""The port's K10 (the DGC top-k threshold's histogram) against the JAX
package's Pallas kernel.

The same numpy inputs go through `paddle_tpu.kernels.topk_threshold`
(the Pallas kernel in interpret mode on this CPU host) and
`paddle_tpu_torch.kernels.topk_threshold` (the plain version, since the
tensors lie on the CPU).  Everything is held exactly: the counts are
integers (exact in float32 below 2^24 elements, as every input here
is), the edges are the same float32 products, so the threshold and the
masks are bit for bit the reference's.  The CUDA kernel is held against
the plain version on the card (`test_k10_on_card`, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.distributed.strategies import dgc_topk_mask as jdgc_mask
from paddle_tpu.kernels import topk_threshold as J

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import strategies as tstrategies
from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import topk_threshold as T


def _values(n, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "sparse":
        # the DGC state's shape: most elements exactly 0 (cleared slots)
        v = rng.standard_normal(n).astype(np.float32)
        v[rng.random(n) < 0.9] = 0.0
        return v
    if kind == "ties":
        # few distinct magnitudes, both signs, -0 included
        v = rng.choice(np.array([-2.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.0],
                                np.float32), n)
        return v.astype(np.float32)
    raise ValueError(kind)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def test_edge_fractions_are_jnp_linspace_bit_for_bit():
    want = np.asarray(jnp.linspace(0.0, 1.0, J.NUM_EDGES,
                                   dtype=jnp.float32))
    assert T.EDGE_FRACTIONS.dtype == np.float32
    np.testing.assert_array_equal(T.EDGE_FRACTIONS.view(np.uint32),
                                  want.view(np.uint32))
    assert T.NUM_EDGES == J.NUM_EDGES and T.DEFAULT_BLOCK == J.DEFAULT_BLOCK
    # torch.linspace is not jnp.linspace: the constant is needed
    tl = torch.linspace(0, 1, 256, dtype=torch.float32).numpy()
    assert (tl.view(np.uint32) != want.view(np.uint32)).any()


@pytest.mark.parametrize("block", [1024, 64 * 1024])
@pytest.mark.parametrize("n,kind", [(5000, "normal"), (1, "normal"),
                                    (70001, "normal"), (65537, "sparse"),
                                    (3000, "ties")])
def test_counts_match_reference_exactly(n, kind, block):
    """Sizes that are not a multiple of either block, and one of 1."""
    x = np.abs(_values(n, 0 if kind != "ties" else 5, kind))
    # edges over [0, max], some of them exactly on input values
    edges = (T.EDGE_FRACTIONS * np.float32(max(float(x.max()), 1e-30))
             ).astype(np.float32)
    want = np.asarray(J.count_ge_histogram(jnp.asarray(x),
                                           jnp.asarray(edges), block=block))
    got = T.count_ge_histogram(torch.from_numpy(x), torch.from_numpy(edges),
                               block=block)
    assert got.dtype == torch.float32 and got.shape == (T.NUM_EDGES,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_of_unsorted_and_nan_edges():
    """The reference counts |x| >= edge for any edges: unsorted ones, and
    a NaN edge or element that never counts."""
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal(3001)).astype(np.float32)
    x[17] = np.nan
    edges = rng.permutation(T.EDGE_FRACTIONS * np.float32(3.0))
    edges[9] = np.nan
    want = np.asarray(J.count_ge_histogram(jnp.asarray(x),
                                           jnp.asarray(edges), block=1024))
    got = T.count_ge_histogram(torch.from_numpy(x), torch.from_numpy(edges))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[9] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,kind,k", [(20000, "normal", 200),
                                      (65537, "sparse", 66),
                                      (3000, "ties", 100), (1, "normal", 1),
                                      (4096, "normal", 1)])
def test_threshold_is_bitwise_the_reference(n, kind, k, dtype):
    v = _values(n, 1, kind)
    if dtype == "bfloat16":
        v = _bf16(v)
    jv = jnp.asarray(v, getattr(jnp, dtype))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    want = np.float32(J.topk_threshold(jv, k, block=4096))
    got = T.topk_threshold(tv, k)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.float32(got.item()).view(np.uint32) == want.view(np.uint32)
    # the reference's bracket (tests/test_topk_threshold.py:23): at least
    # k kept, at most the elements within one bin of the exact k-th value
    a = np.abs(v.astype(np.float32))
    kept = int((a >= got.item()).sum())
    exact_kth = np.sort(a)[-k]
    binw = a.max() / (T.NUM_EDGES - 1)
    assert k <= kept <= int((a >= exact_kth - binw).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sparsity", [((64, 128), 0.99),
                                            ((3, 3, 16, 8), 0.5),
                                            ((1000,), 0.999), ((7,), 0.0)])
def test_mask_matches_reference(shape, sparsity, dtype):
    """The masks are equal for f32 and bf16 v; in bf16, |v| is compared
    with the f32 threshold in f32 (a bf16 compare would round t)."""
    v = _values(int(np.prod(shape)), 2).reshape(shape)
    if dtype == "bfloat16":
        v = _bf16(v)
    want = np.asarray(J.dgc_topk_mask_pallas(
        jnp.asarray(v, getattr(jnp, dtype)), sparsity, block=2048)
        .astype(jnp.float32))
    got = T.dgc_topk_mask_pallas(
        torch.from_numpy(v).to(getattr(torch, dtype)), sparsity)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_mask_compares_in_f32():
    """An element whose bf16 value lies just below the f32 threshold must
    stay out of the mask, as in the reference: a bf16 compare would round
    the threshold (0.94921881) to the element (0.94921875) and keep it."""
    vals = [0.439453125, 0.953125, 0.5, 0.42578125, 0.62109375, 0.99609375,
            0.94921875, 0.4609375]
    v = torch.tensor(vals, dtype=torch.bfloat16)
    t = T.topk_threshold(v, 2)
    assert bool((v.abs() >= t)[6]) and not bool((v.float().abs() >= t)[6])
    got = T.dgc_topk_mask_pallas(v, 0.75)
    assert got.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]
    want = np.asarray(J.dgc_topk_mask_pallas(
        jnp.asarray(np.array(vals, np.float32), jnp.bfloat16), 0.75)
        .astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flag_routes_dgc_topk_mask_through_k10_and_back(dtype, monkeypatch):
    rng = np.random.default_rng(3)
    v = rng.standard_normal(4096).astype(np.float32)
    if dtype == "bfloat16":
        v = _bf16(v)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jv = jnp.asarray(v, getattr(jnp, dtype))
    calls = []
    real = T.count_ge_histogram
    monkeypatch.setattr(T, "count_ge_histogram",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert tflags.flag("use_pallas_dgc_topk") is False
    exact = tstrategies.dgc_topk_mask(tv, 0.99)
    assert not calls
    np.testing.assert_array_equal(
        exact.float().numpy(),
        np.asarray(jdgc_mask(jv, 0.99).astype(jnp.float32)))
    tflags.set_flags({"FLAGS_use_pallas_dgc_topk": True})
    jflags.set_flags({"FLAGS_use_pallas_dgc_topk": 1})
    try:
        approx = tstrategies.dgc_topk_mask(tv, 0.99)
        japprox = np.asarray(jdgc_mask(jv, 0.99).astype(jnp.float32))
    finally:
        tflags.set_flags({"FLAGS_use_pallas_dgc_topk": False})
        jflags.set_flags({"FLAGS_use_pallas_dgc_topk": 0})
    assert calls == [1]
    np.testing.assert_array_equal(approx.float().numpy(), japprox)
    # the histogram mask keeps every element the exact one keeps
    assert bool((approx >= exact).all()) and approx.sum() >= exact.sum()
    assert tstrategies.dgc_topk_mask(tv, 0.99).sum() == exact.sum()


def test_kernel_route_refuses_what_it_does_not_take():
    x = torch.zeros(8, dtype=torch.float16)
    with pytest.raises(TypeError):
        T._launch(x, torch.zeros(T.NUM_EDGES))
    with pytest.raises(ValueError):
        T._launch(torch.zeros(8), torch.zeros(T.NUM_EDGES - 1))
    assert "topk_threshold" in backend.SOURCES


@pytest.mark.cuda
def test_k10_on_card():
    """K10 against the plain version on the card: counts exactly equal,
    f32 and bf16, at the sizes of chip_smoke.py's synthetic checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    for n, kind in ((1, "normal"), (65537, "sparse"), (3000, "ties"),
                    (2359296, "normal")):
        for dt in (torch.float32, torch.bfloat16):
            v = torch.from_numpy(_values(n, 6, kind)).to("cuda", dt)
            vmax = v.float().abs().max()
            edges = T._edges(vmax)
            backend.reset_launches()
            got = T.count_ge_histogram(v, edges)
            assert backend.LAUNCHES["topk_threshold"] == 1
            want = T.count_ge_histogram_ref(v, edges)
            assert torch.equal(got, want), (n, kind, dt)
