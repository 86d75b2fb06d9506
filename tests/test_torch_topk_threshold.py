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
from torch_threads import torch_threads  # noqa: F401


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


def _inorder(k):
    """csrc/topk_threshold.cu `inorder`: the sorted position of node k
    (1..255) of the depth-8 search tree stored breadth-first."""
    level = k.bit_length() - 1
    return ((2 * (k - (1 << level)) + 1) << (7 - level)) - 1


def _bin_count_model(x, edges):
    """CPU model of K10's bin count (csrc/topk_threshold.cu), in numpy:
    the edges sorted with their indices (NaN last), each |x| searched down
    the breadth-first tree of the first 255 sorted edges and compared with
    the last (m = the number of sorted edges <= |x|, 0 for a NaN), per-bin
    counts, suffix sums (sorted edge r counts the elements in bins m > r)
    mapped back to the edges' own order.  Returns float32 counts."""
    a = np.abs(np.asarray(x, np.float32).reshape(-1))
    edges = np.asarray(edges, np.float32)
    order = np.argsort(edges, kind="stable")          # NaN sorts last
    key = edges[order]
    tree = np.zeros(256, np.float32)
    tree[1:] = key[[_inorder(k) for k in range(1, 256)]]
    k = np.ones(a.shape, np.int64)
    with np.errstate(invalid="ignore"):
        for _ in range(8):
            k = 2 * k + (tree[k] <= a)
        m = np.where(key[255] <= a, 256, k - 256)
    bins = np.bincount(m, minlength=257)
    suffix = np.cumsum(bins[::-1])[::-1]              # suffix[r] = bins[r:]
    counts = np.zeros(256, np.int64)
    counts[order] = suffix[1:]
    return counts.astype(np.float32)


def _edge_cases():
    """(name, edges): sorted, unsorted, duplicated, NaN, +-inf, +-0, all
    zero, all NaN."""
    rng = np.random.default_rng(21)
    lin = T.EDGE_FRACTIONS * np.float32(2.5)
    odd = rng.permutation(lin)
    odd[:9] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.25, 1.25, np.nan, 0.5]
    dup = np.sort(rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), 256))
    return [("sorted", lin), ("unsorted", rng.permutation(lin)),
            ("duplicates", dup), ("nan inf zero dup", odd),
            ("all zero", np.zeros(256, np.float32)),
            ("all nan", np.full(256, np.nan, np.float32))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge_case", [c[0] for c in _edge_cases()])
def test_bin_count_model_is_bitwise_the_reference(edge_case, dtype):
    """The K10 design's counts (search, bins, suffix sums, mapped back)
    equal the Pallas kernel's (interpret mode) and the plain version's bit
    for bit, with NaN, -0 and +inf elements among the values.  At an edge
    <= -1 (here -inf) the Pallas kernel also counts the -1.0 padding of
    its last tile (117 elements at n 5003, block 1024), which the port's
    function, |x| >= edge over the n elements, does not; the DGC path's
    edges are >= 0."""
    edges = dict(_edge_cases())[edge_case].astype(np.float32)
    x = np.abs(_values(5003, 22)) * np.float32(1.3)
    x[[3, 700, 4001]] = np.nan
    x[[5, 6]] = -0.0
    x[[7, 8]] = np.inf
    x[9] = np.float32(1.25)
    if dtype == "bfloat16":
        x = _bf16(x)
    want = np.asarray(J.count_ge_histogram(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(edges), block=1024))
    plain = T.count_ge_histogram_ref(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(edges)).numpy()
    got = _bin_count_model(x, edges)
    padded = edges <= -1.0
    np.testing.assert_array_equal(got[~padded], want[~padded])
    np.testing.assert_array_equal(got[padded] + (-x.size) % 1024,
                                  want[padded])
    np.testing.assert_array_equal(got, plain)
    assert (got[np.isnan(edges)] == 0).all()


def test_search_tree_layout():
    """Every sorted position but the last is a node of the tree once, and
    the breadth-first walk visits the root's in-order neighbours in
    order (node 2k left of k, 2k + 1 right of it)."""
    pos = [_inorder(k) for k in range(1, 256)]
    assert sorted(pos) == list(range(255))
    for k in range(1, 128):
        assert _inorder(2 * k) < _inorder(k) < _inorder(2 * k + 1)
    text = (backend.CSRC / "topk_threshold.cu").read_text()
    assert "((2 * (k - (1 << l)) + 1) << (7 - l)) - 1" in text
    # integer atomics only (shared bins, the workspace, the counter)
    assert "atomicAdd(h + m" in text and "float* counts" in text
    assert "atomicAdd(counts" not in text


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
    f32 and bf16, at the sizes of chip_smoke.py's synthetic checks, with
    the DGC path's edges and with `_edge_cases` (unsorted, duplicated,
    NaN, +-inf edges) over values with NaN, -0 and +inf among them; and
    over a view that is not 16-byte aligned."""
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
            x = _values(n + 3, 7, kind)
            x[:: 97] = np.nan
            x[1:3] = [-0.0, np.inf]
            for name, e in _edge_cases():
                xt = torch.from_numpy(x).to("cuda", dt)[3:]
                et = torch.from_numpy(e.astype(np.float32)).to("cuda")
                got = T.count_ge_histogram(xt, et)
                want = T.count_ge_histogram_ref(xt, et)
                assert torch.equal(got, want), (n, kind, dt, name)
