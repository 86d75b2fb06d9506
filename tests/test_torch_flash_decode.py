"""K6's split-KV schedule, modelled on the CPU, against the JAX package's
Pallas decode kernel and the port's plain version.

The CUDA K6 (csrc/flash_decode.cu) runs one launch over a grid (b*h, S):
each row's cache is cut into chunks of `decode_plan`'s size, a block per
chunk runs the online softmax over sub-tiles of its chunk's live keys
and writes an (m, l, acc) partial, an empty one (m = -inf, l = 0) where
its chunk starts at or past the live length, and the last block of the
row merges the partials in split order.  `_decode_split_model` is that
schedule in plain torch: the same chunking from T and b*h, the same
sub-tiles, the empty partials skipped by the merge, the merge in split
order, p kept in f32.  Here it is held against the Pallas
`flash_decode` (interpret mode, as tests/test_torch_kernels.py runs it)
and against `flash_decode_ref`, at D 64/128/256 and ragged lengths 0, 1,
a chunk boundary +-1, T and past T: f32 atol = rtol = 2e-5 (the same sums
in another order), bf16 3e-2 (the Pallas kernel rounds p to bf16 before
P.V; the model and the plain version keep it in f32).

The card test (tests/test_torch_kernels.py `test_kernels_on_card`) holds
the CUDA K6 to this model with the card's SM count.
"""

import contextlib
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import flash_decode as j_decode

from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import flash_attention as TFA
from torch_threads import torch_threads  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
H100_SMS = 132


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _sub_tile(d, itemsize):
    """Keys per sub-tile of the CUDA K6 (csrc/flash_decode.cu `Cfg::kKT`):
    at most 16 KB of K, at most 64 keys."""
    return min(64, 16384 // (d * itemsize))


def _decode_split_model(q, k, v, lengths, sm_scale=None, sms=H100_SMS):
    """K6's schedule on q [B, H, 1, D], k, v [B, H, T, D]: per row, the
    chunks of `decode_plan(B * H, T, sms)`, each an online softmax over
    its live keys in sub-tiles, then the partials merged in split order.
    f32 throughout; the result in q's dtype."""
    b, h, _, d = q.shape
    t = k.shape[-2]
    scale = torch.tensor(1.0 / math.sqrt(d) if sm_scale is None
                         else sm_scale, dtype=torch.float32)
    chunk, splits = TFA.decode_plan(b * h, t, sms)
    kt = _sub_tile(d, q.element_size())
    lens = TFA._decode_lengths(lengths, b, q.device).clamp(0, t).tolist()
    qf = q.float().reshape(b * h, d)
    kf, vf = (x.float().reshape(b * h, t, d) for x in (k, v))
    neg = torch.tensor(-math.inf)
    out = torch.zeros(b * h, d, device=q.device)
    for bh in range(b * h):
        n = lens[bh // h]
        parts = []
        for s in range(splits):
            start, end = s * chunk, min(s * chunk + chunk, n)
            if start >= end:
                parts.append((neg, None, None))      # empty partial
                continue
            m, l, acc = neg, torch.tensor(0.0), torch.zeros(d,
                                                            device=q.device)
            for k0 in range(start, end, kt):
                k1 = min(k0 + kt, end)
                sc = (kf[bh, k0:k1] @ qf[bh]) * scale
                m_new = torch.maximum(m, sc.max())
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = l * alpha + p.sum()
                acc = acc * alpha + p @ vf[bh, k0:k1]
                m = m_new
            parts.append((m, l, acc))
        mt = max((m for m, _, _ in parts), default=neg)
        lt, at = torch.tensor(0.0), torch.zeros(d, device=q.device)
        for m, l, acc in parts:                      # split order
            if m == -math.inf:
                continue
            w = torch.exp(m - mt)
            lt = lt + l * w
            at = at + acc * w
        out[bh] = at / (lt if lt != 0 else 1.0)
    return out.reshape(b, h, 1, d).to(q.dtype)


# T 256, b * h = 16 rows: decode_plan gives 64-key chunks, S = 4, so the
# lengths fall on and beside the chunk boundaries
T = 256
LENGTHS = np.array([0, 1, 63, 64, 65, 129, T, T + 9], np.int32)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_matches_pallas_and_plain(dtype, d):
    b, h = len(LENGTHS), 2
    assert TFA.decode_plan(b * h, T, H100_SMS) == (64, 4)
    q = _rand((b, h, 1, d), 11)
    k, v = _rand((b, h, T, d), 12), _rand((b, h, T, d), 13)
    want = j_decode(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                    jnp.asarray(LENGTHS))
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    lens = torch.from_numpy(LENGTHS)
    got = _decode_split_model(tq, tk, tv, lens)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, 1, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    plain = TFA.flash_decode_ref(tq, tk, tv, lens)
    torch.testing.assert_close(got.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the l == 0 guard: no live key, output 0
    assert float(got[0].abs().max()) == 0.0


def test_split_model_merges_one_split_and_a_long_cache():
    """S = 1 (the whole cache one chunk: b * h beyond two blocks per SM)
    and S = 32 (one row over a 2048-deep cache), against the plain
    version in f32."""
    for b, h, t, lens, sms in ((4, 2, 256, [256, 3, 0, 200], 2),
                               (1, 1, 2048, [2000], H100_SMS)):
        chunk, splits = TFA.decode_plan(b * h, t, sms)
        assert splits == (1 if sms == 2 else 32)
        q = _t(_rand((b, h, 1, 64), 21), "float32")
        k, v = (_t(_rand((b, h, t, 64), s), "float32") for s in (22, 23))
        lens = torch.tensor(lens, dtype=torch.int32)
        torch.testing.assert_close(
            _decode_split_model(q, k, v, lens, sms=sms),
            TFA.flash_decode_ref(q, k, v, lens), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bh, t, want", [
    (48, 384, (64, 6)),          # generate decode [4, 12]: 288 blocks
    (96, 1024, (320, 4)),        # engine decode [8, 12]: 384 blocks
    (12, 2048, (64, 32)),        # one row of 12 heads over 2048 keys
    (384, 1024, (1024, 1)),      # batch 32: one chunk a row
    (1, 128, (64, 2)),
])
def test_decode_plan(bh, t, want):
    assert TFA.decode_plan(bh, t, H100_SMS) == want


def test_decode_plan_rule():
    """Over a grid of rows and depths: chunks of at least 64 keys, a
    multiple of 64, splits = ceil(T / chunk), and at least two blocks per
    SM unless the chunks are the smallest."""
    for bh in (1, 3, 12, 48, 96, 264, 1000):
        for t in (128, 256, 384, 1024, 2048, 8192):
            chunk, splits = TFA.decode_plan(bh, t, H100_SMS)
            assert chunk >= 64 and chunk % 64 == 0
            assert splits == -(-t // chunk)
            assert chunk == 64 or bh * splits >= 2 * H100_SMS, \
                (bh, t, chunk, splits)


def test_wrapper_passes_the_planned_chunk_and_scratch(monkeypatch):
    """The launcher hands the C entry the chunk the model plans, a fresh
    workspace of b*h*S*(D + 2) floats and b*h zeroed counters (kept per
    device and stream; a set outgrown stays alive behind the new one),
    and counts one launch; with S = 1 no scratch."""
    calls = []

    class Lib:
        @staticmethod
        def pt_flash_decode(*args):
            calls.append(args)
            return 0

    allocs = []
    empty = torch.empty

    def spy_empty(*shape, **kw):
        allocs.append(empty(*shape, **kw))
        return allocs[-1]

    monkeypatch.setattr(backend, "load", lambda name, sigs: Lib)
    monkeypatch.setattr(backend, "stream_handle",
                        lambda dev: ctypes.c_void_p(7))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(TFA, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TFA, "_DECODE_COUNTERS", {})
    backend.reset_launches()
    for b, h, t, d in ((4, 12, 384, 64), (2, 3, 1024, 128), (32, 12, 256, 64),
                       (8, 12, 1024, 64)):
        q = torch.zeros(b, h, 1, d)
        k = torch.zeros(b, h, t, d)
        lens = torch.full((b,), t, dtype=torch.int32)
        monkeypatch.setattr(torch, "empty", spy_empty)
        TFA._launch_decode(q, k, k, lens, d ** -0.5)
        monkeypatch.setattr(torch, "empty", empty)
        chunk, splits = TFA.decode_plan(b * h, t, H100_SMS)
        args = calls[-1]
        assert args[5:10] == (b, h, t, d, 0) and args[11] == chunk
        if splits == 1:
            assert args[12] is None and args[13] is None
            continue
        ws = allocs[-1]
        assert args[12] == ws.data_ptr()
        assert ws.numel() == b * h * splits * (d + 2)
        held = TFA._DECODE_COUNTERS[(None, 7)]
        assert args[13] == held[-1].data_ptr()
        assert held[-1].numel() >= b * h and not held[-1].any()
    # 48 rows, then 6, then 96: the 48 outgrown and kept
    assert [c.numel() for c in held] == [48, 96]
    assert backend.LAUNCHES["flash_decode"] == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        big = torch.zeros(4 * 12 * 384 * 64 + 1)
        TFA._launch_decode(torch.zeros(4, 12, 1, 64), big[1:].view(
            4, 12, 384, 64), big[1:].view(4, 12, 384, 64), lens, 0.125)
