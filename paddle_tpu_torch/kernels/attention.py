"""Scaled-dot-product attention dispatch (port of
paddle_tpu/kernels/attention.py).

Two entry points, each with the reference's kernel envelope and its own
eager composition:

- `dot_product_attention` (prefill, full forward, training): the flash
  Function (K1 forward, K2 + K3 backward) when the tensors lie on a
  CUDA device and the call is inside the envelope (no mask, no training
  dropout, self-attention, seq % 128 == 0, head_dim in 64/128/256;
  the kernels take float32, bfloat16 and float16); else `_eager_attention`, the port of `_xla_attention`
  (-1e9 causal mask, logits in the input dtype, f32 softmax cast back).
- `decode_attention` (one query row over a KV cache): K6 on a CUDA
  device inside its envelope (no explicit mask, one query row,
  T % 128 == 0, head_dim in 64/128/256); else the decode composition
  (f32 scores, -1e30 mask, f32 softmax cast back to q's dtype).

The reference's TPU-tuned gates (`seq >= 1024`, `t >= 1024`) and its
`PADDLE_TPU_FORCE_FLASH*` environment overrides do not carry over: on
the card the kernels are the dispatch inside their envelopes.  CPU
tensors take the eager compositions unless the caller forces
`use_flash=True`, which then runs the kernels' plain versions.
"""

import math
import warnings

import torch

NEG_INF = -1e9
# the decode path masks with -1e30 (flash_attention.py's NEG_INF), as
# the reference's decode composition does
DECODE_NEG_INF = -1e30


def _eager_attention(q, k, v, mask, scale, is_causal, dropout_p, training,
                     generator):
    # q, k, v: [B, H, S, D]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    # the fill in the logits' dtype, rounded as the reference's: -1e9
    # overflows float16 to -inf (a Python scalar there would raise)
    fill = torch.full((), NEG_INF, device=q.device).to(logits.dtype)
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(s_q, s_k, dtype=torch.bool,
                            device=q.device).tril(diagonal=s_k - s_q)
        logits = torch.where(causal, logits, fill)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, fill)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < (1.0 - dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.matmul(probs, v)


def _use_kernel(use_flash, q):
    # the port's gate: the tensors lie on the card (no TPU thresholds)
    return q.is_cuda if use_flash is None else bool(use_flash)


def decode_attention(q, k, v, pos=None, mask=None, scale=None,
                     use_flash=None):
    """Single-query decode attention: q [B, H, 1, D] against a KV-cache
    prefix k/v [B, H, T, D] -> [B, H, 1, D].

    `pos` is the current token's cache position: a scalar or a [B]
    tensor (per-slot ragged positions); cache columns > pos are masked.
    Alternatively pass an explicit `mask` (bool keeps-where-true, else
    additive).  With neither, the full cache is attended."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    t = k.shape[-2]
    if pos is not None and mask is not None:
        raise ValueError("pass pos or mask, not both")
    if pos is None and mask is None:
        pos = t - 1

    can_flash = (mask is None and q.shape[-2] == 1 and t % 128 == 0
                 and head_dim in (64, 128, 256))
    if _use_kernel(use_flash, q) and can_flash:
        from .flash_attention import flash_decode

        pos_t = torch.as_tensor(pos, device=q.device).to(torch.int32)
        return flash_decode(q, k, v, pos_t + 1, sm_scale=scale)

    s = torch.matmul(q, k.to(q.dtype).transpose(-1, -2)) * scale
    if mask is None:
        pos_t = torch.as_tensor(pos, device=q.device).to(torch.int32)
        idx = torch.arange(t, dtype=torch.int32, device=q.device)
        if pos_t.dim() == 0:
            live = (idx <= pos_t)[None, None, None, :]
        else:                                   # [B] per-row positions
            live = (idx[None, :] <= pos_t[:, None])[:, None, None, :]
        s = torch.where(live, s.float(),
                        torch.full_like(s, DECODE_NEG_INF, dtype=torch.float32))
    elif mask.dtype == torch.bool:
        s = torch.where(mask, s.float(),
                        torch.full_like(s, DECODE_NEG_INF, dtype=torch.float32))
    else:
        s = s.float() + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v.to(q.dtype))


def dot_product_attention(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                          scale=None, training=True, generator=None,
                          use_flash=None):
    """q/k/v: [batch, heads, seq, head_dim] -> [batch, heads, seq, head_dim]."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)

    # K1 takes neither masks nor in-kernel dropout, and needs
    # self-attention shapes with block-aligned seq; anything else takes
    # the eager path even if the caller forced use_flash=True
    seq = q.shape[-2]
    can_flash = (
        (dropout_p == 0.0 or not training)
        and mask is None
        and q.shape[-2] == k.shape[-2]
        and seq % 128 == 0
        and head_dim in (64, 128, 256)
    )
    if use_flash is True and not can_flash:
        warnings.warn(
            "use_flash=True requested but the flash kernel cannot serve this "
            f"call (mask={mask is not None}, dropout={dropout_p}, seq={seq}, "
            f"head_dim={head_dim}; needs no mask, no train-dropout, "
            "self-attention, seq%128==0, head_dim in 64/128/256) — "
            "falling back to the eager path", stacklevel=2)
    if _use_kernel(use_flash, q) and can_flash:
        from .flash_attention import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=is_causal,
                               sm_scale=scale)
    return _eager_attention(q, k, v, mask, scale, is_causal, dropout_p,
                            training, generator)
