"""How tight chip_smoke.py's key-bias rule is.  A key bias's grad is 0 in
exact arithmetic (softmax does not see a shift of a query's scores), so
the parallel phase holds each `k_proj.bias` grad at most 2^-4 of the
same layer's `q_proj.bias` grad.  This probe reads that ratio, max
|grad k bias| / max |grad q bias| per layer, on bench.py's GPT (bf16,
batch 16 x 512, seeded weights and batch as the parallel phase's) for
the attention as it is and for attentions with a fault planted in the
key gradient:

- "flash": the model's own attention (K1-K3 on the card);
- "plain": an eager causal attention whose backward is written out
  (P, dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D)), without fault;
- "no_d": the same with D left out of dS (dS = P * dP);
- "mask": the same with the causal mask left out of the P that dK reads
  (the future keys' exp(s - lse) kept).

One JSON line per (attention, layer), then one summary line per
attention with its largest ratio and whether the rule passes it.

Usage:

    python -m paddle_tpu_torch.tools.kbias_probe [layers]

Default 12 layers.  Needs one card.  Exit code 0 when "flash" and
"plain" pass the rule and both faults fail it, 1 otherwise.
"""

import json
import math
import sys

import numpy as np
import torch

LIMIT = 2.0 ** -4
ATTENTIONS = ("flash", "plain", "no_d", "mask")
CFG = dict(vocab_size=32768, hidden_size=768, num_layers=12, num_heads=12,
           max_seq_len=512, dtype="bfloat16")


class _Attention(torch.autograd.Function):
    """Causal attention of q, k, v [B, H, S, D] in f32 with the backward
    written out; `fault` plants a fault in dK ("no_d", "mask") or none
    ("plain")."""

    @staticmethod
    def forward(ctx, q, k, v, fault):
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        n = s.shape[-1]
        future = torch.ones(n, n, dtype=torch.bool,
                            device=q.device).triu(1)
        lse = torch.logsumexp(s.masked_fill(future, float("-inf")), -1,
                              keepdim=True)
        p = torch.exp(s - lse).masked_fill(future, 0.0)
        o = torch.matmul(p, v.float())
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.fault, ctx.scale = fault, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * ctx.scale
        n = s.shape[-1]
        future = torch.ones(n, n, dtype=torch.bool,
                            device=q.device).triu(1)
        whole = torch.exp(s - lse)
        p = whole.masked_fill(future, 0.0)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        d = (dof * o).sum(-1, keepdim=True)
        ds = p * (dp - d)
        ds_k = {"plain": ds, "no_d": p * dp,
                "mask": whole * (dp - d)}[ctx.fault]
        dq = torch.matmul(ds, kf) * ctx.scale
        dk = torch.matmul(ds_k.transpose(-1, -2), qf) * ctx.scale
        dv = torch.matmul(p.transpose(-1, -2), dof)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _batch(vocab, batch, seq, device, seed=0):
    # chip_smoke.py's `_par_batch`
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                                 dtype=torch.int32, device=device)
                 for _ in range(2))


def ratios(attention, cfg=CFG, batch=16, device="cuda", seed=0):
    """[max |grad k bias| / max |grad q bias|] per layer of the GPT of
    `cfg` (weights from `make_generator(seed)`) under `attention`."""
    from ..models.gpt import GPT, GPTConfig
    from ..nn import functional as F
    from ..nn import make_generator

    model = GPT(GPTConfig(**cfg), device=device,
                generator=make_generator(seed))
    x, y = _batch(cfg["vocab_size"], batch, cfg["max_seq_len"], device)
    layers = range(cfg["num_layers"])
    qb = [model.blocks[i].attn.q_proj.bias for i in layers]
    kb = [model.blocks[i].attn.k_proj.bias for i in layers]
    sdpa = F.scaled_dot_product_attention
    if attention != "flash":
        def planted(q, k, v, is_causal=False, **kw):
            assert is_causal
            return _Attention.apply(q, k, v, attention)

        F.scaled_dot_product_attention = planted
    try:
        grads = torch.autograd.grad(model.loss(x, y), qb + kb)
    finally:
        F.scaled_dot_product_attention = sdpa
    n = len(qb)
    return [(grads[n + i].float().abs().max()
             / grads[i].float().abs().max()).item() for i in range(n)]


def run(attentions=ATTENTIONS, cfg=CFG, batch=16, device="cuda"):
    """{attention: [ratio per layer]}; prints the JSON lines."""
    out = {}
    for att in attentions:
        out[att] = ratios(att, cfg, batch, device)
        for layer, r in enumerate(out[att]):
            print(json.dumps({"attention": att, "layer": layer,
                              "ratio": r}), flush=True)
        worst = max(out[att])
        print(json.dumps({"attention": att, "max_ratio": worst,
                          "passes": worst <= LIMIT}), flush=True)
    return out


def main(argv):
    cfg = dict(CFG, num_layers=int(argv[0])) if argv else CFG
    if torch.cuda.is_available():
        print(torch.cuda.get_device_name(0), flush=True)
    out = run(cfg=cfg)
    sound = all(max(out[a]) <= LIMIT for a in ("flash", "plain"))
    caught = all(max(out[a]) > LIMIT for a in ("no_d", "mask"))
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
