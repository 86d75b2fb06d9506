"""Autoregressive decoding with a KV cache for the GPT family (port of
paddle_tpu/models/generate.py: `generate` and `beam_search`).

The math mirrors `GPT.forward` (same parameter names, same SDPA scale
1/sqrt(head_dim)).  Prefill runs the whole prompt as one causal pass and
fills the cache; each decode step attends the cache prefix through
`kernels.attention.decode_attention`, the same function the serving
engine calls.  On the card, prefill attention is K1 when the prompt
length is a multiple of 128, decode attention is K6 when the cache depth
is, and every LayerNorm is K4.

Differences from the reference, all in how PyTorch runs rather than in
what is computed:
- the reference stacks the blocks and runs `lax.scan` over layers; the
  port keeps one parameter dict per layer and loops in Python;
- the reference's cache is immutable and rebuilt by
  `dynamic_update_slice`; the port writes K/V into the cache tensors in
  place (`prefill` and `decode_step` mutate the `cache` dict's tensors);
- `dynamic_update_slice` clamps an out-of-range start; `decode_step`
  clamps its write position to the last cache row explicitly;
- the reference's whole generation is one compiled program; the port
  runs eagerly, one decode step per Python iteration;
- `beam_search` gathers the cache into the other of two preallocated
  buffers each step (the reference's gather builds a new cache), and
  sizes the cache to a multiple of 128 keys, so that K6 serves every
  step on the card; the columns past the live prefix are masked to
  exact zeros in both paths.
MoE configs decode too (`_block_tail`): the expert choice is per token,
but the capacity drops depend on the cohort, so decode steps route with
drop-free capacity, as the reference's do.
"""

from typing import NamedTuple, Optional

import torch

from ..nn import functional as F

__all__ = ["DecodeParams", "build_decode_params", "prefill",
           "decode_step", "generate", "beam_search", "init_cache"]


class DecCfg(NamedTuple):
    """Static geometry of a decode run."""
    hidden_size: int
    num_heads: int
    num_layers: int
    max_seq_len: int
    dtype: str
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @classmethod
    def from_model_cfg(cls, cfg):
        return cls(cfg.hidden_size, cfg.num_heads, cfg.num_layers,
                   cfg.max_seq_len, cfg.dtype, cfg.moe_top_k,
                   cfg.moe_capacity_factor)


class DecodeParams(NamedTuple):
    """Decode-ready parameters: emb/head dicts, one dict per block (keys
    as in the block's param_dict, e.g. "attn.q_proj.weight")."""
    emb: dict
    blocks: list
    head: dict
    cfg: DecCfg


def build_decode_params(model):
    """GPT -> DecodeParams (views of the model's tensors, no copies)."""
    flat = {n: p.detach() for n, p in model.named_parameters()}
    emb = {n: v for n, v in flat.items() if n.startswith(("wte.", "wpe."))}
    head = {n: v for n, v in flat.items() if n.startswith("norm_f.")}
    blocks = [{n: p.detach() for n, p in b.named_parameters()}
              for b in model.blocks]
    return DecodeParams(emb, blocks, head, DecCfg.from_model_cfg(model.cfg))


def params_device(params):
    return params.emb["wte.weight"].device


def init_cache(cfg, batch, max_len, dtype=None, device=None):
    """Fixed-size KV buffers [L, B, H, max_len, D], zero-filled."""
    from ..core.dtype import to_torch_dtype
    from ..core.place import resolve_device

    head_dim = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, batch, cfg.num_heads, max_len, head_dim)
    dt = to_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _split_heads(x, num_heads):
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def _merge_heads(o):
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def _block_tail(x, attn_out, bp, cfg, decode=False):
    """Residual + MLP/MoE shared by prefill and decode (GPTBlock.forward
    with dropout off).

    MoE capacity: prefill keeps cfg.moe_capacity_factor, so the prompt
    pass is the training forward; decode raises the factor to E/k (the
    capacity is then the cohort's size), so no token is ever dropped:
    small per-step cohorts would otherwise drop more often than training
    cohorts do."""
    x = x + attn_out @ bp["attn.out_proj.weight"] + bp["attn.out_proj.bias"]
    h = F.layer_norm(x, [x.shape[-1]], bp["norm2.weight"], bp["norm2.bias"])
    if "moe.wg" in bp:
        from ..distributed.moe import moe_ffn

        factor = cfg.moe_capacity_factor
        if decode:
            factor = max(factor, bp["moe.wg"].shape[-1] / cfg.moe_top_k)
        ff, _ = moe_ffn({"wg": bp["moe.wg"], "w1": bp["moe.w1"],
                         "w2": bp["moe.w2"]}, h, k=cfg.moe_top_k,
                        capacity_factor=factor)
    else:
        ff = F.gelu(h @ bp["fc1.weight"] + bp["fc1.bias"]) \
            @ bp["fc2.weight"] + bp["fc2.bias"]
    return x + ff


def _qkv(hn, bp, num_heads):
    q = _split_heads(hn @ bp["attn.q_proj.weight"] + bp["attn.q_proj.bias"],
                     num_heads)
    k = _split_heads(hn @ bp["attn.k_proj.weight"] + bp["attn.k_proj.bias"],
                     num_heads)
    v = _split_heads(hn @ bp["attn.v_proj.weight"] + bp["attn.v_proj.bias"],
                     num_heads)
    return q, k, v


def _head(params, h):
    """Final LayerNorm of h [B, S, H] and the tied-embedding logits of
    its last position -> [B, V]."""
    cfg = params.cfg
    h = F.layer_norm(h, [cfg.hidden_size], params.head["norm_f.weight"],
                     params.head["norm_f.bias"])
    return h[:, -1] @ params.emb["wte.weight"].t()


def _prefill_layers(params, input_ids, on_kv, decode=False):
    """Causal pass over [B, S] ids; calls on_kv(layer, k, v) per layer and
    returns the hidden states before the final LayerNorm.  `decode`
    routes MoE drop-free (see `_block_tail`)."""
    cfg = params.cfg
    seq = input_ids.shape[1]
    pos = torch.arange(seq, device=input_ids.device)
    x = params.emb["wte.weight"][input_ids.long()] \
        + params.emb["wpe.weight"][pos][None]
    for layer, bp in enumerate(params.blocks):
        hn = F.layer_norm(x, [cfg.hidden_size], bp["norm1.weight"],
                          bp["norm1.bias"])
        q, k, v = _qkv(hn, bp, cfg.num_heads)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=False)
        on_kv(layer, k, v)
        x = _block_tail(x, _merge_heads(o), bp, cfg, decode)
    return x


def prefill(params: DecodeParams, input_ids, cache):
    """Full-prompt causal pass: writes K/V into cache[..., :S, :] in place
    and returns the last-position logits [B, V]."""
    seq = input_ids.shape[1]

    def write(layer, k, v):
        cache["k"][layer, :, :, :seq] = k
        cache["v"][layer, :, :, :seq] = v

    return _head(params, _prefill_layers(params, input_ids, write))


def decode_step(params: DecodeParams, token, cache, pos):
    """One incremental step: token [B] at position pos (int) -> logits
    [B, V]; writes the step's K/V into the cache in place."""
    from ..kernels.attention import decode_attention

    cfg = params.cfg
    scale = 1.0 / (cfg.hidden_size // cfg.num_heads) ** 0.5
    pos = int(pos)
    posw = min(pos, cache["k"].shape[3] - 1)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=token.device)
    x = params.emb["wte.weight"][token.long()][:, None, :] \
        + params.emb["wpe.weight"][pos][None, None, :]
    for layer, bp in enumerate(params.blocks):
        hn = F.layer_norm(x, [cfg.hidden_size], bp["norm1.weight"],
                          bp["norm1.bias"])
        q, k, v = _qkv(hn, bp, cfg.num_heads)           # [B, H, 1, D]
        k_cache, v_cache = cache["k"][layer], cache["v"][layer]
        k_cache[:, :, posw] = k[:, :, 0]
        v_cache[:, :, posw] = v[:, :, 0]
        o = decode_attention(q, k_cache, v_cache, pos=pos_t, scale=scale)
        x = _block_tail(x, _merge_heads(o), bp, cfg, decode=True)
    return _head(params, x)


def _sample(logits, generator, temperature, top_k, top_p):
    """Masked categorical draw; temperature <= 0 means greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    neg = torch.full_like(logits, -1e30)
    if top_k is not None:
        k = max(1, min(int(top_k), logits.shape[-1]))
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest prefix with mass >= top_p stays; find its cutoff logit
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def check_token_ids(ids, vocab_size, what="prompt"):
    """Host-side id validation at the entry points (the reference's
    `jnp.take` would turn an out-of-range id into a NaN row)."""
    if len(ids.reshape(-1)) and (int(ids.min()) < 0
                                 or int(ids.max()) >= vocab_size):
        raise ValueError(f"{what} ids must lie in [0, {vocab_size})")


def _resolve_and_check(model_or_params, prompt_ids, max_new_tokens):
    params = (model_or_params if isinstance(model_or_params, DecodeParams)
              else build_decode_params(model_or_params))
    prompt_ids = torch.as_tensor(prompt_ids).to(
        device=params_device(params), dtype=torch.int32)
    if prompt_ids.dim() != 2:
        raise ValueError(f"prompt_ids must be [B, S], got "
                         f"{tuple(prompt_ids.shape)}")
    total = prompt_ids.shape[1] + max_new_tokens
    if total > params.cfg.max_seq_len:
        raise ValueError(
            f"prompt+new = {total} exceeds max_seq_len "
            f"{params.cfg.max_seq_len}")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    check_token_ids(prompt_ids, params.emb["wte.weight"].shape[0])
    return params, prompt_ids


@torch.inference_mode()
def generate(model_or_params, prompt_ids, max_new_tokens,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, generator=None, eos_id=None):
    """Generate [B, max_new_tokens] int32 continuations of prompt_ids
    [B, S] (greedy by default).  temperature > 0 samples from
    `generator` (a torch.Generator on the model's device; seed 0 if
    None).  eos_id stops as soon as every row has emitted it, and
    finished rows pad with eos_id."""
    params, prompt_ids = _resolve_and_check(model_or_params, prompt_ids,
                                            max_new_tokens)
    device = params_device(params)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    batch, prompt_len = prompt_ids.shape
    cache = init_cache(params.cfg, batch, prompt_len + max_new_tokens,
                       device=device)
    logits = prefill(params, prompt_ids, cache)
    token = _sample(logits, generator, temperature, top_k, top_p)
    if eos_id is None:
        out = [token]
        for i in range(max_new_tokens - 1):
            logits = decode_step(params, token, cache, prompt_len + i)
            token = _sample(logits, generator, temperature, top_k, top_p)
            out.append(token)
        return torch.stack(out, dim=1)

    eos_id = int(eos_id)
    out = torch.full((batch, max_new_tokens), eos_id, dtype=torch.int32,
                     device=device)
    out[:, 0] = token
    done = token == eos_id
    i = 1
    while i < max_new_tokens and not bool(done.all()):
        logits = decode_step(params, token, cache, prompt_len + i - 1)
        nxt = _sample(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        out[:, i] = nxt
        done = done | (nxt == eos_id)
        token = nxt
        i += 1
    return out


def _top_k_lower_first(x, k):
    """`jax.lax.top_k` over the last dim: the k largest, ties to the lower
    index (a stable descending sort; `torch.topk` promises no order
    among ties on the card)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _beam_update(logp, finished, logits_bkv, eos_id):
    """One beam step: extend each beam by every token, keep the top K
    per batch row; a finished beam extends only by eos at zero added
    score.  -> (scores, parent, token, finished) of the new beams."""
    batch, k, v = logits_bkv.shape
    logp_tok = torch.log_softmax(logits_bkv.float(), dim=-1)
    if eos_id is not None:
        frozen = torch.full((v,), _BEAM_NEG, device=logp_tok.device)
        frozen[eos_id] = 0.0
        logp_tok = torch.where(finished[..., None], frozen, logp_tok)
    total = logp[..., None] + logp_tok                 # [B, K, V]
    top, idx = _top_k_lower_first(total.reshape(batch, k * v), k)
    parent = idx // v                                  # [B, K]
    token = (idx % v).to(torch.int32)
    fin_new = torch.gather(finished, 1, parent)
    if eos_id is not None:
        fin_new = fin_new | (token == eos_id)
    return top, parent, token, fin_new


_BEAM_NEG = -1e30


@torch.inference_mode()
def beam_search(model_or_params, prompt_ids, beam_size, max_new_tokens,
                eos_id: Optional[int] = None, length_penalty: float = 0.0):
    """KV-cached beam search: (sequences [B, beam, T] int32, scores [B,
    beam] f32) sorted best-first.  Beams ride flattened into the batch
    (B * beam rows), the prompt's cache is repeated beam times and
    reordered by parent beam with one gather per step.  Scores are summed
    token log-probs; `length_penalty` > 0 applies the GNMT normalization
    ((5 + len) / 6) ** lp at the final ranking.  With `eos_id`, finished
    beams freeze (eos-padded, score unchanged)."""
    params, prompt_ids = _resolve_and_check(model_or_params, prompt_ids,
                                            max_new_tokens)
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    vocab = params.emb["wte.weight"].shape[0]
    if beam_size > vocab:
        # the first expansion has only `vocab` live candidates
        raise ValueError(f"beam_size {beam_size} exceeds vocab_size {vocab}")
    k = int(beam_size)
    eos_id = None if eos_id is None else int(eos_id)
    device = params_device(params)
    batch, prompt_len = prompt_ids.shape
    depth = -(-(prompt_len + max_new_tokens) // 128) * 128
    cache = init_cache(params.cfg, batch, depth, device=device)
    logits0 = prefill(params, prompt_ids, cache)
    # two beam caches [L, B*K, H, T, D]; each step gathers one into the
    # other by parent row
    bufs = [{n: torch.empty((c.shape[0], batch * k) + tuple(c.shape[2:]),
                            dtype=c.dtype, device=device)
             for n, c in cache.items()} for _ in range(2)]
    rows = torch.arange(batch, device=device).repeat_interleave(k)
    for n in cache:
        torch.index_select(cache[n], 1, rows, out=bufs[0][n])
    del cache
    boffs = (torch.arange(batch, device=device) * k)[:, None]

    def reorder(src, parent):
        flat = (boffs + parent).reshape(-1)
        dst = bufs[1] if src is bufs[0] else bufs[0]
        for n in src:
            torch.index_select(src[n], 1, flat, out=dst[n])
        return dst

    # first expansion: only beam 0 is live, so the top K are K distinct
    # first tokens
    logp = torch.full((batch, k), _BEAM_NEG, device=device)
    logp[:, 0] = 0.0
    finished = torch.zeros((batch, k), dtype=torch.bool, device=device)
    logits_bkv = logits0[:, None, :].expand(batch, k, vocab)
    logp, parent, token, finished = _beam_update(logp, finished, logits_bkv,
                                                 eos_id)
    seqs = torch.full((batch, k, max_new_tokens),
                      eos_id if eos_id is not None else 0,
                      dtype=torch.int32, device=device)
    seqs[:, :, 0] = token
    lens = torch.ones((batch, k), device=device)
    cache = reorder(bufs[0], parent)
    for i in range(max_new_tokens - 1):
        logits = decode_step(params, token.reshape(-1), cache,
                             prompt_len + i)
        was_fin = finished
        logp, parent, token, finished = _beam_update(
            logp, was_fin, logits.reshape(batch, k, vocab), eos_id)
        cache = reorder(cache, parent)
        seqs = torch.gather(seqs, 1, parent[..., None].expand_as(seqs))
        seqs[:, :, i + 1] = token
        lens = torch.gather(lens, 1, parent) \
            + (~torch.gather(was_fin, 1, parent)).float()
    scores = logp / (((5.0 + lens) / 6.0) ** float(length_penalty))
    order = torch.argsort(-scores, dim=1, stable=True)
    return (torch.gather(seqs, 1, order[..., None].expand_as(seqs)),
            torch.gather(scores, 1, order))
