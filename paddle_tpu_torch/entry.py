"""The port's entry point (port of `__graft_entry__.entry()`).

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
