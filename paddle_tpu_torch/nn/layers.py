"""nn.Layer — the eager module base class (port of paddle_tpu/nn/layers.py).

`Layer` is a `torch.nn.Module` that knows its dtype, its device and the
generator its parameters are drawn from.  Parameter names come from the
module tree exactly as the reference's `named_parameters` builds them
(`blocks.3.attn.q_proj.weight`), so `param_dict` keys are identical in
both packages.
"""

import contextlib

import torch

from ..core.place import resolve_device
from .parameter import make_generator, materialize


class Layer(torch.nn.Module):
    def __init__(self, dtype="float32", device=None, generator=None):
        super().__init__()
        self._dtype = dtype
        self._device = resolve_device(device)
        self._generator = generator if generator is not None \
            else make_generator(0)

    def create_parameter(self, shape, dtype=None, is_bias=False,
                         constant=None):
        """A new parameter on this layer's device: zeros for a bias,
        `constant` when given, else Xavier-uniform."""
        if is_bias and constant is None:
            constant = 0.0
        return materialize(shape, dtype or self._dtype, self._device,
                           self._generator, constant)

    def sub_kwargs(self):
        """dtype/device/generator for sub-layers built by this layer."""
        return {"dtype": self._dtype, "device": self._device,
                "generator": self._generator}


def functional_call(layer, params, *args, **kwargs):
    """Forward pass with parameter values taken from `params` (dict
    name -> tensor); the layer's own tensors are left untouched."""
    return torch.func.functional_call(layer, params, args, kwargs)


@contextlib.contextmanager
def _swap_tensors(layer, values):
    """Put `values` (dotted name -> tensor) in place of the layer tree's
    parameters and buffers of those names; the originals come back on
    exit, whatever the call did to the slots in between."""
    owners = dict(layer.named_modules())
    saved = []
    try:
        for path, v in values.items():
            owner_path, _, leaf = path.rpartition(".")
            owner = owners[owner_path]
            store = (owner._parameters if leaf in owner._parameters
                     else owner._buffers)
            if leaf not in store:
                raise KeyError(f"{path}: no such parameter or buffer")
            saved.append((store, leaf, store[leaf]))
            store[leaf] = v
        yield owners
    finally:
        for store, leaf, old in reversed(saved):
            store[leaf] = old


def functional_call_with_state(layer, params, buffers, *args, _method=None,
                               **kwargs):
    """Forward with params AND mutable buffers (batch-norm running stats)
    substituted; returns (output, new_buffers), where new_buffers holds
    what the call left in each buffer slot.  The layer's own tensors are
    left untouched.

    _method: optional fn(layer, *args, **kwargs) to call instead of
    layer.__call__ (e.g. a loss method)."""
    call = _method if _method is not None else (
        lambda l, *a, **kw: l(*a, **kw))
    with _swap_tensors(layer, {**params, **buffers}) as owners:
        out = call(layer, *args, **kwargs)
        new_buffers = {}
        for path in buffers:
            owner_path, _, leaf = path.rpartition(".")
            new_buffers[path] = owners[owner_path]._buffers[leaf]
    return out, new_buffers


def buffer_dict(layer):
    return {n: b for n, b in layer.named_buffers()}


def param_dict(layer, trainable_only=False):
    """name -> parameter (the layer's own tensors); with
    `trainable_only`, only those that require grad (the reference's
    `trainable`)."""
    return {n: p for n, p in layer.named_parameters()
            if p.requires_grad or not trainable_only}


def load_param_dict(layer, values):
    """Copy `values` (name -> array or tensor) into the layer's
    parameters of the same names, in place, keeping each parameter's
    dtype and device.  Names the layer does not have are ignored, as in
    the reference; a shape mismatch raises."""
    named = dict(layer.named_parameters())
    with torch.no_grad():
        for n, v in values.items():
            if n not in named:
                continue
            v = torch.as_tensor(v)
            if tuple(v.shape) != tuple(named[n].shape):
                raise ValueError(f"{n}: shape {tuple(v.shape)} != parameter "
                                 f"shape {tuple(named[n].shape)}")
            named[n].copy_(v)
