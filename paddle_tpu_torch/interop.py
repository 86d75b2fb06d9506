"""Weights and train states across the two packages, as numpy arrays.

The JAX package's `param_dict(model)` converted with `np.asarray` gives
name -> array under the same names the port's modules use
(`blocks.3.attn.q_proj.weight`, Linear weights as [in, out]).  These
helpers turn such a dict into torch tensors and load it into a port
model, which is how the tests give both packages the same weights;
`load_jax_buffer_dict` does the same for mutable buffers (batch-norm
running stats) and `train_state_from_jax` carries a whole train state
(params, buffers, optimizer state, step) across, so both packages can go
on from the same point of a run.  `scope_from_numpy` and `scope_to_numpy`
do the same for a static-graph Scope: the tests run the JAX package's
startup program, read its scope as numpy and seed the port's scope with
it (the port's `uniform_random` never draws JAX's bits).
"""

import numpy as np
import torch

from .core.dtype import to_torch_dtype
from .core.place import resolve_device
from .nn.layers import buffer_dict, load_param_dict, param_dict
from .models.train import TrainState
from .nn.parameter import make_generator


def _to_tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in numpy; the
        # bf16 -> f32 -> bf16 round trip is exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(np_params, device=None, dtype=None):
    """{name: np.ndarray} -> {name: torch.Tensor} on `device` (default
    `cuda`), cast to `dtype` when given."""
    dev = resolve_device(device)
    dt = None if dtype is None else to_torch_dtype(dtype)
    return {n: _to_tensor(a).to(device=dev, dtype=dt)
            for n, a in np_params.items()}


def scope_from_numpy(np_dict, scope, device=None):
    """Set each {name: np.ndarray} entry in the static-graph `scope` as a
    tensor on `device` (default `cuda`), in the device dtype of the
    array's (64-bit narrowed, as the Executor's feeds); returns the
    scope."""
    dev = resolve_device(device)
    for n, a in np_dict.items():
        t = _to_tensor(a)
        scope.set_var(n, t.to(device=dev, dtype=to_torch_dtype(t.dtype)))
    return scope


def scope_to_numpy(scope):
    """{name: np.ndarray} of every value in the static-graph `scope`
    (bfloat16 widened to float32, which is exact)."""
    out = {}
    for n, v in scope.vars.items():
        if v is None:
            continue
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out[n] = v.cpu().numpy()
    return out


def load_jax_param_dict(model, np_params):
    """Copy a JAX model's param_dict (as numpy arrays) into `model`.
    The names must match exactly; each value keeps the port parameter's
    dtype and device."""
    own = {n for n, _ in model.named_parameters()}
    theirs = set(np_params)
    if own != theirs:
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(own - theirs)}, unexpected "
                       f"{sorted(theirs - own)}")
    load_param_dict(model, {n: _to_tensor(a) for n, a in np_params.items()})
    return model


def load_jax_buffer_dict(model, np_buffers):
    """Copy a JAX model's buffers (`dict(jm.named_buffers())` as numpy
    arrays, e.g. the batch-norm `_mean` / `_variance`) into `model`'s
    buffers of the same names, in place, keeping each buffer's dtype and
    device.  The names must match exactly; a shape mismatch raises."""
    named = dict(model.named_buffers())
    if set(named) != set(np_buffers):
        raise KeyError(f"buffer names differ: missing "
                       f"{sorted(set(named) - set(np_buffers))}, unexpected "
                       f"{sorted(set(np_buffers) - set(named))}")
    with torch.no_grad():
        for n, a in np_buffers.items():
            v = _to_tensor(a)
            if tuple(v.shape) != tuple(named[n].shape):
                raise ValueError(f"{n}: shape {tuple(v.shape)} != buffer "
                                 f"shape {tuple(named[n].shape)}")
            named[n].copy_(v)
    return model


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_jax(np_state, model, optimizer, device=None,
                         rng_seed=0):
    """A port TrainState from a JAX package TrainState whose leaves were
    converted to numpy (`jax.tree.map(np.asarray, state)`; a dict with
    the same fields works too).

    The params and buffers (a JAX TrainState's `buffers`, e.g. the
    batch-norm running stats) are copied into `model`, whose own tensors
    the state then holds (as `init_train_state` does); the optimizer state (f32
    moments and beta powers per parameter, the int32 `__step__`) and the
    step counter are converted to tensors on `device` (default `cuda`)
    in the layout `optimizer.init` makes.  A JAX PRNG key has no torch
    counterpart: the state's generator is seeded with `rng_seed`."""
    dev = resolve_device(device)
    load_jax_param_dict(model, _field(np_state, "params"))
    np_buffers = (np_state.get("buffers") if isinstance(np_state, dict)
                  else np_state.buffers)
    if np_buffers:
        load_jax_buffer_dict(model, np_buffers)
    params = param_dict(model, trainable_only=True)
    template = optimizer.init(params)
    theirs = _field(np_state, "opt_state")
    opt_state = {"__step__": _to_tensor(theirs["__step__"]).to(
        device=dev, dtype=torch.int32)}
    for name, slots in template.items():
        if name == "__step__":
            continue
        if set(theirs[name]) != set(slots):
            raise KeyError(f"{name}: optimizer slots {sorted(theirs[name])} "
                           f"!= {sorted(slots)}")
        opt_state[name] = {}
        for k, t in slots.items():
            v = _to_tensor(theirs[name][k]).to(device=dev,
                                               dtype=torch.float32)
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            opt_state[name][k] = v
    return TrainState(
        params=params, opt_state=opt_state, buffers=buffer_dict(model),
        step=_to_tensor(_field(np_state, "step")).to(device=dev,
                                                     dtype=torch.int32),
        rng=make_generator(rng_seed, dev))
