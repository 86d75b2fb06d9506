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

Files cross too.  The JAX package writes bfloat16 arrays to `.npz` as
ml_dtypes' bfloat16, which numpy records as raw 2-byte words (descr
'<V2'); `to_numpy_exact` / `from_numpy_exact` turn a bf16 tensor into
such words and back, and `save_npz` writes them with the same header, so
`io` and `checkpoint` write the JAX package's bytes and read its files
without ml_dtypes.  `train_state_from_jax_npz` reads a JAX package
checkpoint's `arrays.npz` into a port TrainState.

Sharded forms: `sharded_state_from_jax` cuts a global JAX TrainState to
this rank's blocks under partition rules (and ZeRO-1);
`pipeline_params_from_jax` turns the reference's pipeline params
({"emb", "stages": [S, ...] stacked, "head"}) into this pp rank's stage.
"""

import zipfile

import numpy as np
import torch
from numpy.lib import format as _npy_format

from .core.dtype import to_torch_dtype
from .core.place import resolve_device


# the descr np.save writes for ml_dtypes' bfloat16 (raw 2-byte words)
BF16_NPY_DESCR = "<V2"


def _is_bf16_words(a):
    return (a.dtype.kind == "V" and a.dtype.itemsize == 2
            and a.dtype.names is None) or a.dtype.name == "bfloat16"


def to_numpy_exact(t):
    """A tensor as numpy with its exact bytes: bfloat16 as raw 2-byte
    words (a 'V2' array, what numpy reads back from a JAX package file),
    every other dtype as itself."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return t.cpu().numpy()


def from_numpy_exact(a):
    """numpy -> a CPU tensor that owns its memory; 2-byte words ('V2', or
    ml_dtypes' bfloat16) come back as bfloat16 with the same bits."""
    a = np.asarray(a)
    if _is_bf16_words(a):
        words = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_npz(file, arrays):
    """`np.savez(file, **arrays)`, byte for byte, with 2-byte words written
    under the JAX package's bfloat16 descr ('<V2').  `file` is a path (a
    missing `.npz` suffix is added, as np.savez does) or a binary file."""
    if isinstance(file, str) and not file.endswith(".npz"):
        file = file + ".npz"
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if _is_bf16_words(val):
                    _npy_format.write_array_header_1_0(fid, {
                        "descr": BF16_NPY_DESCR, "fortran_order": False,
                        "shape": val.shape})
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    _npy_format.write_array(fid, val, allow_pickle=True)


def params_from_numpy(np_params, device=None, dtype=None):
    """{name: np.ndarray} -> {name: torch.Tensor} on `device` (default
    `cuda`), cast to `dtype` when given."""
    dev = resolve_device(device)
    dt = None if dtype is None else to_torch_dtype(dtype)
    return {n: from_numpy_exact(a).to(device=dev, dtype=dt)
            for n, a in np_params.items()}


def scope_from_numpy(np_dict, scope, device=None):
    """Set each {name: np.ndarray} entry in the static-graph `scope` as a
    tensor on `device` (default `cuda`), in the device dtype of the
    array's (64-bit narrowed, as the Executor's feeds); returns the
    scope."""
    dev = resolve_device(device)
    for n, a in np_dict.items():
        t = from_numpy_exact(a)
        scope.set_var(n, t.to(device=dev, dtype=to_torch_dtype(t.dtype)))
    return scope


def scope_to_numpy(scope):
    """{name: np.ndarray} of every value in the static-graph `scope`
    (bfloat16 widened to float32, which is exact; a sharded value of the
    GSPMD tier assembled from its blocks)."""
    from .framework.spmd import whole

    out = {}
    for n, v in scope.vars.items():
        if v is None:
            continue
        # a GSPMD tier's sharded value: the global array of its blocks
        v = whole(v).detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out[n] = v.cpu().numpy()
    return out


def load_jax_param_dict(model, np_params):
    """Copy a JAX model's param_dict (as numpy arrays) into `model`.
    The names must match exactly; each value keeps the port parameter's
    dtype and device."""
    from .nn.layers import load_param_dict

    own = {n for n, _ in model.named_parameters()}
    theirs = set(np_params)
    if own != theirs:
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(own - theirs)}, unexpected "
                       f"{sorted(theirs - own)}")
    load_param_dict(model, {n: from_numpy_exact(a) for n, a in np_params.items()})
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
            v = from_numpy_exact(a)
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
    from .models.train import TrainState
    from .nn.layers import buffer_dict, param_dict
    from .nn.parameter import make_generator

    dev = resolve_device(device)
    load_jax_param_dict(model, _field(np_state, "params"))
    np_buffers = (np_state.get("buffers") if isinstance(np_state, dict)
                  else np_state.buffers)
    if np_buffers:
        load_jax_buffer_dict(model, np_buffers)
    params = param_dict(model, trainable_only=True)
    template = optimizer.init(params)
    theirs = _field(np_state, "opt_state")
    opt_state = {"__step__": from_numpy_exact(theirs["__step__"]).to(
        device=dev, dtype=torch.int32)}
    for name, slots in template.items():
        if name == "__step__":
            continue
        if set(theirs[name]) != set(slots):
            raise KeyError(f"{name}: optimizer slots {sorted(theirs[name])} "
                           f"!= {sorted(slots)}")
        opt_state[name] = {}
        for k, t in slots.items():
            v = from_numpy_exact(theirs[name][k]).to(device=dev,
                                               dtype=torch.float32)
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            opt_state[name][k] = v
    return TrainState(
        params=params, opt_state=opt_state, buffers=buffer_dict(model),
        step=from_numpy_exact(_field(np_state, "step")).to(device=dev,
                                                     dtype=torch.int32),
        rng=make_generator(rng_seed, dev))


def train_state_from_jax_npz(path, model, optimizer, device=None,
                             rng_seed=0):
    """A port TrainState from a JAX package checkpoint's `arrays.npz`
    (`checkpoint.save_checkpoint(..., writer="npz")` of its TrainState):
    the leaves keyed `.params['<name>']`, `.opt_state['<name>']['<slot>']`,
    `.opt_state['__step__']`, `.buffers['<name>']` and `.step` are
    gathered into that state's fields and go through
    `train_state_from_jax`'s mapping.  The JAX PRNG key (`.rng`) has no
    torch counterpart: the generator is seeded with `rng_seed`."""
    import ast

    fields = {"params": {}, "opt_state": {}, "buffers": {}}
    step = None
    with np.load(path) as data:
        for key in data.files:
            if key == ".step":
                step = data[key]
                continue
            head, _, rest = key[1:].partition("[")
            if head not in fields:
                continue            # .rng
            keys = [ast.literal_eval(k) for k in
                    ("[" + rest)[1:-1].split("][")]
            node = fields[head]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[key]
    if step is None:
        raise KeyError(f"{path}: no '.step' leaf; not a TrainState "
                       "checkpoint")
    return train_state_from_jax(dict(fields, step=step), model, optimizer,
                                device=device, rng_seed=rng_seed)


def sharded_state_from_jax(np_state, model, optimizer, mesh, rules,
                           zero1=False, device=None, rng_seed=0):
    """This rank's blocks (`distributed.sharded.shard_train_state`) of a
    global JAX TrainState converted to numpy."""
    from .distributed.sharded import shard_train_state

    state = train_state_from_jax(np_state, model, optimizer,
                                 device=device or mesh.device,
                                 rng_seed=rng_seed)
    return shard_train_state(state, mesh, rules, zero1=zero1)


def pipeline_params_from_jax(np_params, mesh, interleave=1, tp=False,
                             axis_name="pp", device=None):
    """The reference's pipeline params as numpy ({"emb": {..}, "stages":
    {name: [S * V, ...]}, "head": {..}}) -> this pp rank's: its stage
    rows (`pipeline.stage_params`: [per, ...], or [V, per, ...] for an
    interleaved stack) and, with `tp`, its tp tiles of them as
    `build_gpt_pipeline_3d` holds them; emb and head whole."""
    from .distributed.pipeline import stage_params, tp_stage_spec
    from .distributed.sharded import local_block

    dev = device or mesh.device

    def tensors(d):
        return {n: from_numpy_exact(v).to(dev) for n, v in d.items()}

    stages = stage_params(tensors(np_params["stages"]), mesh, axis_name,
                          rows=interleave)
    if tp:
        stages = {n: local_block(mesh, tp_stage_spec(n), v).clone()
                  for n, v in stages.items()}
    return {"emb": tensors(np_params["emb"]), "stages": stages,
            "head": tensors(np_params["head"])}
