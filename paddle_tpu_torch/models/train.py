"""Train-step factories: Layer + functional optimizer -> one step function.

Port of paddle_tpu/models/train.py (`TrainState`, `init_train_state`,
`make_train_step`, `make_eval_step`).  The reference traces the whole
(forward, backward, optimizer update) iteration into one jitted function
with donated state; eager PyTorch runs the same three phases as calls:
the loss with the state's params and buffers substituted into the model
(`functional_call_with_state`), `torch.autograd.grad` for the grads, and
the functional optimizer's update.  Buffers that a step replaces (the
batch-norm running stats) come back from the call and are copied into
the state.  On the card the attention and LayerNorm of the forward and
backward run through the hand-written kernels (K1-K5), and a fused
ResNet's identity blocks through K7, by way of their autograd
Functions.

TrainState is the explicit record of everything that changes per step,
the analogue of the reference's persistable variables in a Scope.  Its
`rng` is a `torch.Generator` on the params' device: dropout draws from it
inside the step (`nn.default_rng.key_context`), as the reference's
dropout draws from the step's traced key.  The two never give the same
bits.
"""

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from ..framework.compiler import apply_precision_policy
from ..nn.layers import buffer_dict, functional_call_with_state, param_dict
from ..nn.parameter import default_rng, make_generator, rewound

_PRECISIONS = (None, "highest", "float32", "tensorfloat32")


@dataclasses.dataclass
class TrainState:
    params: Any       # name -> tensor
    opt_state: Any    # the optimizer's state (see optimizer/functional.py)
    buffers: Any      # name -> tensor
    step: Any         # int32 scalar tensor
    rng: Any          # torch.Generator on the params' device


def init_train_state(model, optimizer, rng_seed=0):
    """A state holding the model's own trainable parameters and buffers
    (the step updates them in place when it donates)."""
    params = param_dict(model, trainable_only=True)
    device = next(iter(params.values())).device if params \
        else torch.device("cpu")
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        buffers=buffer_dict(model),
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=make_generator(rng_seed, device),
    )


def _loss_with_buffers(model, params, buffers, rng, loss_fn, batch):
    """Loss evaluation with params/buffers substituted; dropout draws
    from `rng`.  Returns (loss, new_buffers)."""
    with default_rng.key_context(rng):
        return functional_call_with_state(model, params, buffers, *batch,
                                          _method=loss_fn)


def _check_options(remat, accum_steps, precision, grad_psum_axis):
    if isinstance(remat, str) and remat != "conv_outs":
        raise ValueError(
            f"unknown remat mode {remat!r}; use True or 'conv_outs'")
    if int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if precision == "bfloat16":
        raise NotImplementedError(
            "precision='bfloat16' (a bf16 matmul-precision policy for the "
            "whole step, not AMP) is not ported yet: ROADMAP queue 1 item "
            "10; amp=True runs the white-list ops in bf16")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use one of "
                         f"{_PRECISIONS}")
    axes = (grad_psum_axis,) if isinstance(grad_psum_axis, str) \
        else tuple(grad_psum_axis or ())
    for a in axes:
        if a not in ("pp", "dp", "sp", "tp", "ep"):
            raise ValueError(f"grad_psum_axis: unknown mesh axis {a!r}")


def make_train_step(model, optimizer, loss_fn=None, donate=True,
                    grad_psum_axis=None, remat=False, accum_steps=1,
                    precision=None, amp=None, mesh=None):
    """Build `step(state, *batch) -> (state, loss)`.

    loss_fn(model, *batch) -> scalar; defaults to model.loss.
    donate: True updates the state's tensors in place and returns the
    same TrainState (the counterpart of the reference's donation: the
    model's own parameters, held by `init_train_state`, are the ones
    trained); False returns a new TrainState and leaves the old one
    valid.
    accum_steps=k > 1 splits the batch's leading dim into k microbatches
    and accumulates their grads in a Python loop (mean of the microbatch
    grads, one optimizer update, the loss averaged in f32), threading
    buffers through the microbatches as k small steps would.
    remat=True recomputes the forward in the backward pass:
    `torch.utils.checkpoint(use_reentrant=False)` around the pure
    params -> loss function, with the step's generator rewound for the
    recompute (and restored after it, `nn.parameter.rewound`) so dropout
    draws the same masks.
    remat="conv_outs" keeps the conv outputs and recomputes the
    elementwise tail (batch-norm affine, relu, residual add) where the
    backward needs it (`remat.ConvOutsTape`); random ops' outputs are
    kept, so no generator is replayed.  Both give `remat=False`'s
    gradients (bitwise on the CPU).
    precision: None keeps the process's matmul and convolution precision
    (torch's defaults: TF32 off for matmuls, on for cuDNN convs);
    "highest" and "float32" turn TF32 off for the step's matmuls and
    convs, "tensorfloat32" turns it on for both, as the reference's
    precision covers both; the settings are restored after the step.
    amp: True runs the loss under `amp.auto_cast`: white-list ops
    (linear, conv2d) compute in FLAGS_amp_dtype against the f32 master
    params, black-list ops (softmax, cross-entropy) in f32.  None (the
    default) reads FLAGS_amp: "on" turns it on; the "train" default
    keeps the dygraph step f32; False forces it off.  Compose with
    `amp.make_amp_train_step` for float16 dynamic loss scaling.
    grad_psum_axis: a mesh axis ("pp", "dp", "sp", "tp" or "ep"), or a
    tuple of them, over whose process groups the grads and the loss are
    meaned before the update, as the reference's `lax.pmean` inside
    shard_map; `mesh` is the mesh (default: the global mesh, else
    `distributed.default_mesh()`).
    Not ported yet, raising NotImplementedError: precision="bfloat16"
    (ROADMAP item 10).
    """
    _check_options(remat, accum_steps, precision, grad_psum_axis)
    accum_steps = int(accum_steps)
    if loss_fn is None:
        loss_fn = lambda m, *b: m.loss(*b)
    model.train()
    if amp is None:
        from .. import flags as _flags

        amp = _flags.flag("amp") == "on"
    if amp:
        from .. import amp as _amp

        def loss_fn(m, *b, _inner=loss_fn):
            # autocast around the whole forward: the functional ops
            # consult the list-driven dispatch per op, while the params
            # (the grad targets) stay f32 masters
            with _amp.auto_cast(enable=True):
                return _inner(m, *b)

    def _loss_grads(params, bufs, rng, batch):
        names = list(params)
        n = len(names)

        def pure(*flat):
            p = dict(zip(names, flat[:n]))
            return _loss_with_buffers(model, p, bufs, rng, loss_fn,
                                      flat[n:])

        leaves = [params[k] for k in names]
        with torch.enable_grad():
            # differentiate w.r.t. the state's tensors, whatever their
            # requires_grad flag says (a donate=False step makes new ones)
            leaves = [t.detach().requires_grad_() for t in leaves]
            if remat == "conv_outs":
                from .remat import ConvOutsTape

                tape = ConvOutsTape()
                with tape.recording():
                    loss, new_bufs = pure(*leaves, *batch)
            elif remat:
                loss, new_bufs = torch.utils.checkpoint.checkpoint(
                    rewound(pure, rng), *leaves, *batch,
                    use_reentrant=False)
            else:
                loss, new_bufs = pure(*leaves, *batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(), new_bufs,
                {k: g for k, g in zip(names, grads) if g is not None})

    def step(state, *batch):
        rng = state.rng
        if not donate:
            # the old state keeps its generator where it was
            rng = torch.Generator(device=rng.device)
            rng.set_state(state.rng.get_state())
        if accum_steps > 1:
            k = accum_steps
            for b in batch:
                if b.shape[0] % k != 0:
                    raise ValueError(
                        f"batch leading dim {b.shape[0]} not divisible "
                        f"into accum_steps={k} microbatches")
            bufs = state.buffers
            gsum, lsum = {}, None
            for i in range(k):
                micro = tuple(b.reshape(k, b.shape[0] // k, *b.shape[1:])[i]
                              for b in batch)
                l, bufs, g = _loss_grads(state.params, bufs, rng, micro)
                for name, gi in g.items():
                    gsum[name] = gi if name not in gsum else gsum[name] + gi
                l = l.float()
                lsum = l if lsum is None else lsum + l
            grads = {name: g / k for name, g in gsum.items()}
            loss, new_buffers = lsum / k, bufs
        else:
            loss, new_buffers, grads = _loss_grads(
                state.params, state.buffers, rng, batch)
        if grad_psum_axis:
            loss, grads = _pmean_over(grad_psum_axis, mesh, loss, grads)
        params, opt_state = optimizer.update(state.params, grads,
                                             state.opt_state, inplace=donate)
        if donate:
            with torch.no_grad():
                for name, b in new_buffers.items():
                    if b is not state.buffers[name]:
                        state.buffers[name].copy_(b)
                state.step.add_(1)
            return state, loss
        return TrainState(params=params, opt_state=opt_state,
                          buffers=new_buffers, step=state.step + 1,
                          rng=rng), loss

    return apply_precision_policy(step, precision)


def _pmean_over(axis_name, mesh, loss, grads):
    """The loss and the grads meaned over the axis's group (over each
    axis of a tuple in turn: the mean over their product)."""
    from ..distributed import collective, mesh as _mesh

    mesh = mesh or _mesh.get_global_mesh() or _mesh.default_mesh()
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    loss = loss.clone()
    grads = {n: g.contiguous() for n, g in grads.items()}
    for a in axes:
        grads = {n: collective.all_reduce_(g, "mean", mesh, a)
                 for n, g in grads.items()}
        loss = collective.all_reduce_(loss, "mean", mesh, a)
    return loss, grads


def make_eval_step(model, forward_fn=None):
    """Build `step(params, buffers, *batch) -> output`: forward_fn (default
    `model(*batch)`) in eval mode with params and buffers substituted,
    without grads."""
    if forward_fn is None:
        forward_fn = lambda m, *b: m(*b)

    def step(params, buffers, *batch):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                out, _ = functional_call_with_state(
                    model, params, buffers, *batch, _method=forward_fn)
        finally:
            if was_training:
                model.train()
        return out

    return step
