"""Functional optimizers: (params, grads, state) -> (params, state).

Port of paddle_tpu/optimizer/functional.py (`FunctionalOptimizer`, `SGD`,
`Momentum`, `Adam`, `AdamW`, `global_norm_clip`).  Each optimizer wraps
one update op of `paddle_tpu_torch/ops/optimizer_ops.py`, so the math is
Paddle's (see that module), not `torch.optim`'s.

The state has the reference's layout: per parameter name a dict of f32
moment tensors shaped like the parameter and f32 scalar beta powers,
plus an int32 scalar `"__step__"` that drives a callable learning-rate
schedule.  The update math runs in f32 whatever the parameter's dtype;
the new parameter is cast back to its stored dtype (bf16 parameters, as
the reference keeps them, with no f32 master copy).

`update(..., inplace=True)` writes the new values into the given
parameter and state tensors under `torch.no_grad()` and returns those
same tensors: the counterpart of the reference's buffer donation, which
lets XLA reuse the old buffers.  With `inplace=False` it returns new
tensors and leaves its inputs as they were.

Usage:
    opt = functional.AdamW(1e-4)
    state = opt.init(params)                 # params: dict name -> tensor
    params, state = opt.update(params, grads, state)
"""

import torch

from ..ops import optimizer_ops as K

__all__ = ["FunctionalOptimizer", "SGD", "Momentum", "Adam", "AdamW",
           "global_norm_clip"]


class FunctionalOptimizer:
    """Wraps one optimizer_ops kernel into an init/update transform.

    Subclasses define:
      op: the update op
      slots: dict input-name -> fill value, per-param accumulators
      scalar_slots: dict input-name -> init value, per-param scalar
        accumulators (beta powers)
      out_map: op output name -> state slot, where it is not the name
        minus "Out"
    """

    op = None
    slots = {}
    scalar_slots = {}
    out_map = {}

    def __init__(self, learning_rate=0.001, grad_clip=None,
                 weight_decay=None, **attrs):
        self._lr = learning_rate
        self._attrs = attrs
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay

    def init(self, params):
        state = {}
        device = torch.device("cpu")
        for name, p in params.items():
            device = p.device
            # accumulators always f32 (bf16 moments destroy Adam stability)
            s = {k: torch.full(p.shape, v, dtype=torch.float32,
                               device=p.device)
                 for k, v in self.slots.items()}
            s.update({k: torch.tensor(v, dtype=torch.float32,
                                      device=p.device)
                      for k, v in self.scalar_slots.items()})
            state[name] = s
        state["__step__"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    def learning_rate(self, step):
        """The learning rate at `step` (the state's `__step__`), as an
        f32 [1] tensor on the step's device."""
        lr = self._lr(step) if callable(self._lr) else self._lr
        return torch.as_tensor(lr, dtype=torch.float32,
                               device=step.device).reshape(1)

    def update(self, params, grads, state, inplace=False):
        with torch.no_grad():
            return self._update(params, grads, state, inplace)

    def _update(self, params, grads, state, inplace):
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        step = state["__step__"]
        lr = self.learning_rate(step)
        new_params = {}
        new_state = {"__step__": step.add_(1) if inplace else step + 1}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                new_params[name] = p
                new_state[name] = state[name]
                continue
            # update math in f32 regardless of the param dtype
            g = g.float()
            p32 = p.float()
            if self._weight_decay:
                g = g + self._weight_decay * p32
            ins = {"Param": p32, "Grad": g, "LearningRate": lr}
            ins.update(state[name])
            out = type(self).op(ins, dict(self._attrs))
            p_out = out.pop("ParamOut")
            slots = {self.out_map.get(k, k[: -len("Out")]): v
                     for k, v in out.items() if k.endswith("Out")}
            if inplace:
                p.copy_(p_out)
                for k, v in slots.items():
                    state[name][k].copy_(v)
                new_params[name] = p
                new_state[name] = state[name]
            else:
                new_params[name] = p_out.to(p.dtype)
                new_state[name] = slots
        return new_params, new_state


class SGD(FunctionalOptimizer):
    op = staticmethod(K.sgd)


class Momentum(FunctionalOptimizer):
    op = staticmethod(K.momentum)
    slots = {"Velocity": 0.0}

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, mu=momentum,
                         use_nesterov=use_nesterov, **kw)


class Adam(FunctionalOptimizer):
    op = staticmethod(K.adam)
    slots = {"Moment1": 0.0, "Moment2": 0.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self.scalar_slots = {"Beta1Pow": beta1, "Beta2Pow": beta2}


class AdamW(Adam):
    op = staticmethod(K.adamw)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, coeff=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._attrs["coeff"] = coeff


def global_norm_clip(clip_norm):
    """Gradient clip-by-global-norm as a grads -> grads transform (parity:
    fluid.clip.GradientClipByGlobalNorm).  `sumsq(grads)`, when given,
    replaces the local sum of squares (the sharded step sums those of
    split params over their axes)."""

    def clip(grads, sumsq=None):
        if sumsq is None:
            sq = sum(torch.sum(torch.square(g.float()))
                     for g in grads.values() if g is not None)
        else:
            sq = sumsq({k: g for k, g in grads.items() if g is not None})
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {k: (None if g is None else g * scale.to(g.dtype))
                for k, g in grads.items()}

    clip.clip_norm = clip_norm
    return clip
