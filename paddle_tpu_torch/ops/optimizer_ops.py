"""Optimizer update ops (port of the train-step and static-graph slices of
paddle_tpu/ops/optimizer_ops.py: `sgd`, `momentum`, `adam`, `adamw`,
`adagrad`).

The ops keep the reference's `(ins, attrs) -> outs` signature and its
math, which is Paddle's and not `torch.optim`'s:

- Adam's `Beta1Pow`/`Beta2Pow` inputs start at beta1/beta2 (not 1) and
  the op returns them multiplied by beta once more;
- the bias correction folds into the step size,
  lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow), and eps is added to
  sqrt(m2) without bias correction;
- AdamW subtracts lr * coeff * param (the param before the update) from
  Adam's result.

Each op returns new tensors ("ParamOut" etc.); the functional optimizer
(`paddle_tpu_torch/optimizer/functional.py`) writes them back, and the
static-graph Executor binds them to the names the op's outputs carry.
The ops are registered under their op types (`ops/registry.py`) as
stateful: ParamOut and the accumulators' outputs overwrite their inputs.
"""

import torch

from .registry import register_op


def _lr(ins):
    return ins["LearningRate"].reshape(())


def sgd(ins, attrs):
    return {"ParamOut": ins["Param"] - _lr(ins) * ins["Grad"]}


def momentum(ins, attrs):
    mu = attrs.get("mu", 0.9)
    use_nesterov = attrs.get("use_nesterov", False)
    p, g, v = ins["Param"], ins["Grad"], ins["Velocity"]
    lr = _lr(ins)
    v_out = mu * v + g
    if use_nesterov:
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


def adam(ins, attrs):
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    p, g = ins["Param"], ins["Grad"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1pow = ins["Beta1Pow"].reshape(())
    b2pow = ins["Beta2Pow"].reshape(())
    lr = _lr(ins)
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2pow) / (1 - b1pow)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {
        "ParamOut": p_out,
        "Moment1Out": m1_out,
        "Moment2Out": m2_out,
        "Beta1PowOut": (b1pow * beta1).reshape(ins["Beta1Pow"].shape),
        "Beta2PowOut": (b2pow * beta2).reshape(ins["Beta2Pow"].shape),
    }


def adamw(ins, attrs):
    coeff = attrs.get("coeff", 0.01)
    out = adam(ins, attrs)
    lr = _lr(ins)
    out["ParamOut"] = out["ParamOut"] - lr * coeff * ins["Param"]
    return out


register_op("sgd", stateful=True)(sgd)
register_op("momentum", stateful=True)(momentum)
register_op("adam", stateful=True)(adam)
register_op("adamw", stateful=True)(adamw)


@register_op("adagrad", stateful=True)
def adagrad(ins, attrs):
    """operators/optimizers/adagrad_op.h: moment += g^2, then
    param -= lr * g / (sqrt(moment) + epsilon)."""
    eps = attrs.get("epsilon", 1e-6)
    p, g, m = ins["Param"], ins["Grad"], ins["Moment"]
    m_out = m + torch.square(g)
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(m_out) + eps),
            "MomentOut": m_out}
