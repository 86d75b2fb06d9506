"""Learning-rate schedules as graph ops (port of
paddle_tpu/layers/learning_rate_scheduler.py).

Parity: python/paddle/fluid/layers/learning_rate_scheduler.py
(noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup).

Like the reference, schedules are ops over a persistable global-step
counter (`@LR_DECAY_COUNTER@`, stepped in place by `increment`), so LR
state checkpoints with everything else and the schedule runs on the
device as part of the step, with no host read.  The static optimizers
take the schedule's Variable as their learning rate.
"""

import math

import torch

from ..framework.layer_helper import LayerHelper
from ..ops.registry import register_op
from . import tensor as T

GLOBAL_STEP_VAR = "@LR_DECAY_COUNTER@"

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]


def _global_step():
    counter = T.create_global_var([1], 0.0, "float32", persistable=True,
                                  name=GLOBAL_STEP_VAR)
    T.increment(counter, value=1.0, in_place=True)
    return counter


@register_op("piecewise_decay_lr")
def _piecewise_decay_op(ins, attrs):
    step = ins["Step"].reshape(())
    boundaries = torch.tensor(attrs["boundaries"], dtype=torch.float32,
                              device=step.device)
    values = torch.tensor(attrs["values"], dtype=torch.float32,
                          device=step.device)
    # the index stays a device tensor: no host read per step
    idx = (step >= boundaries).to(torch.int64).sum()
    return {"Out": values[idx].reshape(1)}


def piecewise_decay(boundaries, values):
    step = _global_step()
    helper = LayerHelper("piecewise_decay")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("piecewise_decay_lr", inputs={"Step": step},
                     outputs={"Out": out},
                     attrs={"boundaries": [float(b) for b in boundaries],
                            "values": [float(v) for v in values]})
    return out


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step()
    a = T.pow(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    lr = T.elementwise_min(a, b) * (learning_rate * d_model ** -0.5)
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    ratio = step * (1.0 / decay_steps)
    if staircase:
        ratio = T.floor(ratio)
    return T.elementwise_pow(
        T.fill_constant([1], "float32", decay_rate), ratio) * learning_rate


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step()
    ratio = step * (1.0 / decay_steps)
    if staircase:
        ratio = T.floor(ratio)
    return T.exp(ratio * (-decay_rate)) * learning_rate


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step()
    ratio = step * (1.0 / decay_steps)
    if staircase:
        ratio = T.floor(ratio)
    denom = ratio * decay_rate + 1.0
    c = T.fill_constant([1], "float32", learning_rate)
    return T.elementwise_div(c, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step()
    if cycle:
        div = T.ceil(step * (1.0 / decay_steps))
        div = T.elementwise_max(div, T.fill_constant([1], "float32", 1.0))
        decay_var = div * float(decay_steps)
        frac = T.elementwise_div(step, decay_var)
    else:
        capped = T.elementwise_min(
            step, T.fill_constant([1], "float32", float(decay_steps)))
        frac = capped * (1.0 / decay_steps)
    one_minus = frac * -1.0 + 1.0
    return T.pow(one_minus, factor=power) * (learning_rate - end_learning_rate) \
        + end_learning_rate


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    epoch = T.floor(step * (1.0 / step_each_epoch))
    cos_arg = epoch * (math.pi / epochs)
    return (T.cos(cos_arg) + 1.0) * (0.5 * learning_rate)


@register_op("linear_warmup_lr")
def _linear_warmup_op(ins, attrs):
    step = ins["Step"].reshape(())
    main_lr = ins["MainLR"].reshape(())
    warmup = attrs["warmup_steps"]
    start, end = attrs["start_lr"], attrs["end_lr"]
    warm = start + (end - start) * step / warmup
    return {"Out": torch.where(step < warmup, warm, main_lr).reshape(1)}


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from ..framework.program import Variable

    step = _global_step()
    helper = LayerHelper("linear_lr_warmup")
    if not isinstance(learning_rate, Variable):
        learning_rate = T.fill_constant([1], "float32", learning_rate)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("linear_warmup_lr",
                     inputs={"Step": step, "MainLR": learning_rate},
                     outputs={"Out": out},
                     attrs={"warmup_steps": float(warmup_steps),
                            "start_lr": float(start_lr),
                            "end_lr": float(end_lr)})
    return out
