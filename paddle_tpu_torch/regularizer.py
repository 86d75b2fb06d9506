"""Weight regularizers (port of paddle_tpu/regularizer.py; Paddle-Fluid's
fluid/regularizer.py): L1 and L2 decay appended as ops on the gradient
before the optimizer update.  A parameter's own `ParamAttr(regularizer=)`
takes precedence over the optimizer's `regularization=`.
"""


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        from .layers import tensor as T

        decay = T.scale(param, scale=self.coeff)
        return T.elementwise_add(grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        from .layers import tensor as T

        decay = T.scale(T.sign(param), scale=self.coeff)
        return T.elementwise_add(grad, decay)


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
        else:
            out.append((p, reg.append_regularization_op(p, g)))
    return out
