"""ParamAttr — parameter configuration (port of
paddle_tpu/framework/param_attr.py; Paddle-Fluid's fluid/param_attr.py).

`WeightNormParamAttr` reparameterizes the weight as w = g * v / ||v||
(`LayerHelper._create_weight_norm_parameter`).
"""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class WeightNormParamAttr(ParamAttr):
    """param_attr.py:187 — triggers the w = g * v / ||v||
    reparameterization in LayerHelper.create_parameter
    (layer_helper_base.py:87 parity): parameters become name_v / name_g
    (g rank-preserved, size shape[dim] on `dim`, singletons elsewhere),
    with g initialized to ||v|| so the step-0 weight equals v."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
