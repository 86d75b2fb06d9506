"""LayerHelper — shared plumbing for layer functions (port of
paddle_tpu/framework/layer_helper.py; Paddle-Fluid's
fluid/layer_helper.py) — creates
temporary output vars, creates parameters in BOTH the main program (as
Parameter) and the startup program (with their init op), and appends
activations.
"""

from . import unique_name
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr, WeightNormParamAttr
from .program import default_main_program, default_startup_program


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_variable_for_type_inference(self, dtype, shape=None):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            dtype=dtype,
            shape=shape,
        )

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if isinstance(attr, WeightNormParamAttr):
            # the reference reparameterizes w = g * v / ||v|| with
            # square, reduce_sum, sqrt, elementwise_div and
            # elementwise_mul ops, which are not ported
            raise NotImplementedError(
                "WeightNormParamAttr needs the square, reduce_sum, sqrt, "
                "elementwise_div and elementwise_mul ops (ROADMAP item 3, "
                "the rest of the static op set)")
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        param = self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype,
            trainable=attr.trainable, regularizer=attr.regularizer,
            initializer=init,
        )
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        # mirror into startup program with its init op
        sb = self.startup_program.global_block()
        if name not in sb.vars:
            sp = sb.create_parameter(
                name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            )
            init(sp, sb)
        return param

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_activation(self, out, act):
        if act is None:
            return out
        tmp = self.create_variable_for_type_inference(out.dtype,
                                                      shape=out.shape)
        self.append_op(act, inputs={"X": out}, outputs={"Out": tmp})
        return tmp

    def input_dtype(self, var):
        return var.dtype or "float32"
