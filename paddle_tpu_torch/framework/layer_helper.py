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
            # any parameter with this attr reparameterizes, bias
            # included (layer_helper_base.py:327)
            return self._create_weight_norm_parameter(
                attr, shape, dtype, default_initializer)
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

    def _create_weight_norm_parameter(self, attr, shape, dtype,
                                      default_initializer=None):
        """WeightNormParamAttr reparameterization (layer_helper_base.py
        create_parameter with a WeightNormParamAttr): the layer's weight
        becomes w = g * v / ||v||, with g/v the trainable parameters and
        the norm taken over every axis EXCEPT attr.dim (dim=None -> full
        tensor norm), recomputed inside the program each step.  g is
        initialized to ||v|| in the startup program, so w == v at step 0
        exactly like the reference."""
        from .param_attr import ParamAttr as _PA

        base = attr.name or unique_name.generate(f"{self.name}.w")
        inner = _PA(name=base + "_v", initializer=attr.initializer,
                    learning_rate=attr.learning_rate,
                    regularizer=attr.regularizer, trainable=attr.trainable)
        v = self.create_parameter(inner, shape, dtype=dtype,
                                  default_initializer=default_initializer)
        dim = attr.dim
        if dim is not None:
            dim = dim % len(shape)          # negative dims normalize
        # g keeps the weight's rank: shape[dim] on dim, 1 elsewhere
        # (layer_helper_base.py:232-234) — checkpoints match by shape
        g_shape = [1] * len(shape)
        if dim is not None:
            g_shape[dim] = shape[dim]
        g_attr = _PA(name=base + "_g", learning_rate=attr.learning_rate,
                     regularizer=attr.regularizer,
                     trainable=attr.trainable,
                     initializer=ConstantInitializer(1.0))
        g = self.create_parameter(g_attr, g_shape, dtype=dtype)

        axes = ([a for a in range(len(shape)) if a != dim]
                if dim is not None else list(range(len(shape))))

        def norm_ops(block, v_name, out_name, keep_dim):
            sq = unique_name.generate(base + ".wn_sq")
            block.create_var(name=sq, dtype=dtype)
            block.append_op("square", {"X": [v_name]}, {"Out": [sq]}, {})
            ssum = unique_name.generate(base + ".wn_ss")
            block.create_var(name=ssum, dtype=dtype)
            block.append_op("reduce_sum", {"X": [sq]}, {"Out": [ssum]},
                            {"dim": axes, "keep_dim": keep_dim})
            block.append_op("sqrt", {"X": [ssum]}, {"Out": [out_name]},
                            {})

        # startup: g = ||v||, making the initial effective weight equal v
        sb = self.startup_program.global_block()
        raw = unique_name.generate(base + ".wn_g0")
        sb.create_var(name=raw, dtype=dtype)
        norm_ops(sb, v.name, raw, keep_dim=True)
        sb.append_op("reshape2", {"X": [raw]}, {"Out": [g.name]},
                     {"shape": list(g_shape)})

        # main program: w = g * v / ||v|| recomputed per step; g is
        # rank-preserved so plain -1 broadcasting applies throughout
        norm = self.create_variable_for_type_inference(dtype)
        norm_ops(self.main_program.global_block(), v.name, norm.name,
                 keep_dim=True)
        unit = self.create_variable_for_type_inference(dtype)
        self.append_op("elementwise_div", {"X": v, "Y": norm},
                       {"Out": unit}, {"axis": -1})
        w = self.create_variable_for_type_inference(dtype)
        self.append_op("elementwise_mul", {"X": unit, "Y": g},
                       {"Out": w}, {"axis": -1})
        w.shape = list(shape)
        return w

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
