"""Optimizers (port of paddle_tpu/optimizer).

The top-level names are the static-graph optimizers, as in the
reference (Paddle-Fluid's fluid/optimizer.py: Optimizer :54, backward
:607, apply_gradients :671, minimize :779; SGD :828, Momentum :918,
Adagrad :1546, Adam :1653): `minimize` records a BackwardSection, clips
the gradients (the optimizer's `grad_clip`, else the global
`clip.set_gradient_clip`), adds the weight decay (a parameter's
`ParamAttr(regularizer=)`, else the optimizer's `regularization`), and
appends one update op per parameter (`sgd`, `momentum`, `adagrad`,
`adam`, `adamw`, ops/optimizer_ops.py) to the Program, with the learning
rate and the accumulators (velocity, moments, beta powers) as
persistable vars filled by the startup program, under the reference's
names.

`DGCMomentumOptimizer` (optimizer.py:1041) emits the static DGC ops
(ops/misc_ops.py) and `PipelineOptimizer` (:3413) runs a macro-batch as
microbatches, an update each (`run_pipeline`).

`functional` holds the functional optimizers the dygraph train step
uses (`functional.SGD`, `Momentum`, `Adam`, `AdamW`, `global_norm_clip`).

The rest of the reference's static zoo raises NotImplementedError naming
its ROADMAP item.
"""

from .. import clip as clip_mod
from ..framework import _not_ported, unique_name
from ..framework.backward import append_backward
from ..framework.initializer import ConstantInitializer
from ..framework.program import (Variable, default_main_program,
                                 default_startup_program)
from ..layers import tensor as T
from ..regularizer import append_regularization_ops
from . import functional  # noqa: F401

__all__ = [
    "functional", "Optimizer", "SGD", "SGDOptimizer", "Momentum",
    "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW",
    "DGCMomentumOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
    "Adagrad", "AdagradOptimizer", "Adamax", "AdamaxOptimizer", "Dpsgd",
    "DpsgdOptimizer", "DecayedAdagrad", "DecayedAdagradOptimizer",
    "Adadelta", "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer", "Ftrl",
    "FtrlOptimizer", "Lamb", "LambOptimizer", "RecomputeOptimizer",
    "ExponentialMovingAverage", "LookaheadOptimizer", "ModelAverage",
    "PipelineOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(type(self).__name__.lower())
        self._lr_var = None
        self._accumulators = {}

    # -- LR -------------------------------------------------------------

    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        else:
            self._lr_var = T.create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate(self._name + "_lr"))
        return self._lr_var

    def _param_lr(self, param):
        base = self._create_global_learning_rate()
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return base
        return T.scale(base, scale=mult)

    # -- accumulators ----------------------------------------------------

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        vname = f"{param.name}_{self._name}_{name}"
        shape = shape if shape is not None else list(param.shape)
        dtype = dtype or param.dtype
        block = default_main_program().global_block()
        var = block.create_var(name=vname, shape=shape, dtype=dtype,
                               persistable=True, stop_gradient=True)
        sb = default_startup_program().global_block()
        if vname not in sb.vars:
            sv = sb.create_var(name=vname, shape=shape, dtype=dtype,
                               persistable=True, stop_gradient=True)
            ConstantInitializer(fill_value)(sv, sb)
        self._accumulators[key] = var
        return var

    # -- main API --------------------------------------------------------

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               checkpoints=checkpoints)

    def apply_gradients(self, params_grads):
        # the reference's order: clip first, then decay
        grad_clip = self._grad_clip or clip_mod.get_gradient_clip()
        if grad_clip is not None:
            params_grads = grad_clip.apply(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_global_learning_rate()
        ops = []
        for p, g in params_grads:
            if g is None:
                continue
            ops.append(self._append_optimize_op(
                default_main_program().global_block(), (p, g)))
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class RecomputeOptimizer(Optimizer):
    """optimizer.py:3713 — activation checkpointing around another
    optimizer: the checkpoint names flow into the BackwardSection, and the
    Executor recomputes the forward chunks between them in the backward
    (`framework/executor.py` `_checkpoint_chunks`)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set,
            checkpoints=checkpoints or self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads


class SGD(Optimizer):
    """optimizer.py:828 / operators/optimizers/sgd_op.cc"""

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p})


class Momentum(Optimizer):
    """optimizer.py:918"""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._add_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class Adagrad(Optimizer):
    """optimizer.py:1546 / operators/optimizers/adagrad_op.h"""

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p, fill_value=self._init_acc)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self._epsilon})


class Adam(Optimizer):
    """optimizer.py:1653 — Paddle's Adam (ops/optimizer_ops.py adam): the
    beta-power accumulators are [1] persistables starting at beta1 and
    beta2."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    _op_type = "adam"
    _extra_attrs = {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[1])
        b2p = self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                    shape=[1])
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon}
        attrs.update(self._extra_attrs)
        return block.append_op(
            self._op_type,
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs=attrs)


class AdamW(Adam):
    """Adam with decoupled weight decay (the `adamw` op)."""

    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._extra_attrs = {"coeff": weight_decay}


class DGCMomentumOptimizer(Optimizer):
    """optimizer.py:1041 — DGC momentum with the reference constructor
    (momentum, rampup_begin_step, rampup_step, sparsity warm-up list).

    Emits per param: [dgc_clip_by_norm] -> dgc (U/V momentum correction
    + error feedback + top-k sparsify, ops/misc_ops.py) -> dgc_momentum
    (momentum before the rampup boundary, direct sparse update after),
    plus one shared step counter incremented per apply_gradients.  Under
    the data-parallel CompiledProgram the gradients are all-reduced
    before the dgc ops, as in the reference."""

    _u_velocity_acc_str = "_dgc_u_"
    _v_velocity_acc_str = "_dgc_v_"

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=None, parameter_list=None,
                 use_nesterov=False, local_grad_clip_norm=None,
                 num_trainers=None, regularization=None, grad_clip=None,
                 name=None):
        assert rampup_begin_step >= 0, "rampup_begin_step must >= 0"
        super().__init__(learning_rate, regularization=regularization,
                         grad_clip=grad_clip, name=name)
        self.type = "dgc_momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity) if sparsity is not None else [0.999]
        self._parameter_list = parameter_list
        if local_grad_clip_norm is not None:
            # reference optimizer.py:1153-1156: the clip norm is scaled by
            # num_trainers**-0.5, num_trainers a positive int
            assert isinstance(num_trainers, int) and num_trainers > 0, \
                "local_grad_clip_norm needs a positive int num_trainers"
            self._clip_norm = local_grad_clip_norm * (num_trainers ** -0.5)
        else:
            self._clip_norm = None
        self._num_trainers = num_trainers
        self._global_step_var = None

    def _get_global_step_var(self):
        if self._global_step_var is None:
            self._global_step_var = T.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate(self._name + "_global_step"))
        return self._global_step_var

    def apply_gradients(self, params_grads):
        ops = super().apply_gradients(params_grads)
        T.increment(self._get_global_step_var(), 1.0, in_place=True)
        return ops

    def _is_use_dgc(self, param):
        """optimizer.py:1169 — small (< 16384 elements) or non-float32
        params skip sparsification and stay on dense momentum."""
        numel = 1
        for s in param.shape:
            numel *= int(s)
        return numel >= 16384 and str(param.dtype) in ("float32", "FP32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        vel = self._add_accumulator("velocity", p)
        if not self._is_use_dgc(p):
            return block.append_op(
                "momentum",
                inputs={"Param": p, "Grad": g, "Velocity": vel,
                        "LearningRate": self._param_lr(p)},
                outputs={"ParamOut": p, "VelocityOut": vel},
                attrs={"mu": self._momentum,
                       "use_nesterov": self._use_nesterov})
        u = self._add_accumulator(self._u_velocity_acc_str, p)
        v = self._add_accumulator(self._v_velocity_acc_str, p)
        step = self._get_global_step_var()
        if self._clip_norm is not None:
            clipped = block.create_var(
                name=unique_name.generate(p.name + "_dgc_clip"),
                shape=list(p.shape), dtype=p.dtype)
            block.append_op(
                "dgc_clip_by_norm",
                inputs={"X": g, "current_step": step},
                outputs={"Out": clipped},
                attrs={"max_norm": float(self._clip_norm),
                       "rampup_begin_step": float(self._rampup_begin_step)})
            g = clipped
        sparse_g = block.create_var(
            name=unique_name.generate(p.name + "_dgc_grad"),
            shape=list(p.shape), dtype=p.dtype)
        block.append_op(
            "dgc",
            inputs={"U": u, "V": v, "Grad": g, "current_step": step},
            outputs={"UOut": u, "VOut": v, "GradOut": sparse_g},
            attrs={"m": self._momentum,
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "rampup_step": float(self._rampup_step),
                   "sparsity": self._sparsity})
        return block.append_op(
            "dgc_momentum",
            inputs={"Param": p, "Grad": sparse_g, "Velocity": vel,
                    "LearningRate": self._param_lr(p),
                    "current_step": step},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": float(self._rampup_begin_step)})


class PipelineOptimizer:
    """Static-graph pipeline wrapper (optimizer.py:3413 parity).

    The reference's v1 pipeline is ASYNC: microbatches flow through
    program sections bound to places, and the optimizer updates per
    microbatch (SectionWorker scope queues, device_worker.h:325).  As in
    the JAX package, this wrapper keeps the reference API — cut_list /
    place_list / concurrency_list are accepted and recorded — and gives
    the reference's execution semantics through `run_pipeline`: the feed
    batch splits into microbatches, each running the full (forward,
    backward, update) program, so the parameters update per microbatch
    as in the async reference.  Pipeline model parallelism over stages
    is `distributed.pipeline` (GPipe and the interleaved schedule)."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30,
                 start_cpu_core_id=0, sync_steps=1):
        self._inner = optimizer
        self.cut_list = cut_list or []
        self.place_list = place_list or []
        self.concurrency_list = concurrency_list or []
        self.queue_size = queue_size
        self.sync_steps = sync_steps

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        out = self._inner.minimize(loss, startup_program=startup_program,
                                   parameter_list=parameter_list,
                                   no_grad_set=no_grad_set)
        loss.block.program._pipeline_cfg = {
            "cut_list": self.cut_list,
            "concurrency_list": self.concurrency_list,
            "sync_steps": self.sync_steps,
        }
        return out

    def run_pipeline(self, exe, program, feed, fetch_list,
                     micro_batch_num=None):
        """Run one macro-batch as `micro_batch_num` microbatches with a
        parameter update per microbatch (the reference's async pipeline
        semantics); returns the per-microbatch fetch lists."""
        m = micro_batch_num or max(
            1, max(self.concurrency_list) if self.concurrency_list else 2)
        names = list(feed)
        batch = feed[names[0]].shape[0]
        if batch % m != 0:
            raise ValueError(
                f"macro batch {batch} not divisible into {m} microbatches")
        step = batch // m
        return [exe.run(program,
                        feed={n: feed[n][i * step:(i + 1) * step]
                              for n in names},
                        fetch_list=fetch_list)
                for i in range(m)]


SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
AdagradOptimizer = Adagrad


LarsMomentum = LarsMomentumOptimizer = _not_ported(
    "LarsMomentum", "10, the rest of the optimizer zoo")
Adamax = AdamaxOptimizer = _not_ported("Adamax",
                                       "10, the rest of the optimizer zoo")
Dpsgd = DpsgdOptimizer = _not_ported("Dpsgd",
                                     "10, the rest of the optimizer zoo")
DecayedAdagrad = DecayedAdagradOptimizer = _not_ported(
    "DecayedAdagrad", "10, the rest of the optimizer zoo")
Adadelta = AdadeltaOptimizer = _not_ported(
    "Adadelta", "10, the rest of the optimizer zoo")
RMSProp = RMSPropOptimizer = _not_ported("RMSProp",
                                         "10, the rest of the optimizer zoo")
Ftrl = FtrlOptimizer = _not_ported("Ftrl",
                                   "10, the rest of the optimizer zoo")
Lamb = LambOptimizer = _not_ported("Lamb",
                                   "10, the rest of the optimizer zoo")
ExponentialMovingAverage = _not_ported("ExponentialMovingAverage",
                                       "10, the rest of the optimizer zoo")
LookaheadOptimizer = _not_ported("LookaheadOptimizer",
                                 "10, the rest of the optimizer zoo")
ModelAverage = _not_ported("ModelAverage",
                           "10, the rest of the optimizer zoo")
