"""Static-graph autodiff API.

Port of paddle_tpu/framework/backward.py (Paddle-Fluid's fluid/backward.py:
`append_backward` :1145, `gradients` :1678, recompute checkpoints :623).

Paddle-Fluid walks forward ops in reverse querying C++ grad-op makers and
appends explicit grad ops.  Here append_backward records a BackwardSection
marker, as the JAX package does; the port's Executor realizes it with
`torch.autograd.grad` over the forward segment.  `<name>@GRAD` variables are still materialized
in the block so downstream ops (optimizers, clipping, collectives) compose
exactly like the reference.
"""

from .program import BackwardSection, Parameter


def _grad_name(name):
    return name + "@GRAD"


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    checkpoints=None):
    """Mark backward computation for `loss`; returns [(param, grad_var)].

    checkpoints: list of Variables/names marking recompute boundaries
    (parity with RecomputeOptimizer / _append_backward_ops_with_checkpoints_).
    """
    program = loss.block.program
    block = program.global_block()
    no_grad = {v.name if hasattr(v, "name") else v for v in (no_grad_set or ())}

    if parameter_list is not None:
        params = [p.name if hasattr(p, "name") else p for p in parameter_list]
    else:
        params = [
            p.name for p in program.all_parameters()
            if getattr(p, "trainable", True)
        ]
    params = [p for p in params if p not in no_grad]

    ckpt_names = [c.name if hasattr(c, "name") else c
                  for c in (checkpoints or ())]

    pos = len(block.ops)
    program.backward_sections.append(
        BackwardSection(pos, loss.name, params, no_grad, ckpt_names)
    )
    # a backward section changes the compiled step even when every @GRAD
    # var already exists, so the run-plan/compiled caches must see it
    program._bump()

    result = []
    for pname in params:
        pv = block.var(pname)
        gname = _grad_name(pname)
        if gname not in block.vars:
            g = block.create_var(name=gname, shape=pv.shape, dtype=pv.dtype,
                                 stop_gradient=True)
        else:
            g = block.vars[gname]
        result.append((pv, g))
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of targets w.r.t. inputs (parity: backward.py:1678
    calc_gradient): d(sum_i <targets[i], target_gradients[i] or 1>)/d(inputs).

    inputs must be variables live *before* the backward position (feed data
    or parameters) — intermediate activations inside the differentiated
    segment are not addressable, as in the JAX package.
    """
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(
            target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    program = targets[0].block.program
    block = program.global_block()
    if len(targets) > 1 or target_gradients is not None:
        # reference calc_gradient semantics: d(sum_i <target_i, tg_i>)/d(x)
        # with tg defaulting to ones.  Synthesize the weighted-sum scalar in
        # the block so ONE BackwardSection covers all targets.
        parts = []
        for i, tgt in enumerate(targets):
            term = tgt
            tg = (target_gradients[i]
                  if target_gradients and i < len(target_gradients) else None)
            if tg is not None:
                mul = block.create_var(
                    name=f"{tgt.name}@weighted_{i}", shape=tgt.shape,
                    dtype=tgt.dtype, stop_gradient=False)
                block.append_op("elementwise_mul",
                                inputs={"X": tgt, "Y": tg},
                                outputs={"Out": mul}, attrs={"axis": -1})
                term = mul
            red = block.create_var(
                name=f"{tgt.name}@grad_sum_{i}", shape=[1],
                dtype=tgt.dtype, stop_gradient=False)
            block.append_op("reduce_sum", inputs={"X": term},
                            outputs={"Out": red},
                            attrs={"reduce_all": True, "keep_dim": False})
            parts.append(red)
        if len(parts) > 1:
            loss = block.create_var(
                name=f"{targets[0].name}@combined_target", shape=[1],
                dtype=targets[0].dtype, stop_gradient=False)
            block.append_op("sum", inputs={"X": parts},
                            outputs={"Out": loss})
        else:
            loss = parts[0]
    else:
        loss = targets[0]
    names = [v.name if hasattr(v, "name") else v for v in inputs]
    pos = len(block.ops)
    program.backward_sections.append(
        BackwardSection(pos, loss.name, names, no_grad_set)
    )
    program._bump()
    grads = []
    for n in names:
        v = block.var(n)
        g = block.create_var(name=_grad_name(n), shape=v.shape, dtype=v.dtype,
                             stop_gradient=True)
        grads.append(g)
    return grads
