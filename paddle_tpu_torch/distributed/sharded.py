"""Partition rules and the sharded train step (port of the expert- and
data-parallel part of paddle_tpu/distributed/sharded.py).

The reference attaches `NamedSharding`s to the arrays of the train state
by regex rules and lets GSPMD compile the collectives, so its sharded
step computes the unsharded step's function of the GLOBAL batch.  In the
port each rank holds its own tensors:

- `shard_params` / `shard_train_state` keep this rank's slice of every
  leaf whose spec names an axis of size > 1: the expert-major MoE
  weights (`moe.(w1|w2)`, spec ("ep", None, None)) become [E/ep, ...];
  everything else stays whole (replicated);
- `shard_batch` keeps this rank's block of the batch (dim 0 over dp,
  dim 1 over sp);
- `make_sharded_train_step` runs `models.train.make_train_step` with
  its grads and loss meaned over dp, and its MoE layers in
  `moe.expert_parallel(mesh)`: the router input is gathered over dp so
  that every rank gates the global tokens, each rank runs its local
  experts, and their outputs are gathered over ep.  Gating, capacity,
  the aux loss, the losses and the updated params are then those of the
  unsharded step on the whole batch.

Ported: meshes of dp and ep.  Tensor parallelism (tp > 1), sp > 1 in
the step, ZeRO-1 (`zero1=True`), fsdp specs over dp > 1, gradient
accumulation and gradient clipping across expert slices are ROADMAP
queue 1 item 8; they raise.
"""

import re

import torch

__all__ = [
    "PartitionSpec", "P", "PartitionRules", "gpt_rules", "bert_rules",
    "mlp_rules", "fsdp_rules", "shard_params", "shard_train_state",
    "shard_batch", "make_sharded_train_step",
]

_ITEM8 = "ROADMAP queue 1 item 8"


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`'s counterpart: one entry per dim, an
    axis name, a tuple of names, or None (not split)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class PartitionRules:
    """Ordered (regex, PartitionSpec) table; first match wins."""

    def __init__(self, rules, default=P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec(self, name, value=None):
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return self.default

    def __add__(self, other):
        out = PartitionRules([], default=self.default)
        out.rules = self.rules + other.rules
        return out


def gpt_rules():
    """Megatron TP sharding for models/gpt.py / models/bert.py naming,
    and the MoE expert-major weights over ep (the router replicated).
    No trailing catch-all, so `gpt_rules() + fsdp_rules()` composes."""
    col = P(None, "tp")   # [in, out] -> out sharded
    row = P("tp", None)   # [in, out] -> in sharded
    return PartitionRules([
        (r"(q_proj|k_proj|v_proj|fc1|linear1)\.weight$", col),
        (r"(q_proj|k_proj|v_proj|fc1|linear1)\.bias$", P("tp")),
        (r"(out_proj|fc2|linear2)\.weight$", row),
        (r"(wte|wpe|word_emb|pos_emb|embedding)\.weight$", P("tp", None)),
        (r"moe\.(w1|w2)$", P("ep", None, None)),
        (r"moe\.wg$", P()),
    ])


def bert_rules():
    return gpt_rules()


def mlp_rules():
    return PartitionRules([
        (r"\.weight$", P(None, "tp")),
    ])


def fsdp_rules():
    """ZeRO-3/FSDP-style rules: every parameter's dim 0 over dp."""
    return PartitionRules([
        (r".*", P("dp")),
    ])


def _dims(mesh, spec, value):
    """(dim, axes) of the spec's entries that split `value` on this
    mesh: entries past the rank are dropped, and a dim that the axes'
    size does not divide stays whole (the reference's `_named` clamp)."""
    out = []
    for d, a in enumerate(list(spec)[:value.dim()]):
        if a is None:
            continue
        axes = (a,) if isinstance(a, str) else tuple(a)
        size = 1
        for name in axes:
            size *= mesh.axis_size(name)
        if size > 1 and value.shape[d] % size == 0:
            out.append((d, axes))
    return out


def _local(mesh, spec, value):
    """This rank's block of `value` under `spec`."""
    for d, axes in _dims(mesh, spec, value):
        if axes != ("ep",) and axes != ("dp",) and axes != ("sp",):
            raise NotImplementedError(
                f"a spec over {axes}: tensor parallelism and multi-axis "
                f"dims are not ported ({_ITEM8})")
        n = mesh.axis_size(axes[0])
        blk = value.shape[d] // n
        value = value.narrow(d, mesh.axis_index(axes[0]) * blk, blk)
    return value


def _check_param_spec(mesh, name, spec, value):
    for _, axes in _dims(mesh, spec, value):
        if axes != ("ep",):
            raise NotImplementedError(
                f"param {name!r} split over {axes}: the sharded step "
                f"splits params over ep only; tp, fsdp over dp and sp "
                f"are {_ITEM8}")


def shard_params(params, mesh, rules):
    """{name: this rank's block of the tensor} per the partition rules
    (a copy where it is a slice, the tensor itself where whole)."""
    out = {}
    for n, v in params.items():
        local = _local(mesh, rules.spec(n, v), v)
        out[n] = local.clone() if local.shape != v.shape else v
    return out


def shard_batch(mesh, *arrays, spec=None):
    """This rank's block of each batch array: dim 0 over dp, dim 1 (the
    sequence) over sp, unless `spec` says otherwise."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        s = spec
        if s is None:
            s = P("dp", "sp") if a.dim() >= 2 else P("dp")
        out.append(_local(mesh, s, a).contiguous())
    return tuple(out) if len(out) > 1 else out[0]


def shard_train_state(state, mesh, rules, zero1=False):
    """A models.train.TrainState with its params and their optimizer
    slots cut to this rank's blocks per `rules`; buffers, step and rng
    as they are."""
    from ..models.train import TrainState

    if zero1:
        raise NotImplementedError(f"zero1=True (optimizer state split over "
                                  f"dp) is not ported ({_ITEM8})")
    params = shard_params(state.params, mesh, rules)
    opt_state = {}
    for n, slots in state.opt_state.items():
        p = state.params.get(n)
        if p is None or not isinstance(slots, dict):
            opt_state[n] = slots
            continue
        spec = rules.spec(n, p)
        opt_state[n] = {
            k: (_local(mesh, spec, t).clone()
                if tuple(t.shape) == tuple(p.shape) else t)
            for k, t in slots.items()}
    return TrainState(params=params, opt_state=opt_state,
                      buffers=state.buffers, step=state.step, rng=state.rng)


def make_sharded_train_step(model, optimizer, mesh, rules=None,
                            loss_fn=None, rng_seed=0, zero1=False,
                            accum_steps=1):
    """Build (step, sharded_state).  step(state, *batch) -> (state,
    loss), where batch holds this rank's blocks (`shard_batch`) and loss
    is the global batch's.  The step is `make_train_step`'s with grads
    and loss meaned over dp, run inside `moe.expert_parallel(mesh)`;
    see the module docstring for what it computes."""
    from ..models.train import init_train_state, make_train_step
    from .moe import expert_parallel

    rules = rules or gpt_rules()
    if int(accum_steps) != 1:
        raise NotImplementedError(f"accum_steps > 1 in the sharded step is "
                                  f"not ported ({_ITEM8})")
    if mesh.axis_size("sp") > 1:
        raise NotImplementedError(f"sp > 1 in the sharded train step "
                                  f"(sequence-parallel models) is not "
                                  f"ported ({_ITEM8})")
    state = init_train_state(model, optimizer, rng_seed=rng_seed)
    for n, v in state.params.items():
        _check_param_spec(mesh, n, rules.spec(n, v), v)
    if mesh.axis_size("ep") > 1 and optimizer._grad_clip is not None:
        raise NotImplementedError(f"gradient clipping over params split on "
                                  f"ep is not ported ({_ITEM8})")
    state = shard_train_state(state, mesh, rules, zero1=zero1)
    inner = make_train_step(model, optimizer, loss_fn=loss_fn,
                            grad_psum_axis="dp", mesh=mesh)

    def step(st, *batch):
        with expert_parallel(mesh):
            return inner(st, *batch)

    return step, state
